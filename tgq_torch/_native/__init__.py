"""Native (C++) serving-runtime components, built on demand.

``get_page_alloc_cls()`` builds ``pagealloc.cc`` (CPython C API) with g++
(``$CXX``) at first use into ``_build/<interpreter tag>/``, never beside
the source, rebuilds it when the source is newer than the library, and
returns its ``PageAlloc`` type.  A failed build or import raises
:class:`NativeBuildError` with the compiler's stderr;
``tgq_torch.serve.kv_cache.PageTable(backend="auto")`` then falls back to
its pure-Python backend, ``backend="native"`` raises.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pagealloc.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_MODULE = "tgq_torch_pagealloc"

_loaded: dict = {}  # build directory → PageAlloc type, or the NativeBuildError raised


class NativeBuildError(RuntimeError):
    """The native allocator could not be built or imported."""


def _tag() -> str:
    """One build per interpreter: the library links against its headers."""
    key = f"{sys.version}|{sysconfig.get_paths()['include']}|{sys.platform}"
    return hashlib.sha1(key.encode()).hexdigest()[:12]


def library_path(build_dir: str | None = None) -> str:
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(build_dir or _BUILD_DIR, _tag(), _MODULE + ext)


def build(build_dir: str | None = None) -> str:
    """Compile the allocator unless an up-to-date library exists; returns
    its path.  Writes to a temporary name and renames, so that processes
    building at the same time never load a half-written file."""
    so = library_path(build_dir)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}", _SRC, "-o", tmp]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"native page allocator: {' '.join(cmd)}: {e}") from e
    if out.returncode != 0 or not os.path.exists(tmp):
        raise NativeBuildError(f"native page allocator: {' '.join(cmd)} exited "
                               f"{out.returncode}:\n{out.stderr.strip()}")
    os.replace(tmp, so)
    return so


def get_page_alloc_cls(build_dir: str | None = None):
    """The compiled ``PageAlloc`` type (built on first use, once per build
    directory and process); raises :class:`NativeBuildError`."""
    key = build_dir or _BUILD_DIR
    if key not in _loaded:
        try:
            so = build(build_dir)
            spec = importlib.util.spec_from_file_location(_MODULE, so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _loaded[key] = mod.PageAlloc
        except NativeBuildError as e:
            _loaded[key] = e
        except ImportError as e:
            _loaded[key] = NativeBuildError(f"native page allocator: import failed: {e}")
    got = _loaded[key]
    if isinstance(got, NativeBuildError):
        raise got
    return got
