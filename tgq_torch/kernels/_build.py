"""Build and load the CUDA kernels.

Each ``csrc/*.cu`` file (with the headers ``csrc/*.cuh``) is compiled by
its own ``nvcc`` (all started together) for ``sm_90a`` into an object with
a plain C interface; the objects are linked into ``_build/<hash>/libtgq_kernels.so`` and loaded
with ``ctypes``.  The directory is keyed by a hash of the sources and
flags, so the first call after a change rebuilds and later calls (and
processes) reuse the library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# per-source extra flags: the GPTQ sweep contracts exactly the two FMAs
# XLA:CPU contracts (written as __fmaf_rn) and no others
SOURCES = {
    "pchol_panel.cu": [],
    "gptq_block.cu": ["-fmad=false"],
    "dequant_matmul.cu": [],
    "a8_matmul.cu": [],
    "paged_attention.cu": [],
    "causal_attention.cu": [],
    "causal_attention_bwd.cu": [],
}

_lib = None
_limits: dict[int, tuple[int, int]] = {}  # device -> (SMs, opt-in shared memory)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "tgq_device_sms": ([_I], _I),
    "tgq_device_smem_optin": ([_I], _I),
    "tgq_pchol_panel_blocks_per_sm": ([_I, _I, _I], _I),
    "tgq_pchol_panel": ([_P] * 11 + [_I] * 9 + [_P], _I),
    "tgq_gptq_block": ([_P] * 6 + [_I] * 4 + [ctypes.c_float, ctypes.c_float, _I, _P], _I),
    "tgq_dequant_matmul": ([_P, _I, _L] + [_P] * 4 + [_I, _P] + [_I] * 11 + [_P], _I),
    "tgq_a8_matmul": ([_P] * 6 + [_I] * 10 + [_P], _I),
    "tgq_paged_attention": ([_P] * 15 + [_I] * 11 + [ctypes.c_float, _I, _P], _I),
    "tgq_causal_attention": ([_P] * 5 + [_L] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P], _I),
    "tgq_causal_attention_bwd": ([_P] * 10 + [_L] * 15 + [_I] * 5 + [ctypes.c_float, _I, _P],
                                 _I),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("tgq_torch kernels: nvcc not found (set CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(ARCH + COMMON + flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # included by the sources
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtgq_kernels.so"


def ptxas_report() -> str:
    """Registers, shared memory and spills per kernel, as ptxas printed
    them when the library was built."""
    rep = library_path().parent / "ptxas.txt"
    return rep.read_text() if rep.exists() else ""


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs, objs = [], []
        for name, flags in SOURCES.items():
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *ARCH, *COMMON, *flags, "-Xptxas=-v",
                   "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        reports = []
        for name, p in procs:
            text, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
            reports.append(f"--- {name}\n{text}")
        lib_tmp = Path(tmp) / "libtgq_kernels.so"
        link = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out.parent / "ptxas.txt").write_text("\n".join(reports))
        os.replace(lib_tmp, out)
    return out


def load(path) -> ctypes.CDLL:
    """A kernel library with the argument types of the functions it has."""
    handle = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def device_limits(lib, dev: int) -> tuple[int, int]:
    """(SMs, opt-in shared memory bytes a block) of CUDA device ``dev``."""
    if dev not in _limits:
        sms, smem = lib.tgq_device_sms(dev), lib.tgq_device_smem_optin(dev)
        if sms <= 0 or smem <= 0:
            raise RuntimeError(f"cannot read the limits of CUDA device {dev}")
        _limits[dev] = (sms, smem)
    return _limits[dev]
