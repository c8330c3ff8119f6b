"""The port's native page allocator (``tgq_torch/_native``): it builds with
g++ into its git-ignored build directory, and its ``PageTable`` backend
stays in lockstep with the port's pure-Python backend and with the JAX
package's ``PageTable(backend="python")`` on every observable through a
randomized sequence of operations (the model is
``tests/test_serve.py::test_page_allocator_backends_equivalent``).  A
build that fails raises for ``backend="native"`` and falls back for
``"auto"``."""
import os

import numpy as np
import pytest

from tgq.serve.kv_cache import PageTable as JPageTable
from tgq_torch import _native
from tgq_torch.serve.kv_cache import PageTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_pages=32, page_size=4, max_slots=4, max_pages_per_slot=8)


def test_builds_into_the_ignored_directory():
    cls = _native.get_page_alloc_cls()
    so = _native.library_path()
    assert os.path.exists(so) and cls.__name__ == "PageAlloc"
    rel = os.path.relpath(so, REPO)
    assert rel.startswith(os.path.join("tgq_torch", "_native", "_build") + os.sep), rel
    # never beside the source, and .gitignore lists the build directory
    assert os.path.dirname(so) != os.path.dirname(_native._SRC)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "tgq_torch/_native/_build/" in ignored
    assert PageTable(**KW).backend == "native"


def test_rebuilds_when_the_source_is_newer(tmp_path):
    so = _native.build(str(tmp_path))
    t0 = os.path.getmtime(so)
    assert _native.build(str(tmp_path)) == so and os.path.getmtime(so) == t0
    os.utime(so, (t0 - 10, os.path.getmtime(_native._SRC) - 10))
    _native.build(str(tmp_path))
    assert os.path.getmtime(so) >= os.path.getmtime(_native._SRC)


def observe(pt, extra: bool = True):
    obs = (pt.num_free, tuple(pt.lens), tuple(pt.slot_pages(s) for s in range(pt.max_slots)))
    if extra:
        table, lens = pt.device_tables()
        obs += (table.numpy().tobytes(), lens.numpy().tobytes())
    return obs


def test_backends_in_lockstep(rng):
    a = PageTable(backend="python", **KW)
    b = PageTable(backend="native", **KW)
    j = JPageTable(backend="python", **KW)
    assert (a.backend, b.backend) == ("python", "native")
    tables = (a, b, j)
    active: set[int] = set()
    counts = {"alloc": 0, "extend": 0, "free": 0, "detach": 0}
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            free_slots = [s for s in range(4) if s not in active]
            n = int(rng.integers(1, 20))
            assert len({t.can_alloc(n) for t in tables}) == 1
            if free_slots and a.can_alloc(n):
                s = free_slots[0]
                got = {t.alloc_slot(s, n) for t in tables}
                assert len(got) == 1, got
                active.add(s)
                counts["alloc"] += 1
        elif op == 1 and active:
            s = sorted(active)[int(rng.integers(0, len(active)))]
            grow = a.pages_needed(a.lens[s] + 1) - a.pages_needed(a.lens[s])
            if a.pages_needed(a.lens[s] + 1) <= 8 and grow <= a.num_free:
                for t in tables:
                    t.extend(s, 1)
                counts["extend"] += 1
        elif op == 2 and active:
            s = sorted(active)[int(rng.integers(0, len(active)))]
            if rng.integers(0, 2):
                for t in tables:
                    t.free_slot(s)
                counts["free"] += 1
            else:  # detach, then release (the engine's deferred frees)
                got = {t.detach_slot(s) for t in tables}
                assert len(got) == 1, got
                for t in tables:
                    t.release_pages(next(iter(got)))
                counts["detach"] += 1
            active.discard(s)
        assert observe(a) == observe(b), counts
        assert observe(a, extra=False) == observe(j, extra=False), counts
        np.testing.assert_array_equal(a.device_tables()[0].numpy(),
                                      np.asarray(j.device_tables()[0]))
    assert min(counts.values()) > 10, counts  # every operation was exercised
    for s in sorted(active):
        for t in tables:
            t.free_slot(s)
    assert a.num_free == b.num_free == j.num_free == KW["num_pages"] - 1


def test_native_raises_when_the_build_fails(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(_native.NativeBuildError, match="exited 1"):
        _native.get_page_alloc_cls(str(tmp_path / "broken"))
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path / "broken2"))
    with pytest.raises(_native.NativeBuildError):
        PageTable(backend="native", **KW)
    pt = PageTable(backend="auto", **KW)  # falls back, and says so
    assert pt.backend == "python" and pt.alloc_slot(0, 5) == (1, 2)
    with pytest.raises(ValueError, match="backend"):
        PageTable(backend="cpp", **KW)


def test_engine_states_its_backend():
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models import PRESETS
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.serve import Engine, ServeConfig

    cfg = PRESETS["tiny-qwen3"]
    params = init_packed_params(cfg, QuantSpec(4, 32), device="cpu")
    outs = {}
    for backend in ("native", "python"):
        eng = Engine(params, cfg, ServeConfig(max_slots=2, page_size=8, num_pages=16,
                                              max_pages_per_slot=4, max_new_tokens=4,
                                              page_alloc=backend), device="cpu")
        assert eng.pt.backend == backend
        reqs = [eng.submit(p) for p in ([5, 17, 42], [7, 9, 3, 1, 4, 1, 5, 9, 2])]
        eng.run()
        assert eng.pt.num_free == 15
        outs[backend] = [r.output for r in reqs]
    assert outs["native"] == outs["python"]


def test_serve_soak_balances_pages(capsys):
    """``python -m tgq_torch.cli.serve_soak`` at tiny size on the CPU: mixed
    lengths, temperatures and EOS with submission interleaved with
    ``Engine.step``; every request ends within its budget and the pages
    return.  Its defaults are ``scripts/serve_soak.py``'s settings."""
    import json

    from tgq_torch.cli import serve_soak

    d = serve_soak.build_parser().parse_args([])
    assert (d.model_id, d.w_bits, d.group_size, d.lm_head_bits, d.n_requests) == (
        "qwen3-8b", 4, 128, 8, 512)
    assert (d.max_slots, d.page_size, d.max_pages_per_slot, d.max_new_tokens, d.kv_bits,
            d.a_bits, d.decode_chunk, d.eos_id, d.prefill_chunk_tokens) == (
        128, 64, 8, 64, 8, 8, 16, 7, 4096)
    assert serve_soak.main(["--model_id", "tiny-qwen3", "--group_size", "32", "--device", "cpu",
                            "--max_slots", "8", "--n_requests", "40",
                            "--page_alloc", "native"]) == 0
    out = capsys.readouterr().out.splitlines()
    res = json.loads(out[-2])
    assert out[-1] == "PAGES BALANCED; SOAK OK"
    assert res["ok"] and res["done"] == 40 and not res["bad"]
    assert res["free_pages"] == res["free_pages_start"] == 8 * 8
    assert res["page_alloc"] == "native" and res["a8_active"]
    assert res["ended_by_eos"] > 0  # the EOS path ran
