"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have (the exchange between cards is left
out: every cell runs on one card).  The drivers run on the CPU at tiny
sizes through the port's plain kernels, judged by the limits of
``tiny.LIMITS``."""
import pytest
import torch

from portbench.lib.verdict import judge
from portbench.tests import tiny


def _verdict(c, **kw):
    out = tiny.run(c, **kw)
    ok, table = judge(out.checks, c.limits)
    print(c.name, {k: v["value"] for k, v in table.items()})
    return ok, table


@pytest.fixture(params=["qwen3-8b.quantize", "opt-1.3b.quantize"])
def sweep_cell(request):
    conf = tiny.QWEN if request.param.startswith("qwen") else tiny.OPT
    return tiny.cell(request.param, conf, tiny.SWEEP)


def test_sound_sweep_is_correct(sweep_cell):
    ok, table = _verdict(sweep_cell)
    assert ok, table


def test_sweep_that_leaves_the_weights_unchanged_fails(sweep_cell, monkeypatch):
    from tgq_torch.calib import pipeline
    real = pipeline.quantize_weight

    def unchanged(w, *a, **k):
        res = real(w, *a, **k)
        res.w_q = w.float().clone()
        return res
    monkeypatch.setattr(pipeline, "quantize_weight", unchanged)
    ok, table = _verdict(sweep_cell)
    assert not ok, table


def test_sweep_that_leaves_half_the_batch_out_fails(sweep_cell):
    from portbench import faults
    with faults.FAULTS["half_batch"]():
        ok, table = _verdict(sweep_cell)
    assert not ok, table


def test_sweep_that_alters_a_module_s_codes_fails(sweep_cell, monkeypatch):
    from tgq_torch.calib import pipeline
    real = pipeline.quantize_weight

    def altered(w, *a, **k):
        res = real(w, *a, **k)
        if w.shape[0] == w.shape[1]:            # the square modules: q_proj, o_proj, ...
            res.codes = torch.clamp(res.codes + 1, 0, 15)
        return res
    monkeypatch.setattr(pipeline, "quantize_weight", altered)
    ok, table = _verdict(sweep_cell)
    assert not ok, table


@pytest.fixture(params=["qwen3-8b.serve-decode", "qwen3-8b.serve-prefill"])
def serve_cell(request):
    if request.param.endswith("prefill"):
        return tiny.open_loop_cell()
    return tiny.cell(request.param, tiny.QWEN, tiny.CLOSED)


def test_sound_serving_is_correct(serve_cell):
    ok, table = _verdict(serve_cell, seconds=4.0)
    assert ok, table


def test_serving_that_alters_a_token_fails(serve_cell, monkeypatch):
    from tgq_torch.serve import engine
    real = engine.Engine._collect

    def altered(self, chunk):
        chunk.toks = chunk.toks.clone()
        chunk.toks[0] = (chunk.toks[0] + 1) % self.cfg.vocab_size
        return real(self, chunk)
    monkeypatch.setattr(engine.Engine, "_collect", altered)
    ok, table = _verdict(serve_cell, seconds=4.0)
    assert not ok, table


def test_serving_that_leaves_the_cache_unchanged_fails(serve_cell, monkeypatch):
    from tgq_torch.serve import decode
    monkeypatch.setattr(decode, "kv_write_pages", lambda cache, *a, **k: cache)
    ok, table = _verdict(serve_cell, seconds=4.0)
    assert not ok, table


@pytest.mark.parametrize("fault", ["rank", "stale_diagonal"])
def test_sweep_with_a_wrong_rank_or_pivot_walk_fails(fault):
    """The faults of ``portbench/faults.py`` read on the card for the
    solver's limits.  At Qwen3's tiny widths every group is one K1 panel
    and ten times eps keeps the same rank, so they bite at OPT's (n 256)."""
    from portbench import faults
    c = tiny.cell("opt-1.3b.quantize", tiny.OPT, tiny.SWEEP)
    with faults.FAULTS[fault]():
        ok, table = _verdict(c)
    assert not ok, table
