"""The plain reference against the port's plain path on the CPU, at tiny
sizes of the two families (tiny-qwen3 and tiny-opt widths)."""
import numpy as np
import pytest
import torch

from portbench.lib import bench, weights
from portbench.reference import truncgptq as ref
from portbench.tests import tiny


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("conf", [tiny.QWEN, tiny.OPT], ids=["tiny-qwen3", "tiny-opt"])
def test_reference_forward_matches_the_port(conf):
    from tgq_torch.models.causal_lm import forward

    from portbench.lib.runctx import model_config
    fam = bench.family(conf["family"])
    d = fam.dims(conf)
    params = weights.make_params(d, 2**31 + 5, torch.bfloat16, "cpu")
    ids = torch.randint(0, d.vocab, (2, 48), generator=torch.Generator().manual_seed(0))
    port = forward(params, model_config(conf, "tiny"), ids, attn_impl="naive")
    o = fam.ref_outer(d, params, torch.float32)
    x = fam.ref_embed(d, o, ids, torch.float32)
    for li, lp in enumerate(params["model"]["layers"]):
        w = {p: (weights.get(lp, p)["w"].float(),
                 weights.get(lp, p)["b"].float() if "b" in weights.get(lp, p) else None)
             for p, *_ in fam.layer_plan(d, li).linears}
        *_, x = fam.ref_layer(d, li, w, fam.ref_tensors(d, lp, torch.float32), x)
    logits = fam.ref_final(d, o, x) @ o["head"].float().T
    # the port computes in bf16 (its activations), the reference in f32
    assert _rel(port, logits) < 3e-2


def test_reference_rtn_matches_the_port():
    from tgq_torch.core.quant import QuantSpec, fake_quantize
    w = torch.randn(16, 256, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ref.rtn(w, 4, 128)[0], fake_quantize(w, QuantSpec(4, 128, False)))


def _hessian(n, tokens, seed):
    x = torch.randn(tokens, n, generator=torch.Generator().manual_seed(seed))
    return x.T @ x / tokens


def test_reference_pivoted_cholesky_matches_the_port():
    from tgq_torch.solver.pchol import pchol_factor
    h = _hessian(96, 400, 2)
    port = pchol_factor(h, eps=1e-6, backend="plain")
    L, perm, piv, regret = ref.pivoted_cholesky(h.double(), panel=32)
    rank = ref.energy_rank(L, piv, float(torch.diagonal(h).double().sum()), 1e-6, 1e-6)
    assert torch.equal(perm, port.perm.long()) and rank == port.rank
    assert float(regret.max()) == 0.0
    r = ref.truncated_factor(L, perm, rank)
    assert _rel(port.r_full, r) < 1e-4


def test_reference_truncated_factor_on_a_singular_hessian():
    from tgq_torch.solver.pchol import pchol_factor
    h = _hessian(64, 40, 3)          # rank 40 of 64
    port = pchol_factor(h, eps=1e-6, backend="plain")
    L, perm, piv, _ = ref.pivoted_cholesky(h.double())
    rank = ref.energy_rank(L, piv, float(torch.diagonal(h).double().sum()), 1e-6, 1e-6)
    assert rank == port.rank <= 40
    r = ref.truncated_factor(L, port.perm.long(), port.rank)
    assert _rel(port.r_full, r) < 1e-3


def test_reference_gptq_matches_the_port():
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.solver.gptq_loop import quantize_weight
    from tgq_torch.solver.pchol import pchol_factor
    h = _hessian(128, 600, 4)
    w = torch.randn(32, 128, generator=torch.Generator().manual_seed(5)) / 8
    f = pchol_factor(h, eps=1e-6, backend="plain")
    port = quantize_weight(w, f, QuantSpec(4, 32, False), block_size=64, backend="plain")
    sc, ze = ref.find_params(w, 4, 32)
    assert torch.equal(sc, port.scale) and torch.equal(ze, port.zero)
    codes = ref.gptq(w.double(), f.r_full.double(), f.perm.long(), sc.double(), ze.double(),
                     4, 32, 64)
    assert float((codes != port.codes.double()).double().mean()) < 0.01


def test_unpack_reads_the_port_packing():
    from tgq_torch.core.packing import PackedLinear
    from tgq_torch.core.quant import QuantSpec
    q = torch.randint(0, 16, (24, 256), generator=torch.Generator().manual_seed(6))
    pl = PackedLinear.from_codes(q, torch.ones(24, 2), torch.zeros(24, 2), QuantSpec(4, 128, False))
    assert torch.equal(ref.unpack_int4(pl.codes, 24, 256, 128), q.to(torch.int32))


@pytest.mark.parametrize("conf", [tiny.QWEN, tiny.OPT], ids=["tiny-qwen3", "tiny-opt"])
def test_sound_sweep_reads_small_numbers(conf):
    out = tiny.run(tiny.cell("qwen3-8b.quantize", conf, tiny.SWEEP))
    c = out.checks
    assert c["sweeps_differ"] == 0 and c["grid_miss"] == 0 and c["rank_gap"] == 0
    assert c["gram_rel"] < 0.05 and c["act_rel"] < 0.05 and c["factor_rel"] < 0.1
    assert c["code_miss"] < 0.05 and abs(c["loss_ratio"] - 1) < 0.05
    assert np.isfinite(out.e2e["quantize_s_per_layer"])
