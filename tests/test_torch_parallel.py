"""``tgq_torch.parallel`` on the CPU against the JAX package:

- the device-grid rules, case for case with ``tests/test_launch.py``;
- the slicing rules, leaf for leaf with ``tgq.parallel``'s partition
  specs (``tests/test_parallel.py::test_sharding_rules_shapes`` and
  ``..._packed_bias_and_head``);
- on 4 gloo ranks (data 2 x model 2, one spawn for the module): the mesh
  of ``global_mesh``, the TP+DP forward against the single-rank forward
  and against tgq's forward (rtol = atol = 2e-2, the tolerance of
  ``tests/test_parallel.py``), ``dp_hessian_gram`` against the Gram of
  the whole batch (rtol 1e-5, atol 1e-4, as there), and ``dp_sum``
  against one process adding the same Grams in order, bit for bit;
- the int4 pools a rank packs with one segment against tgq's
  ``pack_segments == tp`` pools, slice by slice, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tgq_torch.models import PRESETS
from tgq_torch.parallel.launch import Device, build_device_grid

CFG = PRESETS["tiny-qwen3"]


def make_pod(hosts: int, local: int, shuffle_seed=None):
    devs = [Device(process_index=h, id=h * local + i) for h in range(hosts) for i in range(local)]
    if shuffle_seed is not None:
        devs = [devs[i] for i in np.random.default_rng(shuffle_seed).permutation(len(devs))]
    return devs


def test_grid_model_axis_intra_host():
    grid = build_device_grid(make_pod(4, 8), local=8)
    assert grid.shape == (4, 8)
    for row in grid:
        assert len({d.process_index for d in row}) == 1
    assert len({grid[i, 0].process_index for i in range(4)}) == 4


def test_grid_ignores_input_ordering():
    grid = build_device_grid(make_pod(2, 4, shuffle_seed=0), local=4)
    assert grid.shape == (2, 4)
    for row in grid:
        assert len({d.process_index for d in row}) == 1
        assert [d.id for d in row] == sorted(d.id for d in row)


def test_grid_sub_host_tp():
    grid = build_device_grid(make_pod(2, 4), local=4, model=2)
    assert grid.shape == (4, 2)
    for row in grid:
        assert len({d.process_index for d in row}) == 1


def test_grid_cross_host_tp():
    grid = build_device_grid(make_pod(4, 4), local=4, model=8)
    assert grid.shape == (2, 8)
    for row in grid:
        assert len({d.process_index for d in row}) == 2


def test_grid_rejects_straddling():
    with pytest.raises(ValueError):
        build_device_grid(make_pod(2, 4), local=4, model=3)


def _jax_specs(tree):
    import jax

    from tgq.parallel import param_sharding_rules

    out = {}
    flat = jax.tree_util.tree_flatten_with_path(param_sharding_rules(tree),
                                                is_leaf=lambda x: x is None)[0]
    for path, spec in flat:
        keys = tuple(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", None))))
                     for p in path)
        out[keys] = tuple(spec)
    return out


def test_sharding_rules_match_jax():
    """Every leaf of a tiny-qwen3 tree (dense, and packed with biases and a
    packed head) gets tgq's spec."""
    import jax

    from tgq.core.packing import PackedLinear as JPacked
    from tgq.core.quant import QuantSpec as JSpec
    from tgq.models import PRESETS as JP
    from tgq.models import init_params as j_init
    from tgq_torch.parallel.mesh import spec_for_path

    jp = j_init(JP["tiny-qwen3"], jax.random.key(0))
    spec = JSpec(bits=8, group_size=32, sym=False)
    pl = JPacked.from_codes(np.zeros((16, 64), np.int32), np.ones((16, 2), np.float32),
                            np.zeros((16, 2), np.float32), spec, bias=np.zeros((16,)))
    packed = {"model": {"layers": [{"self_attn": {"q_proj": pl, "o_proj": pl},
                                    "mlp": {"down_proj": pl}}]}, "lm_head": pl}
    n = 0
    for tree in (jp, packed):
        for keys, want in _jax_specs(tree).items():
            assert spec_for_path(keys) == want, (keys, want)
            n += 1
    assert n > 20
    got = spec_for_path(("model", "layers", "0", "self_attn", "q_proj", "w"))
    assert got == ("model", None)
    assert spec_for_path(("lm_head", "codes")) == (None, "model")


def test_shard_params_slices_and_relabels():
    """Column shards split the outputs, row shards the inputs at a group
    multiple; the packed shards carry their local features and dequantize
    to the matching slice of the whole weight."""
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.parallel.mesh import Mesh, mark_tp_kinds, shard_params

    p = mark_tp_kinds(init_packed_params(CFG, QuantSpec(4, 32), lm_head_bits=8, device="cpu"))
    for r in range(2):
        s = shard_params(p, Mesh(data=1, model=2, model_rank=r))
        lp, full = s["model"]["layers"][0], p["model"]["layers"][0]
        q, o = lp["self_attn"]["q_proj"], lp["self_attn"]["o_proj"]
        assert (q.in_features, q.out_features, q.tp_kind) == (64, CFG.q_size // 2, "col")
        assert (o.in_features, o.out_features, o.tp_kind) == (CFG.q_size // 2, 64, "row")
        wq = full["self_attn"]["q_proj"].dequantize()
        wo = full["self_attn"]["o_proj"].dequantize()
        h = CFG.q_size // 2
        assert torch.equal(q.dequantize(), wq[r * h:(r + 1) * h])
        assert torch.equal(o.dequantize(), wo[:, r * h:(r + 1) * h])
        v = CFG.vocab_size // 2
        assert torch.equal(s["model"]["embed_tokens"]["weight"],
                           p["model"]["embed_tokens"]["weight"][r * v:(r + 1) * v])
        assert torch.equal(lp["input_layernorm"]["weight"], full["input_layernorm"]["weight"])


# ------------------------------------------------ 4 gloo ranks, one spawn


def _ranks(path: str) -> dict:
    """One rank: the mesh, the TP+DP forward and the DP Hessian."""
    import torch.distributed as dist

    from tgq_torch.models.causal_lm import forward
    from tgq_torch.parallel import dp_hessian_gram, local_config, serving_mesh_scope, shard_params
    from tgq_torch.parallel.launch import global_mesh
    from tgq_torch.parallel.mesh import all_reduce, dp_sum
    from tgq_torch.solver.hessian import gram

    params, ids = torch.load(path, weights_only=False)
    mesh = global_mesh(model_per_host=2)
    mine = ids[mesh.data_rank * 2:(mesh.data_rank + 1) * 2]
    with serving_mesh_scope(mesh):
        logits = forward(shard_params(params, mesh), local_config(CFG, mesh), mine,
                         attn_impl="naive")
    x = params["model"]["embed_tokens"]["weight"][mine].float()
    total = all_reduce(torch.tensor([float(dist.get_rank())]), mesh, "model")
    # dp_sum with a batch Gram a sequence: data rank 0 gives its running sum
    parts = [gram(x[i]) for i in range(2)]
    own = parts if mesh.data_rank else parts[0] + parts[1]
    refused = None
    if mesh.data_rank:
        try:
            dp_sum(parts[0], mesh)
            refused = False
        except ValueError:
            refused = True
    return {"shape": mesh.shape, "coords": (mesh.data_rank, mesh.model_rank),
            "model_sum": float(total[0]), "logits": logits, "gram": dp_hessian_gram(x, mesh),
            "dp_sum": dp_sum(own, mesh), "refused": refused, "backend": mesh.backend}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    import jax

    from tgq.models import PRESETS as JP
    from tgq.models import init_params as j_init
    from tgq_torch.models.convert import params_from_numpy
    from tgq_torch.parallel.launch import spawn

    jp = j_init(JP["tiny-qwen3"], jax.random.key(1))
    ids = np.random.default_rng(2).integers(0, CFG.vocab_size, (4, 32))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    path = str(tmp_path_factory.mktemp("tp") / "inputs.pt")
    torch.save((params, torch.from_numpy(ids)), path)
    return jp, params, ids, spawn(_ranks, 4, args=(path,), device="cpu", timeout_s=300)


def test_global_mesh_layout(four_ranks):
    res = four_ranks[3]
    assert [r["shape"] for r in res] == [{"data": 2, "model": 2}] * 4
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # a model row is consecutive ranks: {0, 1} and {2, 3}
    assert [r["model_sum"] for r in res] == [1.0, 1.0, 5.0, 5.0]
    assert {r["backend"] for r in res} == {"gloo"}


def test_tp_forward_matches_single_rank_and_jax(four_ranks):
    import jax.numpy as jnp

    from tgq.models import PRESETS as JP
    from tgq.models import forward as j_forward
    from tgq_torch.models.causal_lm import forward

    jp, params, ids, res = four_ranks
    ref = forward(params, CFG, torch.from_numpy(ids), attn_impl="naive").numpy()
    jref = np.asarray(j_forward(jp, JP["tiny-qwen3"], jnp.asarray(ids), attn_impl="naive"))
    for r in res:
        d = r["coords"][0]
        np.testing.assert_allclose(r["logits"], ref[2 * d:2 * d + 2], rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(r["logits"], jref[2 * d:2 * d + 2], rtol=2e-2, atol=2e-2)
    # the two model ranks of a data row hold the same gathered logits
    np.testing.assert_array_equal(res[0]["logits"], res[1]["logits"])


def test_dp_hessian_exact(four_ranks):
    _, params, ids, res = four_ranks
    x = params["model"]["embed_tokens"]["weight"][torch.from_numpy(ids)].float()
    x = x.reshape(-1, x.shape[-1]).numpy()
    for r in res:
        np.testing.assert_allclose(r["gram"], x.T @ x, rtol=1e-5, atol=1e-4)


def test_dp_sum_adds_in_single_process_order(four_ranks):
    """Data rank 0's running sum of its Grams and data rank 1's list sum to
    the single process's ((g0 + g1) + g2) + g3, bit for bit; a later data
    rank may not give a running sum."""
    from tgq_torch.solver.hessian import gram

    _, params, ids, res = four_ranks
    x = params["model"]["embed_tokens"]["weight"][torch.from_numpy(ids)].float()
    want = torch.zeros(x.shape[-1], x.shape[-1])
    for i in range(4):
        want += gram(x[i])
    for r in res:
        np.testing.assert_array_equal(r["dp_sum"], want.numpy())
        assert r["refused"] is (True if r["coords"][0] else None)


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_rank_pools_match_jax_segments(rng, tp):
    """tgq's int4 pool packed with ``pack_segments == tp``, sliced by shard,
    is byte for byte the pool a rank packs from its own kv heads (one
    segment); the port's segmented packing equals tgq's too."""
    import jax
    import jax.numpy as jnp

    from tgq.serve.kv_cache import _absmax_quantize4 as j_q4
    from tgq.serve.kv_cache import kv_unpack4 as j_unpack4
    from tgq_torch.serve.kv_cache import _absmax_quantize4, kv_unpack4

    kvh, d = 8, 16
    x = rng.standard_normal((5, 3, kvh, d)).astype(np.float32)
    # jitted, as tgq's writes run it (XLA turns / 7.0 into the port's * (1/7))
    jcodes, js = jax.jit(j_q4, static_argnames="segments")(jnp.asarray(x), segments=tp)
    jcodes, js = np.asarray(jcodes), np.asarray(js)
    codes, s = _absmax_quantize4(torch.from_numpy(x), segments=tp)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(kv_unpack4(codes, segments=tp).numpy(),
                                  np.asarray(j_unpack4(jnp.asarray(jcodes), segments=tp)))
    n, b = kvh // tp, jcodes.shape[-1] // tp
    for r in range(tp):
        local, ls = _absmax_quantize4(torch.from_numpy(x[..., r * n:(r + 1) * n, :].copy()))
        np.testing.assert_array_equal(local.numpy(), jcodes[..., r * b:(r + 1) * b])
        np.testing.assert_array_equal(ls.numpy(), js[..., r * n:(r + 1) * n])


def test_paged_cache_layouts():
    """A cache takes pack_segments only for int4 pools whose kv heads split
    into even segments."""
    from tgq_torch.serve.kv_cache import PagedKVCache

    k = torch.zeros((1, 2, 4, 32), dtype=torch.uint8)
    assert PagedKVCache(k=k, v=k, num_kv_heads=4, pack_segments=2).pack_segments == 2
    for bad in (dict(num_kv_heads=4, pack_segments=3),
                dict(num_kv_heads=2, pack_segments=4)):
        with pytest.raises(ValueError):
            PagedKVCache(k=k, v=k, **bad)
    kb = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        PagedKVCache(k=kb, v=kb, num_kv_heads=4, pack_segments=2)
    assert dataclasses.replace(PagedKVCache(k=k, v=k, num_kv_heads=2)).pack_segments == 1
