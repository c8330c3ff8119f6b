"""The calibration sweep of GPT-2, OPT and the sketch (``mode="svd"``)
under a (data 2 x model 2) mesh and a (data 4 x model 1) mesh, on 4 gloo
CPU ranks (one spawn for the module), against the single-rank sweep and
against tgq's mesh sweep on the virtual CPU devices
(``attn_impl="naive"``, no Pallas kernel).

Against the single rank:
- GPT-2 splits nothing in a layer, and a data-only mesh splits no layer,
  so there every code, every written-back weight, every stat and every
  finalized sketch is the single rank's bit for bit (``dp_sum`` adds the
  batch parts in the single process's order);
- OPT under model 2 splits q/k/v by heads: layer 0's q/k/v see the
  single-rank Hessian (from the replicated LayerNorm input), its other
  modules the heads gathered in order, and all are bit-equal; the rest is
  held to ``tests/test_pipeline_mesh.py``'s limits
  (under 2 % of a q_proj's weights off by more than 1e-6, perplexity
  within 2 %);
- llama (tiny-qwen3) under model 2 all-reduces o_proj's and down_proj's
  bf16 partial sums, so past layer 0's attention its inputs are not the
  single rank's: its layer-0 q/k/v and o_proj sketches and codes are held
  bit for bit, the perplexity within the same 2 %.

Against tgq's mesh sweep: the family pins of ``test_torch_families.py``
(code agreement, per-module rel_error within ``REL_ERROR_FACTOR``) and,
for svd, per-module rel_error within the 10 % of
``test_torch_agreement.py::test_svd_rel_error_within_ten_percent`` (the
two packages draw different Gaussian sketches).
"""
import copy

import numpy as np
import pytest
import torch

from tgq_torch.models import PRESETS

# test_torch_families.py's setting (pchol) and test_torch_agreement.py's (svd),
# at 16 samples in batches of 4: each of 4 data ranks holds one whole batch
# of the single rank's (the port's data split), and tgq splits each batch
# over 4 devices (its data split)
KW = {"pchol": dict(mode="pchol", w_bits=4, group_size=32, batch_size=4, block_size=32,
                    eps=1e-6, threshold_method="energy", attn_impl="naive"),
      "svd": dict(mode="svd", w_bits=4, group_size=32, actorder=True, batch_size=4,
                  block_size=32, eps=1e-6, threshold_method="energy", attn_impl="naive")}
CALIB = {"pchol": dict(n_samples=16, seq_len=64, seed=42),
         "svd": dict(n_samples=16, seq_len=32, seed=42)}
CASES = (("tiny-gpt2", "pchol"), ("tiny-opt", "pchol"), ("tiny-gpt2", "svd"),
         ("tiny-qwen3", "svd"))
MESHES = ((2, 2), (4, 1))   # (data, model)


def _calib(preset: str, mode: str):
    from tgq_torch.calib.data import synthetic_calibration

    return synthetic_calibration(PRESETS[preset].vocab_size, **CALIB[mode])


def _sweep(params, preset: str, mode: str, mesh=None) -> dict:
    """One port sweep: its packed codes, layer stats, finalized svd
    sketches (in group order) and written-back params."""
    from tgq_torch.calib import QuantizeConfig, pipeline, quantize_model

    sketches, factorize = [], pipeline._factorize

    def capture(h_or_y, qcfg, eps):
        if qcfg.mode == "svd":
            sketches.append(h_or_y.clone())
        return factorize(h_or_y, qcfg, eps)

    pipeline._factorize = capture
    try:
        p, packed, log = quantize_model(params, PRESETS[preset], _calib(preset, mode),
                                        QuantizeConfig(**KW[mode]), device="cpu", mesh=mesh)
    finally:
        pipeline._factorize = factorize
    return {"codes": {k: v.codes for k, v in packed.items()},
            "stats": [(s["name"], s["rank"], s["rel_error"]) for s in log["layer_stats"]],
            "sketches": sketches, "params": p}


def _ranks(paths: dict) -> dict:
    """This rank's share of the single-rank sweeps (run in the ranks: the
    CPU GEMMs' and LAPACK's last bits depend on the thread count), then
    every mesh sweep."""
    from tgq_torch.parallel import make_mesh

    load = lambda preset: torch.load(paths[preset], weights_only=False)  # noqa: E731
    single = {(p, m): _sweep(load(p), p, m)
              for p, m in CASES[torch.distributed.get_rank()::4]}
    # every rank creates every mesh's groups, in one order
    meshes = {shape: make_mesh(*shape) for shape in MESHES}
    mesh = {(p, m, shape): _sweep(load(p), p, m, meshes[shape])
            for shape in MESHES for p, m in CASES}
    return {"single": single, "mesh": mesh}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' sweeps, spawned first, and meanwhile tgq's mesh sweeps
    of every case in this process."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from tgq.calib import QuantizeConfig as JConfig
    from tgq.calib import quantize_model as j_quantize
    from tgq.models import PRESETS as JP
    from tgq.models import init_params as j_init
    from tgq.parallel import make_mesh as j_make_mesh
    from tgq_torch.models.convert import params_from_numpy
    from tgq_torch.parallel.launch import spawn

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jps = {p: j_init(JP[p], jax.random.key(0)) for p in sorted({p for p, _ in CASES})}
    paths = {}
    for p, jp in jps.items():
        paths[p] = str(tmp_path_factory.mktemp("mesh_families") / f"{p}.pt")
        torch.save(params_from_numpy(jax.tree.map(np.asarray, jp)), paths[p])
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _ranks, 4, args=(paths,), device="cpu", timeout_s=300)
        jax_runs = {}
        for p, m in CASES:
            for data, model in MESHES:
                mesh = j_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
                _, packed, log = j_quantize(copy.deepcopy(jps[p]), JP[p], _calib(p, m),
                                            JConfig(**KW[m]), mesh=mesh)
                jax_runs[(p, m, (data, model))] = (packed, log["layer_stats"])
        res = ranks.result()
    single = {k: v for r in res for k, v in r["single"].items()}
    return single, jax_runs, [r["mesh"] for r in res]


def _unpack(codes, pl):
    """The codes of a packed linear laid out as ``pl``."""
    from tgq_torch.core.packing import unpack_rows

    return unpack_rows(torch.as_tensor(np.array(codes)).T, pl.bits, pl.group_size,
                       pl.in_features).numpy()


def _ppl(params, preset: str) -> float:
    from tgq_torch.calib.data import synthetic_eval_stream
    from tgq_torch.eval.ppl import perplexity_from_token_stream

    cfg = PRESETS[preset]
    eval_ids = synthetic_eval_stream(cfg.vocab_size, 1024, seed=3)
    return perplexity_from_token_stream(params, cfg, eval_ids, max_length=64, stride=32,
                                        attn_impl="naive")


def _weight(params, name: str) -> np.ndarray:
    """The weight of the linear at dotted path ``name`` as f32 numpy."""
    for part in name.split("."):
        params = params[int(part)] if isinstance(params, list) else params[part]
    return np.asarray(params["w"], np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _key(stat_name: str) -> str:
    """The packed export's key of a layer_stats name ("layer_<i>.<path>")."""
    return "layers." + stat_name[len("layer_"):]


def _exact(res: dict, single: dict, modules=None, groups=None) -> None:
    """``res`` equals ``single`` bit for bit: every code, written-back
    weight, stat and sketch, or only those of ``modules`` and of the
    first ``groups`` groups."""
    keep = (lambda k: True) if modules is None else (lambda k: k in modules)  # noqa: E731
    for k, c in single["codes"].items():
        if keep(k):
            np.testing.assert_array_equal(res["codes"][k], c, err_msg=k)
            np.testing.assert_array_equal(_weight(res["params"], "model." + k),
                                          _weight(single["params"], "model." + k), err_msg=k)
    assert [s for s in res["stats"] if keep(_key(s[0]))] == \
        [s for s in single["stats"] if keep(_key(s[0]))]
    assert len(res["sketches"]) == len(single["sketches"])
    for gi, (a, b) in enumerate(zip(res["sketches"], single["sketches"])):
        if groups is None or gi < groups:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"sketch {gi}")


def _within_limits(res: dict, single: dict, preset: str, q_proj: str) -> None:
    """tests/test_pipeline_mesh.py's limits: under 2 % of ``q_proj``'s
    weights off by more than 1e-6, perplexity within 2 %.  Every layer's
    q_proj share is printed."""
    from tgq_torch.models.convert import params_from_numpy

    moved = {li: (np.abs(_weight(res["params"], f"model.layers.{li}.self_attn.q_proj")
                         - _weight(single["params"], f"model.layers.{li}.self_attn.q_proj"))
                  > 1e-6).mean() for li in range(PRESETS[preset].num_layers)}
    ppl1, ppl2 = (_ppl(params_from_numpy(r["params"]), preset) for r in (single, res))
    print(f"{preset}: q_proj weights moved by layer {moved}, PPL {ppl2:.4f} vs single "
          f"{ppl1:.4f}")
    held = moved[int(q_proj.split(".")[2])]
    assert held < 0.02 and abs(ppl1 - ppl2) / ppl1 < 0.02, (q_proj, held, ppl1, ppl2)


@pytest.mark.parametrize("case", CASES, ids="-".join)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_ranks_write_back_the_same_model(runs, case, shape):
    res = [r[(*case, shape)] for r in runs[2]]
    for r in res[1:]:
        assert r["stats"] == res[0]["stats"]
        for k, c in res[0]["codes"].items():
            np.testing.assert_array_equal(r["codes"][k], c, err_msg=k)
    assert len(res[0]["codes"]) == PRESETS[case[0]].num_layers * \
        (4 if case[0] == "tiny-gpt2" else 6 if case[0] == "tiny-opt" else 7)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_gpt2_equals_single_rank(runs, shape):
    """Nothing in a GPT-2 layer is split: the mesh sweep is the single
    rank's in every layer."""
    single, _, ranks = runs
    _exact(ranks[0][("tiny-gpt2", "pchol", shape)], single[("tiny-gpt2", "pchol")])


def test_opt_against_single_rank(runs):
    single, _, ranks = runs
    one = single[("tiny-opt", "pchol")]
    # data only: nothing split, every layer bit for bit
    _exact(ranks[0][("tiny-opt", "pchol", (4, 1))], one)
    res = ranks[0][("tiny-opt", "pchol", (2, 2))]
    # layer 0's q/k/v see the replicated LayerNorm input, and its out_proj,
    # fc1 and fc2 the heads gathered from the ranks in order
    _exact(res, one, modules={k for k in one["codes"] if k.startswith("layers.0.")})
    _within_limits(res, one, "tiny-opt", "model.layers.1.self_attn.q_proj")


@pytest.mark.parametrize("preset", ["tiny-gpt2", "tiny-qwen3"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_svd_sketches_and_codes_equal_single_rank(runs, preset, shape):
    """Every data rank draws the projections of the earlier ranks' batches
    first, so each finalized sketch is the single rank's bit for bit
    wherever the layer's inputs are."""
    single, _, ranks = runs
    res, one = ranks[0][(preset, "svd", shape)], single[(preset, "svd")]
    if preset == "tiny-qwen3" and shape[1] > 1:
        layer0 = {f"layers.0.self_attn.{n}" for n in ("q_proj", "k_proj", "v_proj", "o_proj")}
        _exact(res, one, modules=layer0, groups=2)
        # layer 1's inputs pass the row-parallel all-reduces (15 % of its
        # q_proj weights move in this test on the CPU; 11 % of Qwen3-8B's
        # under pchol on an H100): test_pipeline_mesh.py holds layer 0's
        # q_proj and the PPL
        _within_limits(res, one, preset, "model.layers.0.self_attn.q_proj")
    else:
        _exact(res, one)


def _pinned_against_jax(res: dict, jpacked: dict, jstats: list, agreement: float,
                        factor: float) -> float:
    """Codes agreeing with tgq's at least ``agreement``, each module's
    rel_error within ``factor`` of tgq's; returns the agreement."""
    same = total = 0
    for key, c in res["codes"].items():
        tc, jc = _unpack(c, jpacked[key]), _unpack(jpacked[key].codes, jpacked[key])
        same += int((tc == jc).sum())
        total += tc.size
    assert [s[0] for s in res["stats"]] == [s["name"] for s in jstats]
    for (name, _, rel), j in zip(res["stats"], jstats):
        assert 1 / factor <= rel / j["rel_error"] <= factor, (name, rel, j["rel_error"])
    assert same / total >= agreement, same / total
    return same / total


@pytest.mark.parametrize("preset", ["tiny-gpt2", "tiny-opt"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_families_against_jax_mesh_sweep(runs, preset, shape):
    from test_torch_families import AGREEMENT, REL_ERROR_FACTOR

    _, jax_runs, ranks = runs
    share = _pinned_against_jax(ranks[0][(preset, "pchol", shape)],
                                *jax_runs[(preset, "pchol", shape)], AGREEMENT[preset],
                                REL_ERROR_FACTOR)
    print(f"{preset} {shape}: codes agreeing with tgq's mesh sweep {share:.4f}")


@pytest.mark.parametrize("preset", ["tiny-gpt2", "tiny-qwen3"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_svd_against_jax_mesh_sweep(runs, preset, shape):
    _, jax_runs, ranks = runs
    res = ranks[0][(preset, "svd", shape)]
    _, jstats = jax_runs[(preset, "svd", shape)]
    gaps = [abs(rel / j["rel_error"] - 1) for (_, _, rel), j in zip(res["stats"], jstats)]
    print(f"svd {preset} {shape}: most rel_error gap {max(gaps):.4f}")
    assert len(gaps) == len(res["stats"]) == len(jstats) and max(gaps) <= 0.10, gaps


@pytest.mark.parametrize("preset,split", [("tiny-qwen3", (True, True)),
                                          ("tiny-opt", (True, False)),
                                          ("tiny-gpt2", (False, False))])
def test_local_config_follows_the_rules(preset, split):
    """A rank's heads are split where q/k/v_proj are, its MLP width where
    gate/up_proj are: llama both, OPT its heads, GPT-2 neither."""
    from tgq_torch.parallel import Mesh, local_config

    cfg = PRESETS[preset]
    got = local_config(cfg, Mesh(data=1, model=2))
    heads, mlp = split
    assert (got.num_heads, got.num_kv_heads, got.intermediate_size) == (
        cfg.num_heads // 2 if heads else cfg.num_heads,
        cfg.num_kv_heads // 2 if heads else cfg.num_kv_heads,
        cfg.intermediate_size // 2 if mlp else cfg.intermediate_size)
    assert (got.hidden_size, got.vocab_size) == (cfg.hidden_size, cfg.vocab_size)


def test_sketch_split_equals_one_process():
    """The sketches of three data ranks (two batches each, the later ones
    drawing the earlier ranks' projections first and keeping their parts),
    summed in order, are one process's sketch bit for bit, at a sketch rank
    whose draws have a tail."""
    from tgq_torch.solver.hessian import SketchAccumulator

    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((3, 40, 16), generator=gen).bfloat16() for _ in range(6)]
    one = SketchAccumulator.init(16, rank=63, seed=5)
    for x in xs:
        one.update(x)
    ranks = [SketchAccumulator.init(16, rank=63, seed=5, keep_parts=r > 0, first_batch=2 * r)
             for r in range(3)]
    for r, acc in enumerate(ranks):
        for x in xs[2 * r:2 * r + 2]:
            acc.update(x)
    total = ranks[0].own().clone()
    for acc in ranks[1:]:
        for part in acc.own():
            total += part
    got = SketchAccumulator.normalize(total, sum(acc.n_samples for acc in ranks))
    assert torch.equal(got, one.finalize())
