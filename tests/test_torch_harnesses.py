"""The port's timing CLIs and table runners on the CPU at tiny sizes, held
against the JAX package's tools (``tgq/cli/{kernel_bench,decode_bench,
gptq_kernel_bench,kv_quality,synthetic_bench,run_benchmark,run_experiments,
run_baseline,extract_log}.py``).

Timing tools: their JSON line has the JAX tool's keys (``kernel_bench`` and
``gptq_kernel_bench`` are run beside the JAX tools; ``decode_bench``'s
JAX tool needs its Pallas kernel interpreted, 30 s at the smallest size,
so its keys are read from its source).  Tolerances, beside the values
measured here:
- ``kv_quality``: the same rows in the same order, each rel_err within
  KVQ_RTOL = 1e-3 relative of the JAX tool's (measured at most 7.3e-5 at
  contexts 128-2048, 3.5e-6 at the test's 64/256: the two
  packages' attention sums in another order; the cache codes are
  bit-equal).
- ``synthetic_bench``: activations bit-equal (the same numpy calls);
  rel_output_error within SYN_ATOL = 1e-4 of the JAX tool's (both round
  to 6 decimals; measured 0: equal at every row).
- ``run_benchmark`` on one tiny-qwen3 HF checkpoint (exported by the JAX
  package, read by both CLIs): every row OK, each PPL within
  PPL_RTOL = 0.5 % of the JAX run's (measured -0.003 %, -0.024 % and
  +0.033 % for FP16_Baseline, GPTQ_W4_Asym and Trunc_W4_Asym).
"""
import contextlib
import csv
import io
import json
import os

import jax
import numpy as np
import pytest

from tgq.models import PRESETS as J_PRESETS
from tgq.models import init_params as j_init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KVQ_RTOL = 1e-3
SYN_ATOL = 1e-4
PPL_RTOL = 5e-3


def last_json(fn, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


# ------------------------------------------------------------ timing tools

KB = ["--model_id", "tiny-qwen3", "--group_size", "32", "--tokens", "8", "--reps", "2"]


def test_kernel_bench_keys_match_jax():
    from tgq.cli.kernel_bench import main as j_main
    from tgq_torch.cli.kernel_bench import main

    jres = last_json(j_main, KB)
    for extra in ([], ["--a_bits", "8"]):
        res = last_json(main, KB + ["--device", "cpu"] + extra)
        assert set(res) == set(jres), (set(res), set(jres))
        assert set(res["config"]) >= set(jres["config"])
        assert len(res["shapes"]) == 4
        assert all(set(r) >= {"shape", "ms", "weight_GB_s", "frac_peak"} for r in res["shapes"])
        assert [r["shape"].split()[0] for r in res["shapes"]] == [
            "qkv_fused_equiv(q)", "o_proj", "gate_proj", "down_proj"]
    assert res["config"]["a_bits"] == 8
    assert all("quantize_activations_ms" in r for r in res["shapes"])


def test_kernel_bench_all_shapes_unstable():
    """A peak so low that every reading is above 1.2x it: each shape is
    skipped, and the line says so (the JAX tool divides by zero here)."""
    from tgq_torch.cli.kernel_bench import main

    res = last_json(main, KB + ["--device", "cpu", "--peak_gbps", "1e-9"])
    assert res["status"] == "all shapes unstable" and res["value"] is None
    assert res["shapes"] == [] and len(res["unstable"]) == 4


def test_decode_bench_keys_match_jax():
    from tgq_torch.cli.decode_bench import main

    src = open(os.path.join(REPO, "tgq", "cli", "decode_bench.py")).read()
    argv = ["--model_id", "tiny-qwen3", "--group_size", "32", "--slots", "2", "--context",
            "32", "--page_size", "8", "--reps", "2", "--device", "cpu"]
    res = last_json(main, argv)
    assert set(res) == {"metric", "value", "unit", "config", "components"}
    assert res["metric"] == "decode_step_component_ms"
    parts = {"attention_ms", "matmuls_ms", "lm_head_ms", "kv_write_ms", "sampling_ms"}
    assert set(res["components"]) == parts | {"composed_ms"}
    assert all(f'"{k}"' in src for k in parts | {"composed_ms"})
    assert abs(res["value"] - sum(res["components"][k] for k in parts)) < 1e-3
    for key in ("model", "slots", "context", "page_size", "w_bits", "kv_bits", "a_bits",
                "lm_head_bits"):
        assert f'"{key}"' in src and key in res["config"]
    res = last_json(main, argv + ["--skip_components", "--kv_bits", "4", "--a_bits", "8",
                                  "--lm_head_bits", "16"])
    assert set(res) == {"metric", "value", "unit", "config"}
    assert res["metric"] == "decode_step_composed_ms" and res["value"] > 0


def test_gptq_kernel_bench_keys_match_jax():
    from tgq.cli.gptq_kernel_bench import main as j_main
    from tgq_torch.cli.gptq_kernel_bench import main

    argv = ["--shapes", "64x128,32x64", "--block_size", "32", "--group_size", "32"]
    jres = last_json(j_main, argv)
    res = last_json(main, argv + ["--device", "cpu"])
    assert set(res) == set(jres)
    assert set(res["results"]) == {"plain"} and set(res["results"]["plain"]) == {
        "64x128", "32x64"}


# --------------------------------------------------------------- kv_quality


def test_kv_quality_matches_jax():
    from tgq.cli.kv_quality import run as j_run
    from tgq_torch.cli.kv_quality import run

    contexts = [64, 256]
    jrows = j_run(contexts, seed=0)
    rows = run(contexts, seed=0, device="cpu")
    assert [(r["format"], r["context"]) for r in rows] == [
        (r["format"], r["context"]) for r in jrows]
    worst = max(abs(r["rel_err"] - j["rel_err"]) / j["rel_err"] for r, j in zip(rows, jrows))
    assert worst <= KVQ_RTOL, worst
    # the equalizers cut the error of their format at every context
    err = {(r["format"], r["context"]): r["rel_err"] for r in rows}
    for n in contexts:
        assert err[("int8+eq", n)] < err[("int8", n)] and err[("int4+eq", n)] < err[("int4", n)]


# ---------------------------------------------------------- synthetic_bench


def test_synthetic_bench_matches_jax(tmp_path):
    from tgq.cli import synthetic_bench as J
    from tgq_torch.cli import synthetic_bench as T

    for kind in ("gaussian", "ar1", "student_t", "ar1_t", "lognormal"):
        a = J.make_activations(kind, np.random.default_rng(5), 48, 16)
        b = T.make_activations(kind, np.random.default_rng(5), 48, 16)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), kind
    argv = ["--n_tokens", "512", "--n_features", "64", "--out_features", "32",
            "--group_size", "32", "--bits", "4,2", "--distributions", "gaussian,ar1"]
    with contextlib.redirect_stdout(io.StringIO()):
        J.main(argv + ["--out", str(tmp_path / "j.csv")])
        T.main(argv + ["--device", "cpu", "--out", str(tmp_path / "t.csv")])
    jrows = list(csv.DictReader(open(tmp_path / "j.csv")))
    rows = list(csv.DictReader(open(tmp_path / "t.csv")))
    assert len(rows) == len(jrows) == 16
    worst = 0.0
    for r, j in zip(rows, jrows):
        assert (r["dist"], r["bits"], r["method"], r["rank"]) == (
            j["dist"], j["bits"], j["method"], j["rank"])
        worst = max(worst, abs(float(r["rel_output_error"]) - float(j["rel_output_error"])))
    assert worst <= SYN_ATOL, worst
    rows = [{**r, "bits": int(r["bits"]), "rel_output_error": float(r["rel_output_error"])}
            for r in rows]
    rtn = {(r["dist"], r["bits"]): r["rel_output_error"] for r in rows if r["method"] == "rtn"}
    for r in rows:
        if r["method"] in ("pchol", "eigh") and r["bits"] == 4:
            assert np.isfinite(r["rel_output_error"])
            assert r["rel_output_error"] <= rtn[(r["dist"], 4)], r


# ------------------------------------------------------------ table runners


def test_experiment_lists_match_jax():
    from tgq.cli import run_benchmark as J
    from tgq_torch.cli import run_benchmark as T
    from tgq_torch.cli.args import build_parser

    base = ["--model_id", "m", "--dataset", "synthetic", "--no_save"]
    for solver in ("eigh", "pchol"):
        exps = T.experiment_list(solver)
        assert exps == J.experiment_list(solver) and len(exps) == 11
        for exp in exps:
            argv = T.experiment_argv(exp, base, "out")
            assert argv == J.experiment_argv(exp, base, "out")
            args = build_parser().parse_args(argv)
            assert args.mode == exp["mode"] and args.sym == bool(exp.get("sym"))


@pytest.fixture(scope="module")
def hf_tiny(tmp_path_factory):
    """tiny-qwen3 as an HF checkpoint, written by the JAX package, so that
    both packages' CLIs quantize the same weights."""
    from tgq.models.hf_export import export_hf

    path = str(tmp_path_factory.mktemp("hf") / "tiny-qwen3")
    export_hf(path, j_init_params(J_PRESETS["tiny-qwen3"], jax.random.key(0)),
              J_PRESETS["tiny-qwen3"])
    return path


def table_argv(model: str, out: str) -> list[str]:
    return ["--model_id", model, "--dataset", "synthetic", "--n_samples", "4", "--seq_len",
            "64", "--batch_size", "2", "--group_size", "-1", "--solver", "pchol",
            "--out", out, "--attn_impl", "naive",
            "--only", "FP16_Baseline,GPTQ_W4_Asym,Trunc_W4_Asym"]


def test_run_benchmark_matches_jax(tmp_path, hf_tiny):
    """As tests/test_cli.py::test_run_benchmark_table, on one checkpoint for
    both packages: every row OK, and each PPL within PPL_RTOL of the JAX
    run's; then extract_log over the port's run finds its modules."""
    from tgq.cli.run_benchmark import main as j_main
    from tgq_torch.cli.extract_log import main as x_main
    from tgq_torch.cli.run_benchmark import main

    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(table_argv(hf_tiny, out) + ["--device", "cpu"]) == 0
        assert j_main(table_argv(hf_tiny, jout)) == 0
    rows = list(csv.DictReader(open(os.path.join(out, "final_benchmark.csv"))))
    jrows = list(csv.DictReader(open(os.path.join(jout, "final_benchmark.csv"))))
    assert [r["name"] for r in rows] == ["FP16_Baseline", "GPTQ_W4_Asym", "Trunc_W4_Asym"]
    assert all(r["status"] == "OK" for r in rows + jrows), rows + jrows
    for r, j in zip(rows, jrows):
        assert abs(float(r["ppl"]) / float(j["ppl"]) - 1) <= PPL_RTOL, (r, j)
    assert os.path.exists(os.path.join(out, "results_partial.csv"))

    summary = str(tmp_path / "summary.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        assert x_main([out, "--out", summary]) == 0
    mods = {r["module"] for r in csv.DictReader(open(summary))}
    assert {"q_proj", "down_proj"} <= mods, mods


def test_failed_row_is_recorded_not_raised(tmp_path):
    """A row that fails is caught so that the sweep goes on, and says so in
    its status: a caller that needs every row must check ``status``."""
    from tgq_torch.cli.run_benchmark import run_experiment

    row = run_experiment({"name": "bad", "mode": "gptq", "w_bits": 4},
                         ["--model_id", str(tmp_path / "missing"), "--device", "cpu"],
                         str(tmp_path))
    assert row["status"].startswith("Failed") and row["ppl"] is None


def test_run_baseline_and_experiments(tmp_path, hf_tiny):
    from tgq_torch.cli.run_baseline import run as run_baseline
    from tgq_torch.cli.run_experiments import run as run_experiments

    common = ["--model_id", hf_tiny, "--dataset", "synthetic", "--n_samples", "4",
              "--seq_len", "64", "--batch_size", "2", "--group_size", "-1", "--attn_impl",
              "naive", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        rows = run_baseline(common + ["--out", str(tmp_path / "b")])
        grid = run_experiments(common + ["--out", str(tmp_path / "e"), "--solver", "pchol",
                                         "--eps_grid", "1e-6,1e-2", "--bits", "4"])
    assert [r["name"] for r in rows] == ["FP_Baseline", "GPTQ_4bit"]
    assert [r["name"] for r in grid] == ["W4_Sym_eps1e-06", "W4_Sym_eps0.01",
                                         "W4_Asym_eps1e-06", "W4_Asym_eps0.01"]
    assert all(r["status"] == "OK" and np.isfinite(r["ppl"]) for r in rows + grid)
    assert len(list(csv.DictReader(open(tmp_path / "e" / "final_results.csv")))) == 4
