"""The analysis CLIs of slice 9 against the JAX package on the CPU:
``trunc_regimes`` (rows of one cell equal), ``tiny_train`` (the Markov
source and stream bit-equal; training lowers the loss and reaches a PPL far
below uniform in both packages), ``tiny_quality_bench`` (the same table),
``diff_baseline`` / ``reproduce_baseline --smoke`` (the verdicts of
``scripts/diff_baseline.py``) and ``boundary_bench``."""
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_thread():
    """Tiny eager models run thousands of small ops: one intra-op thread
    keeps them fast when the suite's workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ----------------------------------------------------------- trunc_regimes


@pytest.mark.parametrize("spectrum", ["log", "outlier", "channel"])
def test_trunc_regimes_cell_matches_jax(spectrum):
    """Same numpy draws, host f64 factors in both packages and bit-exact
    GPTQ sweeps: every row equal, the errors (rounded to 6 digits) within
    one unit of the last digit."""
    from tgq.cli import trunc_regimes as J
    from tgq_torch.cli import trunc_regimes as T

    args = (64, 32, 6.0, 48, (2, 4), 1, 32, 0.01, False)
    rows_j = J.run_cell(*args, spectrum=spectrum)
    rows_t = T.run_cell(*args, spectrum=spectrum, device="cpu")
    assert len(rows_t) == len(rows_j) == 6
    for rj, rt in zip(rows_j, rows_t):
        assert rt.keys() == rj.keys()
        for key in rj:
            if key.startswith("err_"):
                assert abs(rt[key] - rj[key]) <= 1e-6, (key, rj, rt)
            else:
                assert rt[key] == rj[key], (key, rj, rt)


def test_trunc_regimes_csv_eps_is_a_joined_string(tmp_path, capsys):
    """The ``trunc_best`` rows' eps column is "e1;e2", not a list's repr;
    the other numbers equal the JAX package's summary of the same rows."""
    from tgq.cli import trunc_regimes as J
    from tgq_torch.cli import trunc_regimes as T

    out = tmp_path / "s.csv"
    assert T.main(["--n", "32", "--m", "16", "--decades", "3", "--n_tokens", "24",
                   "--bits", "3", "--seeds", "3", "--group_size", "16", "--device", "cpu",
                   "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["cells"] == 1 and last["device"] == "cpu"
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    best = [r for r in rows if r["method"] == "trunc_best"]
    assert len(best) == 1 and "[" not in best[0]["eps"]
    assert all(float(e) in T.EPS_GRID for e in best[0]["eps"].split(";"))
    cells = [r for s in range(3) for r in T.run_cell(32, 16, 3.0, 24, (3,), s, 16, 0.01, False)]
    ours, theirs = T.summarize(cells), J.summarize(cells)
    for a, b in zip(ours, theirs):
        if a["method"] == "trunc_best":
            assert a["eps"] == ";".join(f"{e:g}" for e in b["eps"])
        assert {k: v for k, v in a.items() if k != "eps"} == \
            {k: v for k, v in b.items() if k != "eps"}


# ------------------------------------------------------------- tiny_train


@pytest.mark.parametrize("seed", [0, 3])
def test_markov_source_and_stream_bit_equal(seed):
    from tgq.calib import tiny_train as J
    from tgq_torch.calib import tiny_train as T

    pj, pt = J.markov_source(512, seed=seed), T.markov_source(512, seed=seed)
    assert pj.dtype == pt.dtype and np.array_equal(pj, pt)
    sj, st = J.sample_stream(pj, 3000, seed=seed + 1), T.sample_stream(pt, 3000, seed=seed + 1)
    assert st.dtype == sj.dtype == np.int32 and np.array_equal(sj, st)


def test_train_tiny_learns_in_both_packages(one_thread):
    """80 Adam steps on tiny-qwen3: the loss falls from ln(512) and the
    strided PPL ends far below the uniform bound (< vocab / 8, the JAX
    package's own criterion) in both packages; their initial weights
    differ, so the two PPLs agree only roughly."""
    import torch

    from tgq.calib import tiny_train as J
    from tgq.eval import perplexity_from_token_stream as j_ppl
    from tgq.models.config import PRESETS as J_PRESETS
    from tgq_torch.calib import tiny_train as T
    from tgq_torch.eval import perplexity_from_token_stream as t_ppl
    from tgq_torch.models import PRESETS

    cfg = PRESETS["tiny-qwen3"]
    _, _, first = T.train_tiny(cfg, steps=1, device="cpu")
    params, probs, last = T.train_tiny(cfg, steps=80, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in params["model"]["embed_tokens"].values())
    eval_ids = T.sample_stream(probs, 2048, seed=99)
    ppl_t = t_ppl(params, cfg, eval_ids, max_length=64, stride=32)
    jparams, _, jlast = J.train_tiny(J_PRESETS["tiny-qwen3"], steps=80)
    ppl_j = j_ppl(jparams, J_PRESETS["tiny-qwen3"], eval_ids, max_length=64, stride=32,
                  attn_impl="naive")
    assert first > np.log(cfg.vocab_size) - 0.5 and last < first - 2.0, (first, last)
    assert ppl_t < cfg.vocab_size / 8 and ppl_j < cfg.vocab_size / 8, (ppl_t, ppl_j)
    assert abs(last - jlast) < 0.5 and 0.67 < ppl_t / ppl_j < 1.5, (last, jlast, ppl_t, ppl_j)


def test_tiny_quality_bench_table_matches_jax_layout(tmp_path, capsys, one_thread):
    """Both CLIs at minimal settings: the same CSV columns and the same
    (bits, method, eps, a_bits) rows in the same order (the two trained
    models differ, so each trunc_best row may name another ε); every PPL
    finite."""
    from tgq.cli import tiny_quality_bench as J
    from tgq_torch.cli import tiny_quality_bench as T

    flags = ["--steps", "3", "--bits", "4,2", "--methods", "pchol,gptq,rtn",
             "--eps", "1e-6,1e-4", "--a_bits", "16,8", "--n_calib", "4"]
    tables = {}
    for name, mod, extra in (("jax", J, []), ("torch", T, ["--device", "cpu"])):
        out = tmp_path / f"{name}.csv"
        assert mod.main(flags + extra + ["--out", str(out)]) == 0
        last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with open(out, newline="") as f:
            reader = csv.DictReader(f)
            tables[name] = (reader.fieldnames, list(reader), last)
    (cols_j, rows_j, _), (cols_t, rows_t, last_t) = tables["jax"], tables["torch"]
    assert cols_t == cols_j
    # a trunc_best row's eps is its winner's, which the trained weights decide
    key = lambda r: (r["bits"], r["method"], r["a_bits"],  # noqa: E731
                     "" if r["method"] == "trunc_best" else r["eps"])
    assert [key(r) for r in rows_t] == [key(r) for r in rows_j]
    assert len(rows_t) == 2 * 2 * (2 + 1 + 1 + 1)  # bits x a_bits x (2 eps, gptq, rtn, best)
    assert all(np.isfinite(float(r["ppl"])) for r in rows_t)
    assert np.isfinite(last_t["base_ppl"]) and last_t["device"] == "cpu"


def test_tiny_quality_bench_act_report(one_thread):
    from tgq_torch.calib.tiny_train import sample_stream, train_tiny
    from tgq_torch.cli.tiny_quality_bench import activation_report
    from tgq_torch.models import PRESETS

    cfg = PRESETS["tiny-qwen3"]
    params, probs, _ = train_tiny(cfg, steps=2, device="cpu")
    rows = activation_report(params, cfg, sample_stream(probs, 4 * 64, seed=7).reshape(4, 64),
                             "cpu")
    assert [(r["layer"], r["group"]) for r in rows] == [(li, g) for li in range(2)
                                                         for g in range(4)]
    assert all(0 < r["rel_err"] < 0.05 and r["absmax_max"] >= r["absmax_mean"] for r in rows)


# ---------------------------------------------------- reproduction scripts


def _table(path, ppl: dict, failed=()):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "status", "ppl", "time_s"])
        w.writeheader()
        for name, p in ppl.items():
            w.writerow({"name": name, "status": "Failed: x" if name in failed else "OK",
                        "ppl": "" if name in failed else p, "time_s": 1.0})


@pytest.mark.parametrize("case", ["reference", "off_by_tolerance", "ordering", "failed_row",
                                  "skip_checks"])
def test_diff_baseline_matches_the_script(tmp_path, case):
    """The committed CSV format (run_benchmark's final_benchmark.csv): the
    port's verdict equals ``scripts/diff_baseline.py``'s on the same file."""
    from tgq_torch.cli import diff_baseline as D

    ppl = dict(D.REFERENCE_PPL)
    flags, failed = [], ()
    if case == "off_by_tolerance":
        ppl["GPTQ_W3_Asym"] += 0.25  # > max(0.15, 2 % of 9.59)
    elif case == "ordering":
        ppl["Trunc_W4_Sym"] = ppl["GPTQ_W4_Sym"] + 0.1
        flags = ["--abs_tol", "1.0"]
    elif case == "failed_row":
        failed = ("Trunc_W2_Asym",)
    elif case == "skip_checks":
        ppl = {k: v * 3 for k, v in ppl.items()}
        flags = ["--skip_reference_check", "--skip_ordering_check"]
    path = tmp_path / "final_benchmark.csv"
    _table(path, ppl, failed)
    want = 0 if case in ("reference", "skip_checks") else 1
    assert D.main([str(path)] + flags) == want
    script = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "diff_baseline.py"),
                             str(path)] + flags, capture_output=True, text=True, timeout=60)
    assert script.returncode == want, script.stdout


def test_reproduce_baseline_smoke(tmp_path, capsys, one_thread):
    from tgq_torch.cli import reproduce_baseline

    out = tmp_path / "smoke"
    assert reproduce_baseline.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "PASS"
    with open(out / "final_benchmark.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 11 and all(r["status"] == "OK" for r in rows)
    with pytest.raises(SystemExit):
        reproduce_baseline.main([])  # a model or --smoke


# ---------------------------------------------------------- boundary_bench


def test_boundary_bench_cpu(capsys):
    from tgq_torch.cli import boundary_bench as B

    assert B.main(["--device", "cpu", "--tokens", "2", "--reps", "1", "--shapes", "o",
                   "--splits", "1,2,4"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu" and set(res["results"]) == {"o"}
    assert set(res["results"]["o"]["per_split_ms"]) == {"1", "2", "4"}
    assert B.per_boundary({1: 1.0, 2: 1.5, 4: 2.5, 8: 4.5}) == pytest.approx(0.5)


def test_boundary_bench_slices_are_the_same_matmul():
    """The out-column slices of a packed weight, side by side, give the
    whole weight's product bit for bit (the bench changes only the number
    of launches)."""
    import torch

    from tgq_torch.cli import boundary_bench as B
    from tgq_torch.kernels.dequant_matmul import quantized_matmul

    w = B.make_packed(np.random.default_rng(0), 256, 96, 4, 128, "cpu")
    x = torch.randn((3, 256), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    whole = quantized_matmul(x, w, out_dtype=torch.bfloat16)
    parts = torch.cat([quantized_matmul(x, wi, out_dtype=torch.bfloat16)
                       for wi in B.split_out(w, 4)], dim=-1)
    assert torch.equal(whole, parts)
