#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``tgq_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases:
  0. the card's name and power limit; build the CUDA kernels from
     ``tgq_torch/kernels/csrc`` (one nvcc per source, in parallel).
  1. K1 (pivoted-Cholesky panel) against its plain version on the card at
     n = 4096 and 12288, on a well-separated spectrum and on an
     outlier-channel spectrum.
  2. K2 (GPTQ block sweep) against its plain version at m = 1024, 4096,
     12288, b = 256, W4 g128.
  3. The main path at Qwen3-8B full width (2 layers, random weights):
     layer 0's q/k/v Hessian against an f64 Gram, then
     ``quantize_model(mode="pchol")`` on 32 x 2048 synthetic calibration
     tokens, the packed checkpoint round trip and strided perplexity.
     Both kernels' launch counters must rise during this run.
  4. ``python -m tgq_torch.cli.quantize`` on tiny-qwen3.

Every mismatch raises; the script exits 0 only if every phase passed.
The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.  It fails without CUDA, and
without the ``tgq_torch`` package beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time


HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ------------------------------------------------------------ spectra (K1)


def separated_spectrum(n: int, gen, dev):
    """H = D^½ C D^½ with C = AR1(0.2) and geometrically spaced channel
    variances (ratio 0.999) assigned in random order: every conditional
    variance the sweep compares differs from its rivals by >= ~1e-4
    relative, far above f32 noise, so the pivot order is unambiguous."""
    import torch

    lam = 0.999 ** torch.arange(n, dtype=torch.float64, device=dev)
    lam = lam[torch.randperm(n, generator=gen, device=dev)]
    idx = torch.arange(n, device=dev, dtype=torch.float64)
    c = 0.2 ** (idx[:, None] - idx[None, :]).abs()
    s = lam.sqrt()
    return (s[:, None] * c * s[None, :]).float()


def outlier_spectrum(n: int, gen, dev):
    """H = D·AR1(0.9)·D with four channels 1e4x the log-spaced bulk — the
    real-LLM Hessian shape that broke reduced-precision Schur updates."""
    import torch

    d = torch.cat([torch.full((4,), 1e4, dtype=torch.float64, device=dev),
                   torch.logspace(0, -3, n - 4, dtype=torch.float64, device=dev)])
    d = d[torch.randperm(n, generator=gen, device=dev)]
    idx = torch.arange(n, device=dev, dtype=torch.float64)
    c = 0.9 ** (idx[:, None] - idx[None, :]).abs()
    s = d.sqrt()
    return (s[:, None] * c * s[None, :]).float()


def phase1_pchol(dev, report: dict, sizes=(4096, 12288)) -> None:
    import torch

    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.solver.pchol import _pchol_factors, _rank_f64, _sweep, trace_rank

    gen = torch.Generator(device=dev).manual_seed(0)
    for n in sizes:
        for name, make in (("separated", separated_spectrum), ("outlier", outlier_spectrum)):
            h = make(n, gen, dev)
            hn = torch.linalg.norm(h.double())
            res = {}
            for version, plain in (("kernel", False), ("plain", True)):
                torch.cuda.synchronize()
                t0 = time.time()
                lt, perm, dhist, pivhist = _sweep(h, panel=128, plain=plain)
                torch.cuda.synchronize()
                secs = time.time() - t0
                l64 = lt.double()
                rec = float(torch.linalg.norm(l64.T @ l64 - h.double()) / hn)
                res[version] = (lt, perm, dhist, pivhist, secs, rec, trace_rank(dhist, 1e-6))
                del l64
            lt_k, perm_k, dh_k, ph_k, s_k, rec_k, tr_k = res["kernel"]
            lt_p, perm_p, _, _, s_p, rec_p, tr_p = res["plain"]
            same_perm = bool(torch.equal(perm_k, perm_p))
            first_diff = -1 if same_perm else int((perm_k != perm_p).nonzero()[0])
            err = float((lt_k - lt_p).abs().max())
            log(f"[phase1] K1 n={n} {name}: sweep kernel {s_k*1e3:.1f} ms, plain "
                f"{s_p*1e3:.1f} ms; recon kernel {rec_k:.3e} plain {rec_p:.3e}; "
                f"trace_rank(1e-6) kernel {tr_k} plain {tr_p}; perm identical "
                f"{same_perm} (first diff {first_diff}); max|dL| {err:.3e}")
            assert rec_k <= 1e-5 and rec_p <= 1e-5, (rec_k, rec_p)
            assert tr_k == tr_p, (tr_k, tr_p)
            if name == "separated":
                assert same_perm, first_diff
            if n == sizes[-1] and name == "outlier":
                report["max_abs_err"] = err
            if name == "outlier":
                rank = _rank_f64(dh_k, ph_k, 1e-6, 1e-5)
                build_ms = cuda_ms(lambda: _pchol_factors(lt_k, perm_k, rank), reps=1)
                log(f"[phase1] factor build n={n} rank {rank}: {build_ms:.1f} ms")
            del res, lt_k, lt_p
        # one panel launch at this n, timed on its own (the first panel of
        # the outlier sweep: 128 steps over all n columns)
        a = h.contiguous()
        d = torch.diagonal(a).reshape(1, n).contiguous()
        done = torch.zeros((1, n), dtype=torch.float32, device=dev)
        before = K1.launches
        ms = cuda_ms(lambda: K1.pchol_panel(a, d, done), reps=10)
        plain_ms = cuda_ms(lambda: K1.pchol_panel_plain(a, d, done), reps=1, warmup=0)
        K1.launches = before
        panel = 128
        nbytes = 4 * (panel * n + 2 * n) + 4 * (panel * n + 2 * n + 2 * panel)
        flops = panel * (panel - 1) * n + 8 * panel * n
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"[phase1] K1 n={n}: {ms:.3f} ms/launch (plain {plain_ms:.1f} ms), "
            f"{n // panel} launches/sweep -> {ms * (n // panel):.1f} ms/sweep in "
            f"the kernel; bound {b_ms*1e3:.2f} us ({b_by})")
        if n == sizes[-1]:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        del h, a


def phase2_gptq(dev, report: dict, sizes=(1024, 4096, 12288)) -> None:
    import torch

    from tgq_torch.core.quant import QuantSpec, expand_params, find_params
    from tgq_torch.kernels import gptq_block as K2

    spec = QuantSpec(bits=4, group_size=128, sym=False)
    b = 256
    gen = torch.Generator(device=dev).manual_seed(1)
    for m in sizes:
        w = torch.randn((m, b), generator=gen, device=dev)
        s_full, z_full = expand_params(find_params(w, spec), b)
        s, z = s_full.contiguous(), z_full.contiguous()
        a = torch.randn((b, b), generator=gen, device=dev, dtype=torch.float64) / b ** 0.5
        r = torch.linalg.qr(a)[1]
        r = (r * torch.sign(torch.diagonal(r))[:, None] + 0.5 * torch.eye(b, device=dev,
                                                                           dtype=torch.float64))
        r = r.float().contiguous()
        before = K2.launches
        q_k, e_k = K2.process_block(w, s, z, r, spec.min_q, spec.max_q)
        q_p, e_p = K2.process_block_plain(w, s, z, r, spec.min_q, spec.max_q)
        mism = int((q_k != q_p).sum())
        e_err = float((e_k - e_p).abs().max())
        e_scale = float(e_p.abs().max())
        ms = cuda_ms(lambda: K2.process_block(w, s, z, r, spec.min_q, spec.max_q), reps=20)
        plain_ms = cuda_ms(lambda: K2.process_block_plain(w, s, z, r, spec.min_q, spec.max_q),
                           reps=2)
        K2.launches = before
        nbytes = 4 * (3 * m * b + b * b) + 4 * (2 * m * b)
        flops = m * b * (b - 1) + 8 * m * b
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"[phase2] K2 m={m} b={b}: code mismatches {mism}/{m*b}; max|de| "
            f"{e_err:.3e} (max|e| {e_scale:.3e}); {ms:.3f} ms/launch (plain "
            f"{plain_ms:.1f} ms); bound {b_ms*1e3:.2f} us ({b_by})")
        assert mism == 0, mism
        assert e_err <= 1e-6 * e_scale, (e_err, e_scale)
        if m == sizes[-1]:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=e_err)


def layer0_gram_check(params, cfg, calib, qcfg, dev) -> None:
    """Layer 0's q/k/v Hessian from ``HessianAccumulator`` (token-chunked
    Gram) and from one tensor-core GEMM per batch, each against an f64
    Gram of the same bf16 activations; then the pchol rank and q_proj's
    rel_error (f32 and f64 factor builds) against RTN's on each.  The
    accumulator must stay within 1e-5 of max|H| (it measured 2.1e-6)."""
    import torch

    from tgq_torch.core.quant import fake_quantize
    from tgq_torch.models.causal_lm import attn_input
    from tgq_torch.solver.factorize import FactorResult
    from tgq_torch.solver.gptq_loop import quantize_weight, rel_error
    from tgq_torch.solver.hessian import HessianAccumulator
    from tgq_torch.solver.pchol import _pchol_factors, _rank_f64, _sweep

    bs = qcfg.batch_size
    emb = params["model"]["embed_tokens"]["weight"]
    lp = params["model"]["layers"][0]
    ids = torch.from_numpy(calib.astype("int64")).to(dev)
    xs = [attn_input(lp, cfg, emb[ids[j:j + bs]].to(torch.bfloat16))
          for j in range(0, len(calib), bs)]
    tokens = ids.numel()
    acc = HessianAccumulator.init(cfg.hidden_size, device=dev)
    for x in xs:
        acc.update(x)
    one_gemm = sum(torch.mm(x.reshape(-1, cfg.hidden_size).T, x.reshape(-1, cfg.hidden_size),
                            out_dtype=torch.float32) for x in xs) / tokens
    h64 = sum(x.reshape(-1, cfg.hidden_size).double().T @ x.reshape(-1, cfg.hidden_size).double()
              for x in xs) / tokens
    del xs
    w = lp["self_attn"]["q_proj"]["w"].float()
    errs = {}
    for name, h in (("HessianAccumulator", acc.finalize()), ("one GEMM per batch", one_gemm)):
        errs[name] = float((h.double() - h64).abs().max() / h64.abs().max())
        lt, perm, dhist, pivhist = _sweep(h)
        rank = _rank_f64(dhist, pivhist, qcfg.eps, 1e-5)
        rels = []
        for dtype in (torch.float32, torch.float64):
            r_full, r_x = _pchol_factors(lt.to(dtype), perm, rank)
            f = FactorResult(r_full=r_full.float(), perm=perm, rank=rank, r_x=r_x.float())
            rels.append(float(quantize_weight(w, f, qcfg.spec).rel_error))
        rtn = float(rel_error(w, fake_quantize(w, qcfg.spec), perm.long(), r_x.float()))
        log(f"[phase3] layer-0 q/k/v Gram, {name}: max|H-H64|/max|H64| {errs[name]:.3e}; "
            f"pchol rank {rank}; q_proj rel_err f32 build {rels[0]:.4f}, f64 build "
            f"{rels[1]:.4f}, rtn {rtn:.4f}")
    assert errs["HessianAccumulator"] <= 1e-5, errs


def phase3_main_path(dev, counts: dict, preset: str = "qwen3-8b", n_samples: int = 32,
                     seq: int = 2048, eval_tokens: int = 8192, group_size: int = 128) -> None:
    import torch

    from tgq_torch.calib import QuantizeConfig, quantize_model, synthetic_calibration
    from tgq_torch.calib.data import synthetic_eval_stream
    from tgq_torch.core.checkpoint import load_quantized, save_quantized
    from tgq_torch.core.packing import PackedLinear
    from tgq_torch.eval import perplexity_from_token_stream
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import get_nested, init_params
    from tgq_torch.utils.profiling import PhaseTimers

    cfg = dataclasses.replace(PRESETS[preset], num_layers=2)
    t0 = time.time()
    params = init_params(cfg, seed=0, device=dev)
    # one bank of 256 16-token phrases: 4035 distinct tokens, so layer 0's
    # q/k/v Hessian is singular at width 4096 — the case that needs an
    # accurate Gram (tgq_torch/solver/hessian.py)
    calib = synthetic_calibration(cfg.vocab_size, n_samples, seq, seed=42)
    eval_ids = synthetic_eval_stream(cfg.vocab_size, eval_tokens, seed=43)
    torch.cuda.synchronize()
    log(f"[phase3] {cfg.name} x{cfg.num_layers} layers initialized in {time.time()-t0:.1f} s")
    t0 = time.time()
    base_ppl = perplexity_from_token_stream(params, cfg, eval_ids, max_length=seq,
                                            stride=seq // 4)
    log(f"[phase3] unquantized PPL {base_ppl:.4f} ({time.time()-t0:.1f} s)")

    qcfg = QuantizeConfig(mode="pchol", w_bits=4, group_size=group_size, eps=1e-6,
                          threshold_method="energy", batch_size=8)
    t0 = time.time()
    layer0_gram_check(params, cfg, calib, qcfg, dev)
    log(f"[phase3] Gram check {time.time()-t0:.1f} s")
    timers = PhaseTimers(sync=True)
    K1.launches = 0
    K2.launches = 0
    t0 = time.time()
    params, packed, run_log = quantize_model(params, cfg, calib, qcfg, device=dev,
                                             timers=timers)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts["pchol_panel"] = K1.launches
    counts["gptq_block"] = K2.launches
    log(f"[phase3] quantize_model: {secs:.1f} s ({secs / cfg.num_layers:.2f} s/layer); "
        f"launches pchol_panel {K1.launches}, gptq_block {K2.launches}")
    log("[phase3] phases " + json.dumps(timers.summary()))
    # per layer: 3 sweeps of n = hidden and one of n = intermediate in
    # 128-step panels; 6 modules of hidden inputs and one of intermediate
    # inputs in 256-column blocks (Qwen3-8B: 3*32 + 96 and 6*16 + 48)
    h, f = cfg.hidden_size, cfg.intermediate_size
    assert K1.launches >= cfg.num_layers * (3 * -(-h // 128) + -(-f // 128)), K1.launches
    assert K2.launches >= cfg.num_layers * (6 * -(-h // 256) + -(-f // 256)), K2.launches
    for st in run_log["layer_stats"]:
        log(f"[phase3]   {st['name']:<28} rank {st['rank']:6d}  rel_err "
            f"{st['rel_error']:.4f}  rtn {st['rtn_rel_error']:.4f}  {st['time']:.2f} s")
    for st in run_log["layer_stats"]:
        assert st["rank"] >= 1, st
        assert math.isfinite(st["rel_error"]), st
        assert st["rel_error"] <= st["rtn_rel_error"], st

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        save_quantized(tmp, params, packed, cfg, dataclasses.asdict(qcfg))
        tree, cfg2, _ = load_quantized(tmp, device=dev)
        assert cfg2 == cfg
        for key in packed:
            li, path = key.split(".", 2)[1:]
            pl = get_nested(tree["model"]["layers"][int(li)], path)
            assert isinstance(pl, PackedLinear), key
            written = get_nested(params["model"]["layers"][int(li)], path)["w"].to(dev)
            assert torch.equal(pl.dequantize().to(torch.bfloat16), written), key
        log(f"[phase3] checkpoint round trip: {len(packed)} packed linears equal the "
            f"written bf16 weights ({time.time()-t0:.1f} s)")
        del tree

    t0 = time.time()
    q_ppl = perplexity_from_token_stream(params, cfg, eval_ids, max_length=seq,
                                         stride=seq // 4)
    log(f"[phase3] quantized PPL {q_ppl:.4f} vs unquantized {base_ppl:.4f} "
        f"({(q_ppl / base_ppl - 1) * 100:+.3f} %, {time.time()-t0:.1f} s)")
    assert math.isfinite(q_ppl) and abs(q_ppl / base_ppl - 1) <= 0.05, (q_ppl, base_ppl)


def phase4_cli(dev) -> None:
    from tgq_torch.cli.quantize import main

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        t0 = time.time()
        rc = main(["--model_id", "tiny-qwen3", "--device", "cuda", "--dataset", "synthetic",
                   "--mode", "pchol", "--n_samples", "8", "--seq_len", "128",
                   "--batch_size", "4", "--block_size", "32", "--eps", "1e-6",
                   "--save_path", out])
        assert rc == 0, rc
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)
        assert set(res) >= {"config", "layer_stats", "metrics"}, list(res)
        assert len(res["layer_stats"]) == 14
        assert math.isfinite(res["metrics"]["quantized_ppl"])
        log(f"[phase4] CLI tiny-qwen3: PPL {res['metrics']['quantized_ppl']:.4f} "
            f"({time.time()-t0:.1f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated phases to run (all by default)")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import tgq_torch  # noqa: F401  (fails outside a checkout of the repo)
    from tgq_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[phase0] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build()
    _build.lib()
    log(f"[phase0] kernels built and loaded in {time.time()-t0:.1f} s")
    log(_build.ptxas_report())

    k1 = {"name": "pchol_panel", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/pchol_panel.cu",
          "replaces": "tgq/kernels/pchol_panel.py:109", "library_ms": None}
    k2 = {"name": "gptq_block", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/gptq_block.cu",
          "replaces": "tgq/kernels/gptq_block.py:84", "library_ms": None}
    counts: dict[str, int] = {}
    if 1 in phases:
        phase1_pchol(dev, k1)
    if 2 in phases:
        phase2_gptq(dev, k2)
    if 3 in phases:
        phase3_main_path(dev, counts)
    if 4 in phases:
        phase4_cli(dev)
    k1["launches"] = counts.get("pchol_panel", 0)
    k2["launches"] = counts.get("gptq_block", 0)

    log(f"[card] {card_line()}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
