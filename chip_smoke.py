#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``tgq_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 0,5,6,7   # the serving slice only
    python3 chip_smoke.py --phases 0,8       # GPT-2 / OPT, HF checkpoints, resume

Phases:
  0. the card's name and power limit; build the CUDA kernels from
     ``tgq_torch/kernels/csrc`` (one nvcc per source, in parallel).
  1. K1 (pivoted-Cholesky panel) against its plain version on the card at
     n = 4096 and 12288, on a well-separated spectrum and on an
     outlier-channel spectrum: the whole sweep's perm, Lt, dhist and
     pivhist bit for bit; then single panels (strip, d, done, perm,
     pivhist bit for bit, two launches alike) at those widths, a ragged
     last panel (37 steps), one with most strip rows in global memory,
     n = 28672 and a ragged n = 4100.
  2. K2 (GPTQ block sweep) against its plain version at m = 1024, 4096,
     12288, 28672 and a ragged 1000 with b = 256, and b = 128, 512 and
     200 (not a multiple of 32): codes and errors bit for bit, two
     launches alike.
  3. The main path at Qwen3-8B full width (2 layers, random weights):
     layer 0's q/k/v Hessian against an f64 Gram, then
     ``quantize_model(mode="pchol")`` on 32 x 2048 synthetic calibration
     tokens, the packed checkpoint round trip and strided perplexity.
     Both kernels' launch counters must rise during this run.
  4. ``python -m tgq_torch.cli.quantize`` on tiny-qwen3.
  5. K3 (packed-weight matmul on the tensor cores, bits 2/3/4/8, GLU,
     bf16 and f32 activations) on groups of 32, 64 and one a row, then K3
     and K4 (W4A8 on the int8 tensor cores; bits 2/3/4) against their
     plain versions at the Qwen3-8B serving shapes, t = 8, 64, 1024,
     beside the library int4 GEMM, a dense bf16 matmul and
     dequantize-once; K4 timed alone, with quantize_activations apart.
  6. K5 (split-context paged decode attention) against its plain
     version: bf16, int8 and int4 pools, soft cap, the current-row write
     with a dead slot, lengths across split boundaries, GQA groups 1, 4
     and 8, head_dim 64, 128 and 256; two launches bit-identical; SDPA on
     the same K/V gathered dense beside every bf16 case.
  7. The serving main path at Qwen3-8B full width: 4-layer paged decode
     held against full-recompute ``forward``, then
     ``tgq_torch.cli.serve.run`` at 36 layers with kv_bits 16, 8 and
     4 + A8 + an 8-bit head.  K3, K4 and K5's counters must rise.  Last,
     one 8-step decode chunk at 36 layers traced by ``torch.profiler``:
     wall, host dispatch and device-busy time per step, by kernel class.
  8. Families and checkpoints: GPT-2 (12 layers) and OPT-1.3b (24 layers,
     two shards with an index) written in their HF layouts with random
     weights by the port's safetensors writer, then quantized through
     ``python -m tgq_torch.cli.quantize`` with ``--hf_export
     --resume_dir --profile_dir``: rel_error against RTN, PPL against the
     unquantized model, K1/K2 launches against the counts the shapes
     give, the export's logits against the in-memory model's bit for
     bit, the trace's kernel names; K1 and K2 at the families' widths
     against their plain versions; an untraced rerun for s/layer; GPT-2
     stopped after layer 5 and resumed, codes bit for bit.

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
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
INT8_OP_PER_S = 1979e12     # H100 SXM int8 tensor cores, dense


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls.  A spin
    kernel keeps the card busy while the host queues the timed calls, so
    the events bracket the device's work and not the host's dispatch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9 * (2 * reps * host_s + 1e-3), 1e9)))  # ~2 GHz cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / rate * 1e3
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


def bits_equal(x, y) -> bool:
    """Same shape and the same bits (f32 compared as int32)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return bool(torch.equal(x, y))


def k1_panel_case(K1, a, d, done, steps: int, label: str) -> None:
    """One panel launched twice and run by the plain version: strip, d,
    done, perm and pivhist bit for bit, and the two launches alike."""
    before = K1.launches
    got = K1.pchol_panel(a, d, done, panel=128, steps=steps)
    again = K1.pchol_panel(a, d, done, panel=128, steps=steps)
    K1.launches = before
    want = K1.pchol_panel_plain(a, d, done, panel=128, steps=steps)
    names = ("strip", "d", "done", "perm", "pivhist")
    bad = [nm for nm, g, w in zip(names, got, want) if not bits_equal(g, w)]
    rep = all(bits_equal(g, h) for g, h in zip(got, again))
    log(f"[phase1] K1 panel {label} steps={steps}: kernel = plain bit for bit "
        f"{not bad} (differs: {bad}); two launches identical {rep}")
    assert not bad and rep, (label, bad, rep)


def phase1_pchol(dev, report: dict, sizes=(4096, 12288), extra=(28672, 4100)) -> None:
    import torch

    from tgq_torch.kernels import _build
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
            sweep_bits = [bits_equal(x, y) for x, y in zip(res["kernel"][:4], res["plain"][:4])]
            log(f"[phase1] K1 n={n} {name}: sweep kernel {s_k*1e3:.1f} ms, plain "
                f"{s_p*1e3:.1f} ms; recon kernel {rec_k:.3e} plain {rec_p:.3e}; "
                f"trace_rank(1e-6) kernel {tr_k} plain {tr_p}; perm identical "
                f"{same_perm} (first diff {first_diff}); max|dL| {err:.3e}; "
                f"perm, Lt, dhist, pivhist bit for bit {sweep_bits}")
            assert rec_k <= 1e-5 and rec_p <= 1e-5, (rec_k, rec_p)
            assert tr_k == tr_p, (tr_k, tr_p)
            assert all(sweep_bits), sweep_bits
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
        k1_panel_case(K1, a, d, done, 128, f"n={n} outlier")
        before = K1.launches
        ms = cuda_ms(lambda: K1.pchol_panel(a, d, done), reps=10)
        plain_ms = cuda_ms(lambda: K1.pchol_panel_plain(a, d, done), reps=1, warmup=0)
        K1.launches = before
        panel = 128
        nbytes = 4 * (panel * n + 2 * n) + 4 * (panel * n + 2 * n + 2 * panel)
        flops = panel * (panel - 1) * n + 8 * panel * n
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"[phase1] K1 n={n}: {ms:.3f} ms/launch ({ms / panel * 1e3:.2f} us a step; "
            f"plain {plain_ms:.1f} ms), {n // panel} launches/sweep -> "
            f"{ms * (n // panel):.1f} ms/sweep in the kernel; bound {b_ms*1e3:.2f} us ({b_by})")
        if n == sizes[-1]:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            # a ragged last panel: 37 steps, the rest of the strip zero
            done = done.clone()
            done[0, ::3] = 1.0
            k1_panel_case(K1, a, torch.where(done > 0, 0.0, d), done, 37, f"n={n} ragged")
            # strip rows that do not fit shared memory stay in global memory
            # (n > ~59000 on this card): the plan for a limit that holds 40
            sms, limit = _build.device_limits(_build.lib(), dev.index)
            plan = K1._k1_plan(n, 128, sms, limit)
            _build._limits[dev.index] = (sms, K1._K1_STATIC_SMEM + 4 * (2 * plan.tile + 128)
                                         + 4 * 40 * plan.tile)
            try:
                rows = K1._k1_plan(n, 128, *_build._limits[dev.index]).rows_smem
                k1_panel_case(K1, a, d, torch.zeros_like(done), 128,
                              f"n={n}, {rows} strip rows in shared memory")
            finally:
                _build._limits[dev.index] = (sms, limit)
            assert rows == 40, rows
        del h, a
    # llama3-70b's intermediate width and a ragged width, one panel each
    for n in extra:
        a = separated_spectrum(n, gen, dev)
        d = torch.diagonal(a).reshape(1, n).contiguous()
        done = torch.zeros((1, n), dtype=torch.float32, device=dev)
        k1_panel_case(K1, a, d, done, 128, f"n={n} separated")
        if n == extra[0]:
            before = K1.launches
            ms = cuda_ms(lambda: K1.pchol_panel(a, d, done), reps=5)
            K1.launches = before
            log(f"[phase1] K1 n={n}: {ms:.3f} ms/launch ({ms / 128 * 1e3:.2f} us a step)")
        del a


def phase2_gptq(dev, report: dict, cases=((1024, 256), (4096, 256), (12288, 256),
                                          (28672, 256), (4096, 128), (4096, 512),
                                          (1000, 256), (1024, 200))) -> None:
    import torch

    from tgq_torch.core.quant import QuantSpec, expand_params, find_params
    from tgq_torch.kernels import gptq_block as K2

    spec = QuantSpec(bits=4, group_size=128, sym=False)
    gen = torch.Generator(device=dev).manual_seed(1)
    for m, b in cases:
        w = torch.randn((m, b), generator=gen, device=dev)
        s_full, z_full = expand_params(find_params(w, QuantSpec(
            bits=4, group_size=128 if b % 128 == 0 else -1, sym=False)), b)
        s, z = s_full.contiguous(), z_full.contiguous()
        a = torch.randn((b, b), generator=gen, device=dev, dtype=torch.float64) / b ** 0.5
        r = torch.linalg.qr(a)[1]
        r = (r * torch.sign(torch.diagonal(r))[:, None] + 0.5 * torch.eye(b, device=dev,
                                                                           dtype=torch.float64))
        r = r.float().contiguous()
        before = K2.launches
        q_k, e_k = K2.process_block(w, s, z, r, spec.min_q, spec.max_q)
        q_k2, e_k2 = K2.process_block(w, s, z, r, spec.min_q, spec.max_q)
        q_p, e_p = K2.process_block_plain(w, s, z, r, spec.min_q, spec.max_q)
        mism = int((q_k != q_p).sum())
        q_bits, e_bits = bits_equal(q_k, q_p), bits_equal(e_k, e_p)
        rep = bits_equal(q_k, q_k2) and bits_equal(e_k, e_k2)
        e_err = float((e_k - e_p).abs().max())
        e_scale = float(e_p.abs().max())
        ms = cuda_ms(lambda: K2.process_block(w, s, z, r, spec.min_q, spec.max_q), reps=20)
        plain_ms = cuda_ms(lambda: K2.process_block_plain(w, s, z, r, spec.min_q, spec.max_q),
                           reps=2)
        K2.launches = before
        nbytes = 4 * (3 * m * b + b * b) + 4 * (2 * m * b)
        flops = m * b * (b - 1) + 8 * m * b
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"[phase2] K2 m={m} b={b}: code mismatches {mism}/{m*b}; codes and e bit for "
            f"bit {q_bits and e_bits} (max|de| {e_err:.3e}, max|e| {e_scale:.3e}); two "
            f"launches identical {rep}; {ms:.4f} ms/launch ({ms / b * 1e3:.3f} us a step; "
            f"plain {plain_ms:.1f} ms); bound {b_ms*1e3:.2f} us ({b_by})")
        assert mism == 0 and q_bits and e_bits, (mism, e_err, e_scale)
        assert rep
        if (m, b) == (12288, 256):
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


# ------------------------------------------------------ serving (K3-K5)


def bf16_ulp(v):
    """One bf16 ulp at each element of the f32 tensor ``v``."""
    import torch

    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def random_packed(n_out: int, n_in: int, bits: int, gen, dev, group: int = 128, pad: int = 0):
    """A random RTN-packed linear (N(0, 1/in) weights), rows padded."""
    import torch

    from tgq_torch.core.packing import pad_out
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models.hf_import import rtn_pack

    w = torch.randn((n_out, n_in), generator=gen, device=dev) / n_in ** 0.5
    p = rtn_pack(w, QuantSpec(bits=bits, group_size=group, sym=False))
    return pad_out(p, pad) if pad else p


def int4pack_library(w):
    """PyTorch's grouped int4 GEMM on ``w``'s codes (W4, CUDA only): the
    weight is repacked once with ``_convert_weight_to_int4pack``; the call
    dequantizes ``(q - 8)·s + zero`` with bf16 scale and zero, so our
    ``(q - z)·s`` goes in as zero = (8 - z)·s.  Returns ``fn(x)`` for bf16
    x (t, in) -> (t, out) bf16.  Used only to time the library beside K3."""
    import torch

    from tgq_torch.core.packing import unpack_rows

    g = w.group_size
    q = unpack_rows(w.codes.T, 4, group_size=g, in_features=w.in_features)  # (N, K)
    packed = torch.ops.aten._convert_weight_to_int4pack(
        (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8).contiguous(), 8)
    sz = torch.stack([w.scale, (8.0 - w.zero) * w.scale], dim=-1).to(torch.bfloat16)
    sz = sz.contiguous()
    return lambda x: torch.ops.aten._weight_int4pack_mm(x, packed, g, sz)


# Qwen3-8B packed matmuls (out x in): fused qkv, o, fused gate_up, down, head
QWEN3_8B_MATMULS = (("qkv", 6144, 4096), ("o", 4096, 4096), ("gate_up", 24576, 4096),
                    ("down", 4096, 12288), ("lm_head", 151936, 4096))


def k3_group_check(dev, n_out: int = 520, n_in: int = 1024, tokens=(8, 64)) -> None:
    """K3 and K4 beyond the 128-input chunks of the serving shapes: groups
    of 32 and 64 (chunks of a whole small group, uc read at run time), one
    group per row (g = in_features), and 520 output columns (a ragged last
    tile, codes copied bytewise since rows are not 16-byte multiples); K3 at
    bits 2/3/4/8, bf16 and f32 x, GLU at W4, K4 at bits 2/3/4.  The same
    limits as phase 5."""
    import torch

    from tgq_torch.kernels import dequant_matmul as KD

    gen = torch.Generator(device=dev).manual_seed(55)
    before, before_a8 = KD.launches, KD.launches_a8
    for g in (32, 64, -1):
        for bits in (2, 3, 4, 8):
            w = random_packed(n_out, n_in, bits, gen, dev, group=g)
            worst = 0.0
            for t in tokens:
                for x_dt, glu in ((torch.bfloat16, False), (torch.float32, False),
                                  (torch.bfloat16, bits == 4)):
                    x = torch.randn((t, 2 * n_in if glu else n_in), generator=gen,
                                    device=dev).to(x_dt)
                    y32 = KD.quantized_matmul(x, w, out_dtype=torch.float32, glu=glu)
                    y16 = KD.quantized_matmul(x, w, out_dtype=torch.bfloat16, glu=glu)
                    ref = KD.dequant_matmul_plain(x, w, glu=glu)
                    rel = float((y32 - ref).abs().max() / ref.abs().max())
                    worst = max(worst, rel)
                    case = (g, bits, t, x_dt, glu, rel)
                    assert rel <= 1e-4, case
                    assert torch.equal(y16, y32.to(torch.bfloat16)), case
                    assert torch.equal(y32, KD.quantized_matmul(x, w, out_dtype=torch.float32,
                                                                glu=glu)), case
                    if glu:
                        split = KD.quantized_matmul(KD.glu_act(x[:, :n_in], x[:, n_in:]), w,
                                                    out_dtype=torch.bfloat16)
                        assert torch.equal(y16, split), case
            plan = KD._k3_plan(tokens[0], n_in, n_out, w.group_size, bits)
            log(f"[phase5] K3 {n_out}x{n_in} W{bits} g{w.group_size}: chunk {plan.chunk_k} "
                f"({'fixed' if plan.chunk_k == 128 else 'run-time'} build), t = {tokens}, bf16 / "
                f"f32 x{', GLU' if bits == 4 else ''}: max|dy| / max|y| {worst:.2e}, bf16 = "
                f"rounded f32, repeat bit-identical")
            if bits == 8:
                continue
            # K4 on the same weights: bit for bit, f32 and bf16
            w8 = dataclasses.replace(w, act_bits=8)
            for t in tokens:
                x8, a = KD.quantize_activations(
                    torch.randn((t, n_in), generator=gen, device=dev).to(torch.bfloat16))
                ref = KD.a8_matmul_plain(x8, a, w8)
                assert torch.equal(KD.a8_matmul(x8, a, w8), ref), (g, bits, t)
                assert torch.equal(KD.a8_matmul(x8, a, w8, out_dtype=torch.bfloat16),
                                   ref.to(torch.bfloat16)), (g, bits, t)
            plan = KD._k4_plan(tokens[0], n_in, n_out, w.group_size, bits)
            log(f"[phase5] K4 {n_out}x{n_in} W{bits}A8 g{w.group_size}: chunk {plan.chunk_k} "
                f"({'fixed' if plan.chunk_k == 128 else 'run-time'} build), t = {tokens}: f32 and "
                f"bf16 output bit-exact")
    torch.cuda.synchronize() if dev.type == "cuda" else None
    KD.launches, KD.launches_a8 = before, before_a8


def phase5_matmul(dev, k3: dict, k4: dict, shapes=QWEN3_8B_MATMULS, tokens=(8, 64, 1024),
                  time_it=None) -> None:
    """K3 (bits 2/3/4/8, bf16 and f32 output, bf16 activations and, at o
    and down, f32 ones; GLU at the down shape) and K4 (bits 2/3/4, f32 and
    bf16 output) against their plain versions, each K3 case with the
    planner's regime, tile, chunk and split-K; ms per launch beside the
    byte and bf16 tensor-core bounds, a dense bf16 torch.matmul of the same
    shape, dequantize-once (``w.dequantize(bf16)`` + ``torch.matmul``, at
    the largest t; timed only) and, at W4 on CUDA, PyTorch's int4 GEMM
    (``_weight_int4pack_mm``) on the same codes.  K3 f32 output within
    1e-4 * max|y|, bf16 output within one bf16 ulp and equal to the f32
    output rounded once, two launches bit-identical, GLU equal to the split
    form ``glu_act`` + matmul bit for bit; K4 bit for bit.  The library's
    int4 GEMM rounds scale and zero to bf16 and dequantizes in bf16, so it
    is held within 2e-2 * max|y|."""
    import torch

    from tgq_torch.kernels import dequant_matmul as KD

    time_it = time_it or cuda_ms
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, n_out, n_in in shapes:
        head = name == "lm_head"
        for bits in ((8,) if head else (4, 3, 2, 8)):
            w = random_packed(n_out, n_in, bits, gen, dev, pad=512 if head else 0)
            n = w.out_features
            w_dense = w.dequantize(torch.float32).to(torch.bfloat16)
            w8 = dataclasses.replace(w, act_bits=8)
            lib = int4pack_library(w) if bits == 4 and not head and dev.type == "cuda" else None
            for t in tokens:
                x = torch.randn((t, n_in), generator=gen, device=dev).to(torch.bfloat16)
                glu_cases = (False, True) if name == "down" and bits == 4 else (False,)
                # f32 activations (split into two bf16 halves by the kernel) at
                # o and down; timed only in bf16, as the serving path runs it
                x_dtypes = (torch.bfloat16, torch.float32) if name in ("o", "down") else (
                    torch.bfloat16,)
                for glu, x_dt in ((gl, dt) for gl in glu_cases for dt in x_dtypes):
                    timed = x_dt == torch.bfloat16
                    xin = (torch.randn((t, 2 * n_in), generator=gen, device=dev).to(x_dt)
                           if glu else x.to(x_dt) if timed else
                           torch.randn((t, n_in), generator=gen, device=dev))
                    before = KD.launches
                    y32 = KD.quantized_matmul(xin, w, out_dtype=torch.float32, glu=glu)
                    y16 = KD.quantized_matmul(xin, w, out_dtype=torch.bfloat16, glu=glu)
                    # two launches on the same input give the same bits
                    repeat = bool(torch.equal(
                        y32, KD.quantized_matmul(xin, w, out_dtype=torch.float32, glu=glu)))
                    ref = KD.dequant_matmul_plain(xin, w, glu=glu)
                    err = float((y32 - ref).abs().max())
                    scale = float(ref.abs().max())
                    # bf16 output: the f32 result rounded once, and within one bf16
                    # ulp of the plain result (or of the f32 tolerance, where an
                    # output near 0 has an ulp below the summation-order error)
                    same_rounding = bool(torch.equal(y16, y32.to(torch.bfloat16)))
                    d16 = (y16.float() - ref.to(torch.bfloat16).float()).abs()
                    ulps = float((d16 / torch.maximum(
                        torch.maximum(bf16_ulp(ref), bf16_ulp(y16)),
                        torch.full_like(ref, 1e-4 * float(ref.abs().max())))).max())
                    glu_split = None
                    if glu:
                        y_split = KD.quantized_matmul(
                            KD.glu_act(xin[:, :n_in], xin[:, n_in:]), w,
                            out_dtype=torch.bfloat16)
                        glu_split = bool(torch.equal(y16, y_split))
                    plan = KD._k3_plan(t, n_in, n, w.group_size, bits, x_f32=not timed,
                                       glu=glu)
                    case = (f"[phase5] K3 {name} {n}x{n_in} W{bits} t={t}"
                            f"{' glu' if glu else ''}{'' if timed else ' f32 x'}: plan "
                            f"{plan.regime} {plan.tile_t}x{plan.tile_n} tile, chunk "
                            f"{plan.chunk_k}, split-K {plan.split}; max|dy| f32 {err:.3e} "
                            f"(max|y| {scale:.3e}), bf16 {ulps:.2f} ulp, bf16 = rounded f32 "
                            f"{same_rounding}, repeat bit-identical {repeat}"
                            f"{'' if glu_split is None else f', = split form {glu_split}'}")
                    assert err <= 1e-4 * scale, (case, err, scale)
                    assert ulps <= 1.0 and same_rounding and repeat, case
                    assert glu_split in (None, True), case
                    if not timed:
                        KD.launches = before
                        log(case)
                        continue
                    ms = time_it(lambda: KD.quantized_matmul(xin, w, glu=glu), reps=20)
                    if not glu:
                        k3_ms = ms  # beside K4 at the same shape
                    plain_ms = time_it(lambda: KD.dequant_matmul_plain(xin, w, glu=glu), reps=3)
                    dense_ms = time_it(lambda: torch.matmul(x, w_dense.T), reps=20)
                    KD.launches = before
                    lib_ms = lib_note = None
                    if lib is not None and not glu:
                        lib_err = float((lib(x).float() - ref).abs().max())
                        lib_ms = time_it(lambda: lib(x), reps=20)
                        lib_note = (f"; library int4 GEMM {lib_ms*1e3:.1f} us, max|dy| "
                                    f"{lib_err:.3e}")
                        assert lib_err <= 2e-2 * scale, (name, t, lib_err, scale)
                    once_note = ""
                    if t == tokens[-1] and not glu and not head:
                        # dequantize-once (weights rounded to bf16, so not K3's
                        # function): timed only, for the prefill-routing question
                        once_ms = time_it(
                            lambda: torch.matmul(x, w.dequantize(torch.bfloat16).T), reps=5)
                        once_note = f"; dequantize-once + bf16 matmul {once_ms*1e3:.1f} us"
                    nbytes = (w.codes.numel() + 8 * w.scale.numel() + xin.numel() * 2
                              + t * n * 2)
                    flops = 2.0 * t * n * n_in
                    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
                    log(f"{case}; {ms*1e3:.1f} us/launch, bound {b_ms*1e3:.1f} us "
                        f"({b_by}: bytes {nbytes / HBM_BYTES_PER_S * 1e6:.1f} us, bf16 "
                        f"tensor-core ops {flops / BF16_FLOP_PER_S * 1e6:.1f} us), plain "
                        f"{plain_ms*1e3:.1f} us, dense bf16 matmul "
                        f"{dense_ms*1e3:.1f} us{lib_note or ''}{once_note}")
                    if name == "gate_up" and bits == 4 and t == tokens[0]:
                        k3.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                  max_abs_err=err, library_ms=lib_ms, dense_bf16_ms=dense_ms)
                if head or bits == 8:
                    continue
                before = KD.launches_a8
                x8, a = KD.quantize_activations(x)
                y = KD.quantized_matmul(x, w8, out_dtype=torch.float32)
                ref = KD.a8_matmul_plain(x8, a, w8)
                exact = bool(torch.equal(y, ref))
                # bf16 output, as the serving path runs it: the f32 result rounded once
                exact16 = bool(torch.equal(KD.quantized_matmul(x, w8), ref.to(torch.bfloat16)))
                repeat = bool(torch.equal(y, KD.a8_matmul(x8, a, w8)))
                err = float((y - ref).abs().max())
                # the kernel alone, and the activation quantization (PyTorch ops) apart
                ms = time_it(lambda: KD.a8_matmul(x8, a, w8, out_dtype=torch.bfloat16), reps=20)
                qa_ms = time_it(lambda: KD.quantize_activations(x), reps=20)
                plain_ms = time_it(lambda: KD.a8_matmul_plain(x8, a, w8), reps=3)
                KD.launches_a8 = before
                plan = KD._k4_plan(t, n_in, n, w.group_size, bits)
                nbytes = (w.codes.numel() + 8 * w.scale.numel() + t * n_in + 4 * t + t * n * 2)
                b_ms, b_by = bound_ms(nbytes, 2.0 * t * n * n_in, INT8_OP_PER_S)
                log(f"[phase5] K4 {name} {n}x{n_in} W{bits}A8 t={t}: plan {plan.regime} "
                    f"{plan.tile_t}x{plan.tile_n} tile, chunk {plan.chunk_k}, {plan.k_warps} k "
                    f"warps; bit-exact {exact}, bf16 output {exact16}, repeat bit-identical "
                    f"{repeat} (max|dy| {err:.3e}); kernel {ms*1e3:.1f} us/launch, "
                    f"quantize_activations {qa_ms*1e3:.1f} us, int8 bound {b_ms*1e3:.1f} us "
                    f"({b_by}: bytes {nbytes / HBM_BYTES_PER_S * 1e6:.1f} us, int8 ops "
                    f"{2.0 * t * n * n_in / INT8_OP_PER_S * 1e6:.1f} us), K3 W{bits} same shape "
                    f"{k3_ms*1e3:.1f} us, plain {plain_ms*1e3:.1f} us")
                assert exact and exact16 and repeat, (name, bits, t, err, exact16, repeat)
                if name == "gate_up" and bits == 4 and t == tokens[0]:
                    k4.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              max_abs_err=err, library_ms=None)
            del w, w_dense, w8, lib


def attention_case(dev, gen, slots: int, kv_bits: int, lengths, n_layers=4, page=64,
                   H=32, kvh=8, d=128, mpps=32):
    """Random layer-stacked pools and a shuffled page table for K5."""
    import torch

    from tgq_torch.serve.kv_cache import scale_pad

    n_pages = slots * mpps + 1
    fused = kvh * d
    stored = fused // 2 if kv_bits == 4 else fused
    shape = (n_layers, n_pages, page, stored)
    if kv_bits == 16:
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
    else:
        hi = 256 if kv_bits == 4 else 255
        dt = torch.uint8 if kv_bits == 4 else torch.int8
        off = 0 if kv_bits == 4 else 127
        k = (torch.randint(0, hi, shape, generator=gen, device=dev) - off).to(dt)
        v = (torch.randint(0, hi, shape, generator=gen, device=dev) - off).to(dt)
        sshape = (n_layers, n_pages, kvh, scale_pad(page))
        ks = torch.rand(sshape, generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(sshape, generator=gen, device=dev) * 0.02 + 1e-3
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[: slots * mpps] + 1
    table = perm.reshape(slots, mpps).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((slots, H, d), generator=gen, device=dev) * 0.3 / d ** 0.5
    kc = torch.randn((slots, fused), generator=gen, device=dev)
    vc = torch.randn((slots, fused), generator=gen, device=dev)
    return q, k, v, ks, vs, lens, table, kc, vc


def attention_bytes(kv_bits, lens, slots, H, kvh, d):
    """Bytes K5 must move: q, out, current rows, live KV (+ scales)."""
    fused = kvh * d
    tokens = sum(max(int(n) - 1, 0) for n in lens)
    per_tok = {16: 2 * fused, 8: fused, 4: fused // 2}[kv_bits] + (0 if kv_bits == 16 else 4 * kvh)
    return 2 * tokens * per_tok + 4 * slots * (2 * H * d + 2 * fused) + 8 * slots


def sdpa_gathered_ms(q, k_pool, v_pool, lens, table, kvh: int, time_it) -> float:
    """ms of one ``scaled_dot_product_attention`` call over the pool's K/V
    gathered dense (bf16, every slot padded to the table's length, keys
    masked past each slot's length): the library yardstick beside K5."""
    import torch

    from tgq_torch.serve.kv_cache import gather_pools

    slots, H, d = q.shape
    kg, vg = gather_pools(k_pool, v_pool, None, None, table, kvh, torch.bfloat16)
    kb, vb = (t.transpose(1, 2).contiguous() for t in (kg, vg))
    qb = q.to(torch.bfloat16).reshape(slots, 1, H, d).transpose(1, 2).contiguous()
    pos = torch.arange(kb.shape[2], device=q.device)
    mask = (pos[None, :] < lens.clamp(min=1)[:, None].to(pos.dtype))[:, None, None, :]
    return time_it(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=1.0, enable_gqa=True), reps=20)


def phase6_attention(dev, k5: dict, slot_counts=(8, 64), max_len=2048, time_it=None,
                     geometry=dict(H=32, kvh=8, d=128),
                     more_geometries=((8, 8, 128), (64, 8, 128), (32, 8, 64), (16, 4, 256)),
                     more_len=512) -> None:
    """K5 against its plain version: bf16 / int8 / int4 pools, layer 2 of
    a 4-layer pool, page 64, lengths 0, 1, 2, 64, 65 ... max_len and
    lengths on the split boundaries of the planner's S, in a shuffled page
    table; a soft-capped case; ``write_current`` with one dead slot, pools
    then compared byte for byte; then GQA groups 1 and 8 and head_dim 64
    and 256 (``more_geometries``: H, kvh, d) at 8 slots up to ``more_len``
    tokens.  Output within rtol = atol = 1e-5 (both sides compute in f32
    from the same stored values; only the order of the sums differs), two
    launches bit-identical; SDPA on the gathered K/V beside every bf16
    case."""
    import torch

    from tgq_torch.kernels import paged_attention as K5

    time_it = time_it or cuda_ms
    gen = torch.Generator(device=dev).manual_seed(6)
    host_gen = torch.Generator().manual_seed(6)
    li = 2

    def views(pools, layer):
        return [None if p is None else p[layer] for p in pools]

    def check(slots, lengths, kv_bits, soft_cap, write, H, kvh, d, mpps, label):
        q, k, v, ks, vs, lens, table, kc, vc = attention_case(
            dev, gen, slots, kv_bits, lengths, H=H, kvh=kvh, d=d, mpps=mpps)
        live = torch.ones((slots,), dtype=torch.int32, device=dev)
        live[2] = 0
        pools_k = [t.clone() if t is not None else None for t in (k, v, ks, vs)]
        pools_p = [t.clone() if t is not None else None for t in (k, v, ks, vs)]
        kw = dict(num_kv_heads=kvh, attn_logits_soft_cap=soft_cap, write_current=write)
        vk, vv, vks, vvs = views(pools_k, li)
        before = K5.launches
        out = K5.paged_decode_attention(q, vk, vv, vks, vvs, lens, table, kc, vc,
                                        live=live, **kw)
        # a second launch (the write repeats the same bytes) gives the same bits
        repeat = bool(torch.equal(out, K5.paged_decode_attention(
            q, vk, vv, vks, vvs, lens, table, kc, vc, live=live, **kw)))
        pk, pv, pks, pvs = views(pools_p, li)
        ref = K5.paged_decode_attention_plain(q, pk, pv, pks, pvs, lens, table, kc,
                                              vc, live=live, **kw)
        torch.cuda.synchronize() if dev.type == "cuda" else None
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-5))
        same_pools = all(
            a is None or torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(pools_k, pools_p))
        ms = time_it(lambda: K5.paged_decode_attention(
            q, vk, vv, vks, vvs, lens, table, kc, vc, live=live, **kw), reps=20)
        plain_ms = time_it(lambda: K5.paged_decode_attention_plain(
            q, pk, pv, pks, pvs, lens, table, kc, vc, live=live, **kw), reps=2)
        K5.launches = before
        nbytes = attention_bytes(kv_bits, lengths, slots, H, kvh, d)
        flops = 4.0 * H * d * sum(lengths)
        b_ms, b_by = bound_ms(nbytes, flops)
        sdpa_note = ""
        if kv_bits == 16 and dev.type == "cuda":
            # the yardstick: SDPA over the same K/V gathered dense, padded to
            # the longest context with a length mask
            sdpa_ms = sdpa_gathered_ms(q, pk, pv, lens, table, kvh, time_it)
            sdpa_note = (f", SDPA on the gathered bf16 K/V {sdpa_ms*1e3:.1f} us "
                         f"(K5 / SDPA {ms / sdpa_ms:.2f})")
        plan = K5._k5_plan(slots, kvh, mpps, 64)
        log(f"[phase6] K5 {label} slots={slots} H={H} kvh={kvh} d={d} kv{kv_bits} "
            f"cap={soft_cap} write={write}: S {plan.splits}; max|do| {err:.3e}, allclose(1e-5) "
            f"{ok}, pools identical {same_pools}, repeat bit-identical {repeat}; "
            f"{ms*1e3:.1f} us/launch, bound {b_ms*1e3:.2f} us ({b_by}), plain "
            f"{plain_ms*1e3:.1f} us{sdpa_note}")
        assert ok, (label, slots, H, kvh, d, kv_bits, soft_cap, write, err)
        assert same_pools and repeat, (label, slots, kv_bits, write, same_pools, repeat)
        del pools_k, pools_p, k, v, ks, vs

    H, kvh, d = geometry["H"], geometry["kvh"], geometry["d"]
    mpps = -(-max_len // 64)
    for slots in slot_counts:
        splits = K5._k5_plan(slots, kvh, mpps, 64).splits
        # split boundaries: pool lengths of one tile, S tiles and just past them
        fixed = [0, 1, 2, 33, 32 * splits + 1, max_len, 65, 130, 64, 32 * splits + 2,
                 max_len - 1, 34]
        rnd = torch.randint(0, max_len + 1, (max(slots - len(fixed), 0),),
                            generator=host_gen).tolist()
        lengths = [min(n, max_len) for n in (fixed + rnd)[:slots]]
        for kv_bits in (16, 8, 4):
            for soft_cap, write in ((None, False), (30.0, False), (None, True)):
                if soft_cap is not None and kv_bits != 16:
                    continue
                check(slots, lengths, kv_bits, soft_cap, write, H, kvh, d, mpps, "group 4")
    more_mpps = -(-more_len // 64)
    for gH, gkvh, gd in more_geometries:
        slots = 8
        splits = K5._k5_plan(slots, gkvh, more_mpps, 64).splits
        lengths = [min(n, more_len)
                   for n in (0, 1, 33, 32 * splits + 1, more_len, 65, 200, more_len - 1)]
        for kv_bits in (16, 8, 4):
            check(slots, lengths, kv_bits, None, True, gH, gkvh, gd, more_mpps,
                  f"group {gH // gkvh}")
    # the serving geometry: 8 slots x 192-token contexts, bf16 pools, with the
    # current-row write (no live gate: every slot writes), beside SDPA over
    # the same tokens gathered dense
    slots = 8
    lengths = [192] * slots
    q, k, v, ks, vs, lens, table, kc, vc = attention_case(
        dev, gen, slots, 16, lengths, H=H, kvh=kvh, d=d, mpps=4)
    kw = dict(num_kv_heads=kvh, write_current=True)
    before = K5.launches
    run = lambda: K5.paged_decode_attention(q, k[li], v[li], None, None, lens, table,  # noqa
                                            kc, vc, **kw)
    k_p, v_p = k[li].clone(), v[li].clone()
    out = run()
    ref = K5.paged_decode_attention_plain(q, k_p, v_p, None, None, lens, table, kc, vc, **kw)
    err = float((out - ref).abs().max())
    assert torch.equal(k[li], k_p) and torch.equal(v[li], v_p), "K5 write without live"
    ms = time_it(run, reps=50)
    plain_ms = time_it(lambda: K5.paged_decode_attention_plain(
        q, k[li], v[li], None, None, lens, table, kc, vc, **{**kw, "write_current": False}),
        reps=3)
    K5.launches = before
    from tgq_torch.serve.kv_cache import gather_pools

    kg, vg = gather_pools(k[li], v[li], None, None, table[:, :3], kvh, torch.bfloat16)
    kg = torch.cat([kg[:, :191], kc.to(torch.bfloat16).reshape(slots, 1, kvh, d)], 1)
    vg = torch.cat([vg[:, :191], vc.to(torch.bfloat16).reshape(slots, 1, kvh, d)], 1)
    qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (
        q.to(torch.bfloat16).reshape(slots, 1, H, d), kg, vg))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qb, kb, vb, scale=1.0, enable_gqa=True)
    lib_ms = time_it(sdpa, reps=50)
    b_ms, b_by = bound_ms(attention_bytes(16, lengths, slots, H, kvh, d),
                          4.0 * H * d * sum(lengths))
    log(f"[phase6] K5 serving geometry 8 slots x 192 tokens bf16: {ms*1e3:.1f} us/launch, "
        f"bound {b_ms*1e3:.2f} us ({b_by}), plain {plain_ms*1e3:.1f} us, SDPA on the "
        f"gathered bf16 K/V {lib_ms*1e3:.1f} us; max|do| {err:.3e}")
    assert err <= 1e-5 + 1e-5 * float(ref.abs().max()), err
    k5.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
              library_ms=lib_ms)


def dense_reference(params):
    """The packed decoder linears dequantized to dense bf16 {"w"}."""
    import torch

    from tgq_torch.core.packing import PackedLinear

    def walk(node):
        if isinstance(node, PackedLinear):
            return {"w": node.dequantize(torch.float32).to(torch.bfloat16)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def bf16_exact(params):
    """The packed decoder linears with every scale rounded to a power of two:
    ``(q - z)·s`` then has at most 4 significant bits (z is an integer), so
    the dense reference's bf16 weights equal the kernels' f32 dequantization
    and only the activations' rounding differs between the two paths."""
    import torch

    from tgq_torch.core.packing import PackedLinear

    def walk(node):
        if isinstance(node, PackedLinear):
            return dataclasses.replace(node, scale=torch.exp2(torch.round(torch.log2(node.scale))))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def paged_vs_recompute(params, cfg, dev, steps: int, rel_tol: float, fault=None,
                       ref_attn: str = "auto"):
    """Prefill two prompts (100 and 37 tokens), then ``steps`` paged decode
    steps on 2 slots (bf16 KV); at every step each slot's logits against
    ``forward`` recomputed on the whole sequence with the dequantized dense
    bf16 weights (no K3/K5; ``ref_attn`` "auto" is bf16 SDPA on CUDA,
    "naive" an f32 softmax).  ``fault`` plants a bug for a control reading:
    "attention" passes K5 a zero current V row (so the current token's
    value is lost, in the output and in the pool), "matmul" zeroes every
    packed matmul's last group of inputs.  Returns (max |dlogit|
    / max |logit|, max |logit|, greedy agreements, steps whose reference
    top-2 gap exceeds ``rel_tol`` * max |logit|)."""
    import torch

    from tgq_torch.kernels import paged_attention as K5
    from tgq_torch.models import causal_lm as CL
    from tgq_torch.serve.decode import decode_step, fuse_packed_projections, prefill
    from tgq_torch.serve.kv_cache import PagedKVCache, PageTable

    real_attn, real_mm = K5.paged_decode_attention, CL.quantized_matmul

    def attn_without_current_v(q, kp, vp, ks, vs, lens, table, kc, vc, **kw):
        return real_attn(q, kp, vp, ks, vs, lens, table, kc, torch.zeros_like(vc), **kw)

    def matmul_without_last_group(x, w, *args, **kw):
        x = x.clone()
        x[..., -w.group_size:] = 0
        return real_mm(x, w, *args, **kw)

    dense = dense_reference(params)
    fused = fuse_packed_projections(params)
    page, mpps = 64, 4
    rng = torch.Generator(device="cpu").manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (100, 37)]
    cache = PagedKVCache.init(cfg, 2 * mpps + 1, page, device=dev)
    pt = PageTable(2 * mpps + 1, page, 2, mpps)
    if fault == "attention":
        K5.paged_decode_attention = attn_without_current_v
    elif fault == "matmul":
        CL.quantized_matmul = matmul_without_last_group
    try:
        seqs, toks = [], []
        for s, p in enumerate(prompts):
            pages = pt.alloc_slot(s, len(p))
            ids = torch.zeros((1, len(pages) * page), dtype=torch.long, device=dev)
            ids[0, :len(p)] = torch.tensor(p, device=dev)
            logits, cache = prefill(fused, cache, cfg, torch.tensor(pages, device=dev), ids,
                                    len(p))
            seqs.append(list(p))
            toks.append(int(logits.argmax()))
        worst, agree, decided, top = 0.0, 0, 0, 0.0
        for _ in range(steps):
            for s in range(2):
                pt.extend(s, 1)
                seqs[s].append(toks[s])
            table, lens = pt.device_tables(dev)
            tokens = torch.tensor(toks, dtype=torch.int32, device=dev)
            logits, cache = decode_step(fused, cache, cfg, table, lens, tokens, lens - 1,
                                        live=torch.ones(2, dtype=torch.int32, device=dev))
            for s in range(2):
                ref = CL.forward(dense, cfg, torch.tensor([seqs[s]], device=dev),
                                 attn_impl=ref_attn)[0, -1]
                top_s = float(ref.abs().max())
                worst = max(worst, float((logits[s] - ref).abs().max()) / top_s)
                top = max(top, top_s)
                top2 = torch.topk(ref, 2).values
                if float(top2[0] - top2[1]) > rel_tol * top_s:
                    decided += 1
                    agree += int(int(logits[s].argmax()) == int(ref.argmax()))
                toks[s] = int(logits[s].argmax())
    finally:
        K5.paged_decode_attention, CL.quantized_matmul = real_attn, real_mm
    return worst, top, agree, decided


def kernel_class(name: str) -> str:
    """The bucket of a device kernel's name in the decode-step breakdown."""
    for key, label in (("dequant_matmul_kernel", "K3 matmul"),
                       ("dequant_matmul_reduce", "K3 split-K sum"),
                       ("a8_matmul_kernel", "K4 matmul"),
                       ("paged_attention_kernel", "K5 attention")):
        if key in name:
            return label
    if "gemm" in name.lower() or "cutlass" in name.lower() or "sm90" in name:
        return "dense GEMM (head)"
    return "elementwise and other PyTorch ops"


def decode_step_profile(dev, preset: str = "qwen3-8b", slots: int = 8, prompt_len: int = 128,
                        steps: int = 8, layers=None) -> dict:
    """``decode_steps`` chunks of ``steps`` tokens for ``slots`` slots at
    full width and depth (W4 g128, bf16 KV, dense head), after a warm-up
    chunk: one timed on the host's clock (wall per step, and the host's
    dispatch time per step until ``decode_steps`` returns), then one
    traced by ``torch.profiler`` for the device-busy time (the kernels'
    times summed; one stream, so they do not overlap), launches per step
    and device time by kernel class.  The idle share is 1 - busy / the
    untraced wall (the tracer slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models import PRESETS
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.serve.decode import decode_steps, fuse_packed_projections, prefill_batch
    from tgq_torch.serve.kv_cache import PagedKVCache, PageTable

    cfg = PRESETS[preset]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = fuse_packed_projections(
        init_packed_params(cfg, QuantSpec(bits=4, group_size=128), seed=0, device=dev))
    page = 64
    mpps = -(-(prompt_len + 2 * steps + 1) // page)
    n_pages = slots * mpps + 1
    cache = PagedKVCache.init(cfg, n_pages, page, device=dev)
    pt = PageTable(n_pages, page, slots, mpps)
    gen = torch.Generator(device=dev).manual_seed(0)
    pad = -(-prompt_len // page) * page
    ids = torch.zeros((slots, pad), dtype=torch.long, device=dev)
    ids[:, :prompt_len] = torch.randint(0, cfg.vocab_size, (slots, prompt_len), generator=gen,
                                        device=dev)
    slot_pages = torch.tensor([pt.alloc_slot(s, prompt_len) for s in range(slots)],
                              device=dev)
    temps = torch.zeros((slots,), device=dev)
    live = torch.ones((slots,), dtype=torch.int32, device=dev)
    tok, cache = prefill_batch(params, cache, cfg, slot_pages, ids,
                               torch.full((slots,), prompt_len, device=dev), temps, gen,
                               greedy_only=True)

    def chunk():
        lens0 = torch.tensor(pt.lens, dtype=torch.int32, device=dev)
        for s in range(slots):
            pt.extend(s, steps)
        table, _ = pt.device_tables(dev)
        return decode_steps(params, cache, cfg, table, lens0 + 1, tok, lens0, temps, gen,
                            steps, greedy_only=True, live=live)[0]

    chunk().cpu()
    t0 = time.time()
    toks = chunk()
    host = time.time() - t0
    toks.cpu()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        chunk().cpu()
        traced_wall = time.time() - t0
    by_class: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = kernel_class(e.key)
        by_class[label] = by_class.get(label, 0.0) + dev_us / 1e3
        launches += e.count
    busy = sum(by_class.values())
    out = {"layers": cfg.num_layers, "slots": slots, "steps": steps,
           "wall_ms_per_step": wall * 1e3 / steps, "host_ms_per_step": host * 1e3 / steps,
           "traced_wall_ms_per_step": traced_wall * 1e3 / steps,
           "device_busy_ms_per_step": busy / steps,
           "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
           "device_launches_per_step": launches / steps,
           "device_ms_per_step_by_class": {k: v / steps for k, v in sorted(
               by_class.items(), key=lambda kv: -kv[1])}}
    del params, cache
    return out


def phase7_serving(dev, counts: dict, preset: str = "qwen3-8b", check_layers: int = 4,
                   serve_layers=None, steps: int = 16, serve_args=None) -> list:
    """(a) prefill + ``steps`` decode steps on 2 slots at ``check_layers``
    layers, logits held at every step against full-recompute ``forward``
    on the dequantized dense weights (SDPA attention, no K3/K5), beside
    the same with bf16-exact weights and two planted faults that the
    tolerance must catch (``paged_vs_recompute``);
    (b) ``tgq_torch.cli.serve.run`` at all layers with kv_bits 16, 8, and
    4 with a_bits 8 and an 8-bit head, each run's launch counts read."""
    import torch

    from tgq_torch.cli.serve import build_parser, run
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.kernels import dequant_matmul as KD
    from tgq_torch.kernels import paged_attention as K5
    from tgq_torch.models import PRESETS
    from tgq_torch.models.hf_import import init_packed_params

    cfg = dataclasses.replace(PRESETS[preset], num_layers=check_layers)
    t0 = time.time()
    params = init_packed_params(cfg, QuantSpec(bits=4, group_size=128), seed=0, device=dev)
    # allowed |logit| difference, relative to the largest reference logit
    rel_tol = 0.03
    exact = bf16_exact(params)
    readings = {}
    for label, tree, fault, ref_attn in (
            ("sound", params, None, "auto"),
            ("bf16-exact weights", exact, None, "auto"),
            ("bf16-exact weights, f32 reference attention", exact, None, "naive"),
            ("fault: K5 drops the current V row", params, "attention", "auto"),
            ("fault: K3 skips the last input group", params, "matmul", "auto")):
        readings[label] = paged_vs_recompute(tree, cfg, dev, steps, rel_tol, fault, ref_attn)
        log(f"[phase7a] {label}: max|dlogit| / max|logit| {readings[label][0]:.4g} "
            f"(max|logit| {readings[label][1]:.2f}); greedy agrees on {readings[label][2]}/"
            f"{readings[label][3]} steps whose reference top-2 gap exceeds the tolerance")
    worst, _, agree, decided = readings["sound"]
    log(f"[phase7a] {cfg.name} x{check_layers} layers W4 g128, 2 slots, prefill + {steps} "
        f"decode steps vs full-recompute forward on the dequantized weights: max|dlogit| / "
        f"max|logit| {worst:.4f}, tolerance {rel_tol} ({time.time()-t0:.1f} s)")
    for label, (rel, _, agree_l, decided_l) in readings.items():
        if label.startswith("fault"):
            assert rel > rel_tol, (label, rel)  # the limit catches a planted fault
        else:
            assert rel <= rel_tol and agree_l == decided_l, (label, rel, agree_l, decided_l)
    del params, exact

    results = []
    base = serve_args or ["--model_id", preset, "--w_bits", "4", "--group_size", "128",
                          "--n_requests", "16", "--prompt_len", "128", "--gen_tokens", "64",
                          "--max_slots", "8", "--page_size", "64", "--decode_chunk", "8"]
    for extra in (["--kv_bits", "16"], ["--kv_bits", "8"],
                  ["--kv_bits", "4", "--a_bits", "8", "--lm_head_bits", "8"]):
        args = build_parser().parse_args(base + extra + ["--device", dev.type])
        full = PRESETS[args.model_id]
        if serve_layers is not None:  # a cut depth, for rehearsals
            PRESETS[args.model_id] = dataclasses.replace(full, num_layers=serve_layers)
        KD.launches = KD.launches_a8 = K5.launches = 0
        t0 = time.time()
        try:
            res = run(args)
        finally:
            PRESETS[args.model_id] = full
        if dev.type == "cuda":
            torch.cuda.synchronize()
        got = {"dequant_matmul": KD.launches, "a8_matmul": KD.launches_a8,
               "paged_attention": K5.launches}
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        print(json.dumps(res), flush=True)
        log(f"[phase7b] {' '.join(extra)}: {res['value']} tok/s, decode-only "
            f"{res['decode_only_tok_s']} tok/s, TTFT p50/p90/p99 {res['ttft_p50_s']}/"
            f"{res['ttft_p90_s']}/{res['ttft_p99_s']} s, decode wall {res['decode_wall_s']} s, "
            f"prefill wall {res['prefill_wall_s']} s; launches {got} ({time.time()-t0:.1f} s "
            f"with set-up)")
        n_req, gen_tok = int(base[base.index("--n_requests") + 1]), int(
            base[base.index("--gen_tokens") + 1])
        assert res["total_tokens"] == n_req * gen_tok, res
        assert got["dequant_matmul"] > 0 and got["paged_attention"] > 0, got
        if "--a_bits" in extra:
            assert got["a8_matmul"] > 0 and res["config"]["a_bits"] == 8, (got, res["config"])
        results.append(res)
    t0 = time.time()
    prof = decode_step_profile(dev, preset, layers=serve_layers)
    print(json.dumps({"decode_step_profile": prof}), flush=True)
    log(f"[phase7c] {preset} x{prof['layers']} layers, {prof['slots']} slots, bf16 KV: "
        f"{prof['wall_ms_per_step']:.2f} ms/step wall, host dispatch "
        f"{prof['host_ms_per_step']:.2f} ms/step (traced: {prof['traced_wall_ms_per_step']:.2f} "
        f"ms/step wall), device busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms/step, idle share {prof['idle_share']}, "
        f"{prof['device_launches_per_step']:.0f} device launches/step ({time.time()-t0:.1f} s)")
    return results


# ------------------------------------------- families and checkpoints (8)

# rel_error over RTN's for a module whose pchol rank is below half its input
# width: the card read at most 1.006 at eps 1e-6 (PERF.md section 2)
LOW_RANK_RTN_CAP = 1.05

def write_hf_model(path: str, preset: str, dev, n_files: int = 1):
    """A checkpoint in the published HF layout of ``preset`` with random
    bf16 weights (seed 0), written by the port's safetensors writer; GPT-2
    gets its f32 causal-mask buffers too.  ``n_files`` > 1 splits it into
    that many shards with an index.  Returns (cfg, bytes, seconds of the
    flatten and the write)."""
    import torch

    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params
    from tgq_torch.models.hf_export import _gpt2_state_dict, _opt_state_dict, hf_config_dict
    from tgq_torch.models.safetensors_io import save_checkpoint

    cfg = PRESETS[preset]
    params = init_params(cfg, seed=0, device=dev)
    t0 = time.time()  # the export's work: flatten to HF names on the host, write
    flatten = _gpt2_state_dict if cfg.family == "gpt2" else _opt_state_dict
    state = flatten(params, torch.bfloat16)
    del params
    if cfg.family == "gpt2":
        n = cfg.max_position_embeddings
        mask = torch.tril(torch.ones((n, n))).reshape(1, 1, n, n)
        for li in range(cfg.num_layers):
            state[f"transformer.h.{li}.attn.bias"] = mask
    total = sum(t.numel() * t.element_size() for t in state.values())
    files = save_checkpoint(path, state, max_shard_bytes=int(0.6 * total) if n_files == 2
                            else total)
    assert files == n_files, (files, n_files)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f)
    return cfg, total, time.time() - t0


def groups_in_features(cfg):
    """Each quantization group's input width, and each module's."""
    from tgq_torch.models.causal_lm import sequenced_groups

    widths = [cfg.hidden_size, cfg.q_size, cfg.hidden_size, cfg.intermediate_size]
    return widths, [w for w, g in zip(widths, sequenced_groups(cfg)) for _ in g]


def group_of(cfg, mod: str) -> int:
    """The quantization group whose input ``mod`` reads."""
    from tgq_torch.models.causal_lm import sequenced_groups

    return next(gi for gi, g in enumerate(sequenced_groups(cfg)) if mod in g)


def layer0_grams(params, cfg, calib, dev, groups, bs: int = 8):
    """Layer 0's Hessians of the given groups, from the unquantized model
    and the run's calibration tokens (``HessianAccumulator``): each group's
    input as the unquantized layer computes it, not as the quantize run
    sees it after the earlier groups were quantized."""
    from tgq_torch.calib.pipeline import _embed_batches, _group_input
    from tgq_torch.models.causal_lm import rope_cache, tree_to
    from tgq_torch.solver.hessian import HessianAccumulator

    widths, _ = groups_in_features(cfg)
    inps = _embed_batches(params, cfg, calib, bs, dev)
    lp = tree_to(params["model"]["layers"][0], dev)
    cos, sin = rope_cache(cfg, calib.shape[1], device=dev)
    out = {}
    for gi in groups:
        acc = HessianAccumulator.init(widths[gi], device=dev)
        for j in range(0, len(calib), bs):
            acc.update(_group_input(lp, cfg, gi, inps[j:j + bs], cos, sin))
        out[gi] = acc.finalize()
    return out


def k1_new_width(K1, h, label: str, time_it, sweep: bool) -> dict:
    """K1 at a Gram of the run: one panel (and, with ``sweep``, the whole
    sweep) bit for bit against the plain version, then one panel timed."""
    import torch

    from tgq_torch.solver.pchol import _sweep

    n = h.shape[0]
    a = h.contiguous()
    d = torch.diagonal(a).reshape(1, n).contiguous()
    done = torch.zeros((1, n), dtype=torch.float32, device=a.device)
    before = K1.launches
    k1_panel_case(K1, a, d, done, min(128, n), label)
    if sweep:
        got = _sweep(h, plain=False)
        want = _sweep(h, plain=True)
        same = [bits_equal(x, y) for x, y in zip(got, want)]
        log(f"[phase8] K1 {label}: whole sweep ({-(-n // 128)} panels) perm, Lt, dhist, "
            f"pivhist bit for bit {same}")
        assert all(same), same
    ms = time_it(lambda: K1.pchol_panel(a, d, done), reps=10)
    plain_ms = time_it(lambda: K1.pchol_panel_plain(a, d, done), reps=1, warmup=0)
    K1.launches = before
    panel = 128
    nbytes = 4 * (panel * n + 2 * n) + 4 * (panel * n + 2 * n + 2 * panel)
    b_ms, b_by = bound_ms(nbytes, panel * (panel - 1) * n + 8 * panel * n)
    log(f"[phase8] K1 n={n} ({label}): {ms:.4f} ms/launch, plain {plain_ms:.1f} ms, "
        f"bound {b_ms * 1e3:.2f} us ({b_by})")
    return {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def k2_new_width(K2, w, h, label: str, time_it, group_size: int = 128) -> dict:
    """K2 on a real module's first column block, in the order and with the
    factor pchol gives ``h``, the layer-0 Gram of the module's own group:
    codes and e bit for bit against the plain version, two launches alike,
    then timed."""
    from tgq_torch.core.quant import QuantSpec, expand_params, find_params
    from tgq_torch.solver.pchol import pchol_factor

    spec = QuantSpec(bits=4, group_size=group_size, sym=False)
    b = min(256, w.shape[1])
    f = pchol_factor(h, eps=1e-6, want_rx=False)
    perm = f.perm.long()
    w = w.float()
    s_full, z_full = expand_params(find_params(w, spec), w.shape[1])
    wb = w[:, perm][:, :b].contiguous()
    s, z = s_full[:, perm][:, :b].contiguous(), z_full[:, perm][:, :b].contiguous()
    r = f.r_full[:b, :b].contiguous()
    m = wb.shape[0]
    before = K2.launches
    q_k, e_k = K2.process_block(wb, s, z, r, spec.min_q, spec.max_q)
    q_k2, e_k2 = K2.process_block(wb, s, z, r, spec.min_q, spec.max_q)
    q_p, e_p = K2.process_block_plain(wb, s, z, r, spec.min_q, spec.max_q)
    ok = bits_equal(q_k, q_p) and bits_equal(e_k, e_p)
    rep = bits_equal(q_k, q_k2) and bits_equal(e_k, e_k2)
    ms = time_it(lambda: K2.process_block(wb, s, z, r, spec.min_q, spec.max_q), reps=20)
    plain_ms = time_it(lambda: K2.process_block_plain(wb, s, z, r, spec.min_q, spec.max_q),
                       reps=2)
    K2.launches = before
    nbytes = 4 * (3 * m * b + b * b) + 4 * (2 * m * b)
    b_ms, b_by = bound_ms(nbytes, m * b * (b - 1) + 8 * m * b)
    log(f"[phase8] K2 m={m} b={b} ({label}, rank {f.rank}): codes and e bit for bit {ok}; "
        f"two launches identical {rep}; {ms:.4f} ms/launch, plain {plain_ms:.1f} ms, "
        f"bound {b_ms * 1e3:.2f} us ({b_by})")
    assert ok and rep, (label, ok, rep)
    return {"m": m, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def quantize_family(dev, counts: dict, tmp: str, preset: str, n_files: int, n_samples: int,
                    group_size: int = 128):
    """Phase 8 for one model: write its HF checkpoint, quantize it through
    the CLI (export, resume directory and trace on), then hold the result
    to RTN, to the unquantized PPL, to the shape-derived launch counts, to
    its HF export and to its trace.  Returns what the kernel checks need
    and the numbers to print."""
    import numpy as np
    import torch

    from tgq_torch.calib.pipeline import _load_resume
    from tgq_torch.cli.quantize import main
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models.causal_lm import forward
    from tgq_torch.models.hf_import import load_hf_checkpoint

    src = os.path.join(tmp, preset)
    cfg, nbytes, write_s = write_hf_model(src, preset, dev, n_files)
    log(f"[phase8] {preset}: wrote {nbytes / 1e9:.3f} GB ({n_files} file(s)) in "
        f"{write_s:.1f} s")
    out, res_dir, prof = (os.path.join(tmp, f"{preset}.{k}") for k in ("out", "resume", "prof"))
    args = ["--model_id", src, "--device", dev.type, "--mode", "pchol", "--w_bits", "4",
            "--group_size", str(group_size), "--dataset", "synthetic", "--n_samples",
            str(n_samples), "--seq_len", str(cfg.seqlen), "--eps", "1e-6"]
    t0 = time.time()
    assert main(args + ["--mode", "baseline", "--save_path", out + ".base"]) == 0
    with open(os.path.join(out + ".base", "results.json")) as f:
        base_ppl = json.load(f)["metrics"]["baseline_ppl"]
    log(f"[phase8] {preset}: unquantized PPL {base_ppl:.4f} ({time.time() - t0:.1f} s)")
    K1.launches = K2.launches = 0
    t0 = time.time()
    assert main(args + ["--save_path", out, "--hf_export", "--resume_dir", res_dir,
                        "--profile_dir", prof]) == 0
    cli_s = time.time() - t0
    k1_n, k2_n = K1.launches, K2.launches
    counts["pchol_panel"] = counts.get("pchol_panel", 0) + k1_n
    counts["gptq_block"] = counts.get("gptq_block", 0) + k2_n
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    stats, metrics = res["layer_stats"], res["metrics"]
    per_layer = metrics["phase_timing"]
    q_ppl = metrics["quantized_ppl"]
    widths, mod_widths = groups_in_features(cfg)
    want_k1 = cfg.num_layers * sum(-(-w // 128) for w in widths)
    want_k2 = cfg.num_layers * sum(-(-w // 256) for w in mod_widths)
    log(f"[phase8] {preset}: CLI quantize {cli_s:.1f} s under the trace (pipeline "
        f"{metrics['total_time']:.1f} s, {metrics['total_time'] / cfg.num_layers:.3f} s/layer"
        f"); phases {json.dumps(per_layer)}")
    log(f"[phase8] {preset}: launches pchol_panel {k1_n} (from the shapes {want_k1}), "
        f"gptq_block {k2_n} (from the shapes {want_k2})")
    if dev.type == "cuda":  # the wrappers count launches of the kernels only
        assert (k1_n, k2_n) == (want_k1, want_k2), (k1_n, want_k1, k2_n, want_k2)
    # PERF.md section 2: rel_error <= RTN's where pchol keeps at least half
    # the columns in rank; below that the truncated solve can land above RTN
    # in the JAX package too, and those modules are held to LOW_RANK_RTN_CAP
    assert len(stats) == len(mod_widths) * cfg.num_layers
    assert all(math.isfinite(st["rel_error"]) for st in stats), stats
    n_in = mod_widths * cfg.num_layers
    held = [st for st, n in zip(stats, n_in) if 2 * st["rank"] >= n]
    low = [(st, n) for st, n in zip(stats, n_in) if 2 * st["rank"] < n]
    worse = [st for st in held if st["rel_error"] > st["rtn_rel_error"]]
    worse += [st for st, _ in low if st["rel_error"] > LOW_RANK_RTN_CAP * st["rtn_rel_error"]]
    above = [st for st, _ in low if st["rel_error"] > st["rtn_rel_error"]]
    worst = max(held, key=lambda st: st["rel_error"] / st["rtn_rel_error"])
    top = max([st["rel_error"] / st["rtn_rel_error"] for st in above] or [0.0])
    log(f"[phase8] {preset}: {len(held)} of {len(stats)} modules keep at least half their "
        f"columns in rank, {len(worse)} of them above RTN (highest ratio {worst['name']} "
        f"{worst['rel_error']:.4f} vs {worst['rtn_rel_error']:.4f}); {len(low)} below half "
        f"(ranks {sorted(st['rank'] for st, _ in low)[:3]}...), {len(above)} of them above "
        f"RTN, ratios up to {top:.4f} (cap {LOW_RANK_RTN_CAP}); quantized PPL {q_ppl:.4f} vs {base_ppl:.4f} "
        f"({(q_ppl / base_ppl - 1) * 100:+.3f} %)")
    assert not worse, worse
    assert math.isfinite(q_ppl) and abs(q_ppl / base_ppl - 1) <= 0.05, (q_ppl, base_ppl)

    # the export against the in-memory quantized model, which the resume
    # directory holds layer by layer
    t0 = time.time()
    exported, cfg_e = load_hf_checkpoint(os.path.join(out, "hf"), device=dev)
    import_s = time.time() - t0
    params, cfg_src = load_hf_checkpoint(src, device=dev)
    assert _load_resume(res_dir, params, {}, {"layer_stats": []}, cfg.num_layers) \
        == cfg.num_layers
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256)))
    ids = ids.to(dev)
    same = bits_equal(forward(exported, cfg_e, ids), forward(params, cfg_src, ids))
    log(f"[phase8] {preset}: HF export imported in {import_s:.1f} s; its logits equal the "
        f"quantized model's bit for bit {same}")
    assert same
    del exported, params

    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
    kernels = sorted(n for n in names if "pchol_panel_kernel" in n or "gptq_block" in n)
    log(f"[phase8] {preset}: trace {os.path.getsize(os.path.join(prof, 'trace.json')) / 1e6:.1f}"
        f" MB, K1/K2 kernels in it: {kernels}")
    if dev.type == "cuda":
        assert any("pchol_panel_kernel" in k for k in kernels), sorted(names)[:50]
        assert any("gptq_block" in k for k in kernels), sorted(names)[:50]
    return {"cfg": cfg, "src": src, "out": out, "stop_layer": cfg.num_layers // 2 - 1,
            "traced_s_per_layer": metrics["total_time"] / cfg.num_layers,
            "write_s": write_s, "import_s": import_s, "gb": nbytes / 1e9}


def cli_inputs(run: dict, n_samples: int):
    """The CLI run's QuantizeConfig (from its checkpoint's config.json)
    and calibration tokens, to repeat its quantization in-process."""
    from tgq_torch.calib import QuantizeConfig
    from tgq_torch.calib.data import get_loaders

    cfg = run["cfg"]
    with open(os.path.join(run["out"], "config.json")) as f:
        qcfg = QuantizeConfig(**json.load(f)["quant_config"])
    calib = get_loaders("synthetic", None, n_samples, cfg.seqlen, seed=42,
                        vocab_size=cfg.vocab_size)
    return qcfg, calib


def timed_quantize(dev, run: dict, n_samples: int) -> dict:
    """The CLI run's quantization again, untraced, with every phase
    synchronized (``PhaseTimers(sync=True)``): s/layer and the phase split."""
    import torch

    from tgq_torch.calib import quantize_model
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models.hf_import import load_hf_checkpoint
    from tgq_torch.utils.profiling import PhaseTimers

    cfg = run["cfg"]
    qcfg, calib = cli_inputs(run, n_samples)
    params, _ = load_hf_checkpoint(run["src"], device=dev)
    before = (K1.launches, K2.launches)
    timers = PhaseTimers(sync=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    quantize_model(params, cfg, calib, qcfg, device=dev, timers=timers)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.time() - t0
    K1.launches, K2.launches = before
    split = {k: round(v["total_s"] / cfg.num_layers, 4) for k, v in timers.summary().items()}
    log(f"[phase8] {cfg.name}: untraced quantize {secs:.2f} s, {secs / cfg.num_layers:.3f} "
        f"s/layer; per layer {json.dumps(split)}")
    return {"s_per_layer": secs / cfg.num_layers, "split": split}


def resume_check(dev, run: dict, n_samples: int) -> None:
    """Stop after ``stop_layer``, resume in a fresh call, and hold every
    module's codes to the uninterrupted CLI run's, bit for bit."""
    import torch

    from tgq_torch.calib import quantize_model
    from tgq_torch.core.checkpoint import load_quantized
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models.causal_lm import get_nested
    from tgq_torch.models.hf_import import load_hf_checkpoint

    cfg = run["cfg"]
    qcfg, calib = cli_inputs(run, n_samples)
    ref, _, _ = load_quantized(run["out"], device=dev)
    before = (K1.launches, K2.launches)
    res_dir = run["out"] + ".stop"
    t0 = time.time()
    params, _ = load_hf_checkpoint(run["src"], device=dev)
    _, _, log1 = quantize_model(params, cfg, calib, qcfg, device=dev, resume_dir=res_dir,
                                stop_after_layer=run["stop_layer"])
    params, _ = load_hf_checkpoint(run["src"], device=dev)
    _, packed, log2 = quantize_model(params, cfg, calib, qcfg, device=dev,
                                     resume_dir=res_dir)
    K1.launches, K2.launches = before
    names = [st["name"] for st in log2["layer_stats"]]
    assert len(names) == len(set(names)) == len(packed), (len(names), len(packed))
    assert len(log1["layer_stats"]) == len(packed) * (run["stop_layer"] + 1) // cfg.num_layers
    diff = [k for k, pl in packed.items() if not torch.equal(
        pl.codes, get_nested(ref["model"]["layers"][int(k.split(".")[1])],
                             k.split(".", 2)[2]).codes)]
    log(f"[phase8] {cfg.name}: stopped after layer {run['stop_layer']}, resumed: "
        f"{len(packed)} modules, each named once in layer_stats; codes equal to the "
        f"uninterrupted run's bit for bit in all but {diff} ({time.time() - t0:.1f} s)")
    assert not diff, diff


def phase8_families(dev, counts: dict, models=(("gpt2", 1), ("opt-1.3b", 2)),
                    n_samples: int = 32, group_size: int = 128, time_it=None) -> dict:
    """GPT-2 and OPT-1.3b from HF checkpoints through the quantize CLI, K1
    and K2 at their widths, the export round trip, resume and the trace."""
    from tgq_torch.calib.data import get_loaders
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models.causal_lm import get_nested
    from tgq_torch.models.hf_import import load_hf_checkpoint

    time_it = time_it or cuda_ms
    t_phase = time.time()
    k1_rows, k2_rows, runs = [], [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, n_files in models:
            run = quantize_family(dev, counts, tmp, preset, n_files, n_samples, group_size)
            runs[preset] = run
            cfg = run["cfg"]
            # K1 and K2 at this family's widths, on Grams of the run
            src_params = load_hf_checkpoint(run["src"], device=dev)[0]
            calib = get_loaders("synthetic", None, n_samples, cfg.seqlen, seed=42,
                                vocab_size=cfg.vocab_size)
            mods = (("attn.c_attn", "attn.c_proj", "mlp.c_fc") if cfg.family == "gpt2"
                    else ("self_attn.q_proj", "fc1"))
            k1_groups = (0, 3)
            grams = layer0_grams(src_params, cfg, calib, dev,
                                 sorted({*k1_groups, *(group_of(cfg, m) for m in mods)}))
            for gi in k1_groups:
                h = grams[gi]
                k1_rows.append(k1_new_width(K1, h, f"{preset} layer-0 group {gi}", time_it,
                                            sweep=h.shape[0] in (768, 8192)))
            lp = src_params["model"]["layers"][0]
            for mod in mods:
                gi = group_of(cfg, mod)
                k2_rows.append(k2_new_width(K2, get_nested(lp, mod)["w"], grams[gi],
                                            f"{preset} {mod} (group {gi})", time_it,
                                            group_size))
            del src_params, grams
            run.update(timed_quantize(dev, run, n_samples))
            if cfg.family == "gpt2":
                resume_check(dev, run, n_samples)
    for r in k1_rows:
        log(f"[phase8] K1 n={r['n']}: {r['ms']:.4f} ms/launch, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.2f} ms")
    for r in k2_rows:
        log(f"[phase8] K2 m={r['m']}: {r['ms']:.4f} ms/launch, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.2f} ms")
    for preset, run in runs.items():
        log(f"[phase8] {preset}: {run['s_per_layer']:.3f} s/layer untraced "
            f"({run['traced_s_per_layer']:.3f} in the traced CLI run), per layer "
            f"{json.dumps(run['split'])}; checkpoint {run['gb']:.3f} GB written in "
            f"{run['write_s']:.1f} s, the export imported in {run['import_s']:.1f} s")
    log(f"[phase8] families and checkpoints: {time.time() - t_phase:.1f} s")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8",
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

    k3 = {"name": "dequant_matmul", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/dequant_matmul.cu",
          "replaces": "tgq/kernels/dequant_matmul.py:73", "library_ms": None}
    k4 = {"name": "a8_matmul", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/a8_matmul.cu",
          "replaces": "tgq/kernels/dequant_matmul.py:108", "library_ms": None}
    k5 = {"name": "paged_attention", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/paged_attention.cu",
          "replaces": "tgq/kernels/paged_attention.py:106", "library_ms": None}
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
    if 5 in phases:
        k3_group_check(dev)
        phase5_matmul(dev, k3, k4)
    if 6 in phases:
        phase6_attention(dev, k5)
    if 7 in phases:
        phase7_serving(dev, counts)
    if 8 in phases:
        phase8_families(dev, counts)
    kernels = [k1, k2, k3, k4, k5]
    for k in kernels:
        k["launches"] = counts.get(k["name"], 0)
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"):
            k.setdefault(key, None)

    log(card_line())  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
