#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``tgq_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 0,5,6,7   # the serving slice only
    python3 chip_smoke.py --phases 0,8       # GPT-2 / OPT, HF checkpoints, resume
    python3 chip_smoke.py --phases 0,9       # equalizers, soak, harnesses, tables
    python3 chip_smoke.py --phases 0,10      # tensor and data parallelism (runs phase 3's
                                             # sweep itself when phase 3 is not asked for),
                                             # GPT-2 / OPT / svd under the mesh (10e)
    python3 chip_smoke.py --phases 0,11      # K6 (causal flash attention), the slice-9 CLIs
    python3 chip_smoke.py --phases 0,12      # K6-bwd, training through the flash attention
    python3 chip_smoke.py --phases 0,13      # the decode chunk as CUDA graphs

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
     give (plus one sweep for each factor build the pchol ladder
     re-sweeps), the export's logits against the in-memory model's bit for
     bit, the trace's kernel names; K1 and K2 at the families' widths
     against their plain versions; an untraced rerun for s/layer; GPT-2
     stopped after layer 5 and resumed, codes bit for bit.
  9. Equalizers, the native allocator, the soak and the harnesses:
     (a) KV equalizers estimated on 256 seeded tokens for phase 7a's
     model, then paged decode with int8 and int4 KV, with and without
     them, against full recompute under phase 7a's limit: equalized int8
     against the unquantized model, equalized int8 and int4 against the
     model whose last token attends the rows the cache stored (int4's own
     error against the unquantized model is printed, 9x the limit), with a
     planted fault (decode without the equalizers) caught; (b) the serve
     CLI at 12 layers (cut from 36 to make room for phase 10) with
     ``--kv_equalize`` and the native page allocator, kv8 and kv4 + A8 +
     8-bit head; (c) the serving soak (``tgq_torch.cli.serve_soak``: 256
     mixed requests, cut from 512, 128 slots, kv8,
     A8, EOS), every request within budget and the pages balanced; (d)
     ``kernel_bench`` (K3 at t = 16 and 8, K4 at t = 8; the t = 8
     readings within 25 % of phase 5's), ``decode_bench`` at its defaults
     and at phase 7c's shape (the whole step within 25 % of phase 7c's
     chunk wall, timed interleaved with it), ``gptq_kernel_bench`` (K2
     faster than plain, codes bit for bit); (e) ``run_benchmark`` (11 rows), ``run_baseline`` and
     ``run_experiments`` on a 12-layer GPT-2 HF checkpoint, every row OK,
     W4 PPL within 5 % of FP, and ``extract_log`` over the table's runs;
     (f) ``kv_quality``: equalized int8 / int4 error below unequalized at
     every context; (g) ``synthetic_bench``: pchol and eigh at or below
     RTN at W4.  Each path runs with the launch counters set to 0 just
     before it and read just after.
 10. Tensor and data parallelism, ranks started with the ``spawn`` method
     and talking over gloo on the one card: (a) K5's chunk-window mode
     (``w_live``, ``return_stats``) against its plain version at the
     rank-local shape of Qwen3-8B under TP 2 (16 q / 4 kv heads), bf16 /
     int8 / int4, w_live 0, 1, 7, 8, an idle slot and empty pool ranges,
     its partials merged with ``_window_partial`` against non-window K5,
     timed beside non-window K5; (b) TP 2 decode at Qwen3-8B width, 4
     layers, W4 g128, two chunks of 8 steps in chunk-window mode, every
     step's logits against full recompute under phase 7a's limit (kv16 and
     kv8 against the unquantized model, kv4 against the model attending the
     rows the ranks stored), the ranks' tokens identical; (c) ``python -m
     tgq_torch.cli.serve --mesh_model 2`` at 36 layers, kv16 and kv4 + A8 +
     an 8-bit head, 8 requests of 128 + 32 tokens, beside phase 7b, the
     decode steps' collectives counted and timed apart from the prefill's
     (``--time_collectives``); (d)
     ``quantize_model(mesh=make_mesh(data=2, model=2))`` on 4 ranks at phase
     3's setting, held to phase 3's run (Gram error at most 2x, < 2 % of
     q_proj's weights moved, PPL within 2 %); (e) the same mesh sweep of
     GPT-2 (12 layers) and OPT-1.3b (full width, 4 layers), and ``mode="svd"``
     at GPT-2 width (1 layer) on it and on (data 4 x model 1), from HF
     checkpoints written as phase 8 writes them, at phase 8's calibration
     (32 sequences at the model's seqlen, W4 g128, eps 1e-6 energy), beside
     single-rank sweeps of the same checkpoints: GPT-2's codes equal in
     every layer, OPT-1.3b's layer-0 codes equal (q/k/v from the
     replicated LayerNorm input, out_proj, fc1 and fc2 from the gathered
     heads), under 2 % of any later layer's codes moved and its PPL within
     2 %, every svd sketch bit-equal; the share of codes moved by layer,
     s/layer and K1 / K2 / K6 launches by rank printed.  A failure in any
     rank fails the phase.
 11. K6, the causal flash attention of every whole-sequence forward
     (calibration, PPL, equalizer calibration, prefill, GPT-2 / OPT): (a)
     the build's ptxas report shows K6's wgmma kernels free of spills and
     of serialised wgmmas; K6 against its plain version within
     ``causal_attention.tolerance`` at lengths 1, 7, 64, 65, 100, 127-129,
     255-257, 2047, 2048 (the 64- and 128-row tile edges), head_dim 16 / 64
     / 128, GQA groups 1 / 4 / 8, Qwen3-8B's 32 / 8 heads and its TP 2
     rank's 16 / 4, GPT-2's fused q/k/v views, an OPT-1.3b TP 2 head slice,
     a peaked softmax; two launches, a batch of 8 and each sequence alone,
     head slices and the full launch, all bit for bit; (b) timed at the
     main paths' shapes beside its bound, its plain version, SDPA (the
     yardstick only) and the first design's reading; (c) K6's launch
     counter is set to 0 before and read after phases 3, 4, 7b, 8 and 10
     (on each rank), > 0 on each; (d)
     ``trunc_regimes`` (one cell), ``tiny_quality_bench`` (300 steps, W4,
     A16 and A8), ``boundary_bench`` and ``reproduce_baseline --smoke`` on
     the card, each with the counters read around it.
 12. K6-bwd, the gradients of the causal flash attention, and the training
     path through it: (a) dq, dk, dv against the plain backward within
     ``causal_attention_bwd.bwd_tolerance`` over phase 11a's cases, K6's
     stats output against the plain log2-sum-exp, K6's o bit-identical with
     the stats output on and off, two backward launches, a batch and each
     sequence alone, head slices and the full launch, all bit for bit; the
     six kernels' ptxas registers, spills and wgmma serialisation warnings
     (none allowed); (b) timed at the calibration, GPT-2 and OPT-1.3b shapes
     beside the first design's (mma.sync), its bound (counted and executed
     TFLOP/s), its plain version and the SDPA backward (the yardstick
     only); (c) the LM loss through the staged functions with
     ``attn_impl="flash"`` at Qwen3-8B full width (2 layers, 4 x 2048) and
     GPT-2 (12 layers, 8 x 1024): every parameter's gradient against
     "naive" within ``TRAIN_REL_FROB``, then 3 AdamW steps with the loss
     falling, K6-bwd launched once a layer a step, the seconds a step.
 13. The serving engine's decode chunks replayed from CUDA graphs
     (``tgq_torch.serve.decode.DecodeGraphs``) against the same engine with
     ``graphs = None`` (every chunk eager), at Qwen3-8B full width and
     depth, W4 g128, budgets of 8-64 (slots retire mid-chunk; overlapped
     dispatch): 8 slots and 16 seeded requests of 128 prompt tokens at bf16
     KV with A16, int8 KV with W4A8 (K4), and int4 KV with W4A8 and an
     8-bit packed head; 128 slots and 128 requests of 512 tokens at bf16
     KV.  The tokens identical, the K3 / K4 / K5 launches counted alike,
     every chunk replayed from a graph, four captures; the capture's
     seconds and both runs' walls printed (one-shot).

Every mismatch raises; the script exits 0 only if every phase passed.
The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.  It fails without CUDA, and
without the ``tgq_torch`` package beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

from tgq_torch.utils.timing import (  # fails outside a checkout of the repo
    BF16_FLOP_PER_S,
    HBM_BYTES_PER_S,
    INT8_OP_PER_S,
    bound_ms,
    cuda_ms,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    """Same shape and the same bits (f32 and bf16 compared as integers)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    elif x.dtype == torch.bfloat16:
        x, y = x.view(torch.int16), y.view(torch.int16)
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
    return errs


def phase3_main_path(dev, counts: dict, preset: str = "qwen3-8b", n_samples: int = 32,
                     seq: int = 2048, eval_tokens: int = 8192, group_size: int = 128) -> dict:
    """The quantize main path; returns what phase 10d compares its mesh run
    with: layer 0's q/k/v Gram error, the modules' pchol ranks, layer 0's
    written-back q_proj (on the host), the quantized PPL and s/layer."""
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
    gram_errs = layer0_gram_check(params, cfg, calib, qcfg, dev)
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
    return {"gram_err": gram_errs["HessianAccumulator"],
            "ranks": {st["name"]: st["rank"] for st in run_log["layer_stats"]},
            "q0": params["model"]["layers"][0]["self_attn"]["q_proj"]["w"].cpu(),
            "q1": params["model"]["layers"][1]["self_attn"]["q_proj"]["w"].cpu(),
            "ppl": q_ppl, "s_per_layer": secs / cfg.num_layers}


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
                  time_it=None, readings=None) -> None:
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
    is held within 2e-2 * max|y|.  ``readings`` collects each timed
    launch's ms under ("K3" | "K4", name, bits, t)."""
    import torch

    from tgq_torch.kernels import dequant_matmul as KD

    time_it = time_it or cuda_ms
    readings = {} if readings is None else readings
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
                        readings[("K3", name, bits, t)] = ms
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
                readings[("K4", name, bits, t)] = ms
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


def stored_kv_attention(cfg, cache, table_row, eq, window=None):
    """A causal attention for ``forward`` whose last query attends the K/V
    rows the paged cache holds for its earlier tokens (dequantized, times
    the equalizers ``eq`` = (k_eq, v_eq) when given) and its own row as
    computed: the attention of the last token over exactly what the cache
    stored.  The other queries attend the fresh rows (the last token's
    logits do not depend on them).  f32 softmax; the layer is counted from
    the calls, which ``forward`` makes in layer order.  ``window`` = (wk,
    wv, p0, w): a decode chunk's raw rows (L, kvh, W, d) of this slot, which
    stand for positions p0 .. p0+w-1 (not yet in the pools)."""
    import torch

    from tgq_torch.kernels.causal_attention import causal_attention_plain
    from tgq_torch.serve.kv_cache import gather_pools

    calls = [0]

    def attention(q, k, v, impl="auto"):
        li = calls[0] % cfg.num_layers
        calls[0] += 1
        n, h, d = q.shape[1:]
        kvh = k.shape[2]
        out = causal_attention_plain(q, k, v).float()
        quantized = cache.ks is not None
        kg, vg = gather_pools(cache.k[li], cache.v[li], cache.ks[li] if quantized else None,
                              cache.vs[li] if quantized else None, table_row, kvh,
                              segments=cache.pack_segments)
        if eq is not None:
            kg = kg * torch.as_tensor(eq[0][li], device=kg.device).reshape(kvh, d)
            vg = vg * torch.as_tensor(eq[1][li], device=vg.device).reshape(kvh, d)
        if window is not None and window[3] > 0:  # raw rows: no equalizers
            wk, wv, p0, w = window
            kg[0, p0:p0 + w] = wk[li, :, :w].transpose(0, 1).float()
            vg[0, p0:p0 + w] = wv[li, :, :w].transpose(0, 1).float()
        rows = lambda g, x: torch.cat([g[:, :n - 1], x[:, -1:].float()], dim=1)  # noqa: E731
        kl = rows(kg, k).repeat_interleave(h // kvh, dim=2)
        vl = rows(vg, v).repeat_interleave(h // kvh, dim=2)
        logits = torch.einsum("bhd,bkhd->bhk", q[:, -1].float(), kl) / math.sqrt(d)
        out[:, -1] = torch.einsum("bhk,bkhd->bhd", torch.softmax(logits, dim=-1), vl)
        return out.to(q.dtype)

    return attention


def paged_vs_recompute(params, cfg, dev, steps: int, rel_tol: float, fault=None,
                       ref_attn: str = "auto", kv_bits: int = 16, eq=None,
                       kv_reference: bool = False):
    """Prefill two prompts (100 and 37 tokens), then ``steps`` paged decode
    steps on 2 slots (bf16 KV, or ``kv_bits`` 8 / 4 with the equalizers
    ``eq`` = (k_eq, v_eq) or none; ``kv_reference``: the reference's last
    token attends the rows the cache stored, ``stored_kv_attention``); at
    every step each slot's logits against
    ``forward`` recomputed on the whole sequence with the dequantized dense
    bf16 weights (no K3/K5; ``ref_attn`` "auto" is K6 on CUDA,
    "naive" an f32 softmax).  ``fault`` plants a bug for a control reading:
    "attention" passes K5 a zero current V row (so the current token's
    value is lost, in the output and in the pool), "matmul" zeroes every
    packed matmul's last group of inputs, "equalizers" drops the cache's
    equalizers after prefill (decode neither folds nor divides by them).
    Returns (max |dlogit|
    / max |logit|, max |logit|, greedy agreements, steps whose reference
    top-2 gap exceeds ``rel_tol`` * max |logit|)."""
    import torch

    from tgq_torch.kernels import paged_attention as K5
    from tgq_torch.models import causal_lm as CL
    from tgq_torch.serve.decode import decode_step, fuse_packed_projections, prefill
    from tgq_torch.serve.kv_cache import PagedKVCache, PageTable

    real_attn, real_mm = K5.paged_decode_attention, CL.quantized_matmul
    real_causal = CL.causal_attention

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
    k_eq, v_eq = eq if eq is not None else (None, None)
    cache = PagedKVCache.init(cfg, 2 * mpps + 1, page, kv_bits=kv_bits, k_eq=k_eq, v_eq=v_eq,
                              device=dev)
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
        if fault == "equalizers":
            cache.k_eq = cache.v_eq = None
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
                if kv_reference:
                    CL.causal_attention = stored_kv_attention(cfg, cache, table[s:s + 1], eq)
                try:
                    ref = CL.forward(dense, cfg, torch.tensor([seqs[s]], device=dev),
                                     attn_impl=ref_attn)[0, -1]
                finally:
                    CL.causal_attention = real_causal

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


def decode_chunk_runner(dev, preset: str = "qwen3-8b", slots: int = 8, prompt_len: int = 128,
                        steps: int = 8, layers=None, chunks: int = 7):
    """Phase 7c's decode: ``slots`` prompts of ``prompt_len`` tokens prefilled
    at full width and depth (W4 g128, bf16 KV, dense head, greedy), and a
    function that dispatches the next ``decode_steps`` chunk of ``steps``
    tokens (pages for ``chunks`` chunks) and returns its token block
    without waiting.  Returns (chunk, cfg)."""
    import torch

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
    mpps = -(-(prompt_len + chunks * steps + 1) // page)
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

    return chunk, cfg


def decode_step_profile(dev, preset: str = "qwen3-8b", slots: int = 8, prompt_len: int = 128,
                        steps: int = 8, layers=None, timed_chunks: int = 5) -> dict:
    """``decode_chunk_runner``'s chunks, after a warm-up chunk:
    ``timed_chunks`` timed on the host's clock with the garbage collector
    off (the median chunk's wall per step, and the host's dispatch time per
    step until ``decode_steps`` returns), then one traced by
    ``torch.profiler`` for the device-busy time (the kernels' times summed;
    one stream, so they do not overlap), launches per step and device time
    by kernel class.  The idle share is 1 - busy / the untraced wall (the
    tracer slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    chunk, cfg = decode_chunk_runner(dev, preset, slots, prompt_len, steps, layers,
                                     chunks=timed_chunks + 2)
    chunk().cpu()
    walls, hosts = [], []
    gc.collect()
    gc.disable()  # as timeit does: no collection lands in a timed chunk
    try:
        for _ in range(timed_chunks):
            t0 = time.time()
            toks = chunk()
            hosts.append(time.time() - t0)
            toks.cpu()
            walls.append(time.time() - t0)
    finally:
        gc.enable()
    wall, host = sorted(walls)[timed_chunks // 2], sorted(hosts)[timed_chunks // 2]
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
           "wall_ms_per_step_range": [min(walls) * 1e3 / steps, max(walls) * 1e3 / steps],
           "traced_wall_ms_per_step": traced_wall * 1e3 / steps,
           "device_busy_ms_per_step": busy / steps,
           "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
           "device_launches_per_step": launches / steps,
           "device_ms_per_step_by_class": {k: v / steps for k, v in sorted(
               by_class.items(), key=lambda kv: -kv[1])}}
    return out


def phase7_serving(dev, counts: dict, preset: str = "qwen3-8b", check_layers: int = 4,
                   serve_layers=None, steps: int = 16, serve_args=None) -> list:
    """(a) prefill + ``steps`` decode steps on 2 slots at ``check_layers``
    layers, logits held at every step against full-recompute ``forward``
    on the dequantized dense weights (K6 attention, no K3/K5), beside
    the same with bf16-exact weights and two planted faults that the
    tolerance must catch (``paged_vs_recompute``);
    (b) ``tgq_torch.cli.serve.run`` at all layers with kv_bits 16, 8, and
    4 with a_bits 8 and an 8-bit head, each run's launch counts read;
    (c) one decode chunk traced (``decode_step_profile``).  Returns the
    three metrics dicts, then the profile."""
    import torch

    from tgq_torch.cli.serve import build_parser, run
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.kernels import causal_attention as K6
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
        KD.launches = KD.launches_a8 = K5.launches = K6.launches = 0
        t0 = time.time()
        try:
            res = run(args)
        finally:
            PRESETS[args.model_id] = full
        if dev.type == "cuda":
            torch.cuda.synchronize()
        got = {"dequant_matmul": KD.launches, "a8_matmul": KD.launches_a8,
               "paged_attention": K5.launches, "causal_attention": K6.launches}
        log(f"[phase11c] 7b {' '.join(extra)}: causal_attention launches "
            f"{got['causal_attention']}")
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
        assert got["causal_attention"] > 0 or dev.type != "cuda", got
        if "--a_bits" in extra:
            assert got["a8_matmul"] > 0 and res["config"]["a_bits"] == 8, (got, res["config"])
        results.append(res)
    t0 = time.time()
    prof = decode_step_profile(dev, preset, layers=serve_layers)
    print(json.dumps({"decode_step_profile": prof}), flush=True)
    log(f"[phase7c] {preset} x{prof['layers']} layers, {prof['slots']} slots, bf16 KV: "
        f"{prof['wall_ms_per_step']:.2f} ms/step wall (median chunk; range "
        f"{prof['wall_ms_per_step_range'][0]:.2f}-{prof['wall_ms_per_step_range'][1]:.2f}), host dispatch "
        f"{prof['host_ms_per_step']:.2f} ms/step (traced: {prof['traced_wall_ms_per_step']:.2f} "
        f"ms/step wall), device busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms/step, idle share {prof['idle_share']}, "
        f"{prof['device_launches_per_step']:.0f} device launches/step ({time.time()-t0:.1f} s)")
    return results + [prof]


# ------------------------------------------- families and checkpoints (8)

# rel_error over RTN's for a module whose pchol rank is below half its input
# width: the card read at most 1.006 at eps 1e-6 (PERF.md section 2)
LOW_RANK_RTN_CAP = 1.05

def write_hf_model(path: str, preset: str, dev, n_files: int = 1, layers=None):
    """A checkpoint in the published HF layout of ``preset`` (cut to
    ``layers`` when given) with random bf16 weights (seed 0), written by
    the port's safetensors writer; GPT-2 gets its f32 causal-mask buffers
    too.  ``n_files`` > 1 splits it into that many shards with an index.
    Returns (cfg, bytes, seconds of the flatten and the write)."""
    import torch

    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params
    from tgq_torch.models.hf_export import _gpt2_state_dict, _opt_state_dict, hf_config_dict
    from tgq_torch.models.safetensors_io import save_checkpoint

    cfg = PRESETS[preset]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
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


@contextlib.contextmanager
def pchol_resweeps():
    """The widths of the Hessians whose pchol factor build escalated to a
    second sweep (``tgq_torch.solver.pchol.pchol_factor``'s warning: a
    non-finite build at pivot_rtol < 1e-3 sweeps again at 1e-3), read from
    the solver's log while the block runs."""
    import logging

    widths: list[int] = []

    class Escalations(logging.Handler):
        def emit(self, record):
            if "escalating" in record.msg and record.args[3] < 1e-3:
                widths.append(int(record.args[1]))

    handler = Escalations(level=logging.WARNING)
    log_ = logging.getLogger("tgq_torch.solver.pchol")
    log_.addHandler(handler)
    try:
        yield widths
    finally:
        log_.removeHandler(handler)


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
    with pchol_resweeps() as resweeps:
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
    # one sweep a group, and one more for each build pchol_factor escalates
    # (a non-finite factor at pivot_rtol < 1e-3 re-sweeps the same Hessian)
    want_k1 = cfg.num_layers * sum(-(-w // 128) for w in widths) + \
        sum(-(-w // 128) for w in resweeps)
    want_k2 = cfg.num_layers * sum(-(-w // 256) for w in mod_widths)
    log(f"[phase8] {preset}: CLI quantize {cli_s:.1f} s under the trace (pipeline "
        f"{metrics['total_time']:.1f} s, {metrics['total_time'] / cfg.num_layers:.3f} s/layer"
        f"); phases {json.dumps(per_layer)}")
    log(f"[phase8] {preset}: launches pchol_panel {k1_n} (from the shapes {want_k1}, with "
        f"{len(resweeps)} escalated builds re-swept at widths {resweeps}), gptq_block {k2_n} "
        f"(from the shapes {want_k2})")
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


# ------------------------------ slice 7: equalizers, soak, harnesses (9)

KERNEL_COUNTERS = (("pchol_panel", "pchol_panel", "launches"),
                   ("gptq_block", "gptq_block", "launches"),
                   ("dequant_matmul", "dequant_matmul", "launches"),
                   ("a8_matmul", "dequant_matmul", "launches_a8"),
                   ("paged_attention", "paged_attention", "launches"),
                   ("causal_attention", "causal_attention", "launches"),
                   ("causal_attention_bwd", "causal_attention_bwd", "launches"))


@contextlib.contextmanager
def counted(counts: dict, label: str, expect=()):
    """Drive one main path with every launch counter set to 0 just before
    it; just after, read them into the yielded dict, add them to
    ``counts`` and require each kernel in ``expect`` to have launched
    (on CUDA: the wrappers count launches of the kernels only)."""
    import importlib

    import torch

    mods = {name: importlib.import_module(f"tgq_torch.kernels.{mod}")
            for name, mod, _ in KERNEL_COUNTERS}
    for name, _, attr in KERNEL_COUNTERS:
        setattr(mods[name], attr, 0)
    got: dict[str, int] = {}
    yield got
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for name, _, attr in KERNEL_COUNTERS:
        got[name] = getattr(mods[name], attr)
        counts[name] = counts.get(name, 0) + got[name]
    log(f"[launches] {label}: {got}")
    if torch.cuda.is_available():
        assert all(got[k] > 0 for k in expect), (label, got, expect)


def quiet(fn, *args, **kw):
    """``fn``'s result with its standard output kept out of the log (the
    table runners print their tables; the phase prints what it checks)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def phase9a_equalized_decode(dev, counts: dict, preset: str, check_layers: int, steps: int,
                             group_size: int = 128):
    """Equalizers from ``estimate_kv_equalizers`` on 256 seeded tokens (the
    serving CLI's), then paged decode at kv_bits 8 and 4 with and without
    them against full-recompute ``forward`` under phase 7a's limit."""
    import numpy as np

    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models import PRESETS
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.serve.kv_calibrate import estimate_kv_equalizers

    cfg = dataclasses.replace(PRESETS[preset], num_layers=check_layers)
    params = init_packed_params(cfg, QuantSpec(bits=4, group_size=group_size), seed=0, device=dev)
    rel_tol = 0.03  # phase 7a's
    calib = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 256))
    t0 = time.time()
    with counted(counts, "9a equalizer calibration (K3 at t = 256)", ("dequant_matmul",)):
        k_eq, v_eq = estimate_kv_equalizers(params, cfg, calib)
    eq_s = time.time() - t0
    for li in range(check_layers):
        log(f"[phase9a] layer {li} equalizers: k_eq {k_eq[li].min():.4f}-{k_eq[li].max():.4f}, "
            f"v_eq {v_eq[li].min():.4f}-{v_eq[li].max():.4f}")
    assert all(np.isfinite(e).all() and (e > 0).all() for e in (k_eq, v_eq))
    assert k_eq.max() - k_eq.min() > 1e-3 and v_eq.max() - v_eq.min() > 1e-3  # not all ones
    readings = {}
    for kv_bits in (8, 4):
        for label, eq in (("equalized", (k_eq, v_eq)), ("no equalizers", None)):
            for ref in ("unquantized", "as stored"):
                with counted(counts, f"9a kv{kv_bits} {label}, {ref} reference",
                             ("dequant_matmul", "paged_attention")):
                    readings[(kv_bits, label, ref)] = r = paged_vs_recompute(
                        params, cfg, dev, steps, rel_tol, kv_bits=kv_bits, eq=eq,
                        kv_reference=ref == "as stored")
                log(f"[phase9a] kv{kv_bits} {label} vs the {ref} reference: max|dlogit| / "
                    f"max|logit| {r[0]:.4g} (max|logit| {r[1]:.2f}); greedy agrees on "
                    f"{r[2]}/{r[3]} steps whose reference top-2 gap exceeds the tolerance")
    for kv_bits in (8, 4):  # a control: the limit catches decode without the equalizers
        with counted(counts, f"9a kv{kv_bits} fault control", ("paged_attention",)):
            readings[(kv_bits, "fault: decode drops the equalizers", "as stored")] = r = \
                paged_vs_recompute(params, cfg, dev, steps, rel_tol, fault="equalizers",
                                   kv_bits=kv_bits, eq=(k_eq, v_eq), kv_reference=True)
        log(f"[phase9a] kv{kv_bits} fault: decode drops the equalizers, vs the as stored "
            f"reference: max|dlogit| / max|logit| {r[0]:.4g}")
        assert r[0] > rel_tol, r
    # phase 7a's limit: the equalized int8 cache against the unquantized
    # model, and both equalized caches against the model whose last token
    # attends what the cache stored (int4's own error is far above it)
    held = [(8, "equalized", "unquantized"), (8, "equalized", "as stored"),
            (4, "equalized", "as stored")]
    for key in held:
        rel, _, agree, decided = readings[key]
        assert rel <= rel_tol and agree == decided, (key, readings[key])
    r = {k: v[0] for k, v in readings.items()}
    log(f"[phase9a] {cfg.name} x{check_layers} layers W4 g128, 2 slots, prefill + {steps} decode "
        f"steps, equalized kv8 vs the unquantized model {r[(8, 'equalized', 'unquantized')]:.4f} "
        f"(without equalizers {r[(8, 'no equalizers', 'unquantized')]:.4f}); equalized kv8 / kv4 "
        f"vs the model attending the stored rows {r[(8, 'equalized', 'as stored')]:.4f} / "
        f"{r[(4, 'equalized', 'as stored')]:.4f} (without equalizers "
        f"{r[(8, 'no equalizers', 'as stored')]:.4f} / {r[(4, 'no equalizers', 'as stored')]:.4f})"
        f", tolerance {rel_tol}; kv4 vs the unquantized model {r[(4, 'equalized', 'unquantized')]:.4f}"
        f" (without equalizers {r[(4, 'no equalizers', 'unquantized')]:.4f}: int4's own error, "
        f"not held); calibration {eq_s:.2f} s; {card_line()}")
    del params


def phase9b_serve(dev, counts: dict, preset: str, serve_layers=None, serve_args=None):
    """``tgq_torch.cli.serve.run`` with ``--kv_equalize`` and the native
    allocator at kv8 and at kv4 + A8 + an 8-bit head."""
    from tgq_torch.cli.serve import build_parser, run
    from tgq_torch.models import PRESETS

    base = serve_args or ["--model_id", preset, "--w_bits", "4", "--group_size", "128",
                          "--n_requests", "16", "--prompt_len", "128", "--gen_tokens", "64",
                          "--max_slots", "8", "--page_size", "64", "--decode_chunk", "8"]
    for extra, expect in ((["--kv_bits", "8"], ("dequant_matmul", "paged_attention")),
                          (["--kv_bits", "4", "--a_bits", "8", "--lm_head_bits", "8"],
                           ("dequant_matmul", "a8_matmul", "paged_attention"))):
        args = build_parser().parse_args(base + extra + ["--kv_equalize", "--page_alloc",
                                                         "native", "--device", dev.type])
        full = PRESETS[args.model_id]
        if serve_layers is not None:  # a cut depth, for rehearsals
            PRESETS[args.model_id] = dataclasses.replace(full, num_layers=serve_layers)
        t0 = time.time()
        try:
            with counted(counts, f"9b serve {' '.join(extra)} --kv_equalize", expect):
                res = run(args)
        finally:
            PRESETS[args.model_id] = full
        print(json.dumps(res), flush=True)
        c = res["config"]
        log(f"[phase9b] {' '.join(extra)} --kv_equalize: {res['value']} tok/s, decode-only "
            f"{res['decode_only_tok_s']} tok/s, TTFT p50/p90/p99 {res['ttft_p50_s']}/"
            f"{res['ttft_p90_s']}/{res['ttft_p99_s']} s, calibration {c['kv_equalize_s']:.2f} s, "
            f"page allocator {c['page_alloc']} ({time.time() - t0:.1f} s with set-up); "
            f"{card_line()}")
        assert c["page_alloc"] == "native" and c["kv_equalizers"] == "calibrated", c
        n_req, gen_tok = args.n_requests, args.gen_tokens
        assert res["total_tokens"] == n_req * gen_tok, res
        if args.a_bits == 8:
            assert c["a_bits"] == 8, c


def phase9c_soak(dev, counts: dict, soak_args) -> dict:
    """``python -m tgq_torch.cli.serve_soak`` (its ``run``, in this process
    so that the launch counters are read) with the native allocator."""
    from tgq_torch.cli import serve_soak

    args = serve_soak.build_parser().parse_args(soak_args + ["--device", dev.type,
                                                             "--page_alloc", "native"])
    t0 = time.time()
    with counted(counts, "9c soak", ("dequant_matmul", "a8_matmul", "paged_attention")):
        res = serve_soak.run(args)
    print(json.dumps(res), flush=True)
    log(f"[phase9c] soak: {res['done']}/{res['n_requests']} requests done, {res['tokens']} "
        f"tokens in {res['wall_s']} s ({res['tok_s']} tok/s), {res['ended_by_eos']} ended by "
        f"EOS, outside budget {res['bad']}, free pages {res['free_pages']} of "
        f"{res['free_pages_start']} at the start, allocator {res['page_alloc']} "
        f"({time.time() - t0:.1f} s with set-up); {card_line()}")
    assert res["ok"] and not res["bad"] and res["page_alloc"] == "native", res
    return res


def k34_reference_ms(dev, name: str, n_out: int, n_in: int, t: int, a8: bool) -> float:
    """Phase 5's timing of K3 (or K4 alone) at one shape, for a phase-9 run
    without phase 5 (the same weights' maker, launch and timer)."""
    import torch

    from tgq_torch.kernels import dequant_matmul as KD

    gen = torch.Generator(device=dev).manual_seed(5)
    w = random_packed(n_out, n_in, 4, gen, dev)
    x = torch.randn((t, n_in), generator=gen, device=dev).to(torch.bfloat16)
    before = (KD.launches, KD.launches_a8)
    if a8:
        w8 = dataclasses.replace(w, act_bits=8)
        x8, a = KD.quantize_activations(x)
        ms = cuda_ms(lambda: KD.a8_matmul(x8, a, w8, out_dtype=torch.bfloat16), reps=20)
    else:
        ms = cuda_ms(lambda: KD.quantized_matmul(x, w), reps=20)
    KD.launches, KD.launches_a8 = before
    return ms


def phase9d_timing_clis(dev, counts: dict, k34: dict, prof7c, preset: str,
                        decode_layers=None, gptq_shapes=None, group_size: int = 128,
                        ref_tol: float = 0.25):
    """kernel_bench (t = 16, t = 8, t = 8 with A8), decode_bench at its
    defaults and at phase 7c's shape, gptq_kernel_bench at the Qwen3-8B
    module shapes; the t = 8 readings against phase 5's, decode_bench's
    whole step against phase 7c's chunk timed between its chunks."""
    from tgq_torch.cli import decode_bench, gptq_kernel_bench, kernel_bench
    from tgq_torch.models import PRESETS

    on_card = dev.type == "cuda"
    kb = {}
    for extra, expect in ((["--tokens", "16"], ("dequant_matmul",)),
                          (["--tokens", "8"], ("dequant_matmul",)),
                          (["--tokens", "8", "--a_bits", "8"], ("a8_matmul",))):
        argv = ["--model_id", preset, "--w_bits", "4", "--group_size", str(group_size),
                "--device", dev.type] + extra
        with counted(counts, f"9d kernel_bench {' '.join(extra)}", expect):
            res = quiet(kernel_bench.run, kernel_bench.build_parser().parse_args(argv))
        kb[" ".join(extra)] = res
        print(json.dumps(res), flush=True)
        for r in res["shapes"]:
            log(f"[phase9d] kernel_bench {' '.join(extra)}: {r['shape']} {r['ms']:.4f} ms, "
                f"{r['weight_GB_s']} GB/s, {r['frac_peak']:.3f} of the HBM peak")
        assert res["value"] is not None and len(res["shapes"]) == 4, res
        assert all(r["frac_peak"] <= 1.0 for r in res["shapes"]), res["shapes"]
    # the t = 8 readings against phase 5's of the same launches
    cfg = PRESETS[preset]
    for kernel, key in (("K3", "--tokens 8"), ("K4", "--tokens 8 --a_bits 8")):
        for shape_name, p5_name, n_out, n_in in (
                ("o_proj", "o", cfg.hidden_size, cfg.q_size),
                ("down_proj", "down", cfg.hidden_size, cfg.intermediate_size)):
            row = next(r for r in kb[key]["shapes"] if r["shape"].startswith(shape_name + " "))
            ref = k34.get((kernel, p5_name, 4, 8))
            src = "phase 5"
            if ref is None and on_card:
                ref, src = k34_reference_ms(dev, p5_name, n_out, n_in, 8, kernel == "K4"), \
                    "phase 5's timing, rerun"
            if ref is None:
                continue
            log(f"[phase9d] {kernel} {shape_name} t=8: kernel_bench {row['ms']:.4f} ms, {src} "
                f"{ref:.4f} ms ({row['ms'] / ref - 1:+.1%})")
            assert abs(row["ms"] / ref - 1) <= ref_tol, (kernel, shape_name, row["ms"], ref)

    full = PRESETS[preset]
    if decode_layers is not None:  # a cut depth, for rehearsals
        PRESETS[preset] = dataclasses.replace(full, num_layers=decode_layers)
    try:
        runs = {}
        for label, extra in (("defaults", []),
                             ("phase 7c's shape", ["--slots", "8", "--kv_bits", "16",
                                                   "--lm_head_bits", "16", "--context", "160"])):
            argv = ["--model_id", preset, "--group_size", str(group_size),
                    "--device", dev.type] + extra
            between, walls7c = None, []
            if extra:
                # phase 7c's chunk, timed after each of decode_bench's chunks:
                # the host's speed drifts by 30 % and more between windows of
                # seconds, so the two are held in the same window
                chunk7c, _ = decode_chunk_runner(dev, preset, layers=decode_layers)
                chunk7c().cpu()

                def between(chunk7c=chunk7c, walls7c=walls7c):
                    t0 = time.time()
                    chunk7c().cpu()
                    walls7c.append((time.time() - t0) * 1e3 / 8)

            with counted(counts, f"9d decode_bench {label}", ("dequant_matmul", "paged_attention")):
                res = quiet(decode_bench.run, decode_bench.build_parser().parse_args(argv),
                            between=between)
            runs[label] = (res, sorted(walls7c))
            print(json.dumps(res), flush=True)
            comp = res["components"]
            parts = sum(v for k, v in comp.items() if k != "composed_ms")
            log(f"[phase9d] decode_bench {label} ({res['config']['slots']} slots x "
                f"{res['config']['context']}, kv{res['config']['kv_bits']}, head "
                f"{res['config']['lm_head_bits']}-bit, {res['config']['layers']} layers): "
                + ", ".join(f"{k} {v:.3f}" for k, v in comp.items())
                + f"; sum of the parts {parts:.3f} ms beside the whole step "
                f"{comp['composed_ms']:.3f} ms (the gap is the host's dispatch); {card_line()}")
    finally:
        PRESETS[preset] = full
    res, walls7c = runs["phase 7c's shape"]
    whole, wall = res["components"]["composed_ms"], walls7c[len(walls7c) // 2]
    log(f"[phase9d] decode_bench whole step at phase 7c's shape {whole:.2f} ms vs phase 7c's "
        f"chunk interleaved with it {wall:.2f} ms ({whole / wall - 1:+.1%}; 7c's chunks "
        f"{walls7c[0]:.2f}-{walls7c[-1]:.2f} ms; phase 7c read "
        + (f"{prof7c['wall_ms_per_step']:.2f} ms" if prof7c else "nothing: phase 7 did not run")
        + ")")
    assert abs(whole / wall - 1) <= ref_tol, (whole, walls7c)

    argv = ["--w_bits", "4", "--group_size", str(group_size), "--block_size", "256",
            "--device", dev.type]
    if gptq_shapes:
        argv += ["--shapes", gptq_shapes]
    with counted(counts, "9d gptq_kernel_bench", ("gptq_block",)):
        res = quiet(gptq_kernel_bench.run, gptq_kernel_bench.build_parser().parse_args(argv))
    print(json.dumps(res), flush=True)
    for shape, plain_s in res["results"]["plain"].items():
        kernel_s = res["results"].get("kernel", {}).get(shape)
        log(f"[phase9d] gptq_kernel_bench {shape} (block 256): plain {plain_s:.4f} s, kernel "
            f"{kernel_s} s, codes bit-equal {res.get('codes_bit_equal', {}).get(shape)}")
        if on_card:
            assert kernel_s < plain_s and res["codes_bit_equal"][shape], (shape, res)


def phase9e_tables(dev, counts: dict, tmp: str, model: str, n_samples: int, group_size: int):
    """The table runners on GPT-2 from an HF checkpoint written as phase 8
    writes it: run_benchmark (11 rows), run_baseline (2), run_experiments
    at W4 on two ε, and extract_log over the run_benchmark output."""
    import csv

    from tgq_torch.cli import extract_log, run_baseline, run_benchmark, run_experiments

    src = os.path.join(tmp, model)
    cfg, nbytes, _ = write_hf_model(src, model, dev)
    common = ["--model_id", src, "--dataset", "synthetic", "--n_samples", str(n_samples),
              "--seq_len", str(cfg.seqlen), "--group_size", str(group_size),
              "--device", dev.type]
    t0 = time.time()
    out = os.path.join(tmp, "bench")
    with counted(counts, "9e run_benchmark", ("pchol_panel", "gptq_block")):
        rows = quiet(run_benchmark.run, common + ["--solver", "pchol", "--out", out])
    bench_s = time.time() - t0
    for r in rows:
        log(f"[phase9e] run_benchmark {r['name']:14s} {r['status']:4s} PPL {r['ppl']} "
            f"({r['time_s']} s)")
    assert [r["name"] for r in rows] == [e["name"] for e in run_benchmark.experiment_list("pchol")]
    assert all(r["status"] == "OK" for r in rows), [r["status"] for r in rows]
    ppl = {r["name"]: r["ppl"] for r in rows}
    for name in ("Trunc_W4_Asym", "GPTQ_W4_Asym"):
        assert math.isfinite(ppl[name]) and abs(ppl[name] / ppl["FP16_Baseline"] - 1) <= 0.05, (
            name, ppl[name], ppl["FP16_Baseline"])
    t0 = time.time()
    with counted(counts, "9e run_baseline", ("gptq_block",)):
        base_rows = quiet(run_baseline.run, common + ["--out", os.path.join(tmp, "base")])
    base_s = time.time() - t0
    log(f"[phase9e] run_baseline: " + ", ".join(
        f"{r['name']} {r['status']} PPL {r['ppl']}" for r in base_rows))
    assert [r["status"] for r in base_rows] == ["OK", "OK"], base_rows
    t0 = time.time()
    with counted(counts, "9e run_experiments", ("pchol_panel", "gptq_block")):
        grid = quiet(run_experiments.run, common + [
            "--solver", "pchol", "--eps_grid", "1e-6,1e-2", "--bits", "4",
            "--out", os.path.join(tmp, "grid")])
    grid_s = time.time() - t0
    log(f"[phase9e] run_experiments: " + ", ".join(
        f"{r['name']} {r['status']} PPL {r['ppl']}" for r in grid))
    assert len(grid) == 4 and all(r["status"] == "OK" for r in grid), grid
    summary = os.path.join(tmp, "summary.csv")
    quiet(extract_log.main, [out, "--out", summary])
    mods = sorted({r["module"] for r in csv.DictReader(open(summary))})
    want = sorted({name.split(".")[-1] for name in ("attn.c_attn", "attn.c_proj", "mlp.c_fc",
                                                    "mlp.c_proj")})
    log(f"[phase9e] extract_log over run_benchmark: module types {mods}")
    assert mods == want, (mods, want)
    log(f"[phase9e] {cfg.name} ({cfg.num_layers} layers, {nbytes / 1e9:.3f} GB checkpoint): "
        f"run_benchmark {bench_s:.1f} s, run_baseline {base_s:.1f} s, run_experiments "
        f"{grid_s:.1f} s; PPL FP {ppl['FP16_Baseline']:.4f}, Trunc_W4_Asym "
        f"{ppl['Trunc_W4_Asym']:.4f} ({ppl['Trunc_W4_Asym'] / ppl['FP16_Baseline'] - 1:+.3%}), "
        f"GPTQ_W4_Asym {ppl['GPTQ_W4_Asym']:.4f} "
        f"({ppl['GPTQ_W4_Asym'] / ppl['FP16_Baseline'] - 1:+.3%}); {card_line()}")


def phase9f_kv_quality(dev, contexts=(128, 512, 2048, 8192)):
    from tgq_torch.cli.kv_quality import run

    rows = run(list(contexts), device=dev.type)
    err = {(r["format"], r["context"]): r["rel_err"] for r in rows}
    for r in rows:
        print(json.dumps(r), flush=True)
    for n in contexts:
        log(f"[phase9f] kv_quality context {n}: int8 {err[('int8', n)]:.6f} -> +eq "
            f"{err[('int8+eq', n)]:.6f}, int4 {err[('int4', n)]:.6f} -> +eq "
            f"{err[('int4+eq', n)]:.6f}")
        assert err[("int8+eq", n)] < err[("int8", n)] and err[("int4+eq", n)] < err[("int4", n)]


def phase9g_synthetic(dev, counts: dict, extra=()):
    from tgq_torch.cli import synthetic_bench

    args = synthetic_bench.build_parser().parse_args(["--device", dev.type, *extra])
    t0 = time.time()
    with counted(counts, "9g synthetic_bench", ("pchol_panel", "gptq_block")):
        rows = quiet(synthetic_bench.run, args)
    secs = time.time() - t0
    rtn = {(r["dist"], r["bits"]): r["rel_output_error"] for r in rows if r["method"] == "rtn"}
    for r in rows:
        if r["bits"] == 4:
            log(f"[phase9g] {r['dist']:10s} W4 {r['method']:6s} rank {r['rank']:4d} rel_err "
                f"{r['rel_output_error']:.6f}")
    for r in rows:
        if r["method"] in ("pchol", "eigh") and r["bits"] == 4:
            assert math.isfinite(r["rel_output_error"]), r
            assert r["rel_output_error"] <= rtn[(r["dist"], 4)], r
    log(f"[phase9g] synthetic_bench ({args.n_tokens} tokens x {args.n_features} features, "
        f"{len(rows)} rows): {secs:.1f} s")


def phase9_slice7(dev, counts: dict, k34=None, prof7c=None, preset: str = "qwen3-8b",
                  check_layers: int = 4, steps: int = 16, serve_layers=None, serve_args=None,
                  soak_args=("--n_requests", "512"), decode_layers=None, gptq_shapes=None,
                  serve_group: int = 128, table_model: str = "gpt2", table_samples: int = 32,
                  table_group: int = 128, kvq_contexts=(128, 512, 2048, 8192),
                  synthetic_args=()) -> None:
    """Phase 9 (see the module docstring); the keyword arguments cut sizes
    for a rehearsal on the CPU."""
    t_phase = time.time()
    marks = {}

    def mark(step):
        marks[step] = round(time.time() - t_phase - sum(marks.values()), 1)

    phase9a_equalized_decode(dev, counts, preset, check_layers, steps, serve_group)
    mark("a")
    phase9b_serve(dev, counts, preset, serve_layers, serve_args)
    mark("b")
    phase9c_soak(dev, counts, list(soak_args))
    mark("c")
    phase9d_timing_clis(dev, counts, k34 or {}, prof7c, preset, decode_layers, gptq_shapes,
                        serve_group)
    mark("d")
    with tempfile.TemporaryDirectory() as tmp:
        phase9e_tables(dev, counts, tmp, table_model, table_samples, table_group)
    mark("e")
    phase9f_kv_quality(dev, kvq_contexts)
    mark("f")
    phase9g_synthetic(dev, counts, synthetic_args)
    mark("g")
    log(f"[phase9] equalizers, soak and harnesses: {time.time() - t_phase:.1f} s (by step "
        f"{marks}); {card_line()}")


# ------------------------------- slice 8: tensor and data parallelism (10)

def phase10a_window(dev, k5: dict, time_it=None, slots: int = 8, W: int = 8, H: int = 16,
                    kvh: int = 4, d: int = 128, max_len: int = 2048) -> None:
    """K5's chunk-window mode (``w_live``, ``return_stats``) against its plain
    version at the rank-local shape of Qwen3-8B under TP 2 (16 q / 4 kv heads,
    d 128): bf16 / int8 / int4 pools, w_live 0, 1, W-1 and W, stats on and
    off, an idle slot, lengths across the split boundaries and lengths whose
    pool range is empty (len <= w_live + 1).  m and l within rtol = atol =
    1e-5, o too after both sides are divided by the plain version's l (the
    un-normalised sum grows with the context); two launches bit-identical.
    Then K5's partials merged with ``_window_partial`` against non-window K5
    over the same tokens (bf16 pools; the window rows' values set to zero in
    both, so the window's bf16 rounding of its probabilities, the JAX
    package's, drops out): within 1e-5.  Timed beside non-window K5."""
    import torch

    from tgq_torch.kernels import paged_attention as K5
    from tgq_torch.serve.decode import _merge_partials, _window_partial

    time_it = time_it or cuda_ms
    gen = torch.Generator(device=dev).manual_seed(10)
    li, page = 1, 64
    mpps = -(-max_len // page)
    splits = K5._k5_plan(slots, kvh, mpps, page).splits
    worst = worst_l = 0.0   # max |d| of o (normalised) and m; max relative |d| of l
    for kv_bits in (16, 8, 4):
        for w_live in (0, 1, W - 1, W):
            lengths = [0, 1, w_live + 1, 32 * splits + w_live + 2, max_len, 65 + w_live,
                       33 + w_live, 2 + w_live][:slots]
            q, k, v, ks, vs, lens, table, kc, vc = attention_case(
                dev, gen, slots, kv_bits, lengths, H=H, kvh=kvh, d=d, mpps=mpps)
            pools = [None if t is None else t[li] for t in (k, v, ks, vs)]
            for stats in (True, False):
                kw = dict(num_kv_heads=kvh, w_live=w_live, return_stats=stats)
                before = K5.launches
                got = K5.paged_decode_attention(q, *pools, lens, table, kc, vc, **kw)
                again = K5.paged_decode_attention(q, *pools, lens, table, kc, vc, **kw)
                K5.launches = before
                ref = K5.paged_decode_attention_plain(q, *pools, lens, table, kc, vc, **kw)
                got, again, ref = ((t,) if not stats else t for t in (got, again, ref))
                assert all(torch.equal(a, b) for a, b in zip(got, again)), (kv_bits, w_live)
                if stats:
                    scale = ref[2].clamp(min=1.0)
                    pairs = ((got[0] / scale, ref[0] / scale), (got[1], ref[1]))
                    idle = lens == 0
                    assert bool((got[0][idle] == 0).all() and (got[2][idle] == 0).all()
                                and (got[1][idle] == K5.DEFAULT_MASK_VALUE).all())
                    assert torch.allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)
                    worst_l = max(worst_l, float(((got[2] - ref[2]).abs() / scale).max()))
                else:
                    pairs = ((got[0], ref[0]),)
                for a, b in pairs:
                    err = float((a - b).abs().max())
                    worst = max(worst, err)
                    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), (kv_bits, w_live,
                                                                        stats, err)
        log(f"[phase10a] K5 window mode kv{kv_bits}, w_live 0/1/{W - 1}/{W}, stats on and "
            f"off: within 1e-5 of the plain version (so far max|d| of o and m {worst:.3e}, "
            f"of l relative {worst_l:.3e}), two launches bit-identical")
    # partials + window == non-window K5 over the same tokens (bf16 pools)
    lengths = [0] + [W + 2 + 37 * i for i in range(slots - 1)]
    q, k, v, ks, vs, lens, table, kc, vc = attention_case(
        dev, gen, slots, 16, lengths, H=H, kvh=kvh, d=d, mpps=mpps)
    q = q.to(torch.bfloat16).float()   # the window attends a bf16 query
    kp, vp = k[li], v[li]
    wk = torch.zeros((1, slots, kvh, W, d), dtype=torch.bfloat16, device=dev)
    wv = torch.zeros_like(wk)
    for s_, n in enumerate(lengths):
        for j in range(W if n else 0):
            t = n - 1 - W + j
            pg, off = int(table[s_, t // page]), t % page
            wk[0, s_, :, j] = kp[pg, off].reshape(kvh, d)
            vp[pg, off] = 0   # the window's rows carry zero values in both paths
    full = K5.paged_decode_attention(q, kp, vp, None, None, lens, table, kc, vc,
                                     num_kv_heads=kvh)
    part = K5.paged_decode_attention(q, kp, vp, None, None, lens, table, kc, vc,
                                     num_kv_heads=kvh, w_live=W, return_stats=True)
    merged = _merge_partials(part, _window_partial(q, (wk, wv), 0, W, kvh))
    busy = lens > 0
    merge_err = float((merged[busy] - full[busy]).abs().max())
    assert torch.allclose(merged[busy], full[busy], rtol=1e-5, atol=1e-5), merge_err
    # time window K5 beside non-window K5 at the serving geometry (8 x 192)
    lengths = [192] * slots
    q, k, v, ks, vs, lens, table, kc, vc = attention_case(
        dev, gen, slots, 16, lengths, H=H, kvh=kvh, d=d, mpps=4)
    kp, vp = k[li], v[li]
    before = K5.launches
    win_ms = time_it(lambda: K5.paged_decode_attention(
        q, kp, vp, None, None, lens, table, kc, vc, num_kv_heads=kvh, w_live=W - 1,
        return_stats=True), reps=50)
    full_ms = time_it(lambda: K5.paged_decode_attention(
        q, kp, vp, None, None, lens, table, kc, vc, num_kv_heads=kvh), reps=50)
    K5.launches = before
    plain_ms = time_it(lambda: K5.paged_decode_attention_plain(
        q, kp, vp, None, None, lens, table, kc, vc, num_kv_heads=kvh, w_live=W - 1,
        return_stats=True), reps=3)
    wq = torch.zeros((1, slots, kvh, W, d), dtype=torch.bfloat16, device=dev)
    part_ms = time_it(lambda: _window_partial(q, (wq, wq), 0, W - 1, kvh), reps=20)
    toks = [n - W for n in lengths]  # pool rows read: len - 1 - w_live
    b_ms, b_by = bound_ms(attention_bytes(16, [t + 1 for t in toks], slots, H, kvh, d)
                          + 8 * slots * H, 4.0 * H * d * sum(toks))
    log(f"[phase10a] K5 window partials + _window_partial vs non-window K5 (bf16): max|d| "
        f"{merge_err:.3e}; 8 slots x 192, 16/4 heads: window K5 {win_ms * 1e3:.1f} us/launch "
        f"(w_live {W - 1}, stats), non-window K5 {full_ms * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}), plain {plain_ms * 1e3:.1f} us, _window_partial "
        f"{part_ms * 1e3:.1f} us; {card_line()}")
    k5.update(window_ms=win_ms, window_nonwindow_ms=full_ms, window_plain_ms=plain_ms,
              window_bound_ms=b_ms, window_max_abs_err=max(worst, merge_err),
              window_partial_ms=part_ms)


def gather_dim(x, mesh, dim: int):
    """The model ranks' ``x`` concatenated along ``dim``."""
    from tgq_torch.parallel.mesh import all_gather_last

    return all_gather_last(x.movedim(dim, -1).contiguous(), mesh, "model").movedim(-1, dim)


def rank_device():
    """A spawned rank's device: its card (``init_distributed`` set it), or
    the CPU in a rehearsal."""
    import torch

    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def tp_decode_rank(preset: str, layers: int, kv_list, chunk: int, n_chunks: int,
                   group_size: int = 128) -> dict:
    """One of 2 ranks of phase 10b: the packed model's TP shards, prefill of
    two prompts (100 and 37 tokens), then ``n_chunks`` decode chunks of
    ``chunk`` steps in chunk-window mode, each step's logits held on rank 0
    against full-recompute ``forward`` (``paged_vs_recompute``'s reference:
    the dequantized dense weights, K6; for int4 KV the last token attends
    the rows the ranks' caches and windows hold, ``stored_kv_attention``)."""
    import torch

    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.kernels import causal_attention as K6
    from tgq_torch.kernels import dequant_matmul as KD
    from tgq_torch.kernels import paged_attention as K5
    from tgq_torch.models import PRESETS
    from tgq_torch.models import causal_lm as CL
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.parallel import local_config, make_mesh, mark_tp_kinds, serving_mesh_scope
    from tgq_torch.parallel import shard_params
    from tgq_torch.serve.decode import _decode_core, fuse_packed_projections, prefill
    from tgq_torch.serve.kv_cache import PagedKVCache, PageTable, window_flush, window_init

    dev = rank_device()
    mesh = make_mesh(data=1, model=2)
    cfg = dataclasses.replace(PRESETS[preset], num_layers=layers)
    params = init_packed_params(cfg, QuantSpec(bits=4, group_size=group_size), seed=0,
                                device=dev)
    local = fuse_packed_projections(shard_params(mark_tp_kinds(params), mesh))
    run_cfg = local_config(cfg, mesh)
    dense = dense_reference(params) if mesh.model_rank == 0 else None
    del params
    rel_tol, page, mpps = 0.03, 64, 4
    real_causal = CL.causal_attention
    out = {}
    for kv_bits in kv_list:
        KD.launches = KD.launches_a8 = K5.launches = K6.launches = 0
        t0 = time.time()
        gen = torch.Generator(device="cpu").manual_seed(7)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
                   for n in (100, 37)]
        cache = PagedKVCache.init(run_cfg, 2 * mpps + 1, page, kv_bits=kv_bits, device=dev)
        pt = PageTable(2 * mpps + 1, page, 2, mpps, backend="python")
        seqs, toks = [], []
        with serving_mesh_scope(mesh):
            for s_, p in enumerate(prompts):
                pages = pt.alloc_slot(s_, len(p))
                ids = torch.zeros((1, len(pages) * page), dtype=torch.long, device=dev)
                ids[0, :len(p)] = torch.tensor(p, device=dev)
                logits, cache = prefill(local, cache, run_cfg, torch.tensor(pages, device=dev),
                                        ids, len(p))
                seqs.append(list(p))
                toks.append(int(logits.argmax()))
        live = torch.ones(2, dtype=torch.int32, device=dev)
        worst, agree, decided, all_toks = 0.0, 0, 0, []
        for _ in range(n_chunks):
            lens0 = [len(sq) + 1 for sq in seqs]
            for s_ in range(2):
                pt.extend(s_, chunk)
            table, _ = pt.device_tables(dev)
            lens = torch.tensor(lens0, dtype=torch.int32, device=dev)
            pos0 = lens - 1
            win = window_init(cache, 2, chunk)
            for i in range(chunk):
                for s_ in range(2):
                    seqs[s_].append(toks[s_])
                tokens = torch.tensor(toks, dtype=torch.int32, device=dev)
                with serving_mesh_scope(mesh):
                    logits = _decode_core(local, cache, run_cfg, table, lens, tokens, lens - 1,
                                          live, win=win, w_live=i)
                full = None
                if kv_bits == 4:  # rank 0's reference reads both ranks' rows
                    pools = [None if t is None else gather_dim(t, mesh, d) for t, d in (
                        (cache.k, 3), (cache.v, 3), (cache.ks, 2), (cache.vs, 2))]
                    full = PagedKVCache(*pools, num_kv_heads=cfg.num_kv_heads,
                                        pack_segments=mesh.model)
                    wins = [gather_dim(w, mesh, 2) for w in win]
                if mesh.model_rank == 0:
                    for s_ in range(2):
                        if full is not None:
                            CL.causal_attention = stored_kv_attention(
                                cfg, full, table[s_:s_ + 1], None,
                                window=(wins[0][:, s_], wins[1][:, s_], int(pos0[s_]), i))
                        try:
                            ref = CL.forward(dense, cfg, torch.tensor([seqs[s_]], device=dev))[
                                0, -1]
                        finally:
                            CL.causal_attention = real_causal
                        top_s = float(ref.abs().max())
                        worst = max(worst, float((logits[s_] - ref).abs().max()) / top_s)
                        top2 = torch.topk(ref, 2).values
                        if float(top2[0] - top2[1]) > rel_tol * top_s:
                            decided += 1
                            agree += int(int(logits[s_].argmax()) == int(ref.argmax()))
                toks = logits.argmax(dim=-1).tolist()
                all_toks.append(list(toks))
                lens = lens + 1
            window_flush(cache, win, table, pos0, chunk, live=live)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[kv_bits] = {"worst": worst, "agree": agree, "decided": decided,
                        "tokens": all_toks, "seconds": time.time() - t0,
                        "launches": {"dequant_matmul": KD.launches,
                                     "a8_matmul": KD.launches_a8,
                                     "paged_attention": K5.launches,
                                     "causal_attention": K6.launches}}
    return out


def phase10c_serve(dev, counts: dict, single=None, preset: str = "qwen3-8b",
                   serve_args=None) -> list:
    """``python -m tgq_torch.cli.serve --mesh_model 2`` (the command starts
    its own two ranks, gloo on the one card) at kv16 and at kv4 + A8 + an
    8-bit head; every request must finish and K3 / K4 / K5 must launch on
    both ranks.  Printed beside phase 7b's single-rank runs (``single``)."""
    base = serve_args or ["--model_id", preset, "--w_bits", "4", "--group_size", "128",
                          "--n_requests", "8", "--prompt_len", "128", "--gen_tokens", "32",
                          "--max_slots", "8", "--page_size", "64", "--decode_chunk", "8"]
    results = []
    for i, extra in enumerate((["--kv_bits", "16"],
                               ["--kv_bits", "4", "--a_bits", "8", "--lm_head_bits", "8"])):
        cmd = [sys.executable, "-m", "tgq_torch.cli.serve", *base, *extra, "--mesh_model", "2",
               "--time_collectives", "--device", dev.type]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.time() - t0
        assert proc.returncode == 0, (cmd, proc.stderr[-4000:])
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        c, par = res["config"], res["config"]["parallel"]
        n_req = int(base[base.index("--n_requests") + 1])
        gen_tok = int(base[base.index("--gen_tokens") + 1])
        assert res["total_tokens"] == n_req * gen_tok, res
        assert (par["data"], par["model"], par["backend"]) == (1, 2, "gloo"), par
        for got in c["rank_launches"]:
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
            if dev.type == "cuda":
                assert got["dequant_matmul"] > 0 and got["paged_attention"] > 0, got
                assert got["causal_attention"] > 0, got
                assert got["a8_matmul"] > 0 or "--a_bits" not in extra, got
        step_ms = res["decode_wall_s"] / max(c["decode_steps"], 1) * 1e3
        ar_ms = par["decode_collective_ms_per_step"]
        wait_ms = par["decode_collective_wait_ms_per_step"]
        by = par["collectives_by_phase"]
        assert by["decode"]["calls"] > 0 and ar_ms > 0 and wait_ms >= 0, par
        ref = ""
        if single is not None and i < len(single):
            s1 = single[0 if i == 0 else -1]
            s1_ms = s1["decode_wall_s"] / max(s1["config"].get("decode_steps") or 1, 1) * 1e3
            ref = (f"; phase 7b single rank ({s1['config']['n_requests']} x "
                   f"{s1['config']['gen_tokens']}): {s1['value']} tok/s, TTFT p50 "
                   f"{s1['ttft_p50_s']} s, decode step {s1_ms:.2f} ms")
        log(f"[phase10c] TP 2 {' '.join(extra)}: {res['value']} tok/s, decode-only "
            f"{res['decode_only_tok_s']} tok/s, TTFT p50/p90/p99 {res['ttft_p50_s']}/"
            f"{res['ttft_p90_s']}/{res['ttft_p99_s']} s, decode step {step_ms:.2f} ms "
            f"({c['decode_steps']} steps, collectives timed), "
            f"{par['decode_collectives_per_step']} decode collectives a step: {ar_ms:.2f} ms "
            f"in the collectives ({ar_ms / step_ms:.1%} of the step) and {wait_ms:.2f} ms "
            f"waiting for the other rank at their barriers ({wait_ms / step_ms:.1%}); prefill "
            f"{by.get('prefill')}; launches by rank {c['rank_launches']} ({secs:.1f} s with "
            f"set-up){ref}; {card_line()}")
        results.append(res)
    return results


def dp_tp_quantize_rank(preset: str, n_samples: int, seq: int, group_size: int,
                        ref_path: str, eval_tokens: int) -> dict:
    """One of 4 ranks of phase 10d: layer 0's q/k/v Hessian under the (data
    2 x model 2) mesh, then ``quantize_model(mesh=...)`` at phase 3's
    setting; rank 0 holds the result to phase 3's (``ref_path``)."""
    import torch

    from tgq_torch.calib import QuantizeConfig, quantize_model, synthetic_calibration
    from tgq_torch.calib.data import synthetic_eval_stream
    from tgq_torch.eval import perplexity_from_token_stream
    from tgq_torch.kernels import causal_attention as K6
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import attn_input, init_params
    from tgq_torch.parallel import dp_hessian_gram, make_mesh

    dev = rank_device()
    mesh = make_mesh(data=2, model=2)
    cfg = dataclasses.replace(PRESETS[preset], num_layers=2)
    params = init_params(cfg, seed=0, device=dev)
    calib = synthetic_calibration(cfg.vocab_size, n_samples, seq, seed=42)
    qcfg = QuantizeConfig(mode="pchol", w_bits=4, group_size=group_size, eps=1e-6,
                          threshold_method="energy", batch_size=8)
    # layer 0's q/k/v Hessian as the mesh sweep forms it: this rank's data
    # share in whole batches, the batch Grams summed over "data" in order
    share, bs = n_samples // mesh.data, qcfg.batch_size
    emb, lp0 = params["model"]["embed_tokens"]["weight"], params["model"]["layers"][0]
    ids = torch.from_numpy(calib.astype("int64")).to(dev)
    mine = ids[mesh.data_rank * share:(mesh.data_rank + 1) * share]
    h = dp_hessian_gram([attn_input(lp0, cfg, emb[mine[j:j + bs]].to(torch.bfloat16))
                         for j in range(0, share, bs)], mesh) / ids.numel()
    out = {}
    if mesh.rank == 0:
        h64 = sum(x.reshape(-1, cfg.hidden_size).double().T @ x.reshape(-1, cfg.hidden_size)
                  .double() for x in (attn_input(lp0, cfg, emb[ids[j:j + 8]].to(torch.bfloat16))
                                      for j in range(0, n_samples, 8))) / ids.numel()
        out["gram_err"] = float((h.double() - h64).abs().max() / h64.abs().max())
        del h64
    del h
    K1.launches = K2.launches = K6.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    params, packed, run_log = quantize_model(params, cfg, calib, qcfg, device=dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out.update(seconds=time.time() - t0, launches={"pchol_panel": K1.launches,
                                                   "gptq_block": K2.launches,
                                                   "causal_attention": K6.launches},
               ranks={st["name"]: st["rank"] for st in run_log["layer_stats"]},
               packed=len(packed))
    # the other ranks give their memory back before rank 0's evaluation
    del packed, run_log
    if mesh.rank != 0:
        del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    if mesh.rank == 0:
        ref = torch.load(ref_path, weights_only=False)
        for li in (0, 1):   # layer 1's inputs pass through TP forwards
            q = params["model"]["layers"][li]["self_attn"]["q_proj"]["w"].float().cpu()
            out[f"q{li}_moved"] = float(((q - ref[f"q{li}"].float()).abs() > 1e-6)
                                        .float().mean())
        eval_ids = synthetic_eval_stream(cfg.vocab_size, eval_tokens, seed=43)
        out["ppl"] = perplexity_from_token_stream(params, cfg, eval_ids, max_length=seq,
                                                  stride=seq // 4)
    return out


def phase10_parallel(dev, counts: dict, k5: dict, p3=None, single=None,
                     preset: str = "qwen3-8b", check_layers: int = 4, chunk: int = 8,
                     n_chunks: int = 2, serve_args=None, n_samples: int = 32,
                     seq: int = 2048, group_size: int = 128, eval_tokens: int = 8192) -> None:
    """Phase 10 (see the module docstring); the keyword arguments cut sizes
    for a rehearsal on the CPU.  ``p3``: phase 3's readings (run here when
    phase 3 was not); ``single``: phase 7b's runs, printed beside 10c."""
    import torch

    from tgq_torch.parallel.launch import spawn

    t_phase = time.time()
    marks = {}

    def mark(step):
        marks[step] = round(time.time() - t_phase - sum(marks.values()), 1)

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        phase10a_window(dev, k5)
    mark("a")
    res = spawn(tp_decode_rank, 2, args=(preset, check_layers, (16, 8, 4), chunk, n_chunks,
                                         group_size), device=dev.type, timeout_s=600)
    for kv_bits, r0 in res[0].items():
        r1 = res[1][kv_bits]
        for r in (r0, r1):
            for k, v in r["launches"].items():
                counts[k] = counts.get(k, 0) + v
        ref = "the model attending the stored rows" if kv_bits == 4 else "the unquantized model"
        log(f"[phase10b] TP 2 decode kv{kv_bits}, {check_layers} layers, {n_chunks} chunks of "
            f"{chunk} steps (window 0-{chunk - 1} rows): max|dlogit| / max|logit| "
            f"{r0['worst']:.4f} against {ref}, tolerance 0.03; greedy agrees on "
            f"{r0['agree']}/{r0['decided']} decided steps; ranks' tokens identical "
            f"{r0['tokens'] == r1['tokens']}; launches rank 0 {r0['launches']}, rank 1 "
            f"{r1['launches']} ({r0['seconds']:.1f} s)")
        assert r0["worst"] <= 0.03 and r0["agree"] == r0["decided"], (kv_bits, r0)
        assert r0["tokens"] == r1["tokens"], kv_bits
        if dev.type == "cuda":
            assert all(r["launches"]["dequant_matmul"] > 0 and r["launches"]["paged_attention"]
                       > 0 and r["launches"]["causal_attention"] > 0 for r in (r0, r1)), (
                r0["launches"], r1["launches"])
    mark("b")
    phase10c_serve(dev, counts, single, preset, serve_args)
    mark("c")
    if p3 is None:
        p3 = phase3_main_path(dev, {}, preset, n_samples, seq, eval_tokens, group_size)
    mark("3")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # four ranks' sweeps share the card
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "phase3.pt")
        torch.save({"q0": p3["q0"], "q1": p3["q1"]}, ref_path)
        res = spawn(dp_tp_quantize_rank, 4,
                    args=(preset, n_samples, seq, group_size, ref_path, eval_tokens),
                    device=dev.type, timeout_s=900)
    r0 = res[0]
    for r in res:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
        assert r["ranks"] == r0["ranks"] and r["packed"] == 2 * 7, (r["ranks"], r0["ranks"])
        if dev.type == "cuda":
            assert r["launches"]["pchol_panel"] > 0 and r["launches"]["gptq_block"] > 0, r
            assert r["launches"]["causal_attention"] > 0, r
    ranks = "; ".join(f"{name.split('.', 1)[1]} {r0['ranks'][name]} (phase 3 {p3['ranks'][name]})"
                      for name in r0["ranks"] if name.startswith("layer_0"))
    ppl_rel = r0["ppl"] / p3["ppl"] - 1
    log(f"[phase10d] DP 2 x TP 2 quantize, {preset} x2 layers, {n_samples} x {seq} tokens, 4 "
        f"ranks on one card: layer-0 q/k/v Gram max|H-H64|/max|H64| {r0['gram_err']:.3e} "
        f"(phase 3 {p3['gram_err']:.3e}, limit 2x); pchol ranks {ranks}; layer-0 q_proj "
        f"moved {r0['q0_moved']:.4%} of weights by > 1e-6 (limit 2 %), layer 1's "
        f"{r0['q1_moved']:.4%} (its inputs pass TP forwards; not held); PPL {r0['ppl']:.4f} vs phase "
        f"3 {p3['ppl']:.4f} ({ppl_rel:+.3%}, limit 2 %); {r0['seconds'] / 2:.2f} s/layer "
        f"(phase 3 {p3['s_per_layer']:.2f}); launches by rank "
        f"{[r['launches'] for r in res]}; {card_line()}")
    assert r0["gram_err"] <= 2 * p3["gram_err"] + 1e-12, (r0["gram_err"], p3["gram_err"])
    assert r0["q0_moved"] < 0.02 and abs(ppl_rel) < 0.02, (r0["q0_moved"], ppl_rel)
    mark("d")
    log(f"[phase10] tensor and data parallelism: {time.time() - t_phase:.1f} s (by step "
        f"{marks}); {card_line()}")


# ------------------ slice 11: GPT-2, OPT and the sketch under the mesh (10e)

# (label, preset, layers, mode, meshes as (data, model)); phase 8's
# calibration: 32 sequences at the model's seqlen, W4 g128, eps 1e-6 energy.
# svd at one layer (cut from 2): its host f64 sketch_factor at a rank's 2
# threads took about 22.6 s a layer on each of its three sweeps (an H100
# host of 8 cores)
FAMILY_MESH_RUNS = (
    ("gpt2", "gpt2", 12, "pchol", ((2, 2),)),
    ("opt-1.3b", "opt-1.3b", 4, "pchol", ((2, 2),)),
    ("gpt2-svd", "gpt2", 1, "svd", ((2, 2), (4, 1))),
)


def family_sweep(path: str, mode: str, dev, n_samples: int, group_size: int, mesh=None,
                 eval_tokens: int = 0) -> dict:
    """``quantize_model`` of the HF checkpoint at ``path`` on phase 8's
    calibration, on this rank's ``mesh`` or alone: its packed codes (on the
    host), the sha256 of each finalized svd sketch, its seconds, its K1 /
    K2 / K6 launches and, with ``eval_tokens``, its strided PPL."""
    import hashlib

    import torch

    from tgq_torch.calib import QuantizeConfig, pipeline, quantize_model, synthetic_calibration
    from tgq_torch.calib.data import synthetic_eval_stream
    from tgq_torch.eval import perplexity_from_token_stream
    from tgq_torch.kernels import causal_attention as K6
    from tgq_torch.kernels import gptq_block as K2
    from tgq_torch.kernels import pchol_panel as K1
    from tgq_torch.models.hf_import import load_hf_checkpoint

    params, cfg = load_hf_checkpoint(path, device=dev)
    calib = synthetic_calibration(cfg.vocab_size, n_samples, cfg.seqlen, seed=42)
    qcfg = QuantizeConfig(mode=mode, w_bits=4, group_size=group_size, eps=1e-6,
                          threshold_method="energy")
    digests, factorize = [], pipeline._factorize

    def capture(h_or_y, q, eps):
        if q.mode == "svd":
            digests.append(hashlib.sha256(h_or_y.cpu().numpy().tobytes()).hexdigest())
        return factorize(h_or_y, q, eps)

    pipeline._factorize = capture
    K1.launches = K2.launches = K6.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    try:
        params, packed, _ = quantize_model(params, cfg, calib, qcfg, device=dev, mesh=mesh)
    finally:
        pipeline._factorize = factorize
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {"s_per_layer": (time.time() - t0) / cfg.num_layers, "digests": digests,
           "launches": {"pchol_panel": K1.launches, "gptq_block": K2.launches,
                        "causal_attention": K6.launches},
           "codes": {k: v.codes.cpu() for k, v in packed.items()},
           "in_features": {k: v.in_features for k, v in packed.items()}}
    if eval_tokens:
        out["ppl"] = perplexity_from_token_stream(
            params, cfg, synthetic_eval_stream(cfg.vocab_size, eval_tokens, seed=43),
            max_length=cfg.seqlen, stride=cfg.seqlen // 4)
    return out


def codes_moved(codes: dict, ref: dict, bits: int, group_size: int) -> dict:
    """Each module's share of codes that differ from ``ref``'s (0.0 where
    the packed codes are equal bit for bit)."""
    import torch

    from tgq_torch.core.packing import unpack_rows

    out = {}
    for k, c in codes.items():
        r, n = ref["codes"][k], ref["in_features"][k]
        out[k] = 0.0 if torch.equal(c, r) else float(
            (unpack_rows(c.T, bits, group_size, n) != unpack_rows(r.T, bits, group_size, n))
            .float().mean())
    return out


def family_mesh_rank(runs, tmp: str, n_samples: int, group_size: int,
                     eval_tokens: int) -> dict:
    """One of 4 ranks of phase 10e.  Rank 0 first runs every single-rank
    sweep alone on the card (the others wait) and saves its codes as
    ``<label>.ref.pt``: in a rank, so that its host f64 factorizations
    (svd's sketch_factor) run on as many threads as the mesh sweeps',
    which their last bits depend on.  Then every mesh sweep of ``runs``;
    rank 0 holds its codes to the single rank's and evaluates its PPL."""
    import hashlib

    import torch

    from tgq_torch.parallel import make_mesh

    dev = rank_device()
    if dev.type == "cuda":   # the process's first CUDA work, out of the timings
        from tgq_torch.kernels import _build

        _build.lib()
        torch.ones((256, 256), device=dev).matmul(torch.ones((256, 256), device=dev))
        torch.cuda.synchronize()
    out = {}
    if torch.distributed.get_rank() == 0:
        for label, _, _, mode, _ in runs:
            res = family_sweep(os.path.join(tmp, label), mode, dev, n_samples, group_size,
                               eval_tokens=eval_tokens)
            torch.save({"codes": res.pop("codes"), "in_features": res.pop("in_features")},
                       os.path.join(tmp, f"{label}.ref.pt"))
            out[f"{label} single"] = res
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    torch.distributed.barrier()
    shapes = list(dict.fromkeys(shape for *_, meshes in runs for shape in meshes))
    # every rank creates every mesh's groups, in one order
    meshes = {shape: make_mesh(*shape) for shape in shapes}
    for label, _, _, mode, run_shapes in runs:
        for shape in run_shapes:
            mesh = meshes[shape]
            res = family_sweep(os.path.join(tmp, label), mode, dev, n_samples, group_size,
                               mesh, eval_tokens if mesh.rank == 0 else 0)
            codes = res.pop("codes")
            res["codes_sha256"] = hashlib.sha256(b"".join(
                codes[k].numpy().tobytes() for k in sorted(codes))).hexdigest()
            if mesh.rank == 0:
                ref = torch.load(os.path.join(tmp, f"{label}.ref.pt"), weights_only=False)
                res["moved"] = codes_moved(codes, ref, 4, group_size)
            out[f"{label} {shape}"] = res
            del codes
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def phase10e_family_mesh(dev, counts: dict, runs=FAMILY_MESH_RUNS, n_samples: int = 32,
                         group_size: int = 128, eval_tokens: int = 8192) -> None:
    """Phase 10e: GPT-2, OPT and svd under the mesh against single-rank
    sweeps of the same checkpoints on the card (module docstring).  The
    keyword arguments cut sizes for a rehearsal on the CPU."""
    import torch

    from tgq_torch.models import PRESETS
    from tgq_torch.parallel.launch import spawn

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        for label, preset, layers, _, _ in runs:
            write_hf_model(os.path.join(tmp, label), preset, dev, layers=layers)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()   # the ranks share the card
        # the 4 ranks share the host's cores: cap the OpenMP and BLAS threads
        # of each (its host f64 factorizations), which the libraries read
        # from the environment when a child loads them, before its first
        # line runs; set around the spawn in this, the script's one thread
        caps = [k for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
                if k not in os.environ]
        os.environ.update({k: str(max(1, (os.cpu_count() or 1) // 4)) for k in caps})
        try:
            ranks = spawn(family_mesh_rank, 4,
                          args=(runs, tmp, n_samples, group_size, eval_tokens),
                          device=dev.type, timeout_s=900)
        finally:
            for k in caps:
                del os.environ[k]
    for r in ranks:
        for res in r.values():
            for k, v in res["launches"].items():
                counts[k] = counts.get(k, 0) + v
    for label, _, layers, _, _ in runs:
        one = ranks[0][f"{label} single"]
        log(f"[phase10e] {label} single rank (rank 0 of the spawn, the others waiting): "
            f"{layers} layers, {one['s_per_layer']:.3f} s/layer, PPL {one['ppl']:.4f}, "
            f"launches {one['launches']}")
    if dev.type == "cuda":
        for i, r in enumerate(ranks):
            total = {k: sum(res["launches"][k] for key, res in r.items() if "single" not in key)
                     for k in ("pchol_panel", "gptq_block", "causal_attention")}
            assert all(v > 0 for v in total.values()), (i, total)
    for label, preset, layers, mode, shapes in runs:
        one = ranks[0][f"{label} single"]
        for shape in shapes:
            key = f"{label} {shape}"
            results = [r[key] for r in ranks]
            assert len({res["codes_sha256"] for res in results}) == 1, key  # ranks agree
            if dev.type == "cuda":
                assert all(res["launches"]["gptq_block"] > 0 and res["launches"][
                    "causal_attention"] > 0 and (mode == "svd" or res["launches"][
                        "pchol_panel"] > 0) for res in results), [
                    res["launches"] for res in results]
            r0 = results[0]
            by_layer = [max(v for k, v in r0["moved"].items() if k.startswith(f"layers.{li}."))
                        for li in range(layers)]
            moved = {li: f"{m:.4%}" for li, m in enumerate(by_layer) if m}
            sketches = r0["digests"] == one["digests"]
            ppl_rel = r0["ppl"] / one["ppl"] - 1
            log(f"[phase10e] {key} {mode}, {layers} layers, {n_samples} x "
                f"{PRESETS[preset].seqlen} tokens, 4 ranks: layers whose codes equal the single "
                f"rank's {sum(not m for m in by_layer)}/{layers}"
                + (f" (codes moved: {moved})" if moved else "")
                + (f"; svd sketches bit-equal {sketches} ({len(one['digests'])} groups)"
                   if mode == "svd" else "")
                + f"; PPL {r0['ppl']:.4f} vs single {one['ppl']:.4f} ({ppl_rel:+.4%}); "
                f"{r0['s_per_layer']:.3f} s/layer (single {one['s_per_layer']:.3f}); "
                f"launches by rank {[res['launches'] for res in results]}; {card_line()}")
            if PRESETS[preset].family == "gpt2":   # nothing in a GPT-2 layer is split
                assert not any(by_layer), (key, moved)
            else:
                # layer 0 reads the replicated LayerNorm input (q/k/v) and the
                # heads gathered in order (out_proj, fc1, fc2); later layers'
                # column-sliced GEMMs are not promised the single rank's bits
                assert not by_layer[0], (key, r0["moved"])
                assert max(by_layer) < 0.02 and abs(ppl_rel) < 0.02, (key, moved, ppl_rel)
            if mode == "svd":
                assert sketches, key
    log(f"[phase10e] GPT-2, OPT and svd under the mesh: {time.time() - t_phase:.1f} s; "
        f"{card_line()}")


# ------------------------- slice 9: K6, causal flash attention, and the CLIs (11)

K6_SHAPES = (  # (label, batch, tokens, q heads, kv heads, head_dim) of the main paths
    ("calibration batch", 8, 2048, 32, 8, 128),
    ("PPL window batch", 4, 2048, 32, 8, 128),
    ("GPT-2 calibration batch", 8, 1024, 12, 12, 64),
    ("OPT-1.3b calibration batch", 8, 2048, 32, 32, 64),
    ("prefill wave 16 x 128", 16, 128, 32, 8, 128),
)


# K6's first design (mma.sync, 64-row tiles, cp.async) at K6_SHAPES, ms a
# launch on an NVIDIA H100 80GB HBM3 at 700 W, read by phase 11b
K6_FIRST_DESIGN_MS = {"calibration batch": 1.4159, "PPL window batch": 0.7361,
                      "GPT-2 calibration batch": 0.0921, "OPT-1.3b calibration batch": 0.7395,
                      "prefill wave 16 x 128": 0.0399}


@contextlib.contextmanager
def k6_counted(counts: dict, label: str):
    """K6's launch counter set to 0 just before a main path and read just
    after; the launches join ``counts`` and, on CUDA, must be > 0."""
    import torch

    from tgq_torch.kernels import causal_attention as K6

    K6.launches = 0
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    n = K6.launches
    counts["causal_attention"] = counts.get("causal_attention", 0) + n
    log(f"[phase11c] {label}: causal_attention launches {n}")
    if torch.cuda.is_available():
        assert n > 0, label


def k6_inputs(gen, dev, b: int, s: int, h: int, kv: int, d: int, q_scale: float = 1.0):
    """bf16 q (b, s, h, d), k and v (b, s, kv, d) from ``gen``; q times
    ``q_scale`` (a larger one peaks the softmax)."""
    import torch

    def draw(heads, scale=1.0):
        return (torch.randn((b, s, heads, d), generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    return draw(h, q_scale), draw(kv), draw(kv)


def k6_ptxas(report: str, kernel: str = "causal_attention_wgmma") -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes, wgmma
    serialisation warnings)} of the kernels whose names hold ``kernel`` (K6's
    wgmma kernels by default) in a ptxas -v report."""
    import re

    out, name = {}, None
    serial = {}
    for line in report.splitlines():
        m = re.search(r"wgmma.mma_async instructions are serialized.*'(\w+)'", line)
        if m:
            serial[m.group(1)] = serial.get(m.group(1), 0) + 1
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name] = (None, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name] = (int(m.group(1)),) + out[name][1:]
            name = None
    return {k: v + (serial.get(k, 0),) for k, v in out.items()}


def k6_cases(gen, dev) -> list:
    """[(label, make)]: K6's check cases, ``make()`` giving bf16 q, k, v from
    ``gen``: lengths at the 64- and 128-row tile edges, every head size, GQA
    group and strided view the main paths give it, a peaked softmax."""
    import torch

    cases = [(1, s, 32, 8, 128, 1.0)
             for s in (1, 7, 64, 100, 127, 128, 129, 255, 256, 257, 2047, 2048)]
    cases += [(2, 129, 4, 2, 16, 1.0), (2, 1000, 4, 2, 16, 1.0),     # tiny-qwen3's heads
              (2, 1024, 12, 12, 64, 1.0), (1, 2048, 32, 32, 64, 1.0),  # GPT-2, OPT-1.3b
              (2, 65, 12, 12, 64, 1.0),                                 # half a query tile
              (2, 300, 8, 8, 128, 1.0), (2, 300, 32, 4, 128, 1.0),     # GQA groups 1 and 8
              (2, 2048, 16, 4, 128, 1.0),                               # Qwen3-8B at TP 2
              (2, 777, 32, 8, 128, 8.0), (2, 200, 12, 12, 64, 8.0)]    # peaked softmax

    def views(b, s, h, d):
        """GPT-2's fused q/k/v: three (b, s, h, d) views of one (b, s, 3·h·d)
        tensor (row stride 3·h·d)."""
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        return tuple(x.view(b, s, h, d) for x in qkv.split(h * d, dim=-1))

    def opt_tp_slice():
        """OPT-1.3b's second TP 2 rank: heads 16-31 of q, k and v."""
        q, k, v = k6_inputs(gen, dev, 2, 2048, 32, 32, 64)
        return q[:, :, 16:], k[:, :, 16:], v[:, :, 16:]

    inputs = [(f"b {b} s {s} heads {h}/{kv} d {d} q x{qs:g}",
               lambda b=b, s=s, h=h, kv=kv, d=d, qs=qs: k6_inputs(gen, dev, b, s, h, kv, d, qs))
              for b, s, h, kv, d, qs in cases]
    inputs += [("GPT-2 fused q/k/v views b 2 s 1024 heads 12 d 64",
                lambda: views(2, 1024, 12, 64)),
               ("GPT-2 fused q/k/v views b 2 s 129 heads 12 d 64", lambda: views(2, 129, 12, 64)),
               ("OPT-1.3b TP 2 head slice 16:32 b 2 s 2048 d 64", opt_tp_slice)]
    return inputs


def phase11a_k6_check(dev, k6: dict, report: str | None = None) -> None:
    """K6 against its plain version: every element within
    ``causal_attention.tolerance`` (2^-8 + 2^-12 of the row's Σ p·|v| for the
    bf16 probabilities and the f32 order, and 2 bf16 ulps for the outputs'
    roundings), over lengths at the 64- and 128-row tile edges, every head
    size, GQA group and strided view the main paths give it; then two
    launches, a batch and each sequence alone, a head slice and the full
    launch, bit for bit.  ``report`` (ptxas -v of the build) must show the
    wgmma kernels free of spills and of serialised wgmmas."""
    import torch

    from tgq_torch.kernels import _build
    from tgq_torch.kernels import causal_attention as K6

    t0 = time.time()
    regs = k6_ptxas(_build.ptxas_report() if report is None else report)
    log(f"[phase11a] K6 wgmma kernels (registers, spill store / load bytes, wgmma "
        f"serialisation warnings): {regs}")
    assert len(regs) == 2 and all(r[1:] == (0, 0, 0) for r in regs.values()), regs
    before = K6.launches
    gen = torch.Generator(device=dev).manual_seed(11)
    inputs = k6_cases(gen, dev)
    worst, worst_ratio = 0.0, 0.0
    for label, make in inputs:
        q, k, v = make()
        out = K6.flash_causal_attention(q, k, v)
        ref = K6.causal_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs()
        ratio = float((err / K6.tolerance(q, k, v, ref)).max())
        worst, worst_ratio = max(worst, float(err.max())), max(worst_ratio, ratio)
        log(f"[phase11a] K6 {label}: max|do| {float(err.max()):.3e} (max|o| "
            f"{float(ref.float().abs().max()):.3f}), max err / tolerance {ratio:.3f}")
        assert torch.isfinite(out.float()).all() and ratio <= 1.0, (label, ratio)
        del q, k, v, out, ref, err

    q, k, v = k6_inputs(gen, dev, 2, 2048, 32, 8, 128)
    rep = bits_equal(K6.flash_causal_attention(q, k, v), K6.flash_causal_attention(q, k, v))
    q, k, v = k6_inputs(gen, dev, 8, 300, 16, 4, 128)
    full = K6.flash_causal_attention(q, k, v)
    alone = all(bits_equal(full[i:i + 1], K6.flash_causal_attention(
        q[i:i + 1], k[i:i + 1], v[i:i + 1])) for i in range(8))
    q, k, v = k6_inputs(gen, dev, 2, 512, 32, 8, 128)
    full = K6.flash_causal_attention(q, k, v)
    sliced = all(bits_equal(full[:, :, h0:h1], K6.flash_causal_attention(
        q[:, :, h0:h1], k[:, :, h0 // 4:h1 // 4], v[:, :, h0 // 4:h1 // 4]))
        for h0, h1 in ((0, 16), (16, 32), (8, 12)))
    K6.launches = before
    log(f"[phase11a] K6 against its plain version over {len(inputs)} cases: max|do| "
        f"{worst:.3e}, max err / tolerance {worst_ratio:.3f}; two launches bit-identical "
        f"{rep}; a batch of 8 equals each sequence alone {alone}; head slices (TP 2 "
        f"ranks' 16 / 4 heads, 4 heads) equal the full launch's {sliced} "
        f"({time.time() - t0:.1f} s)")
    assert rep and alone and sliced, (rep, alone, sliced)
    k6["max_abs_err"] = worst


def phase11b_k6_timing(dev, k6: dict, shapes=K6_SHAPES, time_it=None) -> None:
    """K6 a launch at the main paths' shapes beside its bound (bf16
    tensor-core operations against q, k, v and o's bytes), its plain
    version and PyTorch's SDPA on the same values (GQA heads expanded and
    the (b, h, s, d) layout made outside the timed calls): the yardstick
    only, never on the path.  The kernels line takes the calibration batch."""
    import torch
    import torch.nn.functional as F

    from tgq_torch.kernels import causal_attention as K6

    time_it = time_it or cuda_ms
    t0 = time.time()
    before = K6.launches
    gen = torch.Generator(device=dev).manual_seed(12)
    for label, b, s, h, kv, d in shapes:
        q, k, v = k6_inputs(gen, dev, b, s, h, kv, d)
        ms = time_it(lambda: K6.flash_causal_attention(q, k, v), reps=10)
        plain_ms = time_it(lambda: K6.causal_attention_plain(q, k, v), reps=2)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
        lib_ms = time_it(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=1.0 / math.sqrt(d)), reps=10)
        flops = 4.0 * d * h * b * s * (s + 1) / 2
        b_ms, b_by = bound_ms(2.0 * (2 * h + 2 * kv) * b * s * d, flops, BF16_FLOP_PER_S)
        first = K6_FIRST_DESIGN_MS[label]
        log(f"[phase11b] K6 {label} ({b}, {s}, {h}/{kv}, {d}): {ms:.4f} ms a launch, "
            f"{flops / ms / 1e9:.1f} TFLOP/s; bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of "
            f"it); plain {plain_ms:.3f} ms; SDPA {lib_ms:.4f} ms (K6 / SDPA {ms / lib_ms:.2f}); "
            f"first design {first:.4f} ms (K6 / first {ms / first:.2f})")
        if label == shapes[0][0]:
            k6.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    K6.launches = before
    log(f"[phase11b] K6 timing {time.time() - t0:.1f} s; {card_line()}")


def phase11d_clis(dev, counts: dict, tiny_steps: int = 300, tr_n: int = 512) -> None:
    """Slice 9's CLIs on the card at small settings, each with the launch
    counters set to 0 just before it and read just after: one
    ``trunc_regimes`` cell (K2), ``tiny_quality_bench`` at W4 with A16 and
    A8 (K6, K1, K2, K3, K4; the trained PPL below vocab / 8 as the JAX
    tests demand), ``boundary_bench`` (K3) and ``reproduce_baseline
    --smoke`` (K6, K1, K2; every row OK)."""
    from tgq_torch.cli import boundary_bench, reproduce_baseline, tiny_quality_bench, trunc_regimes
    from tgq_torch.models import PRESETS

    d = dev.type
    t0 = time.time()
    with counted(counts, "11d trunc_regimes", ("gptq_block",)):
        res = quiet(trunc_regimes.run, trunc_regimes.build_parser().parse_args([
            "--n", str(tr_n), "--m", str(tr_n // 2), "--decades", "6", "--n_tokens", "256",
            "--bits", "4", "--seeds", "1", "--spectrum", "channel", "--device", d]))
    log(f"[phase11d] trunc_regimes, one channel-spectrum cell (n {tr_n}, N 256, W4): {res} "
        f"({time.time() - t0:.1f} s)")
    assert res["cells"] == 1, res

    t0 = time.time()
    with counted(counts, "11d tiny_quality_bench", ("pchol_panel", "gptq_block", "dequant_matmul",
                                                    "a8_matmul", "causal_attention")):
        res = quiet(tiny_quality_bench.run, tiny_quality_bench.build_parser().parse_args([
            "--steps", str(tiny_steps), "--bits", "4", "--methods", "pchol,rtn",
            "--eps", "1e-6", "--a_bits", "16,8", "--device", d]))
    vocab = PRESETS["tiny-qwen3"].vocab_size
    table = {(r["method"], r["a_bits"]): r["ppl"] for r in res["rows"]}
    log(f"[phase11d] tiny_quality_bench, tiny-qwen3 trained {tiny_steps} steps: base PPL "
        f"{res['base_ppl']} (uniform {vocab}); W4 {table} ({time.time() - t0:.1f} s)")
    assert res["base_ppl"] < vocab / 8, res["base_ppl"]
    assert all(math.isfinite(r["ppl"]) for r in res["rows"]), res["rows"]

    t0 = time.time()
    with counted(counts, "11d boundary_bench", ("dequant_matmul",)):
        res = quiet(boundary_bench.run, boundary_bench.build_parser().parse_args(["--device", d]))
    log(f"[phase11d] boundary_bench (K3, t = {res['tokens']}, W{res['bits']}): per-boundary us "
        f"{ {k: v['per_boundary_us'] for k, v in res['results'].items()} }; per split ms "
        f"{ {k: v['per_split_ms'] for k, v in res['results'].items()} } "
        f"({time.time() - t0:.1f} s); {card_line()}")

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, \
            counted(counts, "11d reproduce_baseline --smoke",
                    ("pchol_panel", "gptq_block", "causal_attention")):
        out = os.path.join(tmp, "smoke")
        assert quiet(reproduce_baseline.main, ["--smoke", "--device", d, "--out", out]) == 0
        with open(os.path.join(out, "final_benchmark.csv")) as f:
            n_rows = sum(1 for line in f) - 1
    log(f"[phase11d] reproduce_baseline --smoke: {n_rows} rows, diff PASS "
        f"({time.time() - t0:.1f} s)")
    assert n_rows == 11, n_rows


# ------------------------------------------- slice 12: K6-bwd and training (12)

# K6-bwd's timing shapes (label, batch, tokens, q heads, kv heads, head_dim)
K6_BWD_SHAPES = (
    ("calibration batch", 8, 2048, 32, 8, 128),
    ("GPT-2 calibration batch", 8, 1024, 12, 12, 64),
    ("OPT-1.3b calibration batch", 8, 2048, 32, 32, 64),
)
# the first design's (mma.sync, no wgmma) ms at those shapes, NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6)
K6_BWD_FIRST_DESIGN_MS = {"calibration batch": 4.4970, "GPT-2 calibration batch": 0.2605,
                          "OPT-1.3b calibration batch": 2.0826}


def k6_bwd_executed_flops(b: int, s: int, h: int, kv: int, d: int) -> float:
    """bf16 tensor-core operations the head_dim 64 / 128 kernels issue: the
    dQ kernel's 64 x 64 steps (S, dP, dS·K) up to each 64-row half's
    diagonal, the dK / dV kernel's 64-key x BQ-row steps (Sᵀ, dPᵀ, Pᵀ·dO,
    dSᵀ·Q) from each 128-key tile's first key, its skipped steps left out;
    rows past the end count as the kernels compute them."""
    from tgq_torch.kernels import causal_attention_bwd as KB

    bq = KB.DKV_STEP_ROWS[d]
    nt = -(-s // 128)
    dq = sum((2 * qt + 1 + c) * 64 * 64 for qt in range(nt) for c in (0, 1))
    dkv = 0
    for kt in range(nt):
        key0 = 128 * kt
        steps = -(-(s - key0) // bq)
        dkv += sum(64 * bq for c in (0, 1) for j in range(steps) if (j + 1) * bq > 64 * c)
    return 2.0 * d * b * h * (3 * dq + 4 * dkv)


def k6_bwd_inputs(q, k, v, gen):
    """K6's output and stats for q, k, v (the kernel on CUDA) and a bf16
    cotangent of o's shape from ``gen``."""
    import torch

    from tgq_torch.kernels import causal_attention as K6

    o, lse = K6._forward(q, k, v, 1.0 / math.sqrt(q.shape[3]), stats=True)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(torch.bfloat16)
    return o, lse, do


def phase12a_k6_bwd_check(dev, kb: dict, report: str | None = None) -> None:
    """K6-bwd against its plain version over phase 11a's cases: dq, dk, dv
    within ``causal_attention_bwd.bwd_tolerance`` ((2^-8 + 2^-12) of each
    gradient's magnitude for the bf16 p and ds and the f32 order, 2 bf16
    ulps for the roundings), K6's stats output within 1e-3 of the plain
    log2-sum-exp; then K6's o bit-identical with the stats output on and
    off, and two backward launches, a batch and each sequence alone, a head
    slice and the full launch, all bit for bit.  ``report`` (ptxas -v of the
    build) must show the six kernels (the wgmma dQ and dK / dV kernels at
    head_dim 64 and 128, the mma.sync ones at 16) free of spills and of
    serialised wgmmas."""
    import torch

    from tgq_torch.kernels import _build
    from tgq_torch.kernels import causal_attention as K6
    from tgq_torch.kernels import causal_attention_bwd as KB

    t0 = time.time()
    regs = k6_ptxas(_build.ptxas_report() if report is None else report, "attention_bwd")
    log(f"[phase12a] K6-bwd kernels (registers, spill store / load bytes, wgmma "
        f"serialisation warnings): {regs}")
    # dQ and dK / dV: wgmma at d 64 and 128, mma.sync at 16; no spill, no
    # serialised wgmma
    assert len(regs) == 6 or dev.type == "cpu", regs
    assert sum("wgmma" in name for name in regs) == 4 or dev.type == "cpu", regs
    assert all(r[1:] == (0, 0, 0) for r in regs.values()), regs
    before = (K6.launches, KB.launches)
    gen = torch.Generator(device=dev).manual_seed(13)
    worst, worst_ratio, worst_lse = 0.0, 0.0, 0.0
    inputs = k6_cases(gen, dev)
    for label, make in inputs:
        q, k, v = make()
        o, lse, do = k6_bwd_inputs(q, k, v, gen)
        got = KB.flash_causal_attention_bwd(q, k, v, o, lse, do)
        ref = KB.causal_attention_bwd_plain(q, k, v, o, lse, do)
        tol = KB.bwd_tolerance(q, k, v, do, ref)
        errs = [float((g.float() - r).abs().max()) for g, r in zip(got, ref)]
        ratios = [float(((g.float() - r).abs() / t).max()) for g, r, t in zip(got, ref, tol)]
        lse_err = float((lse - KB.lse_plain(q, k)).abs().max()) if q.shape[1] else 0.0
        worst, worst_ratio = max(worst, *errs), max(worst_ratio, *ratios)
        worst_lse = max(worst_lse, lse_err)
        log(f"[phase12a] K6-bwd {label}: max|d(dq, dk, dv)| "
            f"{', '.join(f'{e:.3e}' for e in errs)} (max|dk| {float(ref[1].abs().max()):.3f}), "
            f"max err / tolerance {', '.join(f'{r:.3f}' for r in ratios)}; stats {lse_err:.2e}")
        assert all(torch.isfinite(g.float()).all() for g in got), label
        assert max(ratios) <= 1.0 and lse_err <= 1e-3, (label, ratios, lse_err)
        del q, k, v, o, lse, do, got, ref, tol

    same_o = True
    for b, s, h, kv, d in ((2, 300, 4, 2, 16), (2, 1000, 12, 12, 64), (2, 777, 32, 8, 128)):
        q, k, v = k6_inputs(gen, dev, b, s, h, kv, d)
        same_o &= bits_equal(K6._forward(q, k, v, d ** -0.5, stats=False)[0],
                             K6._forward(q, k, v, d ** -0.5, stats=True)[0])
    q, k, v = k6_inputs(gen, dev, 2, 2048, 32, 8, 128)
    o, lse, do = k6_bwd_inputs(q, k, v, gen)
    one, two = (KB.flash_causal_attention_bwd(q, k, v, o, lse, do) for _ in range(2))
    rep = all(bits_equal(x, y) for x, y in zip(one, two))
    q, k, v = k6_inputs(gen, dev, 8, 300, 16, 4, 128)
    o, lse, do = k6_bwd_inputs(q, k, v, gen)
    full = KB.flash_causal_attention_bwd(q, k, v, o, lse, do)
    alone = all(all(bits_equal(f[i:i + 1], g) for f, g in zip(full, KB.flash_causal_attention_bwd(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1], lse[i:i + 1], do[i:i + 1])))
        for i in range(8))
    q, k, v = k6_inputs(gen, dev, 2, 512, 32, 8, 128)
    o, lse, do = k6_bwd_inputs(q, k, v, gen)
    full = KB.flash_causal_attention_bwd(q, k, v, o, lse, do)
    sliced = True
    for h0, h1 in ((0, 16), (16, 32), (8, 12)):
        part = KB.flash_causal_attention_bwd(
            q[:, :, h0:h1], k[:, :, h0 // 4:h1 // 4], v[:, :, h0 // 4:h1 // 4], o[:, :, h0:h1],
            lse[:, h0:h1], do[:, :, h0:h1])
        sliced &= bits_equal(full[0][:, :, h0:h1], part[0]) and all(
            bits_equal(f[:, :, h0 // 4:h1 // 4], g) for f, g in zip(full[1:], part[1:]))
    K6.launches, KB.launches = before
    log(f"[phase12a] K6-bwd against its plain version over {len(inputs)} cases: max|d| "
        f"{worst:.3e}, max err / tolerance {worst_ratio:.3f}; K6 stats within {worst_lse:.2e} "
        f"of the plain log2-sum-exp; o with and without stats bit-identical {same_o}; two "
        f"launches bit-identical {rep}; a batch of 8 equals each sequence alone {alone}; "
        f"head slices (TP 2 ranks' 16 / 4 heads, 4 heads) equal the full launch's {sliced} "
        f"({time.time() - t0:.1f} s)")
    assert same_o and rep and alone and sliced, (same_o, rep, alone, sliced)
    kb["max_abs_err"] = worst


def phase12b_k6_bwd_timing(dev, kb: dict, shapes=K6_BWD_SHAPES, time_it=None) -> None:
    """K6-bwd a launch (its two kernels) at the calibration, GPT-2 and
    OPT-1.3b shapes beside the first design's, its bound (2.5x the
    forward's bf16 tensor-core operations against q, k, v, o, dO, the stats,
    dQ, dK and dV's bytes; the TFLOP/s both of those and of the operations
    the kernels issue), its plain version and PyTorch's SDPA backward on
    the same values (GQA heads expanded and the (b, h, s, d) layout made
    outside the timed calls; the forward run once, its graph kept): the
    yardstick only, never on the path.  The kernels line takes the
    calibration batch."""
    import torch
    import torch.nn.functional as F

    from tgq_torch.kernels import causal_attention as K6
    from tgq_torch.kernels import causal_attention_bwd as KB

    time_it = time_it or cuda_ms
    t0 = time.time()
    before = (K6.launches, KB.launches)
    gen = torch.Generator(device=dev).manual_seed(14)
    for label, b, s, h, kv, d in shapes:
        q, k, v = k6_inputs(gen, dev, b, s, h, kv, d)
        o, lse, do = k6_bwd_inputs(q, k, v, gen)
        ms = time_it(lambda: KB.flash_causal_attention_bwd(q, k, v, o, lse, do), reps=5)
        plain_ms = time_it(lambda: KB.causal_attention_bwd_plain(q, k, v, o, lse, do), reps=1)
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous().requires_grad_()
        vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous().requires_grad_()
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0 / math.sqrt(d))
        dot = do.transpose(1, 2).contiguous()
        lib_ms = time_it(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                         reps=5)
        flops = 5.0 * d * h * b * s * (s + 1)
        nbytes = 2.0 * b * s * d * (4 * h + 4 * kv) + 4.0 * b * h * s
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        first = K6_BWD_FIRST_DESIGN_MS[label]
        log(f"[phase12b] K6-bwd {label} ({b}, {s}, {h}/{kv}, {d}): {ms:.4f} ms a launch "
            f"[first design {first:.4f}; {first / ms:.2f}x], {flops / ms / 1e9:.1f} TFLOP/s "
            f"counted, "
            f"{k6_bwd_executed_flops(b, s, h, kv, d) / ms / 1e9:.1f} executed; bound "
            f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it); plain {plain_ms:.3f} ms; SDPA "
            f"backward {lib_ms:.4f} ms (K6-bwd / SDPA {ms / lib_ms:.2f})")
        if label == shapes[0][0]:
            kb.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v, o, lse, do, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    K6.launches, KB.launches = before
    log(f"[phase12b] K6-bwd timing {time.time() - t0:.1f} s; {card_line()}")


TRAIN_REL_FROB = 0.03  # per-tensor relative Frobenius error, "flash" against "naive"


def lm_loss(params, cfg, ids, attn_impl: str):
    """tiny_train's loss through the staged functions: embed_tokens ->
    decoder_layer x L -> apply_final_norm -> lm_logits -> f32 log-softmax
    NLL of the next token."""
    import torch

    from tgq_torch.models import causal_lm as cl

    x = cl.embed_tokens(params, ids[:, :-1], cfg=cfg)
    cos, sin = cl.rope_cache(cfg, ids.shape[1] - 1, device=x.device)
    for lp in params["model"]["layers"]:
        x = cl.decoder_layer(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    logits = cl.lm_logits(params, cfg, cl.apply_final_norm(params, cfg, x))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, ids[:, 1:, None]).mean()


def tree_leaves(tree, path: str = "") -> list:
    """[(dotted name, leaf)] of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_leaves(v, f"{path}.{k}" if path else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in tree_leaves(v, f"{path}.{i}")]
    return [(path, tree)]


def flash_training(dev, counts: dict, preset: str, layers: int, batch: int, seq: int,
                   steps: int = 3, lr: float = 1e-3) -> dict:
    """One model's training path through ``attn_impl="flash"`` at full
    width: bf16 weights from ``init_params``, ``batch`` x ``seq`` ids from a
    numpy seed; every parameter's gradient through "flash" (K6, K6-bwd)
    against "naive" (autograd of the plain attention) within
    ``TRAIN_REL_FROB``, then ``steps`` AdamW steps through "flash" on the
    repeated batch, the loss finite and falling, K6-bwd launched ``layers``
    times a step (the launch counters set to 0 just before and read just
    after)."""
    import numpy as np
    import torch

    from tgq_torch.kernels import causal_attention_bwd as KB
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params

    cfg = dataclasses.replace(PRESETS[preset], num_layers=layers)
    params = init_params(cfg, seed=12, device=dev)
    leaves = tree_leaves(params)
    for _, t in leaves:
        t.requires_grad_()
    ids = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, size=(batch, seq + 1))).to(dev)
    t0 = time.time()
    naive = torch.autograd.grad(lm_loss(params, cfg, ids, "naive"), [t for _, t in leaves])
    t_naive = time.time() - t0
    opt = torch.optim.AdamW([t for _, t in leaves], lr=lr)
    with counted(counts, f"12c {preset} x{layers}",
                 ("causal_attention", "causal_attention_bwd")) as got:
        loss = lm_loss(params, cfg, ids, "flash")
        flash = torch.autograd.grad(loss, [t for _, t in leaves])
        errs = {name: float((f.double() - n.double()).norm() / n.double().norm().clamp_min(1e-30))
                for (name, _), f, n in zip(leaves, flash, naive)}
        del flash, naive
        losses, walls = [], []
        for _ in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.time()
            opt.zero_grad(set_to_none=True)
            loss = lm_loss(params, cfg, ids, "flash")
            loss.backward()
            opt.step()
            losses.append(loss.item())
            walls.append(time.time() - t1)
    worst = max(errs, key=errs.get)
    log(f"[phase12c] {preset} at full width, {layers} layers, {batch} x {seq}: grads through "
        f"flash against naive, max relative Frobenius error {errs[worst]:.4f} ({worst}; bound "
        f"{TRAIN_REL_FROB}), median {float(np.median(list(errs.values()))):.4f}; AdamW losses "
        f"{[round(x, 4) for x in losses]}; s a step {[round(w, 3) for w in walls]} (naive "
        f"gradient {t_naive:.2f} s); K6-bwd launches {got.get('causal_attention_bwd')}")
    assert errs[worst] <= TRAIN_REL_FROB, (preset, worst, errs[worst])
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    if dev.type == "cuda":
        assert got["causal_attention_bwd"] == layers * (steps + 1), got
    del params, leaves, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"max_rel": errs[worst], "losses": losses, "s_per_step": walls}


def phase12c_training(dev, counts: dict, runs=(("qwen3-8b", 2, 4, 2048),
                                              ("gpt2", 12, 8, 1024))) -> None:
    """The training path through ``attn_impl="flash"``: Qwen3-8B at full
    width (2 layers, 4 x 2048) and GPT-2 at full width and depth (8 x
    1024), each with :func:`flash_training`."""
    for preset, layers, batch, seq in runs:
        flash_training(dev, counts, preset, layers, batch, seq)


# ------------------------------------- decode chunks as CUDA graphs (13)


def graph_vs_eager(dev, preset: str = "qwen3-8b", layers=None, kv_bits: int = 16,
                   a_bits: int = 16, lm_head_bits: int = 16, slots: int = 8,
                   n_requests: int = 16, prompt_len: int = 128, max_new: int = 64,
                   seed: int = 0, group_size: int = 128) -> dict:
    """The same seeded requests through an engine whose greedy decode chunks
    replay from CUDA graphs and through one with ``graphs = None``: per
    mode the outputs, the engine's counters, the K3 / K4 / K5 launches the
    run counted, the run's wall and (graphs) the seconds of the capture,
    made before the first request."""
    import numpy as np
    import torch

    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.kernels import dequant_matmul as KD
    from tgq_torch.kernels import paged_attention as K5
    from tgq_torch.models import PRESETS
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.serve import Engine, ServeConfig

    cfg = PRESETS[preset]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = init_packed_params(cfg, QuantSpec(bits=4, group_size=group_size), seed=0,
                                lm_head_bits=lm_head_bits, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(n_requests)]
    budgets = [int(b) for b in rng.integers(8, max_new + 1, size=n_requests)]
    page = 64
    mpps = -(-(prompt_len + max_new + page) // page)
    scfg = ServeConfig(max_slots=slots, page_size=page, num_pages=slots * mpps + 1,
                       max_pages_per_slot=mpps, max_new_tokens=max_new, decode_chunk=8,
                       kv_bits=kv_bits, a_bits=a_bits)
    out = {}
    for mode in ("eager", "graphs"):
        eng = Engine(params, cfg, scfg, device=dev)
        capture_s = None
        if mode == "eager":
            eng.graphs = None
        elif dev.type == "cuda":
            t0 = time.time()
            eng.graphs.capture()
            torch.cuda.synchronize()
            capture_s = time.time() - t0
        reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        KD.launches = KD.launches_a8 = K5.launches = 0
        t0 = time.time()
        eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[mode] = {"tokens": [r.output for r in reqs], "wall_s": time.time() - t0,
                     "capture_s": capture_s, "a8": eng.a8_active, "steps": eng.steps,
                     "chunks": eng.chunks, "spec_chunks": eng.spec_chunks,
                     "graph_chunks": eng.graph_chunks, "graph_captures": eng.graph_captures,
                     "launches": {"dequant_matmul": KD.launches, "a8_matmul": KD.launches_a8,
                                  "paged_attention": K5.launches}}
        del eng
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# (kv_bits, a_bits, lm_head_bits, slots, requests, prompt length): the cell's
# 128 slots at prompts of 512 (K5 splits each context in 3) besides 8 slots
PHASE13_RUNS = ((16, 16, 16, 8, 16, 128), (8, 8, 16, 8, 16, 128), (4, 8, 8, 8, 16, 128),
                (16, 16, 16, 128, 128, 512))


def phase13_decode_graphs(dev, counts: dict, preset: str = "qwen3-8b", layers=None,
                          runs=PHASE13_RUNS) -> list:
    """``graph_vs_eager`` at bf16 KV with A16, int8 KV with W4A8, int4 KV
    with W4A8 and an 8-bit packed head, each at 8 slots, and bf16 KV at
    128 slots: the same tokens and the same launch counts in both modes."""
    results = []
    for kv_bits, a_bits, head_bits, slots, n_req, prompt_len in runs:
        r = graph_vs_eager(dev, preset, layers, kv_bits=kv_bits, a_bits=a_bits,
                           lm_head_bits=head_bits, slots=slots, n_requests=n_req,
                           prompt_len=prompt_len)
        e, g = r["eager"], r["graphs"]
        n_tok = sum(len(t) for t in e["tokens"])
        same = e["tokens"] == g["tokens"]
        summary = {"kv_bits": kv_bits, "a_bits": a_bits, "lm_head_bits": head_bits,
                   "slots": slots, "requests": n_req, "prompt_len": prompt_len,
                   "tokens_identical": same, "tokens": n_tok, "capture_s": g["capture_s"],
                   **{f"{m}_{k}": r[m][k] for m in ("eager", "graphs")
                      for k in ("wall_s", "steps", "chunks", "spec_chunks", "graph_chunks",
                                "graph_captures", "launches")}}
        print(json.dumps({"decode_graphs": summary}), flush=True)
        label = f"kv{kv_bits} a{a_bits} head{head_bits} {slots} slots"
        log(f"[phase13] {label}: tokens identical {same} ({n_tok} tokens); graph chunks "
            f"{g['graph_chunks']} of {g['chunks']} ({g['spec_chunks']} speculative), captures "
            f"{g['graph_captures']} in {g['capture_s']} s; launches {g['launches']} with graphs, "
            f"{e['launches']} eager; wall {g['wall_s']:.2f} s with graphs, {e['wall_s']:.2f} s "
            f"eager (one-shot); {card_line()}")
        for k, v in g["launches"].items():
            counts[k] = counts.get(k, 0) + v
        assert same, label
        assert g["launches"] == e["launches"], (label, g["launches"], e["launches"])
        assert e["graph_chunks"] == e["graph_captures"] == 0, e
        assert g["graph_captures"] == 4 and g["graph_chunks"] == g["chunks"] == e["chunks"], g
        assert g["a8"] == e["a8"] == (a_bits == 8), (g["a8"], e["a8"])
        results.append(summary)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13",
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
    k6 = {"name": "causal_attention", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/causal_attention.cu",
          "replaces": "tgq/models/causal_lm.py:143", "library_ms": None}
    kb = {"name": "causal_attention_bwd", "route": "cuda",
          "source": "tgq_torch/kernels/csrc/causal_attention_bwd.cu",
          "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941, :1287",
          "library_ms": None}
    counts: dict[str, int] = {}
    k34_readings: dict = {}
    prof7c = p3 = serve7b = None
    if 1 in phases:
        phase1_pchol(dev, k1)
    if 2 in phases:
        phase2_gptq(dev, k2)
    if 3 in phases:
        with k6_counted(counts, "phase 3"):
            p3 = phase3_main_path(dev, counts)
    if 4 in phases:
        with k6_counted(counts, "phase 4"):
            phase4_cli(dev)
    if 5 in phases:
        k3_group_check(dev)
        phase5_matmul(dev, k3, k4, readings=k34_readings)
    if 6 in phases:
        phase6_attention(dev, k5)
    if 7 in phases:
        *serve7b, prof7c = phase7_serving(dev, counts)
    if 8 in phases:
        with k6_counted(counts, "phase 8"):
            phase8_families(dev, counts)
    if 9 in phases:
        # depth cuts that make room for phase 10 (PERF.md section 4): the
        # soak at 256 requests, 9b's serve runs at 12 of 36 layers
        phase9_slice7(dev, counts, k34_readings, prof7c, serve_layers=12,
                      soak_args=("--n_requests", "256"))
    if 10 in phases:
        phase10_parallel(dev, counts, k5, p3, serve7b)
        phase10e_family_mesh(dev, counts)
    if 11 in phases:
        t11 = time.time()
        phase11a_k6_check(dev, k6)
        phase11b_k6_timing(dev, k6)
        phase11d_clis(dev, counts)
        log(f"[phase11] K6 and the slice-9 CLIs: {time.time() - t11:.1f} s")
    if 12 in phases:
        t12 = time.time()
        phase12a_k6_bwd_check(dev, kb)
        phase12b_k6_bwd_timing(dev, kb)
        phase12c_training(dev, counts)
        log(f"[phase12] K6-bwd and training through the flash attention: "
            f"{time.time() - t12:.1f} s")
    if 13 in phases:
        t13 = time.time()
        phase13_decode_graphs(dev, counts)
        log(f"[phase13] the decode chunk as CUDA graphs: {time.time() - t13:.1f} s")
    kernels = [k1, k2, k3, k4, k5, k6, kb]
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
