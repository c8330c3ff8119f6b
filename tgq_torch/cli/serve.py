"""``python -m tgq_torch.cli.serve`` — serving entry point and throughput
harness (mirrors ``tgq/cli/serve.py``).

Loads a packed checkpoint (``--checkpoint``) or makes a preset with random
RTN-packed weights, drives the continuous-batching engine with synthetic
prompts (one warm-up wave, then the measured run, closed-loop or with
Poisson arrivals), and prints one JSON line of metrics: tokens/s,
decode-only tokens/s, TTFT percentiles, decode and prefill wall time.
``--kv_equalize`` calibrates static KV equalizers on 256 seeded tokens
for a quantized cache (a checkpoint's stored ones win); ``--page_alloc``
picks the page allocator, and ``config.page_alloc`` says which ran.
Runs on CUDA unless ``--device cpu``.

Tensor parallelism: ``--mesh_model T`` (with ``--mesh_data D`` replicas)
serves on D·T ranks, one process each.  Run alone, the command starts its
own ranks on this host (``tgq_torch.parallel.launch.spawn``; gloo when
they share a card, NCCL when each has one); under ``torchrun`` pass
``--distributed`` and every rank joins the group torchrun describes.
Rank 0 prints; a failure in any rank fails the command.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time

import numpy as np
import torch

def _rtn_pack_dense(params, cfg, spec) -> None:
    """RTN-pack every decoder linear of a dense tree in place."""
    from tgq_torch.models.causal_lm import find_linear_paths, get_nested, set_nested
    from tgq_torch.models.hf_import import rtn_pack

    for lp in params["model"]["layers"]:
        for name in find_linear_paths(cfg):
            entry = get_nested(lp, name)
            set_nested(lp, name, rtn_pack(entry["w"], spec, bias=(
                entry["b"].float() if "b" in entry else None)))


def load_or_make_model(args, device):
    """(params, cfg, kv equalizers or None) on ``device``."""
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models.config import PRESETS

    if args.checkpoint:
        from tgq_torch.core.checkpoint import load_quantized

        params, cfg, qconf = load_quantized(args.checkpoint, device=device)
        _maybe_pack_head(params, args)
        return params, cfg, qconf.get("kv_equalizers")
    spec = QuantSpec(bits=args.w_bits, group_size=args.group_size, sym=False)
    cfg = PRESETS.get(args.model_id)
    if cfg is not None and cfg.family == "llama" and args.w_bits < 16 \
            and not cfg.attention_bias:
        from tgq_torch.models.hf_import import init_packed_params

        return init_packed_params(cfg, spec, seed=0, lm_head_bits=args.lm_head_bits,
                                  device=device), cfg, None
    from tgq_torch.models.hf_import import resolve_model

    params, cfg, _ = resolve_model(args.model_id, seed=0, device=device)
    if args.w_bits < 16:
        _rtn_pack_dense(params, cfg, spec)
    _maybe_pack_head(params, args)
    return params, cfg, None


def _maybe_pack_head(params, args) -> bool:
    """RTN-pack a dense lm_head when ``--lm_head_bits`` asks for it, rows
    padded to a multiple of 512 (``lm_logits`` slices the logits back)."""
    head = params.get("lm_head")
    if args.lm_head_bits >= 16 or not isinstance(head, dict):
        return False
    from tgq_torch.core.packing import pad_out
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models.hf_import import rtn_pack

    spec = QuantSpec(bits=args.lm_head_bits, group_size=args.group_size, sym=False)
    params["lm_head"] = pad_out(rtn_pack(head["w"], spec))
    return True


def _measured_run(eng, prompts, arrival_rate: float, rng, sync, agree=lambda n: n):
    """The measured run: every prompt at once (closed loop), or Poisson
    arrivals at ``arrival_rate`` req/s driving ``Engine.step``.  ``agree``
    turns this rank's count of arrivals due by its clock into the count
    every rank of a TP group admits (the first rank's): the ranks' clocks
    differ, and their engines must take the same steps.  Returns
    (requests, wall seconds)."""
    if arrival_rate > 0:
        gaps = rng.exponential(1.0 / arrival_rate, size=len(prompts))
        t0 = time.time()
        arrivals = t0 + np.cumsum(gaps)
        reqs, i = [], 0
        while i < len(prompts) or not eng.idle:
            if eng.idle:  # nothing to step: wait for the next arrival
                time.sleep(max(0.0, arrivals[i] - time.time()))
            due = agree(int(np.searchsorted(arrivals, time.time(), side="right")))
            while i < due:
                reqs.append(eng.submit(prompts[i]))
                i += 1
            if not eng.idle:
                eng.step()
    else:
        reqs = [eng.submit(p) for p in prompts]
        t0 = time.time()
        eng.run()
    sync()
    return reqs, time.time() - t0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default=None, help="packed checkpoint dir")
    ap.add_argument("--model_id", default="qwen3-8b",
                    help="preset, local HF directory or cached hub id when no checkpoint")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--w_bits", type=int, default=4,
                    help="RTN bits for the random preset (16 = dense)")
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--n_requests", type=int, default=16)
    ap.add_argument("--prompt_len", type=int, default=128)
    ap.add_argument("--gen_tokens", type=int, default=64)
    ap.add_argument("--max_slots", type=int, default=8)
    ap.add_argument("--page_size", type=int, default=64)
    ap.add_argument("--num_pages", type=int, default=0,
                    help="KV page pool size; 0 = max_slots * pages-per-request + scratch")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode_chunk", type=int, default=8,
                    help="decode steps per device dispatch")
    ap.add_argument("--prefill_chunk_tokens", type=int, default=4096,
                    help="max padded prompt tokens per prefill dispatch (0 = one wave)")
    ap.add_argument("--a_bits", type=int, default=16, choices=(16, 8),
                    help="activation precision of the packed matmuls (8 = W4A8)")
    ap.add_argument("--lm_head_bits", type=int, default=16, choices=(16, 8),
                    help="vocab-head quantization")
    ap.add_argument("--kv_bits", type=int, default=16, choices=(16, 8, 4),
                    help="KV cache storage: bf16, int8 + scales, int4 + scales")
    ap.add_argument("--kv_equalize", action="store_true",
                    help="calibrate per-channel KV equalizers on 256 seeded tokens "
                         "(kv_bits < 16; a checkpoint's stored ones win)")
    ap.add_argument("--page_alloc", default="auto", choices=("auto", "native", "python"),
                    help="page allocator backend (auto: native when it builds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival_rate", type=float, default=0.0,
                    help="open loop: Poisson arrivals at this rate (req/s); 0 = closed loop")
    ap.add_argument("--profile_dir", default=None,
                    help="torch.profiler trace of the measured run, written to "
                         "<dir>/trace.json")
    ap.add_argument("--mesh_model", type=int, default=0,
                    help="TP degree; 0 = single device.  With --distributed the mesh spans "
                         "every rank torchrun started (model axis inside a host)")
    ap.add_argument("--mesh_data", type=int, default=1,
                    help="data-parallel degree of the serving mesh (replicas)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group of torchrun's environment variables")
    ap.add_argument("--time_collectives", action="store_true",
                    help="under a mesh, time every collective of the measured run by "
                         "phase: the wait for the group's last rank (a barrier) apart "
                         "from the collective itself, the device synchronised around both")
    return ap


def run(args) -> dict:
    """Load or make the model, drive the engine (one warm-up wave, then
    the measured run) and return the metrics dict."""
    from tgq_torch.parallel import mesh as pmesh
    from tgq_torch.serve import Engine, ServeConfig
    from tgq_torch.utils.precision import resolve_device

    device = resolve_device(args.device)
    if args.distributed:
        from tgq_torch.parallel.launch import init_distributed

        device = init_distributed(device.type)
    mesh = None
    if args.mesh_model:
        from tgq_torch.parallel.launch import global_mesh

        mesh = global_mesh(model_per_host=args.mesh_model)
        if mesh.data != args.mesh_data:
            raise ValueError(f"--mesh_data {args.mesh_data} x --mesh_model {args.mesh_model} "
                             f"!= {mesh.data * mesh.model} ranks")
    params, cfg, ckpt_eq = load_or_make_model(args, device)
    k_eq = v_eq = None
    kv_eq_s = None
    if ckpt_eq is not None and args.kv_bits < 16:
        k_eq, v_eq = ckpt_eq
        logging.info("[kv-eq] using checkpoint-stored per-channel equalizers")
    elif args.kv_equalize and args.kv_bits < 16:
        from tgq_torch.serve.kv_calibrate import estimate_kv_equalizers

        calib = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab_size, size=(1, 256))
        t0 = time.time()
        k_eq, v_eq = estimate_kv_equalizers(params, cfg, calib)
        kv_eq_s = time.time() - t0
        logging.info("[kv-eq] calibrated per-channel equalizers in %.1fs", kv_eq_s)
    max_pages_per_slot = -(-(args.prompt_len + args.gen_tokens + args.page_size)
                           // args.page_size)
    num_pages = args.num_pages or args.max_slots * max_pages_per_slot + 1
    scfg = ServeConfig(
        max_slots=args.max_slots, page_size=args.page_size, num_pages=num_pages,
        max_pages_per_slot=max_pages_per_slot, max_new_tokens=args.gen_tokens,
        temperature=args.temperature, seed=args.seed, decode_chunk=args.decode_chunk,
        kv_bits=args.kv_bits, kv_k_eq=k_eq, kv_v_eq=v_eq,
        prefill_chunk_tokens=args.prefill_chunk_tokens, a_bits=args.a_bits,
        page_alloc=args.page_alloc)
    eng = Engine(params, cfg, scfg, mesh=mesh, device=device)
    del params

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
               for _ in range(args.n_requests)]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warm-up: one full wave at the real admission width
    for p in prompts[: min(args.max_slots, args.n_requests)]:
        eng.submit(p)
    eng.run()
    sync()
    eng.decode_wall_s = eng.prefill_wall_s = 0.0
    eng.steps = eng.tokens_emitted = 0

    from tgq_torch.utils.profiling import device_trace

    from tgq_torch.kernels import causal_attention as K6
    from tgq_torch.kernels import dequant_matmul as KD
    from tgq_torch.kernels import paged_attention as K5

    stats0 = pmesh.collective_totals()
    launches0 = (KD.launches, KD.launches_a8, K5.launches, K6.launches)
    agree = (lambda n: n) if mesh is None else (lambda n: pmesh.broadcast_int(n, mesh))
    timing = pmesh.time_collectives() if mesh is not None and args.time_collectives \
        else contextlib.nullcontext()
    with device_trace(args.profile_dir, cuda=device.type == "cuda"), timing:
        reqs, wall = _measured_run(eng, prompts, args.arrival_rate, rng, sync, agree)
    launches = {name: now - then for name, now, then in zip(
        ("dequant_matmul", "a8_matmul", "paged_attention", "causal_attention"),
        (KD.launches, KD.launches_a8, K5.launches, K6.launches), launches0)}
    parallel = None
    if mesh is not None:
        phases = {}
        for ph, st in pmesh.collective_stats.items():
            st0 = stats0.get(ph, {"calls": 0, "seconds": 0.0, "wait_seconds": 0.0})
            calls = st["calls"] - st0["calls"]
            if calls:
                ms = {k: round((st[k] - st0[k]) * 1e3, 3) if args.time_collectives else None
                      for k in ("seconds", "wait_seconds")}
                phases[ph] = {"calls": calls, "ms": ms["seconds"], "wait_ms": ms["wait_seconds"]}
        dec = phases.get("decode", {"calls": 0, "ms": None, "wait_ms": None})
        per_step = lambda v: None if v is None else round(v / max(eng.steps, 1), 4)  # noqa: E731
        parallel = {"data": mesh.data, "model": mesh.model, "backend": mesh.backend,
                    "collectives": sum(p["calls"] for p in phases.values()),
                    "collectives_by_phase": phases,
                    "decode_collectives_per_step": round(dec["calls"] / max(eng.steps, 1), 2),
                    "decode_collective_ms_per_step": per_step(dec["ms"]),
                    "decode_collective_wait_ms_per_step": per_step(dec["wait_ms"])}

    total_tokens = sum(len(r.output) for r in reqs)
    ttft = [r.first_token_t - r.submit_t for r in reqs]
    return {
        "metric": "decode_tokens_per_second",
        "value": round(total_tokens / wall, 2),
        "unit": "tok/s",
        "total_tokens": total_tokens,
        "wall_s": round(wall, 2),
        "decode_wall_s": round(eng.decode_wall_s, 2),
        "prefill_wall_s": round(eng.prefill_wall_s, 2),
        "decode_only_tok_s": round(
            (total_tokens - len(reqs)) / max(eng.decode_wall_s, 1e-9), 2),
        "ttft_p50_s": round(float(np.percentile(ttft, 50)), 3),
        "ttft_p90_s": round(float(np.percentile(ttft, 90)), 3),
        "ttft_p99_s": round(float(np.percentile(ttft, 99)), 3),
        "arrival_rate": args.arrival_rate,
        "config": {
            "model": cfg.name, "w_bits": args.w_bits, "kv_bits": args.kv_bits,
            "a_bits": args.a_bits if eng.a8_active else 16,
            "a_bits_requested": args.a_bits,
            "slots": args.max_slots, "decode_chunk": args.decode_chunk,
            "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens,
            "n_requests": args.n_requests, "device": str(device),
            "page_alloc": eng.pt.backend,
            "kv_equalizers": ("checkpoint" if ckpt_eq is not None and k_eq is not None
                              else "calibrated" if k_eq is not None else None),
            "kv_equalize_s": kv_eq_s,
            "parallel": parallel,
            "decode_steps": eng.steps,
            "launches": launches,  # kernel launches of the measured run (CUDA only)
        },
    }


def _rank_main(argv) -> dict:
    """One spawned rank of ``main``: the metrics of ``run`` (the process
    group is already joined)."""
    logging.basicConfig(level=logging.INFO if int(os.environ.get("RANK", 0)) == 0
                        else logging.WARNING)
    return run(build_parser().parse_args(argv))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    world = args.mesh_data * args.mesh_model  # no mesh without --mesh_model, as in tgq
    if args.distributed or world <= 1:
        res = run(args)
        if int(os.environ.get("RANK", 0)) == 0:
            print(json.dumps(res))
        return 0
    from tgq_torch.parallel.launch import spawn

    res = spawn(_rank_main, world, args=(argv,), device=args.device)
    out = res[0]
    out["config"]["rank_launches"] = [r["config"]["launches"] for r in res]
    out["config"]["rank_decode_steps"] = [r["config"]["decode_steps"] for r in res]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
