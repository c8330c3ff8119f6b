"""``python -m tgq_torch.cli.serve`` — serving entry point and throughput
harness (mirrors ``tgq/cli/serve.py``, single device).

Loads a packed checkpoint (``--checkpoint``) or makes a preset with random
RTN-packed weights, drives the continuous-batching engine with synthetic
prompts (one warm-up wave, then the measured run, closed-loop or with
Poisson arrivals), and prints one JSON line of metrics: tokens/s,
decode-only tokens/s, TTFT percentiles, decode and prefill wall time.
Runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

_QUEUED = "is queued in ROADMAP.md (queue 1)"


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


def _measured_run(eng, prompts, arrival_rate: float, rng, sync):
    """The measured run: every prompt at once (closed loop), or Poisson
    arrivals at ``arrival_rate`` req/s driving ``Engine.step``.  Returns
    (requests, wall seconds)."""
    if arrival_rate > 0:
        gaps = rng.exponential(1.0 / arrival_rate, size=len(prompts))
        t0 = time.time()
        arrivals = t0 + np.cumsum(gaps)
        reqs, i = [], 0
        while i < len(prompts) or not eng.idle:
            now = time.time()
            while i < len(prompts) and arrivals[i] <= now:
                reqs.append(eng.submit(prompts[i]))
                i += 1
            if eng.idle and i < len(prompts):
                time.sleep(max(0.0, arrivals[i] - time.time()))
                continue
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
                    help="calibrate KV equalizers (queued)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival_rate", type=float, default=0.0,
                    help="open loop: Poisson arrivals at this rate (req/s); 0 = closed loop")
    ap.add_argument("--profile_dir", default=None,
                    help="torch.profiler trace of the measured run, written to "
                         "<dir>/trace.json")
    ap.add_argument("--mesh_model", type=int, default=0, help="TP degree (queued)")
    ap.add_argument("--mesh_data", type=int, default=1, help="data-parallel degree (queued)")
    ap.add_argument("--distributed", action="store_true", help="multi-host (queued)")
    return ap


def run(args) -> dict:
    """Load or make the model, drive the engine (one warm-up wave, then
    the measured run) and return the metrics dict."""
    from tgq_torch.serve import Engine, ServeConfig
    from tgq_torch.utils.precision import resolve_device

    for flag, on in (("--mesh_model", args.mesh_model), ("--mesh_data", args.mesh_data != 1),
                     ("--distributed", args.distributed), ("--kv_equalize", args.kv_equalize)):
        if on:
            raise NotImplementedError(f"{flag} {_QUEUED}")
    device = resolve_device(args.device)
    params, cfg, ckpt_eq = load_or_make_model(args, device)
    k_eq = v_eq = None
    if ckpt_eq is not None and args.kv_bits < 16:
        k_eq, v_eq = ckpt_eq
        logging.info("[kv-eq] using checkpoint-stored per-channel equalizers")
    max_pages_per_slot = -(-(args.prompt_len + args.gen_tokens + args.page_size)
                           // args.page_size)
    num_pages = args.num_pages or args.max_slots * max_pages_per_slot + 1
    scfg = ServeConfig(
        max_slots=args.max_slots, page_size=args.page_size, num_pages=num_pages,
        max_pages_per_slot=max_pages_per_slot, max_new_tokens=args.gen_tokens,
        temperature=args.temperature, seed=args.seed, decode_chunk=args.decode_chunk,
        kv_bits=args.kv_bits, kv_k_eq=k_eq, kv_v_eq=v_eq,
        prefill_chunk_tokens=args.prefill_chunk_tokens, a_bits=args.a_bits)
    eng = Engine(params, cfg, scfg, device=device)
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

    with device_trace(args.profile_dir, cuda=device.type == "cuda"):
        reqs, wall = _measured_run(eng, prompts, args.arrival_rate, rng, sync)

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
        },
    }


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
