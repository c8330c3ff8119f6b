"""``python -m tgq_torch.cli.decode_bench`` — a decode step split into its
parts (mirrors ``tgq/cli/decode_bench.py``).

Times each part of the serving decode step alone at real serving shapes,
over all layers: K5 (paged decode attention), the four packed matmuls of
every layer (K3, or K4 under ``--a_bits 8``), the packed head, the KV
write of one token for all layers (``kv_write_token_all``) and sampling.
Then the whole step as ``decode_steps`` runs it: the wall time of a chunk
of ``reps`` steps, ended by fetching its tokens, per step (the median of
five chunks after a warm one, the garbage collector off).  The parts are device times: the
head, the KV write and sampling by ``tgq_torch.utils.timing.cuda_ms``
(CUDA events behind a spin kernel), the 36-layer attention and matmuls
by ``busy_ms`` (the kernels' durations from ``torch.profiler``: hundreds
of launches outrun the launch queue a spin kernel can hold, and events
would time the host).  On the port the gap between their sum and the
whole step is the host's dispatch of the step's launches.  With ``--device cpu`` everything runs the plain versions on
the host's clock.  Prints one JSON line.

Usage:
  python -m tgq_torch.cli.decode_bench --model_id qwen3-8b --slots 128 \\
      --context 256 --page_size 64
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_id", default="qwen3-8b")
    ap.add_argument("--w_bits", type=int, default=4)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--slots", type=int, default=128)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--page_size", type=int, default=64)
    ap.add_argument("--kv_bits", type=int, default=8, choices=(16, 8, 4))
    ap.add_argument("--a_bits", type=int, default=16, choices=(16, 8),
                    help="activation precision for the packed matmuls")
    ap.add_argument("--lm_head_bits", type=int, default=8, choices=(16, 8))
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--skip_components", action="store_true",
                    help="measure only the composed decode_steps path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chunk_ms(fn, n: int, chunks: int = 5, between=None) -> float:
    """Host-clock milliseconds per step of ``fn(n)``, a chunk of n steps
    that ends in a fetch: the median of ``chunks`` chunks after a warm one,
    timed with the garbage collector off (as ``timeit`` times).
    ``between()``, if given, runs after each timed chunk, untimed."""
    fn(n)
    walls = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(chunks):
            t0 = time.perf_counter()
            fn(n)
            walls.append((time.perf_counter() - t0) * 1e3 / n)
            if between is not None:
                between()
    finally:
        gc.enable()
    return sorted(walls)[len(walls) // 2]


@torch.no_grad()
def run(args, between=None) -> dict:
    """The JSON line's dict.  ``between()``, if given, runs after each of
    the whole step's timed chunks (a caller's own measurement, interleaved
    with them so that both see the same host)."""
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.kernels.paged_attention import paged_decode_attention
    from tgq_torch.models.causal_lm import apply_linear, glu_act, lm_logits
    from tgq_torch.models.config import PRESETS
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.serve.decode import _sample_tokens, decode_steps, fuse_packed_projections
    from tgq_torch.serve.engine import _mark_act_bits
    from tgq_torch.serve.kv_cache import PagedKVCache, kv_write_token_all
    from tgq_torch.utils.precision import resolve_device
    from tgq_torch.utils.timing import busy_ms, cuda_ms, host_ms

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = PRESETS[args.model_id]
    spec = QuantSpec(bits=args.w_bits, group_size=args.group_size, sym=False)
    slots, page = args.slots, args.page_size
    mpps = -(-args.context // page)
    if args.context - args.reps - 1 < 1:
        raise ValueError("--context must exceed --reps + 1 (the composed step's headroom)")
    params = init_packed_params(cfg, spec, seed=0, lm_head_bits=args.lm_head_bits, device=dev)
    if args.a_bits == 8:
        params, _ = _mark_act_bits(params, 8)
    params = fuse_packed_projections(params)
    layers = params["model"]["layers"]
    cache = PagedKVCache.init(cfg, slots * mpps + 1, page, kv_bits=args.kv_bits, device=dev)
    table = torch.arange(1, 1 + slots * mpps, dtype=torch.int32, device=dev).reshape(slots, mpps)
    lens = torch.full((slots,), args.context, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    L, kvh, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    results: dict[str, float] = {}

    def part(key: str, label: str, fn, reps: int, launches: str = "few") -> None:
        time_it = (busy_ms if launches == "many" else cuda_ms) if on_card else host_ms
        ms = time_it(fn, reps=reps)
        results[key] = round(ms, 4)
        print(f"[decode_bench] {label}: {ms:9.4f} ms/step", flush=True)

    if not args.skip_components:
        quantized = cache.ks is not None
        q0 = torch.randn((slots, cfg.num_heads, d), generator=gen, device=dev) * 0.1

        def attention():
            for li in range(L):
                paged_decode_attention(
                    q0, cache.k[li], cache.v[li], cache.ks[li] if quantized else None,
                    cache.vs[li] if quantized else None, lens, table, num_kv_heads=kvh)

        part("attention_ms", f"attention x{L}", attention, args.reps, launches="many")

        h0 = torch.randn((slots, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)

        def matmuls():
            for lp in layers:
                sa, mlp = lp["self_attn"], lp["mlp"]
                q = apply_linear(sa["qkv_proj"], h0)[:, :cfg.q_size]
                apply_linear(sa["o_proj"], q)
                g, u = apply_linear(mlp["gate_up_proj"], h0).chunk(2, dim=-1)
                apply_linear(mlp["down_proj"], glu_act(g, u))

        part("matmuls_ms", f"matmuls x{L}", matmuls, max(args.reps // 2, 1), launches="many")

        x0 = torch.randn((slots, 1, cfg.hidden_size), generator=gen, device=dev).to(
            torch.bfloat16)
        part("lm_head_ms", "lm_head", lambda: lm_logits(params, cfg, x0), args.reps)

        kv = torch.randn((L, slots, kvh, d), generator=gen, device=dev)
        pos = lens - 1
        pages = table[torch.arange(slots, device=dev), (pos // page).long()]
        offs = pos % page
        part("kv_write_ms", "kv_write(all)",
             lambda: kv_write_token_all(cache, pages, offs, kv, kv), args.reps)

        temps = torch.zeros((slots,), device=dev)
        lg0 = torch.randn((slots, cfg.vocab_size), generator=gen, device=dev)
        part("sampling_ms", "sampling", lambda: _sample_tokens(lg0, temps, gen), args.reps)

    # the composed step through decode_steps: lens mid-context, so that
    # lens + reps stays within the table
    temps_all = torch.zeros((slots,), device=dev)
    toks0 = torch.ones((slots,), dtype=torch.int32, device=dev)
    lens_c = torch.full((slots,), args.context - args.reps - 1, dtype=torch.int32, device=dev)
    live = torch.ones((slots,), dtype=torch.int32, device=dev)

    def run_steps(n: int) -> int:
        toks, _ = decode_steps(params, cache, cfg, table, lens_c + 1, toks0, lens_c, temps_all,
                               gen, n, greedy_only=True, live=live)
        return int(toks[-1, 0])  # the fetch waits for the chunk

    _sync(dev)
    ms = _chunk_ms(run_steps, args.reps, between=between)
    results["composed_ms"] = round(ms, 4)
    print(f"[decode_bench] composed step: {ms:9.4f} ms/step ({slots / ms * 1e3:.0f} tok/s)",
          flush=True)

    config = {"model": args.model_id, "slots": slots, "context": args.context,
              "page_size": page, "w_bits": args.w_bits, "kv_bits": args.kv_bits,
              "a_bits": args.a_bits, "lm_head_bits": args.lm_head_bits, "layers": L,
              "device": str(dev),
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if args.skip_components:
        # a component total of 0 would be a misleading record
        return {"metric": "decode_step_composed_ms", "value": results["composed_ms"],
                "unit": "ms", "config": config}
    total = sum(v for k, v in results.items() if k != "composed_ms")
    return {"metric": "decode_step_component_ms", "value": round(total, 4), "unit": "ms",
            "config": config, "components": results}


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
