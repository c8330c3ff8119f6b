"""``python -m tgq_torch.cli.serve_soak`` — serving soak (mirrors
``scripts/serve_soak.py``).

Mixed prompt lengths, temperatures and an EOS token through the
continuous-batching engine, with ``submit`` interleaved with
``Engine.step()``.  Checks that every request ends within its budget
(1 <= len(output) <= max_new_tokens) and that the page allocator returns
to its starting free count: no page leaked or freed twice across
admission, speculation and retirement mid-chunk.  The defaults are the
JAX script's (Qwen3-8B W4 g128 with random weights, an 8-bit head, 128
slots, page 64, int8 KV, W4A8 matmuls, decode chunk 16, EOS 7, 512
requests).  Prints one JSON line; exits non-zero when a check fails.
Runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_id", default="qwen3-8b")
    ap.add_argument("--checkpoint", default=None, help="packed checkpoint dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--w_bits", type=int, default=4)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--lm_head_bits", type=int, default=8, choices=(16, 8))
    ap.add_argument("--n_requests", type=int, default=512)
    ap.add_argument("--max_slots", type=int, default=128)
    ap.add_argument("--page_size", type=int, default=64)
    ap.add_argument("--max_pages_per_slot", type=int, default=8)
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--kv_bits", type=int, default=8, choices=(16, 8, 4))
    ap.add_argument("--a_bits", type=int, default=8, choices=(16, 8))
    ap.add_argument("--decode_chunk", type=int, default=16)
    ap.add_argument("--eos_id", type=int, default=7)
    ap.add_argument("--prefill_chunk_tokens", type=int, default=4096)
    ap.add_argument("--page_alloc", default="auto", choices=("auto", "native", "python"))
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args) -> dict:
    """Drive the soak; returns its summary (``ok`` False when a check failed)."""
    import torch

    from tgq_torch.cli.serve import load_or_make_model
    from tgq_torch.serve import Engine, ServeConfig
    from tgq_torch.utils.precision import resolve_device

    device = resolve_device(args.device)
    params, cfg, _ = load_or_make_model(args, device)
    slots = args.max_slots
    scfg = ServeConfig(max_slots=slots, page_size=args.page_size,
                       num_pages=slots * args.max_pages_per_slot + 1,
                       max_pages_per_slot=args.max_pages_per_slot,
                       max_new_tokens=args.max_new_tokens, kv_bits=args.kv_bits,
                       a_bits=args.a_bits, decode_chunk=args.decode_chunk, eos_id=args.eos_id,
                       prefill_chunk_tokens=args.prefill_chunk_tokens, seed=args.seed,
                       page_alloc=args.page_alloc)
    eng = Engine(params, cfg, scfg, device=device)
    del params
    free0 = eng.pt.num_free
    rng = np.random.default_rng(args.seed)
    reqs = []
    t0 = time.time()
    for i in range(args.n_requests):
        plen = int(rng.integers(8, 384))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        temp = float(rng.choice([0.0, 0.0, 0.0, 0.8]))
        mnt = int(rng.integers(4, 64))
        reqs.append(eng.submit(prompt, max_new_tokens=mnt, temperature=temp))
        if i % 16 == 15:  # interleave submission with engine ticks
            eng.step()
    while not eng.idle:
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.output) for r in reqs)
    bad = [r.rid for r in reqs if not r.output or len(r.output) > r.max_new_tokens]
    eos = sum(1 for r in reqs if r.output and r.output[-1] == args.eos_id
              and len(r.output) < r.max_new_tokens)
    return {
        "metric": "serve_soak", "ok": done == args.n_requests and not bad
        and eng.pt.num_free == free0,
        "done": done, "n_requests": args.n_requests, "tokens": toks,
        "wall_s": round(wall, 2), "tok_s": round(toks / wall, 2), "bad": bad[:5],
        "ended_by_eos": eos, "free_pages": eng.pt.num_free, "free_pages_start": free0,
        "page_alloc": eng.pt.backend, "a8_active": eng.a8_active,
        "config": {"model": cfg.name, "layers": cfg.num_layers, "slots": slots,
                   "page_size": args.page_size, "kv_bits": args.kv_bits,
                   "a_bits": args.a_bits, "decode_chunk": args.decode_chunk,
                   "eos_id": args.eos_id, "device": str(device)},
    }


def main(argv=None) -> int:
    res = run(build_parser().parse_args(argv))
    print(json.dumps(res), flush=True)
    if res["ok"]:
        print("PAGES BALANCED; SOAK OK")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
