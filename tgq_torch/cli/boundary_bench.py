"""``python -m tgq_torch.cli.boundary_bench`` — the price of one more
kernel launch in the decode step's matmuls (mirrors
``tgq/cli/boundary_bench.py``).

The same packed-weight matmul work (K3 on CUDA) runs as 1, 2, 4 or 8
launches over out-column slices of one Qwen3-8B decode weight: the same
operations and the same weight bytes, only the number of launches
changes.  The least-squares slope of the time against (splits - 1) is the
cost of one launch boundary; times 36 layers it prices fusing launches
(or capturing the step in a CUDA graph) before building it.  In decode
regime one K3 call can be two launches (the split-K sum), so a boundary
here is one ``quantized_matmul`` call.

Device times come from ``tgq_torch.utils.timing.cuda_ms`` (CUDA events
behind a spin kernel, so the events bracket the device's work, not the
host's dispatch); with ``--device cpu`` the plain version is timed on
the host's clock.  Weights come from numpy (``default_rng(0)``) as in the
JAX tool.

Usage: python -m tgq_torch.cli.boundary_bench [--tokens 128] [--reps 32] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

SHAPES = {  # qwen3-8b decode matmuls (in, out)
    "qkv": (4096, 6144),
    "o": (4096, 4096),
    "gate_up": (4096, 24576),
    "down": (12288, 4096),
}


def make_packed(rng, n: int, m: int, bits: int, group: int, device):
    """A (m, n) PackedLinear of random codes, scales in [0.005, 0.025) and
    a mid-range zero, drawn from ``rng`` as the JAX tool draws them."""
    from tgq_torch.core.packing import PackedLinear
    from tgq_torch.core.quant import QuantSpec

    q = rng.integers(0, 2 ** bits, size=(m, n), dtype=np.int32)
    ng = n // group
    scale = (rng.random((m, ng)) * 0.02 + 0.005).astype(np.float32)
    zero = np.full((m, ng), float(2 ** (bits - 1)), np.float32)
    spec = QuantSpec(bits=bits, group_size=group, sym=False)
    return PackedLinear.from_codes(torch.from_numpy(q).to(device),
                                   torch.from_numpy(scale).to(device),
                                   torch.from_numpy(zero).to(device), spec)


def split_out(w, parts: int) -> list:
    """``parts`` out-column slices of a PackedLinear (codes, scale and zero
    are K-major, so an out slice is a column slice; groups run along the
    inputs and stay whole)."""
    step = w.out_features // parts
    return [dataclasses.replace(w, codes=w.codes[:, sl].contiguous(),
                                scale=w.scale[:, sl].contiguous(),
                                zero=w.zero[:, sl].contiguous(), out_features=step)
            for sl in (slice(i * step, (i + 1) * step) for i in range(parts))]


def per_boundary(per_split_ms: dict) -> float:
    """Least-squares slope of ms against (splits - 1), in ms."""
    ks = sorted(per_split_ms)
    if len(ks) < 2:
        return 0.0
    return float(np.polyfit([k - 1 for k in ks], [per_split_ms[k] for k in ks], 1)[0])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--splits", default="1,2,4,8")
    ap.add_argument("--shapes", default="qkv,o,gate_up,down")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


@torch.no_grad()
def run(args) -> dict:
    from tgq_torch.kernels.dequant_matmul import quantized_matmul
    from tgq_torch.utils.precision import resolve_device
    from tgq_torch.utils.timing import timer_for

    dev = resolve_device(args.device)
    time_it = timer_for(dev)
    rng = np.random.default_rng(0)
    t = args.tokens
    results = {}
    for name in args.shapes.split(","):
        n, m = SHAPES[name]
        w = make_packed(rng, n, m, args.bits, args.group_size, dev)
        x = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32)).to(dev).to(
            torch.bfloat16)
        per_split = {}
        for parts in (int(s) for s in args.splits.split(",")):
            ws = split_out(w, parts)
            per_split[parts] = time_it(
                lambda: [quantized_matmul(x, wi, out_dtype=torch.bfloat16) for wi in ws],
                reps=args.reps)
            print(f"[boundary] {name:8s} splits {parts}  {per_split[parts]:7.4f} ms/iter",
                  flush=True)
        slope = per_boundary(per_split)
        results[name] = {"per_split_ms": {k: round(v, 4) for k, v in per_split.items()},
                         "per_boundary_us": round(slope * 1e3, 2)}
        print(f"[boundary] {name:8s} per-boundary {slope * 1e3:7.2f} us", flush=True)
    return {"tokens": t, "bits": args.bits, "results": results, "device": str(dev),
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
