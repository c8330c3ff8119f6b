"""``python -m tgq_torch.cli.kernel_bench`` — the packed-weight matmul
against the card's memory rate (mirrors ``tgq/cli/kernel_bench.py``).

A decode-shape matmul is bound by streaming its packed weights once
(bits/8 bytes a weight plus an f32 scale and zero a group).  This times
K3 (``--a_bits 16``) or K4 on pre-quantized int8 activations (``--a_bits
8``, the kernel alone; the activation quantization is timed apart) at a
preset's four decode shapes, and reports the weight bytes per second and
their fraction of the H100's 3.35 TB/s (NVIDIA's data sheet).  Device
times come from ``tgq_torch.utils.timing.cuda_ms`` (CUDA events behind a
spin kernel); with ``--device cpu`` the plain versions are timed on the
host's clock.  A reading above 1.2x the peak is skipped as unstable, as in
the JAX tool; when every shape is skipped the JSON line says so instead
of averaging nothing.

Usage:
  python -m tgq_torch.cli.kernel_bench --model_id qwen3-8b --w_bits 4 --tokens 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

PEAK_GBPS = 3350.0  # H100 SXM HBM3, NVIDIA data sheet


def weight_bytes(in_f: int, out_f: int, bits: int, group: int) -> int:
    codes = in_f * out_f * bits // 8
    scales = 2 * (in_f // group) * out_f * 4  # f32 scale + zero
    return codes + scales


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_id", default="qwen3-8b")
    ap.add_argument("--w_bits", type=int, default=4)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=16, help="decode batch (token count)")
    ap.add_argument("--a_bits", type=int, default=16, choices=(16, 8),
                    help="8: time K4 (W4A8) on the same shapes")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--peak_gbps", type=float, default=0.0,
                    help="0 = the H100's 3350 GB/s")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def shapes(cfg) -> dict:
    """name → (in_features, out_features), the JAX tool's four shapes."""
    return {
        "qkv_fused_equiv(q)": (cfg.hidden_size, cfg.q_size),
        "o_proj": (cfg.q_size, cfg.hidden_size),
        "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
        "down_proj": (cfg.intermediate_size, cfg.hidden_size),
    }


@torch.no_grad()
def run(args) -> dict:
    from tgq_torch.core.packing import PackedLinear
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.kernels import dequant_matmul as KD
    from tgq_torch.models.config import PRESETS
    from tgq_torch.utils.precision import resolve_device
    from tgq_torch.utils.timing import timer_for

    if args.a_bits == 8 and args.w_bits not in (2, 3, 4):
        raise ValueError("--a_bits 8 (K4) takes --w_bits 2, 3 or 4")
    dev = resolve_device(args.device)
    time_it = timer_for(dev)
    cfg = PRESETS[args.model_id]
    spec = QuantSpec(bits=args.w_bits, group_size=args.group_size, sym=False)
    peak = args.peak_gbps or PEAK_GBPS
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, unstable = [], []
    for name, (in_f, out_f) in shapes(cfg).items():
        codes = torch.randint(0, spec.max_q + 1, (out_f, in_f), generator=gen, device=dev,
                              dtype=torch.int32)
        scale = torch.ones((out_f, max(in_f // args.group_size, 1)), device=dev)
        w = PackedLinear.from_codes(codes, scale, torch.zeros_like(scale), spec)
        x = torch.randn((args.tokens, in_f), generator=gen, device=dev).to(torch.bfloat16)
        row_extra = {}
        if args.a_bits == 8:
            w = dataclasses.replace(w, act_bits=8)
            x8, a = KD.quantize_activations(x)
            if dev.type == "cuda":
                ms = time_it(lambda: KD.a8_matmul(x8, a, w, out_dtype=torch.bfloat16),
                             reps=args.reps)
            else:
                ms = time_it(lambda: KD.a8_matmul_plain(x8, a, w), reps=args.reps)
            row_extra["quantize_activations_ms"] = round(
                time_it(lambda: KD.quantize_activations(x), reps=args.reps), 4)
        else:
            ms = time_it(lambda: KD.quantized_matmul(x, w), reps=args.reps)
        wb = weight_bytes(in_f, out_f, args.w_bits, args.group_size)
        gbps = wb / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")
        if ms <= 0 or gbps > 1.2 * peak:
            # a non-positive time or one faster than the memory allows
            print(f"[kernel] {name}: unstable timing ({ms:.4f} ms), skipped", flush=True)
            unstable.append(name)
            continue
        rows.append({"shape": f"{name} {in_f}x{out_f}", "ms": round(ms, 4),
                     "weight_GB_s": round(gbps, 1), "frac_peak": round(gbps / peak, 3),
                     **row_extra})
        print(f"[kernel] {name:22s} {in_f:6d}x{out_f:<6d} {ms:8.4f} ms {gbps:8.1f} GB/s "
              f"({100 * gbps / peak:5.1f}% of {peak:.0f})", flush=True)
    config = {"model": args.model_id, "w_bits": args.w_bits, "a_bits": args.a_bits,
              "tokens": args.tokens, "peak_gbps": peak, "device": str(dev),
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if not rows:
        return {"metric": "dequant_matmul_weight_bandwidth", "value": None, "unit": "GB/s",
                "vs_baseline": None, "status": "all shapes unstable", "config": config,
                "shapes": [], "unstable": unstable}
    agg = sum(r["weight_GB_s"] * r["ms"] for r in rows) / sum(r["ms"] for r in rows)
    return {"metric": "dequant_matmul_weight_bandwidth", "value": round(agg, 1),
            "unit": "GB/s", "vs_baseline": round(agg / peak, 3), "config": config,
            "shapes": rows}


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
