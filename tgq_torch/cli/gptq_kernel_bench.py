"""``python -m tgq_torch.cli.gptq_kernel_bench`` — ``quantize_weight`` with
K2 against its plain version (mirrors ``tgq/cli/gptq_kernel_bench.py``).

Times ``quantize_weight`` end to end (the same blockwise loop and
inter-block GEMM; only the in-block sweep differs) with backend
``kernel`` (K2, ``csrc/gptq_block.cu``) and backend ``plain`` on
synthetic W and R at the four Qwen3-8B decoder-module shapes.  On CUDA
both backends run, their codes are compared bit for bit (K2 is bit-exact)
and ``kernel`` is timed with ``tgq_torch.utils.timing.cuda_ms``, ``plain``
by one launch bracketed with CUDA events (it runs for seconds); on the
CPU only ``plain`` runs, on the host's clock.  Prints one JSON line with
seconds per module for each backend.

Usage:  python -m tgq_torch.cli.gptq_kernel_bench [--w_bits 4] [--block_size 1024]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--w_bits", type=int, default=4)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--block_size", type=int, default=1024)
    ap.add_argument("--shapes", type=str,
                    default="4096x4096,6144x4096,24576x4096,4096x12288",
                    help="out_f x in_f list (qwen3-8b: o/qkv/gate_up/down)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _once_ms(fn, dev):
    """(milliseconds, result) of one call: CUDA events on the card, the
    host's clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end), out


@torch.no_grad()
def run(args) -> dict:
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.solver.factorize import FactorResult
    from tgq_torch.solver.gptq_loop import quantize_weight
    from tgq_torch.utils.precision import resolve_device
    from tgq_torch.utils.timing import cuda_ms

    dev = resolve_device(args.device)
    spec = QuantSpec(bits=args.w_bits, group_size=args.group_size, sym=False)
    backends = ["plain"] + (["kernel"] if dev.type == "cuda" else [])
    results: dict[str, dict[str, float]] = {b: {} for b in backends}
    bit_equal: dict[str, bool] = {}
    for shape in args.shapes.split(","):
        out_f, in_f = (int(v) for v in shape.split("x"))
        gen = torch.Generator(device=dev).manual_seed(out_f + in_f)
        w = torch.randn((out_f, in_f), generator=gen, device=dev) * 0.05
        # a synthetic upper-triangular R with a unit diagonal: the sweep's
        # cost depends on the shapes, not the values
        r_np = np.triu(np.random.default_rng(0).standard_normal(
            (in_f, in_f)).astype(np.float32) * 0.02)
        np.fill_diagonal(r_np, 1.0)
        stats = FactorResult(r_full=torch.from_numpy(r_np).to(dev),
                             perm=np.arange(in_f, dtype=np.int64), rank=in_f, r_x=None)
        codes = {}
        for backend in backends:
            def fn(backend=backend):
                return quantize_weight(w, stats, spec, block_size=args.block_size,
                                       backend=backend, with_error=False)

            if backend == "kernel":
                codes[backend] = fn().codes
                ms = cuda_ms(fn, reps=3)
            else:  # seconds a module: one run, whose codes are kept
                ms, out = _once_ms(fn, dev)
                codes[backend] = out.codes
            results[backend][shape] = round(ms / 1e3, 4)
            print(f"[gptq_kernel_bench] {shape:12s} {backend:6s} {ms / 1e3:9.4f}s", flush=True)
        if "kernel" in codes:
            bit_equal[shape] = bool(torch.equal(codes["kernel"], codes["plain"]))
        del w, stats, codes

    summary = {"metric": "gptq_block_kernel_seconds", "unit": "s/module",
               "block_size": args.block_size, "w_bits": args.w_bits, "results": results}
    if "kernel" in results:
        tot_p = sum(results["plain"].values())
        tot_k = sum(results["kernel"].values())
        summary.update(plain_total_s=round(tot_p, 3), kernel_total_s=round(tot_k, 3),
                       kernel_speedup=round(tot_p / max(tot_k, 1e-9), 3),
                       codes_bit_equal=bit_equal, kind=torch.cuda.get_device_name(dev))
    return summary


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
