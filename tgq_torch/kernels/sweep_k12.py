"""K1 and K2 knockouts on the card: each kernel timed as it is and with one
component removed, at the quantize path's shapes, so the time left names
what a step is made of.

    python3 -m tgq_torch.kernels.sweep_k12      # on a machine with the GPU

Each variant is ``csrc/pchol_panel.cu`` or ``csrc/gptq_block.cu`` with one
piece of source replaced, built (with the source's own flags) into
``_build/sweep12/`` and called through the port's own wrappers
(``pchol_panel.pchol_panel``, ``gptq_block.process_block``) with the
variant library in place of the built one.  ``KNOCKOUTS`` holds the
substitutions for each design of a source; the sweep uses the design
whose strings all occur in the source it finds, so the same file also
measures an older checkout's kernels (copy it into that checkout's
``tgq_torch/kernels/`` and run it there).

K1 (one 128-step panel on an AR(1) Hessian of variances 0.999^i, n =
4096 and 12288, and the same launch with ``steps = 1``, the launch
floor): ``no correction chain`` (the Schur-row sum over earlier steps),
``no grid barrier`` (the cross-block arrival; each block then reads
whatever key it finds), ``no argmax atomic`` (the key's max reduction),
``no pivot-row read`` (a's row at the pivot), ``no pivot-column read``
(the strip's column at the pivot); the first design also had ``no
candidate scan`` (each block takes its own candidate).  K2 (W4 g128,
b = 256, m = 1024 ... 28672): ``no sweep`` (the 32 steps of a
sub-block), ``no divisions`` (both divisions by products), ``no
propagation`` (the update of the later columns), ``no prefetch`` (the
cp.async ring's refill), ``empty`` (the kernel returns at once), and the
unchanged kernel at every row tile that fits (``TM=n``); the first design
had ``no R loads`` (R's row by a constant) in place of the sweep and
prefetch knockouts.  A knocked-out variant's output is wrong by design
(a K1 variant clamps its pivot into range); only its time is read.
Prints device microseconds a launch, and a step's share (launch /
steps), the card's name and power limit first.  Tuning only: the port's
wrappers never call this.
"""
from __future__ import annotations

import re
import subprocess

import torch

from tgq_torch.core.quant import QuantSpec, expand_params, find_params
from tgq_torch.kernels import _build
from tgq_torch.kernels import gptq_block as K2
from tgq_torch.kernels import pchol_panel as K1
from tgq_torch.kernels.sweep_k3 import device_us

_CLAMP_FIRST = ("const int piv = bi;", "const int piv = min(max(bi, 0), n - 1);")
_CLAMP_TILED = ("const int piv = key_index(key);",
              "const int piv = min(max(key_index(key), 0), n - 1);")

# {source: {design: {knockout: [(old, new), ...]}}}
KNOCKOUTS = {
    "pchol_panel.cu": {
        "tiled design (column tiles, strip in shared memory, u64 max keys)": {
            "none": [],
            "no correction chain": [("      for (; t + 8 <= ts; t += 8) {", "      for (t = ts; t < 0;) {"),
                                    ("      for (; t < ts; ++t)\n        acc", "      for (; t < 0; ++t)\n        acc")],
            "no grid barrier": [("      while (ld_acquire(arrived + k) < (unsigned int)G) {\n"
                                 "      }\n", ""), _CLAMP_TILED],
            "no argmax atomic": [("if (lane == 0 && best != 0ull) red_max(keys + k, best);", ""),
                                 _CLAMP_TILED],
            "no pivot-row read": [("c0 < cols ? __ldg(arow + c0) : 0.f", "1.0f")],
            "no pivot-column read": [("s_col[t] = __ldcg(strip_t + (size_t)piv * panel + t);",
                                      "s_col[t] = 0.5f;")],
        },
        "first design (one column a thread, strip in L2)": {
            "none": [("grid_barrier(bar, G);", "grid_barrier(bar, G);")],
            "no correction chain": [(
                "      for (int t = 0; t < k; ++t)\n"
                "        acc = __fadd_rn(acc, __fmul_rn(s_col[t], strip[(size_t)t * n + j]));\n",
                "")],
            "no grid barrier": [("    grid_barrier(bar, G);", "    __syncthreads();"),
                                _CLAMP_FIRST],
            "no pivot-row read": [("__fsub_rn(arow[j], acc)", "__fsub_rn(1.0f, acc)")],
            "no pivot-column read": [("s_col[t] = __ldcg(strip + (size_t)t * n + piv);",
                                      "s_col[t] = 0.5f;")],
            "no candidate scan": [("for (int b = threadIdx.x; b < G; b += blockDim.x) {",
                                   "for (int b = blockIdx.x + threadIdx.x; b <= blockIdx.x; "
                                   "b += blockDim.x) {"), _CLAMP_FIRST],
        },
    },
    "gptq_block.cu": {
        "tiled design (row tiles, 32-column sub-blocks, deferred updates)": {
            "none": [],
            "no sweep": [("    if (sweeper) {\n      const bool live",
                          "    if (false) {\n      const bool live")],
            "no divisions": [("__fdiv_rn(ok ? wk : 1.f, sk)", "__fmul_rn(wk, sk)"),
                             ("__fdiv_rn(ok ? __fmaf_rn(-__fsub_rn(qk, zk), sk, wk) : 1.f, rkk)",
                              "__fmul_rn(__fmaf_rn(-__fsub_rn(qk, zk), sk, wk), rkk)")],
            "no propagation": [("for (int t = tid; t < (tm >> 3) * nq; t += kThreads) {",
                                "for (int t = tid; t < 0; t += kThreads) {")],
            "no prefetch": [("    if (c + 1 < J) load_stage(c + 1);", "")],
            "empty": [("  extern __shared__ __align__(16) float sm[];",
                       "  return;\n  extern __shared__ __align__(16) float sm[];")],
        },
        "first design (one row a warp, R from L1/L2)": {
            "none": [("constexpr int kMaxWarps = 8;", "constexpr int kMaxWarps = 8;")],
            "no R loads": [("__ldg(rrow + j)", "0.5f")],
            "no divisions": [("__fdiv_rn(wk, sk)", "__fmul_rn(wk, sk)"),
                             ("__fdiv_rn(__fmaf_rn(-__fsub_rn(qk, zk), sk, wk), rkk)",
                              "__fmul_rn(__fmaf_rn(-__fsub_rn(qk, zk), sk, wk), rkk)")],
            "no propagation": [("for (int j = k + 1 + lane; j < b; j += 32)",
                                "for (int j = b; j < b; j += 32)")],
            "empty": [("  extern __shared__ float sm[];", "  return;\n  extern __shared__ float sm[];")],
        },
    },
}

K1_SIZES = (4096, 12288)
K2_SIZES = (1024, 4096, 12288, 28672)


def design(source: str) -> tuple[str, dict]:
    """The design of ``source`` whose knockout strings all occur in it."""
    text = (_build.CSRC / source).read_text()
    for label, variants in KNOCKOUTS[source].items():
        if all(old in text for subs in variants.values() for old, _ in subs):
            return label, variants
    raise RuntimeError(f"sweep_k12: no knockout set matches {source}")


def build() -> dict:
    """{(source, knockout): loaded library}, all nvcc runs started together."""
    out = _build.BUILD_ROOT / "sweep12"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in KNOCKOUTS:
        text = (_build.CSRC / source).read_text()
        for name, subs in design(source)[1].items():
            src = text
            for old, new in subs:
                src = src.replace(old, new)
            stem = re.sub(r"\W+", "_", f"{source[:-3]}_{name}", flags=re.ASCII)
            (out / f"{stem}.cu").write_text(src)
            procs[(source, name)] = (stem, subprocess.Popen(
                [_build._nvcc(), *_build.ARCH, *_build.COMMON, *_build.SOURCES[source],
                 "-I", str(_build.CSRC), "-shared", str(out / f"{stem}.cu"),
                 "-o", str(out / f"lib{stem}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (stem, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {key} variant:\n{text}")
        libs[key] = _build.load(out / f"lib{stem}.so")
    return libs


def timed(lib, fn, reps: int = 10) -> float:
    """Device microseconds of ``fn()`` with ``lib`` as the kernel library."""
    real = _build._lib
    _build._lib = lib
    try:
        return device_us(fn, reps=reps)
    finally:
        _build._lib = real


def ar1_hessian(n: int, dev) -> torch.Tensor:
    """AR(1) correlation 0.5 scaled by variances 0.999^i: distinct pivots."""
    i = torch.arange(n, dtype=torch.float64, device=dev)
    s = (0.999 ** i).sqrt()
    return (s[:, None] * 0.5 ** (i[:, None] - i[None, :]).abs() * s[None, :]).float()


def k2_inputs(m: int, b: int, gen, dev):
    spec = QuantSpec(bits=4, group_size=128 if b % 128 == 0 else -1, sym=False)
    w = torch.randn((m, b), generator=gen, device=dev)
    s, z = (t.contiguous() for t in expand_params(find_params(w, spec), b))
    a = torch.randn((b, b), generator=gen, device=dev, dtype=torch.float64) / b ** 0.5
    r = torch.linalg.qr(a)[1]
    r = r * torch.sign(torch.diagonal(r))[:, None] + 0.5 * torch.eye(b, device=dev,
                                                                      dtype=torch.float64)
    return w, s, z, r.float().contiguous(), spec


def main() -> None:
    libs = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    for source in KNOCKOUTS:
        print(f"{source}: {design(source)[0]}", flush=True)
    dev = torch.device("cuda", 0)
    limits = None
    if hasattr(_build, "device_limits"):  # cached here for K2's variants, which lack the query
        limits = _build.device_limits(libs[("pchol_panel.cu", "none")], 0)
    for n in K1_SIZES:
        a = ar1_hessian(n, dev)
        d = torch.diagonal(a).reshape(1, n).contiguous()
        done = torch.zeros((1, n), dtype=torch.float32, device=dev)
        for steps in (128, 1):
            cells = []
            for (src, kn), lib in libs.items():
                if src == "pchol_panel.cu" and (steps == 128 or kn == "none"):
                    us = timed(lib, lambda: K1.pchol_panel(a, d, done, panel=128, steps=steps))
                    cells.append(f"{kn}: {us:.1f} ({us / steps:.2f} a step)")
            print(f"K1 n={n} panel 128 steps={steps} us: " + "; ".join(cells), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m in K2_SIZES:
        w, s, z, r, spec = k2_inputs(m, 256, gen, dev)
        cells = []
        for (src, kn), lib in libs.items():
            if src == "gptq_block.cu":
                us = timed(lib, lambda: K2.process_block(w, s, z, r, spec.min_q, spec.max_q))
                cells.append(f"{kn}: {us:.1f} ({us / 256:.3f} a step)")
        label = ""
        if limits is not None:  # the unchanged kernel at every row tile
            label = f" (planned TM {K2._k2_plan(m, 256, *limits).tm})"
            plan_fn = K2._k2_plan
            for tm in (t for t in K2._K2_TILES if K2._k2_smem(t, 256) <= limits[1]):
                K2._k2_plan = lambda *args, tm=tm: K2.K2Plan(tm, K2._k2_smem(tm, 256))
                try:
                    us = timed(libs[("gptq_block.cu", "none")],
                               lambda: K2.process_block(w, s, z, r, spec.min_q, spec.max_q))
                finally:
                    K2._k2_plan = plan_fn
                cells.append(f"TM={tm}: {us:.1f}")
        print(f"K2 m={m} b=256{label} us: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
