"""K6-bwd variants and knockouts on the card: the gradients of the causal
flash attention timed as they are, with one design choice undone and with
one part removed, at the training shapes, so the time left names what
bounds them.

    python3 -m tgq_torch.kernels.sweep_k6_bwd      # on a machine with the GPU
    python3 -m tgq_torch.kernels.sweep_k6_bwd --variants "none,no exp2"

Each variant is ``csrc/causal_attention_bwd.cu`` with one piece of source
replaced, compiled beside ``csrc/causal_attention.cu`` (K6, whose output
and stats the backward reads) into a library of its own under
``_build/sweep6b/`` (all nvcc runs started together) and called through
``causal_attention_bwd.flash_causal_attention_bwd`` with that library in
place of the built one.  Design variants (checked against the plain
backward, their max err / tolerance printed): ``step 64 at d 128`` (the dK
/ dV kernel's query steps of 64 rows, as at d 64, in place of 32: ptxas
spills), ``dO and V from shared memory at d 64`` (read by each dP and dPᵀ
product, as at d 128, instead of held as register A operands as Q and K
are), ``dO and V in registers at d 128`` (as at d 64: ptxas spills),
``divergent
warpgroup index`` (the index read from threadIdx without a shuffle, so
ptxas serialises the wgmmas), ``no ping-pong`` (the consumers issue their
products without taking turns), ``round robin`` (a block's items in the
same order every round, not a snake), ``one block an item`` (a grid of every
work item in place of one persistent block an SM).  Knockouts (wrong
output by design; only the time is read): ``dQ kernel only`` and ``dK / dV
kernel only`` (the other launch left out: the two kernels' shares), ``no
di loads`` (the dQ kernel reads no o and dO for di: di is 0), ``no
exp2`` (p is the exponent as it came, in both kernels).  Prints per variant
ptxas's registers, spills and wgmma-serialisation warnings of the wgmma
kernels, then device microseconds a launch at each shape; the card's name
and power limit first.  Tuning only: the port never calls this.
"""
from __future__ import annotations

import argparse
import math
import re
import subprocess

import torch

from tgq_torch.kernels import _build
from tgq_torch.kernels import causal_attention as K6
from tgq_torch.kernels import causal_attention_bwd as KB
from tgq_torch.utils.timing import cuda_ms

SHAPES = (  # (label, batch, tokens, q heads, kv heads, head_dim): chip_smoke.K6_BWD_SHAPES
    ("calibration", 8, 2048, 32, 8, 128),
    ("GPT-2", 8, 1024, 12, 12, 64),
    ("OPT-1.3b", 8, 2048, 32, 32, 64),
)
CHECKS = ((2, 300, 32, 8, 128), (2, 1000, 12, 12, 64), (1, 77, 4, 2, 128))

_WG = "const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);"
DESIGN = {
    "none": [],
    "step 64 at d 128": [("static constexpr int BQ = D == 128 ? 32 : 64;\n",
                          "static constexpr int BQ = 64;\n")],
    "dO and V from shared memory at d 64": [
        ("static constexpr bool DO_REGS = D == 64;", "static constexpr bool DO_REGS = false;"),
        ("static constexpr bool V_REGS = D == 64;", "static constexpr bool V_REGS = false;")],
    "dO and V in registers at d 128": [
        ("static constexpr bool DO_REGS = D == 64;", "static constexpr bool DO_REGS = true;"),
        ("static constexpr bool V_REGS = D == 64;", "static constexpr bool V_REGS = true;")],
    "divergent warpgroup index": [(_WG, "const int wg = threadIdx.x / 128;")],
    "no ping-pong": [("    bar_sync(1 + c, 256);\n", ""),
                     ("    if (pass) bar_arrive(2 - c, 256);\n", ""),
                     ("  if (w.c == 1) bar_arrive(1, 256);  // consumer 0 takes the first turn\n",
                      "")],
    "round robin": [("  return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : "
                     "(int)blockIdx.x);", "  return r * (int)gridDim.x + (int)blockIdx.x;")],
    "one block an item": [("const int gq = (int)(n_dq < sms[device] ? n_dq : sms[device]);",
                           "const int gq = (int)n_dq;"),
                          ("const int gk = (int)(n_dkv < sms[device] ? n_dkv : sms[device]);",
                           "const int gk = (int)n_dkv;")],
}
KNOCKOUTS = {
    "dQ kernel only": [
        ("  kdkv<<<gk, THREADS, PK::SMEM, stream>>>(nq_, ndo, nk_, nv, mdk, mdv, "
         "Dims{a, B, (int)nk});\n", "")],
    "dK / dV kernel only": [
        ("  kdq<<<gq, THREADS, PQ::SMEM, stream>>>(mq, mdo, mk, mv, mdq, Dims{a, B, (int)nq});\n",
         "")],
    "no di loads": [("    for (int m = 0; m < D / 16; ++m) ov[m] = ",
                     "    for (int m = 0; m < 0; ++m) ov[m] = "),
                    ("    for (int m = 0; m < D / 16; ++m) {\n      const int f = half",
                     "    for (int m = 0; m < 0; ++m) {\n      const int f = half")],
    "no exp2": [("float p = ex2(fmaf(s[4 * i + e], scale_log2, -lr[e >> 1]));",
                 "float p = fmaf(s[4 * i + e], scale_log2, -lr[e >> 1]);"),
                ("float p = ex2(fmaf(st[4 * i + e], scale_log2, -l));",
                 "float p = fmaf(st[4 * i + e], scale_log2, -l);")],
}


def _nvcc(src, obj):
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build.COMMON, "-Xptxas=-v", "-I", str(_build.CSRC),
         "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def summary(report: str) -> str:
    """Registers, spills and serialisation warnings of the wgmma kernels."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if "wgmma" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and m:
            kind = "dq" if "attention_bwd_dq" in name else "dkv"
            d = re.search(r"ILi(\d+)E", name).group(1)
            out.append(f"{kind} d {d}: spills {m.group(1)}/{m.group(2)}")
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out[-1] += f", {m.group(1)} registers"
            name = None
    serial = sum("wgmma.mma_async instructions are serialized" in ln
                 for ln in report.splitlines())
    return "; ".join(out) + f"; serialisation warnings {serial}"


def build(variants: dict) -> dict:
    """{name: (loaded library, ptxas summary)}, all nvcc runs started together."""
    out = _build.BUILD_ROOT / "sweep6b"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "causal_attention_bwd.cu").read_text()
    fwd = out / "k6.o"
    procs = {None: _nvcc(_build.CSRC / "causal_attention.cu", fwd)}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            assert old in src, (name, old)
            src = src.replace(old, new)
        stem = re.sub(r"\W+", "_", f"k6b_{name}", flags=re.ASCII)
        (out / f"{stem}.cu").write_text(src)
        procs[name] = _nvcc(out / f"{stem}.cu", out / f"{stem}.o")
    reports = {}
    for name, p in procs.items():
        report, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{report}")
        reports[name] = report
    libs = {}
    for name in variants:
        stem = re.sub(r"\W+", "_", f"k6b_{name}", flags=re.ASCII)
        so = out / f"lib{stem}.so"
        link = subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", str(fwd),
                               str(out / f"{stem}.o"), "-o", str(so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed on the {name} variant:\n{link.stdout}")
        libs[name] = (_build.load(so), summary(reports[name]))
    return libs


def with_lib(lib, fn):
    real = _build._lib
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = real


def inputs(gen, dev, b, s, h, kv, d):
    """q, k, v, K6's o and stats, and a cotangent, bf16 from ``gen``."""
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).bfloat16() for _ in range(2))
    o, lse = K6._forward(q, k, v, 1.0 / math.sqrt(d), stats=True)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    return q, k, v, o, lse, do


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma-separated variant names (all by default)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape labels (all by default)")
    args = ap.parse_args()
    every = {**DESIGN, **KNOCKOUTS}
    names = list(every) if args.variants is None else args.variants.split(",")
    shapes = [s for s in SHAPES if args.shapes is None or s[0] in args.shapes.split(",")]
    libs = build({n: every[n] for n in names})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = (K6.launches, KB.launches)
    for name, (lib, summ) in libs.items():
        line = f"K6-bwd {name}: {summ}"
        if name in DESIGN:
            worst = 0.0
            for b, s, h, kv, d in CHECKS:
                q, k, v, o, lse, do = with_lib(lib, lambda: inputs(gen, dev, b, s, h, kv, d))
                got = with_lib(lib, lambda: KB.flash_causal_attention_bwd(q, k, v, o, lse, do))
                torch.cuda.synchronize()
                ref = KB.causal_attention_bwd_plain(q, k, v, o, lse, do)
                tol = KB.bwd_tolerance(q, k, v, do, ref)
                worst = max([worst] + [float(((g.float() - r).abs() / t).max())
                                       for g, r, t in zip(got, ref, tol)])
            line += f"; max err / tolerance {worst:.3f}"
        print(line, flush=True)
    for label, b, s, h, kv, d in shapes:
        q, k, v, o, lse, do = with_lib(next(iter(libs.values()))[0],
                                       lambda: inputs(gen, dev, b, s, h, kv, d))

        def us(lib):
            return 1000 * with_lib(lib, lambda: cuda_ms(
                lambda: KB.flash_causal_attention_bwd(q, k, v, o, lse, do), reps=5))

        cells = [f"{name}: {us(lib):.1f}" for name, (lib, _) in libs.items()]
        print(f"K6-bwd {label} ({b}, {s}, {h}/{kv}, {d}) us: " + "; ".join(cells), flush=True)
    K6.launches, KB.launches = before


if __name__ == "__main__":
    main()
