"""K6 variants and knockouts on the card: the causal flash attention timed
as it is, with one design choice undone and with one component removed,
at the main paths' shapes, so the time left names what bounds it.

    python3 -m tgq_torch.kernels.sweep_k6      # on a machine with the GPU

Each variant is ``csrc/causal_attention.cu`` with one piece of source
replaced, built into ``_build/sweep6/`` (all nvcc runs started together)
and called through ``causal_attention.flash_causal_attention`` with the
variant library in place of the built one.  Design variants (checked
against the plain version, their max err / tolerance printed): ``divergent
warpgroup index`` (the index read from threadIdx without a shuffle, so
ptxas serialises the wgmmas), ``one block a tile`` (a grid of every tile
in place of one persistent block an SM), ``no setmaxnreg`` (168 registers
for every warpgroup), ``no diagonal skip`` (the first half's diagonal tile
over all 128 keys, masked; also at d 64 only), ``no ping-pong`` (the
consumers issue their products without taking turns), other ring depths
(K 2 stages; K and V 3 / 2 and 6 / 5 at d 64), ``scaled scores`` (the
scores multiplied by sm_scale·log2 e before the max, then a subtraction,
where the kernel takes the max of raw scores and one FMA).  Knockouts
(wrong output by design; only the time is read): ``no softmax`` (P is S as
it came), ``no exp2``, ``no P·V`` (the second product not issued), ``no
store`` (no TMA store of the output).  Prints per variant ptxas's
registers, spills and wgmma-serialisation warnings, then device
microseconds a launch at each shape; the card's name and power limit
first.  Tuning only: the port never calls this.
"""
from __future__ import annotations

import re
import subprocess

import torch

from tgq_torch.kernels import _build
from tgq_torch.kernels import causal_attention as K6
from tgq_torch.utils.timing import cuda_ms

SHAPES = (  # (label, batch, tokens, q heads, kv heads, head_dim) of the main paths
    ("calibration", 8, 2048, 32, 8, 128),
    ("PPL window", 4, 2048, 32, 8, 128),
    ("GPT-2", 8, 1024, 12, 12, 64),
    ("OPT-1.3b", 8, 2048, 32, 32, 64),
    ("prefill wave", 16, 128, 32, 8, 128),
)

_MASK = ("      if (diag && 8 * i + 2 * tig + (e & 1) > r + (e >> 1) * 8) "
         "s[4 * i + e] = -INFINITY;")
DESIGN = {
    "none": [],
    "divergent warpgroup index": [
        ("const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);",
         "const int wg = threadIdx.x / 128;")],
    "one block a tile": [("const int grid = (int)(n_tiles < sms[device] ? n_tiles : sms[device]);",
                          "const int grid = (int)n_tiles;")],
    "no diagonal skip": [("        turn<S_HALF", "        turn<S_DIAG"),
                         ("turn<S_NONE, PV_HALF>", "turn<S_NONE, PV_FULL>")],
    "no ping-pong": [("    bar_sync(1 + c, 256);\n", ""),
                     ("if (pass) bar_arrive(2 - c, 256);", ""),
                     ("if (w.c == 1) bar_arrive(1, 256);", "")],
    "no setmaxnreg": [("    setmaxnreg_dec<PRODUCER_REGS>();\n", ""),
                      ("  setmaxnreg_inc<CONSUMER_REGS>();\n", ""),
                      ("regs[device] != LAUNCH_REGS", "false")],
    "scaled scores": [
        (_MASK, "      s[4 * i + e] *= scale_log2;\n" + _MASK),
        ("    al[x] = ex2((m[x] - mn) * scale_log2);", "    al[x] = ex2(m[x] - mn);"),
        ("    ms[x] = mn * scale_log2;", "    ms[x] = mn;"),
        ("      const float p = ex2(fmaf(s[4 * i + e], scale_log2, -ms[e >> 1]));",
         "      const float p = ex2(s[4 * i + e] - ms[e >> 1]);")],
    "K ring 2 stages": [("static constexpr int KS = D == 64 ? 4 : 3;",
                         "static constexpr int KS = 2;")],
    "rings 3 and 2 at d 64": [("static constexpr int KS = D == 64 ? 4 : 3;",
                               "static constexpr int KS = 3;"),
                              ("static constexpr int VS = D == 64 ? 4 : 2;",
                               "static constexpr int VS = 2;")],
    "rings 6 and 5 at d 64": [("static constexpr int KS = D == 64 ? 4 : 3;",
                               "static constexpr int KS = D == 64 ? 6 : 3;"),
                              ("static constexpr int VS = D == 64 ? 4 : 2;",
                               "static constexpr int VS = D == 64 ? 5 : 2;")],
    "no diagonal skip at d 64": [
        ("        turn<S_HALF", "        turn<D == 64 ? S_DIAG : S_HALF"),
        ("turn<S_NONE, PV_HALF>", "turn<S_NONE, D == 64 ? PV_FULL : PV_HALF>")],
}
KNOCKOUTS = {
    "no softmax": [("softmax_tile(sc, SM != S_FULL, r, tig, scale_log2, m, l, al);",
                    "al[0] = al[1] = 1.f;")],
    "no exp2": [("const float p = ex2(fmaf(s[4 * i + e], scale_log2, -ms[e >> 1]));",
                 "const float p = fmaf(s[4 * i + e], scale_log2, -ms[e >> 1]);")],
    "no P·V": [("    if constexpr (PM != PV_NONE) {\n      const uint32_t va",
                "    if constexpr (false) {\n      const uint32_t va")],
    "no store": [("for (int x = 0; x < P::BOXES; ++x) "
                   "tma_store_4d(to, ob + x * BOX, 64 * x, h, row0, b);", "")],
}


def build(variants: dict) -> dict:
    """{name: (loaded library, ptxas summary)}, all nvcc runs started together."""
    out = _build.BUILD_ROOT / "sweep6"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "causal_attention.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            assert old in src, (name, old)
            src = src.replace(old, new)
        stem = re.sub(r"\W+", "_", f"k6_{name}", flags=re.ASCII)
        (out / f"{stem}.cu").write_text(src)
        procs[name] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH, *_build.COMMON, "-Xptxas=-v", "-I", str(_build.CSRC),
             "-shared", str(out / f"{stem}.cu"), "-o", str(out / f"lib{stem}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, p) in procs.items():
        report, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{report}")
        regs = re.findall(r"causal_attention_wgmmaILi(\d+)E.*?Used (\d+) registers",
                          report, re.S)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
        serial = sum("wgmma.mma_async instructions are serialized" in ln
                     for ln in report.splitlines())
        libs[name] = (_build.load(out / f"lib{stem}.so"),
                      f"registers {dict(regs)}, spills {spills}, serialisation warnings {serial}")
    return libs


def with_lib(lib, fn):
    real = _build._lib
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = real


_failed: dict = {}


def ok(lib, name) -> bool:
    """Whether the variant launches (its error is printed once if not)."""
    if name not in _failed:
        q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16, device="cuda")
        try:
            with_lib(lib, lambda: K6.flash_causal_attention(q, q[:, :, :1], q[:, :, :1]))
            torch.cuda.synchronize()
            _failed[name] = None
        except RuntimeError as e:
            _failed[name] = str(e)
            print(f"K6 {name}: {e}", flush=True)
    return _failed[name] is None


def main() -> None:
    libs = build({**DESIGN, **KNOCKOUTS})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = [(2, 300, 32, 8, 128), (2, 1024, 12, 12, 64)]
    for name, (lib, summary) in libs.items():
        line = f"K6 {name}: {summary}"
        if name in DESIGN:
            worst = 0.0
            for b, s, h, kv, d in checks if ok(lib, name) else ():
                q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
                k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).bfloat16()
                        for _ in range(2))
                out = with_lib(lib, lambda: K6.flash_causal_attention(q, k, v))
                ref = K6.causal_attention_plain(q, k, v)
                err = (out.float() - ref.float()).abs() / K6.tolerance(q, k, v, ref)
                worst = max(worst, float(err.max()))
            line += f"; max err / tolerance {worst:.3f}"
        print(line, flush=True)
    before = K6.launches
    for label, b, s, h, kv, d in SHAPES:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        def us(lib):
            return 1000 * with_lib(lib, lambda: cuda_ms(
                lambda: K6.flash_causal_attention(q, k, v), reps=10))

        cells = [f"{name}: {us(lib):.1f}" for name, (lib, _) in libs.items() if ok(lib, name)]
        print(f"K6 {label} ({b}, {s}, {h}/{kv}, {d}) us: " + "; ".join(cells), flush=True)
    K6.launches = before


if __name__ == "__main__":
    main()
