"""K4 and K5 knockouts on the card: each kernel timed as it is and with one
component removed, at the serving shapes, so the time left names what
bounds it.

    python3 -m tgq_torch.kernels.sweep_k45      # on a machine with the GPU

Each variant is ``csrc/a8_matmul.cu`` or ``csrc/paged_attention.cu`` with
one piece of source replaced, built into ``_build/sweep45/`` and called
through the port's own wrappers (``dequant_matmul.a8_matmul``,
``paged_attention.paged_decode_attention``) with the variant library in
place of the built one.  K4 (W4A8 g128, Qwen3-8B shapes, t = 8 and 1024):
``no mma`` (the int8 product by one integer op), ``no conversion`` (the
q - z fragments by constants), ``no code loads`` (the codes' cp.async),
``no compute`` (the whole k32 loop); and other decode tiles than the
planner's (columns, chunks a stage, stages).  K5 (bf16 pools, H 32, kv heads 8,
d 128): ``no logits`` (the q·k dot by one shared-memory read), ``no P·V``
(the value loop), ``no KV loads`` (the K and V cp.async), ``no merge``
(every split returns after writing its partial), ``empty`` (every block
returns after reading its slot's length); and the unchanged
kernel at other split counts (``S=n``) than the planner's.  A knocked-out
variant's output is wrong by design; only its time is read.  Prints
device microseconds a launch, the card's name and power limit first.
Tuning only: the port's wrappers never call this.
"""
from __future__ import annotations

import dataclasses
import re
import subprocess

import torch

from tgq_torch.core.quant import QuantSpec
from tgq_torch.kernels import _build
from tgq_torch.kernels import dequant_matmul as KD
from tgq_torch.kernels import paged_attention as K5
from tgq_torch.kernels.sweep_k3 import SHAPES, device_us
from tgq_torch.models.hf_import import rtn_pack

KNOCKOUTS = {
    "a8_matmul.cu": {
        "none": [],
        "no mma": [('''  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
                    "  d[0] += (int)(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);")],
        "no conversion": [("quad<BITS, CS>(q0, cw, e0, v0, uc, kz);",
                           "q0[0] = q0[1] = q0[2] = q0[3] = 0x01010101u ^ (uint32_t)(e0 + v0);"),
                          ("quad<BITS, CS>(q1, cw, e1, v1, uc, kz);",
                           "q1[0] = q1[1] = q1[2] = q1[3] = 0x01010101u ^ (uint32_t)(e1 + v1);")],
        "no code loads": [("cp_async16(dst, col < a.N ? src : a.codes, col < a.N ? 16 : 0);", "")],
        "no compute": [("auto kstep = [&](int s, int e0, int v0, int e1, int v1) {",
                        "auto kstep = [&](int s, int e0, int v0, int e1, int v1) { return;")],
        **{f"decode {32 * wc} cols {nwk} chunks x {st} stages": [
            ("case 0: return launch_k4<BITS, 1, 1, 1, 8, 2, UCF>(a, device, s);",
             f"case 0: return launch_k4<BITS, {wc}, 1, 1, {nwk}, {st}, UCF>(a, device, s);")]
           for wc, nwk, st in ((1, 8, 3), (2, 4, 3))},
        "wide decode 4 chunks x 3 stages": [
            ("case 2: return launch_k4<BITS, 4, 1, 1, 2, 4, UCF>(a, device, s);",
             "case 2: return launch_k4<BITS, 4, 1, 1, 4, 3, UCF>(a, device, s);")],
    },
    "paged_attention.cu": {
        "none": [],
        "no logits": [("float logit = row_dot<KVB, D>(kt + lane * R::STRIDE, q_s + h * D, sh);",
                       "float logit = q_s[h * D + lane];")],
        "no P·V": [("for (int j = 0; j < n_tok; j += 4) {", "for (int j = 0; j < 0; j += 4) {")],
        "no KV loads": [("cp_async16(dst, base + r * row_bytes + c * 16, 16);", "")],
        "no merge": [("    if (!*flag) return;", "    return;")],
        "empty": [("  if (s >= n_merge) return;", "  return;")],
    },
}


def build() -> dict:
    """{(source, knockout): loaded library}, all nvcc runs started together."""
    out = _build.BUILD_ROOT / "sweep45"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, variants in KNOCKOUTS.items():
        text = (_build.CSRC / source).read_text()
        for name, subs in variants.items():
            src = text
            for old, new in subs:
                assert old in src, (source, old)
                src = src.replace(old, new)
            stem = re.sub(r"\W+", "_", f"{source[:-3]}_{name}", flags=re.ASCII)
            (out / f"{stem}.cu").write_text(src)
            procs[(source, name)] = (stem, subprocess.Popen(
                [_build._nvcc(), *_build.ARCH, *_build.COMMON, "-I", str(_build.CSRC), "-shared",
                 str(out / f"{stem}.cu"), "-o", str(out / f"lib{stem}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (stem, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {key} variant:\n{text}")
        libs[key] = _build.load(out / f"lib{stem}.so")
    return libs


def timed(lib, fn) -> float:
    """Device microseconds of ``fn()`` with ``lib`` as the kernel library;
    K5's merge counters start from zero (a knockout may leave them set)."""
    real = _build._lib
    _build._lib = lib
    K5._counters.clear()
    try:
        return device_us(fn)
    finally:
        _build._lib = real


def main() -> None:
    libs = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, n_out, n_in in SHAPES:
        w = torch.randn((n_out, n_in), generator=gen, device=dev) / n_in ** 0.5
        w = dataclasses.replace(rtn_pack(w, QuantSpec(bits=4, group_size=128, sym=False)),
                                act_bits=8)
        for t in (8, 1024):
            x8, a = KD.quantize_activations(torch.randn((t, n_in), generator=gen, device=dev))
            cells = [f"{k}: {timed(lib, lambda: KD.a8_matmul(x8, a, w, torch.bfloat16)):.1f}"
                     for (src, k), lib in libs.items() if src == "a8_matmul.cu"]
            print(f"K4 {name} {n_out}x{n_in} t={t} us: " + "; ".join(cells), flush=True)
    for label, slots, lengths, mpps in (
            ("8 x 192", 8, [192] * 8, 4),
            ("8 up to 2048", 8, [2048, 1900, 1500, 1024, 700, 300, 129, 2048], 32),
            ("64 up to 2048", 64, [int(v) for v in torch.randint(
                0, 2049, (64,), generator=torch.Generator().manual_seed(6))], 32)):
        n_pages = slots * mpps + 1
        k, v = (torch.randn((n_pages, 64, 1024), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: slots * mpps] + 1
                 ).reshape(slots, mpps).int()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn((slots, 32, 128), generator=gen, device=dev) * 0.03
        kc, vc = (torch.randn((slots, 1024), generator=gen, device=dev) for _ in range(2))
        splits = K5._k5_plan(slots, 8, mpps, 64).splits

        def run():
            return K5.paged_decode_attention(q, k, v, None, None, lens, table, kc, vc,
                                             num_kv_heads=8)

        cells = [f"{kn}: {timed(lib, run):.1f}"
                 for (src, kn), lib in libs.items() if src == "paged_attention.cu"]
        plan_fn = K5._k5_plan
        for other in sorted({max(1, splits // 2), min(64, 2 * splits), min(64, 4 * splits)}):
            K5._k5_plan = lambda *args, n=other: K5.K5Plan(splits=n, tile=K5._K5_TILE)
            try:
                cells.append(f"S={other}: {timed(libs[('paged_attention.cu', 'none')], run):.1f}")
            finally:
                K5._k5_plan = plan_fn
        print(f"K5 {label} (S {splits}) us: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
