"""K3 tuning sweep on the card: tile shapes, ring stages and split-K counts
of the packed-weight matmul, and knockouts (the kernel with one component
removed), W4 g128 at the Qwen3-8B shapes, t = 8 and t = 1024.

    python3 -m tgq_torch.kernels.sweep_k3      # on a machine with the GPU

Each variant is ``launch_k3<4, 0, WC, WN, NTT, STAGES, 64>`` from
``csrc/dequant_matmul.cu``, built with its knockout into
``_build/sweep/``; bf16 x and output.  A knockout replaces one piece of the
source: ``no mma`` (the tensor-core product by one integer op), ``no
dequant`` (the weight fragments by a constant), ``no code loads`` (the
codes' cp.async), ``no compute`` (the whole k16 loop), so the time left is
what the rest costs.  Prints device microseconds a launch, the card's name
and power limit first.  Tuning only: the port's wrapper never calls this.
"""
from __future__ import annotations

import ctypes
import subprocess
import time

import torch

from tgq_torch.core.quant import QuantSpec
from tgq_torch.kernels import _build
from tgq_torch.kernels import dequant_matmul as KD
from tgq_torch.models.hf_import import rtn_pack

# (WC, WN, NTT, STAGES); the first of each regime is the one the wrapper runs
DECODE = [(4, 1, 1, 4), (4, 1, 1, 6), (8, 1, 1, 4), (16, 1, 1, 4)]
PREFILL = [(4, 2, 8, 3), (4, 2, 4, 3), (8, 1, 8, 2), (8, 1, 8, 3), (4, 4, 4, 3)]
SPLITS = (1, 2, 4, 8, 11, 16, 24)
SHAPES = (("qkv", 6144, 4096), ("o", 4096, 4096), ("gate_up", 24576, 4096),
          ("down", 4096, 12288))
KNOCKOUTS = {
    "none": [],
    "no mma": [('''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
                "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3f8fffffu);")],
    "no dequant": [("weights<BITS, CS>(w0, cw, e0, v0, uc, zz);",
                    "w0[0] = w0[1] = w0[2] = w0[3] = 0x3f803f80u ^ (uint32_t)(e0 + v0);"),
                   ("weights<BITS, CS>(w1, cw, e1, v1, uc, zz);",
                    "w1[0] = w1[1] = w1[2] = w1[3] = 0x3f803f80u ^ (uint32_t)(e1 + v1);")],
    "no code loads": [("cp_async16(dst, col < a.N ? src : a.codes, col < a.N ? 16 : 0);", "")],
    "no compute": [("for (int s = 0; s < kc / 16; ++s) {", "for (int s = 0; s < 0; ++s) {")],
}


def _variant_source(subs) -> str:
    src = (_build.CSRC / "dequant_matmul.cu").read_text()
    for bits in (2, 3, 4, 8):  # only the variants below are instantiated
        src = src.replace(f"case {bits}: return launch_k3_x<{bits}>(a, xm, prefill, device, s);",
                          "")
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    cases = "\n".join(
        f"    case {i}: return launch_k3<4, 0, {wc}, {wn}, {ntt}, {st}, 64>(a, 0, s);"
        for i, (wc, wn, ntt, st) in enumerate(DECODE + PREFILL))
    return src + f'''
extern "C" int k3_variant(int vid, const void* x, const uint8_t* codes, const float* scale,
                          const float* zero, void* y, float* ws, int t, int K, int N,
                          int split, void* stream) {{
  const K3Args a{{x, K, codes, scale, zero, y, ws, 1, t, K, N, 128, 64, split, 1}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (vid) {{
{cases}
    default: return -1;
  }}
}}
'''


def build() -> dict:
    out = _build.BUILD_ROOT / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in KNOCKOUTS.items():
        stem = name.replace(" ", "_")
        (out / f"{stem}.cu").write_text(_variant_source(subs))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH, *_build.COMMON, "-I", str(_build.CSRC), "-shared",
             str(out / f"{stem}.cu"),
             "-o", str(out / f"lib{stem}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{text}")
        lib = ctypes.CDLL(str(out / f"lib{name.replace(' ', '_')}.so"))
        lib.k3_variant.argtypes = [I] + [P] * 6 + [I] * 4 + [P]
        lib.k3_variant.restype = I
        libs[name] = lib
    return libs


def device_us(fn, reps: int = 20) -> float:
    """Device microseconds a call, the host's dispatch hidden behind a spin
    kernel (as chip_smoke.cuda_ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9 * (2 * reps * host + 1e-3), 1e9)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def main() -> None:
    libs = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, n_out, n_in in SHAPES:
        w = torch.randn((n_out, n_in), generator=gen, device=dev) / n_in ** 0.5
        w = rtn_pack(w, QuantSpec(bits=4, group_size=128, sym=False))
        for t, configs, splits in ((8, DECODE, SPLITS), (1024, PREFILL, (1,))):
            x = torch.randn((t, n_in), generator=gen, device=dev).bfloat16()
            ref = KD.dequant_matmul_plain(x, w)
            plan = KD._k3_plan(t, n_in, n_out, 128, 4)
            first = 0 if t == 8 else len(DECODE)
            cells = []
            for i, cfg in enumerate(configs):
                for split in splits:
                    if split > n_in // 128:
                        continue
                    for knock, lib in libs.items():
                        if knock != "none" and (i > 0 or split != plan.split):
                            continue  # knockouts at the wrapper's configuration only
                        y = torch.empty((t, n_out), dtype=torch.bfloat16, device=dev)
                        ws = torch.empty((split * t * n_out,), device=dev) if split > 1 else None
                        args = (first + i, x.data_ptr(), w.codes.data_ptr(), w.scale.data_ptr(),
                                w.zero.data_ptr(), y.data_ptr(),
                                None if ws is None else ws.data_ptr(), t, n_in, n_out, split,
                                stream)
                        _build.check(lib.k3_variant(*args), f"k3_variant {cfg}")
                        torch.cuda.synchronize()
                        if knock == "none":
                            rel = float((y.float() - ref).abs().max() / ref.abs().max())
                            assert rel < 1e-2, (name, t, cfg, split, rel)
                        us = device_us(lambda: lib.k3_variant(*args))
                        label = "" if knock == "none" else f" {knock}"
                        cells.append(f"{cfg}/{split}{label}: {us:.1f}")
            print(f"{name} {n_out}x{n_in} t={t} (wrapper: {configs[0]}, split {plan.split}) "
                  "us: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
