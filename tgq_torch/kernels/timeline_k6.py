"""Where a K6 block's time goes on the card: a copy of
``csrc/causal_attention.cu`` that records ``clock64`` at eight points of
every turn of both consumer warpgroups of block 0, run once at a shape,
summed by stage, at the calibration batch (d 128) and OPT-1.3b's (d 64).

    python3 -m tgq_torch.kernels.timeline_k6      # on a machine with the GPU

The copy is made by text substitution (keep the strings in step with the
.cu), built into ``_build/timeline6/`` and called through
``causal_attention.flash_causal_attention``.  The stages of a turn: wait
for its K / V tiles, wait for the turn (the other consumer's hand-over),
issue the products, wait for S, softmax, wait for P·V, the rescale and P
and the release; between turns, and once a tile the epilogue (O out by
TMA, the wait for the next tile's Q).  Prints cycles a turn by stage for the middle turns
(S and P·V both), each stage's share of the block's consumer time, and
the epilogue's by part; the card's name and power limit first.  The timestamps
cost block 0 a few stores a turn.  Tuning only: the port never calls this.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from tgq_torch.kernels import _build
from tgq_torch.kernels import causal_attention as K6

TURNS = 2048  # turns recorded a consumer
TILES = 256  # query tiles recorded a consumer
STAGES = ("wait K/V", "wait turn", "issue", "wait S", "softmax", "wait P·V", "rescale, P")
SUBS = [
    ('#include "hopper.cuh"\n',
     '#include "hopper.cuh"\n\n__device__ unsigned long long k6_trace[2][%d][8];\n'
     '__device__ unsigned long long k6_epi[2][%d][5];\n'
     '#define TR(i) do { if (blockIdx.x == 0 && nturn < %d) '
     'k6_trace[c][nturn][i] = clock64(); } while (0)\n'
     '#define ER(i) do { if (blockIdx.x == 0 && ntile < %d) '
     'k6_epi[c][ntile][i] = clock64(); } while (0)\n' % (TURNS, TILES, TURNS, TILES)),
    ("  float m[2], l[2], al[2];\n", "  float m[2], l[2], al[2];\n  int nturn = 0, ntile = 0;\n"),
    ("  __device__ __forceinline__ void store(const CUtensorMap* to, int b, int h, int qt, int S,\n"
     "                                        int qb) {\n",
     "  __device__ __forceinline__ void store(const CUtensorMap* to, int b, int h, int qt, int S,\n"
     "                                        int qb) {\n    ER(0);\n"),
    ("    fence_proxy_async();\n    bar_sync(3 + c, 128);\n",
     "    ER(1);\n    fence_proxy_async();\n    bar_sync(3 + c, 128);\n    ER(2);\n"),
    ("    mbar_arrive_if(bar + P::QE + 8 * qb, t == 0);\n  }\n",
     "    ER(3);\n    mbar_arrive_if(bar + P::QE + 8 * qb, t == 0);\n    ++ntile;\n  }\n"),
    ("    mbar_wait(bar + P::QF + 8 * qb, (it / 2) & 1);\n",
     "    mbar_wait(bar + P::QF + 8 * qb, (it / 2) & 1);\n"
     "    if (blockIdx.x == 0 && it < %d) k6_epi[w.c][it][4] = clock64();\n" % TILES),
    ("    const int ks = n % P::KS, vs = (n + P::VS - 1) % P::VS;  // K_n's and V_{n-1}'s stages\n",
     "    const int ks = n % P::KS, vs = (n + P::VS - 1) % P::VS;  // K_n's and V_{n-1}'s stages\n"
     "    TR(0);\n"),
    ("    bar_sync(1 + c, 256);\n", "    TR(1);\n    bar_sync(1 + c, 256);\n    TR(2);\n"),
    ("    if (pass) bar_arrive(2 - c, 256);\n",
     "    TR(3);\n    if (pass) bar_arrive(2 - c, 256);\n"),
    ("      wgmma_wait<1>();  // S_j is done; P_{j-1}·V_{j-1} may still run\n",
     "      wgmma_wait<1>();  // S_j is done; P_{j-1}·V_{j-1} may still run\n      TR(4);\n"),
    ("      softmax_tile(sc, SM != S_FULL, r, tig, scale_log2, m, l, al);\n    }\n"
     "    wgmma_wait<0>();\n",
     "      softmax_tile(sc, SM != S_FULL, r, tig, scale_log2, m, l, al);\n      TR(5);\n    }\n"
     "    wgmma_wait<0>();\n    TR(6);\n"),
    ("        pa[ks][3] = pack_bf16x2(sc[8 * ks + 6], sc[8 * ks + 7]);\n      }\n    }\n  }\n",
     "        pa[ks][3] = pack_bf16x2(sc[8 * ks + 6], sc[8 * ks + 7]);\n      }\n    }\n"
     "    TR(7);\n    ++nturn;\n  }\n"),
]
GETTER = '''
extern "C" int k6_trace_get(void* dst, void* epi) {
  const cudaError_t e = cudaMemcpyFromSymbol(dst, k6_trace, sizeof(k6_trace));
  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(epi, k6_epi, sizeof(k6_epi)));
}
extern "C" int k6_trace_clear() {
  static unsigned long long zero[2][%d][8], zero_epi[2][%d][5];
  const cudaError_t e = cudaMemcpyToSymbol(k6_trace, zero, sizeof(zero));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(k6_epi, zero_epi, sizeof(zero_epi)));
}
''' % (TURNS, TILES)


def build() -> tuple[ctypes.CDLL, str]:
    """The instrumented kernel library and ptxas's report of it."""
    out = _build.BUILD_ROOT / "timeline6"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "causal_attention.cu").read_text()
    for old, new in SUBS:
        assert old in src, old
        src = src.replace(old, new)
    (out / "k6_timeline.cu").write_text(src + GETTER)
    r = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.COMMON, "-Xptxas=-v", "-I",
                        str(_build.CSRC), "-shared", str(out / "k6_timeline.cu"), "-o",
                        str(out / "libk6_timeline.so")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = _build.load(out / "libk6_timeline.so")
    lib.k6_trace_get.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, r.stdout + r.stderr


def tiles_of_block0(b: int, s: int, h: int, sms: int) -> list[int]:
    """The query tiles block 0 walks (the kernel's longest-first list)."""
    nq = (s + 127) // 128
    n = nq * h * b
    return [nq - 1 - i // (h * b) for i in range(0, n, min(n, sms))]


SHAPES = ((8, 2048, 32, 8, 128), (8, 2048, 32, 32, 64))  # calibration, OPT-1.3b


def main() -> None:
    lib, report = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    serial = sum("are serialized" in ln for ln in report.splitlines())
    print(f"instrumented build: wgmma serialisation warnings {serial}", flush=True)
    for shape in SHAPES:
        timeline(lib, *shape)


def timeline(lib, b: int, s: int, h: int, kv: int, d: int) -> None:
    """Block 0's consumer turns at (b, s, h / kv, d), by stage."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).bfloat16() for _ in range(2))
    real, before = _build._lib, K6.launches
    _build._lib = lib
    try:
        for _ in range(3):
            K6.flash_causal_attention(q, k, v)
        torch.cuda.synchronize()
        _build.check(lib.k6_trace_clear(), "trace clear")
        K6.flash_causal_attention(q, k, v)
        torch.cuda.synchronize()
        trace = np.zeros((2, TURNS, 8), dtype=np.uint64)
        epi = np.zeros((2, TILES, 5), dtype=np.uint64)
        _build.check(lib.k6_trace_get(trace.ctypes.data, epi.ctypes.data), "trace get")
    finally:
        _build._lib, K6.launches = real, before
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = tiles_of_block0(b, s, h, sms)
    print(f"K6 ({b}, {s}, {h}/{kv}, {d}), block 0: {len(tiles)} query tiles "
          f"{tiles[:4]}...{tiles[-2:]}, {sum(t + 2 for t in tiles)} turns a consumer", flush=True)
    for c in range(2):
        t = trace[c].astype(np.int64)
        n = int((t[:, 7] > 0).sum())
        t = t[:n]
        # a turn without S records no S wait and no softmax
        t[:, 4] = np.where(t[:, 4] == 0, t[:, 3], t[:, 4])
        t[:, 5] = np.where(t[:, 5] == 0, t[:, 4], t[:, 5])
        # a tile's turns: S only, qt - 1 middle turns (S and P·V), the diagonal, P·V only
        middle, first = [], 0
        epilogue = 0
        for i, qt in enumerate(tiles):
            middle += range(first + 1, first + qt)
            if i + 1 < len(tiles) and first + qt + 2 < n:
                epilogue += t[first + qt + 2, 0] - t[first + qt + 1, 7]
            first += qt + 2
        total = t[-1, 7] - t[0, 0]
        stages = np.diff(t, axis=1)  # 7 stages a turn
        mid = stages[middle].mean(axis=0)
        share = stages.sum(axis=0) / total
        gaps = (t[1:, 0] - t[:-1, 7]).sum() - epilogue
        print(f"consumer {c}: {n} turns, {total} cycles; middle turns, cycles a turn: "
              + "; ".join(f"{nm} {x:.0f}" for nm, x in zip(STAGES, mid))
              + f" (sum {mid.sum():.0f})", flush=True)
        print(f"consumer {c}: share of its time: "
              + "; ".join(f"{nm} {x:.1%}" for nm, x in zip(STAGES, share))
              + f"; between turns {gaps / total:.1%}; epilogues {epilogue / total:.1%} "
              f"({epilogue / max(len(tiles) - 1, 1):.0f} cycles a tile)", flush=True)
        e = epi[c, :len(tiles)].astype(np.int64)
        parts = np.stack([e[:-1, 1] - e[:-1, 0], e[:-1, 2] - e[:-1, 1], e[:-1, 3] - e[:-1, 2],
                          e[1:, 4] - e[:-1, 3]], axis=1).mean(axis=0)
        print(f"consumer {c}: epilogue, cycles a tile: O divided and written {parts[0]:.0f}; "
              f"fence and barrier {parts[1]:.0f}; TMA store issued and read {parts[2]:.0f}; "
              f"to the next tile's Q {parts[3]:.0f}", flush=True)


if __name__ == "__main__":
    main()
