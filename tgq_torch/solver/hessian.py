"""Streaming layer-Hessian and sketch accumulation (mirrors
``tgq/solver/hessian.py``).

H accumulates in f32.  bf16 activations keep their exact products: the
product of two bf16 values fits an f32 significand, so an f32-output
GEMM over bf16 operands loses nothing against upcasting first — only
the summation order differs.  A bf16 ``matmul`` would return bf16 and
destroy H, so on CUDA the Gram is ``torch.mm(..., out_dtype=float32)``;
the CPU build lacks that overload and upcasts to f32 first, which gives
the same products.

On the H100 that tensor-core Gram loses accuracy with the length of its
reduction: over 16384 tokens its largest error was 5.9e-5 of max|H|
against an f64 Gram, 2.1e-6 when the tokens go in chunks of 1024 summed
in f32.  The larger error sits in the smallest eigen-directions: on
layer 0 of Qwen3-8B with one ``synthetic_calibration`` bank (4035
distinct tokens, so H has rank 4035) the one-shot Gram left pchol 4010
resolvable pivots, and q_proj's GPTQ error on that factor was 28x RTN's
(chip_smoke.py phase 3 prints both Grams).  So the Gram runs in token
chunks of ``GRAM_CHUNK`` on every device.
"""
from __future__ import annotations

import dataclasses

import torch

GRAM_CHUNK = 1024  # tokens per Gram GEMM; the chunks are summed in f32


def _flatten_tokens(x: torch.Tensor) -> torch.Tensor:
    """(..., features) -> (tokens, features)."""
    return x.reshape(-1, x.shape[-1])


def _gram_f32(ct: torch.Tensor) -> torch.Tensor:
    if ct.dtype == torch.bfloat16 and ct.is_cuda:
        return torch.mm(ct, ct.T, out_dtype=torch.float32)
    ct = ct.float()
    return ct @ ct.T


def gram_t(xt: torch.Tensor) -> torch.Tensor:
    """xt @ xtᵀ in f32 for a (features, tokens) operand."""
    h = _gram_f32(xt[:, :GRAM_CHUNK])
    for i in range(GRAM_CHUNK, xt.shape[1], GRAM_CHUNK):
        h += _gram_f32(xt[:, i:i + GRAM_CHUNK])
    return h


def gram(x: torch.Tensor) -> torch.Tensor:
    """xᵀx in f32 for a (..., features) operand."""
    return gram_t(_flatten_tokens(x).T)


@dataclasses.dataclass
class HessianAccumulator:
    """H = (1/N) Σ xᵀx over calibration tokens for one layer-group input.
    With ``parts`` (a list) each update's Gram is kept there instead of
    added, for a data-parallel sum in a fixed order
    (``tgq_torch.parallel.mesh.dp_sum``)."""

    h: torch.Tensor
    n_samples: int = 0
    parts: list | None = None

    @classmethod
    def init(cls, in_features: int, device="cpu", keep_parts: bool = False
             ) -> "HessianAccumulator":
        return cls(h=torch.zeros((in_features, in_features), dtype=torch.float32,
                                 device=device), parts=[] if keep_parts else None)

    def _add(self, g: torch.Tensor) -> None:
        if self.parts is None:
            self.h += g
        else:
            self.parts.append(g)

    def own(self):
        """What this rank gives ``dp_sum``: its kept parts, or its sum."""
        return self.h if self.parts is None else self.parts

    def update(self, x: torch.Tensor) -> "HessianAccumulator":
        self._add(gram(x))
        self.n_samples += x.numel() // x.shape[-1]
        return self

    def update_t(self, xt: torch.Tensor) -> "HessianAccumulator":
        """Update from a transposed (features, tokens) operand."""
        self._add(gram_t(xt.reshape(xt.shape[0], -1)))
        self.n_samples += xt.numel() // xt.shape[0]
        return self

    @staticmethod
    def normalize(total: torch.Tensor, n_samples: int) -> torch.Tensor:
        """The Hessian of a Gram sum over ``n_samples`` tokens."""
        return total / max(n_samples, 1)

    def finalize(self) -> torch.Tensor:
        """Normalized Hessian (f32).  Safe on an empty accumulator."""
        return self.normalize(self.h, self.n_samples)


@dataclasses.dataclass
class SketchAccumulator:
    """Randomized Gaussian sketch Y = Σ R_batch X, scaled by
    1/sqrt(N·rank) at finalize.  The Gaussian numbers come from a
    ``torch.Generator``, so they differ from ``jax.random``'s; the sketch
    agrees with the JAX one in distribution, not in bits.

    One process draws every batch's R_b from one generator, in order.  A
    data rank whose first batch is global batch ``first_batch`` draws and
    drops that many projections of its first batch's shape before its own
    (every data rank holds batches of one shape): the generators' outputs
    depend on the calls' shapes (the CPU's vectorised normal, the CUDA
    Philox offsets), so one larger draw or a computed offset would not
    give the same numbers.  It keeps its R_b X_b in ``parts`` for
    ``dp_sum`` like the Grams, and the sum is the single process's
    sketch."""

    y: torch.Tensor
    n_samples: int
    gen: torch.Generator
    parts: list | None = None
    skip: int = 0

    @classmethod
    def init(cls, in_features: int, rank: int, seed: int = 0, device="cpu",
             keep_parts: bool = False, first_batch: int = 0) -> "SketchAccumulator":
        dev = torch.device(device)
        return cls(y=torch.zeros((rank, in_features), dtype=torch.float32, device=dev),
                   n_samples=0, gen=torch.Generator(device=dev).manual_seed(seed),
                   parts=[] if keep_parts else None, skip=first_batch)

    def own(self):
        """What this rank gives ``dp_sum``: its kept parts, or its sum."""
        return self.y if self.parts is None else self.parts

    def update(self, x: torch.Tensor) -> "SketchAccumulator":
        x = _flatten_tokens(x).float()
        shape = (self.y.shape[0], x.shape[0])
        for _ in range(self.skip):   # the earlier data ranks' batches
            torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.y.device)
        self.skip = 0
        r = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.y.device)
        if self.parts is None:
            self.y += r @ x
        else:
            self.parts.append(r @ x)
        self.n_samples += x.shape[0]
        return self

    @staticmethod
    def normalize(total: torch.Tensor, n_samples: int) -> torch.Tensor:
        """The sketch of a sum over ``n_samples`` tokens."""
        return total / (max(n_samples, 1) * total.shape[0]) ** 0.5

    def finalize(self) -> torch.Tensor:
        return self.normalize(self.y, self.n_samples)


def hessian_from_activations(x: torch.Tensor) -> torch.Tensor:
    """One-shot normalized Hessian from a (tokens, features) matrix."""
    return HessianAccumulator.init(x.shape[-1], device=x.device).update(x).finalize()
