"""Seeded inputs: calibration ids, request sizes, prompts and arrival
times.  Every draw comes from ``--seed``; sizes and gaps are stratified
samples of their distribution (the same set for every seed, in another
order), so a seed changes which request gets which size and tokens, not
how much work a run has.

``synthetic_calibration`` is a copy of
``tgq_torch.calib.data.synthetic_calibration``; the Poisson schedule
follows ``tgq_torch.cli.serve._measured_run``'s, and records each
request's due time.
"""
from __future__ import annotations

import math
import statistics

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of the seed."""
    return np.random.default_rng([int(seed) & (2**63 - 1), int(stream)])


def synthetic_calibration(vocab_size: int, n_samples: int, seq_len: int, seed: int,
                          n_phrases: int = 256, phrase_len: int = 16) -> np.ndarray:
    """(n_samples, seq_len) int32: sequences of phrases drawn from one bank
    of ``n_phrases`` random ``phrase_len``-token phrases."""
    rng = np.random.default_rng(int(seed))
    bank = rng.integers(0, vocab_size, size=(n_phrases, phrase_len))
    out = np.empty((n_samples, seq_len), np.int64)
    for s in range(n_samples):
        chunks = []
        total = 0
        while total < seq_len:
            chunks.append(bank[rng.integers(0, n_phrases)])
            total += phrase_len
        out[s] = np.concatenate(chunks)[:seq_len]
    return out.astype(np.int32)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def stratified_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` whole lengths from ``spec``, in an order drawn from ``rng``:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` (clipped) or
    ``{"dist": "uniform", "min", "max"}`` (both ends included)."""
    u = _quantiles(n)
    if spec["dist"] == "lognormal":
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(float(p)) for p in u])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        x = np.clip(np.rint(x), spec["min"], spec["max"])
    elif spec["dist"] == "uniform":
        x = spec["min"] + np.floor(u * (spec["max"] - spec["min"] + 1))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return rng.permutation(x.astype(np.int64))


def poisson_due(rate: float, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Due times (seconds from the window's start) of a Poisson process at
    ``rate`` req/s covering ``seconds``: stratified exponential gaps in an
    order drawn from ``rng``."""
    n = int(math.ceil(rate * seconds)) + 1
    gaps = -np.log1p(-_quantiles(n)) / rate
    return np.cumsum(rng.permutation(gaps))


def prompt_tokens(vocab_size: int, n: int, rng: np.random.Generator) -> list[int]:
    return rng.integers(0, vocab_size, size=int(n)).tolist()


class RequestStream:
    """Sizes of an endless stream of requests: (prompt, output) pairs from
    a stratified pool of ``pool`` pairs, permuted anew each pass."""

    def __init__(self, mix: dict, vocab_size: int, rng: np.random.Generator):
        self.mix, self.vocab, self.rng = mix, vocab_size, rng
        self._pairs: list[tuple[int, int]] = []

    def next(self) -> tuple[list[int], int]:
        if not self._pairs:
            n = int(self.mix["pool"])
            p = stratified_lengths(self.mix["prompt"], n, self.rng)
            o = stratified_lengths(self.mix["output"], n, self.rng)
            self._pairs = list(zip(p.tolist(), o.tolist()))[::-1]
        p_len, o_len = self._pairs.pop()
        return prompt_tokens(self.vocab, p_len, self.rng), int(o_len)
