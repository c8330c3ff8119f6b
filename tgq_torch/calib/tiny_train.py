"""A tiny model trained on a synthetic Markov source (mirrors
``tgq/calib/tiny_train.py``).

A random-init model has flat logits: its PPL sits at the uniform bound
and every quantizer's PPL delta is noise.  Training a tiny llama-family
model for a few hundred Adam steps on a low-entropy bigram source gives
a model whose PPL is far below uniform, so quantization deltas are
signal (``tgq_torch.cli.tiny_quality_bench``).

``markov_source`` and ``sample_stream`` are numpy and equal the JAX
package's.  ``train_tiny`` trains through the plain attention
(``attn_impl="naive"``) under autograd, as the JAX package trains
through its naive attention under ``jax.grad``, so no backward kernel
is needed.  The optimizer is ``torch.optim.AdamW`` with optax.adamw's
defaults (weight decay 1e-4, not torch's 1e-2).  Initial weights come
from the port's seeded ``init_params`` and differ from ``jax.random``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from tgq_torch.models.causal_lm import (apply_final_norm, decoder_layer, embed_tokens,
                                        init_params, lm_logits, rope_cache)
from tgq_torch.models.config import ModelConfig
from tgq_torch.utils.precision import resolve_device

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def markov_source(vocab_size: int, branching: int = 4, seed: int = 0) -> np.ndarray:
    """(vocab, vocab) bigram probabilities: each token has ``branching``
    likely successors (Zipf-weighted, 98 % of the mass), the rest share
    2 %; entropy ≈ log(branching) « log(vocab)."""
    rng = np.random.default_rng(seed)
    succ = np.stack([rng.choice(vocab_size, size=branching, replace=False)
                     for _ in range(vocab_size)])
    w = 1.0 / np.arange(1, branching + 1)
    p_main = 0.98 * w / w.sum()
    probs = np.full((vocab_size, vocab_size), 0.02 / vocab_size)
    np.put_along_axis(probs, succ, p_main[None, :] + np.take_along_axis(probs, succ, 1), axis=1)
    probs /= probs.sum(axis=1, keepdims=True)
    return probs


def sample_stream(probs: np.ndarray, n_tokens: int, seed: int = 1) -> np.ndarray:
    """``n_tokens`` int32 tokens of the chain, from a uniform first token."""
    rng = np.random.default_rng(seed)
    v = probs.shape[0]
    out = np.empty((n_tokens,), np.int32)
    tok = int(rng.integers(v))
    cum = probs.cumsum(axis=1)
    u = rng.random(n_tokens)
    for i in range(n_tokens):
        tok = int(np.searchsorted(cum[tok], u[i]))
        out[i] = min(tok, v - 1)
    return out


def _logits(params, cfg: ModelConfig, ids: torch.Tensor) -> torch.Tensor:
    """``causal_lm.forward`` with autograd on and the plain attention."""
    x = embed_tokens(params, ids, cfg=cfg)
    cos, sin = rope_cache(cfg, ids.shape[1], device=x.device)
    for lp in params["model"]["layers"]:
        x = decoder_layer(lp, cfg, x, cos, sin, attn_impl="naive")
    return lm_logits(params, cfg, apply_final_norm(params, cfg, x))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def train_tiny(cfg: ModelConfig, steps: int = 300, batch: int = 32, seq_len: int = 64,
               lr: float = 3e-3, seed: int = 0, source_seed: int = 0,
               outlier_channels: int = 0, outlier_scale: float = 30.0,
               device: str = "cuda"):
    """Train ``cfg`` from scratch on the Markov source; returns (params in
    bf16 on ``device``, probs, the last step's loss).

    ``outlier_channels`` > 0 scales that many embedding channels by
    ``outlier_scale`` at init, so the trained model uses massive-activation
    channels and its calibration Hessians have the trace-dominating channel
    structure of real LLMs (``tgq_torch.cli.trunc_regimes``' "channel"
    spectrum)."""
    dev = resolve_device(device)
    probs = markov_source(cfg.vocab_size, seed=source_seed)
    stream = sample_stream(probs, steps * batch * seq_len + seq_len, seed=seed + 1)
    params = _map(init_params(cfg, seed=seed, device=dev),
                  lambda t: t.float().requires_grad_())
    if outlier_channels:
        with torch.no_grad():
            params["model"]["embed_tokens"]["weight"][:, :outlier_channels] *= outlier_scale
    opt = torch.optim.AdamW(_leaves(params), lr=lr, weight_decay=ADAMW_WEIGHT_DECAY)
    n = batch * seq_len
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        chunk = stream[i * n: i * n + n + 1]
        ids = torch.from_numpy(np.stack([chunk[j * seq_len: j * seq_len + seq_len + 1]
                                         for j in range(batch)]).astype(np.int64)).to(dev)
        logp = torch.log_softmax(_logits(params, cfg, ids[:, :-1]).float(), dim=-1)
        loss = -logp.gather(-1, ids[:, 1:, None]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    params = _map(params, lambda t: t.detach().to(torch.bfloat16))
    return params, probs, float(loss.detach())
