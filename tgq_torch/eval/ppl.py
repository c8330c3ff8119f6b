"""Strided sliding-window perplexity (mirrors ``tgq/eval/ppl.py``).

The window schedule, the −100 target masking, the right-padding and the
token-weighted NLL are the JAX package's exactly.  Causal attention makes
a padding mask unnecessary: padded positions sit after every scored
position and their labels are −100.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from tgq_torch.models.causal_lm import forward
from tgq_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)

IGNORE = -100


def build_window_requests(dataset_size: int, max_length: int, stride: int):
    requests = []
    prev_end_loc = 0
    for begin_loc in range(0, dataset_size, stride):
        end_loc = min(begin_loc + max_length, dataset_size)
        target_len = end_loc - prev_end_loc
        requests.append({"begin": begin_loc, "end": end_loc, "target_len": target_len})
        prev_end_loc = end_loc
        if end_loc == dataset_size:
            break
    return requests


@torch.no_grad()
def _batch_nll(params, cfg: ModelConfig, input_ids: torch.Tensor,
               labels: torch.Tensor, attn_impl: str = "auto"):
    """Summed token NLL and active-token count for one padded batch
    (logits at t score labels[t+1])."""
    logits = forward(params, cfg, input_ids, attn_impl=attn_impl)
    shift_labels = labels[:, 1:]
    mask = shift_labels != IGNORE
    safe = torch.where(mask, shift_labels, 0).long()
    logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
    tok_ll = torch.gather(logprobs, -1, safe[..., None])[..., 0]
    return -(torch.where(mask, tok_ll, 0.0).sum()), mask.sum()


def _params_device(params) -> torch.device:
    return params["model"]["embed_tokens"]["weight"].device


def perplexity_from_token_stream(params, cfg: ModelConfig, token_ids: np.ndarray,
                                 max_length: int | None = None, stride: int = 512,
                                 batch_size: int = 4, pad_token_id: int = 0,
                                 attn_impl: str = "auto") -> float:
    """PPL of a flat token stream with the reference's window schedule,
    on the device the params live on."""
    token_ids = np.asarray(token_ids).reshape(-1)
    if max_length is None:
        max_length = cfg.seqlen
    n = len(token_ids)
    requests = build_window_requests(n, max_length, stride)
    logger.info("[eval] tokens=%d window=%d stride=%d windows=%d",
                n, max_length, stride, len(requests))
    dev = _params_device(params)
    total_nll = 0.0
    total_tokens = 0
    n_batches = -(-len(requests) // batch_size)
    report_every = max(1, n_batches // 10)
    for i in range(0, len(requests), batch_size):
        batch = requests[i : i + batch_size]
        inp = np.full((batch_size, max_length), pad_token_id, np.int64)
        lab = np.full((batch_size, max_length), IGNORE, np.int64)
        for j, req in enumerate(batch):
            ids = token_ids[req["begin"] : req["end"]]
            L = len(ids)
            inp[j, :L] = ids
            lab[j, :L] = ids
            lab[j, : L - req["target_len"]] = IGNORE
        nll, count = _batch_nll(params, cfg, torch.from_numpy(inp).to(dev),
                                torch.from_numpy(lab).to(dev), attn_impl=attn_impl)
        total_nll += float(nll)
        total_tokens += int(count)
        b = i // batch_size + 1
        if total_tokens and (b % report_every == 0 or b == n_batches):
            logger.info("[eval] batch %d/%d running PPL: %.4f",
                        b, n_batches, float(np.exp(total_nll / total_tokens)))
    if total_tokens == 0:
        return float("inf")
    return float(np.exp(total_nll / total_tokens))


def evaluate_perplexity(params, cfg: ModelConfig, dataset: str = "wikitext2",
                        tokenizer=None, stride: int = 512, batch_size: int = 4,
                        attn_impl: str = "auto",
                        token_ids: np.ndarray | None = None) -> float:
    """Dataset-level entry point: a pre-tokenized ``token_ids`` stream, or a
    dataset name and tokenizer (needs local HF data)."""
    if token_ids is None:
        from tgq_torch.calib.data import load_eval_tokens

        token_ids = load_eval_tokens(dataset, tokenizer)
    pad = 0
    if tokenizer is not None:
        pad = tokenizer.pad_token_id or tokenizer.eos_token_id or 0
    return perplexity_from_token_stream(
        params, cfg, token_ids, stride=stride, batch_size=batch_size,
        pad_token_id=pad, attn_impl=attn_impl,
    )
