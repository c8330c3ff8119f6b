"""Calibration / evaluation data loading (a copy of ``tgq/calib/data.py``).

WikiText-2 joined with "\\n\\n", tokenized once, 128 random 2048-token
windows at seed 42; C4 streamed with shuffle-buffer 10000.  Both need HF
``datasets`` with local data and import it lazily; the deterministic
synthetic source needs nothing and gives the same tokens as the JAX
package for the same seed.
"""
from __future__ import annotations

import logging
import random
from typing import List

import numpy as np

logger = logging.getLogger(__name__)


def get_wikitext2(tokenizer, n_samples: int, seq_len: int, seed: int = 42) -> np.ndarray:
    from datasets import load_dataset

    data = load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
    text = "\n\n".join(data["text"])
    enc = tokenizer(text, return_tensors="np", add_special_tokens=False)
    ids = enc["input_ids"][0]
    full_len = len(ids)
    logger.info("[data] wikitext2 train tokens: %d", full_len)
    rng = random.Random(seed)
    samples = []
    for _ in range(n_samples):
        i = rng.randint(0, full_len - seq_len - 1)
        samples.append(ids[i : i + seq_len])
    return np.stack(samples).astype(np.int32)


def get_c4(tokenizer, n_samples: int, seq_len: int, seed: int = 42) -> np.ndarray:
    from datasets import load_dataset

    data = load_dataset("allenai/c4", "en", split="train", streaming=True)
    data = data.shuffle(seed=42, buffer_size=10000)
    samples: List[np.ndarray] = []
    for doc in data:
        if len(samples) >= n_samples:
            break
        toks = tokenizer(doc["text"], return_tensors="np", truncation=True,
                         max_length=seq_len, add_special_tokens=False)["input_ids"][0]
        if len(toks) >= seq_len:
            samples.append(toks[:seq_len])
    return np.stack(samples).astype(np.int32)


def synthetic_calibration(
    vocab_size: int, n_samples: int, seq_len: int, seed: int = 42
) -> np.ndarray:
    """Deterministic Markov-ish token stream: structured enough that a
    random-init model's Hessians are non-degenerate, with repeated n-grams
    so PPL is meaningfully below uniform."""
    rng = np.random.default_rng(seed)
    # build a small bank of "phrases" and sample sequences from them
    n_phrases, phrase_len = 256, 16
    bank = rng.integers(0, vocab_size, size=(n_phrases, phrase_len))
    out = np.empty((n_samples, seq_len), np.int64)
    for s in range(n_samples):
        chunks = []
        total = 0
        while total < seq_len:
            p = bank[rng.integers(0, n_phrases)]
            chunks.append(p)
            total += phrase_len
        out[s] = np.concatenate(chunks)[:seq_len]
    return out.astype(np.int32)


def synthetic_eval_stream(vocab_size: int, n_tokens: int, seed: int = 43) -> np.ndarray:
    return synthetic_calibration(vocab_size, 1, n_tokens, seed)[0]


def get_loaders(
    name: str, tokenizer, n_samples: int = 128, seq_len: int = 2048,
    seed: int = 42, vocab_size: int | None = None,
) -> np.ndarray:
    """(n_samples, seq_len) int32 calibration batch (reference get_loaders)."""
    if name == "wikitext2":
        return get_wikitext2(tokenizer, n_samples, seq_len, seed)
    if name == "c4":
        return get_c4(tokenizer, n_samples, seq_len, seed)
    if name == "synthetic":
        assert vocab_size is not None, "synthetic data needs vocab_size"
        return synthetic_calibration(vocab_size, n_samples, seq_len, seed)
    raise ValueError(f"Unknown dataset: {name}")


def load_eval_tokens(name: str, tokenizer, vocab_size: int | None = None) -> np.ndarray:
    """Flat evaluation token stream (reference eval_utils.py:30-36)."""
    if name == "wikitext2":
        from datasets import load_dataset

        testdata = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
        text = "\n\n".join(testdata["text"])
        return tokenizer(text, return_tensors="np")["input_ids"][0].astype(np.int32)
    if name == "synthetic":
        assert vocab_size is not None
        return synthetic_eval_stream(vocab_size, 16384)
    raise ValueError(f"Unknown eval dataset: {name}")
