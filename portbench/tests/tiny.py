"""Tiny configurations and mixes for CPU rehearsals of the drivers (the
cells themselves run only at their published widths on the card)."""
from __future__ import annotations

import copy
import time

import torch

from portbench.lib import bench
from portbench.lib.runctx import Context

QWEN = {"family": "llama", "model_type": "qwen3", "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False, "max_position_embeddings": 4096, "layers_per_sweep": 2}
OPT = {"family": "opt", "model_type": "opt", "hidden_size": 64, "ffn_dim": 256,
       "num_hidden_layers": 2, "num_attention_heads": 4, "vocab_size": 512,
       "max_position_embeddings": 256, "layers_per_sweep": 2}

SWEEP = {"n_samples": 8, "seq_len": 64, "phrases": 16, "batch_size": 4, "group_size": 32,
         "block_size": 32, "pivot_rtol": 1e-6}
CLOSED = {"group_size": 32, "page_size": 16, "check_requests": 3, "clients": 4, "slots": 4,
          "pool": 16, "warm_seconds": 0.2,
          "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.5, "min": 8, "max": 40},
          "output": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 24}}
OPEN = {"group_size": 32, "page_size": 16, "check_requests": 3, "slots": 4, "rate": 4.0,
        "prefill_chunk_tokens": 256,
        "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.5, "min": 8, "max": 48},
        "output": {"dist": "uniform", "min": 2, "max": 8}}


# limits for the tiny sizes: above the sound CPU readings with room (the
# cells' own limits are set from the card's readings at their sizes)
LIMITS = {"sweeps_differ": 0, "grid_miss": 0, "gram_rel": 0.02, "act_rel": 0.03,
          "pivot_regret": 1e-3, "rank_gap": 0.01, "factor_rel": 0.1, "code_miss": 0.05,
          "loss_ratio": 1.05, "served_gap": 0.15, "served_gap_mean": 0.01}


def cell(workload: str, config: dict, over: dict) -> bench.Cell:
    """The named cell of BENCHMARK.json with a tiny configuration, its
    mix's sizes shrunk, and the tiny limits of its numbers."""
    real = bench.find_cell(workload)
    mix = copy.deepcopy(real.mix)
    mix.update(over)
    return bench.Cell(name=workload, chips=1, config_name="tiny", config=config,
                      mix_name=real.mix_name, mix=mix,
                      limits={k: LIMITS[k] for k in real.limits},
                      end_to_end=real.end_to_end, per_layer=real.per_layer)


def open_loop_cell() -> bench.Cell:
    """A tiny cell of the ``prefill-open`` mix (driver ``serve-open``), which
    no entry of BENCHMARK.json runs at present, held to the numbers of its
    limits file, ``limits/qwen3-8b.serve-prefill.json``."""
    name = "qwen3-8b.serve-prefill"
    mix = bench.load_json(bench.PKG / "traffic" / "prefill-open.json")
    mix.update(copy.deepcopy(OPEN))
    limits = bench.load_json(bench.PKG / "limits" / f"{name}.json")
    return bench.Cell(name=name, chips=1, config_name="tiny", config=QWEN,
                      mix_name="prefill-open", mix=mix,
                      limits={k: LIMITS[k] for k in limits}, end_to_end=[], per_layer=[])


def run(c: bench.Cell, seed: int = 2**31 + 77, seconds: float = 1.0, trace: bool = False,
        control=None, device="cpu"):
    ctx = Context(cell=c, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device), t_start=time.time(), control=control)
    return bench.driver(c.mix["driver"]).run(ctx)
