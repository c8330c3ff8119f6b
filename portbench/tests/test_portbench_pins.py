"""Readings pinned to the values the harness gave before model families
became files of their own (``families/<family>.py``): the seeded weights
of the tiny llama and OPT configurations, bit for bit, and the work
counts and count-based readers at the ``qwen3-8b`` and ``opt-1.3b``
configurations, exactly.  A change that moves the family code and moves
none of these readings keeps them."""
import hashlib

import pytest
import torch

from portbench.counts import work
from portbench.lib import bench, weights
from portbench.tests import tiny

SEED = 2**31 + 5

WEIGHTS = {
    ("llama", torch.bfloat16): "b785b1d1f88705514d32ed9801c43bd399748081934d43ca05a7d05be54a2e57",
    ("llama", torch.float32): "993112579bed52e37417d0fa8643115f7d5528c6f534354c8f0d95d3dc8c131d",
    ("opt", torch.bfloat16): "56bf76a810437e8ed9755f27baed1f54589ce2f1bdc430d1d7b01d1e29189897",
    ("opt", torch.float32): "e8f30e37548bf499134c851ff09f955d23fa6b4081985778b03e07c7b457bbe4",
}

# group ranks of the swept layers (as the program's log gives them) and
# served requests (prompt, output before, output after, first token in)
RANKS = {"qwen3-8b": [[4010, 4096, 4096, 12288], [4096, 4096, 4095, 12288],
                      [4096, 4093, 4096, 12280], [4096, 4096, 4096, 12288]],
         "opt-1.3b": [[2048, 2040, 2048, 8192]] * 4 + [[2047, 2048, 2048, 8190]] * 4}
REQS = [(640, 10, 25, False), (300, 0, 5, True), (1536, 0, 1, True), (256, 383, 384, False)]
TOKENS, SEQ = 262144, 2048

COUNTS = {
    "qwen3-8b": {
        "quantize_layer_least_s": [0.1882739625765991, 0.18829546851836526,
                                   0.18827694689276328, 0.18829571886344487],
        "k2_layer_least_s": 0.0007371958791641801,
        "token_flops": [15726018560.0, 13895663616.0], "prompt_flops": 14535715979264.0,
        "k6_prompt_least_s": 0.0003129824420626896, "window_flops": 26539842732032.0,
        "mfu.quantize": 10.0418946246823, "k2_roofline": 23.973849728916427,
        "mfu.serve-decode": 1.3417514020238626},
    "opt-1.3b": {
        "quantize_layer_least_s": [0.05596847185580176] * 4 + [0.055966907033468426] * 4,
        "k2_layer_least_s": 0.0001923119684776122,
        "token_flops": [2818441216.0, 2417295360.0], "prompt_flops": 2577286955008.0,
        "k6_prompt_least_s": 0.00012019498029850746, "window_flops": 4731733147648.0,
        "mfu.quantize": 5.96988687409441, "k2_roofline": 12.508095510739006,
        "mfu.serve-decode": 0.23921805599838222},
}


def digest(tree) -> str:
    """sha256 over every tensor of a tree: its path, dtype, shape and bytes,
    in the order of the paths."""
    flat = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat.append((prefix[:-1], node))
    walk(tree, "")
    h = hashlib.sha256()
    for path, t in sorted(flat, key=lambda pt: pt[0]):
        h.update(f"{path}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("family, dtype", list(WEIGHTS), ids=lambda v: str(v))
def test_tiny_weights_are_the_same_bits(family, dtype):
    conf = {"llama": tiny.QWEN, "opt": tiny.OPT}[family]
    d = bench.family(conf["family"]).dims(conf)
    assert digest(weights.make_params(d, SEED, dtype, "cpu")) == WEIGHTS[(family, dtype)]


@pytest.mark.parametrize("name", list(COUNTS))
def test_work_counts_are_the_same_numbers(name):
    conf = bench.load_json(bench.PKG / "configs" / f"{name}.json")
    d = bench.family(conf["family"]).dims(conf)
    want = COUNTS[name]
    assert [work.quantize_layer_least_s(d, li, TOKENS, SEQ, r)
            for li, r in enumerate(RANKS[name])] == want["quantize_layer_least_s"]
    assert work.k2_layer_least_s(d, 0, 256, 128) == want["k2_layer_least_s"]
    assert [work.token_flops(d, 1000, True), work.token_flops(d, 7, False)] == want["token_flops"]
    assert work.prompt_flops(d, 1024) == want["prompt_flops"]
    assert work.k6_prompt_least_s(d, 1024) == want["k6_prompt_least_s"]
    assert work.window_flops(d, REQS) == want["window_flops"]


@pytest.mark.parametrize("name", list(COUNTS))
def test_count_readers_read_the_same_numbers(name):
    conf = bench.load_json(bench.PKG / "configs" / f"{name}.json")
    d = bench.family(conf["family"]).dims(conf)
    layers = len(RANKS[name])
    qrec = {"dims": d, "group_ranks": RANKS[name], "group_rows": [[TOKENS] * 4] * layers,
            "tokens": TOKENS, "seq": SEQ, "sweeps": 3, "wall_s": 22.5,
            "layers_per_sweep": layers, "traced_sweeps": 1, "block": 256, "group": 128,
            "trace": {"kernels": {"gptq_block_kernel": 0.0123}}}
    srec = {"dims": d, "traced": {"window_s": 2.0, "requests": REQS}}
    for metric, rec in (("mfu.quantize", qrec), ("k2_roofline", qrec), ("mfu.serve-decode", srec)):
        assert bench.reader(metric).read(rec) == COUNTS[name][metric], metric
