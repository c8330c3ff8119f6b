"""Seeded random weights, made on the device in a few large draws.

A configuration file holds the published ``config.json`` keys;
``dims`` reads the sizes from them by family.  Every layer is one
``torch.randn`` call on the card (its matrices and biases are slices of
it), seeded from ``--seed`` and the layer's index, so any layer can be
made again alone, bit for bit, for the reference.  Matrices are
N(0, 1/in_features), embeddings and a dense head N(0, 0.02^2), OPT's
learned positions N(0, 0.01^2) and its linear biases N(0, 0.01^2); norm
weights are ones and LayerNorm biases zeros (the configuration files list
these under ``assumed``).  The tree is the port's parameter layout.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str          # llama | opt
    hidden: int
    ff: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    max_pos: int
    eps: float
    tie: bool
    qk_norm: bool = False
    bias: bool = False    # llama's q/k/v bias
    rope_theta: float = 0.0

    @property
    def q_size(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.kv_heads * self.head_dim


def dims(conf: dict) -> Dims:
    """Sizes from a configuration file's published keys."""
    family = conf["family"]
    if family == "llama":
        return Dims(family=family, hidden=conf["hidden_size"], ff=conf["intermediate_size"],
                    layers=conf["num_hidden_layers"], heads=conf["num_attention_heads"],
                    kv_heads=conf["num_key_value_heads"],
                    head_dim=conf.get("head_dim")
                    or conf["hidden_size"] // conf["num_attention_heads"],
                    vocab=conf["vocab_size"], max_pos=conf["max_position_embeddings"],
                    eps=conf["rms_norm_eps"], tie=conf["tie_word_embeddings"],
                    qk_norm=conf["model_type"] == "qwen3",
                    bias=conf.get("attention_bias", False), rope_theta=conf["rope_theta"])
    if family == "opt":
        h, heads = conf["hidden_size"], conf["num_attention_heads"]
        return Dims(family=family, hidden=h, ff=conf["ffn_dim"],
                    layers=conf["num_hidden_layers"], heads=heads, kv_heads=heads,
                    head_dim=h // heads, vocab=conf["vocab_size"],
                    max_pos=conf["max_position_embeddings"], eps=1e-5, tie=True)
    raise ValueError(f"unknown family {family!r}")


OPT_POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding: row = position + 2


def linears(d: Dims) -> list[tuple[str, int, int, bool]]:
    """(path, out, in, has bias) of one layer's linears, in the order of
    the four quantization groups."""
    if d.family == "llama":
        return [("self_attn.q_proj", d.q_size, d.hidden, d.bias),
                ("self_attn.k_proj", d.kv_size, d.hidden, d.bias),
                ("self_attn.v_proj", d.kv_size, d.hidden, d.bias),
                ("self_attn.o_proj", d.hidden, d.q_size, False),
                ("mlp.gate_proj", d.ff, d.hidden, False),
                ("mlp.up_proj", d.ff, d.hidden, False),
                ("mlp.down_proj", d.hidden, d.ff, False)]
    h = d.hidden
    return [("self_attn.q_proj", h, h, True), ("self_attn.k_proj", h, h, True),
            ("self_attn.v_proj", h, h, True), ("self_attn.out_proj", h, h, True),
            ("fc1", d.ff, h, True), ("fc2", h, d.ff, True)]


def groups(d: Dims) -> list[list[str]]:
    """The four sequential quantization groups (modules sharing one input)."""
    names = [p for p, *_ in linears(d)]
    if d.family == "llama":
        return [names[0:3], names[3:4], names[4:6], names[6:7]]
    return [names[0:3], names[3:4], names[4:5], names[5:6]]


def sub_seed(seed: int, *tags) -> int:
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


def _gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _set(tree: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def make_layer(d: Dims, seed: int, li: int, dtype, device) -> dict:
    """Layer ``li``'s tree, from one draw."""
    specs = linears(d)
    sizes = [o * i for _, o, i, _ in specs] + [o for _, o, _, b in specs if b]
    flat = torch.randn(sum(sizes), generator=_gen(device, seed, "layer", li),
                       dtype=dtype, device=device)
    lp: dict = {}
    at = 0
    for path, o, i, _ in specs:
        w = flat[at:at + o * i].view(o, i)
        w.mul_(1.0 / i ** 0.5)
        _set(lp, path + ".w", w)
        at += o * i
    for path, o, _, b in specs:
        if b:
            _set(lp, path + ".b", flat[at:at + o].mul_(0.01))
            at += o

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    if d.family == "llama":
        lp["input_layernorm"] = {"weight": ones(d.hidden)}
        lp["post_attention_layernorm"] = {"weight": ones(d.hidden)}
        if d.qk_norm:
            lp["self_attn"]["q_norm"] = {"weight": ones(d.head_dim)}
            lp["self_attn"]["k_norm"] = {"weight": ones(d.head_dim)}
    else:
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            lp[ln] = {"weight": ones(d.hidden),
                      "bias": torch.zeros((d.hidden,), dtype=dtype, device=device)}
    return lp


def make_outer(d: Dims, seed: int, dtype, device) -> dict:
    """Everything outside the layers: embeddings, final norm, head."""
    model: dict = {"embed_tokens": {"weight": torch.randn(
        (d.vocab, d.hidden), generator=_gen(device, seed, "embed"), dtype=dtype,
        device=device).mul_(0.02)}}
    out: dict = {"model": model}
    if d.family == "opt":
        model["wpe"] = {"weight": torch.randn(
            (d.max_pos + OPT_POS_OFFSET, d.hidden), generator=_gen(device, seed, "wpe"),
            dtype=dtype, device=device).mul_(0.01)}
        model["norm"] = {"weight": torch.ones((d.hidden,), dtype=dtype, device=device),
                         "bias": torch.zeros((d.hidden,), dtype=dtype, device=device)}
    else:
        model["norm"] = {"weight": torch.ones((d.hidden,), dtype=dtype, device=device)}
    if not d.tie:
        out["lm_head"] = {"w": torch.randn(
            (d.vocab, d.hidden), generator=_gen(device, seed, "head"), dtype=dtype,
            device=device).mul_(0.02)}
    return out


def make_params(d: Dims, seed: int, dtype, device) -> dict:
    """The whole tree."""
    params = make_outer(d, seed, dtype, device)
    params["model"]["layers"] = [make_layer(d, seed, li, dtype, device) for li in range(d.layers)]
    return params


def get(tree: dict, dotted: str):
    for p in dotted.split("."):
        tree = tree[p]
    return tree
