"""Seeded random weights, made on the device in a few large draws.

A family (``families/<family>.py``) lays out its trees and draws them
here: every layer's linears are one ``torch.randn`` call on the card
(``draw_linears``: its matrices and biases are slices of it), seeded from
``--seed`` and the layer's index, so any layer can be made again alone,
bit for bit, for the reference.  Matrices are N(0, 1/in_features) and
linear biases N(0, 0.01^2); what else a family draws, and its fixed
tensors (norm weights ones, LayerNorm biases zeros), its file says (the
configuration files list them under ``assumed``).  The tree is the port's
parameter layout.
"""
from __future__ import annotations

import hashlib

import torch

from portbench.lib import bench


def sub_seed(seed: int, *tags) -> int:
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


def gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def set_path(tree: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def get(tree: dict, dotted: str):
    for p in dotted.split("."):
        tree = tree[p]
    return tree


def draw_linears(linears, seed: int, li: int, dtype, device) -> dict:
    """Layer ``li``'s linears (``plan.Linear``s, in their order), from one draw."""
    sizes = [o * i for _, o, i, _ in linears] + [o for _, o, _, b in linears if b]
    flat = torch.randn(sum(sizes), generator=gen(device, seed, "layer", li),
                       dtype=dtype, device=device)
    lp: dict = {}
    at = 0
    for path, o, i, _ in linears:
        w = flat[at:at + o * i].view(o, i)
        w.mul_(1.0 / i ** 0.5)
        set_path(lp, path + ".w", w)
        at += o * i
    for path, o, _, b in linears:
        if b:
            set_path(lp, path + ".b", flat[at:at + o].mul_(0.01))
            at += o
    return lp


def make_params(d, seed: int, dtype, device) -> dict:
    """The whole tree of the sizes ``d`` (a family's ``dims``)."""
    fam = bench.family(d.family)
    params = fam.make_outer(d, seed, dtype, device)
    params["model"]["layers"] = [fam.make_layer(d, seed, li, dtype, device)
                                 for li in range(d.layers)]
    return params
