"""A decoder layer as the harness sees it, whatever its family: its
linears, its quantization groups in the program's sweep order, and what
the work counts need.  ``families/<family>.py`` gives one for each layer
index (``layer_plan(d, li)``); the driver, the check and the counts read
layers only through it, so layers of several kinds, and groups fed by the
rows routed to them, need no file of the harness but the family's."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple


class Linear(NamedTuple):
    path: str        # the module's path in the layer tree (``self_attn.q_proj``)
    out: int
    inp: int
    bias: bool


@dataclasses.dataclass(frozen=True)
class Group:
    """Modules that share one input and are quantized together (one
    Hessian, one factorization)."""
    paths: tuple[str, ...]
    n: int                  # the input's width
    routed: bool = False    # fed by the rows routed to it (none, at times), not every token


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    linears: tuple[Linear, ...]   # every linear of the layer, in the order of its draw
    groups: tuple[Group, ...]     # the quantization groups, in the program's sweep order
    attention: bool               # causal attention over the sequence at the model's heads
    token_macs: int               # multiply-adds of one token through the linears it passes

    def linear(self, path: str) -> Linear:
        return next(x for x in self.linears if x.path == path)


def dense(linears: list[Linear], groups: list[list[str]], attention: bool) -> LayerPlan:
    """A layer whose every token passes every linear, and whose every
    group is fed by every token."""
    width = {x.path: x.inp for x in linears}
    return LayerPlan(linears=tuple(linears),
                     groups=tuple(Group(tuple(g), width[g[0]]) for g in groups),
                     attention=attention, token_macs=sum(x.out * x.inp for x in linears))
