"""A test-only model family of two layer kinds, for the check's plumbing:
a ``dense`` layer (RMSNorm, a SiLU GLU: groups gate/up and down, fed by
every token) and a ``moe`` layer (RMSNorm, a top-1-of-``num_experts``
router over the normed hidden, each expert an up / ReLU / down MLP: one
group for each expert's up, then one for each expert's down, each fed by
the rows routed to that expert).  The router is not quantized.  A
``moe`` layer's ``expert_bias`` (from the configuration, by layer index)
is added to the router's scores for the choice alone, as LFM2's is; a
large negative one leaves its expert with no row.  No attention: a
token's hidden state is a function of its id.

It lives under ``tests/`` and is no family of the benchmark: a test hands
it to the harness in place of ``bench.family``'s lookup.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.lib import weights
from portbench.lib.plan import Group, LayerPlan, Linear, dense
from portbench.reference.layers import linear, rms_norm

SERVES = False


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str
    hidden: int
    ff: int
    expert_ff: int
    experts: int
    kinds: tuple
    expert_bias: tuple   # a tuple of each layer's bias (zeros where none)
    vocab: int
    eps: float
    layers: int
    heads: int = 1
    kv_heads: int = 1
    head_dim: int = 0
    max_pos: int = 1 << 20


def dims(conf: dict) -> Dims:
    kinds = tuple(conf["layer_types"])
    e = conf["num_experts"]
    bias = tuple(tuple(conf["expert_bias"].get(str(li), [0.0] * e)) for li in range(len(kinds)))
    return Dims(family=conf["family"], hidden=conf["hidden_size"],
                ff=conf["intermediate_size"], expert_ff=conf["moe_intermediate_size"],
                experts=e, kinds=kinds, expert_bias=bias, vocab=conf["vocab_size"],
                eps=conf["norm_eps"], layers=conf["num_hidden_layers"],
                head_dim=conf["hidden_size"])


def port_config(conf: dict, name: str) -> dict:
    raise NotImplementedError("the port has no such family")


def _up(e: int) -> str:
    return f"experts.{e}.up_proj"


def _down(e: int) -> str:
    return f"experts.{e}.down_proj"


def layer_plan(d: Dims, li: int) -> LayerPlan:
    h = d.hidden
    if d.kinds[li] == "dense":
        lin = [Linear("mlp.gate_proj", d.ff, h, False), Linear("mlp.up_proj", d.ff, h, False),
               Linear("mlp.down_proj", h, d.ff, False)]
        return dense(lin, [["mlp.gate_proj", "mlp.up_proj"], ["mlp.down_proj"]], attention=False)
    es = range(d.experts)
    lin = ([Linear("router", d.experts, h, False)]
           + [Linear(_up(e), d.expert_ff, h, False) for e in es]
           + [Linear(_down(e), h, d.expert_ff, False) for e in es])
    groups = ([Group((_up(e),), h, routed=True) for e in es]
              + [Group((_down(e),), d.expert_ff, routed=True) for e in es])
    return LayerPlan(linears=tuple(lin), groups=tuple(groups), attention=False,
                     token_macs=d.experts * h + 2 * d.expert_ff * h)


def make_layer(d: Dims, seed: int, li: int, dtype, device) -> dict:
    lp = weights.draw_linears(layer_plan(d, li).linears, seed, li, dtype, device)
    lp["norm"] = {"weight": torch.ones((d.hidden,), dtype=dtype, device=device)}
    if d.kinds[li] == "moe":
        lp["router"]["expert_bias"] = torch.tensor(d.expert_bias[li], dtype=dtype, device=device)
    return lp


def make_outer(d: Dims, seed: int, dtype, device) -> dict:
    return {"model": {
        "embed_tokens": {"weight": torch.randn((d.vocab, d.hidden),
                                               generator=weights.gen(device, seed, "embed"),
                                               dtype=dtype, device=device)},
        "norm": {"weight": torch.ones((d.hidden,), dtype=dtype, device=device)}}}


def ref_outer(d: Dims, outer: dict, dtype) -> dict:
    m = outer["model"]
    return {"embed": m["embed_tokens"]["weight"], "norm": (m["norm"]["weight"].to(dtype),),
            "head": m["embed_tokens"]["weight"]}


def ref_embed(d: Dims, o: dict, ids, dtype):
    return o["embed"][ids].to(dtype)


def ref_final(d: Dims, o: dict, x):
    return rms_norm(x, o["norm"][0], d.eps)


def ref_tensors(d: Dims, lp: dict, dtype) -> dict:
    out = {"norm": lp["norm"]["weight"].to(dtype)}
    if "router" in lp:
        out["expert_bias"] = lp["router"]["expert_bias"].to(dtype)
    return out


def routes(d: Dims, w: dict, t: dict, h) -> torch.Tensor:
    """Each token's expert (top-1 of the router's scores plus the bias)."""
    return (linear(h, w["router"]) + t["expert_bias"]).argmax(-1)


def ref_layer(d: Dims, li: int, w: dict, t: dict, x):
    h = rms_norm(x, t["norm"], d.eps)
    if d.kinds[li] == "dense":
        yield h
        act = torch.nn.functional.silu(linear(h, w["mlp.gate_proj"])) * linear(h, w["mlp.up_proj"])
        yield act
        yield x + linear(act, w["mlp.down_proj"])
        return
    hf = h.reshape(-1, d.hidden)
    choice = routes(d, w, t, hf)
    idx = [(choice == e).nonzero().squeeze(1) for e in range(d.experts)]
    for e in range(d.experts):
        yield hf[idx[e]]
    acts = []
    for e in range(d.experts):
        acts.append(torch.relu(linear(hf[idx[e]], w[_up(e)])))
        yield acts[e]
    y = x.reshape(-1, d.hidden).clone()
    for e in range(d.experts):
        y.index_add_(0, idx[e], linear(acts[e], w[_down(e)]))
    yield y.reshape(x.shape)
