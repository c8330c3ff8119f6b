"""What the two serving drivers share: the served model, the engine,
the harness's spans around the engine's two device calls, the window's
counters, and the check of a sample of the served requests.

The model follows ``tgq_torch.cli.serve``'s path without a checkpoint:
every decoder linear drawn in f32 from the seed and RTN-packed by the
port's ``rtn_pack`` (W4, group 128, asymmetric), bf16 embeddings, norms
and dense head, served greedily by ``tgq_torch.serve.Engine`` with bf16 KV
pages.  The layers are the family's (``families/<family>.py``); a family
whose ``SERVES`` is false is one the port's engine does not run.
"""
from __future__ import annotations

import math
import time

import torch

from portbench.lib import bench, traffic, weights
from portbench.lib.runctx import free_device, model_config, sync
from portbench.lib.trace import span


def pages_per_slot(mix: dict) -> int:
    page = mix["page_size"]
    return -(-(mix["prompt"]["max"] + mix["output"]["max"] + page) // page)


def build_engine(ctx, slots: int):
    """(engine, dims) for the cell's configuration and mix; the pool holds
    ``slots`` requests of the mix's largest size."""
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models.hf_import import rtn_pack
    from tgq_torch.serve import Engine, ServeConfig

    cell, mix, dev = ctx.cell, ctx.cell.mix, ctx.device
    fam = bench.family(cell.config["family"])
    if not fam.SERVES:
        raise ValueError(f"portbench: the port's engine does not serve family "
                         f"{cell.config['family']!r} (its families file says SERVES = False)")
    d = fam.dims(cell.config)
    cfg = model_config(cell.config, cell.config_name)
    spec = QuantSpec(bits=mix["w_bits"], group_size=mix["group_size"], sym=False)

    def pack(lp, li):
        for path, *_ in fam.layer_plan(d, li).linears:
            parent, leaf = path.rsplit(".", 1) if "." in path else ("", path)
            node = weights.get(lp, path)
            packed = rtn_pack(node["w"], spec, bias=node["b"].float() if "b" in node else None)
            (weights.get(lp, parent) if parent else lp)[leaf] = packed
        return _to_bf16(lp)

    params = fam.make_outer(d, ctx.seed, torch.bfloat16, dev)
    params["model"]["layers"] = [pack(fam.make_layer(d, ctx.seed, li, torch.float32, dev), li)
                                 for li in range(d.layers)]
    mpps = pages_per_slot(mix)
    a_bits = (ctx.control or {}).get("a_bits", mix["a_bits"])
    scfg = ServeConfig(max_slots=slots, page_size=mix["page_size"], num_pages=slots * mpps + 1,
                       max_pages_per_slot=mpps, max_new_tokens=mix["output"]["max"],
                       temperature=0.0, seed=0, decode_chunk=mix["decode_chunk"],
                       kv_bits=mix["kv_bits"], a_bits=a_bits,
                       prefill_chunk_tokens=mix["prefill_chunk_tokens"], page_alloc="auto")
    eng = Engine(params, cfg, scfg, device=str(dev))
    del params
    sync(dev)
    return eng, d


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(torch.bfloat16)
    return tree


class Spans:
    """Spans of the harness around the engine's ``decode_steps`` and
    ``prefill_batch`` calls while ``tracer`` records, with the decode steps
    and the prompts' true lengths they were given."""

    def __init__(self, tracer):
        from tgq_torch.serve import engine as engine_mod
        self.mod = engine_mod
        self.orig = (engine_mod.decode_steps, engine_mod.prefill_batch)
        self.decode_steps = 0
        self.true_lens: list[torch.Tensor] = []
        decode_steps, prefill_batch = self.orig

        def traced_decode(*args, **kwargs):
            if not tracer.active:
                return decode_steps(*args, **kwargs)
            with span("decode_steps", True):
                out = decode_steps(*args, **kwargs)
            self.decode_steps += int(args[9])
            return out

        def traced_prefill(*args, **kwargs):
            if not tracer.active:
                return prefill_batch(*args, **kwargs)
            with span("prefill_batch", True):
                out = prefill_batch(*args, **kwargs)
            self.true_lens.append(args[5])
            return out

        engine_mod.decode_steps, engine_mod.prefill_batch = traced_decode, traced_prefill

    def prompt_lens(self) -> list[int]:
        """True lengths of the prompts prefilled in the traced window."""
        return [int(x) for t in self.true_lens for x in t.tolist()]

    def close(self):
        self.mod.decode_steps, self.mod.prefill_batch = self.orig


def steps_in_flight(eng) -> int:
    """Decode steps dispatched whose tokens the host has not fetched yet
    (the engine's pending and speculative chunks): the window's steps are
    those of the chunks whose tokens it collected."""
    return sum(c.n for c in (getattr(eng, "_pending", None), getattr(eng, "_spec", None))
               if c is not None)


def window_work(reqs: list, k0: dict, t0: float, t1: float) -> dict:
    """Per request: its prompt length, output tokens collected before
    (``k0``, by request id) and at the window's end, and whether its first
    token came inside the window."""
    out = []
    for r in reqs:
        a = k0.get(r.rid, 0)
        b = len(r.output)
        first_in = bool(r.first_token_t) and t0 <= r.first_token_t <= t1
        if b > a or first_in:
            out.append((len(r.prompt), a, b, first_in))
    return {"requests": out}


def trace_start(ctx) -> float:
    """Seconds into the window at which a traced run starts its trace:
    the trace's span sits in the middle of the window, where the engine
    runs as it does through the rest of it."""
    return max(0.0, (ctx.seconds - ctx.cell.mix["trace_seconds"]) / 2)


def traced_counts(reqs: list, k0: dict, t0: float, tr) -> dict:
    """The traced window's length and per-request work, at its end
    (``k0`` and ``t0`` taken where the trace started)."""
    return {"window_s": tr.t1 - tr.t0, **window_work(reqs, k0, t0, time.time())}


def sample_for_check(done: list, n: int, seed: int) -> list:
    """``n`` finished requests drawn from the seed, with the one of the
    most output tokens and the one of the longest prompt among them."""
    if not done:
        return []
    must = {max(done, key=lambda r: len(r.output)).rid, max(done, key=lambda r: len(r.prompt)).rid}
    rest = [r for r in done if r.rid not in must]
    rng = traffic.rng_for(seed, 7)
    k = max(0, min(len(rest), n - len(must)))
    pick = [rest[int(i)] for i in rng.choice(len(rest), size=k, replace=False)] if k else []
    return [r for r in done if r.rid in must] + pick


def check_served(ctx, d, sample: list) -> dict:
    """The widest and the mean served gap of the sampled requests'
    tokens (reference.check_serve)."""
    from portbench.reference.check_serve import served_gaps
    if not sample:
        return {"served_gap": math.inf, "served_gap_mean": math.inf}
    free_device(ctx.device)
    mix, dev = ctx.cell.mix, ctx.device
    fam = bench.family(d.family)
    gaps = served_gaps(
        d, lambda li: fam.make_layer(d, ctx.seed, li, torch.float32, dev),
        fam.make_outer(d, ctx.seed, torch.bfloat16, dev),
        [(r.prompt, r.output) for r in sample], mix["w_bits"], mix["group_size"], dev)
    return {"served_gap": max(gaps), "served_gap_mean": sum(gaps) / len(gaps)}
