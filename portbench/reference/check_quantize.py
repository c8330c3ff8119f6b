"""The comparison that decides a quantize cell's ``correct``.

The program's sweep is followed layer by layer from its own state: the
reference recomputes every group's input in f32 through the program's
quantized weights of the earlier groups (its codes, scales and zeros,
rounded to bf16 as the program hands the model on), and each solver
stage from the program's own input to that stage.  The layers are the
family's (``families/<family>.py``): its plan names each layer's groups
in sweep order, and its ``ref_layer`` yields each group's input rows
(for a routed group, only the rows routed to it, at times none), then
the layer's output.  Each layer's captured factorizations are matched to
its plan's groups; where their counts or widths differ the check raises
``CaptureMismatch`` and reads nothing.  A group fed by no row has a zero
Hessian: it keeps no pivot, and its modules round to nearest.

- ``gram_rel``: every group's Hessian against the f64 Gram of the
  reference's f32 activations (calibration forwards, K6, the Grams; 0
  where both are zero);
- ``act_rel``: one calibration batch of each layer's output, the input
  the program hands the next layer, against the reference's f32 forward;
- ``pivot_regret``: along the program's pivot order, the largest
  remaining f64 Schur diagonal less the chosen one, over the kept pivots,
  relative to the first pivot (the greedy sweep, K1);
- ``rank_gap``: the program's rank against the energy rule on that f64
  sweep, over the group's width;
- ``factor_rel``: the program's factor against the f64 factor built from
  the program's Hessian, pivots and rank (the factor build);
- ``code_miss``: the share of a module's codes that differ from an f64
  GPTQ run on the program's factor, at the worst module (K2 and the
  blocks' error propagation); one rounding that goes the other way
  changes the errors carried along its row, so a few rows differ widely;
- ``loss_ratio``: at the worst module, the program's GPTQ loss
  sum over rows of (w - q) H (w - q)^T on its Hessian, over that f64 run's;
- ``grid_miss``: scales and zeros that differ from the RTN parameters of
  the original weight, and written-back weights that differ from their
  codes' bf16 dequantization (exact).

``control_captures`` is the control: the same sweep computed by this
reference in f32 with TF32 products, in the program's place.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.lib import bench
from portbench.reference.truncgptq import (
    Gram,
    dequantize,
    energy_rank,
    find_params,
    gptq,
    pivoted_cholesky,
    truncated_factor,
)


@dataclasses.dataclass
class GroupCapture:
    h: torch.Tensor        # the program's Hessian (n, n)
    perm: torch.Tensor     # its pivot order
    rank: int
    r: torch.Tensor        # its factor (n, n), pivot order


@dataclasses.dataclass
class ModuleCapture:
    codes: torch.Tensor    # (m, n) integer codes
    scale: torch.Tensor    # (m, n / group)
    zero: torch.Tensor
    w: torch.Tensor        # the written-back (m, n) weight


@dataclasses.dataclass
class LayerCapture:
    groups: list           # a GroupCapture for each of the plan's groups, in sweep order
    modules: dict          # path -> ModuleCapture
    out_sample: torch.Tensor  # the layer's output for calibration batch ``sample``


NUMBERS = ("gram_rel", "act_rel", "pivot_regret", "rank_gap", "factor_rel",
           "code_miss", "loss_ratio", "grid_miss")


def _worst(a: float, b: float) -> float:
    """The larger reading; a NaN reads as infinite, never as the smaller."""
    if a != a or b != b:
        return float("inf")
    return max(a, b)


class CaptureMismatch(ValueError):
    """The program's captures do not line up with the family's plan."""


def _rel(a, b) -> float:
    nb = torch.linalg.norm(b.double())
    if nb == 0:
        return 0.0 if bool((a == b).all()) else float("inf")
    return float(torch.linalg.norm((a - b).double()) / nb)


def _get(tree, dotted):
    for p in dotted.split("."):
        tree = tree[p]
    return tree


def _bias(lp, path, dtype):
    node = _get(lp, path)
    return node["b"].to(dtype) if "b" in node else None


def _regret(regret, piv, rank: int) -> float:
    """The kept pivots' largest regret over the first pivot; 0 where no
    pivot was kept or the Hessian is zero."""
    worst = float(regret[:rank].max()) if rank else 0.0
    first = float(piv[0])
    if first > 0:
        return worst / first
    return 0.0 if worst == 0 else float("inf")


def check_group(gc: GroupCapture, weights: list, params: list, s: dict) -> dict:
    """The solver numbers of one group: ``weights`` the group's original
    weights (m_i, n), ``params`` the program's (codes, scale, zero) of each."""
    n = gc.h.shape[0]
    h = gc.h.double()
    perm = gc.perm.to(h.device).long()
    L, _, piv, regret = pivoted_cholesky(h, order=perm)
    r_ref = energy_rank(L, piv, float(torch.diagonal(h).sum()), s["eps"], s["pivot_rtol"])
    out = {"rank_gap": abs(r_ref - gc.rank) / n, "pivot_regret": _regret(regret, piv, gc.rank)}
    rf = truncated_factor(L, perm, gc.rank)
    out["factor_rel"] = _rel(gc.r.double(), rf)
    del L, rf
    w = torch.cat([x.double() for x in weights])
    scale = torch.cat([p[1] for p in params]).double()
    zero = torch.cat([p[2] for p in params]).double()
    codes = gptq(w, gc.r.double(), perm, scale, zero, s["bits"], s["group"], s["block"])
    prog = torch.cat([p[0] for p in params]).to(codes.device).to(codes.dtype)
    g = s["group"]
    loss_p = _row_loss(w, dequantize(prog, scale, zero, g), h)
    loss_r = _row_loss(w, dequantize(codes, scale, zero, g), h)
    out["code_miss"] = out["loss_ratio"] = 0.0
    at = 0
    for x in weights:
        rows = slice(at, at + x.shape[0])
        out["code_miss"] = _worst(out["code_miss"],
                                  float((codes[rows] != prog[rows]).double().mean()))
        out["loss_ratio"] = _worst(out["loss_ratio"], float(
            loss_p[rows].sum() / loss_r[rows].sum().clamp(min=1e-300)))
        at += x.shape[0]
    return out


def _row_loss(w, wq, h):
    """(w - wq) H (w - wq)^T of every row."""
    e = w - wq
    return ((e @ h) * e).sum(1)


def _aligned(fam, d, captures: list) -> None:
    for li, cap in enumerate(captures):
        groups = fam.layer_plan(d, li).groups
        if len(cap.groups) != len(groups):
            raise CaptureMismatch(
                f"layer {li}: the program factorized {len(cap.groups)} groups, the plan of "
                f"family {d.family!r} holds {len(groups)}")
        for gi, (g, gc) in enumerate(zip(groups, cap.groups)):
            if tuple(gc.h.shape) != (g.n, g.n):
                raise CaptureMismatch(f"layer {li} group {gi} ({g.paths[0]}): a Hessian of "
                                      f"{tuple(gc.h.shape)}, the plan's input is {g.n} wide")


def _weights(lp: dict, plan, dtype, quantized: dict) -> dict:
    """Path -> (weight, bias or None) of every linear of the layer: the
    ``quantized`` weight where given, the original elsewhere."""
    out = {}
    for x in plan.linears:
        w = quantized[x.path] if x.path in quantized else _get(lp, x.path)["w"].to(dtype)
        out[x.path] = (w, _bias(lp, x.path, dtype))
    return out


@torch.no_grad()
def check_sweep(d, make_layer, outer, ids, s: dict, captures: list, solver_layers,
                sample: int, device) -> dict:
    """The numbers of one sweep (module docstring).  ``make_layer(li)`` the
    original layer tree, ``outer`` the tree outside the layers, ``ids``
    the calibration ids, ``s`` the settings (bits, group, eps, pivot_rtol,
    block, batch), ``sample`` the calibration batch of ``out_sample``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, f64 = torch.float32, torch.float64
    fam = bench.family(d.family)
    _aligned(fam, d, captures)
    o = fam.ref_outer(d, outer, f32)
    ids = torch.as_tensor(ids, device=device).long()
    n_seq, seq = ids.shape
    bs = s["batch"]
    x_all = torch.empty((n_seq, seq, d.hidden), dtype=f32, device=device)
    for b0 in range(0, n_seq, bs):
        x_all[b0:b0 + bs] = fam.ref_embed(d, o, ids[b0:b0 + bs], f32)
    nums = {k: 0.0 for k in NUMBERS}
    for li, cap in enumerate(captures):
        plan = fam.layer_plan(d, li)
        lp = make_layer(li)
        t = fam.ref_tensors(d, lp, f32)
        deqs = {}
        for path, mc in cap.modules.items():
            orig = _get(lp, path)["w"].float()
            sc, ze = find_params(orig, s["bits"], s["group"])
            nums["grid_miss"] += float((sc != mc.scale).sum() + (ze != mc.zero).sum())
            deq = dequantize(mc.codes, mc.scale, mc.zero, s["group"]).to(torch.bfloat16)
            nums["grid_miss"] += float((deq != mc.w.to(torch.bfloat16)).sum())
            deqs[path] = deq.float()
        wq = _weights(lp, plan, f32, deqs)
        grams = [Gram(g.n, f64, device) for g in plan.groups]
        for b0 in range(0, n_seq, bs):
            rows = fam.ref_layer(d, li, wq, t, x_all[b0:b0 + bs])
            for gram, x in zip(grams, rows):
                gram.update(x)
            x_all[b0:b0 + bs] = next(rows)
            del rows
        ref_out = x_all[sample * bs:(sample + 1) * bs]
        nums["act_rel"] = _worst(nums["act_rel"], _rel(cap.out_sample.float(), ref_out))
        for gi, (g, gc) in enumerate(zip(plan.groups, cap.groups)):
            nums["gram_rel"] = _worst(nums["gram_rel"], _rel(gc.h, grams[gi].value()))
            grams[gi] = None
            if li in solver_layers:
                got = check_group(gc, [_get(lp, p)["w"] for p in g.paths],
                                  [(cap.modules[p].codes, cap.modules[p].scale,
                                    cap.modules[p].zero) for p in g.paths], s)
                for k, v in got.items():
                    nums[k] = _worst(nums[k], v)
        del lp, wq, grams
    return nums


@torch.no_grad()
def control_captures(d, make_layer, outer, ids, s: dict, n_layers: int, sample: int,
                     device) -> list:
    """The sweep computed by this reference in f32 with TF32 products (the
    next precision below the program's exact-f32 solver), as captures of
    the program's kind."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _sweep(d, make_layer, outer, ids, s, n_layers, sample, device, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _solve_group(h, weights, s):
    L, perm, piv, _ = pivoted_cholesky(h)
    rank = energy_rank(L, piv, float(torch.diagonal(h).sum()), s["eps"], s["pivot_rtol"])
    r = truncated_factor(L, perm, rank)
    out = []
    for w in weights:
        sc, ze = find_params(w.float(), s["bits"], s["group"])
        q = gptq(w.to(h.dtype), r, perm, sc, ze, s["bits"], s["group"], s["block"])
        out.append(ModuleCapture(codes=q, scale=sc, zero=ze,
                                 w=dequantize(q, sc, ze, s["group"]).to(torch.bfloat16)))
    return GroupCapture(h=h.float(), perm=perm, rank=rank, r=r.float()), out


def _nth(gen, k: int):
    """The ``k``-th value a generator yields (it is left unfinished)."""
    for i, v in enumerate(gen):
        if i == k:
            return v
    raise IndexError(k)


def _sweep(d, make_layer, outer, ids, s, n_layers, sample, device, dt):
    """Each group's input is the layer run up to it, through the groups
    already quantized (the layer is run anew for each group)."""
    fam = bench.family(d.family)
    o = fam.ref_outer(d, outer, dt)
    ids = torch.as_tensor(ids, device=device).long()
    n_seq, seq = ids.shape
    bs = s["batch"]
    x_all = torch.empty((n_seq, seq, d.hidden), dtype=dt, device=device)
    for b0 in range(0, n_seq, bs):
        x_all[b0:b0 + bs] = fam.ref_embed(d, o, ids[b0:b0 + bs], dt).to(torch.bfloat16).to(dt)
    caps = []
    for li in range(n_layers):
        plan = fam.layer_plan(d, li)
        lp = make_layer(li)
        t = fam.ref_tensors(d, lp, dt)
        wq = _weights(lp, plan, dt, {})
        gcs, mods = [], {}
        for gi, g in enumerate(plan.groups):
            gram = Gram(g.n, dt, device)
            for b0 in range(0, n_seq, bs):
                gram.update(_nth(fam.ref_layer(d, li, wq, t, x_all[b0:b0 + bs]), gi))
            gc, mcs = _solve_group(gram.value(), [_get(lp, p)["w"] for p in g.paths], s)
            gcs.append(gc)
            for p, mc in zip(g.paths, mcs):
                mods[p] = mc
                wq[p] = (mc.w.to(dt), wq[p][1])
        out_sample = None
        for b0 in range(0, n_seq, bs):
            y = _nth(fam.ref_layer(d, li, wq, t, x_all[b0:b0 + bs]), len(plan.groups))
            x_all[b0:b0 + bs] = y.to(torch.bfloat16).to(dt)
            if b0 == sample * bs:
                out_sample = y.to(torch.bfloat16)
        caps.append(LayerCapture(groups=gcs, modules=mods, out_sample=out_sample))
    return caps
