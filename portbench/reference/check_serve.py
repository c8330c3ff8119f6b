"""The comparison that decides a serve cell's ``correct``.

The reference packs the dense f32 weights the benchmark made by its own
round-to-nearest (asymmetric, grouped), dequantizes them, and runs a full-
recompute f32 forward over each sampled request's prompt and served
tokens.  At every position that produced a served token (the prefill's
last prompt token, then each decode step) it reads how far the served
token's logit lies below the reference's best one, in standard deviations
of the reference's logits at that position (``served_gap``: free of the
random weights' logit scale; a token drawn at random reads about 4).
That is the whole path a served token takes: prefill (the packed matmuls
at prompt length, K6), then decode through the paged cache (the packed
matmuls at the decode batch, K5), greedy.  The harness holds the widest
gap (``served_gap``: one wrong token reads several deviations) and the
mean over the served tokens (``served_gap_mean``: how often and how far
the served tokens leave the reference's best, which a lower precision
moves).
"""
from __future__ import annotations

import torch

from portbench.lib import bench
from portbench.reference.truncgptq import rtn


def _get(tree, dotted):
    for p in dotted.split("."):
        tree = tree[p]
    return tree


@torch.no_grad()
def served_gaps(d, make_layer, outer, requests, bits: int, group: int, device,
                seqs_at_once: int = 2) -> list[float]:
    """Gap of every served token of ``requests`` ([(prompt, output)]),
    request by request in order.  ``make_layer(li)`` the dense layer tree;
    the layers are the family's (``families/<family>.py::ref_layer``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    fam = bench.family(d.family)
    o = fam.ref_outer(d, outer, f32)
    seqs = [list(p) + list(out[:-1]) for p, out in requests]
    t_max = max(len(s) for s in seqs)
    ids = torch.zeros((len(seqs), t_max), dtype=torch.long, device=device)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = torch.tensor(s, dtype=torch.long)
    x_all = torch.cat([fam.ref_embed(d, o, ids[i:i + 1], f32) for i in range(len(seqs))])
    for li in range(d.layers):
        plan = fam.layer_plan(d, li)
        lp = make_layer(li)
        t = fam.ref_tensors(d, lp, f32)
        w = {}
        for x in plan.linears:
            node = _get(lp, x.path)
            w[x.path] = (rtn(node["w"].float(), bits, group)[0],
                         node["b"].float() if "b" in node else None)
        del lp
        for b0 in range(0, len(seqs), seqs_at_once):
            *_, y = fam.ref_layer(d, li, w, t, x_all[b0:b0 + seqs_at_once])
            x_all[b0:b0 + seqs_at_once] = y
        del w
    head = o["head"].float()
    gaps = []
    for i, (p, out) in enumerate(requests):
        pos = torch.arange(len(p) - 1, len(p) - 1 + len(out), device=device)
        logits = fam.ref_final(d, o, x_all[i, pos]) @ head.T
        served = torch.tensor(list(out), dtype=torch.long, device=device)
        gap = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
        gaps.extend((gap / logits.std(-1)).tolist())
    return gaps
