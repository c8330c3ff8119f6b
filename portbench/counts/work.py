"""The work a cell's inputs need, counted from shapes: the least
operations and bytes, never what an implementation happens to do, so a
share of a peak or a roofline cannot pass 100 % when a later change
removes work.  Times are least times on the card of ``peaks.json``.

A layer's shapes come from its family's plan (``families/<family>.py::
layer_plan``): its linears, whether it attends, the multiply-adds of one
token, and its quantization groups with the rows that fed each (every
token, or for a routed group the rows the run reports).  Work outside
the linears and the attention (norms, activations, a short convolution,
a router's choice) is not counted: the count stays a least one."""
from __future__ import annotations

import json
from pathlib import Path

from portbench.lib import bench

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_s(flops: float = 0.0, nbytes: float = 0.0, flop_rate: float | None = None) -> float:
    """The larger of operations over their peak and bytes over HBM's."""
    rate = flop_rate or PEAKS["bf16_flop_per_s"]
    return max(flops / rate, nbytes / PEAKS["hbm_bytes_per_s"])


def plan(d, li: int):
    """Layer ``li``'s plan in the family of the sizes ``d``."""
    return bench.family(d.family).layer_plan(d, li)


def model_macs(d) -> int:
    """Multiply-adds of one token through every layer's linears (a routed
    token: through its experts)."""
    return sum(plan(d, li).token_macs for li in range(d.layers))


def attention_layers(d) -> int:
    """The layers that attend over the sequence."""
    return sum(1 for li in range(d.layers) if plan(d, li).attention)


def causal_attention_flops(d, seq: int) -> float:
    """QK^T and PV over the causal half of one sequence, one layer."""
    return 2.0 * 2.0 * (seq * (seq + 1) / 2) * d.head_dim * d.heads


def causal_attention_bytes(d, seq: int) -> float:
    """q, k, v read once and o written once, bf16, one layer."""
    return 2.0 * seq * d.head_dim * (2 * d.heads + 2 * d.kv_heads)


# ---------------------------------------------------------------- quantize

def gptq_flops(m: int, n: int, rank: int) -> float:
    """Error propagation of GPTQ on an (m, n) weight whose factor has
    ``rank`` rows before its identity tail: each of the first ``rank``
    columns updates every later column (f32 multiply-adds, x2)."""
    r = min(rank, n)
    return 2.0 * m * (r * n - r * (r + 1) / 2)


def factor_flops(rank: int) -> float:
    """One Cholesky factorization at the rank the module reached."""
    return rank ** 3 / 3.0


def quantize_layer_least_s(d, li: int, n_tokens: int, seq: int, ranks: list[int],
                           rows: list[int] | None = None) -> float:
    """Least time of layer ``li`` in the sweep: one bf16 forward of the
    calibration tokens through the quantized layer (each group's input is
    needed once), each group's Gram as its symmetric half in bf16 (n^2 x
    the rows that fed it), and the f32 factorization and GPTQ propagation
    at each group's rank.  ``ranks`` and ``rows`` follow the plan's groups;
    ``rows`` None: every group fed by all ``n_tokens`` (no routed group)."""
    p = plan(d, li)
    if rows is None:
        if any(g.routed for g in p.groups):
            raise ValueError(f"layer {li} has routed groups: their rows are the run's")
        rows = [n_tokens] * len(p.groups)
    fed = {path: r for g, r in zip(p.groups, rows) for path in g.paths}
    fwd = 2.0 * sum(x.out * x.inp * fed.get(x.path, n_tokens) for x in p.linears)
    if p.attention:
        fwd += causal_attention_flops(d, seq) * (n_tokens // seq)
    gram = 0.0
    f32 = 0.0
    for g, r, n_rows in zip(p.groups, ranks, rows):
        gram += float(g.n) * g.n * n_rows        # n^2 rows multiply-adds: the half
        f32 += factor_flops(r)
        f32 += sum(gptq_flops(p.linear(path).out, g.n, r) for path in g.paths)
    return (fwd + gram) / PEAKS["bf16_flop_per_s"] + f32 / PEAKS["f32_flop_per_s"]


def k2_launch_least_s(m: int, b: int, group: int) -> float:
    """Least time of one in-block GPTQ launch on an (m, b) block: the f32
    block of W in and its error out, the (b, b) factor block in, 4-bit
    codes out, one scale and zero a group; m b^2 f32 operations."""
    nbytes = 4.0 * m * b * 2 + 4.0 * b * b + 0.5 * m * b + 8.0 * m * b / group
    return least_s(flops=float(m) * b * b, nbytes=nbytes, flop_rate=PEAKS["f32_flop_per_s"])


def k2_layer_least_s(d, li: int, block: int, group: int) -> float:
    """K2's least time over layer ``li``: every quantized module, every block."""
    p = plan(d, li)
    total = 0.0
    for g in p.groups:
        for path in g.paths:
            m = p.linear(path).out
            for i1 in range(0, g.n, block):
                total += k2_launch_least_s(m, min(block, g.n - i1), group)
    return total


# ----------------------------------------------------------------- serving

def token_flops(d, context: int, head: bool) -> float:
    """Model operations of one token at ``context`` positions (itself
    included): 2 x the parameters it passes through, attention over its
    context in every layer, and the head if it yields a token."""
    f = 2.0 * model_macs(d)
    f += 2.0 * 2.0 * context * d.head_dim * d.heads * attention_layers(d)
    if head:
        f += 2.0 * d.vocab * d.hidden
    return f


def prompt_flops(d, n: int) -> float:
    """A prefill of ``n`` prompt tokens: every token through the layers
    over its causal context, one token through the head."""
    f = 2.0 * model_macs(d) * n
    f += causal_attention_flops(d, n) * attention_layers(d)
    return f + 2.0 * d.vocab * d.hidden


def k6_prompt_least_s(d, n: int) -> float:
    """K6's least time for one prompt of ``n`` tokens over every layer."""
    return attention_layers(d) * least_s(causal_attention_flops(d, n),
                                         causal_attention_bytes(d, n))


def window_flops(d, requests) -> float:
    """Model operations of the tokens a serving window processed: each
    request as (prompt length, output tokens before, output tokens after,
    first token inside the window); its prompt if its first token came in
    the window, and every later output token's decode step."""
    per_layer_linear = 2.0 * model_macs(d)
    attn_per_ctx = 4.0 * d.head_dim * d.heads * attention_layers(d)
    head = 2.0 * d.vocab * d.hidden
    total = 0.0
    for p, a, b, first_in in requests:
        if first_in:
            total += prompt_flops(d, p)
        lo = max(a, 1)
        n = b - lo
        if n > 0:
            # output token k is decoded from position p + k - 1, over p + k positions
            ctx_sum = n * p + (lo + b - 1) * n / 2.0
            total += n * (per_layer_linear + head) + attn_per_ctx * ctx_sum
    return total
