"""K6's share of its roofline: its least time for the true lengths of the
prompts prefilled in the traced window (``counts/work.py``: causal QK^T and
PV at 989 TFLOP/s, or q, k, v and o over HBM, the larger) over the device
time of the ``causal_attention`` kernels."""
from portbench.counts import work
from portbench.lib.readers import kernel_time


def read(rec):
    t = kernel_time(rec, "causal_attention", exclude=("bwd",))
    lens = rec.get("prompt_lens_traced") or []
    if t is None or not lens:
        return None
    return 100.0 * sum(work.k6_prompt_least_s(rec["dims"], n) for n in lens) / t
