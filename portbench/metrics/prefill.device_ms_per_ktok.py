"""Device milliseconds per 1000 true prompt tokens under the span around
``prefill_batch``."""
from portbench.lib.readers import span_value


def read(rec):
    s = span_value(rec, "prefill_batch", "device_s")
    toks = sum(rec.get("prompt_lens_traced") or [])
    if s is None or toks == 0:
        return None
    return 1e3 * s / (toks / 1000.0)
