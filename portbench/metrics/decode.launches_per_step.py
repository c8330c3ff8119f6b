"""Launch calls a decode step under the span around ``decode_steps``
(kernel events where a launch call was not recorded)."""
from portbench.lib.readers import span_value


def read(rec):
    n = span_value(rec, "decode_steps", "launches")
    if n is None or not rec.get("traced_decode_steps"):
        return None
    return n / rec["traced_decode_steps"]
