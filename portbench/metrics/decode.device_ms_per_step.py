"""Device milliseconds a decode step: the kernels launched under the
harness's span around ``decode_steps``, over the steps it ran."""
from portbench.lib.readers import span_value


def read(rec):
    s = span_value(rec, "decode_steps", "device_s")
    if s is None or not rec.get("traced_decode_steps"):
        return None
    return 1e3 * s / rec["traced_decode_steps"]
