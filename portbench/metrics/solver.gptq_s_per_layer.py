"""Seconds a layer in the GPTQ loop (``solver.gptq_loop``: K2, the inter-
block and relative-error products), from the program's ``quantize``
phase."""
from portbench.lib.readers import phase_s_per_layer


def read(rec):
    return phase_s_per_layer(rec, "quantize")
