"""Seconds a layer in the Gram accumulation (``solver.hessian``), from the
program's ``accumulate`` phase."""
from portbench.lib.readers import phase_s_per_layer


def read(rec):
    return phase_s_per_layer(rec, "accumulate")
