"""Seconds a layer in the factorization (``solver.pchol``: the K1 sweep
and the factor build), from the program's ``factorize`` phase."""
from portbench.lib.readers import phase_s_per_layer


def read(rec):
    return phase_s_per_layer(rec, "factorize")
