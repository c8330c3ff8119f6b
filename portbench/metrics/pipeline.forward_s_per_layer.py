"""Seconds a layer in the calibration pipeline's staged forwards and
re-forward (``calib.pipeline``: bf16 GEMMs, K6), from the program's
``stage_fwd`` and ``reforward`` phases."""
from portbench.lib.readers import phase_s_per_layer


def read(rec):
    return phase_s_per_layer(rec, "stage_fwd", "reforward")
