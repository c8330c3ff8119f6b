"""K2's share of its roofline: the least time of every in-block GPTQ
launch the traced sweeps needed (``counts/work.py``, from the modules'
shapes and the block) over the device time of the ``gptq_block`` kernels
in the trace."""
from portbench.counts import work
from portbench.lib.readers import kernel_time


def read(rec):
    t = kernel_time(rec, "gptq_block")
    if t is None or not rec.get("traced_sweeps"):
        return None
    need = work.k2_layer_least_s(rec["dims"], rec["block"], rec["group"])
    return 100.0 * need * rec["layers_per_sweep"] * rec["traced_sweeps"] / t
