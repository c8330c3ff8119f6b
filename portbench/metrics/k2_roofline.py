"""K2's share of its roofline: the least time of every in-block GPTQ
launch the traced sweeps needed (``counts/work.py``, from the swept
layers' quantized modules and the block) over the device time of the
``gptq_block`` kernels in the trace."""
import math

from portbench.counts import work
from portbench.lib.readers import kernel_time


def read(rec):
    t = kernel_time(rec, "gptq_block")
    if t is None or not rec.get("traced_sweeps"):
        return None
    need = math.fsum(work.k2_layer_least_s(rec["dims"], li, rec["block"], rec["group"])
                     for li in range(rec["layers_per_sweep"]))
    return 100.0 * need * rec["traced_sweeps"] / t
