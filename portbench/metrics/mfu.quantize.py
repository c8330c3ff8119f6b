"""The least time of the sweeps' work (``counts/work.py``: one bf16
forward and the Grams at 989 TFLOP/s, the f32 factorization and GPTQ at
each group's rank at 67 TFLOP/s) over their timed walls."""
from portbench.counts import work


def read(rec):
    if not rec.get("wall_s") or "group_ranks" not in rec:
        return None
    need = sum(work.quantize_layer_least_s(rec["dims"], rec["tokens"], rec["seq"], r)
               for r in rec["group_ranks"])
    return 100.0 * need * rec["sweeps"] / rec["wall_s"]
