"""The least time of the sweeps' work (``counts/work.py``: one bf16
forward and the Grams at 989 TFLOP/s, the f32 factorization and GPTQ at
each group's rank at 67 TFLOP/s, from each swept layer's plan and the
rows that fed each group) over their timed walls."""
from portbench.counts import work


def read(rec):
    if not rec.get("wall_s") or "group_ranks" not in rec:
        return None
    if any(r is None for rows in rec["group_rows"] for r in rows):
        return None     # a routed group whose rows the program does not report
    need = sum(work.quantize_layer_least_s(rec["dims"], li, rec["tokens"], rec["seq"], r, rows)
               for li, (r, rows) in enumerate(zip(rec["group_ranks"], rec["group_rows"])))
    return 100.0 * need * rec["sweeps"] / rec["wall_s"]
