"""The verdict of a run: every compared number against its limit."""
from __future__ import annotations

import math


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}).  The cell's limits file names
    the numbers it compares; a run is correct when it read each of them,
    finite and at most its limit.  A number the file does not name is
    printed with the limit None and not compared."""
    table = {}
    for name, value in checks.items():
        table[name] = {"value": float(value) if math.isfinite(value) else repr(float(value)),
                       "limit": limits.get(name)}
    correct = bool(limits) and all(
        name in checks and math.isfinite(checks[name]) and checks[name] <= limit
        for name, limit in limits.items())
    return correct, table
