"""The traced window's share of time in which no kernel, copy or set ran
on the card."""
from portbench.lib.readers import idle_share


def read(rec):
    return idle_share(rec)
