"""The model operations of every token the traced window processed
(prompts whose first token came in it, and every decode step), at the
bf16 peak, over that window."""
from portbench.lib.readers import serve_mfu


def read(rec):
    return serve_mfu(rec)
