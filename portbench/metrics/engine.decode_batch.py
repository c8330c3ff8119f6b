"""Requests decoded a step: the engine's tokens emitted in the window less
its first tokens, over its decode steps (``Engine.tokens_emitted``,
``Engine.steps``)."""


def read(rec):
    if not rec.get("steps"):
        return None
    return (rec["tokens"] - rec["first_tokens"]) / rec["steps"]
