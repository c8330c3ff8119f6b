"""The serving engine's spans and chunk counters on the CPU.

Under a recording ``torch.profiler`` every tick's host work is a
``tgq.engine.*`` span, ``decode_dispatch`` inside ``step``; without one
``span`` is a single shared null context.  ``Engine.chunks`` counts the
decode chunks dispatched and ``Engine.spec_chunks`` those dispatched before
the previous chunk's tokens were fetched.  Tracing changes no token.
"""
import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tgq_torch.core.quant import QuantSpec
from tgq_torch.models import PRESETS
from tgq_torch.models.hf_import import init_packed_params
from tgq_torch.serve import Engine, ServeConfig
from tgq_torch.utils.profiling import span

CFG = PRESETS["tiny-qwen3"]
SPANS = {"step", "admit", "prefill_dispatch", "prefill_collect", "schedule",
         "decode_dispatch", "fetch", "fold"}
PROMPTS = [[5, 17, 42, 100, 7], [1, 2, 3], [10, 20, 30, 40, 50, 60], [99, 98]]


@pytest.fixture(scope="module")
def packed():
    return init_packed_params(CFG, QuantSpec(bits=4, group_size=32), seed=0, device="cpu")


def engine(packed, **kw):
    base = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_slot=8,
                max_new_tokens=6, decode_chunk=8)
    return Engine(packed, CFG, ServeConfig(**{**base, **kw}), device="cpu")


def serve(packed, prompts, **kw):
    eng = engine(packed, **kw)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    return eng, [r.output for r in reqs]


def test_every_tick_span_is_traced_and_tokens_do_not_change(packed, tmp_path):
    _, plain = serve(packed, PROMPTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, traced = serve(packed, PROMPTS)
    assert traced == plain
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["name"][len("tgq.engine."):], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e["name"].startswith("tgq.")]
    assert {name for name, *_ in spans} == SPANS
    steps = [(a, b) for name, a, b in spans if name == "step"]
    for name, a, b in spans:
        if name == "decode_dispatch":
            assert any(s0 <= a and b <= s1 for s0, s1 in steps)
            # nothing inside the chunk is a span
            assert not any(a <= a2 and b2 <= b for n2, a2, b2 in spans if n2 != name)


# one request, a budget of 18 tokens, chunks of up to 8: the first token
# comes from the prefill, then 8 + 8 + 1 decode steps.  Overlapped, the
# second and third chunks are dispatched before the previous one's fetch,
# each from the budget the host had then (8 steps), and the third's last
# 7 tokens are dropped.
@pytest.mark.parametrize("overlap,chunks,spec,steps", [(True, 3, 2, 24), (False, 3, 0, 17)])
def test_chunk_counters(packed, overlap, chunks, spec, steps):
    eng, (out,) = serve(packed, [PROMPTS[0]], max_new_tokens=18, overlap_host=overlap)
    assert len(out) == 18
    assert (eng.chunks, eng.spec_chunks, eng.steps) == (chunks, spec, steps)


def test_span_without_a_profiler_is_one_shared_null_context():
    a, b = span("engine.step"), span("engine.fold")
    assert a is b and isinstance(a, contextlib.nullcontext)
    opened_before = span("engine.step")
    with opened_before:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("engine.fold"):
                torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert "tgq.engine.fold" in names and "tgq.engine.step" not in names
    assert span("engine.fold") is a
