"""Driver ``serve-closed``: a closed loop of ``clients`` clients, each
sending its next request when the last one finishes, through
``tgq_torch.serve.Engine.submit`` / ``step`` (the calls
``tgq_torch.cli.serve.run`` makes).

Set-up builds the model and the engine, submits every client's first
request with an output budget drawn uniformly below its drawn length (so
completions spread from the window's first second), and steps until every
slot holds a request with its first token, then on for ``warm_seconds``.
The window counts every output token the host collects in it
(``output_tok_s``).  A traced run traces ``trace_seconds`` in the middle
of the window.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.lib import serving, stats, traffic
from portbench.lib.runctx import Outcome, memory_peak, sync
from portbench.lib.trace import DeviceTrace


def run(ctx) -> Outcome:
    mix, dev = ctx.cell.mix, ctx.device
    clients = int(mix["clients"])
    eng, d = serving.build_engine(ctx, slots=int(mix["slots"]))
    stream = traffic.RequestStream(mix, d.vocab, traffic.rng_for(ctx.seed, 2))
    u = traffic.rng_for(ctx.seed, 3).permutation((np.arange(clients) + 0.5) / clients)
    current, all_reqs = [], []
    for c in range(clients):
        prompt, n_out = stream.next()
        current.append(eng.submit(prompt, max(1, int(u[c] * n_out))))
    all_reqs.extend(current)

    def refill(now_reqs):
        for c, r in enumerate(now_reqs):
            if r.done:
                prompt, n_out = stream.next()
                now_reqs[c] = eng.submit(prompt, n_out)
                all_reqs.append(now_reqs[c])

    while any(not r.output for r in current):
        eng.step()
        refill(current)
    t_warm = time.time() + mix["warm_seconds"]
    while time.time() < t_warm:
        eng.step()
        refill(current)
    sync(dev)

    tr = DeviceTrace(ctx.trace)
    spans = serving.Spans(tr)
    traced = None
    t_trace, k_tr, t_tr = serving.trace_start(ctx), {}, 0.0
    try:
        k0 = {r.rid: len(r.output) for r in all_reqs}
        done0 = {r.rid for r in all_reqs if r.done}
        tok0, steps0 = eng.tokens_emitted, eng.steps - serving.steps_in_flight(eng)
        t0 = time.time()
        setup_s = t0 - ctx.t_start
        while True:
            if ctx.trace and not tr.started and time.time() - t0 >= t_trace:
                k_tr, t_tr = {r.rid: len(r.output) for r in all_reqs}, time.time()
                tr.start()
            eng.step()
            refill(current)
            now = time.time()
            if tr.active and time.perf_counter() - tr.t0 >= mix["trace_seconds"]:
                tr.stop()
                traced = serving.traced_counts(all_reqs, k_tr, t_tr, tr)
            if now - t0 >= ctx.seconds:
                break
        t1 = time.time()
        tokens = eng.tokens_emitted - tok0
        steps = eng.steps - serving.steps_in_flight(eng) - steps0
        if tr.active:
            tr.stop()
            traced = serving.traced_counts(all_reqs, k_tr, t_tr, tr)
        tr.finish()
        traced_steps = spans.decode_steps
    finally:
        spans.close()
    sync(dev)
    peak = memory_peak(dev)
    window_s = t1 - t0
    work = serving.window_work(all_reqs, k0, t0, t1)
    firsts = sum(1 for *_, f in work["requests"] if f)
    done = [r for r in all_reqs if r.done and t0 <= r.finish_t <= t1]
    rec = {"dims": d, "window_s": window_s, "steps": steps, "tokens": tokens,
           "first_tokens": firsts, "traced_decode_steps": traced_steps,
           "prompt_lens_traced": spans.prompt_lens(), "traced": traced, **work}
    e2e = {"setup_s": setup_s, "output_tok_s": stats.rate(tokens, window_s)}
    attempted = sum(1 for r in all_reqs if r.rid not in done0)
    checks = {}
    if ctx.check:
        sample = serving.sample_for_check(done, int(mix["check_requests"]), ctx.seed)
        del eng
        t_check = time.time()
        checks = serving.check_served(ctx, d, sample)
        rec["check_s"] = time.time() - t_check
    return Outcome(e2e=e2e, rec=rec, attempted=attempted, failed=0, checks=checks,
                   memory_peak_bytes=peak, trace=tr.summary)
