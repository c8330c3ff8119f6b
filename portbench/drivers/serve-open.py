"""Driver ``serve-open``: open-loop Poisson arrivals at the mix's fixed
``rate`` through ``tgq_torch.serve.Engine.submit`` / ``step``.

Set-up builds the model and the engine and serves a warm-up wave of the
mix's largest and smallest prompts.  In the window, requests fall due for
``--seconds`` seconds (each submitted at the first tick at or after its due
time, and timed from its due time); the window then runs on until every
request due in it has finished, at most ``drain_seconds`` more.  A request
with no first token by the window's end is missing: it sits above every
finished one in ``ttft_p95_s``.  ``tpot_p95_ms`` is taken over the due
requests that finished.  A traced run traces ``trace_seconds`` in the
middle of the window's arrivals.
"""
from __future__ import annotations

import time

from portbench.lib import serving, stats, traffic
from portbench.lib.runctx import Outcome, memory_peak, sync
from portbench.lib.trace import DeviceTrace


def run(ctx) -> Outcome:
    mix, dev = ctx.cell.mix, ctx.device
    eng, d = serving.build_engine(ctx, slots=int(mix["slots"]))
    rng = traffic.rng_for(ctx.seed, 4)
    due = traffic.poisson_due(mix["rate"], ctx.seconds, rng)
    due = due[due < ctx.seconds]
    p_lens = traffic.stratified_lengths(mix["prompt"], len(due), rng)
    o_lens = traffic.stratified_lengths(mix["output"], len(due), rng)

    # warm-up: the largest prompts alone, then a full wave of the smallest
    wrng = traffic.rng_for(ctx.seed, 5)
    big, small = mix["prompt"]["max"], mix["prompt"]["min"]
    for n in [big, big] + [small] * int(mix["slots"]):
        eng.submit(traffic.prompt_tokens(d.vocab, n, wrng), mix["output"]["max"])
    eng.run()
    sync(dev)

    tr = DeviceTrace(ctx.trace)
    spans = serving.Spans(tr)
    reqs, submitted = [], []
    traced = None
    t_trace, k_tr, t_tr = serving.trace_start(ctx), {}, 0.0
    try:
        tok0, steps0 = eng.tokens_emitted, eng.steps
        t0 = time.time()
        setup_s = t0 - ctx.t_start
        i = 0
        while True:
            now = time.time() - t0
            while i < len(due) and due[i] <= now:
                reqs.append(eng.submit(traffic.prompt_tokens(d.vocab, p_lens[i], rng),
                                       int(o_lens[i])))
                submitted.append(now)
                i += 1
            if ctx.trace and not tr.started and now >= t_trace:
                k_tr, t_tr = {r.rid: len(r.output) for r in reqs}, time.time()
                tr.start()
            if tr.active and time.perf_counter() - tr.t0 >= mix["trace_seconds"]:
                tr.stop()
                traced = serving.traced_counts(reqs, k_tr, t_tr, tr)
            if i == len(due) and all(r.done for r in reqs):
                break
            if now >= ctx.seconds + mix["drain_seconds"]:
                break
            if eng.idle:
                nxt = due[i] if i < len(due) else now
                time.sleep(max(0.0, min(nxt - now, 0.05)))
                continue
            eng.step()
        t1 = time.time()
        tokens, steps = eng.tokens_emitted - tok0, eng.steps - steps0
        if tr.active:
            tr.stop()
            traced = serving.traced_counts(reqs, k_tr, t_tr, tr)
        tr.finish()
        traced_steps = spans.decode_steps
    finally:
        spans.close()
    sync(dev)
    peak = memory_peak(dev)
    rel = [(r.first_token_t - t0) if r.first_token_t else None for r in reqs]
    ttft = stats.ttft_p95(list(due[:len(reqs)]), rel)
    tpots = [stats.tpot(r.first_token_t, r.finish_t, len(r.output)) for r in reqs if r.done]
    tpots = [x for x in tpots if x is not None]
    work = serving.window_work(reqs, {}, t0, t1)
    rec = {"dims": d, "window_s": t1 - t0, "steps": steps, "tokens": tokens,
           "first_tokens": sum(1 for x in rel if x is not None),
           "traced_decode_steps": traced_steps, "prompt_lens_traced": spans.prompt_lens(),
           "traced": traced,
           "late_s_max": max((s - u for s, u in zip(submitted, due)), default=0.0), **work}
    e2e = {"setup_s": setup_s, "ttft_p95_s": ttft,
           "tpot_p95_ms": 1e3 * stats.percentile(tpots, 95.0) if tpots else float("inf")}
    missing = sum(1 for x in rel if x is None)
    checks = {}
    if ctx.check:
        done = [r for r in reqs if r.done]
        sample = serving.sample_for_check(done, int(mix["check_requests"]), ctx.seed)
        del eng
        t_check = time.time()
        checks = serving.check_served(ctx, d, sample)
        rec["check_s"] = time.time() - t_check
    return Outcome(e2e=e2e, rec=rec, attempted=len(reqs), failed=missing, checks=checks,
                   memory_peak_bytes=peak, trace=tr.summary)
