"""Driver ``quantize-sweep``: TruncGPTQ sweeps, call after call.

Set-up makes the model's bf16 weights on the card from the seed and the
calibration ids, and warms up with a one-layer sweep.  The window calls
``tgq_torch.calib.pipeline.quantize_model(..., stop_after_layer=L-1)``
(L the configuration's ``layers_per_sweep``) while its time remains,
restoring the swept layers' original weights between calls, outside the
timed calls; it ends with the last sweep.  ``quantize_s_per_layer`` is the
calls' summed walls (each ending in a synchronize) over the layers they
quantized.

The first sweep of the window is captured for the check: the Hessian and
factor of every group (``pipeline._factorize``), layer by layer
(``pipeline.quantize_layer``), one calibration batch of every layer's
output, and the codes and written-back weights.  The layers, their
groups and modules are the family's plans (``families/<family>.py``);
the check matches each layer's captures to its plan's groups and fails
where their counts differ.  Every later sweep's codes must be the first's
bit for bit (``sweeps_differ``).  A traced run passes synchronizing phase
timers and traces the sweeps of its first ``trace_seconds``.

``rec`` hands the readers the first sweep's whole log as
``quantize_model`` returns it (``log``: ``layer_stats`` with every key
the program writes, ``metrics``), each swept layer's group ranks and
the rows that fed each group (``group_ranks``, ``group_rows``: every
calibration token, or for a routed group the ``rows`` its first module's
``layer_stats`` entry reports, None where it reports none), and the
phase timers' totals (``phase_s``).
"""
from __future__ import annotations

import time

import torch

from portbench.lib import bench, stats, traffic, weights
from portbench.lib.runctx import Outcome, free_device, memory_peak, model_config, sync
from portbench.lib.trace import DeviceTrace


class _Capture:
    """Wraps two pipeline functions; records while ``on``."""

    def __init__(self, pipeline, sample: int):
        self.on = False
        self.sample = sample
        self.groups: list = []   # each layer's [(h, FactorResult)] in call order
        self.outs: list = []     # one batch of each layer's outputs
        self._pipeline = pipeline
        self._orig = (pipeline._factorize, pipeline.quantize_layer)
        factorize, quantize_layer = self._orig

        def _factorize(h_or_y, qcfg, eps):
            res = factorize(h_or_y, qcfg, eps)
            if self.on:
                self.groups[-1].append((h_or_y, res))
            return res

        def _quantize_layer(*args, **kwargs):
            if self.on:
                self.groups.append([])
            out = quantize_layer(*args, **kwargs)
            if self.on:
                self.outs.append(out[1][self.sample])
            return out

        pipeline._factorize, pipeline.quantize_layer = _factorize, _quantize_layer

    def close(self):
        self._pipeline._factorize, self._pipeline.quantize_layer = self._orig


def _checksums(packed: dict) -> torch.Tensor:
    """A position-weighted sum of every module's packed codes, scales and
    zeros (device int64 / f64 sums, no host wait)."""
    out = []
    for key in sorted(packed):
        pl = packed[key]
        c = pl.codes.reshape(-1).to(torch.int64)
        w = torch.arange(c.numel(), device=c.device, dtype=torch.int64) % 65521 + 1
        out += [(c * w).sum().double(), pl.scale.double().sum(), pl.zero.double().sum()]
    return torch.stack(out)


def run(ctx) -> Outcome:
    from tgq_torch.calib import pipeline
    from tgq_torch.calib.pipeline import QuantizeConfig, quantize_model
    from tgq_torch.utils.profiling import PhaseTimers

    cell, mix, dev = ctx.cell, ctx.cell.mix, ctx.device
    conf = cell.config
    fam = bench.family(conf["family"])
    d = fam.dims(conf)
    cfg = model_config(conf, cell.config_name)
    n_layers = int(conf["layers_per_sweep"])
    params = weights.make_params(d, ctx.seed, torch.bfloat16, dev)
    ids = traffic.synthetic_calibration(d.vocab, mix["n_samples"], mix["seq_len"], ctx.seed,
                                        mix["phrases"], mix["phrase_len"])
    qcfg = QuantizeConfig(mode=mix["mode"], w_bits=mix["w_bits"], group_size=mix["group_size"],
                          sym=False, eps=mix["eps"], threshold_method=mix["threshold_method"],
                          batch_size=mix["batch_size"], block_size=mix["block_size"],
                          log_rel_error=True, pack=True)
    sample, solver_layers = check_plan(mix, ctx.seed, n_layers)
    pristine = list(params["model"]["layers"][:n_layers])
    layers = params["model"]["layers"]
    cap = _Capture(pipeline, sample)
    try:
        # warm-up: one layer through every kernel and shape of the sweep
        quantize_model(params, cfg, ids, qcfg, device=str(dev), stop_after_layer=0)
        layers[0] = pristine[0]
        sync(dev)
        timers = PhaseTimers(sync=True) if ctx.trace else None
        tr = DeviceTrace(ctx.trace)
        walls, sums, logs = [], [], []
        t0 = time.time()
        setup_s = t0 - ctx.t_start
        tr.start()
        traced = 0
        while True:
            layers[:n_layers] = pristine
            sync(dev)
            cap.on = not walls
            ts = time.perf_counter()
            _, packed, log = quantize_model(params, cfg, ids, qcfg, device=str(dev),
                                            stop_after_layer=n_layers - 1, timers=timers)
            sync(dev)
            walls.append(time.perf_counter() - ts)
            if cap.on:
                cap.on = False
                first = (packed, list(layers[:n_layers]))
            if tr.active:
                traced += 1
                if time.time() - t0 >= mix["trace_seconds"]:
                    tr.stop()
            sums.append(_checksums(packed))
            logs.append(log)
            del packed
            if time.time() - t0 >= ctx.seconds:
                break
        window_s = time.time() - t0
        tr.finish()
        peak = memory_peak(dev)
    finally:
        cap.close()

    modules = [m for log in logs for m in log["layer_stats"]]
    # a module fed by no row (a routed group the log says had none) keeps no rank
    failed = sum(1 for m in modules if m.get("rows", 1)
                 and (not (m["rel_error"] == m["rel_error"]) or m["rank"] < 1))
    sweeps_differ = sum(1 for s in sums if not torch.equal(s, sums[0]))
    tokens = mix["n_samples"] * mix["seq_len"]
    stat = {m["name"]: m for m in logs[0]["layer_stats"]}
    group_ranks, group_rows = [], []
    for li in range(n_layers):
        groups = fam.layer_plan(d, li).groups
        firsts = [stat[f"layer_{li}.{g.paths[0]}"] for g in groups]
        group_ranks.append([m["rank"] for m in firsts])
        group_rows.append([_rows(g, m, tokens) for g, m in zip(groups, firsts)])
    rec = {"dims": d, "layers_per_sweep": n_layers, "sweeps": len(walls),
           "wall_s": sum(walls), "window_s": window_s, "tokens": tokens, "seq": mix["seq_len"],
           "group_ranks": group_ranks, "group_rows": group_rows,
           "block": mix["block_size"], "group": mix["group_size"],
           "phase_s": dict(timers.totals) if timers else None, "traced_sweeps": traced,
           "log": logs[0]}
    e2e = {"setup_s": setup_s,
           "quantize_s_per_layer": stats.s_per_layer(walls, n_layers)}
    checks = {"sweeps_differ": float(sweeps_differ)}
    del params, pristine, layers, sums
    if ctx.check:
        caps = _plain_captures(fam, d, cap, first, n_layers)
        del first, cap
        free_device(dev)
        from portbench.reference.check_quantize import check_sweep
        t_check = time.time()
        checks.update(check_sweep(
            d, lambda li: fam.make_layer(d, ctx.seed, li, torch.bfloat16, dev),
            fam.make_outer(d, ctx.seed, torch.bfloat16, dev), ids, settings(mix), caps,
            solver_layers, sample, dev))
        rec["check_s"] = time.time() - t_check
    return Outcome(e2e=e2e, rec=rec, attempted=len(modules), failed=failed, checks=checks,
                   memory_peak_bytes=peak, trace=tr.summary)


def check_plan(mix: dict, seed: int, n_layers: int) -> tuple[int, set]:
    """The calibration batch whose layer outputs are compared, and the
    layers whose solver stages are (layer 0, the rank-deficient one, and
    others drawn from the seed)."""
    rng = traffic.rng_for(seed, 1)
    sample = int(rng.integers(0, -(-mix["n_samples"] // mix["batch_size"])))
    others = list(range(1, n_layers))
    k = min(len(others), mix["solver_check_layers"] - 1)
    return sample, {0} | {int(x) for x in rng.choice(others, size=k, replace=False)}


def settings(mix: dict) -> dict:
    return {"bits": mix["w_bits"], "group": mix["group_size"], "eps": mix["eps"],
            "pivot_rtol": mix["pivot_rtol"], "block": mix["block_size"],
            "batch": mix["batch_size"]}


def _rows(g, first_stat: dict, tokens: int):
    """The rows that fed group ``g``: what the program's log reports for its
    first module, else every calibration token, or None for a routed group."""
    if "rows" in first_stat:
        return int(first_stat["rows"])
    return None if g.routed else tokens


def _plain_captures(fam, d, cap, first, n_layers) -> list:
    """The first sweep's captures as plain tensors for the reference, each
    layer's factorizations in the order the program made them."""
    from portbench.reference.check_quantize import GroupCapture, LayerCapture, ModuleCapture
    from portbench.reference.truncgptq import unpack_int4
    packed, written = first
    out = []
    for li in range(n_layers):
        gcs = [GroupCapture(h=h, perm=torch.as_tensor(res.perm).long(), rank=int(res.rank),
                            r=torch.as_tensor(res.r_full))
               for h, res in cap.groups[li]]
        mods = {}
        for path in (p for g in fam.layer_plan(d, li).groups for p in g.paths):
            pl = packed[f"layers.{li}.{path}"]
            mods[path] = ModuleCapture(
                codes=unpack_int4(pl.codes, pl.out_features, pl.in_features, pl.group_size),
                scale=pl.scale.T, zero=pl.zero.T, w=weights.get(written[li], path)["w"])
        out.append(LayerCapture(groups=gcs, modules=mods, out_sample=cap.outs[li]))
    return out
