"""The multi-rank dry run (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): on ``n`` ranks of one host, a
("data", "model") mesh drives the whole system once at a tiny size —

1. a TP+DP forward with next-token NLL, its logits against the
   single-rank forward of the same weights;
2. a data-parallel Hessian against the Gram of the whole batch;
3. one ``quantize_model`` pass under the mesh (``num_layers·7`` packed
   modules, the same on every rank);
4. the TP serving engine against the single-rank engine, by the JAX
   package's two-part rule: teacher-forced logits close (the TP decode's
   chunk-window mode against the same mode on one rank), and greedy
   tokens equal up to the first step whose single-rank top-2 margin is
   below the cross-path noise (a random-init model's margins sit near
   1e-3, where a different reduction order may flip an argmax), with
   int8 and int4 KV.

    python -m tgq_torch.parallel.dryrun 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

MARGIN_TOL = 0.05   # greedy ties below this may flip across paths
LOGIT_TOL = 0.02    # max |Δlogit| allowed between TP and single rank
FORWARD_TOL = 2e-2  # the TP forward against the single-rank one (tests/test_parallel.py)


def dryrun_config(model: int):
    """A tiny llama-family config whose heads and MLP split into ``model``."""
    from tgq_torch.models.config import ModelConfig

    kv = max(2, model)
    return ModelConfig(name="dryrun", vocab_size=256, hidden_size=64,
                       intermediate_size=16 * model, num_layers=2, num_heads=kv * 2,
                       num_kv_heads=kv, head_dim=16, rope_theta=1e4,
                       tie_word_embeddings=True, seqlen=32)


def teacher_forced(params, cfg, kv_bits: int, prompt, toks, mesh=None, dev="cpu",
                   chunk: int = 1):
    """(steps, vocab) logits of ``prompt`` then ``toks`` through prefill
    and paged decode, on this rank's shards when ``mesh`` is given.  The
    decode runs in chunks of up to ``chunk`` steps, a chunk of more than
    one step in chunk-window mode as the TP engine decodes it
    (``decode_steps``; one rank runs the mode too), its rows flushed into
    the pools after it."""
    from tgq_torch.parallel.mesh import (local_config, mark_tp_kinds, serving_mesh_scope,
                                         shard_params)
    from tgq_torch.serve.decode import _decode_core, prefill
    from tgq_torch.serve.kv_cache import PagedKVCache, window_flush, window_init

    run_cfg = cfg
    if mesh is not None:
        params, run_cfg = shard_params(mark_tp_kinds(params), mesh), local_config(cfg, mesh)
    cache = PagedKVCache.init(run_cfg, 32, 8, kv_bits=kv_bits, device=dev)
    pages = torch.arange(1, 5, dtype=torch.int32, device=dev)
    ids = torch.tensor([list(prompt) + [0] * (32 - len(prompt))], device=dev)
    table = torch.stack([pages, torch.zeros_like(pages)])
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    steps = list(toks[:-1])
    with serving_mesh_scope(mesh):
        logits, cache = prefill(params, cache, run_cfg, pages, ids, len(prompt))
        out = [logits]
        for c0 in range(0, len(steps), chunk):
            n = min(chunk, len(steps) - c0)
            win = window_init(cache, 2, n) if n > 1 else None
            for j in range(n):
                ln = len(prompt) + 1 + c0 + j
                out.append(_decode_core(params, cache, run_cfg, table, i32([ln, 0]),
                                        i32([steps[c0 + j], 0]), i32([ln - 1, 0]),
                                        win=win, w_live=j)[0])
            if win is not None:
                window_flush(cache, win, table, i32([len(prompt) + c0, 0]), n)
    return torch.stack([o.reshape(-1) for o in out]).float().cpu().numpy()


def engine_tokens(params, cfg, kv_bits: int, prompts, mesh=None, dev="cpu",
                  max_new_tokens: int = 4):
    """Greedy outputs of the serving engine (the dry run's ServeConfig)."""
    from tgq_torch.serve import Engine, ServeConfig

    scfg = ServeConfig(max_slots=2, page_size=8, num_pages=32, max_pages_per_slot=4,
                       max_new_tokens=max_new_tokens, decode_chunk=2, kv_bits=kv_bits)
    eng = Engine(params, cfg, scfg, mesh=mesh, device=dev)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    return [r.output for r in reqs]


def tie_free_prefix(logits: np.ndarray) -> int:
    """Greedy steps that must agree across paths: up to and including the
    first step whose top-2 margin is below ``MARGIN_TOL``."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    ties = np.nonzero(top2[:, 1] - top2[:, 0] < MARGIN_TOL)[0]
    return int(ties[0]) + 1 if len(ties) else logits.shape[0]


def _rank(device: str) -> dict:
    """One rank's part of the dry run (the process group is joined)."""
    import torch.distributed as dist

    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.models.causal_lm import forward, init_params
    from tgq_torch.parallel.launch import global_mesh
    from tgq_torch.parallel.mesh import (all_reduce, dp_hessian_gram, local_config,
                                         serving_mesh_scope, shard_params)

    n = dist.get_world_size()
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    data = 2 if n >= 4 and n % 2 == 0 else 1
    mesh = global_mesh(model_per_host=n // data)
    assert mesh.shape == {"data": data, "model": n // data}, mesh.shape
    cfg = dryrun_config(mesh.model)
    batch = 2 * data
    gen = np.random.default_rng(1)
    ids = torch.from_numpy(gen.integers(0, cfg.vocab_size, (batch, 32))).to(dev)
    mine = ids[mesh.data_rank * 2:(mesh.data_rank + 1) * 2]

    # 1. TP+DP forward with next-token NLL
    params = init_params(cfg, seed=0, device=dev)
    ref = forward(params, cfg, mine, attn_impl="naive")
    with serving_mesh_scope(mesh):
        logits = forward(shard_params(params, mesh), local_config(cfg, mesh), mine,
                         attn_impl="naive")
    d_fwd = float((logits - ref).abs().max())
    assert d_fwd < FORWARD_TOL, f"TP forward against single rank: max|Δ| = {d_fwd}"
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll_local = -logp.gather(-1, mine[:, 1:, None]).mean()
    nll = float(all_reduce(nll_local.reshape(1), mesh, "data")[0]) / mesh.data
    assert np.isfinite(nll), "dryrun NLL not finite"

    # 2. DP Hessian: exact against the whole batch's Gram
    x = params["model"]["embed_tokens"]["weight"][mine].float()
    h = dp_hessian_gram(x, mesh)
    xa = params["model"]["embed_tokens"]["weight"][ids].float().reshape(-1, cfg.hidden_size)
    d_h = float((h - xa.T @ xa).abs().max() / (xa.T @ xa).abs().max())
    assert h.shape == (cfg.hidden_size, cfg.hidden_size) and d_h < 1e-5, d_h

    # 3. one layer-sequential quantization pass under the mesh
    qcfg = QuantizeConfig(mode="pchol", w_bits=4, group_size=16, batch_size=batch,
                          block_size=16, attn_impl="naive", eps=1e-8)
    calib = np.random.default_rng(3).integers(0, cfg.vocab_size, (batch, 32))
    qparams, packed, _ = quantize_model(init_params(cfg, seed=2, device=dev), cfg, calib, qcfg,
                                        device=dev.type, mesh=mesh)
    assert len(packed) == cfg.num_layers * 7, len(packed)
    q0 = qparams["model"]["layers"][0]["self_attn"]["q_proj"]["w"].float()
    same = all_reduce(all_reduce(q0, mesh, "model"), mesh, "data")
    assert torch.equal(same, q0 * (mesh.model * mesh.data)), "ranks wrote back different weights"

    # 4. TP engine against the single-rank engine (two-part rule), kv 8 and 4
    prompts = [[5, 17, 42], [7, 9, 3, 1]]
    n_tokens, d_logit = 0, 0.0
    eng_params = init_params(cfg, seed=4, device=dev)
    for kv_bits in (8, 4):
        ref_out = engine_tokens(eng_params, cfg, kv_bits, prompts, None, dev)
        tp_out = engine_tokens(eng_params, cfg, kv_bits, prompts, mesh, dev)
        for prompt, r, t in zip(prompts, ref_out, tp_out):
            # the TP engine decodes its chunks in window mode: held to the
            # same mode on one rank
            lg_win = teacher_forced(eng_params, cfg, kv_bits, prompt, r, None, dev, chunk=2)
            lg_tp = teacher_forced(eng_params, cfg, kv_bits, prompt, r, mesh, dev, chunk=2)
            dmax = float(np.abs(lg_win - lg_tp).max())
            assert dmax < LOGIT_TOL, f"kv{kv_bits}: TP logits diverge: max|Δ| = {dmax}"
            d_logit = max(d_logit, dmax)
            k = tie_free_prefix(teacher_forced(eng_params, cfg, kv_bits, prompt, r, None, dev))
            assert r[:k] == t[:k], (kv_bits, r, t, k)
            n_tokens += len(t)
    return {"mesh": mesh.shape, "backend": mesh.backend, "nll": nll,
            "forward_max_abs": d_fwd, "hessian_rel": d_h, "packed": len(packed),
            "tp_logit_max_abs": d_logit, "tokens": n_tokens}


def dryrun_multichip(n: int, device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run the dry run on ``n`` new ranks of this host (``spawn``: gloo
    when they share a card or run on the CPU) and return rank 0's
    summary; any rank's failure raises."""
    from tgq_torch.parallel.launch import spawn

    res = spawn(_rank, n, args=(device,), device=device, timeout_s=timeout_s)
    out = res[0]
    print(f"[dryrun] mesh={out['mesh']} nll={out['nll']:.3f} quantized {out['packed']} "
          f"linears; TP serve == single rank ({out['tokens']} tokens, logit-tie aware, "
          f"kv8 and kv4)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-rank dry run")
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
