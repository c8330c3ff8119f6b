"""``python -m tgq_torch.cli.kv_quality`` — error of decode attention per KV
storage format and context (mirrors ``tgq/cli/kv_quality.py``).

Synthetic K/V with the channel-outlier structure of trained LLMs
(per-channel lognormal amplitudes plus a few extreme channels), made with
numpy from ``--seed`` exactly as the JAX tool makes them, go through the
port's real cache path (``kv_write_pages`` → ``kv_gather``); 16 random
queries attend in f32 against the unquantized K/V as the reference.

Formats: int8 and int4, each without and with static per-channel
equalizers (the oracle profile of the data, what
``tgq_torch.serve.kv_calibrate`` estimates from calibration tokens), then
the JAX tool's two simulated rows: per-channel-per-page int4 K scales on
top of the equalizers, and the floor of exact K with int4 + eq V.  Runs on
CUDA unless ``--device cpu``.  Prints one JSON line per (format, context).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _attention(q, kg, vg, n_ctx):
    """f32 attention: q (nq, kvh, d); kg/vg (tokens, kvh, d) → (nq, kvh, d)."""
    k = kg[:n_ctx].float()
    v = vg[:n_ctx].float()
    logits = torch.einsum("qhd,thd->qht", q, k) / np.sqrt(q.shape[-1])
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("qht,thd->qhd", p, v)


def _rel(out, ref) -> float:
    return float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))


@torch.no_grad()
def run(contexts, kv_heads=8, head_dim=128, page_size=64, seed=0, outlier_channels=4,
        outlier_gain=10.0, sigma=0.8, device="cuda"):
    from tgq_torch.models.config import ModelConfig
    from tgq_torch.serve.kv_cache import PagedKVCache, kv_gather, kv_write_pages
    from tgq_torch.utils.precision import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fused = kv_heads * head_dim
    n_max = max(contexts)
    n_pages = n_max // page_size

    def profile():  # channel-outlier amplitudes: lognormal + hard outliers
        a = np.exp(rng.normal(0.0, sigma, fused)).astype(np.float32)
        hot = rng.choice(fused, outlier_channels, replace=False)
        a[hot] *= outlier_gain
        return a

    a_k, a_v = profile(), profile()
    k_raw = (rng.standard_normal((n_max, fused)).astype(np.float32)
             * a_k).reshape(n_max, kv_heads, head_dim)
    v_raw = (rng.standard_normal((n_max, fused)).astype(np.float32)
             * a_v).reshape(n_max, kv_heads, head_dim)
    q = torch.as_tensor(rng.standard_normal((16, kv_heads, head_dim)), dtype=torch.float32,
                        device=dev)

    def eq_of(a):  # the oracle equalizers: the true RMS, mean 1 per head
        e = a.reshape(kv_heads, head_dim)
        e = e / e.mean(axis=-1, keepdims=True)
        return np.maximum(e.reshape(-1), 1e-3)

    cfg = ModelConfig(name="kvq", vocab_size=1, hidden_size=fused, intermediate_size=1,
                      num_layers=1, num_heads=kv_heads, num_kv_heads=kv_heads,
                      head_dim=head_dim)
    kt = torch.from_numpy(k_raw).to(dev)
    vt = torch.from_numpy(v_raw).to(dev)
    pages = torch.arange(1, n_pages + 1, device=dev)
    ref = {n: _attention(q, kt, vt, n) for n in contexts}
    rows = []
    for bits in (8, 4):
        for use_eq in (False, True):
            kw = dict(k_eq=eq_of(a_k)[None], v_eq=eq_of(a_v)[None]) if use_eq else {}
            cache = PagedKVCache.init(cfg, n_pages + 1, page_size, kv_bits=bits, device=dev,
                                      **kw)
            kv_write_pages(cache, 0, pages, kt, vt)
            kg, vg = kv_gather(cache, 0, pages[None], dtype=torch.float32)
            for n in contexts:
                rows.append({"format": f"int{bits}" + ("+eq" if use_eq else ""), "context": n,
                             "rel_err": round(_rel(_attention(q, kg[0], vg[0], n), ref[n]), 6)})

    # per-channel-per-page int4 K scales on top of the equalizers, and the
    # floor of exact K with per-token int4 + eq V (numpy, as the JAX tool)
    ke, ve = eq_of(a_k), eq_of(a_v)
    kp = (k_raw.reshape(n_max, fused) / ke).reshape(n_max // page_size, page_size, fused)
    s = np.maximum(np.abs(kp).max(axis=1) / 7.0, 1e-10)  # (pages, fused)
    kq = np.clip(np.round(kp / s[:, None, :]), -7, 7) * s[:, None, :]
    k_kchan = torch.from_numpy((kq.reshape(n_max, fused) * ke).reshape(
        n_max, kv_heads, head_dim).astype(np.float32)).to(dev)
    v_eqd = v_raw / ve.reshape(kv_heads, head_dim)
    sv = np.maximum(np.abs(v_eqd).max(axis=-1) / 7.0, 1e-10)
    vq = np.clip(np.round(v_eqd / sv[..., None]), -7, 7) * sv[..., None]
    v_tok = torch.from_numpy((vq * ve.reshape(kv_heads, head_dim)).astype(np.float32)).to(dev)
    for n in contexts:
        rows.append({"format": "int4+eq+kchan(sim)", "context": n,
                     "rel_err": round(_rel(_attention(q, k_kchan, v_tok, n), ref[n]), 6)})
        rows.append({"format": "int4 V-only floor(sim)", "context": n,
                     "rel_err": round(_rel(_attention(q, kt, v_tok, n), ref[n]), 6)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--contexts", type=str, default="128,512,2048,8192")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    contexts = [int(c) for c in args.contexts.split(",")]
    rows = run(contexts, seed=args.seed, device=args.device)
    for r in rows:
        print(json.dumps(r))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"config": {"contexts": contexts, "seed": args.seed,
                                  "device": args.device}, "rows": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
