"""``python -m tgq_torch.cli.tiny_quality_bench`` — the low-bit quality
trend on a trained tiny model (mirrors ``tgq/cli/tiny_quality_bench.py``).

Per bit width (W4/W3/W2) and method (pchol / eigh / gptq / rtn), the PPL
delta of the quantized model against the unquantized one, on a tiny
llama-family model trained on a synthetic Markov source
(``tgq_torch.calib.tiny_train``): a random-init model's logits are flat,
so its deltas would be noise.  ``--eps`` takes a comma list that the
truncated methods sweep per bit width, with a ``trunc_best`` row for each
bit's winner (the reference's run_experiments.py protocol; GPTQ stays at
its fixed damp).  ``--outlier_channels`` trains with massive-activation
channels.  ``--a_bits 16,8`` evaluates through the packed checkpoint,
with the decoder's packed linears marked for int8 activations (K4 on
CUDA), and ``--act_report`` prints the per-group int8 activation error.

Calibration and evaluation use ``attn_impl="auto"``: K6 on CUDA (with K1
and K2 in the sweep, K3 / K4 in the packed forward), the plain versions
on the CPU.  (The JAX CLI passes "naive" because its TPU flash kernel
needs 128-multiple lengths; on the CPU the two are the same function.)

Usage:
  python -m tgq_torch.cli.tiny_quality_bench [--steps 300] [--bits 4,3,2] \\
      [--eps 1e-6,1e-5,1e-4] [--a_bits 16,8] [--outlier_channels 4] [--device cuda]
"""
from __future__ import annotations

import argparse
import copy
import csv
import json
import tempfile

FIELDS = ["bits", "method", "eps", "a_bits", "ppl", "delta"]


def activation_report(params, cfg, calib, device) -> list[dict]:
    """Per layer and quantization group, the int8 per-token activation
    quantization's relative error and absmax statistics over a calibration
    pass: rows {layer, group, absmax_mean, absmax_max, rel_err}."""
    import torch

    from tgq_torch.calib.pipeline import _group_input, _layer_forward_staged
    from tgq_torch.kernels.dequant_matmul import quantize_activations
    from tgq_torch.models.causal_lm import embed_tokens, rope_cache

    ids = torch.from_numpy(calib.astype("int64")).to(device)
    x = embed_tokens(params, ids, cfg=cfg)
    cos, sin = rope_cache(cfg, ids.shape[1], device=device)
    rows = []
    with torch.no_grad():
        for li, lp in enumerate(params["model"]["layers"]):
            for gi in range(4):
                xg = _group_input(lp, cfg, gi, x, cos, sin)
                xf = xg.float().reshape(-1, xg.shape[-1])
                q8, a = quantize_activations(xf)
                rel = float(torch.linalg.norm(q8.float() * a - xf)
                            / max(float(torch.linalg.norm(xf)), 1e-30))
                rows.append({"layer": li, "group": gi,
                             "absmax_mean": round(float(a.mean()), 5),
                             "absmax_max": round(float(a.max()), 5), "rel_err": round(rel, 5)})
            x = _layer_forward_staged(lp, cfg, x, cos, sin)
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_id", default="tiny-qwen3")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bits", default="4,3,2")
    ap.add_argument("--methods", default="pchol,eigh,gptq,rtn")
    ap.add_argument("--eps", default="1e-5", help="comma list → per-bit ε sweep for trunc methods")
    ap.add_argument("--a_bits", default="16",
                    help="comma list, e.g. 16,8 — activation precision axis "
                         "(packed-checkpoint eval path)")
    ap.add_argument("--group_size", type=int, default=32)
    ap.add_argument("--n_calib", type=int, default=16)
    ap.add_argument("--damp_percent", type=float, default=0.01)
    ap.add_argument("--outlier_channels", type=int, default=0)
    ap.add_argument("--outlier_scale", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--act_report", action="store_true",
                    help="print per-group activation int8 error table")
    ap.add_argument("--out", default=None, help="CSV output path")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def run(args) -> dict:
    """Train, quantize per (bits, method, ε), evaluate per activation
    precision (rows printed as they come); writes the CSV under ``--out``;
    returns the base PPL and the rows."""
    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.calib.tiny_train import sample_stream, train_tiny
    from tgq_torch.core.checkpoint import load_quantized, save_quantized
    from tgq_torch.eval import perplexity_from_token_stream
    from tgq_torch.models import PRESETS
    from tgq_torch.serve.engine import _mark_act_bits
    from tgq_torch.utils.precision import exact_f32_matmul, resolve_device

    device = resolve_device(args.device)
    exact_f32_matmul()
    cfg = PRESETS[args.model_id]
    params, probs, loss = train_tiny(cfg, steps=args.steps, seed=args.seed,
                                     outlier_channels=args.outlier_channels,
                                     outlier_scale=args.outlier_scale, device=device)
    calib = sample_stream(probs, args.n_calib * 64, seed=7).reshape(args.n_calib, 64)
    eval_ids = sample_stream(probs, 4096, seed=99)
    eps_list = [float(e) for e in args.eps.split(",")]
    a_bits_list = [int(a) for a in args.a_bits.split(",")]
    need_pack = any(a != 16 for a in a_bits_list)

    def ppl_of(p):
        return perplexity_from_token_stream(p, cfg, eval_ids, max_length=64, stride=32)

    base = ppl_of(params)
    print(f"trained base ppl {base:.4f} (uniform bound {cfg.vocab_size}; train loss "
          f"{loss:.3f}; outlier_channels {args.outlier_channels})")
    if args.act_report:
        for r in activation_report(params, cfg, calib, device):
            print(f"act-int8 layer {r['layer']} group {r['group']}: absmax mean "
                  f"{r['absmax_mean']} max {r['absmax_max']} rel_err {r['rel_err']}")

    rows = []
    for bits in (int(b) for b in args.bits.split(",")):
        for mode in args.methods.split(","):
            for eps in (eps_list if mode in ("pchol", "eigh", "svd") else [None]):
                kw = {}
                if eps is not None:
                    kw["eps"] = eps
                elif mode == "gptq":
                    kw.update(actorder=True, damp_percent=args.damp_percent)
                qcfg = QuantizeConfig(mode=mode, w_bits=bits, group_size=args.group_size,
                                      batch_size=4, block_size=32, pack=need_pack, **kw)
                qp, packed, _ = quantize_model(copy.deepcopy(params), cfg, calib, qcfg,
                                               device=device)
                evals = {}
                if need_pack:
                    with tempfile.TemporaryDirectory() as d:
                        save_quantized(d, qp, packed, cfg)
                        tree, _, _ = load_quantized(d, device=device)
                    for ab in a_bits_list:
                        evals[ab] = tree if ab == 16 else _mark_act_bits(tree, 8)[0]
                else:
                    evals[16] = qp
                for ab, p_eval in evals.items():
                    ppl = ppl_of(p_eval)
                    rows.append({"bits": bits, "method": mode, "eps": "" if eps is None else eps,
                                 "a_bits": ab, "ppl": round(float(ppl), 4),
                                 "delta": round(float(ppl - base), 4)})
                    tag = f" eps {eps:g}" if eps is not None else ""
                    tag += f" A{ab}" if len(a_bits_list) > 1 else ""
                    print(f"W{bits} {mode:6s}{tag} ppl {ppl:.4f} (d {ppl - base:+.4f})",
                          flush=True)
        for ab in a_bits_list:  # per-bit trunc_best rows (the reference's sweep protocol)
            cands = [r for r in rows if r["bits"] == bits and r["a_bits"] == ab
                     and r["method"] in ("pchol", "eigh", "svd")]
            if len(cands) > 1:
                best = min(cands, key=lambda r: r["ppl"])
                rows.append({**best, "method": "trunc_best"})
                print(f"W{bits} trunc_best (eps {best['eps']:g}"
                      f"{f' A{ab}' if len(a_bits_list) > 1 else ''}) ppl {best['ppl']:.4f} "
                      f"(d {best['delta']:+.4f})")

    if args.out:
        with open(args.out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=FIELDS)
            w.writeheader()
            w.writerows(rows)
    return {"base_ppl": round(float(base), 4), "rows": rows, "device": str(device)}


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
