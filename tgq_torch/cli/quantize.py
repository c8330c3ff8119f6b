"""``python -m tgq_torch.cli.quantize`` — the quantization entry point (mirrors
``tgq/cli/quantize.py``): flags from ``tgq_torch.cli.args``, stdout and
file logging, ``results.json`` with {config, layer_stats, metrics},
``crash_log.json`` on failure.  ``--model_id`` is a preset (random
weights from ``--seed``), a local HF checkpoint directory or a hub id in
the local HF cache (``tgq_torch.models.hf_import.resolve_model``).  The
packed checkpoint is saved with ``tgq_torch.core.checkpoint``;
``--hf_export`` also writes a dequantized bf16 HF checkpoint to
``<save_path>/hf``, ``--resume_dir`` keeps finished layers across runs,
``--profile_dir`` traces the quantization, ``--kv_equalize`` stores KV
equalizers calibrated on the first calibration sequences
(``tgq_torch.serve.kv_calibrate``) in the checkpoint, and ``--mode test``
runs the spectral consistency check instead.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time


def main(argv=None) -> int:
    from tgq_torch.cli.args import get_args
    from tgq_torch.utils import setup_logging

    args = get_args(argv)
    setup_logging(args.save_path)
    log = logging.getLogger("tgq_torch.quantize")

    log.info("=" * 20 + " INITIALIZING QUANTIZATION " + "=" * 20)
    log.info("Model:  %s", args.model_id)
    log.info("Mode:   %s", args.mode.upper())
    log.info("Params: Bits=%d, Group=%d, Eps=%g", args.w_bits, args.group_size, args.eps)

    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.calib.data import get_loaders, load_eval_tokens
    from tgq_torch.core.checkpoint import save_quantized
    from tgq_torch.eval import perplexity_from_token_stream
    from tgq_torch.models.hf_import import resolve_model
    from tgq_torch.utils.precision import resolve_device

    device = resolve_device(args.device)
    experiment_log = {"config": vars(args), "layer_stats": [], "metrics": {}}
    params, cfg, tokenizer = resolve_model(args.model_id, seed=args.seed, device=device)
    if args.seq_len != cfg.seqlen:
        cfg = dataclasses.replace(cfg, seqlen=args.seq_len)

    def eval_ppl(p):
        if args.dataset == "synthetic" or tokenizer is None:
            tokens = load_eval_tokens("synthetic", None, vocab_size=cfg.vocab_size)
        else:
            tokens = load_eval_tokens("wikitext2", tokenizer)
        return perplexity_from_token_stream(p, cfg, tokens, max_length=cfg.seqlen,
                                            stride=512, attn_impl=args.attn_impl)

    if args.mode == "baseline":
        log.info("BASELINE EVALUATION")
        ppl = eval_ppl(params)
        log.info("Baseline PPL: %.4f", ppl)
        experiment_log["metrics"]["baseline_ppl"] = ppl
        os.makedirs(args.save_path, exist_ok=True)
        with open(os.path.join(args.save_path, "results.json"), "w") as f:
            json.dump(experiment_log, f, indent=4)
        return 0

    log.info("Loading dataset: %s", args.dataset)
    input_ids = get_loaders(args.dataset, tokenizer, args.n_samples, args.seq_len,
                            seed=args.seed, vocab_size=cfg.vocab_size)
    qcfg = QuantizeConfig(
        mode=args.mode, w_bits=args.w_bits, group_size=args.group_size,
        sym=args.sym, eps=args.eps, threshold_method=args.threshold_method,
        actorder=args.actorder, damp_percent=args.damp_percent,
        adaptive_eps=args.adaptive_eps, sketch_ratio=args.sketch_ratio,
        batch_size=args.batch_size, block_size=args.block_size,
        kernel_backend=args.kernel_backend, precision=args.precision,
        attn_impl=args.attn_impl, pack=not args.no_pack, seed=args.seed,
    )

    t0 = time.time()
    if args.mode == "test":
        from tgq_torch.calib.pipeline import spectral_consistency_check

        experiment_log["spectral_check"] = spectral_consistency_check(
            params, cfg, input_ids, qcfg, device=device)
    else:
        from tgq_torch.utils.profiling import device_trace

        with device_trace(args.profile_dir, cuda=device.type == "cuda"):
            params, packed, run_log = quantize_model(params, cfg, input_ids, qcfg,
                                                     device=device,
                                                     resume_dir=args.resume_dir)
        experiment_log["layer_stats"] = run_log["layer_stats"]
        experiment_log["metrics"].update(run_log["metrics"])
        kv_eq = None
        if args.kv_equalize:
            from tgq_torch.serve.kv_calibrate import estimate_kv_equalizers

            log.info("Calibrating per-channel KV equalizers (tgq_torch.serve.kv_calibrate)")
            kv_eq = estimate_kv_equalizers(params, cfg, input_ids[: min(4, len(input_ids))],
                                           attn_impl=args.attn_impl)
        if not args.no_save:
            log.info("Saving packed checkpoint to %s", args.save_path)
            save_quantized(args.save_path, params, packed, cfg, dataclasses.asdict(qcfg),
                           kv_equalizers=kv_eq)
        if args.hf_export:
            from tgq_torch.models.hf_export import export_hf

            hf_dir = os.path.join(args.save_path, "hf")
            log.info("Exporting HF-format checkpoint to %s", hf_dir)
            export_hf(hf_dir, params, cfg, tokenizer=tokenizer)
    total = time.time() - t0
    log.info("Total processing time: %.2f minutes", total / 60)

    if args.mode != "test":
        log.info("Running final evaluation...")
        ppl = eval_ppl(params)
        log.info("Final Quantized PPL: %.4f", ppl)
        experiment_log["metrics"].update({"total_time": total, "quantized_ppl": ppl})

    os.makedirs(args.save_path, exist_ok=True)
    with open(os.path.join(args.save_path, "results.json"), "w") as f:
        json.dump(experiment_log, f, indent=4, default=str)
    return 0


def run() -> None:
    try:
        sys.exit(main())
    except Exception as e:
        logging.error("CRASH: %s", e)
        with open("crash_log.json", "w") as f:
            json.dump({"error": str(e)}, f)
        raise


if __name__ == "__main__":
    run()
