"""``python -m tgq_torch.cli.reproduce_baseline`` — reproduce the
reference's published Qwen3-8B table (BASELINE.md) and diff its PPLs row
by row (the counterpart of ``scripts/reproduce_baseline.sh``).

    python -m tgq_torch.cli.reproduce_baseline <model_dir_or_hf_id> [--out DIR]
    python -m tgq_torch.cli.reproduce_baseline --smoke [--out DIR]

The real run needs a local Qwen3-8B HF checkpoint (a directory, or a hub
id under ``$HF_HUB_CACHE``) and wikitext-2-raw-v1 in the local HF datasets
cache; neither is in the repository.  It runs ``run_benchmark`` at the
reference's configuration (128 x 2048 wikitext-2 calibration samples,
seed 42, group 128, strided PPL, pchol for the TruncGPTQ rows), then
``diff_baseline`` with its default tolerance (|ppl - ref| <= max(0.15,
2 %·ref) per row) and the Trunc <= GPTQ orderings.

``--smoke`` is the hermetic self-test: tiny-qwen3 on synthetic data,
which checks the harness's mechanics (every row OK, the CSV readable by
the diff), not the reference's PPLs or orderings (on a tiny random model
the methods' differences are noise).  Exit code: the diff's.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model", nargs="?", help="Qwen3-8B checkpoint directory or hub id")
    ap.add_argument("--smoke", action="store_true", help="hermetic tiny-model self-test")
    ap.add_argument("--out", default=None,
                    help="output directory (default baseline_repro, or baseline_smoke "
                         "with --smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    from tgq_torch.cli import diff_baseline, run_benchmark
    from tgq_torch.utils.precision import resolve_device

    args = build_parser().parse_args(argv)
    if args.smoke == (args.model is not None):
        build_parser().error("give a model or --smoke, not both")
    resolve_device(args.device)  # the rows' failures would only be logged
    out = args.out or ("baseline_smoke" if args.smoke else "baseline_repro")
    if args.smoke:
        run_benchmark.run(["--model_id", "tiny-qwen3", "--dataset", "synthetic",
                           "--n_samples", "4", "--seq_len", "64", "--batch_size", "2",
                           "--group_size", "-1", "--solver", "pchol", "--out", out,
                           "--device", args.device])
        return diff_baseline.main([os.path.join(out, "final_benchmark.csv"),
                                   "--skip_reference_check", "--skip_ordering_check"])
    # the reference configuration (BASELINE.md): 128 x 2048 wikitext-2
    # calibration samples, seed 42, group 128 static groups, strided PPL
    run_benchmark.run(["--model_id", args.model, "--dataset", "wikitext2",
                       "--n_samples", "128", "--seq_len", "2048", "--batch_size", "8",
                       "--group_size", "128", "--solver", "pchol", "--out", out,
                       "--device", args.device])
    return diff_baseline.main([os.path.join(out, "final_benchmark.csv")])


if __name__ == "__main__":
    raise SystemExit(main())
