"""CLI flag surface — the flags of ``tgq/cli/args.py`` with the same names
and defaults, except ``--device`` (cuda | cpu, default cuda) and
``--kernel_backend`` (kernel | plain)."""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="tgq_torch: TruncGPTQ quantization for LLMs on CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    m = p.add_argument_group("Model Configuration")
    m.add_argument("--model_id", type=str, default="Qwen/Qwen3-8B",
                   help="tgq_torch preset name, local HF checkpoint "
                        "directory, or HF hub id in the local HF cache")
    m.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Compute device")
    m.add_argument("--seed", type=int, default=42, help="Random seed")

    d = p.add_argument_group("Data Configuration")
    d.add_argument("--dataset", type=str, default="wikitext2",
                   choices=["wikitext2", "c4", "synthetic"],
                   help="Calibration dataset")
    d.add_argument("--n_samples", type=int, default=128,
                   help="Number of calibration samples")
    d.add_argument("--seq_len", type=int, default=2048,
                   help="Calibration sequence length")
    d.add_argument("--batch_size", type=int, default=8,
                   help="Batch size for processing")

    q = p.add_argument_group("Quantization Parameters")
    q.add_argument("--w_bits", type=int, default=4, choices=[2, 3, 4, 8],
                   help="Target weight bit-width")
    q.add_argument("--group_size", type=int, default=-1, choices=[-1, 128],
                   help="Group size for block scaling")
    q.add_argument("--sym", action="store_true", help="Symmetric quantization")
    q.add_argument("--eps", type=float, default=1e-2,
                   help="Truncation threshold strength")
    q.add_argument("--sketch_ratio", type=float, default=4.0,
                   help="Sketch size ratio (mode svd)")
    q.add_argument("--mode", type=str, default="eigh",
                   choices=["svd", "gptq", "eigh", "pchol", "rtn", "test", "baseline"],
                   help="Solver: eigh/svd/gptq as in the reference; pchol = "
                        "pivoted-Cholesky TruncGPTQ; rtn; test = spectral "
                        "consistency check; baseline = eval only")
    q.add_argument("--threshold_method", type=str, default="mean_trimmed",
                   choices=["mean_trimmed", "energy"], help="Rank selection rule")
    q.add_argument("--actorder", action="store_true",
                   help="ActOrder for reference GPTQ")
    q.add_argument("--damp_percent", type=float, default=0.01,
                   help="Damping fraction for reference GPTQ")
    q.add_argument("--adaptive_eps", action="store_true",
                   help="Scale eps down 10x for down_proj/o_proj")

    t = p.add_argument_group("Build Extensions")
    t.add_argument("--kernel_backend", type=str, default="kernel",
                   choices=["kernel", "plain"],
                   help="CUDA kernels or their plain PyTorch versions")
    t.add_argument("--precision", type=str, default="f64",
                   choices=["f64", "f32"], help="Factorization precision (eigh mode)")
    t.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "flash", "naive"],
                   help="Attention: auto / flash = the causal flash-attention kernel "
                        "(its plain version on the CPU), naive = plain f32 softmax")
    t.add_argument("--block_size", type=int, default=256,
                   help="GPTQ column block size")
    t.add_argument("--no_pack", action="store_true",
                   help="Skip packed INT export")
    t.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace of the quantization")
    t.add_argument("--resume_dir", type=str, default=None,
                   help="Per-layer resume directory")

    o = p.add_argument_group("Output Configuration")
    o.add_argument("--save_path", type=str, default="./output",
                   help="Directory for checkpoint and logs")
    o.add_argument("--no_save", action="store_true",
                   help="Skip saving model weights")
    o.add_argument("--kv_equalize", action="store_true",
                   help="Calibrate per-channel KV equalizers into the checkpoint")
    o.add_argument("--hf_export", action="store_true",
                   help="Also write a dequantized-bf16 HF checkpoint")
    return p


def get_args(argv=None):
    return build_parser().parse_args(argv)
