"""tgq_torch stands alone: importing every module pulls in neither jax,
ml_dtypes, the tgq package nor the HF packages (safetensors, transformers,
huggingface_hub), and entry points run on CUDA unless told
otherwise — without CUDA they raise instead of falling back to the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import tgq_torch
names = [m.name for m in pkgutil.walk_packages(tgq_torch.__path__, "tgq_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "tgq", "safetensors",
                                    "transformers", "huggingface_hub"))
print(len(names), bad)
assert not bad, bad
"""


def test_no_jax_or_tgq_imports():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 65  # every module was imported
    assert "tgq_torch._native" in _walk_names()  # the allocator's loader is covered
    assert {"tgq_torch.parallel.mesh", "tgq_torch.parallel.launch",
            "tgq_torch.parallel.dryrun"} <= _walk_names()  # and the parallel package
    assert {"tgq_torch.kernels.causal_attention", "tgq_torch.calib.tiny_train",
            "tgq_torch.cli.trunc_regimes", "tgq_torch.cli.tiny_quality_bench",
            "tgq_torch.cli.boundary_bench", "tgq_torch.cli.reproduce_baseline",
            "tgq_torch.cli.diff_baseline"} <= _walk_names()  # and slice 9's modules
    assert "tgq_torch.kernels.causal_attention_bwd" in _walk_names()  # and K6-bwd's


def test_no_library_attention_in_the_port():
    """Causal attention is K6, the port's own kernel: no file of the
    package calls PyTorch's fused attention (chip_smoke.py times it as a
    yardstick only)."""
    named = []
    for root, _, files in os.walk(os.path.join(REPO, "tgq_torch")):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cc")):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    if "scaled_dot_product_attention" in f.read():
                        named.append(os.path.join(root, name))
    assert not named, named


def _walk_names() -> set:
    import pkgutil

    import tgq_torch

    return {m.name for m in pkgutil.walk_packages(tgq_torch.__path__, "tgq_torch.")}


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is usable")


def test_entry_points_default_to_cuda(tmp_path):
    _no_cuda()
    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.cli.quantize import main
    from tgq_torch.core.checkpoint import load_quantized
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params

    cfg = PRESETS["tiny-qwen3"]
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_model(params, cfg, np.zeros((1, 8), np.int32), QuantizeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        load_quantized(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model_id", "tiny-qwen3", "--save_path", str(tmp_path / "o")])


def test_resolve_device():
    from tgq_torch.utils.precision import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("cli", ["trunc_regimes", "tiny_quality_bench", "boundary_bench",
                                 "reproduce_baseline"])
def test_analysis_clis_default_to_cuda(cli, tmp_path):
    _no_cuda()
    import importlib

    mod = importlib.import_module(f"tgq_torch.cli.{cli}")
    argv = {"reproduce_baseline": ["--smoke", "--out", str(tmp_path / "o")]}.get(cli, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)


def test_serving_entry_points_default_to_cuda():
    _no_cuda()
    from tgq_torch.cli.serve import main
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models import PRESETS
    from tgq_torch.models.hf_import import init_packed_params
    from tgq_torch.serve import Engine, ServeConfig

    cfg = PRESETS["tiny-qwen3"]
    with pytest.raises(RuntimeError, match="CUDA"):
        init_packed_params(cfg, QuantSpec(4, 32))
    params = init_packed_params(cfg, QuantSpec(4, 32), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model_id", "tiny-qwen3", "--group_size", "32"])
