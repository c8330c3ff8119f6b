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
    assert int(out.stdout.split()[0]) >= 38  # every module was imported


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
