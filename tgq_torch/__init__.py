"""tgq_torch — TruncGPTQ quantization in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``tgq`` beside it, module for module:

- ``tgq_torch.core``     quantizer math, packed INT storage, checkpoints.
- ``tgq_torch.solver``   Hessian accumulation, spectral / Cholesky /
                         sketch factorizations, the pivoted-Cholesky fast
                         path and the blockwise GPTQ loop.
- ``tgq_torch.kernels``  CUDA kernels (pivoted-Cholesky panel, GPTQ block
                         sweep) with their plain PyTorch versions.
- ``tgq_torch.models``   llama-family decoder (Qwen3, Qwen2.5, Llama-3).
- ``tgq_torch.calib``    the layer-sequential calibration pipeline.
- ``tgq_torch.eval``     strided sliding-window perplexity.
- ``tgq_torch.cli``      ``python -m tgq_torch.cli.quantize``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Nothing here imports ``jax`` or ``tgq``.
"""
from tgq_torch.utils.precision import exact_f32_matmul

exact_f32_matmul()

__version__ = "0.1.0"
