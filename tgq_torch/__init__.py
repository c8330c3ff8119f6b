"""tgq_torch — TruncGPTQ quantization in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``tgq`` beside it, module for module:

- ``tgq_torch.core``     quantizer math, packed INT storage, checkpoints.
- ``tgq_torch.solver``   Hessian accumulation, spectral / Cholesky /
                         sketch factorizations, the pivoted-Cholesky fast
                         path and the blockwise GPTQ loop.
- ``tgq_torch.kernels``  CUDA kernels (pivoted-Cholesky panel, GPTQ block
                         sweep, packed-weight and W4A8 matmuls, paged
                         decode attention) with their plain PyTorch
                         versions.
- ``tgq_torch.models``   decoders of the llama family (Qwen3, Qwen2.5,
                         Llama-3), GPT-2 and OPT; HF checkpoints in and
                         out through its own safetensors reader and
                         writer (``models.safetensors_io``).
- ``tgq_torch.calib``    the layer-sequential calibration pipeline.
- ``tgq_torch.eval``     strided sliding-window perplexity.
- ``tgq_torch.serve``    paged KV cache, static KV equalizers and the
                         continuous-batching engine (llama family).
- ``tgq_torch._native``  the C++ page allocator, built with g++ at first use.
- ``tgq_torch.cli``      ``python -m tgq_torch.cli.quantize`` (presets, local
                         HF directories, resume, HF export, traces),
                         ``serve`` and ``serve_soak``; the timing tools
                         ``kernel_bench``, ``decode_bench`` and
                         ``gptq_kernel_bench``; ``kv_quality``,
                         ``synthetic_bench`` and the table runners
                         ``run_benchmark``, ``run_experiments``,
                         ``run_baseline`` and ``extract_log``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Nothing here imports ``jax``, ``tgq``, ``safetensors``, ``transformers`` or
``huggingface_hub``.
"""
from tgq_torch.utils.precision import exact_f32_matmul

exact_f32_matmul()

__version__ = "0.1.0"
