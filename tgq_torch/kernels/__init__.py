"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- ``pchol_panel``  — one panel of greedy pivoted Cholesky
  (``csrc/pchol_panel.cu``; TPU original ``tgq/kernels/pchol_panel.py``).
- ``gptq_block``   — the in-block GPTQ column sweep
  (``csrc/gptq_block.cu``; TPU original ``tgq/kernels/gptq_block.py``).
- ``dequant_matmul`` — the packed-weight matmul K3 and its W4A8 form K4
  (``csrc/dequant_matmul.cu``; TPU original ``tgq/kernels/dequant_matmul.py``).
- ``paged_attention`` — paged decode attention K5
  (``csrc/paged_attention.cu``; TPU original ``tgq/kernels/paged_attention.py``).
- ``causal_attention`` — causal flash attention K6 of whole sequences
  (``csrc/causal_attention.cu``; TPU original: the upstream Pallas op that
  ``tgq/models/causal_lm.py::_flash_causal_attention`` calls).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors, and counts its launches in a module-level
``launches``.  The library is built on first use (``_build``).
"""
