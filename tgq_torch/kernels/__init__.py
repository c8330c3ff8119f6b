"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- ``pchol_panel``  — one panel of greedy pivoted Cholesky
  (``csrc/pchol_panel.cu``; TPU original ``tgq/kernels/pchol_panel.py``).
- ``gptq_block``   — the in-block GPTQ column sweep
  (``csrc/gptq_block.cu``; TPU original ``tgq/kernels/gptq_block.py``).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors, and counts its launches in a module-level
``launches``.  The library is built on first use (``_build``).
"""
