"""The benchmark of the PyTorch / CUDA port (``tgq_torch``): one command
runs one cell of ``BENCHMARK.json`` once (``portbench/run.py``)."""
