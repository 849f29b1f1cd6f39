"""The benchmark of the PyTorch/CUDA port, cornetto_tpu_torch: run.py runs
one cell of BENCHMARK.json."""
