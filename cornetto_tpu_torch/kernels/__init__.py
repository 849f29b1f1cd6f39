"""Device kernels of the port: plain PyTorch versions and hand-written CUDA
kernels for Hopper (built from ``cornetto_tpu_torch/csrc`` at first use)."""
