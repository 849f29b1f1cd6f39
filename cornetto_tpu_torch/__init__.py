"""cornetto_tpu_torch: the PyTorch/CUDA port of cornetto-tpu.

The JAX package ``cornetto_tpu`` stays the reference; this package re-writes
its device layers in PyTorch, with each Pallas kernel replaced by a kernel
written by hand for NVIDIA Hopper, and imports the JAX-free host layers
(index build, native parsers, TSV formatting, I/O) from ``cornetto_tpu``
unchanged.  It never imports ``jax``.

- ``device``    explicit device choice (``CORNETTO_FORCE_CPU=1`` pins the CPU)
- ``kernels``   minimizer math and the CUDA minimizer-extraction kernel
- ``livefish``  the adaptive-sampling decision engine and streaming loop
- ``cli``       ``python -m cornetto_tpu_torch.cli livefish run ...``
"""

from cornetto_tpu.version import __version__

__all__ = ["__version__"]
