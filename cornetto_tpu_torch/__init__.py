"""cornetto_tpu_torch: the PyTorch/CUDA port of cornetto-tpu.

The JAX package ``cornetto_tpu`` stays the reference; this package re-writes
its device layers in PyTorch, with each Pallas kernel replaced by a kernel
written by hand for NVIDIA Hopper, and imports the JAX-free host layers
(index build, native parsers, TSV formatting, I/O) from ``cornetto_tpu``
unchanged.  It never imports ``jax``.

- ``device``    explicit device choice (``CORNETTO_FORCE_CPU=1`` pins the CPU)
- ``kernels``   minimizer math, the CUDA minimizer-extraction kernel and
                the CUDA window-sum kernel with the window depth statistics
- ``livefish``  the adaptive-sampling decision engine, streaming loop and
                aligner-free coverage tally
- ``tools``     boringbits / noboringbits (window scan on the device)
- ``pipelines`` create-panel
- ``flow``      the iteration orchestrator with the port's device steps
- ``cli``       ``python -m cornetto_tpu_torch.cli livefish run ...``,
                ``... noboringbits``, ``... create-panel``, ``... flow``
"""

from cornetto_tpu.version import __version__

__all__ = ["__version__"]
