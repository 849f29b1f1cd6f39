"""cornetto_tpu_torch: the PyTorch/CUDA port of cornetto-tpu.

The JAX package ``cornetto_tpu`` stays the reference; this package re-writes
its device layers in PyTorch, with each Pallas kernel replaced by a kernel
written by hand for NVIDIA Hopper, and keeps its own copies of the host
layers it needs (index build, native C parsers and DP, TSV formatting, I/O,
interval algebra).  It imports neither ``jax`` nor ``cornetto_tpu``; the
two packages share only the ``.npz`` index format (``dist.checkpoint``).

- ``device``    explicit device choice (``CORNETTO_FORCE_CPU=1`` pins the CPU)
- ``kernels``   minimizer math and the CUDA kernels (minimizer extraction,
                window sums, the SDUST DP, telomere scans) with their plain
                versions; the SDUST chunk plan
- ``livefish``  the adaptive-sampling decision engine, streaming loop,
                aligner-free coverage tally and the host index build
- ``tools``     boringbits / noboringbits, sdust, telofind, telowin,
                telobreaks, bigenough
- ``pipelines`` create-panel, telostats
- ``flow``      the iteration orchestrator
- ``io``, ``intervals``, ``utils``, ``native``, ``dist``  host layers:
                file formats, interval algebra, C-semantics helpers, the
                native C kernels (built into ``build/native/``), the index
                file
- ``cli``       ``python -m cornetto_tpu_torch.cli livefish run ...``,
                ``... noboringbits``, ``... create-panel``, ``... flow``
"""

from cornetto_tpu_torch.version import __version__

__all__ = ["__version__"]
