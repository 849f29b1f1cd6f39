"""Adaptive-sampling decision loop on PyTorch (counterpart of
``cornetto_tpu.livefish``, with its own copy of the host index build)."""
