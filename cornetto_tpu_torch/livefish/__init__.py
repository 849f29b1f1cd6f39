"""Adaptive-sampling decision loop on PyTorch (counterpart of
``cornetto_tpu.livefish``; the index build and host layers are shared)."""
