"""Explicit device choice for the port.

The device is ``cuda`` unless ``CORNETTO_FORCE_CPU=1`` is set (the same
switch the JAX package reads, cornetto_tpu/cli.py).  A request for ``cuda``
on a machine without a usable card raises: the port never carries on on the
CPU behind the caller's back.
"""

import os

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch.device to run on.

    device: an explicit ``torch.device`` or string, or None for the default
    (``cuda``, or ``cpu`` when ``CORNETTO_FORCE_CPU=1``)."""
    if device is None:
        device = "cpu" if os.environ.get("CORNETTO_FORCE_CPU") == "1" \
            else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cornetto_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; set CORNETTO_FORCE_CPU=1 "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s (cuda or cpu)" % dev)
    return dev
