"""Process-group start-up of the port's multi-device runtime: counterpart
of cornetto_tpu/dist/multihost.py (``jax.distributed.initialize``).

The port runs one process a device (SPMD, as ``torchrun`` launches it):
every rank runs the same program, and ``torch.distributed`` joins them.
The backend follows the device (device.resolve_device): ``nccl`` for
``cuda``, ``gloo`` on the CPU (``CORNETTO_FORCE_CPU=1``, as the tests
run).  With neither arguments nor torchrun's environment this is a no-op
that returns False, as the JAX function is on a single host.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from cornetto_tpu_torch.device import resolve_device

# a rank that fails before a collective leaves the others waiting in it:
# the group gives up after this long instead of hanging
TIMEOUT = datetime.timedelta(minutes=5)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Start the default process group; returns True if one was started.

    The arguments default from torchrun's standard environment: the
    rendezvous ``env://`` when MASTER_ADDR and MASTER_PORT are set,
    WORLD_SIZE and RANK.  Returns False when neither an init_method (or
    MASTER_ADDR) nor a world size is given.  backend None picks ``nccl``
    when the resolved device is ``cuda`` and ``gloo`` on the CPU; a rank
    on a card first makes its card the current device (LOCAL_RANK, else
    device 0), so that NCCL and every kernel run there."""
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    world_size = world_size if world_size is not None else \
        _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if init_method is None and world_size is None:
        return False
    dev = resolve_device()
    if dev.type == "cuda":
        torch.cuda.set_device(_int_env("LOCAL_RANK") or 0)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def local_device() -> torch.device:
    """This rank's device: its card (the current CUDA device, which
    initialize set) or the CPU."""
    dev = resolve_device()
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def host_local_batch(global_batch: int) -> int:
    """Per-process share of a global batch for input pipelines that feed
    each rank its own rows."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert global_batch % n == 0
    return global_batch // n
