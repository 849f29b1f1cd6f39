"""The collectives of the port's multi-device runtime, in one place: an
all-gather, a sum reduce-scatter and the sp scan's halo exchange, each on
the process group it is given (``torch.distributed``).  The JAX package's
counterparts are XLA collectives inside shard_map (``all_gather``,
``psum_scatter``, ``ppermute``).

NCCL groups take the device tensors as they are.  What gloo takes on the
card differs by operation and by torch release (torch 2.11 took CUDA
tensors for all_gather_into_tensor and reduce_scatter_tensor, copying
through host memory itself; gloo's send/recv is a host path), so for a
gloo group the port copies a CUDA tensor through pinned host memory to
the collective and its result back to the card itself, for every
operation alike.  That copy is chosen by the group's backend, never by
catching an error; it is not a fallback: every kernel still runs on the
card.  On the CPU (gloo, CORNETTO_FORCE_CPU=1) nothing is copied.
"""

import torch
import torch.distributed as dist

# the single-tensor forms: torch 2.13 names them *_single and deprecates
# the *_tensor names, which older releases have alone
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _staged(t: torch.Tensor, group) -> bool:
    """True when t must cross the collective through host memory: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor t, complete on return."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors, each (n, ...) and alike in shape and type,
    concatenated along dim 0 in the group's rank order: (W n, ...)."""
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    W = dist.get_world_size(group)
    out = torch.empty((W * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device, pin_memory=staged)
    _all_gather(out, src, group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def reduce_scatter_sum(t: torch.Tensor, group) -> torch.Tensor:
    """t (W, ...) on each of the group's W ranks: returns the sum over the
    ranks of block t[r] on group rank r, integer sums wrapping as the
    type does (int32 planes wrap as JAX's psum_scatter does)."""
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    W = dist.get_world_size(group)
    if src.shape[0] != W:
        raise ValueError("reduce_scatter_sum needs (W, ...) = (%d, ...) "
                         "blocks (got %s)" % (W, tuple(src.shape)))
    out = torch.empty(src.shape[1:], dtype=src.dtype, device=src.device,
                      pin_memory=staged)
    # flat, the blocks concatenated: the form every backend takes
    _reduce_scatter(out.view(-1), src.view(-1), op=dist.ReduceOp.SUM,
                    group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def shift_left(t: torch.Tensor, group) -> torch.Tensor:
    """Send t to the previous rank of the group (rank i to i - 1, rank 0 to
    the last) and return what the next rank sent: one send/recv pair a
    rank (batch_isend_irecv), the ppermute of the JAX sp scan."""
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    W = dist.get_world_size(group)
    me = dist.get_rank(group)
    recv = torch.empty_like(src, pin_memory=staged)
    peer = lambda r: dist.get_global_rank(group, r % W)  # noqa: E731
    ops = [dist.P2POp(dist.isend, src, peer(me - 1), group),
           dist.P2POp(dist.irecv, recv, peer(me + 1), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device, non_blocking=True) if staged else recv
