"""The sharded decision engine's two device steps: the shard-masked lookup
and votes, and the policy on the votes summed over the shards.
Counterpart of the XLA code of cornetto_tpu/livefish/decide.py::
_decide_from_minima with ep_axis set (:254-296), which the JAX package
runs inside make_sharded_engine's shard_map.

``sharded_votes`` and ``policy_from_stats`` launch the hand-written CUDA
kernels of csrc/votes.cu for tensors on a CUDA device and run the plain
PyTorch versions (``sharded_votes_ref``, ``policy_from_stats_ref``: the
port's ``_lookup_votes`` with its owner filter and ``_policy_from_stats``)
for tensors on the CPU; on a CUDA tensor they launch or raise, never fall
back.
"""

import torch

from cornetto_tpu_torch.kernels import _build
from cornetto_tpu_torch.kernels.decide import (SLOTS, _lookup_votes,
                                               _policy_from_stats)

_KERNEL = "votes"
MAX_CONTIGS = 65535          # contig ids are 16 bits (livefish.index)


def sharded_votes_ref(hashes, valid, btable, bucket_shift: int,
                      two_choice: bool, ep: int, shard: int, C: int,
                      parts: int = 1):
    """Plain PyTorch version of the kernel (same arguments and result as
    ``sharded_votes``); runs on any device."""
    planes = torch.stack(_lookup_votes(btable, bucket_shift, hashes, valid, C,
                                       two_choice, owner=(ep, shard)))
    b = hashes.shape[0]
    return planes.reshape(9, parts, b // parts, C).transpose(0, 1) \
        .contiguous().reshape(_out_shape(b, C, parts))


# plain PyTorch version of the policy kernel (same arguments and results
# as ``policy_from_stats``); runs on any device
policy_from_stats_ref = _policy_from_stats


def _out_shape(b: int, C: int, parts: int):
    return (9, b, C) if parts == 1 else (parts, 9, b // parts, C)


def _check_tensor(name, t, dtype, dim, dev):
    if not isinstance(t, torch.Tensor) or t.dim() != dim:
        raise ValueError("%s must be a %d-D tensor" % (name, dim))
    if t.device != dev:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, dev))
    if t.dtype != dtype:
        raise TypeError("%s must be %s (got %s)" % (name, dtype, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _check_votes(hashes, valid, btable, ep, shard, C, parts):
    dev = hashes.device
    _check_tensor("hashes", hashes, torch.int32, 2, dev)
    _check_tensor("valid", valid, torch.bool, 2, dev)
    _check_tensor("btable", btable, torch.int32, 2, dev)
    b, M = hashes.shape
    if tuple(valid.shape) != (b, M) or b < 1 or M < 1:
        raise ValueError("hashes and valid must be the same non-empty "
                         "(b, M) shape (got %s, %s)"
                         % (tuple(hashes.shape), tuple(valid.shape)))
    nb, width = btable.shape
    if nb < 1 or nb & (nb - 1):
        raise ValueError("btable must have a power-of-two number of rows "
                         "(got %d)" % nb)
    if width // 2 not in SLOTS or width % 2:
        raise ValueError("btable rows must hold 2K int32 with K in %s "
                         "(got %d)" % (SLOTS, width))
    if ep < 1 or ep & (ep - 1) or not 0 <= shard < ep:
        raise ValueError("ep must be a power of two and 0 <= shard < ep "
                         "(got ep=%d shard=%d)" % (ep, shard))
    if not 1 <= C <= MAX_CONTIGS:
        raise ValueError("1 <= C <= %d contigs (got %d)" % (MAX_CONTIGS, C))
    if parts < 1 or b % parts:
        raise ValueError("parts must divide the %d rows (got %d)"
                         % (b, parts))


def _check_policy(stats, panel_mask, bin_size):
    dev = stats.device
    _check_tensor("stats", stats, torch.int32, 3, dev)
    _check_tensor("panel_mask", panel_mask, torch.bool, 2, dev)
    nine, b, C = stats.shape
    if nine != 9 or b < 1:
        raise ValueError("stats must be (9, b, C) (got %s)"
                         % (tuple(stats.shape),))
    if panel_mask.shape[0] != C or not 1 <= C <= MAX_CONTIGS \
            or panel_mask.shape[1] < 1:
        raise ValueError("panel_mask must be (C, bins) with C = %d "
                         "(got %s)" % (C, tuple(panel_mask.shape)))
    if bin_size < 1:
        raise ValueError("bin_size must be >= 1 (got %d)" % bin_size)


def shared_limit() -> int:
    """The largest C whose planes of a read the votes kernel keeps in
    shared memory (past it, global atomics into the output)."""
    return _build.bind(_KERNEL, "cornetto_votes_shared_limit", "")()


def sharded_votes(hashes, valid, btable, bucket_shift: int,
                  two_choice: bool, ep: int, shard: int, C: int,
                  parts: int = 1):
    """One shard's lookup and votes on the ep group's gathered minimizers.

    hashes (b, M) int32 uint32 bit patterns and valid (b, M) bool (the
    all-gathered output of kernels.extract.extract_minima); btable (2^B,
    2K) int32, shard ``shard`` of a table hash-sharded over ``ep``
    (livefish.index); C the number of contigs (1..65535).  Only the hashes
    with (h & (ep - 1)) == shard count.  Returns the nine int32 planes of
    ``_lookup_votes`` with that owner filter, dense: (9, b, C), or with
    ``parts`` > 1 the rows cut in ``parts`` blocks, (parts, 9, b / parts,
    C), each block contiguous for a reduce-scatter.

    A CUDA input launches the kernel on the current stream without
    synchronising and adds one to ``sharded_votes.launches``."""
    _check_votes(hashes, valid, btable, ep, shard, C, parts)
    if hashes.device.type == "cpu":
        return sharded_votes_ref(hashes, valid, btable, bucket_shift,
                                 two_choice, ep, shard, C, parts)
    if hashes.device.type != "cuda":
        raise ValueError("unsupported device %s" % hashes.device)
    if btable.data_ptr() % 16:
        raise ValueError("btable must be 16-byte aligned")
    b, M = hashes.shape
    out = torch.empty(_out_shape(b, C, parts), dtype=torch.int32,
                      device=hashes.device)
    fn = _build.bind(_KERNEL, "cornetto_sharded_votes", "pppiiiiiiiiiipp")
    _build.launch(fn, "sharded votes kernel", hashes.device,
                  hashes.data_ptr(), valid.data_ptr(), btable.data_ptr(),
                  btable.shape[0].bit_length() - 1, btable.shape[1] // 2,
                  bucket_shift, int(two_choice), ep, shard, C, b, M, parts,
                  out.data_ptr())
    sharded_votes.launches += 1
    return out


sharded_votes.launches = 0


def policy_from_stats(stats, panel_mask, min_hits: int, bin_size: int):
    """The policy on (9, b, C) int32 planes (the shards' votes summed):
    returns the six (b,) outputs of the decision step (decision int8 — 1
    proceed / 0 unblock; best contig, est, nhits, nhits_hq, est2 int32),
    equal to ``_policy_from_stats``; a tie takes the first maximum.

    A CUDA input launches the kernel on the current stream without
    synchronising and adds one to ``policy_from_stats.launches``."""
    _check_policy(stats, panel_mask, bin_size)
    if stats.device.type == "cpu":
        return policy_from_stats_ref(stats, panel_mask, min_hits, bin_size)
    if stats.device.type != "cuda":
        raise ValueError("unsupported device %s" % stats.device)
    _, b, C = stats.shape
    dev = stats.device
    outs = [torch.empty(b, dtype=torch.int8, device=dev)] + \
        [torch.empty(b, dtype=torch.int32, device=dev) for _ in range(5)]
    fn = _build.bind(_KERNEL, "cornetto_policy_from_stats", "ppiiiiippppppp")
    _build.launch(fn, "policy kernel", dev, stats.data_ptr(),
                  panel_mask.data_ptr(), b, C, panel_mask.shape[1], min_hits,
                  bin_size, *[o.data_ptr() for o in outs])
    policy_from_stats.launches += 1
    return tuple(outs)


policy_from_stats.launches = 0
