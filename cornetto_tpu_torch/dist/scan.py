"""Contig-sharded window scanning with a halo exchange, the runtime's
sequence-parallel (``sp``) axis: counterpart of cornetto_tpu/dist/scan.py.

The depth array of one contig is cut into equal shards, one a rank of the
mesh's sp axis; each shard needs only the next shard's first
``window_size`` elements to take its sliding sums alone, and gets them by
one send/recv pair (dist.collectives.shift_left, the JAX scan's
ppermute).  The sums are the window-sum kernel (kernels.window_sum.
window_sums, csrc/window_sum.cu) at stride 1.
"""

import numpy as np
import torch

from cornetto_tpu_torch.dist import collectives
from cornetto_tpu_torch.dist.multihost import local_device
from cornetto_tpu_torch.kernels.window_sum import n_windows, window_sums


def make_sharded_sliding_sum(mesh, window_size: int):
    """Returns fn(x) for this rank's (shard,) int32 slice x of a global
    array, sharded over the mesh's "sp" axis in rank order, whose trailing
    ``window_size`` elements (within the last shard) are zeros; fn returns
    the (shard,) int32 sliding sums of ``window_size`` of x followed by the
    next shard's head (zeros past the last shard), as the JAX function's
    shard does.  The kernel sums in int64 and the result is cast to int32,
    the JAX result's type: sums past 2^31 - 1 wrap there and here alike,
    and the callers keep below it (depths * window_size)."""
    n_sp = mesh.shape["sp"]
    last = mesh.index("sp") == n_sp - 1
    group = mesh.groups["sp"]

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 1 or x.shape[0] < window_size:
            raise ValueError("a shard must be 1-D and hold at least "
                             "window_size = %d elements (got %s)"
                             % (window_size, tuple(x.shape)))
        head = x[:window_size]
        # the last shard's incoming halo (shard 0's head) is zeroed: the
        # caller guarantees the global array is zero-padded
        recv = collectives.shift_left(head, group) if n_sp > 1 else None
        if recv is None or last:
            recv = torch.zeros_like(head)
        ext = torch.cat([x, recv])
        return window_sums(ext, window_size, 1,
                           n_out=x.shape[0]).to(torch.int32)
    return fn


def sharded_window_stats(mesh, depth: np.ndarray, length: int,
                         window_size: int, window_inc: int):
    """Sharded window means of one contig: every rank of the sp axis passes
    the whole depth array and uploads only its shard, the shards exchange
    their halos and take their sliding sums, each rank takes the means of
    the windows that start in its shard, and one all-gather gives every
    rank all of them.  Returns (starts, ends, means) int32 numpy arrays,
    equal to kernels.window_sum.window_stats_numpy's first three (the
    JAX function's results)."""
    n_sp = mesh.shape["sp"]
    me = mesh.index("sp")
    shard = -(-(length + window_size) // n_sp)
    # a single-neighbour halo covers the window only if shards >= window
    shard = max(shard, window_size)
    shard = -(-shard // 128) * 128
    total = shard * n_sp
    lo = me * shard
    x = np.zeros(shard, dtype=np.int32)
    n_mine = max(0, min(length - lo, shard))
    x[:n_mine] = depth[lo:lo + n_mine]
    dev = local_device()
    win = make_sharded_sliding_sum(mesh, window_size)(
        torch.from_numpy(x).to(dev))
    nw = n_windows(length, window_size, window_inc)
    st = np.arange(nw, dtype=np.int64) * window_inc
    end = np.minimum(st + window_size, length)
    at = np.minimum(st, total - 1)
    # the windows of each shard: a run of consecutive starts
    cuts = np.searchsorted(at, np.arange(n_sp + 1) * shard)
    counts = np.diff(cuts)
    a, b = cuts[me], cuts[me + 1]
    pad = int(counts.max())
    mine = torch.zeros(pad, dtype=torch.int32, device=dev)
    if b > a:
        sel = torch.from_numpy(at[a:b] - lo).to(dev)
        div = torch.from_numpy(end[a:b] - st[a:b]).to(dev)
        mine[:b - a] = torch.div(win[sel].to(torch.int64), div,
                                 rounding_mode="floor").to(torch.int32)
    every = collectives.all_gather(mine, mesh.groups["sp"]).cpu().numpy()
    means = np.concatenate([every[s * pad:s * pad + counts[s]]
                            for s in range(n_sp)])
    return st.astype(np.int32), end.astype(np.int32), means
