"""The port's device mesh: counterpart of cornetto_tpu/dist/mesh.py
(a jax.sharding.Mesh).

One process a device (SPMD): the mesh lays the ranks of the default
process group out on a grid of named axes, ``dp`` for read batches,
``ep`` for index hash shards, ``sp`` for contig-sharded scans, in
row-major order as ``np.array(devices).reshape(sizes)`` does, and holds
for each axis the process group of the ranks that share every other
coordinate (the group a collective over that axis runs on) and one group
of all the mesh's ranks.  A mesh smaller than the world leaves the ranks
past it outside (``member`` False), as the JAX mesh takes the first
devices.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist


@dataclass
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]]  # this rank's; None outside the mesh
    groups: Dict[str, object]          # axis -> this rank's group on it
    group: object                      # every rank of the mesh

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (jax.lax.axis_index)."""
        if self.coords is None:
            raise ValueError("this rank is outside the mesh")
        return self.coords[self.axis_names.index(axis)]


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """Build a Mesh with named axes from ``axes`` (e.g. {"dp": 2, "ep":
    4}) over the ranks of the default process group, which must be
    started (dist.multihost.initialize).  The total must not exceed the
    world size; an axis sized -1 absorbs the rest.

    Collective: every rank calls it with the same axes, since
    torch.distributed.new_group must be called by every rank of the world
    for every group, in the same order, even for the groups it is not in
    (a rank that skips one leaves the others waiting)."""
    world = dist.get_world_size()
    me = dist.get_rank()
    names = tuple(axes)
    sizes = [int(axes[n]) for n in names]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    known = int(np.prod([s for s in sizes if s != -1]))
    if unknown:
        assert len(unknown) == 1
        sizes[unknown[0]] = world // known
    total = int(np.prod(sizes))
    assert 1 <= total <= world, (sizes, world)
    grid = np.arange(total).reshape(sizes)
    groups = {}
    for i, name in enumerate(names):
        # the lines of the grid along axis i, in the same order everywhere
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            g = dist.new_group(line.tolist())
            if me in line:
                groups[name] = g
    whole = dist.group.WORLD if total == world else \
        dist.new_group(list(range(total)))
    coords = tuple(int(c) for c in np.unravel_index(me, sizes)) \
        if me < total else None
    return Mesh(names, tuple(sizes), coords, groups,
                whole if me < total else None)


def decision_axes(world: int, n_dp: Optional[int] = None,
                  n_ep: Optional[int] = None) -> Dict[str, int]:
    """The default livefish mesh's axes for ``world`` ranks: ep gets the
    largest power of two up to 8 that divides the world, dp the rest."""
    if n_ep is None:
        n_ep = 1
        while n_ep * 2 <= min(world, 8) and world % (n_ep * 2) == 0:
            n_ep *= 2
    if n_dp is None:
        n_dp = world // n_ep
    return {"dp": n_dp, "ep": n_ep}


def decision_mesh(n_dp: Optional[int] = None,
                  n_ep: Optional[int] = None) -> Mesh:
    """The default livefish mesh over the default process group
    (decision_axes)."""
    return make_mesh(decision_axes(dist.get_world_size(), n_dp, n_ep))
