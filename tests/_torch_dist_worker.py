"""One rank of the port's multi-device runtime for tests/test_torch_dist.py:
a gloo process group on the CPU (CORNETTO_FORCE_CPU=1) joined through a
``file://`` rendezvous, running every case its world size is given in
one group and writing what it got to ``<work>/w<world>_r<rank>.npz`` for
the test to hold against the JAX package.  Imports neither ``jax`` nor
``cornetto_tpu``.

Usage: python tests/_torch_dist_worker.py <rank> <world> <work dir>

<work>/plan<world>.json names the cases: the sharded engines ((dp, ep) meshes,
the reads and packed batches of <work>/inputs.npz, the indexes
<work>/idx<E>.npz), the sp scans, the halo check, the chunk engine over
a sharded engine, the sharded checkpoint of each rank's engine state
(dist.checkpoint.save_sharded / load_sharded), and the meshes whose
layout is recorded.
"""

import datetime
import json
import os
import sys

import numpy as np
import torch


def _engine_cases(plan, inp, out):
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.livefish.decide import make_sharded_engine
    work = plan["work"]
    L = int(inp["L"])
    forms = {
        "decide": None,
        "nmask": (inp["packed"], inp["nmask"], None),
        "lengths": (inp["packed"], None, inp["lengths"]),
        "neither": (inp["packed"], None, None),
    }
    for dp, ep in plan["engine"]:
        mesh = make_mesh({"dp": dp, "ep": ep})       # every rank, in order
        if not mesh.member:
            continue
        idx, panel, _ = load_index(os.path.join(work, "idx%d" % ep))
        eng = make_sharded_engine(mesh, idx, panel)
        for form, args in forms.items():
            res = eng(inp["reads"]) if args is None else \
                eng.decide_packed(args[0], args[1], L, lengths=args[2])
            for i, r in enumerate(res):
                out["engine/%dx%d/%s/%d" % (dp, ep, form, i)] = r.numpy()


def _scan_cases(plan, inp, out):
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.dist.scan import sharded_window_stats
    for n_sp, case in plan["scan"]:
        mesh = make_mesh({"sp": n_sp})
        if not mesh.member:
            continue
        length, w, inc = plan["scan_cases"][case]
        res = sharded_window_stats(mesh, inp["depth%d" % case], length, w,
                                   inc)
        for name, a in zip(("st", "end", "means"), res):
            out["scan/%d/%d/%s" % (n_sp, case, name)] = a


def _halo_case(world, rank, out):
    """tests/_mp_worker.py's halo check: every rank's shard of the
    stride-1 sums against the forward sums of the zero-padded array."""
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.dist.scan import make_sharded_sliding_sum
    W = 64
    n = 256 * world
    depth = np.zeros(n, dtype=np.int32)
    depth[:n - W] = (np.arange(n - W) * 7) % 101
    mesh = make_mesh({"sp": world})
    got = make_sharded_sliding_sum(mesh, W)(
        torch.from_numpy(depth[rank * 256:(rank + 1) * 256].copy()))
    out["halo"] = got.numpy()


def _chunk_case(plan, inp, out):
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.livefish.chunks import (ChunkDecisionEngine,
                                                    ChunkEvent)
    from cornetto_tpu_torch.livefish.decide import (SingleChipEngine,
                                                    make_sharded_engine)
    dp, ep = plan["chunks"]
    mesh = make_mesh({"dp": dp, "ep": ep})
    if not mesh.member:
        return
    work = plan["work"]
    idx1, panel1, _ = load_index(os.path.join(work, "idx1"))
    idxE, panelE, _ = load_index(os.path.join(work, "idx%d" % ep))
    ce1 = ChunkDecisionEngine(SingleChipEngine(idx1, panel1), n_channels=4,
                              chunk_len=200, batch=4)
    ceE = ChunkDecisionEngine(make_sharded_engine(mesh, idxE, panelE),
                              n_channels=4, chunk_len=200, batch=4)
    acgt = np.array(list("ACGT"))
    ctg = "".join(acgt[inp["ctgA"]])
    s_boring, s_fun = ctg[25000:25800], ctg[45000:45800]
    for t in range(4):
        ev = [ChunkEvent(0, "rb", s_boring[t * 200:(t + 1) * 200]),
              ChunkEvent(1, "rf", s_fun[t * 200:(t + 1) * 200])]
        for name, ce in (("single", ce1), ("sharded", ceE)):
            out["chunks/%s/%d" % (name, t)] = np.array(
                sorted((d.channel, d.action) for d in ce.process(ev)),
                dtype=np.int64).reshape(-1, 2)
    out["chunks/done"] = np.array([ce1._done[0], ce1._done[1],
                                   ceE._done[0], ceE._done[1]])
    # the sharded engine's fused form of one batch beside its six outputs
    args = (inp["packed"], None, int(inp["L"]))
    out["chunks/fused"] = ceE.engine.decide_packed_fused(
        *args, lengths=inp["lengths"]).numpy()
    for i, r in enumerate(ceE.engine.decide_packed(*args,
                                                   lengths=inp["lengths"])):
        out["chunks/six/%d" % i] = r.numpy()


def _sharded_ckpt_case(plan, inp, out):
    """Each rank's table shard and panel through save_sharded and
    load_sharded (into -1-filled tensors, and with no abstract tree), and
    the engine's decisions on the reloaded state."""
    import dataclasses
    from cornetto_tpu_torch.dist.checkpoint import (load_index, load_sharded,
                                                    save_sharded)
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.livefish.decide import make_sharded_engine
    dp, ep = plan["sharded_ckpt"]
    mesh = make_mesh({"dp": dp, "ep": ep})
    if not mesh.member:
        return
    work = plan["work"]
    idx, panel, _ = load_index(os.path.join(work, "idx%d" % ep))
    eng = make_sharded_engine(mesh, idx, panel)
    tree = {"btable": eng.state.btable, "panel": eng.state.panel}
    path = os.path.join(work, "sharded%dx%d" % (dp, ep))
    assert save_sharded(path, tree) is True
    back = load_sharded(path, {k: torch.full_like(v, -1)
                               for k, v in tree.items()})
    fresh = load_sharded(path)
    for k in tree:
        out["ckpt/%s" % k] = back[k].numpy()
        out["ckpt/fresh/%s" % k] = fresh[k].numpy()
    eng.state = dataclasses.replace(eng.state, **back)
    for i, r in enumerate(eng(inp["reads"])):
        out["ckpt/decide/%d" % i] = r.numpy()


def _mesh_cases(plan, out):
    import torch.distributed as dist
    from cornetto_tpu_torch.dist.mesh import decision_mesh, make_mesh
    meshes = [(json.dumps(a), make_mesh(a)) for a in plan["meshes"]]
    meshes.append(("decision", decision_mesh()))
    for key, mesh in meshes:
        out["mesh/%s/sizes" % key] = np.array(mesh.sizes)
        out["mesh/%s/coords" % key] = np.array(
            mesh.coords if mesh.member else [-1] * len(mesh.sizes))
        for name in mesh.axis_names:
            g = mesh.groups.get(name)
            out["mesh/%s/%s" % (key, name)] = np.array(
                dist.get_process_group_ranks(g) if g is not None else [])


def main() -> int:
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from cornetto_tpu_torch.dist import multihost
    with open(os.path.join(work, "plan%d.json" % world)) as f:
        plan = json.load(f)
    plan["work"] = work
    started = multihost.initialize(
        init_method="file://" + os.path.join(work, "rdv%d" % world),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=plan["timeout"]))
    assert started and dist.get_backend() == "gloo"
    out = {}
    ones = torch.ones(1, dtype=torch.int32)
    dist.all_reduce(ones)                        # _mp_worker.py's psum check
    out["allreduce"] = ones.numpy()
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    _mesh_cases(plan, out)
    _engine_cases(plan, inp, out)
    _scan_cases(plan, inp, out)
    _halo_case(world, rank, out)
    if plan.get("chunks"):
        _chunk_case(plan, inp, out)
    if plan.get("sharded_ckpt"):
        _sharded_ckpt_case(plan, inp, out)
    np.savez(os.path.join(work, "w%d_r%d.npz" % (world, rank)), **out)
    dist.barrier()
    dist.destroy_process_group()
    print("rank %d/%d OK" % (rank, world))
    return 0


if __name__ == "__main__":
    sys.exit(main())
