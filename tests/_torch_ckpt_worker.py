"""One rank of the crash-injected stream over the port's sharded decision
engine: the protocol of tests/_ckpt_worker.py on torch.distributed, for
tests/test_torch_checkpoint_failure.py (two gloo ranks at (dp, ep) =
(1, 2) on the CPU) and chip_smoke.py (NCCL at (1, 1) on a card).  Imports
neither ``jax`` nor ``cornetto_tpu``.

Every rank of a (1, world) mesh streams the FASTQ through the sharded
engine in fixed batches; rank 0 makes each batch durable with
write-ahead discipline:

    1. write decision rows  -> part.<i>.tmp, fsync, atomic rename part.<i>
    2. checkpoint (cursor=i+1, running tallies, index, panel)
       via cornetto_tpu_torch.dist.checkpoint.save_index (atomic rename)

and dies (os._exit(9)) at the crash point asked for:

    crash_spec: none            run to completion
                mid_part:<i>    die with half of batch i's rows written
                                to the tmp file (torn write)
                after_part:<i>  die after batch i's part rename but
                                BEFORE the checkpoint update
                after_ckpt:<i>  die right after batch i's checkpoint

The other ranks then fail in the next collective (the group's timeout
bounds the wait).  On start rank 0 loads the newest checkpoint (if any)
and broadcasts its cursor; batches before it are skipped, leftover tmp
files and parts >= cursor are recomputed.  A completed run concatenates
the parts into decisions.tsv and prints the final tallies, which must be
byte-identical no matter where an earlier life died.

The engine's index is tests/_ckpt_worker.py's (its genome from seed 1234,
``world`` hash shards, panel ctgA:0-25000), or a saved one (--index, with
``world`` shards).

Usage: python tests/_torch_ckpt_worker.py <rank> <world> <rendezvous file>
           <workdir> <fastq> <crash_spec> [--index path] [--batch N]
           [--read-len L] [--timeout S]
"""

import argparse
import datetime
import os
import sys

import numpy as np
import torch


def build_index(n_shards: int):
    from cornetto_tpu_torch.livefish.index import (build_index as build,
                                                   build_panel_mask)
    rng = np.random.default_rng(1234)
    bases = np.array(list("ACGT"))
    genome = {"ctgA": "".join(bases[rng.integers(0, 4, 50000)]),
              "ctgB": "".join(bases[rng.integers(0, 4, 30000)])}
    idx = build(genome, n_shards=n_shards)
    return idx, build_panel_mask(idx, [("ctgA", 0, 25000)])


def main() -> int:
    ap = argparse.ArgumentParser()
    for name in ("rank", "world"):
        ap.add_argument(name, type=int)
    for name in ("rdv", "workdir", "fastq", "crash_spec"):
        ap.add_argument(name)
    ap.add_argument("--index")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--read-len", type=int, default=300)
    ap.add_argument("--timeout", type=float, default=60.0)
    a = ap.parse_args()
    torch.set_num_threads(1)
    import torch.distributed as dist
    from cornetto_tpu_torch.dist import checkpoint, multihost
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.livefish.decide import make_sharded_engine
    from cornetto_tpu_torch.livefish.stream import batches_from_fastq

    crash_kind, crash_i = "none", -1
    if a.crash_spec != "none":
        crash_kind, s = a.crash_spec.split(":")
        crash_i = int(s)
    multihost.initialize(init_method="file://" + os.path.abspath(a.rdv),
                         world_size=a.world, rank=a.rank,
                         timeout=datetime.timedelta(seconds=a.timeout))
    if a.index:
        idx, panel, _ = checkpoint.load_index(a.index)
    else:
        idx, panel = build_index(a.world)
    lead = a.rank == 0
    ckpt = os.path.join(a.workdir, "state.npz")
    cursor = 0
    n_ctg = len(idx.contig_names)
    tallies = {"accepted": np.zeros(n_ctg, np.int64), "total": np.int64(0)}
    if lead and os.path.exists(ckpt):
        _, _, t = checkpoint.load_index(ckpt)
        cursor = int(t["cursor"])
        tallies = {"accepted": t["accepted"].astype(np.int64),
                   "total": np.int64(t["total"])}
        print("resumed at cursor %d" % cursor, flush=True)
    c = torch.tensor([cursor], dtype=torch.int64,
                     device=multihost.local_device())
    dist.broadcast(c, 0)
    cursor = int(c.item())

    eng = make_sharded_engine(make_mesh({"dp": 1, "ep": a.world}), idx,
                              panel)

    def die(tag):
        print("CRASH %s" % tag, flush=True)
        sys.stdout.flush()
        os._exit(9)

    n_batches = 0
    for i, rb in enumerate(batches_from_fastq(a.fastq, a.batch,
                                              a.read_len)):
        n_batches = i + 1
        if i < cursor:
            continue          # durable already; do NOT recompute
        d, best, est, nhits = (x.cpu().numpy() for x in eng(rb.codes)[:4])
        if not lead:
            continue
        rows = "".join(
            "%s\t%d\t%d\t%d\t%d\n"
            % (rb.ids[j], int(d[j]), int(best[j]), int(est[j]),
               int(nhits[j]))
            for j in range(rb.count))
        print("batch %d computed" % i, flush=True)
        part = os.path.join(a.workdir, "part.%05d" % i)
        tmp = part + ".tmp"
        data = rows.encode()
        with open(tmp, "wb") as f:
            if crash_kind == "mid_part" and i == crash_i:
                f.write(data[:len(data) // 2])
                f.flush()
                os.fsync(f.fileno())
                die("mid_part:%d" % i)
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, part)
        if crash_kind == "after_part" and i == crash_i:
            die("after_part:%d" % i)
        tallies = {
            "accepted": tallies["accepted"]
            + np.bincount(best[:rb.count], weights=d[:rb.count],
                          minlength=n_ctg).astype(np.int64),
            "total": np.int64(int(tallies["total"]) + rb.count),
            "cursor": np.int64(i + 1),
        }
        tmpc = ckpt + ".tmp.npz"
        checkpoint.save_index(tmpc, idx, panel, tallies)
        os.replace(tmpc, ckpt)
        del tallies["cursor"]
        if crash_kind == "after_ckpt" and i == crash_i:
            die("after_ckpt:%d" % i)

    if lead:
        out = os.path.join(a.workdir, "decisions.tsv")
        with open(out + ".tmp", "wb") as f:
            for i in range(n_batches):
                with open(os.path.join(a.workdir, "part.%05d" % i),
                          "rb") as p:
                    f.write(p.read())
        os.replace(out + ".tmp", out)
        print("tallies accepted=%s total=%d"
              % (tallies["accepted"].tolist(), int(tallies["total"])),
              flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if lead:
        print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
