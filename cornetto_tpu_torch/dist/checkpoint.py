"""Durable state of the port: counterpart of cornetto_tpu/dist/checkpoint.py.

``save_index`` / ``load_index`` keep the minimizer index, the panel mask
and running tallies as one uncompressed numpy ``.npz``, in the JAX
package's layout key for key and dtype for dtype, so an index written by
either package loads in the other.  ``save_sharded`` / ``load_sharded``
stand for its Orbax pair: a dict of tensors, each rank's its own shard,
written to one directory through ``torch.distributed.checkpoint``."""

import os
from typing import Dict, Optional

import numpy as np

from cornetto_tpu_torch.livefish.index import MinimizerIndex


def save_index(path: str, index: MinimizerIndex,
               panel_mask: Optional[np.ndarray] = None,
               tallies: Optional[Dict[str, np.ndarray]] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {
        "shard_counts": index.shard_counts,
        "contig_lens": index.contig_lens,
        "k": np.int64(index.k),
        "w": np.int64(index.w),
        "btable": index.btable,
        "bucket_shift": np.int64(index.bucket_shift),
        "bucket_slots": np.int64(index.bucket_slots),
        "two_choice": np.bool_(getattr(index, "two_choice", False)),
        "contig_names": np.array(index.contig_names, dtype=object),
    }
    if index.hashes is not None:
        # padded per-shard tables exist only with keep_tables builds;
        # the runtime needs just btable (livefish/index.py)
        arrays["hashes"] = index.hashes
        arrays["contigs"] = index.contigs
        arrays["positions"] = index.positions
    if panel_mask is not None:
        arrays["panel_mask"] = panel_mask
    for name, arr in (tallies or {}).items():
        arrays["tally_" + name] = np.asarray(arr)
    # uncompressed: hashes/btable are near-uniform bits (deflate gains
    # ~nothing and costs minutes at whole-genome scale)
    np.savez(path, **arrays)


def load_index(path: str):
    """Returns (MinimizerIndex, panel_mask or None, tallies dict)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=True)
    has_tables = "hashes" in z.files
    index = MinimizerIndex(
        hashes=z["hashes"] if has_tables else None,
        contigs=z["contigs"] if has_tables else None,
        positions=z["positions"] if has_tables else None,
        shard_counts=z["shard_counts"],
        contig_names=[str(x) for x in z["contig_names"]],
        contig_lens=z["contig_lens"], k=int(z["k"]), w=int(z["w"]),
        btable=z["btable"],
        bucket_shift=int(z["bucket_shift"]),
        bucket_slots=int(z["bucket_slots"]),
        # pre-round-5 checkpoints hold single-choice tables
        two_choice=bool(z["two_choice"]) if "two_choice" in z.files
        else False)
    panel = z["panel_mask"] if "panel_mask" in z.files else None
    tallies = {name[len("tally_"):]: z[name] for name in z.files
               if name.startswith("tally_")}
    return index, panel, tallies


def _grouped() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank_key(name: str) -> str:
    """A tree key under this rank: ranks holding different shards under
    one name must not be merged as replicas of one tensor."""
    import torch.distributed as dist
    return "rank%d/%s" % (dist.get_rank() if _grouped() else 0, name)


def _dcp(fn, state, **kw):
    """fn (torch.distributed.checkpoint's save or load) over state, without
    its warnings of what is asked for here: a checkpoint overwritten, and,
    with no process group, a run in this process alone."""
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Detected an existing")
        if not _grouped():
            warnings.filterwarnings("ignore", message="torch.distributed is")
        return fn(state, **kw)


def save_sharded(ckpt_dir: str, tree) -> bool:
    """Checkpoint a dict of tensors to ckpt_dir, overwriting what is there;
    returns True.  With a process group every rank calls it (collective),
    each with its own shard under each name (the sharded engine's table
    shard, for example): the directory holds every rank's tensors and one
    metadata file.  Without one it writes this process's tensors alone.
    Tensors on a card are copied to the host as they are written."""
    import torch.distributed.checkpoint as dcp
    state = {_rank_key(k): v for k, v in tree.items()}
    _dcp(dcp.save, state,
         storage_writer=dcp.FileSystemWriter(os.path.abspath(ckpt_dir),
                                             overwrite=True))
    return True


def load_sharded(ckpt_dir: str, abstract_tree=None):
    """This rank's tensors of a save_sharded checkpoint, read at the same
    world size, as a dict under the names they were saved with.
    abstract_tree is a dict of tensors of the right shapes and dtypes,
    filled in place and returned (on whatever device they lie); None
    reads every tensor this rank saved into new CPU tensors."""
    import torch
    import torch.distributed.checkpoint as dcp
    reader = dcp.FileSystemReader(os.path.abspath(ckpt_dir))
    if abstract_tree is None:
        prefix = _rank_key("")
        meta = reader.read_metadata().state_dict_metadata
        abstract_tree = {
            k[len(prefix):]: torch.empty(tuple(m.size),
                                         dtype=m.properties.dtype)
            for k, m in meta.items() if k.startswith(prefix)}
    state = {_rank_key(k): v for k, v in abstract_tree.items()}
    _dcp(dcp.load, state, storage_reader=reader)
    return {k: state[_rank_key(k)] for k in abstract_tree}
