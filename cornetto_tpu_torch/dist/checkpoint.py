"""Durable index state of the port: the minimizer index, the panel mask
and running tallies as one uncompressed numpy ``.npz``.

The layout is the JAX package's (cornetto_tpu/dist/checkpoint.py, without
its orbax branch for sharded JAX arrays), key for key and dtype for dtype,
so an index written by either package loads in the other."""

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

