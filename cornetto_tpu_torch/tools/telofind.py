"""telofind on the port: counterpart of cornetto_tpu/tools/telofind.py.

``--backend device`` (the default) finds the motif's matches with the
port's mask kernel (``kernels.telo.telo_match_mask_long``: one upload of
each contig, one launch per strand, the CUDA kernel on a card, its plain
version under CORNETTO_FORCE_CPU=1, an error with neither) and rebuilds the
rows on the host with ``scan_runs_from_mask``; ``--backend host`` is the
memchr scan ``scan_runs`` (a copy of the JAX package's).
A motif with a byte other than uppercase ACGT takes the host scan: the mask
kernel cannot express an N, and the sequence is uppercased but the motif is
not, so a lowercase letter matches nothing (the JAX CLI's default, the
host scan, behaves so; ``encode_seq`` would map it to the uppercase code).
Rows are byte-identical to the reference C tool's: forward then
reverse-complement hits per contig, sequences uppercased.  No jax is
imported.
"""

import sys

import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.kernels.minimizer import encode_seq
from cornetto_tpu_torch.kernels.motif import revcomp_motif
from cornetto_tpu_torch.kernels.telo import (scan_runs_from_mask,
                                             telo_match_mask_long)


def scan_runs(seq: bytes, motif: bytes):
    """Left-to-right scan-cursor over bytes.find (memchr-fast, the same
    access pattern as the reference's strstr loop): yields maximal exact
    tandem runs (start, end, matched_len)."""
    k = len(motif)
    pos = 0
    while True:
        pos = seq.find(motif, pos)
        if pos < 0:
            return
        start = pos
        length = 0
        while seq[pos:pos + k] == motif:
            pos += k
            length += k
        yield (start, pos, length)
        pos += 1


def run(fasta_path: str, motif: str = "TTAGGG", out=None,
        backend: str = "device") -> None:
    out = out or sys.stdout
    rmotif = revcomp_motif(motif)
    dev = resolve_device() if backend == "device" else None
    for rec in read_fastx(fasta_path):
        # disambiguate: uppercase (reference :76-81)
        seq = rec.seq.upper().encode("latin-1")
        L = len(seq)
        codes = None
        for strand, m in ((0, motif), (1, rmotif)):
            mb = m.encode("latin-1")
            if backend != "device" or not set(mb) <= set(b"ACGT"):
                runs = scan_runs(seq, mb)
            else:
                if codes is None:       # one upload serves both strands
                    codes = torch.from_numpy(
                        encode_seq(seq.decode("latin-1"))).to(dev)
                mask = telo_match_mask_long(codes, encode_seq(m).tolist())
                runs = scan_runs_from_mask(mask, len(mb))
            out.write("".join("%s\t%d\t%d\t%d\t%d\t%d\n"
                              % (rec.name, L, strand, st, end, ln)
                              for st, end, ln in runs))


def main(argv) -> int:
    args = argv[1:] if argv and argv[0] == "telofind" else argv
    backend = "device"
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--backend" and i + 1 < len(args):
            backend = args[i + 1]
            i += 2
        elif a.startswith("--backend="):
            backend = a.split("=", 1)[1]
            i += 1
        else:
            pos.append(a)
            i += 1
    if backend not in ("host", "device"):
        sys.stderr.write("Error: --backend must be host or device\n")
        return 1
    if len(pos) < 1:
        sys.stderr.write("Error: invalid number of parameters\n")
        sys.stderr.write("Usage: find <input fasta> [optional sequence to "
                         "search for, default is vertebrate TTAGGG] "
                         "[--backend host|device]\n")
        return 1
    motif = pos[1] if len(pos) >= 2 else "TTAGGG"
    run(pos[0], motif, backend=backend)
    return 0
