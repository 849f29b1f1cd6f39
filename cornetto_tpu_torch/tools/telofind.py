"""telofind on the port: counterpart of cornetto_tpu/tools/telofind.py.

``--backend device`` (the default) uploads each contig's codes once and,
per strand, finds the motif's match positions on the port's device
(``kernels.telo.telo_match_positions``: the mask kernel, compacted where it
lies, the CUDA kernel on a card, its plain version under
CORNETTO_FORCE_CPU=1, an error with neither); only the positions come back
to the host, where ``scan_runs_from_positions`` rebuilds the rows.
``--backend host`` is the memchr scan ``scan_runs`` (a copy of the JAX
package's).
A motif with a byte other than uppercase ACGT takes the host scan: the mask
kernel cannot express an N, and the sequence is uppercased but the motif is
not, so a lowercase letter matches nothing (the JAX CLI's default, the
host scan, behaves so; the encoding would map it to the uppercase code).
Rows are byte-identical to the reference C tool's: forward then
reverse-complement hits per contig, sequences uppercased.  No jax is
imported.

Each record's sequence stays bytes from the file to the codes
(io/fasta.py::read_fasta): the device backend encodes it with one table
lookup a byte that maps either case of ACGT to one code, and the host scan
uppercases it with bytes.upper(), which maps ASCII letters alone, as the
reference's C toupper does.  A byte outside ASCII is no longer case-mapped
by Python's latin-1 rules, which the JAX package applies to its str (there
'\xdf' became 'SS' and changed the contig's length).
"""

import sys

import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.io.fasta import read_fasta, timed_reads
from cornetto_tpu_torch.kernels.minimizer import encode_bytes
from cornetto_tpu_torch.kernels.motif import revcomp_motif
from cornetto_tpu_torch.kernels.telo import (scan_runs_from_positions,
                                             telo_match_positions)
from cornetto_tpu_torch.utils import profiling


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
        backend: str = "device", stats: dict = None) -> None:
    """stats: optional dict; the run adds its counts (contigs, bases,
    positions read back; records and squeezed, read_fasta's records and
    those whose body held a line end) and its seconds per part to it: read
    (the FASTA read), encode (the codes on the device backend, the
    uppercase for the host scan), h2d, kernel, compact, readback, walk (the
    host scan on the host backend) and output, synchronising the card at
    the end of each part.  Under a profiler each part is the span
    ``telofind.<part>``, timed by the same clock (utils.profiling.lap)."""
    out = out or sys.stdout
    rmotif = revcomp_motif(motif)
    dev = resolve_device() if backend == "device" else None
    acc = {} if stats is None else stats

    def lap(part):
        return profiling.lap("telofind." + part, stats, dev)

    for rec in timed_reads(read_fasta(fasta_path), lambda: lap("read"),
                           stats):
        name, seq = rec.name.decode("latin-1"), rec.seq
        L = len(seq)
        codes = upper = None
        for strand, m in ((0, motif), (1, rmotif)):
            mb = m.encode("latin-1")
            if backend != "device" or not set(mb) <= set(b"ACGT"):
                if upper is None:
                    with lap("encode"):
                        # disambiguate: uppercase (reference :76-81)
                        upper = seq.upper()
                with lap("walk"):
                    runs = list(scan_runs(upper, mb))
            else:
                if codes is None:       # one upload serves both strands
                    with lap("encode"):
                        codes = encode_bytes(seq)
                    with lap("h2d"):
                        codes = torch.from_numpy(codes).to(dev)
                pos = telo_match_positions(codes, encode_bytes(mb).tolist(),
                                           stats=stats)
                with lap("readback"):
                    pos = pos.cpu().numpy()
                acc["positions"] = acc.get("positions", 0) + len(pos)
                with lap("walk"):
                    runs = scan_runs_from_positions(pos, len(mb), L)
            with lap("output"):
                out.write("".join("%s\t%d\t%d\t%d\t%d\t%d\n"
                                  % (name, L, strand, st, end, ln)
                                  for st, end, ln in runs))
        acc["contigs"] = acc.get("contigs", 0) + 1
        acc["bases"] = acc.get("bases", 0) + L


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
