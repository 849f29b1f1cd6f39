"""sdust on the port: counterpart of cornetto_tpu/tools/sdust.py.

``--backend device`` runs the SDUST DP of each contig on the port's device
(``kernels.sdust.sdust_device``: the CUDA kernel on a card, its plain
PyTorch version under CORNETTO_FORCE_CPU=1, an error with neither);
``--backend host`` runs the native sequential DP (``native.sdust``) on a
thread pool, as the JAX package's host backend does.  The device DP takes
3 <= W <= 66 (its ring holds 64 words) and T >= 5 (below, the JAX kernel's
DP departs from the sequential one).  With no ``--backend`` the device runs
when (W, T) lie in that range and the host DP otherwise, so every -w / -t
the JAX CLI takes prints its rows; an explicit ``--backend device`` outside
the range exits 1 with the limit.  This routes on the parameters alone: no
build or launch error is caught.  Rows are byte-identical to the reference
C tool's.
"""

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.io.fasta import read_fasta, timed_reads
from cornetto_tpu_torch.kernels.sdust import check_params, sdust_device
from cornetto_tpu_torch.native.sdust import sdust
from cornetto_tpu_torch.utils import logging as log
from cornetto_tpu_torch.utils import profiling
from cornetto_tpu_torch.utils.parsing import c_atoi

CORE = 2048      # chunk core of the device DP (sdust_pallas' default)


def run(fasta_path: str, T: int = 20, W: int = 64, out=None,
        workers: int = None, backend: str = "device",
        stats: dict = None) -> None:
    """backend "device": one sdust_device call per contig with a chunk core
    of CORE, serial over contigs (the chunks are the parallel axis), on the
    record's bytes as read_fasta gives them; its counts and per-part
    seconds added to ``stats`` if given (which synchronises the card at the
    end of each part), with the FASTA read as the part ``read`` (the span
    ``sdust.read``), counting ``records`` and ``squeezed`` (records whose
    body held a line end, so took a second copy); anything else is the
    host path."""
    out = out or sys.stdout
    if backend != "device":
        _run_host(fasta_path, T, W, out, workers)
        return
    dev = resolve_device()
    for rec in timed_reads(read_fasta(fasta_path),
                           lambda: profiling.lap("sdust.read", stats, dev),
                           stats):
        ivals = sdust_device(rec.seq, T=T, W=W, core=CORE, device=dev,
                             stats=stats)
        if ivals:
            name = rec.name.decode("latin-1")
            out.write("".join("%s\t%d\t%d\n" % (name, a, b)
                              for a, b in ivals))


def _run_host(fasta_path: str, T: int, W: int, out, workers) -> None:
    """The native DP over contigs on a thread pool (the ctypes call
    releases the GIL), with a bounded in-flight window so memory stays at
    O(workers) contigs; rows are written in FASTA order."""
    nw = workers or os.cpu_count() or 1

    def _mask(rec):
        return rec.name.decode("latin-1"), sdust(rec.seq, T=T, W=W)

    def _emit(fut_name_ivals):
        name, ivals = fut_name_ivals.result()
        if ivals:
            out.write("".join("%s\t%d\t%d\n" % (name, a, b)
                              for a, b in ivals))

    with ThreadPoolExecutor(max_workers=nw) as ex:
        inflight = deque()
        for rec in read_fasta(fasta_path):
            inflight.append(ex.submit(_mask, rec))
            while len(inflight) > 2 * nw:
                _emit(inflight.popleft())
        while inflight:
            _emit(inflight.popleft())


def main(argv) -> int:
    W, T = 64, 20
    backend = None
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-w":
            W = c_atoi(argv[i + 1]); i += 2
        elif a.startswith("-w"):
            W = c_atoi(a[2:]); i += 1
        elif a == "-t":
            T = c_atoi(argv[i + 1]); i += 2
        elif a.startswith("-t"):
            T = c_atoi(a[2:]); i += 1
        elif a.startswith("--backend"):
            backend = a.split("=", 1)[1] if "=" in a else argv[i + 1]
            i += 1 if "=" in a else 2
        else:
            args.append(a); i += 1
    if not args:
        sys.stderr.write("Usage: sdust [-w %d] [-t %d] "
                         "[--backend host|device] <in.fa>\n" % (W, T))
        return 1
    if backend not in (None, "host", "device"):
        sys.stderr.write("Error: --backend must be host or device\n")
        return 1
    if backend != "host":
        try:
            check_params(W, T)
            backend = "device"
        except ValueError as e:
            if backend == "device":
                sys.stderr.write("Error: %s\n" % e)
                return 1
            log.verbose("sdust: W=%d, T=%d lie outside the device DP's "
                        "range; the host DP runs" % (W, T))
            backend = "host"
    run(args[0], T=T, W=W, backend=backend)
    return 0
