"""sdust on the port: counterpart of cornetto_tpu/tools/sdust.py.

``--backend device`` runs the SDUST DP of each contig on the port's device
(``kernels.sdust.sdust_device``: the CUDA kernel on a card, its plain
PyTorch version under CORNETTO_FORCE_CPU=1); ``host`` (the default) is the
JAX package's native thread-pool path, called as it is.  The device DP
takes 3 <= W <= 66 (its ring holds 64 words) and T >= 5 (below, the JAX
kernel's DP departs from the sequential one): any other -w or -t exits 1
with the limit, it does not switch to the host.  Rows are byte-identical
to the reference C tool's.
"""

import sys

from cornetto_tpu.io.fasta import read_fastx
from cornetto_tpu.tools import sdust as host_sdust
from cornetto_tpu.utils.parsing import c_atoi
from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.kernels.sdust import check_params, sdust_device

CORE = 2048      # chunk core of the device DP (sdust_pallas' default)


def run(fasta_path: str, T: int = 20, W: int = 64, out=None,
        workers: int = None, backend: str = "host",
        stats: dict = None) -> None:
    """backend "device": one sdust_device call per contig with a chunk core
    of CORE, serial over contigs (the chunks are the parallel axis), its
    counts and per-part seconds added to ``stats`` if given (which
    synchronises the card at the end of each part); anything else is the
    shared host path."""
    out = out or sys.stdout
    if backend != "device":
        host_sdust.run(fasta_path, T=T, W=W, out=out, workers=workers)
        return
    dev = resolve_device()
    for rec in read_fastx(fasta_path):
        ivals = sdust_device(rec.seq.encode("latin-1"), T=T, W=W, core=CORE,
                             device=dev, stats=stats)
        if ivals:
            out.write("".join("%s\t%d\t%d\n" % (rec.name, a, b)
                              for a, b in ivals))


def main(argv) -> int:
    W, T = 64, 20
    backend = "host"
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
    if backend == "device":
        try:
            check_params(W, T)
        except ValueError as e:
            sys.stderr.write("Error: %s\n" % e)
            return 1
    run(args[0], T=T, W=W, backend=backend)
    return 0
