"""telocontigs: contigs sorted by length desc with telomere counts
(reference: src/telocontigs.c:128-245).  The reference's qsort on glibc is a
stable mergesort, so equal lengths keep FASTA order; reproduced with a
stable sort.  (The reference also keeps hash values pointing into a
realloc'd array — a latent bug for >100 contigs; the intended name->count
semantics are implemented here.)
"""

import sys

from cornetto_tpu_torch.io.bed import read_bed3
from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.utils import logging as log


def run(fasta_path: str, bed_path: str, out=None) -> None:
    out = out or sys.stdout
    names = []
    lens = {}
    ntelo = {}
    for rec in read_fastx(fasta_path):
        if rec.name in lens:
            log.error("Duplicate contig '%s' found in fasta" % rec.name)
            sys.exit(1)
        names.append(rec.name)
        lens[rec.name] = len(rec.seq)
        ntelo[rec.name] = 0
    for ref, beg, end in read_bed3(bed_path, "telo"):
        if ref not in lens:
            log.error("Contig '%s' in bed file not found in fasta" % ref)
            sys.exit(1)
        ntelo[ref] += 1
    order = sorted(names, key=lambda n: -lens[n])  # stable for equal lengths
    out.write("Contig\tLength\tNTelomeres\n")
    for n in order:
        out.write("%s\t%d\t%d\n" % (n, lens[n], ntelo[n]))


def main(argv) -> int:
    import getopt as _getopt
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(argv, "h", ["help", "verbose="])
    except _getopt.GetoptError:
        return 1
    for flag, _ in opts:
        if flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 2 or fp_help is sys.stdout:
        fp_help.write("Usage: cornetto telocontigs <assembly.fasta> <telomere.bed>\n")
        fp_help.write("   -h                         help\n")
        return 0 if fp_help is sys.stdout else 1
    run(args[0], args[1])
    return 0
