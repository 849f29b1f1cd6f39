"""fa2bed: FASTA -> `name 0 length` BED (reference: src/assbed.c:50-106)."""

import sys

from cornetto_tpu_torch.io.fasta import read_fastx


def run(fasta_path: str, out=None) -> None:
    out = out or sys.stdout
    for rec in read_fastx(fasta_path):
        out.write("%s\t%d\t%d\n" % (rec.name, 0, len(rec.seq)))


def main(argv) -> int:
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        fp = sys.stdout if argv and argv[0] in ("-h", "--help") else sys.stderr
        fp.write("Usage: cornetto asmbed <assembly.fasta> \n")
        fp.write("   -h                         help\n")
        return 0 if fp is sys.stdout else 1
    run(argv[0])
    return 0
