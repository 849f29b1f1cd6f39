"""report: one-row-per-assembly summary (reference: src/report.c:58-165 —
Ncontigs, largest, N50, N90 in Mb with %.3f)."""

import sys

from cornetto_tpu_torch.io.fasta import read_fastx


def run(fasta_paths, out=None) -> None:
    out = out or sys.stdout
    out.write("#asm\tNcontigs\tLargestcontig(Mbase)\tN50(Mbase)\tN90(Mbase)\n")
    for path in fasta_paths:
        out.write("%s\t" % path)
        lengths = [len(rec.seq) for rec in read_fastx(path)]
        total = sum(lengths)
        lengths.sort()
        cumsum = 0
        n50 = n90 = 0
        for ln in reversed(lengths):
            cumsum += ln
            if cumsum >= total * 0.5 and n50 == 0:
                n50 = ln
            if cumsum >= total * 0.9 and n90 == 0:
                n90 = ln
        out.write("%d\t%.3f\t%.3f\t%.3f\n"
                  % (len(lengths), lengths[-1] / 1e6, n50 / 1e6, n90 / 1e6))


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
    if len(args) < 1 or fp_help is sys.stdout:
        fp_help.write("Usage: cornetto report <assembly.fasta> ... \n")
        fp_help.write("   -h                         help\n")
        return 0 if fp_help is sys.stdout else 1
    run(args)
    return 0
