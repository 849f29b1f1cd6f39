"""nx: Nx/NGx step-table (reference: src/nx.c:61-158 — two lines per contig,
cumulative %% against total or -g genome size, %f formatting)."""

import sys

from cornetto_tpu_torch.io.fasta import read_fastx


def run(fasta_path: str, genome_size: int = -1, out=None) -> None:
    out = out or sys.stdout
    lengths = [len(rec.seq) for rec in read_fastx(fasta_path)]
    total = sum(lengths)
    lengths.sort()  # ks_mergesort ascending; we then walk from the top
    out.write("#x\tcontig_len\n")
    cumsum = 0
    percent = 0.0
    for ln in reversed(lengths):
        out.write("%f\t%d\n" % (percent, ln))
        cumsum += ln
        denom = genome_size if genome_size > 0 else total
        percent = cumsum / denom * 100
        out.write("%f\t%d\n" % (percent, ln))


def main(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.utils.parsing import parse_num_suffix
    genome_size = -1
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(argv, "g:h",
                                        ["genome-size=", "verbose=", "help"])
    except _getopt.GetoptError:
        return 1
    for flag, val in opts:
        if flag in ("-g", "--genome-size"):
            genome_size = parse_num_suffix(val)
            if genome_size <= 0:
                from cornetto_tpu_torch.utils import logging as log
                log.error("Genome size should be larger than 0.")
                return 1
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 1 or fp_help is sys.stdout:
        fp_help.write("Usage: cornetto nx <assembly.fasta> \n")
        fp_help.write("   -g STR                     genome size (e.g. 3.1G). if unspecified, will use total contig length\n")
        fp_help.write("   -h                         help\n")
        return 0 if fp_help is sys.stdout else 1
    run(args[0], genome_size)
    return 0
