"""seq: FASTQ length filter (reference: src/seq.c:53-138 — default min
length 30000, preserves comments, prints before/after stats to stderr)."""

import sys

from cornetto_tpu_torch.io.fasta import read_fastx


def run(fastq_path: str, min_len: int = 30000, out=None, err=None) -> None:
    out = out or sys.stdout
    err = err or sys.stderr
    before = after = before_n = after_n = 0
    for rec in read_fastx(fastq_path):
        n = len(rec.seq)
        before += n
        before_n += 1
        if n >= min_len:
            after += n
            after_n += 1
            if rec.comment:
                out.write("@%s\t%s\n" % (rec.name, rec.comment))
            else:
                out.write("@%s\n" % rec.name)
            out.write("%s\n+\n%s\n" % (rec.seq, rec.qual or ""))
    err.write("total reads: %d\t%d bases\t%.2f Gbases\n"
              % (before_n, before, before / 1e9))
    err.write("reads >= %d: %d\t%d bases\t%.2f Gbases\n"
              % (min_len, after_n, after, after / 1e9))


def main(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.utils.parsing import c_atoi
    min_len = 30000
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(argv, "hm:",
                                        ["help", "min-len=", "verbose="])
    except _getopt.GetoptError:
        _help(sys.stderr, min_len)
        return 1
    for flag, val in opts:
        if flag in ("-m", "--min-len"):
            min_len = c_atoi(val)
            if min_len < 0:
                sys.stderr.write("Error: min-len must be a positive integer\n")
                _help(sys.stderr, min_len)
                return 1
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 1 or fp_help is sys.stdout:
        _help(fp_help, min_len)
        return 0 if fp_help is sys.stdout else 1
    run(args[0], min_len)
    return 0


def _help(fp, min_len):
    fp.write("Usage: cornetto seq <reads.fastq> \n")
    fp.write("   -m INT                     min length [%d]\n" % 30000)
    fp.write("   -h                         help\n")
