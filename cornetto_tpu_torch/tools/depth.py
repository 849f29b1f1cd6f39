"""depth: per-base BAM depth.

The reference's depth subcommand is a dead skeleton (its htslib processing
loop is commented out — reference: src/depth_main.c:162-194, and its -b
region option is parsed but unused via read_bed_regions,
src/misc_p.c:19-79); this is a working implementation producing either
`samtools depth -aa`-style 3-column rows (1-based positions) or the
protocol's awk-converted 1-bp bedgraph (reference:
shitflow/create-launch.pbs.sh:66-67).  With -b, only the listed regions
are computed and printed — served by BAI ranged reads (io.bgzf), so only
the BGZF blocks containing each region are inflated.
"""

import sys

from cornetto_tpu_torch.io.bam import BamFile, depth_arrays, depth_region


def _emit(name: str, d, beg: int, out, bedgraph: bool) -> None:
    """One contig's rows.  Real file objects (incl. stdout) go through the
    native row writer via /proc/self/fd — Python `%`-formatting runs
    ~0.5 us/row, ~25 min for a 3.1 Gbp genome; StringIO and other
    fileno-less sinks fall back to the Python formatter."""
    from cornetto_tpu_torch.native import depth_write as dw
    mode = dw.PER_BASE_BEDGRAPH if bedgraph else dw.SAMTOOLS_DEPTH
    fd = None
    try:
        fd = out.fileno()
    except Exception:
        pass
    if fd is not None and dw._get() is not None:
        out.flush()
        dw.write_rows("/proc/self/fd/%d" % fd, name, d, mode, beg,
                      append=True)
        try:
            if out.seekable():
                out.seek(0, 2)   # realign the stream with the appended rows
        except Exception:
            pass
        return
    if bedgraph:
        out.write("".join("%s\t%d\t%d\t%d\n"
                          % (name, beg + i, beg + i + 1, v)
                          for i, v in enumerate(d)))
    else:
        out.write("".join("%s\t%d\t%d\n" % (name, beg + i + 1, v)
                          for i, v in enumerate(d)))


def run(bam_path: str, min_mapq: int = 0, bedgraph: bool = False,
        include_dels: bool = False, regions=None, out=None) -> None:
    out = out or sys.stdout
    bam = BamFile(bam_path)
    if regions is not None:
        for name, beg, end in regions:
            d = depth_region(bam, name, beg, end, min_mapq=min_mapq,
                             include_dels=include_dels)
            _emit(name, d, beg, out, bedgraph)
        return
    depths = depth_arrays(bam, min_mapq=min_mapq, include_dels=include_dels)
    for name, d in zip(bam.ref_names, depths):
        _emit(name, d, 0, out, bedgraph)


def merge_main(argv) -> int:
    """bammerge: k-way merge of position-sorted BAMs (+ .bai) — the
    `samtools merge && samtools index` step of multi-flowcell runs
    (reference: shitflow/ postcall batch wrappers call samtools; the
    reference binary itself cannot write alignments)."""
    from cornetto_tpu_torch.io.bam import merge_sorted_bams
    noindex = "--no-index" in argv
    args = [a for a in argv if a != "--no-index"]
    if len(args) < 3 or args[0] in ("-h", "--help"):
        fp = sys.stdout if args and args[0] in ("-h", "--help") \
            else sys.stderr
        fp.write("Usage: cornetto bammerge [--no-index] <out.bam> "
                 "<in1.bam> <in2.bam> [...]\n")
        return 0 if fp is sys.stdout else 1
    merge_sorted_bams(args[1:], args[0], build_index=not noindex)
    return 0


def main(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.utils.parsing import c_atoi
    min_mapq = 0
    bedgraph = False
    include_dels = False
    regions = None
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(
            argv, "Q:b:gJh",
            ["min-MQ=", "regions=", "bedgraph", "include-dels", "help"])
    except _getopt.GetoptError:
        return 1
    for flag, val in opts:
        if flag in ("-Q", "--min-MQ"):
            min_mapq = c_atoi(val)
        elif flag in ("-b", "--regions"):
            from cornetto_tpu_torch.io.bed import read_bed3
            regions = list(read_bed3(val))
        elif flag in ("-g", "--bedgraph"):
            bedgraph = True
        elif flag in ("-J", "--include-dels"):
            include_dels = True
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 1 or fp_help is sys.stdout:
        fp_help.write("Usage: cornetto depth [-Q minMQ] [-b regions.bed] "
                      "[-g] [-J] <in.bam>\n")
        fp_help.write("   -Q INT     minimum mapping quality [0]\n")
        fp_help.write("   -b FILE    BED regions: compute depth only there "
                      "(uses the .bai when present)\n")
        fp_help.write("   -g         output 1-bp bedgraph rows instead of "
                      "samtools-depth rows\n")
        fp_help.write("   -J         count deleted (D) reference positions "
                      "as covered\n")
        fp_help.write("   -h         help\n")
        return 0 if fp_help is sys.stdout else 1
    run(args[0], min_mapq=min_mapq, bedgraph=bedgraph,
        include_dels=include_dels, regions=regions)
    return 0
