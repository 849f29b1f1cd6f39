"""create-panel on the port: counterpart of
cornetto_tpu/pipelines/create_cornetto.py.

The same in-memory replacement of the reference shell pipeline
(reference: scripts/create-cornetto.sh), writing the same
tmp_create_cornetto/ intermediates; the interesting windows come from the
port's ``tools.boringbits.iter_fun_windows`` (the CUDA window-sum kernel on
a card).  The interval algebra, bigenough and the BED helpers below are
copies of the JAX package's host code.
"""

import os
import sys
import time
from typing import List

from cornetto_tpu_torch.intervals import algebra
from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.tools import bigenough as bigenough_tool
from cornetto_tpu_torch.tools.boringbits import (BoringbitsOptions,
                                                 iter_fun_windows)
from cornetto_tpu_torch.utils import logging as log

Row = algebra.Row


def _write(path: str, rows) -> None:
    with open(path, "w") as f:
        for c, s, e in rows:
            f.write("%s\t%d\t%d\n" % (c, s, e))


def extend_funbits(rows: List[Row], minpos: int, ext_left: int,
                   ext_right: int) -> List[Row]:
    """The awk extension with its quirk: rows with start <= minpos are kept
    entirely unextended (reference: scripts/create-cornetto.sh:53,
    scripts/recreate-cornetto.sh:36 — note recreate's asymmetric -40k/+50k)."""
    out = []
    for c, s, e in rows:
        if s > minpos:
            out.append((c, s - ext_left, e + ext_right))
        else:
            out.append((c, s, e))
    return out


def contig_edges(assbed: List[Row], edge: int = 200000) -> List[Row]:
    """200-kb windows at both contig ends for contigs longer than edge
    (reference: scripts/create-cornetto.sh:56)."""
    out = []
    for c, s, e in assbed:
        if e - s > edge:
            out.append((c, 0, edge))
            out.append((c, e - edge, e))
    return out


def _premerged_fun_windows(bgtotal: str, bgmq20: str, opt, raw_path: str):
    """Stream the raw interesting windows to raw_path while pre-merging them
    per contig with algebra.merge's `gap <= 1000` rule.  iter_fun_windows
    yields each contig's windows in ascending-start order, so this followed
    by the global sort+merge of the (small) pre-merged list is exactly
    merge(gnu_sort_bed(raw), 1000)."""
    pre: List[Row] = []
    with open(raw_path, "w") as f1:
        cur = None
        for c, s, e in iter_fun_windows(bgtotal, bgmq20, opt):
            f1.write("%s\t%d\t%d\n" % (c, s, e))
            if cur is not None and c == cur[0] and s <= cur[2] + 1000:
                if e > cur[2]:
                    cur[2] = e
            else:
                if cur is not None:
                    pre.append((cur[0], cur[1], cur[2]))
                cur = [c, s, e]
        if cur is not None:
            pre.append((cur[0], cur[1], cur[2]))
    return pre


def run(fasta_path: str, out_dir: str = ".", tmp_dir: str = None,
        backend: str = "auto", ranged_bedgraph: bool = False,
        low_mem: str = "auto") -> int:
    # ranged_bedgraph: accept run-length coverage tracks (the aligner-free
    # approximate-panel mode of livefish cov) instead of the 1-bp
    # samtools-depth format
    prefix = fasta_path[:-len(".fasta")] if fasta_path.endswith(".fasta") \
        else fasta_path
    bgtotal = prefix + ".cov-total.bg"
    bgmq20 = prefix + ".cov-mq20.bg"
    lowq_path = prefix + ".bp.p_ctg.lowQ.bed"
    for p in (fasta_path, bgtotal, bgmq20, lowq_path):
        if not os.path.exists(p):
            log.die("File %s not found" % p)
    basename = os.path.basename(fasta_path)
    base_prefix = basename[:-len(".fasta")] if basename.endswith(".fasta") \
        else basename
    tmp = tmp_dir or os.path.join(out_dir, "tmp_create_cornetto")
    if os.path.isdir(tmp):
        log.die("Directory %s already exists. Please remove it before "
                "running this script or change to a different working "
                "directory" % tmp)
    os.makedirs(tmp)

    # per-stage wall/RSS markers on stderr, as the JAX pipeline writes them
    # (ru_maxrss is a process-wide monotone peak: "peak so far")
    import resource
    t0 = [time.perf_counter()]

    def _mark(name):
        now = time.perf_counter()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss \
            / 1024.0 / 1024.0
        log.info("panel-stage %s: %.1f s (peak RSS so far %.2f GB)"
                 % (name, now - t0[0], rss))
        t0[0] = now

    assbed = [(rec.name, 0, len(rec.seq)) for rec in read_fastx(fasta_path)]
    _write(os.path.join(tmp, basename + ".bed"), assbed)
    _mark("assembly-bed")

    #1# interesting windows (noboringbits col4 != ".")
    opt = BoringbitsOptions(boring=False, high_cov_thresh=2.5,
                            low_cov_thresh=0.4, low_mq_cov_thresh=0.4,
                            backend=backend, low_mem=low_mem,
                            ranged_bedgraph=ranged_bedgraph)
    step1_pre = _premerged_fun_windows(bgtotal, bgmq20, opt,
                                       os.path.join(tmp, "1_tmp.bed"))
    _mark("fun-windows")

    #2# merge within 1000 bp
    step2 = algebra.merge(algebra.gnu_sort_bed(step1_pre), 1000)
    _write(os.path.join(tmp, "2_tmp.bed"), step2)

    #3# drop merged intervals < 30 kb
    step3 = [r for r in step2 if r[2] - r[1] >= 30000]
    _write(os.path.join(tmp, "3_tmp.bed"), step3)

    #4# hifiasm lowQ regions >= 8 kb
    lowq = []
    with open(lowq_path) as f:
        for line in f:
            p = line.split("\t")
            if len(p) >= 3 and int(p[2]) - int(p[1]) >= 8000:
                lowq.append((p[0], int(p[1]), int(p[2].rstrip())))
    _write(os.path.join(tmp, "lowQ_tmp.bed"), lowq)

    #5# combine + extend by 40 kb
    funbits = extend_funbits(algebra.gnu_sort_bed(step3 + lowq),
                             40000, 40000, 40000)

    #6# 200-kb contig-edge windows
    funbits += contig_edges(assbed)
    _write(os.path.join(tmp, "funbits.bed"), funbits)

    #7# sort + merge within 200 kb
    funbits_merged = algebra.merge(algebra.bed_sort(funbits), 200000)
    _write(os.path.join(tmp, "funbits_merged.bed"), funbits_merged)

    #8# subtract from the assembly
    boring_tmp = algebra.subtract(assbed, funbits_merged)
    _write(os.path.join(tmp, "boringbits_tmp.bed"), boring_tmp)

    #9# subtract contigs shorter than 800 kb
    short = [r for r in assbed if r[2] - r[1] < 800000]
    _write(os.path.join(tmp, "short.bed"), short)
    boring = algebra.subtract(boring_tmp, short)
    _write(os.path.join(tmp, "boringbits.bed"), boring)
    _mark("interval-chain")

    #10# bigenough + readfish targets
    out_bed = os.path.join(out_dir, base_prefix + ".boringbits.bed")
    out_csv = os.path.join(out_dir, base_prefix + ".boringbits.txt")
    with open(out_bed, "w") as fbed:
        bopt = bigenough_tool.BigenoughOptions(outreadfish=out_csv)
        bigenough_tool.run(os.path.join(tmp, basename + ".bed"),
                           os.path.join(tmp, "boringbits.bed"), bopt,
                           out=fbed)
    _mark("bigenough")
    return 0


def main(argv) -> int:
    backend = "auto"
    low_mem = "auto"
    ranged = False
    args = []
    for a in argv:
        if a.startswith("--backend="):
            backend = a.split("=", 1)[1]
        elif a == "--low-mem":
            # force the two-pass streaming fun-windows scan (peak RSS =
            # largest contig instead of both whole-genome tracks)
            low_mem = "yes"
        elif a == "--ranged-bedgraph":
            # aligner-free approx-panel mode: coverage tracks produced by
            # `cornetto livefish cov` instead of minimap2+samtools depth
            ranged = True
        else:
            args.append(a)
    if len(args) != 1:
        sys.stderr.write("1 argument required, %d provided. Usage: "
                         "cornetto create-panel <assembly.fa> "
                         "[--ranged-bedgraph]\n" % len(args))
        return 1
    return run(args[0], backend=backend, ranged_bedgraph=ranged,
               low_mem=low_mem)
