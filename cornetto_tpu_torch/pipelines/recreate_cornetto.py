"""recreate-cornetto: iteration panel (no coverage input).

Reference behavior: scripts/recreate-cornetto.sh — lowQ >= 7.5 kb, the
asymmetric -40k/+50k extension quirk (:36), 200-kb edges, merge/subtract,
<1 Mb contig removal, bigenough.
"""

import os
import sys

from cornetto_tpu_torch.intervals import algebra
from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.pipelines.create_cornetto import _write, contig_edges
from cornetto_tpu_torch.tools import bigenough as bigenough_tool
from cornetto_tpu_torch.utils import logging as log


def run(fasta_path: str, out_dir: str = ".", tmp_dir: str = None) -> int:
    if not os.path.exists(fasta_path):
        log.die("Assembly FASTA not found")
    prefix = os.path.basename(fasta_path)
    for suf in (".fa", ".fasta"):
        if prefix.endswith(suf):
            prefix = prefix[:-len(suf)]
    lowq_path = os.path.join(os.path.dirname(fasta_path) or ".",
                             prefix + ".bp.p_ctg.lowQ.bed")
    tmp = tmp_dir or os.path.join(out_dir, "tmp_recreate_cornetto")
    if os.path.isdir(tmp):
        log.die("Directory %s already exists. Please remove it before "
                "running this script or change to a different working "
                "directory" % tmp)
    os.makedirs(tmp)

    # CHROMBED: fa2bed | sort -k3,3nr
    assbed = algebra.gnu_sort_len_desc(
        [(rec.name, 0, len(rec.seq)) for rec in read_fastx(fasta_path)])
    chroms_path = os.path.join(tmp, prefix + ".chroms.bed")
    _write(chroms_path, assbed)

    #1# lowQ >= 7.5 kb
    lowq = []
    with open(lowq_path) as f:
        for line in f:
            p = line.split("\t")
            if len(p) >= 3 and int(p[2]) - int(p[1]) >= 7500:
                lowq.append((p[0], int(p[1]), int(p[2].rstrip())))
    _write(os.path.join(tmp, "lowQ_tmp.bed"), lowq)

    #2# extend: the reference's awk tests start > 50000 but extends by
    #   -40000/+50000 (scripts/recreate-cornetto.sh:36)
    funbits = []
    for c, s, e in algebra.gnu_sort_bed(lowq):
        if s > 50000:
            funbits.append((c, s - 40000, e + 50000))
        else:
            funbits.append((c, s, e))

    #3# 200-kb edges
    funbits += contig_edges(assbed)
    _write(os.path.join(tmp, "funbits.bed"), funbits)

    #4# sort + merge within 200 kb
    funbits_merged = algebra.merge(algebra.bed_sort(funbits), 200000)
    _write(os.path.join(tmp, "funbits_merged.bed"), funbits_merged)

    #5# subtract from assembly
    boring_tmp = algebra.subtract(assbed, funbits_merged)
    _write(os.path.join(tmp, "boringbits_tmp.bed"), boring_tmp)

    #6# subtract contigs < 1 Mb
    short = [r for r in assbed if r[2] - r[1] < 1000000]
    _write(os.path.join(tmp, "short.bed"), short)
    boring = algebra.subtract(boring_tmp, short)
    _write(os.path.join(tmp, "boringbits.bed"), boring)

    #7# bigenough + readfish targets
    out_bed = os.path.join(out_dir, prefix + ".boringbits.bed")
    out_csv = os.path.join(out_dir, prefix + ".boringbits.txt")
    with open(out_bed, "w") as fbed:
        bopt = bigenough_tool.BigenoughOptions(outreadfish=out_csv)
        bigenough_tool.run(chroms_path, os.path.join(tmp, "boringbits.bed"),
                           bopt, out=fbed)
    return 0


def main(argv) -> int:
    if len(argv) != 1:
        sys.stderr.write("1 argument required, %d provided. Usage: "
                         "cornetto recreate-panel <assembly.fa>\n"
                         % len(argv))
        return 1
    return run(argv[0])
