"""telostats: telomere statistics pipeline.

Reference behavior: scripts/telostats.sh — telofind -> telowin 99.9 0.4 ->
merge -d 100 -> intersect with 50-kb contig-end windows ->
<prefix>.windows.0.4.50kb.ends.bed + stdout histogram of contigs with
1/2/>2 telomeres.
"""

import os
import sys
from collections import Counter

from cornetto_tpu_torch.intervals import algebra
from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.tools import telofind, telowin
from cornetto_tpu_torch.utils import logging as log

THRESHOLD = 0.4
ENDS = 50000


def run(fasta_path: str, out_dir: str = ".", tmp_dir: str = None,
        out=None) -> str:
    """Returns the path of the produced .windows BED."""
    out = out or sys.stdout
    if not os.path.exists(fasta_path):
        log.die("File %s not found" % fasta_path)
    prefix = os.path.basename(fasta_path)
    for suf in (".fa", ".fasta"):
        if prefix.endswith(suf):
            prefix = prefix[:-len(suf)]
    tmp = tmp_dir or os.path.join(out_dir, "tmp_%s_telostats" % prefix)
    os.makedirs(tmp, exist_ok=True)
    bed_path = os.path.join(out_dir,
                            "%s.windows.%g.%dkb.ends.bed"
                            % (prefix, THRESHOLD, ENDS // 1000))

    out.write("genome: %s\n" % prefix)
    out.write("THRESHOLD: %s\n" % THRESHOLD)
    out.write("ends: %d\n" % ENDS)
    out.write("asm: %s\n" % fasta_path)

    # telofind -> 6-col telomere file
    telomere_path = os.path.join(tmp, prefix + ".telomere")
    with open(telomere_path, "w") as f:
        telofind.run(fasta_path, out=f)

    # lens
    lens = [(rec.name, len(rec.seq)) for rec in read_fastx(fasta_path)]
    lens_path = os.path.join(tmp, prefix + ".lens")
    with open(lens_path, "w") as f:
        for n, l in lens:
            f.write("%s\t%d\n" % (n, l))

    # telowin
    win_path = os.path.join(tmp, "%s.windows.%g" % (prefix, THRESHOLD))
    with open(win_path, "w") as f:
        telowin.run(telomere_path, 99.9, THRESHOLD, out=f)

    out.write("Merge telomere motifs in 100bp\n")
    win_rows = []
    with open(win_path) as f:
        for line in f:
            p = line.split()
            # awk '{print $2"\t"$(NF-2)"\t"$(NF-1)}'
            win_rows.append((p[1], int(p[-3]), int(p[-2])))
    merged = algebra.merge(win_rows, 100)
    merged_path = os.path.join(tmp, "%s.windows.%g.bed" % (prefix, THRESHOLD))
    with open(merged_path, "w") as f:
        for c, s, e in merged:
            f.write("%s\t%d\t%d\n" % (c, s, e))
    out.write("\n")

    out.write("Find those at end of scaffolds, within < %d\n" % ENDS)
    ends_rows = []
    for n, l in lens:
        if l > ENDS * 2:
            ends_rows.append((n, 0, ENDS))
            ends_rows.append((n, l - ENDS, l))
        else:
            ends_rows.append((n, 0, l))
    with open(os.path.join(tmp, "asm.ends.bed"), "w") as f:
        for c, s, e in ends_rows:
            f.write("%s\t%d\t%d\n" % (c, s, e))

    hits = algebra.intersect_wa(merged, ends_rows)
    with open(bed_path, "w") as f:
        for c, s, e in hits:
            f.write("%s\t%d\t%d\n" % (c, s, e))

    out.write("FILE\t%s\n" % fasta_path)
    out.write("total telomere regions at the end of contigs:\t")
    out.write("%d\n" % len(hits))
    out.write("\n\n")
    counts = Counter(c for c, _, _ in hits)
    t1 = sum(1 for v in counts.values() if v == 1)
    t2 = sum(1 for v in counts.values() if v == 2)
    t3 = sum(1 for v in counts.values() if v > 2)
    out.write("contigs with 1 telo:\t%d\ncontigs with 2 telo:\t%d\n"
              "contigs with more than 2 telo:\t%d\n\n" % (t1, t2, t3))
    return bed_path


def main(argv) -> int:
    if len(argv) != 1:
        sys.stderr.write("Usage: cornetto telostats <assembly.fasta>\n")
        return 1
    run(argv[0])
    return 0
