"""create-hapnetto / recreate-hapnetto: diploid-aware panel generation.

Reference behavior: scripts/create-hapnetto.sh / recreate-hapnetto.sh —
align hap1/hap2 assemblies to the primary; per haplotype, merge target-space
hits within 1 Mb per hap contig, take uncovered gaps plus 500-bp hap-contig
corner flanks as extra funbits; union hap1∪hap2; then re-run the create
steps 5-10 with the extra funbits to emit `<asm>_dip.boringbits.{bed,txt}`.

The hap alignments can be precomputed PAFs (``hap1_paf``/``hap2_paf``) or
produced by external minimap2.
"""

import os
import shutil
import subprocess
import sys
from typing import List

from cornetto_tpu_torch.intervals import algebra
from cornetto_tpu_torch.pipelines.create_cornetto import (_write, contig_edges,
                                                    extend_funbits)
from cornetto_tpu_torch.tools import bigenough as bigenough_tool
from cornetto_tpu_torch.utils import logging as log

Row = algebra.Row


def _hap_txt_rows(paf_path: str) -> List[List[str]]:
    """`cut -f 1-10 <paf> | sort -k7,7nr -nk8,8`: first 10 PAF columns,
    col7 (target length) numeric desc, col8 (target start) numeric asc,
    GNU sort's last-resort whole-line byte compare on ties
    (reference: scripts/create-hapnetto.sh:44)."""
    rows = []
    with open(paf_path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")[:10]
            rows.append(p)
    def key(p):
        line = ("\t".join(p) + "\n").encode()
        return (-int(p[6]), int(p[7]), line)
    rows.sort(key=key)
    return rows


def hap_funbits(paf_path: str, assbed: List[Row], tmp: str = None,
                hap: str = None) -> List[Row]:
    """Per-hap funbits: target-space gaps not covered by hap contigs plus
    500-bp flanks around hap-contig projection corners
    (reference: scripts/create-hapnetto.sh:40-62).  When ``tmp``/``hap`` are
    given, also writes the reference's intermediate files (hapX.txt,
    hapX_tmp.bed, hapX_tmp2.bed) byte-identically."""
    txt_rows = _hap_txt_rows(paf_path)
    if tmp:
        with open(os.path.join(tmp, hap + ".txt"), "w") as f:
            for p in txt_rows:
                f.write("\t".join(p) + "\n")
    # group hits per hap contig (in hapX.txt order, like the awk filter);
    # per contig merge (target, ts, te) within 1 Mb
    per_ctg = {}
    for p in txt_rows:
        per_ctg.setdefault(p[0], []).append((p[5], int(p[7]), int(p[8])))
    hap_tmp: List[Row] = []
    for ctg in sorted(per_ctg):  # `sort -u` order over contig names
        rows = algebra.bed_sort(per_ctg[ctg])
        hap_tmp.extend(algebra.merge(rows, 1000000))
    if tmp:
        _write(os.path.join(tmp, hap + "_tmp.bed"), hap_tmp)
    # fun1: uncovered gaps on the primary
    fun = algebra.subtract(assbed, hap_tmp)
    # fun2: 500-bp corner flanks
    for c, s, e in hap_tmp:
        if s >= 500:
            fun.append((c, s - 500, s + 500))
        if e >= 500:
            fun.append((c, e - 500, e + 500))
    if tmp:
        _write(os.path.join(tmp, hap + "_tmp2.bed"), fun)
    return algebra.merge(algebra.bed_sort(fun), 0)


def run(ass_name: str, hap1_paf: str = None, hap2_paf: str = None,
        out_dir: str = ".", prev_tmp: str = None, recreate: bool = False
        ) -> int:
    fasta = ass_name + ".fasta"
    tmp_prev = prev_tmp or os.path.join(
        out_dir, "tmp_recreate_cornetto" if recreate else
        "tmp_create_cornetto")
    tmp = os.path.join(out_dir, "tmp_%s_hapnetto"
                       % ("recreate" if recreate else "create"))
    if not os.path.isdir(tmp_prev):
        log.die("Directory %s not found. Did you run create cornetto under "
                "the current directory?" % tmp_prev)
    os.makedirs(tmp, exist_ok=True)

    assbed_path = os.path.join(tmp_prev, os.path.basename(fasta) + ".bed")
    if recreate:
        # recreate flow keys artifacts on the chroms bed
        assbed_path = os.path.join(
            tmp_prev, os.path.basename(ass_name) + ".chroms.bed")
    assbed = [(c, s, e) for c, s, e in _read_bed(assbed_path)]

    # hap alignment PAFs
    for hap, paf in (("hap1", hap1_paf), ("hap2", hap2_paf)):
        if paf is None:
            mm2 = os.environ.get("MINIMAP2", "minimap2")
            if shutil.which(mm2) is None:
                log.die("minimap2 not found; pass --hap1-paf/--hap2-paf")
            paf = os.path.join(tmp, "%s_%s_to_asm.paf"
                               % (os.path.basename(ass_name), hap))
            with open(paf, "w") as f:
                subprocess.run([mm2, "-t16", "--eqx", "-cx", "asm5", fasta,
                                "%s.%s.fasta" % (ass_name, hap)],
                               stdout=f, check=True)
        if hap == "hap1":
            hap1_paf = paf
        else:
            hap2_paf = paf

    # keep the alignment artifacts under tmp like the reference
    # (reference: scripts/create-hapnetto.sh:36-37)
    base = os.path.basename(ass_name)
    for hap, paf in (("hap1", hap1_paf), ("hap2", hap2_paf)):
        dst = os.path.join(tmp, "%s_%s_to_asm.paf" % (base, hap))
        if os.path.abspath(paf) != os.path.abspath(dst):
            shutil.copyfile(paf, dst)

    f1 = hap_funbits(hap1_paf, assbed, tmp=tmp, hap="hap1")
    _write(os.path.join(tmp, "hap1_funbits.bed"), f1)
    f2 = hap_funbits(hap2_paf, assbed, tmp=tmp, hap="hap2")
    _write(os.path.join(tmp, "hap2_funbits.bed"), f2)
    hap_union = algebra.merge(algebra.bed_sort(f1 + f2), 0)
    _write(os.path.join(tmp, "hap1_hap2_funbits.bed"), hap_union)

    # steps 5-10 of create with the extra funbits
    step3 = list(_read_bed(os.path.join(tmp_prev, "3_tmp.bed"))) \
        if not recreate else []
    lowq = list(_read_bed(os.path.join(tmp_prev, "lowQ_tmp.bed")))
    funbits = extend_funbits(algebra.gnu_sort_bed(step3 + lowq + hap_union),
                             40000, 40000, 40000)
    funbits += contig_edges(assbed)
    _write(os.path.join(tmp, "funbits.bed"), funbits)
    funbits_merged = algebra.merge(algebra.bed_sort(funbits), 200000)
    _write(os.path.join(tmp, "funbits_merged.bed"), funbits_merged)
    boring_tmp = algebra.subtract(assbed, funbits_merged)
    _write(os.path.join(tmp, "boringbits_tmp.bed"), boring_tmp)
    # NB: 800 kb in BOTH hapnetto variants (recreate-cornetto itself uses
    # 1 Mb; reference: scripts/recreate-hapnetto.sh:89 vs recreate-cornetto.sh:48)
    short = [r for r in assbed if r[2] - r[1] < 800000]
    _write(os.path.join(tmp, "short.bed"), short)
    boring = algebra.subtract(boring_tmp, short)
    _write(os.path.join(tmp, "boringbits.bed"), boring)

    out_bed = os.path.join(out_dir, base + "_dip.boringbits.bed")
    out_csv = os.path.join(out_dir, base + "_dip.boringbits.txt")
    with open(out_bed, "w") as fbed:
        bopt = bigenough_tool.BigenoughOptions(outreadfish=out_csv)
        bigenough_tool.run(assbed_path, os.path.join(tmp, "boringbits.bed"),
                           bopt, out=fbed)
    return 0


def _read_bed(path: str):
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 3:
                yield (p[0], int(p[1]), int(p[2]))


def main(argv) -> int:
    kw = {}
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--hap1-paf":
            kw["hap1_paf"] = argv[i + 1]; i += 2
        elif a == "--hap2-paf":
            kw["hap2_paf"] = argv[i + 1]; i += 2
        elif a == "--recreate":
            kw["recreate"] = True; i += 1
        else:
            args.append(a); i += 1
    if len(args) != 1:
        sys.stderr.write("Usage: cornetto hapnetto <assembly prefix> "
                         "[--hap1-paf f] [--hap2-paf f] [--recreate]\n")
        return 1
    return run(args[0], **kw)
