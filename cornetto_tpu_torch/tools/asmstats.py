"""asmstats: assembly evaluation tables.

Reference behavior: src/asmstats.c — loads a telomere-ends BED, a fixasm
report and an asm->ref PAF into contig/chromosome maps, then prints four
tables (telo table, majority-correct coverage, LX, majority-wrong).  The
telo table's per-chromosome contig lists follow the contig hash's khash
iteration order (reference :430-457), reproduced via utils.khash.KHashStr.
"""

import sys
from dataclasses import dataclass, field
from typing import List, Optional

from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.io.paf import PafRec, read_paf
from cornetto_tpu_torch.utils import logging as log
from cornetto_tpu_torch.utils.khash import KHashStr
from cornetto_tpu_torch.utils.natsort import strnum_key

HUMAN_CHR_1 = ["chr%s" % c for c in
               [*(str(i) for i in range(1, 23)), "X", "Y"]]

HUMAN_CHR_2 = []
for _i in [*(str(i) for i in range(1, 23))]:
    HUMAN_CHR_2 += ["chr%s_MATERNAL" % _i, "chr%s_PATERNAL" % _i]
HUMAN_CHR_2 += ["chrX_MATERNAL", "chrY_PATERNAL"]


@dataclass
class AsCtg:
    paf_recs: List[PafRec] = field(default_factory=list)
    len: int = 0
    ntelo: int = 0
    mapped_chr: Optional[str] = None


@dataclass
class AsChr:
    len: int = 0


def trim_mat_pat(chr: str) -> str:
    for suf in ("_PATERNAL", "_MATERNAL"):
        i = chr.find(suf)
        if i >= 0:
            chr = chr[:i]
    return chr


def load_telobed(h_ctg: KHashStr, bedfile: str) -> None:
    from cornetto_tpu_torch.io.bed import read_bed3
    for ref, beg, end in read_bed3(bedfile, "telo"):
        ctg = h_ctg.get(ref)
        if ctg is None:
            ctg = AsCtg()
            ctg.ntelo += 1
            h_ctg[ref] = ctg
        else:
            ctg.ntelo += 1


def load_fixasm_report(h_ctg: KHashStr, h_chr: KHashStr,
                       reportfile: str) -> None:
    with open(reportfile) as fp:
        for line_no, line in enumerate(fp):
            parts = line.split()
            if len(parts) < 2:
                log.error("Malformed report entry at line %d. Expected "
                          "format: <ctg>\t<chr>" % line_no)
                sys.exit(1)
            ctg_name, chr_name = parts[0], parts[1]
            ctg = h_ctg.get(ctg_name)
            if ctg is None:
                ctg = AsCtg()
                ctg.mapped_chr = chr_name
                h_ctg[ctg_name] = ctg
            else:
                ctg.mapped_chr = chr_name
            if chr_name not in h_chr:
                h_chr[chr_name] = AsChr()


def load_paf(paffile: str, h_ctg: KHashStr, h_chr: KHashStr,
             trim: bool) -> None:
    for rec in read_paf(paffile):
        if trim:
            rec.tid = trim_mat_pat(rec.tid)
        ctg = h_ctg.get(rec.rid)
        if ctg is None:
            log.warning("Contig '%s' in PAF file was not there in the tsv "
                        "report or the telomere bed" % rec.rid)
            continue
        if ctg.len == 0:
            ctg.len = rec.qlen
        elif ctg.len != rec.qlen:
            log.error("Contig '%s' has inconsistent lengths in PAF file"
                      % rec.rid)
            sys.exit(1)
        ctg.paf_recs.append(rec)
        chrm = h_chr.get(rec.tid)
        if chrm is not None:
            if chrm.len == 0:
                chrm.len = rec.tlen
            elif chrm.len != rec.tlen:
                log.error("Chromosome '%s' has inconsistent lengths in PAF "
                          "file" % rec.tid)
                sys.exit(1)
        else:
            log.warning("Chromosome '%s' in PAF file was not there in the "
                        "tsv report or the telomere bed" % rec.tid)


def telo_table(h_chr: KHashStr, h_ctg: KHashStr, chr_list, out) -> None:
    out.write("chr\tT2T?\tNTelo\tTelocontiglen\n")
    for chr_name in chr_list:
        total_telo = 0
        t2t = []
        lens = []
        for _, ctg in h_ctg.items():  # khash iteration order
            if ctg.mapped_chr == chr_name and ctg.ntelo > 0:
                t2t.append("y" if ctg.ntelo == 2 else "n")
                lens.append(ctg.len)
                total_telo += ctg.ntelo
        out.write("%s\t" % chr_name)
        if t2t:
            out.write("".join("%s," % c for c in t2t))
            out.write("\t%d\t" % total_telo)
            out.write("".join("%d," % x for x in lens))
        else:
            out.write("\t\t")
        out.write("\n")


def _process_chr(h_ctg: KHashStr, chr_name: str, length: int, invert: bool,
                 out) -> None:
    c = [0] * 5
    s = [0] * 5
    cuts = [1, 100000, 1000000, 5000000, 10000000]
    for _, ctg in h_ctg.items():
        if ctg.mapped_chr is None:
            continue
        match = (ctg.mapped_chr == chr_name)
        if invert == match:
            continue
        if not ctg.paf_recs:
            continue
        ta = sum(r.target_end - r.target_start for r in ctg.paf_recs
                 if r.tid == chr_name)
        for k, cut in enumerate(cuts):
            if ta >= cut:
                c[k] += 1
                s[k] += ta
    out.write("%s\t%d\t%d\t%d\t%d\t%d\t" % (chr_name, *c))
    out.write("%.3f\t%.3f\t%.3f\t%.3f\t%.3f\n"
              % tuple(x / length * 100 for x in s))


def _process_lx_chr(h_ctg: KHashStr, chr_name: str, length: int, out) -> None:
    aln_lens = []
    for _, ctg in h_ctg.items():
        if ctg.mapped_chr != chr_name or not ctg.paf_recs:
            continue
        ta = sum(r.target_end - r.target_start for r in ctg.paf_recs
                 if r.tid == chr_name)
        aln_lens.append(ta)
    aln_lens.sort()
    l = [0, 0, 0, 0]
    fracs = [0.50, 0.90, 0.95, 0.99]
    cum = [0] * 5
    total = 0
    n = len(aln_lens)
    for i in range(n):
        v = aln_lens[n - i - 1]
        total += v
        for k, f in enumerate(fracs):
            if total >= length * f and l[k] == 0:
                l[k] = i + 1
        for k in range(5):
            if i < k + 1:
                cum[k] += v
    out.write("%s\t%d\t%d\t%d\t%d\t" % (chr_name, *l))
    out.write("%.3f,%.3f,%.3f,%.3f,%.3f\n"
              % tuple(x / length * 100 for x in cum))


def _majority_common(h_chr: KHashStr, h_ctg: KHashStr, chr_list, invert,
                     lx, out) -> None:
    for chr_name in chr_list:
        chrm = h_chr.get(chr_name)
        if chrm is not None:
            if chrm.len == 0:
                log.error("Failed to get chromosome %s length from hash "
                          "table. Check your input files." % chr_name)
                sys.exit(1)
            if lx:
                _process_lx_chr(h_ctg, chr_name, chrm.len, out)
            else:
                _process_chr(h_ctg, chr_name, chrm.len, invert, out)
        else:
            log.warning("Failed to get chromosome %s from hash table. "
                        "Ignoring." % chr_name)
            out.write("%s\n" % chr_name)


def run(paf: str, bed: str, report: str, order: Optional[str] = None,
        trim: bool = False, out=None) -> None:
    out = out or sys.stdout
    h_ctg = KHashStr()
    h_chr = KHashStr()
    load_telobed(h_ctg, bed)
    load_fixasm_report(h_ctg, h_chr, report)
    load_paf(paf, h_ctg, h_chr, trim)

    if order is None:
        chr_list = sorted(h_chr.keys_in_order(), key=strnum_key)
    elif order == "human1":
        chr_list = HUMAN_CHR_1
    elif order == "human2":
        chr_list = HUMAN_CHR_2
    else:
        log.info("Unknown order: %s. Options are: [human1, human2]. "
                 "Assuming %s is a reference file" % (order, order))
        chr_list = [rec.name for rec in read_fastx(order)]

    out.write("%s\n\n" % paf)
    telo_table(h_chr, h_ctg, chr_list, out)

    out.write("\n\n")
    out.write("Contigs whose majority is mapped to the corresponding "
              "chromosome\n")
    out.write("\tNcontigsofsize>=KMbasealignedtochr\t\t\t\t\t"
              "%ofchrsequencecoveredbycontigsofsize>=KMbase\n")
    out.write("chr\t0Mbase\t0.1Mbase\t1Mbase\t5Mbase\t10Mbase\t0Mbase\t"
              "0.1Mbase\t1Mbase\t5Mbase\t10Mbase\n")
    _majority_common(h_chr, h_ctg, chr_list, False, False, out)

    out.write("\n\n")
    out.write("LX of Contigs whose majority is mapped to the corresponding "
              "chromosome\n")
    out.write("\tL50\tL90\tL95\tL99\tCumCovN5\n")
    _majority_common(h_chr, h_ctg, chr_list, False, True, out)

    out.write("\n\n")
    out.write("Contigs whose majority is mapped to another chromosome\n")
    out.write("\tNcontigsofsize>=KMbasealignedtochr\t\t\t\t\t"
              "%ofchrsequencecoveredbycontigsofsize>=KMbase\n")
    out.write("chr\t0Mbase\t0.1Mbase\t1Mbase\t5Mbase\t10Mbase\t0Mbase\t"
              "0.1Mbase\t1Mbase\t5Mbase\t10Mbase\n")
    _majority_common(h_chr, h_ctg, chr_list, True, False, out)


def main(argv) -> int:
    import getopt as _getopt
    report = None
    order = None
    trim = False
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(
            argv, "r:s:h",
            ["report=", "sort-order=", "trim-pat-mat", "verbose=", "help"])
    except _getopt.GetoptError:
        return 1
    for flag, val in opts:
        if flag in ("-r", "--report"):
            report = val
        elif flag in ("-s", "--sort-order"):
            order = val
        elif flag == "--trim-pat-mat":
            trim = True
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 2 or fp_help is sys.stdout or report is None:
        _help(fp_help)
        return 0 if fp_help is sys.stdout else 1
    run(args[0], args[1], report, order=order, trim=trim)
    return 0


def _help(fp):
    fp.write("Usage: cornetto asmstats <asm2ref.paf> <telomere.bed> -r "
             "<fixasm.report.tsv>\n")
    fp.write("   -r FILE                    report file generated from fixasm\n")
    fp.write("   -s STR                     use the sort order specified by STR when printing the chromosome report (human1 for haploid human, human2 for diploid human or ref.fasta)\n")
    fp.write("   -v INT                     verbosity level [%d]\n" % 4)
    fp.write("   -h                         help\n")
