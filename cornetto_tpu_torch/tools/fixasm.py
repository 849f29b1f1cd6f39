"""fixasm: orient, rename and re-map assembly contigs against a reference.

Reference behavior: src/fixasm.c —
- PAF pass 1 (load_paf :226-284): per-contig +/- aligned-base sums and
  per-reference-chromosome hit tallies, chromosome indices assigned in PAF
  first-appearance order;
- FASTA pass (fix_the_assembly :341-416): reverse-complement contigs with
  sump < sumn, rename to `<majority_chr>_<counter>` where majority is the
  tally argmax with LAST-max tie-break (`>=` at :375) and the per-chromosome
  counter increments in FASTA order; writes fixed FASTA to stdout, report
  TSV, missing-contig list;
- PAF pass 2 (write_corrected_paf :287-336): flip strand + mirror query
  coordinates + substitute new names.
"""

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cornetto_tpu_torch.io.fasta import read_fastx, write_fasta_record
from cornetto_tpu_torch.io.paf import read_paf

_RC = str.maketrans("ATGC", "TACG")


def reverse_complement(seq: str) -> str:
    # only A/T/G/C are complemented; other characters (incl. lowercase)
    # pass through unchanged, after reversal (reference :208-224)
    return seq[::-1].translate(_RC)


def cleanup_str(name: str, trim_suffixes: bool) -> str:
    if trim_suffixes:
        for suf in ("_PATERNAL", "_MATERNAL"):
            i = name.find(suf)
            if i >= 0:
                name = name[:i]
    return name


@dataclass
class CtgInfo:
    sump: int = 0
    sumn: int = 0
    tally: Dict[int, int] = field(default_factory=dict)
    new_name: Optional[str] = None


@dataclass
class FixasmResult:
    ctgs: Dict[str, CtgInfo]
    chr_names: List[str]


def load_paf(paffile: str) -> FixasmResult:
    ctgs: Dict[str, CtgInfo] = {}
    chr_index: Dict[str, int] = {}
    chr_names: List[str] = []
    for rec in read_paf(paffile):
        ctg = ctgs.get(rec.rid)
        if ctg is None:
            ctg = ctgs[rec.rid] = CtgInfo()
        if rec.tid not in chr_index:
            chr_index[rec.tid] = len(chr_names)
            chr_names.append(rec.tid)
        length = rec.target_end - rec.target_start
        if rec.strand == 0:
            ctg.sump += length
        else:
            ctg.sumn += length
        ci = chr_index[rec.tid]
        ctg.tally[ci] = ctg.tally.get(ci, 0) + 1
    return FixasmResult(ctgs, chr_names)


def fix_the_assembly(fastafile: str, res: FixasmResult,
                     missing_fn: Optional[str], report_fn: Optional[str],
                     trim_suffixes: bool, out=None, err=None) -> None:
    out = out or sys.stdout
    err = err or sys.stderr
    fp_report = open(report_fn, "w") if report_fn else None
    fp_missing = open(missing_fn, "w") if missing_fn else None
    counters: Dict[int, int] = {}
    missing = total = neg = 0
    for rec in read_fastx(fastafile):
        ctg = res.ctgs.get(rec.name)
        if ctg is None:
            if fp_missing:
                fp_missing.write("%s\n" % rec.name)
            missing += 1
            continue
        seq = rec.seq
        direction = "+"
        if ctg.sump < ctg.sumn:
            seq = reverse_complement(seq)
            direction = "-"
            neg += 1
        # argmax with last-max tie-break over indices 0..max_seen
        max_i, max_v = -1, -1
        tally_size = ctg_tally_size(ctg, res)
        for i in range(tally_size):
            v = ctg.tally.get(i, 0)
            if v >= max_v:
                max_v = v
                max_i = i
        cleaned = cleanup_str(res.chr_names[max_i], trim_suffixes)
        counter = counters.get(max_i, 0)
        ctg.new_name = "%s_%d" % (cleaned, counter)
        if fp_report:
            fp_report.write("%s\t%s\t%s\t%s_%d\n"
                            % (rec.name, cleaned, direction, cleaned, counter))
        write_fasta_record(out, "%s_%d" % (cleaned, counter), seq)
        total += 1
        counters[max_i] = counter + 1
    err.write("total: %d\nnegative: %d\nmissing: %d\n"
              % (total, neg, missing))
    if fp_report:
        fp_report.close()
    if fp_missing:
        fp_missing.close()


def ctg_tally_size(ctg: CtgInfo, res: FixasmResult) -> int:
    """The reference records tally_size = chr_list size at the contig's last
    PAF record (src/fixasm.c:171); equal to max tallied index + 1 ..
    chr_count.  Scanning up to the max tallied index is equivalent because
    untallied slots are zero and the last-max tie-break only advances on
    values >= current max, with all trailing zeros only mattering when ALL
    tallies are zero — impossible (every contig in the map has >= 1 hit)."""
    if not ctg.tally:
        return 0
    return max(ctg.tally) + 1


def write_corrected_paf(out_paf: str, paffile: str,
                        res: FixasmResult) -> None:
    with open(out_paf, "w") as fw:
        for rec in read_paf(paffile):
            ctg = res.ctgs.get(rec.rid)
            if ctg is None:
                sys.stderr.write("Error: contig %s not found in hash table\n"
                                 % rec.rid)
                sys.exit(1)
            newdir = rec.strand
            qs, qe = rec.query_start, rec.query_end
            if ctg.sump < ctg.sumn:
                newdir = 0 if newdir else 1
                qs = rec.qlen - rec.query_end
                qe = rec.qlen - rec.query_start
            fw.write("%s\t%d\t%d\t%d\t%c\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t"
                     "tp:A:%s\n"
                     % (ctg.new_name, rec.qlen, qs, qe,
                        "+" if newdir == 0 else "-", rec.tid, rec.tlen,
                        rec.target_start, rec.target_end, rec.match_len,
                        rec.block_len, rec.mapq, rec.tp))


def run(fastafile: str, paffile: str, missing_fn=None, report_fn=None,
        out_paf=None, trim_suffixes=False, out=None, err=None) -> None:
    res = load_paf(paffile)
    fix_the_assembly(fastafile, res, missing_fn, report_fn, trim_suffixes,
                     out=out, err=err)
    if out_paf:
        write_corrected_paf(out_paf, paffile, res)


def main(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.utils import logging as log
    from cornetto_tpu_torch.utils.parsing import c_atoi
    missing = report = out_paf = None
    trim = False
    try:
        opts, args = _getopt.gnu_getopt(
            argv, "v:r:m:w:h",
            ["verbose=", "help", "missing=", "report=", "trim-pat-mat"])
    except _getopt.GetoptError as e:
        log.error(str(e))
        return 1
    fp_help = sys.stderr
    for flag, val in opts:
        if flag in ("-m", "--missing"):
            missing = val
        elif flag in ("-r", "--report"):
            report = val
        elif flag == "-w":
            out_paf = val
        elif flag in ("-v", "--verbose"):
            log.set_log_level(c_atoi(val))
        elif flag == "--trim-pat-mat":
            trim = True
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 2:
        _help(fp_help)
        return 1
    run(args[0], args[1], missing_fn=missing, report_fn=report,
        out_paf=out_paf, trim_suffixes=trim)
    return 0


def _help(fp):
    fp.write("Usage: cornetto fixasm <assembly.fa> <asm_to_ref.paf>\n")
    fp.write("   -m FILE                    write missing contig names to FILE\n")
    fp.write("   -r FILE                    write report to FILE\n")
    fp.write("   -w FILE                    write fixed PAF to FILE\n")
    fp.write("   -v INT                     verbosity level [%d]\n" % 4)
    fp.write("   -h                         help\n")
