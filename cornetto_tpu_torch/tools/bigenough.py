"""bigenough: keep boring-bits rows only on contigs whose boring coverage
exceeds a percentage threshold of the contig length.

Reference behavior: src/bigenough_main.c:92-326.  Note the deliberate
reproduction of the reference's C int arithmetic in the threshold test
``covlen > (end - start) * T / 100`` — the product overflows a 32-bit int for
contigs longer than ~42.9 Mb at T=50 and the golden outputs depend on the
wrapped value (src/bigenough_main.c:206).
"""

import sys
from dataclasses import dataclass
from typing import Optional

from cornetto_tpu_torch.io.bed import read_bed3
from cornetto_tpu_torch.utils import logging as log
from cornetto_tpu_torch.utils.cformat import c_div, wrap_i32


@dataclass
class BigenoughOptions:
    threshold: int = 50
    outreadfish: Optional[str] = None


def run(assbed: str, boringbed: str, opt: BigenoughOptions, out=None) -> None:
    out = out or sys.stdout
    # read_bed_to_hashmap (reference :229-296): start must be 0, no dups
    lens = {}
    asslen = 0
    for ref, beg, end in read_bed3(assbed, "assembly"):
        if beg != 0:
            log.error("start coordinate should be 0 in the assembly "
                      "chromosome bed. Not so at %s. " % assbed)
            sys.exit(1)
        if ref in lens:
            log.error("Contig '%s' is duplicated in %s" % (ref, assbed))
            sys.exit(1)
        lens[ref] = (beg, end)
        asslen += end

    covlen = {k: 0 for k in lens}
    boring_len = 0
    rows = []
    for ref, beg, end in read_bed3(boringbed, "boring"):
        if ref not in lens:
            log.error("Contig '%s' in %s is not found in assembly bed file"
                      % (ref, boringbed))
            sys.exit(1)
        covlen[ref] += end - beg
        boring_len += end - beg
        rows.append((ref, beg, end))

    outfp = open(opt.outreadfish, "w") if opt.outreadfish else None
    panel_len = 0
    for ref, beg, end in rows:
        start, cend = lens[ref]
        # C int arithmetic with wraparound + truncating division
        thresh = c_div(wrap_i32((cend - start) * opt.threshold), 100)
        if covlen[ref] > thresh:
            out.write("%s\t%d\t%d\n" % (ref, beg, end))
            if outfp:
                outfp.write("%s,%d,%d,+\n" % (ref, beg, end))
                outfp.write("%s,%d,%d,-\n" % (ref, beg, end))
            panel_len += end - beg
    if outfp:
        outfp.close()

    import numpy as np
    sys.stderr.write("Total assembly length:\t%d\t%.2f Gbases\n"
                     % (asslen, asslen / 1000000000.0))
    sys.stderr.write("boring bits length before filtering:\t%d\t%.2f Gbases\n"
                     % (boring_len, boring_len / 1000000000.0))
    sys.stderr.write("Final panel length:\t%d\t%.2f Gbases\n"
                     % (panel_len, panel_len / 1000000000.0))
    # the reference prints these two in C float arithmetic
    sys.stderr.write("%% of panel length (over assembly):\t%.2f%%\n"
                     % float(np.float32(panel_len) / np.float32(asslen) * 100))
    sys.stderr.write("%% of panel length (over human genome):\t%.2f%%\n"
                     % float(np.float32(panel_len) / np.float32(3100000000)
                             * 100))


def main(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.utils.parsing import c_atoi
    opt = BigenoughOptions()
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(
            argv, "T:v:r:hV",
            ["verbose=", "help", "version", "threshold=", "readfish="])
    except _getopt.GetoptError as e:
        log.error(str(e))
        return 1
    for flag, val in opts:
        if flag in ("-T", "--threshold"):
            t = c_atoi(val)
            if t < 0 or t > 100:
                log.error("Threshold should be between 0 and 100. "
                          "You entered %d" % t)
                return 1
            opt.threshold = t
        elif flag in ("-r", "--readfish"):
            opt.outreadfish = val
        elif flag in ("-v", "--verbose"):
            log.set_log_level(c_atoi(val))
        elif flag in ("-V", "--version"):
            from cornetto_tpu_torch.version import __version__
            sys.stdout.write("cornetto-tpu %s\n" % __version__)
            return 0
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
    if len(args) != 2 or fp_help is sys.stdout:
        _help(fp_help, opt)
        return 0 if fp_help is sys.stdout else 1
    run(args[0], args[1], opt)
    return 0


def _help(fp, opt: BigenoughOptions):
    fp.write("Usage: cornetto bigenough [options] <assembly.bed> <boring.bed>\n")
    fp.write("   -T INT                     percentage threshold to consider as sufficient boring bits on a contig [%d]\n" % opt.threshold)
    fp.write("   -r FILE                    also output in readfish format to FILE\n")
    fp.write("   -v INT                     verbosity level [%d]\n" % log.get_log_level())
    fp.write("   -h                         help\n")
