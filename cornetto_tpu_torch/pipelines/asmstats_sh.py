"""asmstats pipeline wrapper (reference: scripts/asmstats.sh — precondition
checks then `cornetto asmstats <prefix>.paf <prefix>.windows.0.4.50kb.ends.bed
-r <prefix>.report.tsv`)."""

import os
import sys

from cornetto_tpu_torch.tools import asmstats
from cornetto_tpu_torch.utils import logging as log


def run(prefix: str, out=None) -> int:
    paf = prefix + ".paf"
    bed = prefix + ".windows.0.4.50kb.ends.bed"
    report = prefix + ".report.tsv"
    for p in (paf, bed, report):
        if not os.path.exists(p):
            log.die("File %s not found" % p)
    asmstats.run(paf, bed, report, out=out)
    return 0


def main(argv) -> int:
    if len(argv) != 1:
        sys.stderr.write("Usage: cornetto asmstats-pipeline <prefix>\n")
        return 1
    return run(argv[0])
