"""GFA assembly-graph reading: the native replacement for the
`gfatools gfa2fa` stages of the assembly job (reference:
shitflow/hifiasm-ont.pbs.sh:82-85 converts hifiasm's .bp.p_ctg.gfa /
hap1 / hap2 graphs to FASTA)."""

import sys
from typing import Iterator, Tuple


def iter_segments(path: str) -> Iterator[Tuple[str, str]]:
    """Yields (name, sequence) for every S line of a GFA 1.x file."""
    with open(path) as f:
        for line in f:
            if line.startswith("S\t"):
                p = line.rstrip("\n").split("\t")
                if len(p) >= 3 and p[2] != "*":
                    yield p[1], p[2]


def gfa2fa(gfa_path: str, out=None) -> int:
    """`gfatools gfa2fa` equivalent: one FASTA record per S line,
    sequence on a single line.  Returns the segment count."""
    out = out or sys.stdout
    n = 0
    for name, seq in iter_segments(gfa_path):
        out.write(">%s\n%s\n" % (name, seq))
        n += 1
    return n


def main(argv) -> int:
    if len(argv) != 1:
        sys.stderr.write("Usage: cornetto gfa2fa <graph.gfa>\n")
        return 1
    gfa2fa(argv[0])
    return 0
