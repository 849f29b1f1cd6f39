"""refine: curated-assembly construction across Cornetto iterations
("fisht2t").

Reference behavior: docs/refine.md + shitflow/fisht2t.pbs.sh:90-201 —
walk iterations in order; collect near-complete chromosomes (contigs with
telomeres at BOTH ends, i.e. exactly 2 rows in the telostats ends BED, and
longer than the minimum chromosome size); the first iteration with any such
contigs seeds the running T2T set; later iterations append only "newfound"
T2T contigs whose alignment back to the running set covers <50% of their
length; the final iteration also appends its newfound non-T2T contigs.

Mapping backend: where the reference shells out to minimap2+samtools, this
uses the framework's own minimizer containment (fraction of a contig's
minimizers present in the running-set index) — the same <0.5 threshold.
Precomputed PAFs are also accepted for exact parity with the script's awk
coverage rule.
"""

import os
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.kernels.minimizer import encode_seq, minimizers_np
from cornetto_tpu_torch.utils import logging as log

MIN_CONTIG_LEN = 40_000_000


def t2t_contigs(telo_ends_bed: str) -> List[str]:
    """Contigs with exactly 2 telomere-end windows
    (reference: fisht2t.pbs.sh:143-147)."""
    counts = Counter()
    with open(telo_ends_bed) as fp:
        for line in fp:
            parts = line.split()
            if parts:
                counts[parts[0]] += 1
    return [name for name, c in counts.items() if c == 2]


class _ContainmentIndex:
    """Minimizer-set index of the running T2T set for containment checks."""

    def __init__(self, k: int = 15, w: int = 10):
        self.k = k
        self.w = w
        self._hashes: set = set()

    def add(self, seq: str) -> None:
        _, h = minimizers_np(encode_seq(seq), k=self.k, w=self.w)
        self._hashes.update(h.tolist())

    def containment(self, seq: str) -> float:
        _, h = minimizers_np(encode_seq(seq), k=self.k, w=self.w)
        if len(h) == 0:
            return 0.0
        hits = sum(1 for x in h.tolist() if x in self._hashes)
        return hits / len(h)


def paf_coverage_fractions(paf_path: str) -> Dict[str, float]:
    """Query-span coverage fraction per contig from a PAF, with the
    reference awk rule: sum(qe-qs) over rows / qlen
    (reference: fisht2t.pbs.sh:115)."""
    spans: Dict[str, int] = {}
    qlens: Dict[str, int] = {}
    from cornetto_tpu_torch.io.paf import read_paf_minidot
    for r in read_paf_minidot(paf_path):
        spans[r.qn] = spans.get(r.qn, 0) + (r.qe - r.qs)
        qlens[r.qn] = r.ql
    return {q: spans[q] / qlens[q] for q in spans if qlens[q]}


def run(iterations: List[Tuple[str, str]], output_prefix: str,
        min_contig_len: int = MIN_CONTIG_LEN,
        labels: Optional[List[str]] = None,
        paf_dir: Optional[str] = None, out=None) -> str:
    """iterations: [(assembly.fasta, telo_ends.bed), ...] in protocol order.
    Returns the final curated FASTA path (`<output_prefix>.fasta`)."""
    out = out or sys.stdout
    labels = labels or ["A_%d" % (i + 1) for i in range(len(iterations))]
    t2t_path = output_prefix + ".t2t.fasta"
    nont2t_path = output_prefix + ".nont2t.fasta"
    final_path = output_prefix + ".fasta"
    index = _ContainmentIndex()
    t2t_found = False
    t2t_records: List[Tuple[str, str]] = []
    nont2t_records: List[Tuple[str, str]] = []

    for cur, ((fasta, telo_bed), label) in enumerate(zip(iterations, labels)):
        out.write("Doing %s\n" % label)
        seqs = {rec.name: rec.seq for rec in read_fastx(fasta)}
        t2t_names = [n for n in t2t_contigs(telo_bed)
                     if n in seqs and len(seqs[n]) > min_contig_len]
        paf_fracs = None
        if paf_dir is not None:
            paf = os.path.join(paf_dir, "%s.t2t.paf" % label)
            if os.path.exists(paf):
                paf_fracs = paf_coverage_fractions(paf)

        if t2t_names:
            out.write("    %s has %d T2T\n" % (label, len(t2t_names)))
            for name in t2t_names:
                renamed = "%s_t2t_%s" % (label, name)
                if not t2t_found:
                    newfound = True
                elif paf_fracs is not None:
                    newfound = paf_fracs.get(renamed,
                                             paf_fracs.get(name, 0.0)) < 0.5
                else:
                    newfound = index.containment(seqs[name]) < 0.5
                if newfound:
                    t2t_records.append((renamed, seqs[name]))
                    index.add(seqs[name])
            t2t_found = True
        else:
            out.write("    %s has no T2T\n" % label)

        if cur == len(iterations) - 1:
            out.write("    Last one. Appending none T2T contigs to the "
                      "base asm\n")
            t2t_set = set(t2t_names)
            for name, seq in seqs.items():
                if name in t2t_set:
                    continue
                renamed = "%s_nont2t_%s" % (label, name)
                if index.containment(seq) < 0.5:
                    nont2t_records.append((renamed, seq))

    _write_fasta(t2t_path, t2t_records)
    _write_fasta(nont2t_path, nont2t_records)
    _write_fasta(final_path, t2t_records + nont2t_records)
    return final_path


def _write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(">%s\n%s\n" % (name, seq))


def main(argv) -> int:
    if len(argv) < 3 or len(argv) % 2 == 0:
        sys.stderr.write(
            "Usage: cornetto refine <out_prefix> <asm1.fasta> <telo1.bed> "
            "[<asm2.fasta> <telo2.bed> ...]\n")
        return 1
    prefix = argv[0]
    pairs = [(argv[i], argv[i + 1]) for i in range(1, len(argv), 2)]
    run(pairs, prefix)
    return 0
