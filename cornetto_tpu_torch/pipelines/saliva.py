"""Saliva-sample helpers: non-human read/contig handling.

Reference behavior: docs/saliva.md + shitflow/saliva/ — the classifier
itself (centrifuge) stays external; these utilities implement every step
around it: human-read extraction from the classification TSV, the
high-count non-human species selection, non-human contig extraction with
the `_nonhuman` rename, and the full-contig exclusion BED for readfish.
"""

import sys
from collections import defaultdict
from typing import Iterable, List, Optional, Set, Tuple

from cornetto_tpu_torch.io.fasta import read_fastx

HUMAN_TAXID = "9606"


def nonhuman_read_ids(classification_tsv: str) -> Set[str]:
    """readID column of rows whose taxID column != 9606
    (reference: docs/saliva.md `awk '$3!=9606'` on centrifuge -S output:
    readID, seqID, taxID, ...)."""
    out: Set[str] = set()
    with open(classification_tsv) as fp:
        header = fp.readline().split("\t")
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3 and parts[2] != HUMAN_TAXID:
                out.add(parts[0])
    return out


def extract_human_reads(fastq_path: str, classification_tsv: str,
                        out=None) -> Tuple[int, int]:
    """Stream reads whose id was never classified non-human.  Returns
    (kept, dropped)."""
    out = out or sys.stdout
    drop = nonhuman_read_ids(classification_tsv)
    kept = dropped = 0
    for rec in read_fastx(fastq_path):
        if rec.name in drop:
            dropped += 1
            continue
        kept += 1
        hdr = "@%s" % rec.name
        if rec.comment:
            hdr += "\t" + rec.comment
        out.write("%s\n%s\n+\n%s\n" % (hdr, rec.seq, rec.qual or ""))
    return kept, dropped


def high_count_nonhuman_species(report_tsv: str,
                                min_reads: int = 100) -> Set[str]:
    """taxIDs (column 2) of non-human species with >= min_reads (column 5)
    (reference: docs/saliva.md step 1)."""
    out: Set[str] = set()
    with open(report_tsv) as fp:
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5 or parts[1] in ("taxID", HUMAN_TAXID):
                continue
            try:
                if int(float(parts[4])) >= min_reads:
                    out.add(parts[1])
            except ValueError:
                continue
    return out


def extract_nonhuman_contigs(asm_fasta: str, contig_classification_tsv: str,
                             species: Set[str], fasta_out=None,
                             bed_out=None) -> List[str]:
    """Contigs classified to any of `species`, renamed `<name>_nonhuman`,
    written as FASTA plus the full-contig exclusion BED
    (reference: docs/saliva.md steps 3-4)."""
    fasta_out = fasta_out or sys.stdout
    wanted: Set[str] = set()
    with open(contig_classification_tsv) as fp:
        fp.readline()
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3 and parts[2] in species:
                wanted.add(parts[0])
    names = []
    for rec in read_fastx(asm_fasta):
        if rec.name not in wanted:
            continue
        new = rec.name + "_nonhuman"
        names.append(new)
        fasta_out.write(">%s\n%s\n" % (new, rec.seq))
        if bed_out is not None:
            bed_out.write("%s\t0\t%d\n" % (new, len(rec.seq)))
    return names
