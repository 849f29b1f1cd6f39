"""File formats of the port: FASTA/FASTQ, BED and bedgraph, BGZF, BAM and
readfish configs (copies of ``cornetto_tpu.io`` that the port uses)."""

from cornetto_tpu_torch.io.fasta import FastxRecord, read_fastx, open_maybe_gzip
from cornetto_tpu_torch.io.bed import read_bed3, write_bed3, read_bedgraph_pair
from cornetto_tpu_torch.io.paf import PafRec, parse_paf_line, read_paf
