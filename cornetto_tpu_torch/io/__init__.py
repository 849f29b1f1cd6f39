"""File formats of the port: FASTA/FASTQ, BED and bedgraph, BGZF, BAM and
readfish configs (copies of ``cornetto_tpu.io`` that the port uses)."""
