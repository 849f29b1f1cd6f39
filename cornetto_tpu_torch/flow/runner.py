"""flow on the port: counterpart of cornetto_tpu/flow/runner.py.

``iteration_flow`` builds the JAX package's iteration DAG (the same steps,
names, outputs, ordering and resume-on-artifacts state) and swaps in the
port's device steps: ``depth`` in aligner-free mode (the port's
``livefish cov`` tally) and ``panel`` (the port's create-panel).  ``align``,
the BAM ``depth`` step, ``telostats`` and ``livefish-index`` are host code
and run as the JAX package defines them.
"""

import json
import os
import shutil
import sys
from typing import Dict, Optional

from cornetto_tpu.flow import runner as _host
from cornetto_tpu.flow.runner import Flow, FlowContext

__all__ = ["Flow", "FlowContext", "iteration_flow", "main"]


def _prefix(fasta: str) -> str:
    prefix = os.path.basename(fasta)
    for suf in (".fa", ".fasta"):
        if prefix.endswith(suf):
            prefix = prefix[:-len(suf)]
    return prefix


def _cov_tracks(ctx: FlowContext, fasta: str, reads_fastq: str,
                config: Dict) -> None:
    # aligner-free: coverage estimated from livefish index hits while
    # deciding — replaces minimap2 realign + samtools depth entirely
    # (reference: shitflow/create-launch.pbs.sh:61-67)
    import numpy as np
    from cornetto_tpu.io.fasta import read_fastx
    from cornetto_tpu.livefish.index import build_index
    from cornetto_tpu_torch.livefish.coverage import (CoverageParams,
                                                      CoverageTally,
                                                      stream_coverage)
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    prefix = _prefix(fasta)
    contigs = {r.name: r.seq for r in read_fastx(fasta)}
    idx = build_index(contigs)
    eng = SingleChipEngine(
        idx, np.zeros((len(idx.contig_names), 128), dtype=bool))
    tally = CoverageTally(idx, CoverageParams(
        bin_size=int(config.get("cov_bin_size", 1000))))
    stream_coverage(eng, tally, reads_fastq,
                    batch=int(config.get("cov_batch", 4096)),
                    read_len=int(config.get("read_len", 450)))
    tally.write_bedgraphs(ctx.path(prefix + ".cov-total.bg"),
                          ctx.path(prefix + ".cov-mq20.bg"))


def _panel(ctx: FlowContext, fasta: str, aligner_free: bool) -> None:
    from cornetto_tpu_torch.pipelines import create_cornetto
    prefix = _prefix(fasta)
    for suffix in (".cov-total.bg", ".cov-mq20.bg", ".bp.p_ctg.lowQ.bed"):
        src = os.path.splitext(fasta)[0] + suffix
        dst = ctx.path(prefix + suffix)
        if not os.path.exists(dst) and os.path.exists(src):
            shutil.copy(src, dst)
    dst_fa = ctx.path(prefix + ".fasta")
    if not os.path.exists(dst_fa):
        shutil.copy(fasta, dst_fa)
    create_cornetto.run(dst_fa, out_dir=ctx.workdir,
                        tmp_dir=ctx.path("tmp_create_cornetto"),
                        ranged_bedgraph=aligner_free)


def iteration_flow(workdir: str, fasta: str, reads_fastq: str,
                   config: Optional[Dict] = None) -> Flow:
    """One Cornetto iteration (cornetto_tpu.flow.runner.iteration_flow)
    with the depth (aligner-free) and panel steps on the port."""
    config = config or {}
    flow = _host.iteration_flow(workdir, fasta, reads_fastq, config)
    aligner_free = bool(config.get("aligner_free", False))
    ported = {"panel": lambda ctx: _panel(ctx, fasta, aligner_free)}
    if aligner_free:
        ported["depth"] = lambda ctx: _cov_tracks(ctx, fasta, reads_fastq,
                                                  config)
    for step in flow.steps:
        step.run = ported.get(step.name, step.run)
    return flow


def main(argv) -> int:
    if len(argv) < 3:
        sys.stderr.write("Usage: cornetto flow <workdir> <assembly.fasta> "
                         "<reads.fastq> [--config cfg.json]\n")
        return 1
    config = {}
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "--config":
            with open(argv[i + 1]) as f:
                config = json.load(f)
            i += 2
        else:
            args.append(argv[i])
            i += 1
    flow = iteration_flow(args[0], args[1], args[2], config)
    return flow.run()
