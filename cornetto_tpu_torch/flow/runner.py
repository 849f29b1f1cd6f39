"""flow on the port: counterpart of cornetto_tpu/flow/runner.py.

The iterative-protocol orchestrator: every step has declared artifact
outputs and a completed marker, so a crashed run resumes by skipping
finished steps.  ``Step``, ``FlowContext`` and ``Flow`` are copies of the
JAX package's runner.  ``iteration_flow`` builds the same DAG (the same
steps, names, outputs, ordering and resume-on-artifacts state) from the
port's own steps: ``align`` (an external command template), ``depth`` from
a BAM or, aligner-free, from the port's ``livefish cov`` tally, ``panel``
(the port's create-panel), ``telostats`` and ``livefish-index``.  No step
runs code of the JAX package.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cornetto_tpu_torch.utils import logging as log

__all__ = ["Flow", "FlowContext", "iteration_flow", "main"]


@dataclass
class Step:
    name: str
    run: Callable[["FlowContext"], None]
    outputs: List[str] = field(default_factory=list)
    after: List[str] = field(default_factory=list)
    # retry budget for flaky external stages (the reference retries only
    # dorado duplex — shitflow/duplex/dorado_duplex_retry.sge.sh; here any
    # step can declare attempts > 1)
    attempts: int = 1


@dataclass
class FlowContext:
    workdir: str
    config: Dict

    def path(self, rel: str) -> str:
        # absolute: ctx.sh runs command templates with cwd=workdir, so
        # workdir-relative paths would resolve doubly-nested there
        return os.path.abspath(os.path.join(self.workdir, rel))

    def sh(self, template_key: str, **fmt) -> None:
        """Run an external-tool command template from the config, e.g.
        config["tools"]["minimap2_asm"] =
        "minimap2 -t16 --eqx -cx asm5 {ref} {asm} > {out}"."""
        template = self.config.get("tools", {}).get(template_key)
        if not template:
            log.die("no command template for external tool '%s' in config"
                    % template_key)
        cmd = template.format(**fmt)
        log.info("flow: $ %s" % cmd)
        subprocess.run(cmd, shell=True, check=True, cwd=self.workdir)


class Flow:
    def __init__(self, name: str, workdir: str, config: Optional[Dict] = None):
        self.name = name
        self.ctx = FlowContext(workdir=workdir, config=config or {})
        self.steps: List[Step] = []
        os.makedirs(workdir, exist_ok=True)
        self._state_path = os.path.join(workdir, ".flow.%s.json" % name)

    def step(self, name: str, outputs: List[str] = (),
             after: List[str] = ()):
        def deco(fn):
            self.steps.append(Step(name, fn, list(outputs), list(after)))
            return fn
        return deco

    def add(self, name: str, fn, outputs: List[str] = (),
            after: List[str] = (), attempts: int = 1):
        self.steps.append(Step(name, fn, list(outputs), list(after),
                               attempts))

    def _load_state(self) -> Dict:
        if os.path.exists(self._state_path):
            with open(self._state_path) as f:
                return json.load(f)
        return {"done": {}}

    def _save_state(self, state: Dict) -> None:
        with open(self._state_path, "w") as f:
            json.dump(state, f, indent=1)

    def _is_done(self, step: Step, state: Dict) -> bool:
        if step.name not in state["done"]:
            return False
        # artifact-level validation: all declared outputs must still exist
        return all(os.path.exists(self.ctx.path(o)) for o in step.outputs)

    def run(self, only: Optional[List[str]] = None) -> int:
        state = self._load_state()
        done = set(n for n in state["done"])
        for step in self.steps:
            if only and step.name not in only:
                continue
            missing = [d for d in step.after if d not in done]
            if missing:
                log.die("flow %s: step %s depends on unfinished %s"
                        % (self.name, step.name, missing))
            if self._is_done(step, state):
                log.info("flow %s: skip %s (artifacts present)"
                         % (self.name, step.name))
                done.add(step.name)
                continue
            log.info("flow %s: run %s" % (self.name, step.name))
            t0 = time.time()
            for attempt in range(step.attempts):
                try:
                    step.run(self.ctx)
                    break
                except Exception as e:
                    if attempt + 1 >= step.attempts:
                        raise
                    log.warning("flow %s: step %s attempt %d/%d failed "
                                "(%s); retrying"
                                % (self.name, step.name, attempt + 1,
                                   step.attempts, e))
            for o in step.outputs:
                if not os.path.exists(self.ctx.path(o)):
                    log.die("flow %s: step %s did not produce %s"
                            % (self.name, step.name, o))
            state["done"][step.name] = {"at": time.time(),
                                        "secs": round(time.time() - t0, 3)}
            done.add(step.name)
            self._save_state(state)
        return 0


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
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.livefish.coverage import (CoverageParams,
                                                      CoverageTally,
                                                      stream_coverage)
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    from cornetto_tpu_torch.livefish.index import build_index
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


def _depth_tracks(ctx: FlowContext, fasta: str) -> None:
    from cornetto_tpu_torch.io.bam import BamFile, write_depth_bedgraph
    prefix = _prefix(fasta)
    bam = BamFile(ctx.path(prefix + ".bam"))
    write_depth_bedgraph(bam, ctx.path(prefix + ".cov-total.bg"))
    write_depth_bedgraph(bam, ctx.path(prefix + ".cov-mq20.bg"), min_mapq=20)


def _telostats(ctx: FlowContext, fasta: str) -> None:
    from cornetto_tpu_torch.pipelines import telostats
    prefix = _prefix(fasta)
    with open(ctx.path(prefix + ".telostats.txt"), "w") as out:
        telostats.run(ctx.path(prefix + ".fasta"), out_dir=ctx.workdir,
                      tmp_dir=ctx.path("tmp_telostats"), out=out)


def _livefish_index(ctx: FlowContext, fasta: str) -> None:
    from cornetto_tpu_torch.dist.checkpoint import save_index
    from cornetto_tpu_torch.io.bed import read_bed3
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    prefix = _prefix(fasta)
    contigs = {r.name: r.seq
               for r in read_fastx(ctx.path(prefix + ".fasta"))}
    idx = build_index(contigs)
    panel = build_panel_mask(
        idx, read_bed3(ctx.path(prefix + ".boringbits.bed")))
    save_index(ctx.path(prefix + ".livefish"), idx, panel_mask=panel)


def iteration_flow(workdir: str, fasta: str, reads_fastq: str,
                   config: Optional[Dict] = None) -> Flow:
    """One Cornetto iteration: depth tracks from a BAM (or, aligner-free,
    from the engine's hits), panel generation, telomere stats, livefish
    index + readfish targets — the create-launch/create-core/getstat chain
    of the reference (reference: shitflow/create-launch.pbs.sh,
    create-core.pbs.sh, getstat.pbs.sh)."""
    config = config or {}
    flow = Flow("iteration", workdir, config)
    aligner_free = bool(config.get("aligner_free", False))
    prefix = _prefix(fasta)

    def align(ctx: FlowContext):
        bam = ctx.path(prefix + ".bam")
        if os.path.exists(bam):
            return
        ctx.sh("minimap2_map_ont", ref=fasta, reads=reads_fastq, out=bam)

    tracks = [prefix + ".cov-total.bg", prefix + ".cov-mq20.bg"]
    if aligner_free:
        flow.add("depth",
                 lambda ctx: _cov_tracks(ctx, fasta, reads_fastq, config),
                 outputs=tracks)
    else:
        flow.add("align", align, outputs=[prefix + ".bam"])
        flow.add("depth", lambda ctx: _depth_tracks(ctx, fasta),
                 outputs=tracks, after=["align"])
    flow.add("panel", lambda ctx: _panel(ctx, fasta, aligner_free),
             outputs=[prefix + ".boringbits.bed", prefix + ".boringbits.txt"],
             after=["depth"])
    flow.add("telostats", lambda ctx: _telostats(ctx, fasta),
             outputs=[prefix + ".telostats.txt"], after=["panel"])
    flow.add("livefish-index", lambda ctx: _livefish_index(ctx, fasta),
             outputs=[prefix + ".livefish.npz"], after=["panel"])
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
