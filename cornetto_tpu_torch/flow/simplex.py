"""Simplex basecall-to-assembly orchestration + the legacy duplex path.

The reference spreads this over three machines with ssh/scp/screen/qsub
(reference: shitflow/simplex-shitflow.sh:83-94 merges slow5 on the
sequencer host and hands off; shitflow/simplex/basecall-gta100.sh:37-71
polls nvidia-smi for a free GPU, basecalls, seqkit-filters >=30 kb and
qsubs the assembly; shitflow/hifiasm-ont.pbs.sh:79-127 assembles and fans
out eval/panel jobs).  Here the same chain is ONE resumable flow: the
genuinely external tools (slow5tools, the basecaller, hifiasm) run through
command templates; the read filter (tools/seq — the seqkit stage),
gfa2fa (io/gfa.py — the gfatools stage) and the duplex read split
(samtools/seqtk/removeSubset.pl chain) run natively.

Device discovery: the reference's nvidia-smi polling loop becomes a
`device_query` template whose stdout names the accelerator (or a static
config["device"]); on a TPU host there is nothing to poll — jax owns the
chip — so the default is "auto".
"""

import glob
import os
from typing import Dict, Optional

from cornetto_tpu_torch.flow.runner import Flow, FlowContext

DEFAULT_TOOLS = {
    "slow5_merge": "slow5tools merge {src} -o {out}",
    "slow5_stats": "slow5tools stats {blow5}",
    "slow5_split": "slow5tools split {blow5} -d {out_dir} -g {groups}",
    # reference: slow5-dorado basecaller -x cuda:all MODEL in.blow5
    #            --emit-fastq --min-qscore 10 > out.fastq
    # (shitflow/simplex/basecall-gta100.sh:59)
    "basecall": "slow5-dorado basecaller -x {device} {model} {blow5} "
                "--emit-fastq --min-qscore 10 > {out}",
    # reference: slow5-dorado duplex MODEL in.blow5 > out.bam
    # (shitflow/duplex/dorado_duplex_retry.sge.sh)
    "basecall_duplex": "slow5-dorado duplex {model} {blow5} > {out}",
    # reference: hifiasm --ont -t T --telo-m CCCTAA --hg-size SZ -o ASM fq
    # (shitflow/hifiasm-ont.pbs.sh:79)
    "hifiasm": "hifiasm --ont -t {threads} --telo-m CCCTAA "
               "--hg-size {hg_size} -o {asm} {fastq}",
    "device_query": None,   # optional: stdout names the accelerator
}

MIN_READ_LEN = 30000        # seqkit seq -m 30000 (basecall-gta100.sh:62)
MIN_SIMPLEX_LEN = 10000     # seqtk seq -L 10000 (get_duplex_..._reads)


def _tools(config: Optional[Dict]) -> Dict:
    tools = dict(DEFAULT_TOOLS)
    tools.update((config or {}).get("tools", {}))
    return tools


def _pick_device(ctx: FlowContext, config: Dict) -> str:
    dev = config.get("device")
    if dev:
        return dev
    template = config["tools"].get("device_query")
    if template:
        import subprocess
        out = subprocess.run(template, shell=True, check=True,
                             capture_output=True, cwd=ctx.workdir)
        return out.stdout.decode().strip()
    return "auto"


def simplex_flow(workdir: str, sample: str, blow5_src: str,
                 config: Optional[Dict] = None) -> Flow:
    """merge slow5 -> basecall -> >=30 kb filter (native) -> hifiasm ->
    gfa2fa x3 (native).  blow5_src: glob/dir of slow5 inputs, or an
    existing .blow5 to skip the merge.  Chain iteration_flow /
    eval_flow on the produced {sample}.fasta afterwards (the reference
    qsubs those as separate jobs; here they are separate flows)."""
    config = dict(config or {})
    config["tools"] = _tools(config)
    flow = Flow("simplex", workdir, config)
    threads = int(config.get("threads", 16))
    blow5 = sample + ".blow5"

    def merge(ctx: FlowContext):
        if os.path.exists(blow5_src) and blow5_src.endswith(".blow5"):
            if not os.path.exists(ctx.path(blow5)):
                os.symlink(os.path.abspath(blow5_src), ctx.path(blow5))
        else:
            ctx.sh("slow5_merge", src=blow5_src, out=ctx.path(blow5))
        ctx.sh("slow5_stats", blow5=ctx.path(blow5))

    def basecall(ctx: FlowContext):
        device = _pick_device(ctx, config)
        ctx.sh("basecall", device=device,
               model=config.get("model", "sup"),
               blow5=ctx.path(blow5),
               out=ctx.path(sample + ".basecalls.fastq"))

    def filter_reads(ctx: FlowContext):
        # native: tools/seq IS the seqkit `seq -m 30000` stage, with the
        # reference binary's exact stderr stats (reference: src/seq.c)
        from cornetto_tpu_torch.tools import seq as seq_tool
        with open(ctx.path(sample + ".fastq"), "w") as out:
            seq_tool.run(ctx.path(sample + ".basecalls.fastq"),
                         int(config.get("min_read_len", MIN_READ_LEN)),
                         out=out)

    def assemble(ctx: FlowContext):
        from cornetto_tpu_torch.io.gfa import gfa2fa
        asm = ctx.path(sample)
        ctx.sh("hifiasm", threads=threads,
               hg_size=config.get("hg_size", "3g"),
               asm=asm, fastq=ctx.path(sample + ".fastq"))
        for gfa, fa in ((".bp.p_ctg.gfa", ".fasta"),
                        (".bp.hap1.p_ctg.gfa", ".hap1.fasta"),
                        (".bp.hap2.p_ctg.gfa", ".hap2.fasta")):
            with open(asm + fa, "w") as out:
                gfa2fa(asm + gfa, out)

    flow.add("merge-slow5", merge, outputs=[blow5])
    flow.add("basecall", basecall, outputs=[sample + ".basecalls.fastq"],
             after=["merge-slow5"],
             attempts=int(config.get("basecall_attempts", 1)))
    flow.add("filter-reads", filter_reads, outputs=[sample + ".fastq"],
             after=["basecall"])
    flow.add("assemble", assemble,
             outputs=[sample + ".fasta", sample + ".hap1.fasta",
                      sample + ".hap2.fasta"],
             after=["filter-reads"])
    return flow


def split_duplex_simplex(bam_paths, duplex_fq: str, simplex_fq: str,
                         min_simplex_len: int = MIN_SIMPLEX_LEN) -> Dict:
    """Native replacement for the samtools/removeSubset.pl/seqtk chain
    (reference: shitflow/duplex/get_duplex_and_simplex_reads.sge.sh):
    dorado-duplex read names are `parent1;parent2` (73 chars) for duplex
    reads and a bare 36-char UUID for simplex; simplex reads whose id
    parents a duplex read are dropped, and the survivors are
    >= min_simplex_len filtered."""
    from cornetto_tpu_torch.io.bam import iter_reads_fastq
    stats = {"duplex": 0, "simplex": 0, "parents_dropped": 0,
             "short_dropped": 0}
    with open(duplex_fq, "w") as fd, open(simplex_fq, "w") as fs:
        for path in bam_paths:
            parents = set()
            simplex = []
            for name, flag, seq, qual in iter_reads_fastq(path):
                if ";" in name:
                    fd.write("@%s\n%s\n+\n%s\n" % (name, seq, qual))
                    stats["duplex"] += 1
                    parents.update(name.split(";"))
                else:
                    simplex.append((name, seq, qual))
            for name, seq, qual in simplex:
                if name in parents:
                    stats["parents_dropped"] += 1
                elif len(seq) < min_simplex_len:
                    stats["short_dropped"] += 1
                else:
                    fs.write("@%s\n%s\n+\n%s\n" % (name, seq, qual))
                    stats["simplex"] += 1
    return stats


def duplex_flow(workdir: str, sample: str, blow5: str,
                config: Optional[Dict] = None) -> Flow:
    """Legacy duplex path: split the blow5 into channel groups, basecall
    each with retries (the reference's only retry loop), then the native
    duplex/simplex read split."""
    config = dict(config or {})
    config["tools"] = _tools(config)
    flow = Flow("duplex", workdir, config)
    groups = int(config.get("channel_groups", 4))

    def split(ctx: FlowContext):
        os.makedirs(ctx.path("split_blow5"), exist_ok=True)
        ctx.sh("slow5_split", blow5=blow5, out_dir=ctx.path("split_blow5"),
               groups=groups)

    def basecall(ctx: FlowContext):
        os.makedirs(ctx.path("split_bam"), exist_ok=True)
        for part in sorted(glob.glob(ctx.path("split_blow5/*.blow5"))):
            stem = os.path.splitext(os.path.basename(part))[0]
            out = ctx.path("split_bam/%s.bam" % stem)
            if os.path.exists(out) and os.path.getsize(out) > 0:
                continue   # durable per-group artifacts, like the retry job
            try:
                ctx.sh("basecall_duplex", model=config.get("model", "sup"),
                       blow5=part, out=out)
            except Exception:
                # drop the partial output so a retry redoes this group
                # (reference: dorado_duplex_retry.sge.sh rm's it)
                if os.path.exists(out):
                    os.unlink(out)
                raise

    def split_reads(ctx: FlowContext):
        bams = sorted(glob.glob(ctx.path("split_bam/*.bam")))
        stats = split_duplex_simplex(
            bams, ctx.path(sample + ".duplex_reads.fastq"),
            ctx.path(sample + ".simplex-min10kb.fastq"),
            int(config.get("min_simplex_len", MIN_SIMPLEX_LEN)))
        with open(ctx.path(sample + ".duplex_split.stats"), "w") as f:
            for k in sorted(stats):
                f.write("%s\t%d\n" % (k, stats[k]))

    flow.add("split-blow5", split, outputs=["split_blow5"])
    flow.add("basecall-duplex", basecall, outputs=["split_bam"],
             after=["split-blow5"],
             attempts=int(config.get("basecall_attempts", 3)))
    flow.add("split-reads", split_reads,
             outputs=[sample + ".duplex_reads.fastq",
                      sample + ".simplex-min10kb.fastq"],
             after=["basecall-duplex"])
    return flow


def main(argv) -> int:
    import json
    import sys
    config = {}
    args = []
    duplex = False
    i = 0
    while i < len(argv):
        if argv[i] == "--config":
            with open(argv[i + 1]) as f:
                config = json.load(f)
            i += 2
        elif argv[i] == "--duplex":
            duplex = True
            i += 1
        else:
            args.append(argv[i])
            i += 1
    if len(args) != 3:
        sys.stderr.write("Usage: cornetto flow-simplex <workdir> <sample> "
                         "<blow5|slow5-dir> [--duplex] "
                         "[--config cfg.json]\n")
        return 1
    mk = duplex_flow if duplex else simplex_flow
    return mk(args[0], args[1], args[2], config).run()
