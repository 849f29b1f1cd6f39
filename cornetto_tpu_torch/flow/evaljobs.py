"""Evaluation-job layer: the getstat / quast / compleasm / yak-qv /
dipcall+truvari chain as a runnable flow DAG (VERDICT round-1 item #8 —
these existed only as a doc note before).

Reference behavior:
- getstat (reference: shitflow/getstat.pbs.sh:59-63): minidotplot +
  telostats + asmstats on an assembly vs a reference genome — those three
  run NATIVELY here (our golden-tested pipelines); only minimap2 stays an
  external template, as in minidotplot.sh.
- quast (reference: shitflow/quast.pbs.sh): `quast.py -t T -o OUT -l ASM
  --large ASM`.
- compleasm (reference: shitflow/compleasm.pbs.sh): `compleasm run -a ASM
  -o OUT -t T -l LINEAGE [-L DB]`.
- yak QV (reference: shitflow/yak-qv.pbs.sh:35-37): `yak count -K1.5g` on
  the truth k-mer source (cached like the reference's `test -e REF.yak`),
  then `yak qv REF.yak ASM > ASM.yak.txt`.
- SV concordance (reference: shitflow/postcall/sv/dipcall.sh, truvari.sh):
  dipcall mak generation + make, bcftools norm, the >50 bp structural
  filter (done natively here — it is pure text processing), bgzip+tabix,
  truvari bench.

All external tools run through config["tools"] command templates with the
reference argv shapes as defaults, so a cluster deployment only overrides
paths (the same role as the PBS `qsub -v` env vars).
"""

import os
import shutil
from typing import Dict, Optional

from cornetto_tpu_torch.flow.runner import Flow, FlowContext

# default external-tool templates, mirroring the reference's invocations
DEFAULT_TOOLS = {
    "minimap2_asm": "minimap2 -t{threads} --eqx -cx asm5 {ref} {asm} "
                    "> {out}",
    "quast": "quast.py -t {threads} -o {out_dir} -l {asm} --large {asm}",
    "compleasm": "compleasm run -a {asm} -o {out_dir} -t {threads} "
                 "-l {lineage}",
    "yak_count": "yak count -K1.5g -t {threads} {source} -o {out}",
    "yak_qv": "yak qv {yak} {asm} -t {threads} > {out}",
    "dipcall": "run-dip {ref} {pat} {mat} > {mak}",
    "make_dip": "make -j2 -f {mak}",
    "bcftools_norm": "bcftools norm -m-any {vcf} > {out}",
    "bgzip": "bgzip {path}",
    "tabix": "tabix {path}",
    "truvari": "truvari bench -b {base_vcf} -c {call_vcf} -f {ref} "
               "-o {out_dir}/",
}


def filter_structural(split_vcf: str, out_vcf: str,
                      min_len: int = 50) -> int:
    """The dipcall.sh awk stage, natively: keep the header plus records
    whose REF or ALT allele is longer than min_len bases (reference:
    shitflow/postcall/sv/dipcall.sh — `length($4)>50 || length($5)>50`).
    Returns the number of structural records kept."""
    kept = 0
    with open(split_vcf) as fin, open(out_vcf, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                fout.write(line)
                continue
            p = line.split("\t")
            if len(p) > 4 and (len(p[3]) > min_len or len(p[4]) > min_len):
                fout.write(line)
                kept += 1
    return kept


def _tools(config: Optional[Dict]) -> Dict:
    tools = dict(DEFAULT_TOOLS)
    tools.update((config or {}).get("tools", {}))
    return tools


def eval_flow(workdir: str, ref: str, asm: str,
              config: Optional[Dict] = None) -> Flow:
    """The getstat evaluation chain + QC jobs for one assembly.

    Steps: minidotplot (native fixasm+minidot, external minimap2),
    telostats (native), asmstats (native), quast, compleasm, yak-qv.
    Config keys: threads, lineage, yak_source (defaults to ref),
    with_quast/with_compleasm/with_yak to opt out of QC jobs."""
    config = dict(config or {})
    config["tools"] = _tools(config)
    flow = Flow("eval", workdir, config)
    threads = int(config.get("threads", 16))
    filename = os.path.basename(asm)
    prefix = filename
    for suf in (".fa", ".fasta"):
        if prefix.endswith(suf):
            prefix = prefix[:-len(suf)]

    def stage_asm(ctx: FlowContext):
        # getstat copies the assembly into the workdir first
        # (reference: shitflow/getstat.pbs.sh:56-57)
        dst = ctx.path(filename)
        if not os.path.exists(dst):
            shutil.copy(asm, dst)

    def minidotplot(ctx: FlowContext):
        from cornetto_tpu_torch.pipelines import minidotplot as mdp
        paf = ctx.path(prefix + ".paf")
        ctx.sh("minimap2_asm", threads=threads, ref=ref,
               asm=ctx.path(filename), out=paf)
        mdp.run(ref, ctx.path(filename), paf_path=paf, out_dir=ctx.workdir)

    def telostats(ctx: FlowContext):
        from cornetto_tpu_torch.pipelines import telostats as ts
        with open(ctx.path(filename + ".telostats.txt"), "w") as out:
            ts.run(ctx.path(filename), out_dir=ctx.workdir,
                   tmp_dir=ctx.path("tmp_%s_telostats" % prefix), out=out)

    def asmstats(ctx: FlowContext):
        # asmstats.sh consumes the RAW minimap2 PAF + fixasm report
        # (reference: scripts/asmstats.sh:27)
        from cornetto_tpu_torch.tools import asmstats as ast
        with open(ctx.path(filename + ".asmstats.txt"), "w") as out:
            ast.run(ctx.path(prefix + ".paf"),
                    ctx.path("%s.windows.0.4.50kb.ends.bed" % prefix),
                    ctx.path(prefix + ".report.tsv"), out=out)

    def quast(ctx: FlowContext):
        ctx.sh("quast", threads=threads, out_dir=ctx.path("quast_out"),
               asm=ctx.path(filename))

    def compleasm(ctx: FlowContext):
        ctx.sh("compleasm", threads=threads,
               out_dir=ctx.path("compleasm_out"), asm=ctx.path(filename),
               lineage=config.get("lineage", "primates"))

    def yak_qv(ctx: FlowContext):
        source = config.get("yak_source", ref)
        yak = source + ".yak"
        if not os.path.exists(yak):   # cached, like the reference
            ctx.sh("yak_count", threads=threads, source=source, out=yak)
        ctx.sh("yak_qv", threads=threads, yak=yak, asm=ctx.path(filename),
               out=ctx.path(filename + ".yak.txt"))

    flow.add("stage-asm", stage_asm, outputs=[filename])
    flow.add("minidotplot", minidotplot,
             outputs=[prefix + ".fixed.paf", prefix + ".report.tsv",
                      prefix + ".eps"],
             after=["stage-asm"])
    flow.add("telostats", telostats,
             outputs=[filename + ".telostats.txt",
                      "%s.windows.0.4.50kb.ends.bed" % prefix],
             after=["stage-asm"])
    flow.add("asmstats", asmstats, outputs=[filename + ".asmstats.txt"],
             after=["minidotplot", "telostats"])
    if config.get("with_quast", True):
        flow.add("quast", quast, outputs=["quast_out"],
                 after=["stage-asm"])
    if config.get("with_compleasm", True):
        flow.add("compleasm", compleasm, outputs=["compleasm_out"],
                 after=["stage-asm"])
    if config.get("with_yak", True):
        flow.add("yak-qv", yak_qv, outputs=[filename + ".yak.txt"],
                 after=["stage-asm"])
    return flow


def eval_main(argv) -> int:
    """CLI: cornetto flow-eval <workdir> <ref.fasta> <asm.fasta>
    [--config cfg.json] — the getstat+QC chain."""
    import json
    import sys
    config, args = _parse_config(argv)
    if len(args) != 3:
        sys.stderr.write("Usage: cornetto flow-eval <workdir> <ref.fasta> "
                         "<asm.fasta> [--config cfg.json]\n")
        return 1
    return eval_flow(args[0], args[1], args[2], config).run()


def sv_main(argv) -> int:
    """CLI: cornetto flow-sv <workdir> <ref> <pat.fa> <mat.fa>
    [base.vcf.gz] [--config cfg.json] — dipcall/truvari SV chain."""
    import sys
    config, args = _parse_config(argv)
    if len(args) not in (4, 5):
        sys.stderr.write("Usage: cornetto flow-sv <workdir> <ref.fa> "
                         "<pat.fa> <mat.fa> [base.vcf.gz] "
                         "[--config cfg.json]\n")
        return 1
    base = args[4] if len(args) == 5 else None
    return sv_flow(args[0], args[1], args[2], args[3], base_vcf=base,
                   config=config).run()


def _parse_config(argv):
    import json
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
    return config, args


def sv_flow(workdir: str, ref: str, pat: str, mat: str,
            base_vcf: Optional[str] = None,
            config: Optional[Dict] = None) -> Flow:
    """SV concordance chain: dipcall -> make -> bcftools norm -> native
    >50 bp structural filter -> bgzip+tabix -> optional truvari bench vs a
    baseline VCF (reference: shitflow/postcall/sv/{dipcall,truvari}.sh)."""
    config = dict(config or {})
    config["tools"] = _tools(config)
    flow = Flow("sv", workdir, config)
    threads = int(config.get("threads", 16))

    def dipcall(ctx: FlowContext):
        ctx.sh("dipcall", ref=ref, pat=pat, mat=mat,
               mak=ctx.path("dip.mak"))
        ctx.sh("make_dip", mak=ctx.path("dip.mak"))

    def norm(ctx: FlowContext):
        ctx.sh("bcftools_norm", vcf=ctx.path("dip.dip.vcf.gz"),
               out=ctx.path("split.vcf"))

    def structural(ctx: FlowContext):
        filter_structural(ctx.path("split.vcf"),
                          ctx.path("structural_split.vcf"))
        ctx.sh("bgzip", path=ctx.path("structural_split.vcf"))
        ctx.sh("tabix", path=ctx.path("structural_split.vcf.gz"))

    def truvari(ctx: FlowContext):
        ctx.sh("truvari", base_vcf=base_vcf,
               call_vcf=ctx.path("structural_split.vcf.gz"), ref=ref,
               out_dir=ctx.path("truvari_out"))

    flow.add("dipcall", dipcall, outputs=["dip.mak", "dip.dip.vcf.gz"])
    flow.add("norm", norm, outputs=["split.vcf"], after=["dipcall"])
    flow.add("structural", structural,
             outputs=["structural_split.vcf.gz"], after=["norm"])
    if base_vcf:
        flow.add("truvari", truvari, outputs=["truvari_out"],
                 after=["structural"])
    _ = threads
    return flow
