"""minidotplot: asm-vs-ref dotplot pipeline.

Reference behavior: scripts/minidotplot.sh — minimap2 asm5 alignment ->
fixasm (report + fixed PAF + fixed FASTA) -> minidot -f 2 -> EPS.

The aligner stays external (as in the reference); pass a precomputed PAF
with --paf, or have `minimap2` on PATH / $MINIMAP2.
"""

import os
import shutil
import subprocess
import sys

from cornetto_tpu_torch.tools import fixasm, minidot
from cornetto_tpu_torch.utils import logging as log


def run(ref_fasta: str, asm_fasta: str, paf_path: str = None,
        out_dir: str = ".", png: bool = False) -> int:
    prefix = os.path.basename(asm_fasta)
    for suf in (".fa", ".fasta"):
        if prefix.endswith(suf):
            prefix = prefix[:-len(suf)]
    prefix = os.path.join(out_dir, prefix)
    if paf_path is None:
        mm2 = os.environ.get("MINIMAP2", "minimap2")
        if shutil.which(mm2) is None:
            log.die("minimap2 not found and no --paf given. Either put "
                    "minimap2 under path, set MINIMAP2, or pass a "
                    "precomputed PAF with --paf")
        paf_path = prefix + ".paf"
        with open(paf_path, "w") as f:
            subprocess.run([mm2, "-t16", "--eqx", "-cx", "asm5", "-I8G",
                            ref_fasta, asm_fasta], stdout=f, check=True)
    fixed_fa = prefix + ".fixed.fasta"
    fixed_paf = prefix + ".fixed.paf"
    report = prefix + ".report.tsv"
    missing = prefix + ".missing.txt"
    with open(fixed_fa, "w") as f:
        fixasm.run(asm_fasta, paf_path, missing_fn=missing,
                   report_fn=report, out_paf=fixed_paf, out=f)
    eps_path = prefix + ".eps"
    with open(eps_path, "w") as f:
        minidot.run(fixed_paf, font_size=2, out=f)
    if png:
        # convenience raster (our extension; the reference emits EPS only)
        from cornetto_tpu_torch.io.raster import eps_to_png
        eps_to_png(eps_path, prefix + ".png")
    return 0


def main(argv) -> int:
    paf = None
    png = False
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "--paf":
            paf = argv[i + 1]
            i += 2
        elif argv[i] == "--png":
            png = True
            i += 1
        else:
            args.append(argv[i])
            i += 1
    if len(args) != 2:
        sys.stderr.write("Usage: cornetto minidotplot <ref.fasta> "
                         "<asm.fasta> [--paf aln.paf]\n")
        return 1
    return run(args[0], args[1], paf_path=paf, png=png)
