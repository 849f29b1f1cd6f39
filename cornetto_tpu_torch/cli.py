"""`cornetto` CLI of the PyTorch port: counterpart of cornetto_tpu/cli.py,
with the same subcommand tree.  ``livefish`` (run | index | toml | cov |
replay), ``boringbits``, ``noboringbits``, ``create-panel``, ``flow``,
``sdust`` and ``telofind`` run the port's engine and kernels
(``telostats`` and ``flow-eval`` reach telofind's device path); every other
subcommand is the port's copy of the JAX package's host tool or pipeline.
The device is cuda unless CORNETTO_FORCE_CPU=1
(cornetto_tpu_torch.device)."""

import importlib
import os
import sys

from cornetto_tpu_torch.utils import timing
from cornetto_tpu_torch.version import __version__


def print_usage(fp) -> int:
    fp.write("Usage: cornetto <command> [options]   (PyTorch/CUDA port)\n\n")
    fp.write("commands:\n")
    fp.write("   create panel:\n")
    fp.write("       noboringbits    print no boring bits in an assembly\n")
    fp.write("       boringbits      print boring bits in an assembly\n")
    fp.write("       bigenough       find contigs that have sufficient "
             "boring bits\n")
    fp.write("   dotplot:\n")
    fp.write("       fixasm          fix the direction of contigs in an "
             "assembly\n")
    fp.write("       minidot         create dot plot "
             "(from https://github.com/lh3/miniasm)\n")
    fp.write("   eval:\n")
    fp.write("       asmstats        calculate assembly statistics\n")
    fp.write("       nx              nx or ngx plot tables\n")
    fp.write("       report          generate a report table for one or more "
             "assemblies\n")
    fp.write("       telocontigs     prints contigs from largest to smallest "
             "with number of telomeres\n")
    fp.write("   telo:\n")
    fp.write("       telowin         analyse telomere windows in a fasta "
             "file\n")
    fp.write("       telobreaks      find telomere breaks in a fasta file\n")
    fp.write("       telofind        find telomere sequences in a fasta "
             "file\n")
    fp.write("       sdust           symmetric DUST "
             "(https://github.com/lh3/sdust)\n")
    fp.write("   misc:\n")
    fp.write("       fa2bed          create a bed file with assembly contig "
             "lengths\n")
    fp.write("       seq             extract reads equal or longer than a "
             "threshold from a fastq\n")
    fp.write("   pipelines:\n")
    fp.write("       create-panel    create-cornetto pipeline "
             "(fa2bed+noboringbits+intervals+bigenough)\n")
    fp.write("       recreate-panel  recreate-cornetto pipeline\n")
    fp.write("       telostats       telomere statistics pipeline\n")
    fp.write("       minidotplot     fixasm + minidot dot plot pipeline\n")
    fp.write("       hapnetto        diploid panel from the haplotype "
             "alignments (after create-panel / recreate-panel)\n")
    fp.write("       refine          curate T2T contigs across iterations\n")
    fp.write("       asmstats-pipeline  asmstats pipeline (<prefix>.paf, "
             ".windows.0.4.50kb.ends.bed, .report.tsv)\n")
    fp.write("       livefish        real-time adaptive-sampling decision "
             "engine (run | index | toml | cov | replay)\n")
    fp.write("       flow            one-iteration orchestrator "
             "(align/cov+panel+telostats+index)\n")
    fp.write("       flow-eval       evaluation chain: "
             "minidotplot+telostats+asmstats+quast/compleasm/yak\n")
    fp.write("       flow-sv         SV concordance chain: dipcall -> >50bp "
             "filter -> truvari\n")
    fp.write("       flow-simplex    basecall->filter->assemble chain "
             "([--duplex] for the legacy path)\n")
    fp.write("       gfa2fa          assembly graph S-lines to FASTA "
             "(gfatools gfa2fa stage)\n")
    fp.write("       depth           per-base BAM depth\n")
    fp.write("       bammerge        merge position-sorted BAMs (+ .bai)\n")
    fp.write("\n")
    fp.write("       --help, -h      print this help message\n")
    fp.write("       --version, -V   print version information\n")
    return 1 if fp is sys.stderr else 0


# subcommand -> (module under cornetto_tpu_torch, function, keyword args)
COMMANDS = {
    "boringbits": ("tools.boringbits", "main", {"boring": True}),
    "noboringbits": ("tools.boringbits", "main", {"boring": False}),
    "create-panel": ("pipelines.create_cornetto", "main", {}),
    "flow": ("flow.runner", "main", {}),
    "sdust": ("tools.sdust", "main", {}),
    "telofind": ("tools.telofind", "main", {}),
    "telowin": ("tools.telowin", "main", {}),
    "telobreaks": ("tools.telobreaks", "main", {}),
    "bigenough": ("tools.bigenough", "main", {}),
    "fixasm": ("tools.fixasm", "main", {}),
    "asmstats": ("tools.asmstats", "main", {}),
    "nx": ("tools.nx", "main", {}),
    "report": ("tools.report", "main", {}),
    "telocontigs": ("tools.telocontigs", "main", {}),
    "fa2bed": ("tools.fa2bed", "main", {}),
    "seq": ("tools.seq", "main", {}),
    "depth": ("tools.depth", "main", {}),
    "bammerge": ("tools.depth", "merge_main", {}),
    "recreate-panel": ("pipelines.recreate_cornetto", "main", {}),
    "telostats": ("pipelines.telostats", "main", {}),
    "asmstats-pipeline": ("pipelines.asmstats_sh", "main", {}),
    "minidot": ("tools.minidot", "main", {}),
    "minidotplot": ("pipelines.minidotplot", "main", {}),
    "hapnetto": ("pipelines.hapnetto", "main", {}),
    "refine": ("pipelines.refine", "main", {}),
    "flow-eval": ("flow.evaljobs", "eval_main", {}),
    "flow-sv": ("flow.evaljobs", "sv_main", {}),
    "flow-simplex": ("flow.simplex", "main", {}),
    "gfa2fa": ("io.gfa", "main", {}),
    "livefish": ("livefish.cli", "main", {}),
}


def main(argv=None) -> int:
    """Run the subcommand argv[1] on argv[2:].  With CORNETTO_PROFILE=<dir>
    it runs under a torch.profiler trace written to
    <dir>/<subcommand>/trace.json (utils.profiling.maybe_trace), and the
    program's spans are logged at VERBOSE level at its end; without it the
    CLI prints what the JAX package's prints."""
    argv = list(sys.argv if argv is None else argv)
    realtime0 = timing.realtime()
    if len(argv) < 2:
        return print_usage(sys.stderr)
    cmd = argv[1]
    rest = argv[2:]
    if cmd in ("--version", "-V"):
        sys.stdout.write("cornetto-tpu %s\n" % __version__)
        return 0
    if cmd in ("--help", "-h"):
        return print_usage(sys.stdout)
    if cmd not in COMMANDS:
        sys.stderr.write("[cornetto] Unrecognised command %s\n" % cmd)
        return print_usage(sys.stderr)
    module, func, kw = COMMANDS[cmd]
    run = getattr(importlib.import_module("cornetto_tpu_torch." + module),
                  func)
    if os.environ.get("CORNETTO_PROFILE"):
        from cornetto_tpu_torch.utils import profiling
        profiling.reset()
        with profiling.maybe_trace(cmd):
            ret = run(rest, **kw)
        profiling.log_tally()
    else:
        ret = run(rest, **kw)
    timing.print_footer(__version__, argv[1:], realtime0)
    return ret


if __name__ == "__main__":
    sys.exit(main())
