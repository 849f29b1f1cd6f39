"""`cornetto` CLI of the PyTorch port: counterpart of cornetto_tpu/cli.py,
with the same subcommand tree.  ``livefish`` (run | index | toml | cov |
replay), ``boringbits``, ``noboringbits``, ``create-panel``, ``flow``,
``sdust`` and ``telofind`` run the port's engine and kernels
(``telostats`` and ``flow-eval`` reach telofind's device path); every other
subcommand is the port's copy of the JAX package's host tool or pipeline.
The device is cuda unless CORNETTO_FORCE_CPU=1
(cornetto_tpu_torch.device)."""

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


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    realtime0 = timing.realtime()
    if len(argv) < 2:
        return print_usage(sys.stderr)
    cmd = argv[1]
    rest = argv[2:]
    if cmd in ("boringbits", "noboringbits"):
        from cornetto_tpu_torch.tools import boringbits
        ret = boringbits.main(rest, boring=cmd == "boringbits")
    elif cmd == "create-panel":
        from cornetto_tpu_torch.pipelines import create_cornetto
        ret = create_cornetto.main(rest)
    elif cmd == "flow":
        from cornetto_tpu_torch.flow import runner
        ret = runner.main(rest)
    elif cmd == "sdust":
        from cornetto_tpu_torch.tools import sdust
        ret = sdust.main(rest)
    elif cmd == "telofind":
        from cornetto_tpu_torch.tools import telofind
        ret = telofind.main(rest)
    elif cmd == "telowin":
        from cornetto_tpu_torch.tools import telowin
        ret = telowin.main(rest)
    elif cmd == "telobreaks":
        from cornetto_tpu_torch.tools import telobreaks
        ret = telobreaks.main(rest)
    elif cmd == "bigenough":
        from cornetto_tpu_torch.tools import bigenough
        ret = bigenough.main(rest)
    elif cmd == "fixasm":
        from cornetto_tpu_torch.tools import fixasm
        ret = fixasm.main(rest)
    elif cmd == "asmstats":
        from cornetto_tpu_torch.tools import asmstats
        ret = asmstats.main(rest)
    elif cmd == "nx":
        from cornetto_tpu_torch.tools import nx
        ret = nx.main(rest)
    elif cmd == "report":
        from cornetto_tpu_torch.tools import report
        ret = report.main(rest)
    elif cmd == "telocontigs":
        from cornetto_tpu_torch.tools import telocontigs
        ret = telocontigs.main(rest)
    elif cmd == "fa2bed":
        from cornetto_tpu_torch.tools import fa2bed
        ret = fa2bed.main(rest)
    elif cmd == "seq":
        from cornetto_tpu_torch.tools import seq
        ret = seq.main(rest)
    elif cmd == "depth":
        from cornetto_tpu_torch.tools import depth
        ret = depth.main(rest)
    elif cmd == "bammerge":
        from cornetto_tpu_torch.tools import depth
        ret = depth.merge_main(rest)
    elif cmd == "recreate-panel":
        from cornetto_tpu_torch.pipelines import recreate_cornetto
        ret = recreate_cornetto.main(rest)
    elif cmd == "telostats":
        from cornetto_tpu_torch.pipelines import telostats
        ret = telostats.main(rest)
    elif cmd == "asmstats-pipeline":
        from cornetto_tpu_torch.pipelines import asmstats_sh
        ret = asmstats_sh.main(rest)
    elif cmd == "minidot":
        from cornetto_tpu_torch.tools import minidot
        ret = minidot.main(rest)
    elif cmd == "minidotplot":
        from cornetto_tpu_torch.pipelines import minidotplot
        ret = minidotplot.main(rest)
    elif cmd == "hapnetto":
        from cornetto_tpu_torch.pipelines import hapnetto
        ret = hapnetto.main(rest)
    elif cmd == "refine":
        from cornetto_tpu_torch.pipelines import refine
        ret = refine.main(rest)
    elif cmd == "flow-eval":
        from cornetto_tpu_torch.flow import evaljobs
        ret = evaljobs.eval_main(rest)
    elif cmd == "flow-sv":
        from cornetto_tpu_torch.flow import evaljobs
        ret = evaljobs.sv_main(rest)
    elif cmd == "flow-simplex":
        from cornetto_tpu_torch.flow import simplex
        ret = simplex.main(rest)
    elif cmd == "gfa2fa":
        from cornetto_tpu_torch.io import gfa
        ret = gfa.main(rest)
    elif cmd == "livefish":
        from cornetto_tpu_torch.livefish import cli as livefish_cli
        ret = livefish_cli.main(rest)
    elif cmd in ("--version", "-V"):
        sys.stdout.write("cornetto-tpu %s\n" % __version__)
        return 0
    elif cmd in ("--help", "-h"):
        return print_usage(sys.stdout)
    else:
        sys.stderr.write("[cornetto] Unrecognised command %s\n" % cmd)
        return print_usage(sys.stderr)

    timing.print_footer(__version__, argv[1:], realtime0)
    return ret


if __name__ == "__main__":
    sys.exit(main())
