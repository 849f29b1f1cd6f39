"""`cornetto` CLI of the PyTorch port: counterpart of cornetto_tpu/cli.py.

Ported: ``livefish`` (run | index | toml | cov | replay), ``boringbits``,
``noboringbits``, ``create-panel``, ``flow``, ``sdust`` and ``telofind``;
``telowin`` and ``telobreaks`` are the port's copies of the JAX package's
host tools.  Every other subcommand of the JAX package exits 1 with "not yet
ported to cornetto_tpu_torch".  The device is cuda unless
CORNETTO_FORCE_CPU=1 (cornetto_tpu_torch.device)."""

import sys

from cornetto_tpu_torch.livefish.cli import NOT_PORTED
from cornetto_tpu_torch.utils import timing
from cornetto_tpu_torch.version import __version__

# subcommands of cornetto_tpu.cli that the port does not have yet
JAX_ONLY = (
    "fixasm", "minidot", "bigenough", "fa2bed", "seq", "asmstats", "nx",
    "report", "telocontigs", "depth", "bammerge", "recreate-panel",
    "telostats", "minidotplot", "hapnetto", "refine", "asmstats-pipeline",
    "flow-eval", "flow-sv", "flow-simplex", "gfa2fa")


def print_usage(fp) -> int:
    fp.write("Usage: cornetto <command> [options]   (PyTorch/CUDA port)\n\n")
    fp.write("commands:\n")
    fp.write("   create panel:\n")
    fp.write("       noboringbits    print no boring bits in an assembly\n")
    fp.write("       boringbits      print boring bits in an assembly\n")
    fp.write("   telo:\n")
    fp.write("       telowin         analyse telomere windows in a fasta "
             "file\n")
    fp.write("       telobreaks      find telomere breaks in a fasta file\n")
    fp.write("       telofind        find telomere sequences in a fasta "
             "file\n")
    fp.write("       sdust           symmetric DUST "
             "(https://github.com/lh3/sdust)\n")
    fp.write("   pipelines:\n")
    fp.write("       create-panel    create-cornetto pipeline "
             "(fa2bed+noboringbits+intervals+bigenough)\n")
    fp.write("       livefish        real-time adaptive-sampling decision "
             "engine (run | index | toml | cov | replay)\n")
    fp.write("       flow            one-iteration orchestrator "
             "(align/cov+panel+telostats+index)\n")
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
    elif cmd == "livefish":
        from cornetto_tpu_torch.livefish import cli as livefish_cli
        ret = livefish_cli.main(rest)
    elif cmd in ("--version", "-V"):
        sys.stdout.write("cornetto-tpu %s\n" % __version__)
        return 0
    elif cmd in ("--help", "-h"):
        return print_usage(sys.stdout)
    elif cmd in JAX_ONLY:
        sys.stderr.write("[cornetto] %s: %s\n" % (cmd, NOT_PORTED))
        return 1
    else:
        sys.stderr.write("[cornetto] Unrecognised command %s\n" % cmd)
        return print_usage(sys.stderr)

    timing.print_footer(__version__, argv[1:], realtime0)
    return ret


if __name__ == "__main__":
    sys.exit(main())
