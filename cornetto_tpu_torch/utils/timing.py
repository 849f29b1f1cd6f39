"""Run-footer self-reporting: real time, CPU time, peak RSS
(reference: src/main.c:145-149, src/misc.c:48-70)."""

import resource
import sys
import time


def realtime() -> float:
    return time.time()


def cputime() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def peakrss_bytes() -> int:
    r = resource.getrusage(resource.RUSAGE_SELF)
    if sys.platform.startswith("linux"):
        return r.ru_maxrss * 1024
    return r.ru_maxrss


def print_footer(version: str, argv, realtime0: float, func: str = "main") -> None:
    sys.stderr.write("[%s] Version: %s\n" % (func, version))
    sys.stderr.write("[%s] CMD:" % func)
    for a in argv:
        sys.stderr.write(" %s" % a)
    sys.stderr.write(
        "\n[%s] Real time: %.3f sec; CPU time: %.3f sec; Peak RAM: %.3f GB\n\n"
        % (func, realtime() - realtime0, cputime(),
           peakrss_bytes() / 1024.0 / 1024.0 / 1024.0))
