"""Native (C) host kernels of the port, built lazily with the system
compiler and loaded via ctypes.  Each source here is compiled with ``cc``
into ``build/native/`` at the root of the checkout (beside the CUDA
kernels' ``build/kernels/``), never into the package directory.  Every
native kernel has a pure-Python twin used as the correctness oracle and
fallback."""

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_LOCK = threading.Lock()
_LIBS = {}


def _build(name: str, source: str, cflags=("-O3",)) -> str:
    so_path = os.path.join(BUILD_DIR, "_%s.so" % name)
    src_path = os.path.join(_HERE, source)
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src_path)):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so_path, os.getpid())
    cc = os.environ.get("CC", "cc")
    cmd = [cc, *cflags, "-shared", "-fPIC", "-pthread", src_path, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)    # atomic: concurrent builds agree
    return so_path


def load(name: str, source: str, cflags=("-O3",)):
    """Build (if stale) and dlopen a native kernel; returns None when no
    compiler is available (callers fall back to Python).

    cflags: per-kernel optimisation flags — the branch-heavy sdust DP is
    2x FASTER at -O2 than -O3 (aggressive unroll/vectorise thrashes its
    data-dependent inner loops), while the streaming parsers like -O3."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(_build(name, source, cflags))
        except Exception as e:  # no toolchain / build failure
            sys.stderr.write("[native] %s unavailable (%s); using Python "
                             "fallback\n" % (name, e.__class__.__name__))
            lib = None
        _LIBS[name] = lib
        return lib
