"""Builds the reference's C loops with cc into build/portbench/ at
the root of the checkout (a fixed directory, named by a hash of the source
and flags, so only the first run of a checkout compiles) and loads them
with ctypes."""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent.parent / "build" / "portbench"
_LIBS = {}
_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """Build (once) and load reference/<name>.c, its functions typed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = _load(name)
        return _LIBS[name]


def _load(name: str) -> ctypes.CDLL:
    cflags = _FLAGS[name]
    src = HERE / (name + ".c")
    key = hashlib.sha256(src.read_bytes() + " ".join(cflags).encode())
    so = BUILD / ("_pb_%s-%s.so" % (name, key.hexdigest()[:16]))
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(so.name + ".%d.tmp" % os.getpid())
        subprocess.run([os.environ.get("CC", "cc"), *cflags, "-shared",
                        "-fPIC", str(src), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn, (res, args) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib


_vp, _i64, _ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the SDUST DP runs 2x faster at -O2 than at -O3 (native/__init__.py)
_FLAGS = {"sdust": ("-O2",), "place": ("-O2",)}
_SIGNATURES = {
    "sdust": {"pb_sdust_mask": (_i64, [ctypes.c_char_p, _i64, _ci, _ci, _vp,
                                       _i64])},
    "place": {"pb_place": (_i64, [_vp, _i64, _ci, _ci, _vp, _vp])},
}
