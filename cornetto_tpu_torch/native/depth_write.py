"""ctypes binding for the native depth-row writer with Python fallback.

write_rows(path, name, depth, mode, start0, append) emits the coverage
rows of one contig; see native/depth_write.c for the three row formats.
"""

import ctypes

import numpy as np

from cornetto_tpu_torch import native

PER_BASE_BEDGRAPH = 0
SAMTOOLS_DEPTH = 1
RUNLEN_BEDGRAPH = 2

_lib = None
_init = False


def _get():
    global _lib, _init
    if not _init:
        _lib = native.load("depth_write", "depth_write.c")
        if _lib is not None:
            _lib.depth_write.restype = ctypes.c_long
            _lib.depth_write.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
                ctypes.c_long, ctypes.c_int]
        _init = True
    return _lib


def _write_rows_py(path: str, name: str, depth: np.ndarray, mode: int,
                   start0: int, append: bool) -> int:
    rows = 0
    with open(path, "ab" if append else "wb") as f:
        if mode == SAMTOOLS_DEPTH:
            out = "".join("%s\t%d\t%d\n" % (name, start0 + i + 1, v)
                          for i, v in enumerate(depth))
            rows = len(depth)
        elif mode == PER_BASE_BEDGRAPH:
            out = "".join("%s\t%d\t%d\t%d\n"
                          % (name, start0 + i, start0 + i + 1, v)
                          for i, v in enumerate(depth))
            rows = len(depth)
        else:
            parts = []
            i, n = 0, len(depth)
            while i < n:
                j = i + 1
                while j < n and depth[j] == depth[i]:
                    j += 1
                parts.append("%s\t%d\t%d\t%d\n"
                             % (name, start0 + i, start0 + j, depth[i]))
                rows += 1
                i = j
            out = "".join(parts)
        f.write(out.encode())
    return rows


def write_rows(path: str, name: str, depth: np.ndarray,
               mode: int = PER_BASE_BEDGRAPH, start0: int = 0,
               append: bool = False) -> int:
    """Write one contig's depth rows; returns the row count."""
    d = np.ascontiguousarray(depth, dtype=np.int64)
    lib = _get()
    if lib is None:
        return _write_rows_py(path, name, d, mode, start0, append)
    r = lib.depth_write(path.encode(), int(append), name.encode(),
                        d.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        len(d), start0, mode)
    if r < 0:
        raise OSError("depth_write failed for %s" % path)
    return int(r)
