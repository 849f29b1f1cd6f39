"""ctypes binding for the native decision-TSV formatter (tsv_format.c).

Formats a whole decision batch into one buffer with the GIL released —
the pure-Python row loop (~200k rows/s, GIL-bound) was the end-to-end
streaming bottleneck once uploads and readbacks were pipelined.  Output is
byte-identical to stream.py's Python fallback (tested).
"""

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from cornetto_tpu_torch import native

_lib = None
_init = False


def _get():
    global _lib, _init
    if not _init:
        _lib = native.load("tsv_format", "tsv_format.c")
        if _lib is not None:
            _lib.tsv_format.restype = ctypes.c_long
            _lib.tsv_format.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_char),
                ctypes.c_long, ctypes.POINTER(ctypes.c_int64)]
            _lib.compact_ids.restype = ctypes.c_long
            _lib.compact_ids.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_char), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64)]
        _init = True
    return _lib


class NameTable:
    """Pre-encoded contig-name blob for the formatter."""

    def __init__(self, names: Optional[List[str]]):
        if names is None:
            self.blob = None
            self.off = None
            self.len = None
            self.n = 0
            return
        enc = [n.encode() for n in names]
        self.blob = b"".join(enc)
        self.len = np.array([len(e) for e in enc], dtype=np.int32)
        self.off = np.zeros(len(enc), dtype=np.int64)
        if len(enc):
            np.cumsum(self.len[:-1], out=self.off[1:])
        self.n = len(enc)


def available() -> bool:
    return _get() is not None


def format_batch(id_blob: bytes, id_off: np.ndarray, id_len: np.ndarray,
                 d: np.ndarray, best: np.ndarray, est: np.ndarray,
                 nhits: np.ndarray, names: NameTable, count: int
                 ) -> Tuple[bytes, int]:
    """Returns (tsv_bytes, n_accepted) for rows [0, count)."""
    lib = _get()
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)

    def as32(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        return a, a.ctypes.data_as(i32)

    d, dp = as32(d)
    best, bp = as32(best)
    est, ep = as32(est)
    nhits, np_ = as32(nhits)
    id_off = np.ascontiguousarray(id_off, dtype=np.int64)
    id_len = np.ascontiguousarray(id_len, dtype=np.int32)
    max_nm = int(names.len.max()) if names.n else 11
    cap = int(id_len[:count].sum()) + count * (max_nm + 45) + 64
    out = ctypes.create_string_buffer(cap)
    acc = ctypes.c_int64(0)
    n = lib.tsv_format(
        id_blob, id_off.ctypes.data_as(i64), id_len.ctypes.data_as(i32),
        dp, bp, ep, np_,
        names.blob, None if names.blob is None
        else names.off.ctypes.data_as(i64),
        None if names.blob is None else names.len.ctypes.data_as(i32),
        names.n, count, out, cap, ctypes.byref(acc))
    assert n >= 0, "tsv_format buffer undersized (cap=%d)" % cap
    return ctypes.string_at(out, n), int(acc.value)


def compact_ids(buf: bytes, base: int, off: np.ndarray, ln: np.ndarray,
                count: int) -> Tuple[bytes, np.ndarray]:
    """Copy ids at buf[base+off[i] : +ln[i]] into one compact blob;
    returns (blob, blob-relative offsets)."""
    lib = _get()
    if lib is None:  # pure-Python fallback (no C toolchain)
        parts = [buf[base + int(off[i]):base + int(off[i]) + int(ln[i])]
                 for i in range(count)]
        lens = np.asarray(ln[:count], dtype=np.int64)
        oo = np.zeros(count, dtype=np.int64)
        if count:
            np.cumsum(lens[:-1], out=oo[1:])
        return b"".join(parts), oo
    off = np.ascontiguousarray(off[:count] + base, dtype=np.int64)
    ln = np.ascontiguousarray(ln[:count], dtype=np.int32)
    cap = int(ln.sum())
    out = ctypes.create_string_buffer(max(cap, 1))
    oo = np.zeros(count, dtype=np.int64)
    n = lib.compact_ids(
        buf, off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), count,
        out, cap, oo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    assert n == cap, (n, cap)
    return ctypes.string_at(out, n), oo
