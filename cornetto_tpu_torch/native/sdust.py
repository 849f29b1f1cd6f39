"""ctypes binding for the native SDUST kernel with Python fallback."""

import ctypes
from typing import List, Tuple

import numpy as np

from cornetto_tpu_torch import native
from cornetto_tpu_torch.kernels.sdust_core import sdust as sdust_py

_lib = None
_init = False


def _get():
    global _lib, _init
    if not _init:
        _lib = native.load("sdust_native", "sdust_native.c",
                           cflags=("-O2",))
        if _lib is not None:
            _lib.sdust_mask.restype = ctypes.c_int64
            _lib.sdust_mask.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64]
        _init = True
    return _lib


def sdust(seq: bytes, T: int = 20, W: int = 64) -> List[Tuple[int, int]]:
    lib = _get()
    if lib is None:
        return sdust_py(seq, T=T, W=W)
    cap = max(len(seq) // 2 + 16, 64)
    out = np.empty(cap, dtype=np.int64)
    n = lib.sdust_mask(seq, len(seq), T, W,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       cap)
    if n < 0:
        cap = -n
        out = np.empty(cap, dtype=np.int64)
        n = lib.sdust_mask(seq, len(seq), T, W,
                           out.ctypes.data_as(
                               ctypes.POINTER(ctypes.c_int64)), cap)
    vals = out[:n]
    return [(int(v >> 32), int(v & 0xFFFFFFFF)) for v in vals]
