"""Fused minimizer extraction: packed reads in, per-window minimizer hashes
out.  Counterpart of cornetto_tpu/kernels/pallas_extract.py::
extract_minima_pallas.

``extract_minima`` launches the hand-written CUDA kernel
(csrc/extract_minima.cu) for tensors on a CUDA device and runs the plain
PyTorch version ``extract_minima_ref`` for tensors on the CPU; on a CUDA
tensor it launches or raises, never falls back.
"""

import torch

from cornetto_tpu_torch.kernels import _build
from cornetto_tpu_torch.kernels.minimizer import (SENTINEL, as_i32_bits,
                                                  canonical_hashes,
                                                  kmer_valid, unpack_codes,
                                                  unpack_nmask)

_KERNEL = "extract_minima"


def extract_minima_ref(packed: torch.Tensor, nmask, L: int, k: int, w: int,
                       lengths=None):
    """Plain PyTorch version of the kernel (same arguments and results as
    ``extract_minima``); runs on any device."""
    m = L - k + 1
    h = canonical_hashes(unpack_codes(packed, L).to(torch.int64), k)
    if nmask is not None:
        ok = kmer_valid(~unpack_nmask(nmask, L), k)
    elif lengths is not None:
        i = torch.arange(m, dtype=torch.int32, device=packed.device)
        ok = i[None, :] + (k - 1) < lengths.to(torch.int32)[:, None]
    else:
        ok = None
    if ok is not None:
        h = torch.where(ok, h, SENTINEL)
    nwin = m // w
    hmin = h[:, :nwin * w].reshape(h.shape[0], nwin, w).amin(dim=2)
    return as_i32_bits(hmin), hmin != SENTINEL


def _check(packed, nmask, L, k, w, lengths):
    if not isinstance(packed, torch.Tensor) or packed.dim() != 2:
        raise ValueError("packed must be a 2-D tensor")
    B = packed.shape[0]
    dev = packed.device
    if not 1 <= k <= 15:
        raise ValueError("k must be in 1..15 (got %d)" % k)
    if w < 1 or L < k or (L - k + 1) // w < 1:
        raise ValueError("no full window: L=%d k=%d w=%d" % (L, k, w))
    if B < 1:
        raise ValueError("empty batch")
    want = [("packed", packed, torch.uint8, (B, -(-L // 4)))]
    if nmask is not None:
        want.append(("nmask", nmask, torch.uint8, (B, -(-L // 8))))
    if lengths is not None:
        want.append(("lengths", lengths, torch.int32, (B,)))
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError("%s is on %s, packed on %s"
                             % (name, t.device, dev))
        if t.dtype != dtype:
            raise TypeError("%s must be %s (got %s)" % (name, dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s (got %s)"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def extract_minima(packed: torch.Tensor, nmask, L: int, k: int, w: int,
                   lengths=None):
    """packed (B, ceil(L/4)) uint8 2-bit codes (kernels.minimizer.
    pack_reads); nmask (B, ceil(L/8)) uint8 N bitmap or None; lengths (B,)
    int32 read lengths or None (nmask wins when both are given; neither =
    N-free).  Returns (hmin (B, nwin) int32 carrying the uint32 hash bit
    pattern, valid (B, nwin) bool), nwin = (L-k+1)//w, equal bit for bit
    to extract_minima_pallas.

    A CUDA input launches the kernel on the current stream without
    synchronising and adds one to ``extract_minima.launches``."""
    _check(packed, nmask, L, k, w, lengths)
    if packed.device.type == "cpu":
        return extract_minima_ref(packed, nmask, L, k, w, lengths=lengths)
    if packed.device.type != "cuda":
        raise ValueError("unsupported device %s" % packed.device)
    if nmask is not None:
        lengths = None
    B = packed.shape[0]
    nwin = (L - k + 1) // w
    hmin = torch.empty((B, nwin), dtype=torch.int32, device=packed.device)
    valid = torch.empty((B, nwin), dtype=torch.bool, device=packed.device)
    fn = _build.bind(_KERNEL, "cornetto_extract_minima", "pppiiiippp")
    _build.launch(fn, "extract_minima kernel", packed.device,
                  packed.data_ptr(),
                  None if nmask is None else nmask.data_ptr(),
                  None if lengths is None else lengths.data_ptr(),
                  B, L, k, w, hmin.data_ptr(), valid.data_ptr())
    extract_minima.launches += 1
    return hmin, valid


extract_minima.launches = 0
