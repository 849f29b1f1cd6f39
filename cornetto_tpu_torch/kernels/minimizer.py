"""Minimizer math: counterpart of cornetto_tpu/kernels/minimizer.py.  The
PyTorch half stands for its device half (hash32_jax, read_minimizers_jax,
unpack_reads_jax); the numpy half (encode_seq, pack_reads, minimizers_np and
the native index-build twin minimizers_native) is a copy of its host half.

The JAX package computes in wrapping uint32.  PyTorch has no shifts,
adds or minimum on uint32 CPU tensors, and ``>>`` on int32 is arithmetic,
so the arithmetic here runs on int64 holding uint32 values, masked with
``& 0xFFFFFFFF`` after every step that can carry past bit 31.  Hash
tensors cross module boundaries as int32 carrying the uint32 bit pattern
(what the CUDA kernel writes); ``as_u32`` widens them back.
"""

import numpy as np
import torch

DEFAULT_K = 15
DEFAULT_W = 10

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


_CODE_TABLE = _CODE.tobytes()


def encode_seq(seq: str) -> np.ndarray:
    """ASCII -> 2-bit codes (4 = N/other)."""
    return _CODE[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]


def encode_bytes(seq: bytes) -> np.ndarray:
    """encode_seq of a bytes object, with no str round trip: one
    bytes.translate pass through the same table (half the time of the
    numpy gather), into a writable array."""
    return np.frombuffer(bytearray(seq.translate(_CODE_TABLE)),
                         dtype=np.uint8)


def _hash32_np(x: np.ndarray) -> np.ndarray:
    """Invertible 32-bit mix (minimap2-style finalizer), numpy."""
    x = x.astype(np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    x = (~x + (x << np.uint64(21))) & mask
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & mask
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & mask
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & mask
    return x.astype(np.uint32)


def minimizers_np(codes: np.ndarray, k: int = DEFAULT_K, w: int = DEFAULT_W):
    """Host twin of the device kernel: returns (positions, hashes) of the
    stride-w windowed minima over canonical k-mer hashes."""
    n = len(codes)
    if n < k:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint32))
    m = n - k + 1
    valid = np.ones(m, dtype=bool)
    fwd = np.zeros(m, dtype=np.uint64)
    rev = np.zeros(m, dtype=np.uint64)
    for j in range(k):
        c = codes[j:m + j]
        valid &= c < 4
        fwd = (fwd << np.uint64(2)) | c.astype(np.uint64)
        rev = rev | ((np.uint64(3) - np.minimum(c, 3).astype(np.uint64))
                     << np.uint64(2 * j))
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd &= mask
    canon = np.minimum(fwd, rev)
    h = _hash32_np(canon.astype(np.uint64))
    h = np.where(valid, h, np.uint32(0xFFFFFFFF))
    nwin = m // w
    if nwin == 0:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint32))
    hw = h[:nwin * w].reshape(nwin, w)
    arg = hw.argmin(axis=1)
    pos = (np.arange(nwin) * w + arg).astype(np.int32)
    hmin = hw[np.arange(nwin), arg]
    keep = hmin != np.uint32(0xFFFFFFFF)
    return pos[keep], hmin[keep]


def minimizers_native(codes: np.ndarray, k: int = DEFAULT_K,
                      w: int = DEFAULT_W):
    """Threaded C twin of minimizers_np (native/minimizer_native.c):
    bit-identical output, ~200x the NumPy rate (the k-pass uint64 NumPy
    build was 380 s for a 500 Mbp genome — the index-build bottleneck).
    Falls back to minimizers_np when no compiler is available."""
    import ctypes
    from cornetto_tpu_torch import native
    lib = native.load("minimizer_native", "minimizer_native.c")
    if lib is None:
        return minimizers_np(codes, k, w)
    n = len(codes)
    m = n - k + 1
    nwin = m // w if m > 0 else 0
    if nwin <= 0:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.uint32))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    hashes = np.empty(nwin, dtype=np.uint32)
    pos = np.empty(nwin, dtype=np.int32)
    import os
    lib.mz_extract(
        ctypes.c_void_p(codes.ctypes.data), ctypes.c_int64(n),
        ctypes.c_int(k), ctypes.c_int(w),
        ctypes.c_int(min(os.cpu_count() or 1, 16)),
        ctypes.c_void_p(hashes.ctypes.data), ctypes.c_void_p(pos.ctypes.data))
    keep = hashes != np.uint32(0xFFFFFFFF)
    return pos[keep], hashes[keep]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """The packed plane of ``pack_reads``: (B, L) uint8 codes < 4, L a
    multiple of 4 and each row contiguous -> (B, L/4) uint8, four codes a
    byte, the first in the low bits.  Each little-endian word of four codes
    folds into its low byte."""
    w = codes.view("<u4")
    w = w | (w >> 6)
    return (w | (w >> 12)).astype(np.uint8)


def pack_reads(codes: np.ndarray):
    """Host-side 2-bit packing for cheap host->device transfer:
    (B, L) uint8 codes (0..4) -> (packed (B, ceil(L/4)) uint8,
    nmask (B, ceil(L/8)) uint8 bitmap of N positions)."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    L8 = -(-L // 8) * 8
    c4 = np.zeros((B, L4), dtype=np.uint8)
    c4[:, :L] = codes & 3
    n8 = np.zeros((B, L8), dtype=np.uint8)
    n8[:, :L] = codes >= 4
    bits = np.packbits(n8, axis=1, bitorder="little")
    return pack_2bit(c4), bits


def pack_codes(codes: torch.Tensor):
    """``pack_reads`` on a tensor, on its own device: (B, L) uint8 codes
    -> (packed (B, ceil(L/4)) uint8, nmask (B, ceil(L/8)) uint8)."""
    B, L = codes.shape
    c4 = torch.zeros((B, -(-L // 4) * 4), dtype=torch.uint8,
                     device=codes.device)
    c4[:, :L] = codes & 3
    packed = (c4[:, 0::4] | (c4[:, 1::4] << 2) | (c4[:, 2::4] << 4)
              | (c4[:, 3::4] << 6))
    n8 = torch.zeros((B, -(-L // 8) * 8), dtype=torch.uint8,
                     device=codes.device)
    n8[:, :L] = codes >= 4
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=codes.device)
    bits = (n8.view(B, -1, 8) * weights).sum(-1, dtype=torch.uint8)
    return packed, bits


U32_MASK = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF   # hash of an invalid k-mer / empty window


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor (int32 bit pattern or int64) -> int64 uint32 value."""
    return x.to(torch.int64) & U32_MASK


def as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 with the same 32-bit pattern (exact;
    no reliance on how a narrowing cast wraps)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Invertible 32-bit mix (minimap2-style finalizer), as hash32_jax.
    Takes any integer tensor (low 32 bits used); returns int64 uint32
    values."""
    m = U32_MASK
    x = as_u32(x)
    x = ((~x) + (x << 21)) & m
    x = x ^ (x >> 24)
    x = (x + (x << 3) + (x << 8)) & m
    x = x ^ (x >> 14)
    x = (x + (x << 2) + (x << 4)) & m
    x = x ^ (x >> 28)
    x = (x + (x << 31)) & m
    return x


def canonical_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) int64 codes in 0..3 -> (B, L-k+1) int64 hash32 of each
    canonical k-mer (min of the big-endian forward word and its reverse
    complement, low 32 bits as the JAX package keeps them)."""
    m = codes.shape[1] - k + 1
    fwd = torch.zeros((codes.shape[0], m), dtype=torch.int64,
                      device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j:j + m]
        fwd = (fwd << 2) | c
        rev = rev | ((3 - c) << (2 * j))
    return hash32(torch.minimum(fwd & U32_MASK, rev & U32_MASK))


def kmer_valid(base_ok: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) per-base validity -> (B, L-k+1): every base of the k-mer."""
    m = base_ok.shape[1] - k + 1
    ok = base_ok[:, :m].clone()
    for j in range(1, k):
        ok &= base_ok[:, j:j + m]
    return ok


def _windows(h: torch.Tensor, w: int) -> torch.Tensor:
    nwin = h.shape[1] // w
    return h[:, :nwin * w].reshape(h.shape[0], nwin, w)


def read_minimizers(codes: torch.Tensor, k: int = 15, w: int = 10,
                    want_pos: bool = True):
    """codes (B, L) uint8 (0..3, 4 = N) -> (positions (B, M) int32 or
    None, hashes (B, M) int32 bit patterns, valid (B, M) bool),
    M = (L-k+1)//w: the stride-w window minima of read_minimizers_jax."""
    h = canonical_hashes(codes.clamp(max=3).to(torch.int64), k)
    h = torch.where(kmer_valid(codes < 4, k), h, SENTINEL)
    hw = _windows(h, w)
    if want_pos:
        # argmin returns the first minimum, as jnp.argmin does
        arg = torch.argmin(hw, dim=2)
        hmin = torch.gather(hw, 2, arg[:, :, None])[:, :, 0]
        base = torch.arange(hw.shape[1], dtype=torch.int64,
                            device=codes.device) * w
        pos = (base[None, :] + arg).to(torch.int32)
    else:
        pos = None
        hmin = hw.amin(dim=2)
    return pos, as_i32_bits(hmin), hmin != SENTINEL


def unpack_codes(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/4)) uint8, four 2-bit codes per byte low bits first ->
    (B, L) uint8 codes 0..3."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    c = (packed[:, :, None] >> shifts[None, None, :]) & 3
    return c.reshape(packed.shape[0], -1)[:, :L]


def unpack_nmask(nmask: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/8)) uint8 little-endian N bitmap -> (B, L) bool."""
    bit = torch.arange(8, dtype=torch.uint8, device=nmask.device)
    nm = (nmask[:, :, None] >> bit[None, None, :]) & 1
    return nm.reshape(nmask.shape[0], -1)[:, :L].bool()


def unpack_reads(packed: torch.Tensor, nmask: torch.Tensor,
                 L: int) -> torch.Tensor:
    """Inverse of kernels.minimizer.pack_reads -> (B, L) uint8 codes with
    N positions as 4 (unpack_reads_jax)."""
    return torch.where(unpack_nmask(nmask, L), torch.tensor(
        4, dtype=torch.uint8, device=packed.device), unpack_codes(packed, L))
