"""Minimizer math in PyTorch: counterpart of the device half of
cornetto_tpu/kernels/minimizer.py (hash32_jax, read_minimizers_jax,
unpack_reads_jax); the numpy half (encode_seq, pack_reads, minimizers_np)
is shared by import.

The JAX package computes in wrapping uint32.  PyTorch has no shifts,
adds or minimum on uint32 CPU tensors, and ``>>`` on int32 is arithmetic,
so the arithmetic here runs on int64 holding uint32 values, masked with
``& 0xFFFFFFFF`` after every step that can carry past bit 31.  Hash
tensors cross module boundaries as int32 carrying the uint32 bit pattern
(what the CUDA kernel writes); ``as_u32`` widens them back.
"""

import torch

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
