"""PyTorch minimizer math (cornetto_tpu_torch.kernels.minimizer) against the
JAX package's device functions and the numpy host twins: integer results,
tolerance 0, inputs from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cornetto_tpu.kernels.minimizer import (_hash32_np, hash32_jax,
                                            minimizers_np, pack_reads,
                                            read_minimizers_jax,
                                            unpack_reads_jax)
from cornetto_tpu_torch.kernels.minimizer import (as_i32_bits, as_u32,
                                                  hash32, read_minimizers,
                                                  unpack_reads)
from cornetto_tpu_torch.kernels.minimizer import pack_reads as pack_reads_port


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32."""
    return t.numpy().view(np.uint32)


def test_hash32_matches_jax_and_numpy():
    rng = np.random.default_rng(101)
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFE,
                  0x3FFFFFFF], dtype=np.uint32),
        rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32),
    ])
    want_jax = np.asarray(hash32_jax(jnp.asarray(x)))
    want_np = _hash32_np(x)
    # as int64 uint32 values and as int32 bit patterns: both inputs agree
    got64 = hash32(torch.from_numpy(x.astype(np.int64))).numpy()
    got32 = hash32(torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got64, want_jax.astype(np.int64))
    np.testing.assert_array_equal(got32, want_np.astype(np.int64))


def test_u32_bit_pattern_roundtrip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                 dtype=np.uint32)
    t = as_i32_bits(torch.from_numpy(x.astype(np.int64)))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(_u32(t), x)
    np.testing.assert_array_equal(as_u32(t).numpy(), x.astype(np.int64))


def _reads(seed, B, L, n_frac=0.01):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    reads[rng.random((B, L)) < n_frac] = 4
    return reads


@pytest.mark.parametrize("B,L,k,w", [
    (16, 450, 15, 10),
    (8, 300, 13, 8),
    (4, 200, 15, 12),
])
def test_read_minimizers_matches_jax(B, L, k, w):
    reads = _reads(5 + B, B, L)
    pos_j, h_j, v_j = read_minimizers_jax(jnp.asarray(reads), k=k, w=w)
    pos_t, h_t, v_t = read_minimizers(torch.from_numpy(reads), k=k, w=w)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(_u32(h_t), np.asarray(h_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    _, h_j2, v_j2 = read_minimizers_jax(jnp.asarray(reads), k=k, w=w,
                                        want_pos=False)
    pos_n, h_t2, v_t2 = read_minimizers(torch.from_numpy(reads), k=k, w=w,
                                        want_pos=False)
    assert pos_n is None
    np.testing.assert_array_equal(_u32(h_t2), np.asarray(h_j2))
    np.testing.assert_array_equal(v_t2.numpy(), np.asarray(v_j2))


def test_read_minimizers_matches_host_twin():
    """Per read, the valid (position, hash) pairs equal minimizers_np, the
    function the index build uses."""
    reads = _reads(17, 6, 500, n_frac=0.02)
    pos_t, h_t, v_t = read_minimizers(torch.from_numpy(reads))
    for i in range(reads.shape[0]):
        p_np, h_np = minimizers_np(reads[i])
        keep = v_t[i].numpy()
        np.testing.assert_array_equal(pos_t[i].numpy()[keep], p_np)
        np.testing.assert_array_equal(_u32(h_t[i])[keep], h_np)


@pytest.mark.parametrize("L", [450, 301, 64])
def test_unpack_reads_matches_jax(L):
    reads = _reads(L, 12, L, n_frac=0.05)
    packed, nmask = pack_reads(reads)
    for got, want in zip(pack_reads_port(reads), (packed, nmask)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert got.shape == want.shape
    want = np.asarray(unpack_reads_jax(jnp.asarray(packed),
                                       jnp.asarray(nmask), L))
    got = unpack_reads(torch.from_numpy(packed), torch.from_numpy(nmask), L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), reads)
