"""Minimizer extraction of the port (cornetto_tpu_torch.kernels.extract)
against the JAX package's Pallas kernel in interpret mode, as
tests/test_pallas_extract.py runs it: all three validity variants, integer
results at tolerance 0, inputs from a numpy seed.  On the CPU the wrapper
runs its plain PyTorch version; the CUDA kernel itself is held against that
version on the card (marked ``cuda``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cornetto_tpu.kernels.minimizer import pack_reads
from cornetto_tpu.kernels.pallas_extract import extract_minima_pallas
from cornetto_tpu_torch.kernels.extract import (extract_minima,
                                                extract_minima_ref)

PARAMS = [
    (64, 450, 15, 10),
    (32, 300, 15, 10),
    (16, 1024, 13, 8),
    (8, 200, 15, 12),
]
VARIANTS = ["nmask", "nfree", "lengths"]


def _inputs(B, L, k, variant):
    rng = np.random.default_rng(7 + B)
    reads = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = None
    if variant == "nmask":
        reads[rng.random((B, L)) < 0.01] = 4      # sprinkle Ns
    elif variant == "lengths":
        lengths = rng.integers(k - 1, L + 1, size=B).astype(np.int32)
        lengths[:2] = L                            # some full-length rows
    packed, nmask = pack_reads(reads)
    return packed, (nmask if variant == "nmask" else None), lengths


def _jax(packed, nmask, lengths, L, k, w):
    h, v = extract_minima_pallas(
        jnp.asarray(packed), None if nmask is None else jnp.asarray(nmask),
        L, k, w, interpret=True,
        lengths=None if lengths is None else jnp.asarray(lengths))
    return np.asarray(h), np.asarray(v)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B,L,k,w", PARAMS)
def test_extract_matches_pallas(B, L, k, w, variant):
    packed, nmask, lengths = _inputs(B, L, k, variant)
    h_ref, v_ref = _jax(packed, nmask, lengths, L, k, w)
    before = extract_minima.launches
    h, v = extract_minima(_t(packed), _t(nmask), L, k, w,
                          lengths=_t(lengths))
    assert extract_minima.launches == before      # CPU: no kernel launch
    assert h.dtype == torch.int32 and v.dtype == torch.bool
    assert h.shape == (B, (L - k + 1) // w)
    np.testing.assert_array_equal(h.numpy().view(np.uint32), h_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)


def test_nmask_wins_over_lengths():
    """With both given, the bitmap decides validity (as in JAX)."""
    B, L, k, w = 8, 200, 15, 10
    packed, nmask, _ = _inputs(B, L, k, "nmask")
    lengths = np.full(B, 20, dtype=np.int32)
    h_ref, v_ref = _jax(packed, nmask, None, L, k, w)
    h, v = extract_minima(_t(packed), _t(nmask), L, k, w,
                          lengths=_t(lengths))
    np.testing.assert_array_equal(h.numpy().view(np.uint32), h_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)


@pytest.mark.parametrize("bad", ["dtype", "shape", "k", "window",
                                 "noncontig", "device_mix"])
def test_wrapper_rejects_bad_input(bad):
    B, L, k, w = 4, 100, 15, 10
    packed = torch.zeros((B, L // 4), dtype=torch.uint8)
    nmask = lengths = None
    if bad == "dtype":
        packed = packed.to(torch.int32)
    elif bad == "shape":
        packed = torch.zeros((B, L // 4 + 1), dtype=torch.uint8)
    elif bad == "k":
        k = 16
    elif bad == "window":
        L, packed = 20, torch.zeros((B, 5), dtype=torch.uint8)
    elif bad == "noncontig":
        packed = torch.zeros((L // 4, B), dtype=torch.uint8).t()
    elif bad == "device_mix":
        lengths = torch.zeros(B, dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, TypeError)):
        extract_minima(packed, nmask, L, k, w, lengths=lengths)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B,L,k,w", PARAMS + [(4096, 450, 15, 10),
                                             (512, 1800, 15, 10)])
def test_kernel_matches_plain_on_card(cuda_device, B, L, k, w, variant):
    packed, nmask, lengths = _inputs(B, L, k, variant)
    args = [None if a is None else torch.from_numpy(a).to(cuda_device)
            for a in (packed, nmask, lengths)]
    before = extract_minima.launches
    h, v = extract_minima(args[0], args[1], L, k, w, lengths=args[2])
    torch.cuda.synchronize()
    assert extract_minima.launches == before + 1
    h_ref, v_ref = extract_minima_ref(args[0], args[1], L, k, w,
                                      lengths=args[2])
    assert torch.equal(h, h_ref) and torch.equal(v, v_ref)
