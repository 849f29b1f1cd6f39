"""Window sums and window depth statistics of the port
(cornetto_tpu_torch.kernels.window_sum) against the JAX package: the
stride-1 sums against sliding_window_sum_pallas in interpret mode (as
tests/test_pallas_window.py runs it), window_stats against
window_stats_jax (sliding_sum_i32 on the CPU) and window_stats_numpy.
Integers throughout, tolerance 0, inputs from a numpy seed.  On the CPU the
wrapper runs its plain PyTorch version; the CUDA kernel itself is held
against that version on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cornetto_tpu.kernels import window_sum as jws
from cornetto_tpu.kernels.pallas_window import sliding_window_sum_pallas
from cornetto_tpu_torch.kernels.window_sum import (resolve_backend,
                                                   window_stats, window_sums,
                                                   window_sums_ref)

LENGTHS = [1, 7, 99, 2500, 2501, 12345]
WINDOWS = [(2500, 50), (999, 37), (1000, 37), (1, 1), (64, 64)]


def _tracks(n, dtype=np.int32, seed=0):
    rng = np.random.default_rng([seed, n])
    return (rng.integers(0, 65536, size=n).astype(dtype),
            rng.integers(0, 65536, size=n).astype(dtype))


@pytest.mark.parametrize("n,chunk,w", [(8192, 2048, 2500), (4096, 1024, 64),
                                       (2048, 2048, 1)])
def test_stride1_sums_match_pallas(n, chunk, w):
    rng = np.random.default_rng(n + w)
    x = rng.integers(0, 65536, n).astype(np.int32)
    want = np.asarray(sliding_window_sum_pallas(jnp.asarray(x), w,
                                                chunk=chunk, interpret=True))
    before = window_sums.launches
    got = window_sums(torch.from_numpy(x), w)
    assert window_sums.launches == before        # CPU: no kernel launch
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        window_sums_ref(torch.from_numpy(x), w).numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
@pytest.mark.parametrize("w,inc", WINDOWS)
@pytest.mark.parametrize("length", LENGTHS)
def test_window_stats_matches_jax_and_numpy(monkeypatch, length, w, inc,
                                            dtype):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    d, m = _tracks(length, dtype)
    want_np = jws.window_stats_numpy(d, m, w, inc)
    want_jax = jws.window_stats_jax(d.astype(np.int32), m.astype(np.int32),
                                    w, inc, pad_bucket=4096)
    got = window_stats(d, m, w, inc)
    for g, a, b in zip(got, want_np, want_jax):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)


@pytest.mark.parametrize("length", [1, 39999, 40000, 40001, 123457])
def test_window_stats_w40000(monkeypatch, length):
    """W > 32767: the JAX package sends these to numpy on the host; the
    port sums them in int64 on the device (here its plain version)."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    d, m = _tracks(length, np.uint16, seed=3)
    want = jws.window_stats_numpy(d, m, 40000, 50)
    want_jax = jws.window_stats_jax(d.astype(np.int32), m.astype(np.int32),
                                    40000, 50)
    for g, a, b in zip(window_stats(d, m, 40000, 50), want, want_jax):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)
    # the largest sums exceed int32
    x = torch.full((2, 40000), 65535, dtype=torch.uint16)
    assert int(window_sums(x, 40000, 50, 1)[0, 0]) == 40000 * 65535


@pytest.mark.parametrize("n,w,s,n_out", [(10, 25, 1, None), (10, 3, 4, None),
                                         (5000, 2500, 50, 51),
                                         (777, 999, 37, 3)])
def test_rows_strides_and_tail(n, w, s, n_out):
    """Each row sums on its own; windows running past the end (N < W
    included) sum only the in-bounds part, as the contract says."""
    rng = np.random.default_rng(n)
    x = rng.integers(-1000, 65536, size=(3, n)).astype(np.int32)
    got = window_sums(torch.from_numpy(x), w, s, n_out).numpy()
    n_out = -(-n // s) if n_out is None else n_out
    want = np.array([[int(x[r, j * s:min(j * s + w, n)].sum())
                      for j in range(n_out)] for r in range(3)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        window_sums(torch.from_numpy(x[1]), w, s, n_out).numpy(), want[1])


@pytest.mark.parametrize("length,w,inc", [(1, 1000, 37), (4, 3, 2),
                                           (12345, 1000, 37),
                                           (12345, 2500, 50)])
def test_int32_extremes_match_jax_numpy(monkeypatch, length, w, inc):
    """int32 tracks across the whole range (sums far past int32) against
    the JAX package's exact host twin; the sums against Python's."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    rng = np.random.default_rng([length, w])
    d, m = rng.integers(-2 ** 31, 2 ** 31, size=(2, length), dtype=np.int64)
    d[:length // 2] = 2 ** 31 - 1
    m[:length // 2] = -2 ** 31
    d, m = d.astype(np.int32), m.astype(np.int32)
    for g, a in zip(window_stats(d, m, w, inc),
                    jws.window_stats_numpy(d, m, w, inc)):
        np.testing.assert_array_equal(g, a)
    nw = jws.n_windows(length, w, inc)
    got = window_sums(torch.from_numpy(np.stack([d, m])), w, inc, nw)
    want = [[int(a[j * inc:j * inc + w].astype(np.int64).sum())
             for j in range(nw)] for a in (d, m)]
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("bad", ["dtype", "dim", "noncontig", "window",
                                 "stride", "n_out", "device"])
def test_wrapper_rejects_bad_input(bad):
    x = torch.zeros((2, 100), dtype=torch.int32)
    w, s, n_out = 10, 1, None
    if bad == "dtype":
        x = x.to(torch.float32)
    elif bad == "dim":
        x = x.reshape(2, 10, 10)
    elif bad == "noncontig":
        x = torch.zeros((100, 2), dtype=torch.int32).t()
    elif bad == "window":
        w = 0
    elif bad == "stride":
        s = 0
    elif bad == "n_out":
        n_out = 0
    elif bad == "device":
        x = torch.zeros((2, 100), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, TypeError)):
        window_sums(x, w, s, n_out)


def test_resolve_backend(monkeypatch, capsys):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    assert resolve_backend("auto") == "torch"
    assert resolve_backend("numpy") == "numpy"
    with pytest.raises(SystemExit) as e:
        resolve_backend("jax")
    assert e.value.code == 1
    assert "not available in cornetto_tpu_torch" in capsys.readouterr().err
    # no card and no CORNETTO_FORCE_CPU: auto raises, never picks numpy
    monkeypatch.delenv("CORNETTO_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CORNETTO_FORCE_CPU"):
        resolve_backend("auto")
    d, m = _tracks(100)
    with pytest.raises(RuntimeError, match="CORNETTO_FORCE_CPU"):
        window_stats(d, m, 10, 5)
