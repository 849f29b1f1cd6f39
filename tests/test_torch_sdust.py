"""SDUST DP of the port (cornetto_tpu_torch.kernels.sdust) against the JAX
package: the plain lane-parallel DP against sdust_pallas_chunks in
interpret mode (per-row intervals and overflow mask), and sdust_device
against the sequential native DP on the inputs of
tests/test_pallas_sdust.py at core 128-512.  Integers throughout; tolerance:
exact equality.  Inputs from a numpy seed.  On the CPU the wrapper runs its
plain PyTorch version; the CUDA kernel is held against that version on the
card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from cornetto_tpu.kernels.pallas_sdust import sdust_pallas_chunks
from cornetto_tpu.kernels.sdust_chunked import plan_chunks
from cornetto_tpu.native.sdust import sdust
from cornetto_tpu_torch.kernels.sdust import (check_window, max_intervals,
                                              plan_rows, sdust_chunks,
                                              sdust_chunks_ref, sdust_device,
                                              sdust_dp, sdust_dp_ref)

ACGT = np.array(list("ACGT"))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain versions run many small ops that gain nothing from torch's
    intra-op threads, and the suite's parallel workers would oversubscribe
    the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _satellite(rng, n, unit="ATTCC", seg=1200, dense=0.6):
    """tests/test_pallas_sdust.py's generator: satellite and random
    segments."""
    parts, tot = [], 0
    while tot < n:
        if rng.random() < dense:
            parts.append((unit * (seg // len(unit) + 1))[:seg])
        else:
            parts.append("".join(ACGT[rng.integers(0, 4, seg)]))
        tot += seg
    return "".join(parts)[:n]


def _rows(rng, n, clen):
    """Rows of every kind: random, short-period repeats, homopolymers,
    interior Ns, separated homopolymer bursts (more intervals than a row
    holds: overflow rows), leading N runs, 70% poly-A."""
    rows = rng.integers(0, 4, size=(n, clen)).astype(np.uint8)
    for r in range(n):
        kind = r % 7
        if kind == 1:
            unit = rng.integers(0, 4, rng.integers(1, 7))
            rows[r] = np.tile(unit, clen)[:clen]
        elif kind == 2:
            rows[r] = rng.integers(0, 4)
        elif kind == 3:
            rows[r, rng.integers(0, clen, 6)] = 4
        elif kind == 4:
            for j, s in enumerate(range(0, clen - 10, 20)):
                rows[r, s:s + 8] = j % 4
        elif kind == 5:
            rows[r, :rng.integers(0, clen)] = 4
        elif kind == 6:
            rows[r] = np.where(rng.random(clen) < 0.7, rows[r], 0)
    return rows


@pytest.mark.parametrize("W,T,core", [(64, 20, 128), (20, 3, 40)])
def test_chunks_match_pallas(W, T, core):
    """(20, 3, 40): a threshold below 5, where the JAX kernel departs from
    the sequential DP; the port keeps the JAX kernel's result."""
    rng = np.random.default_rng([W, T])
    clen = 4 * W + core + W + 8
    rows = _rows(rng, 28, clen)
    want, want_over = sdust_pallas_chunks(rows, T=T, W=W, interpret=True,
                                          lanes=128)
    assert want_over.any() or W != 64       # the overflow rule is exercised
    before = sdust_dp.launches
    got, over = sdust_chunks(torch.from_numpy(rows), T=T, W=W)
    assert sdust_dp.launches == before          # CPU: no kernel launch
    assert got == want
    np.testing.assert_array_equal(over, want_over)
    assert sdust_chunks_ref(torch.from_numpy(rows), T=T, W=W)[0] == want


def _fuzz(trial):
    """tests/test_pallas_sdust.py::test_fuzz_mixed's sequences (seed 14),
    with the chunk core capped at 256."""
    rng = np.random.default_rng(14)
    for t in range(trial + 1):
        parts = []
        for _ in range(rng.integers(2, 6)):
            kind = rng.integers(0, 4)
            n = int(rng.integers(150, 1500))
            if kind == 0:
                parts.append("".join(ACGT[rng.integers(0, 4, n)]))
            elif kind == 1:
                u = "".join(ACGT[rng.integers(0, 4, rng.integers(2, 7))])
                parts.append((u * (n // len(u) + 1))[:n])
            elif kind == 2:
                parts.append("N" * int(rng.integers(1, 80)))
            else:
                parts.append(_satellite(rng, n, seg=173))
        core = int(rng.integers(128, 1024))
    return "".join(parts).encode(), min(core, 256)


def _suite(name):
    """(sequence, core, W, T) of one case."""
    if name == "dense_satellite":
        return _satellite(np.random.default_rng(10), 12_000).encode(), \
            128, 64, 20
    if name == "pure_repeat":
        return ("ATT" * 4000).encode(), 128, 64, 20
    if name == "random_sparse":
        rng = np.random.default_rng(11)
        return "".join(ACGT[rng.integers(0, 4, 8_000)]).encode(), 512, 64, 20
    if name == "with_ns":
        base = list(_satellite(np.random.default_rng(12), 10_000, dense=0.5))
        for lo, hi in ((900, 902), (4_000, 4_200), (7_777, 7_790)):
            base[lo:hi] = "N" * (hi - lo)
        return "".join(base).encode(), 128, 64, 20
    if name == "all_n":
        return b"N" * 500, 128, 64, 20
    if name == "homopolymer":
        return b"A" * 5000, 128, 64, 20
    if name == "w32_t14":
        rng = np.random.default_rng(15)
        return (_satellite(rng, 6_000, unit="AT", seg=700)
                + "".join(ACGT[rng.integers(0, 4, 2000)])).encode(), 64, 32, 14
    if name.startswith("fuzz"):
        seq, core = _fuzz(int(name[4:]))
        return seq, core, 64, 20
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "dense_satellite", "pure_repeat", "random_sparse", "with_ns", "all_n",
    "homopolymer", "w32_t14", "fuzz0", "fuzz1", "fuzz2", "fuzz3"])
def test_device_matches_native(monkeypatch, name):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    seq, core, W, T = _suite(name)
    stats = {}
    got = sdust_device(seq, T=T, W=W, core=core, stats=stats)
    assert got == sdust(seq, T=T, W=W)
    if name == "homopolymer":        # a P of ~1700 entries in the C
        assert got == [(0, 5000)] and stats["overflow_rows"] == 0


def test_short_and_edges(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    rng = np.random.default_rng(13)
    for n in (0, 1, 2, 3, 7, 63, 64, 65, 200):
        seq = "".join(ACGT[rng.integers(0, 4, n)]).encode() if n else b""
        assert sdust_device(seq, core=128) == sdust(seq)


@pytest.mark.parametrize("n,W,core", [(5000, 64, 512), (3000, 32, 128),
                                      (100, 64, 128)])
def test_plan_rows_are_the_pallas_rows(n, W, core):
    """Row r of plan_rows' padded codes is sdust_pallas' row r (pad_left =
    4W - (a - c0), N elsewhere)."""
    rng = np.random.default_rng([16, n])
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.integers(0, n, 5)] = 4
    chunks, host, padded, off, clen = plan_rows(codes, W, core)
    assert (chunks, host) == plan_chunks(codes, core, W)
    assert clen == 4 * W + core + W + 8 and len(off) == len(chunks)
    for (a, _b, c0, stop), o in zip(chunks, off):
        row = np.full(clen, 4, dtype=np.uint8)
        pad_left = 4 * W - (a - c0)
        row[pad_left:pad_left + stop - c0] = codes[c0:stop]
        assert np.array_equal(padded[o:o + clen], row)
    assert plan_rows(np.zeros(0, np.uint8), W, core)[2:4] == (None, None)


def test_overflow_rows_rerun_on_host(monkeypatch):
    """Rows with more intervals than MAXI go to the native DP."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    burst = "".join(c * 8 + "ACGTACGTCAGT" for c in "ACGT" * 12)
    seq = (burst * 3).encode()
    stats = {}
    assert sdust_device(seq, core=512, stats=stats) == sdust(seq)
    assert stats["overflow_rows"] > 0 and stats["chunks"] == 6


@pytest.mark.parametrize("W", [2, 67, 80])
def test_rejects_window_outside_ring(monkeypatch, W):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    with pytest.raises(ValueError, match="3..66"):
        check_window(W)
    with pytest.raises(ValueError, match="3..66"):
        sdust_device(b"ACGT" * 100, W=W, core=256)
    codes = torch.zeros(500, dtype=torch.uint8)
    with pytest.raises(ValueError, match="3..66"):
        sdust_dp(codes, torch.zeros(1, dtype=torch.int64), 100, W=W)


@pytest.mark.parametrize("T", [0, 3, 4])
def test_device_rejects_threshold_below_5(monkeypatch, T):
    """Below T = 5 an eviction can empty the window; the JAX kernel's sweep
    then skips row 0 and departs from the sequential DP, so sdust_device
    refuses (sdust_dp keeps the JAX kernel's result: test_chunks_match_pallas
    at T = 3)."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    seq = "".join(ACGT[np.random.default_rng(T).integers(0, 4, 1500)])
    with pytest.raises(ValueError, match="below 5"):
        sdust_device(seq.encode(), T=T, core=512)


def test_threshold_5_matches_native(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    seq = _satellite(np.random.default_rng(17), 3000, dense=0.3).encode()
    assert sdust_device(seq, T=5, core=128) == sdust(seq, T=5)


def test_window_66_is_the_widest(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    seq = _satellite(np.random.default_rng(16), 3000, dense=0.5).encode()
    assert sdust_device(seq, W=66, core=132) == sdust(seq, W=66)


@pytest.mark.parametrize("bad", ["dtype", "dim", "off_dtype", "noncontig",
                                 "clen", "device", "past_end", "budget"])
def test_wrapper_rejects_bad_input(bad):
    codes = torch.zeros(1000, dtype=torch.uint8)
    off = torch.tensor([0, 500], dtype=torch.int64)
    clen = 300
    budget = None
    if bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "dim":
        codes = codes.reshape(10, 100)
    elif bad == "off_dtype":
        off = off.to(torch.int32)
    elif bad == "noncontig":
        codes = torch.zeros((1000, 2), dtype=torch.uint8)[:, 0]
    elif bad == "clen":
        clen = 0
    elif bad == "device":
        codes = torch.zeros(1000, dtype=torch.uint8, device="meta")
        off = off.to("meta")
    elif bad == "past_end":
        clen = 600
    elif bad == "budget":
        budget = -1
    with pytest.raises((ValueError, TypeError)):
        sdust_dp(codes, off, clen, budget=budget)


def test_ref_counts_find_perfect_row_steps():
    """The plain version counts each row's find_perfect row-steps (the work
    the light pass budgets): none on random sequence, about a window's rows
    a base on a homopolymer, the same rows as the result without counts."""
    rng = np.random.default_rng(3)
    clen, W = 600, 64
    rows = np.stack([rng.integers(0, 4, clen), np.zeros(clen, np.int64),
                     np.tile([0, 1], clen // 2)]).astype(np.uint8)
    codes = torch.from_numpy(rows.reshape(-1))
    off = torch.arange(3, dtype=torch.int64) * clen
    *got, steps = sdust_dp_ref(codes, off, clen, 20, W, return_steps=True)
    for g, w in zip(got, sdust_dp_ref(codes, off, clen, 20, W)):
        assert torch.equal(g, w)
    assert steps.dtype == torch.int64 and steps.shape == (3,)
    assert int(steps[0]) < clen
    assert int(steps[1]) > 40 * clen and int(steps[2]) > 20 * clen


def test_max_intervals():
    assert max_intervals(2376) == 49       # CLEN at W=64, core=2048
    assert max_intervals(456) == 16
