"""The port's CUDA kernels against their plain PyTorch versions on the card:
minimizer extraction, window sums and window stats, the SDUST DP (against
the port's sequential native DP too) and the two telomere kernels.
Integers and booleans throughout; tolerance: exact equality.  Inputs from a
numpy seed.

Every test is marked ``cuda`` and skips without a card.  The file imports
neither ``jax`` nor ``cornetto_tpu`` and uses no fixture of
``tests/conftest.py``, so it runs where JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

(``chip_smoke.py`` runs exactly that.)  The CPU tests of the same modules
hold the plain versions against the JAX package."""

import numpy as np
import pytest
import torch

from cornetto_tpu_torch.kernels.extract import (extract_minima,
                                                extract_minima_ref)
from cornetto_tpu_torch.kernels.minimizer import pack_reads
from cornetto_tpu_torch.kernels.sdust import (BUDGET_MAX, BUDGET_MIN,
                                              sdust_device, sdust_dp,
                                              sdust_dp_ref)
from cornetto_tpu_torch.kernels.telo import (telo_match_mask,
                                             telo_match_mask_ref,
                                             telo_run_stats,
                                             telo_run_stats_ref)
from cornetto_tpu_torch.kernels.window_sum import (n_windows, window_stats,
                                                   window_stats_numpy,
                                                   window_sums,
                                                   window_sums_ref)
from cornetto_tpu_torch.native.sdust import sdust

pytestmark = pytest.mark.cuda

ACGT = np.array(list("ACGT"))
TTAGGG = (3, 3, 0, 2, 2, 2)
CCCTAA = (1, 1, 1, 3, 0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------- extraction

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


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B,L,k,w", PARAMS + [(4096, 450, 15, 10),
                                             (512, 1800, 15, 10)])
def test_extract_kernel_matches_plain(cuda_device, B, L, k, w, variant):
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


# ---------------------------------------------------------------- window sum

WINDOWS = [(2500, 50), (999, 37), (1000, 37), (1, 1), (64, 64)]


def _tracks(n, dtype=np.int32, seed=0):
    rng = np.random.default_rng([seed, n])
    return (rng.integers(0, 65536, size=n).astype(dtype),
            rng.integers(0, 65536, size=n).astype(dtype))


def _check_window_sums(x, w, s):
    nw = n_windows(x.shape[-1], w, s) if s > 1 else x.shape[-1]
    before = window_sums.launches
    got = window_sums(x, w, s, nw)
    torch.cuda.synchronize()
    assert window_sums.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == x.shape[:-1] + (nw,)
    assert torch.equal(got, window_sums_ref(x, w, s, nw))


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint16])
@pytest.mark.parametrize("n,w,s,rows", [(1 << 24, 2500, 1, 1),
                                        (12_345_678, 2500, 50, 2),
                                        (1_000_003, 999, 37, 2),
                                        (1_000_003, 1000, 37, 2),
                                        (100_000, 1, 1, 2),
                                        (3_000_017, 40000, 50, 2),
                                        (1000, 2500, 50, 2),
                                        (3, 2, 1, 3),
                                        (7, 5, 3, 2)])
def test_window_sum_kernel_matches_plain(cuda_device, n, w, s, rows, dtype):
    """W % S != 0 at (1000, 37) on an odd n; n = 3 and 7 are shorter than
    one 16-byte vector of either type, and every row but the first of an
    odd n starts off a 16-byte boundary."""
    rng = np.random.default_rng([n, w, s])
    x = torch.from_numpy(rng.integers(0, 65536, size=(rows, n)).astype(
        np.int32)).to(dtype).to(cuda_device)
    _check_window_sums(x, w, s)


@pytest.mark.parametrize("n,w,s,rows", [(2_000_003, 1000, 37, 2),
                                        (2_000_003, 2500, 50, 2),
                                        (5, 3, 2, 2)])
def test_window_sum_kernel_int32_extremes(cuda_device, n, w, s, rows):
    """int32 values across the whole range: the sums need int64 inside the
    chunk, not only in the carry."""
    rng = np.random.default_rng([n, w, s, 32])
    a = rng.integers(-2 ** 31, 2 ** 31, size=(rows, n), dtype=np.int64)
    a[0, :n // 2] = 2 ** 31 - 1          # window sums far past int32
    a[-1, :n // 2] = -2 ** 31
    _check_window_sums(torch.from_numpy(a.astype(np.int32)).to(cuda_device),
                       w, s)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint16])
@pytest.mark.parametrize("offset", [1, 3, 5])
def test_window_sum_kernel_unaligned_view(cuda_device, dtype, offset):
    """A contiguous view that starts off a 16-byte boundary."""
    rng = np.random.default_rng([offset, 5])
    base = torch.from_numpy(rng.integers(0, 65536, size=300_011).astype(
        np.int32)).to(dtype).to(cuda_device)
    _check_window_sums(base[offset:], 1000, 37)


def test_window_stats_on_card(cuda_device):
    d, m = _tracks(2_000_003, np.uint16, seed=9)
    for w, inc in WINDOWS + [(40000, 50)]:
        for g, a in zip(window_stats(d, m, w, inc),
                        window_stats_numpy(d, m, w, inc)):
            np.testing.assert_array_equal(g, a)


# ---------------------------------------------------------------- SDUST

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
    if name == "with_ns":
        base = list(_satellite(np.random.default_rng(12), 10_000, dense=0.5))
        for lo, hi in ((900, 902), (4_000, 4_200), (7_777, 7_790)):
            base[lo:hi] = "N" * (hi - lo)
        return "".join(base).encode(), 128, 64, 20
    if name == "homopolymer":
        return b"A" * 5000, 128, 64, 20
    if name.startswith("fuzz"):
        seq, core = _fuzz(int(name[4:]))
        return seq, core, 64, 20
    raise ValueError(name)


@pytest.mark.parametrize("W,T,core", [(64, 20, 512), (32, 14, 64),
                                      (66, 20, 132), (64, 20, 2048)])
def test_sdust_kernel_matches_plain(cuda_device, W, T, core):
    clen = 4 * W + core + W + 8
    rows = torch.from_numpy(_rows(np.random.default_rng([W, core]), 140,
                                  clen)).to(cuda_device)
    codes = rows.reshape(-1)
    off = torch.arange(140, device=cuda_device) * clen
    before = sdust_dp.launches
    got = sdust_dp(codes, off, clen, T, W)
    torch.cuda.synchronize()
    assert sdust_dp.launches == before + 2      # light and heavy passes
    for g, w in zip(got, sdust_dp_ref(codes, off, clen, T, W)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("budget", [0, 1, BUDGET_MIN, BUDGET_MAX,
                                    1 << 30])
def test_sdust_two_pass_kernel_matches_plain_across_budget(cuda_device,
                                                           budget):
    """Rows past the light pass's budget go to the heavy pass (one warp per
    row); the result is the plain version's whatever the budget, and budget
    0 is the light pass alone."""
    W, T, clen = 64, 20, 4 * 64 + 2048 + 64 + 8
    rows = torch.from_numpy(_rows(np.random.default_rng([7, budget]), 140,
                                  clen)).to(cuda_device)
    codes = rows.reshape(-1)
    off = torch.arange(140, device=cuda_device) * clen
    *want, steps = sdust_dp_ref(codes, off, clen, T, W, return_steps=True)
    over = int((steps > budget).sum()) if budget else 0
    assert 0 < over < 140 or budget in (0, 1 << 30)
    before, stats = sdust_dp.launches, {}
    got = sdust_dp(codes, off, clen, T, W, budget=budget, stats=stats)
    torch.cuda.synchronize()
    assert sdust_dp.launches == before + (1 if budget == 0 else 2)
    assert stats["heavy_rows"] == over
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sdust_device_matches_native_on_card(cuda_device):
    for name in ("dense_satellite", "with_ns", "homopolymer", "fuzz3"):
        seq, core, W, T = _suite(name)
        assert sdust_device(seq, T=T, W=W, core=core,
                            device=cuda_device) == sdust(seq, T=T, W=W)


# ---------------------------------------------------------------- telomere

def _codes(rng, B, L, motif=TTAGGG):
    """tests/test_pallas_telo.py's reads: codes 0-4 (4 = N) with a
    terminal, an internal and a tail run planted."""
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    telo = np.tile(np.array(motif, np.uint8), min(60, L // 12))
    codes[0, :len(telo)] = telo
    codes[1 % B, 37:37 + len(telo)] = telo
    codes[2 % B, L - len(telo):] = telo
    return codes


@pytest.mark.parametrize("B,L", [(4096, 450), (4096, 1800), (7, 300),
                                 (3, 5), (1, 10_000_019)])
def test_telo_kernels_match_plain(cuda_device, B, L):
    rng = np.random.default_rng([B, L])
    codes = torch.from_numpy(_codes(rng, B, L)).to(cuda_device)
    for motif in (TTAGGG, CCCTAA):
        before = (telo_match_mask.launches, telo_run_stats.launches)
        got_m = telo_match_mask(codes, motif)
        got_s = telo_run_stats(codes, motif)
        torch.cuda.synchronize()
        assert (telo_match_mask.launches, telo_run_stats.launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(got_m, telo_match_mask_ref(codes, motif))
        for g, w in zip(got_s, telo_run_stats_ref(codes, motif)):
            assert torch.equal(g, w)
