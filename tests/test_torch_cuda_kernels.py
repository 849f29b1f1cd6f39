"""The port's CUDA kernels against their plain PyTorch versions on the card:
minimizer extraction, the fused decision step (extraction, lookup, votes
and policy in one launch), the sharded engine's shard-masked votes and its
policy, window sums and window stats, the SDUST DP (against the port's
sequential native DP too) and the two telomere kernels; and every entry
point at the ragged shapes of tests/_torch_ragged_cases.py with the caching
allocator's free blocks poisoned first, so that an output element a kernel
leaves unwritten differs from the plain version, and again with every
tensor against an unmapped guard region (tests/_torch_fence_alloc.c), so
that an access outside a tensor faults.
Integers and booleans throughout; tolerance: exact equality.  Inputs from a
numpy seed.

Every test is marked ``cuda`` and skips without a card.  The file imports
neither ``jax`` nor ``cornetto_tpu`` and uses no fixture of
``tests/conftest.py``, so it runs where JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

(``chip_smoke.py`` runs exactly that.)  The CPU tests of the same modules
hold the plain versions against the JAX package."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cornetto_tpu_torch.kernels.decide import decide_packed, decide_packed_ref
from cornetto_tpu_torch.kernels.extract import (extract_minima,
                                                extract_minima_ref)
from cornetto_tpu_torch.kernels.minimizer import pack_reads
from cornetto_tpu_torch.kernels.sdust import (BUDGET_MAX, BUDGET_MIN,
                                              sdust_device, sdust_dp,
                                              sdust_dp_ref)
from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                              policy_from_stats_ref,
                                              shared_limit, sharded_votes,
                                              sharded_votes_ref)
from cornetto_tpu_torch.kernels.telo import (telo_match_mask,
                                             telo_match_mask_ref,
                                             telo_match_positions,
                                             telo_run_stats,
                                             telo_run_stats_ref)
from cornetto_tpu_torch.kernels.window_sum import (n_windows, window_stats,
                                                   window_stats_numpy,
                                                   window_sums,
                                                   window_sums_ref)
from cornetto_tpu_torch.native.sdust import sdust
import _decide_cases as dc  # tests/, on sys.path under pytest
import _torch_ragged_cases as rc

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

# lanes a read (csrc/minimizer.cuh's group_size): 16 at L = 450, 32 at
# L = 300 and 1024, 8 at 1800 and in the last two, whose windows span
# more than 32 bases (w + k - 1 > 32) and are read a word at a time
PARAMS = [
    (64, 450, 15, 10),
    (32, 300, 15, 10),
    (16, 1024, 13, 8),
    (8, 200, 15, 12),
    (8, 300, 15, 40),
    (5, 97, 1, 33),
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


# ---------------------------------------------------------- fused decision

# (C, two_choice, bases besides the last contig, slots a bucket): both
# sides of the plain version's one-hot / scatter switch (C <= 64), a table
# at high occupancy (hits split across the two probes), 8 and 16 slots
DECIDE_CASES = [(c, tc, 60_000, 4) for c in (3, 64, 65, 300)
                for tc in (True, False)] + \
    [(4, True, 3_000_000, 4), (5, True, 60_000, 8), (5, False, 60_000, 16)]


@functools.lru_cache(maxsize=None)
def _decide_index(case, L):
    C, two_choice, total, slots = case
    return dc.index(8, C, two_choice, L=L, slots=slots, total=total)


def _check_decide(dev, case, variant, min_hits, B=64, L=450):
    """decide_packed on the card, both output forms, against
    decide_packed_ref on the same tensors; one launch a call."""
    idx, panel, codes = _decide_index(case, L)
    packed, nmask, lengths, rows = dc.batch(8, idx, panel, codes, variant,
                                            B=B, L=L)
    put = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa
    args = (put(idx.btable[0]), put(packed), put(nmask), put(panel))
    kw = dict(L=L, k=idx.k, w=idx.w, min_hits=min_hits, bin_size=1000,
              bucket_shift=idx.bucket_shift, two_choice=idx.two_choice,
              lengths=put(lengths))
    for fused in (False, True):
        before = decide_packed.launches
        got = decide_packed(*args, fused=fused, **kw)
        torch.cuda.synchronize()
        assert decide_packed.launches == before + 1
        want = decide_packed_ref(*args, fused=fused, **kw)
        if fused:
            assert got.shape == (2, B) and got.dtype == torch.int32
            assert torch.equal(got, want)
        else:
            assert len(got) == 6
            for g, r in zip(got, want):
                assert g.dtype == r.dtype and torch.equal(g, r)
    return got, rows


@pytest.mark.parametrize("min_hits", [0, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", DECIDE_CASES)
def test_decide_kernel_matches_plain(cuda_device, case, variant, min_hits):
    _check_decide(cuda_device, case, variant, min_hits)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B,L", [(4096, 450), (512, 1800), (1000, 450)])
def test_decide_kernel_main_path_shapes(cuda_device, B, L, variant):
    """The decision loop's batch, the chunk engine's longest read and a
    short tail, on the C = 3 draft."""
    fused, rows = _check_decide(cuda_device, DECIDE_CASES[0], variant, 3,
                                B=B, L=L)
    nhits = (fused[0] >> 16) & 0x3FFF
    assert int((nhits[rows["genomic"]] > 0).sum()) > len(rows["genomic"]) // 2


def test_decide_kernel_rejects_a_misaligned_table(cuda_device):
    idx, panel, codes = _decide_index(DECIDE_CASES[0], 450)
    packed, _, _, _ = dc.batch(8, idx, panel, codes, "nfree")
    flat = torch.from_numpy(idx.btable[0]).to(cuda_device).reshape(-1)
    rows = idx.btable.shape[1] // 2                  # a power of two
    view = flat[1:1 + rows * 8].reshape(rows, 8)     # 4 bytes off
    assert view.is_contiguous() and view.data_ptr() % 16
    before = decide_packed.launches
    with pytest.raises(ValueError):
        decide_packed(view, torch.from_numpy(packed).to(cuda_device), None,
                      torch.from_numpy(panel).to(cuda_device), L=450,
                      k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
                      bucket_shift=idx.bucket_shift,
                      two_choice=idx.two_choice)
    assert decide_packed.launches == before


def test_engine_decides_a_batch_in_one_launch(cuda_device):
    """SingleChipEngine on the card: decide_packed_fused and decide_packed
    each launch the fused kernel once and extraction never."""
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    idx, panel, codes = _decide_index(DECIDE_CASES[0], 450)
    packed, nmask, lengths, _ = dc.batch(8, idx, panel, codes, "lengths")
    eng = SingleChipEngine(idx, panel, device=cuda_device)
    before = (decide_packed.launches, extract_minima.launches)
    fused = eng.decide_packed_fused(packed, None, 450, lengths=lengths)
    six = eng.decide_packed(packed, None, 450, lengths=lengths)
    torch.cuda.synchronize()
    assert (decide_packed.launches, extract_minima.launches) == (
        before[0] + 2, before[1])
    assert torch.equal(fused[0] & 0xFFFF, six[1])
    assert torch.equal(fused[1], six[2])


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


def _motif(name):
    """TTAGGG, the self-overlapping AAAAAA and TATATA, or k seeded codes
    (k = 1, 16 and 17 about the 16-code template, 37, 64 and 65 about the
    staged halo, 100 past it)."""
    if name == "TTAGGG":
        return TTAGGG
    if name == "AAAAAA":
        return (0,) * 6
    if name == "TATATA":
        return (3, 0) * 3
    k = int(name[1:])
    return tuple(np.random.default_rng([k, 3]).integers(0, 4, k).tolist())


def _planted(rng, B, L, motif):
    """Codes 0-4 with the motif at the start, in a tandem array and at the
    end of each row, so that every motif length matches."""
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    m = np.array(motif, np.uint8)
    k = len(m)
    for r in range(B):
        if L >= k:
            c = max(1, min(L // k, 4))
            s = int(rng.integers(0, L - c * k + 1))
            codes[r, s:s + c * k] = np.tile(m, c)
            codes[r, :k] = m
            codes[r, L - k:] = m
    return codes


def _check_mask(codes, motif):
    """Kernel against the plain mask, and the positions of the flat array
    against nonzero of the plain mask of it as one row."""
    before = telo_match_mask.launches
    got = telo_match_mask(codes, motif)
    torch.cuda.synchronize()
    assert telo_match_mask.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == codes.shape
    assert torch.equal(got, telo_match_mask_ref(codes, motif))
    flat = codes.reshape(-1)
    pos = telo_match_positions(flat, motif)
    want = torch.nonzero(telo_match_mask_ref(flat.reshape(1, -1), motif)[0],
                         as_tuple=True)[0]
    assert pos.dtype == torch.int64 and torch.equal(pos, want)
    return int(got.sum())


@pytest.mark.parametrize("motif", ["TTAGGG", "AAAAAA", "TATATA", "k1", "k16",
                                   "k17", "k37", "k64", "k65", "k100"])
@pytest.mark.parametrize("B,L", [(4097, 451), (3, 17), (2, 5), (1, 15),
                                 (1, 1_000_003)])
def test_telo_mask_kernel_shapes_and_motifs(cuda_device, B, L, motif):
    """Rows of odd length, rows shorter than a thread's 16 positions, L < k,
    motif lengths about the kernel's 16-code template and its 64-code staged
    halo, and self-overlapping motifs."""
    mt = _motif(motif)
    rng = np.random.default_rng([B, L, len(mt)])
    n = _check_mask(torch.from_numpy(_planted(rng, B, L, mt)).to(cuda_device),
                    mt)
    assert n > 0 or L < len(mt)


@pytest.mark.parametrize("offset", list(range(1, 16)))
def test_telo_mask_kernel_unaligned_view(cuda_device, offset):
    """Contiguous views that start 1-15 bytes past a 16-byte boundary, as
    one row and as (7, 4999) rows, with motifs inside and past the staged
    halo."""
    rng = np.random.default_rng([offset, 11])
    for motif in (TTAGGG, CCCTAA, _motif("k37"), _motif("k100")):
        base = torch.from_numpy(_planted(rng, 1, 35_008, motif)).to(
            cuda_device).reshape(-1)
        view = base[offset:offset + 34_993]
        assert view.data_ptr() % 16 == offset % 16 and view.is_contiguous()
        assert _check_mask(view.reshape(1, -1), motif) > 0
        _check_mask(view.reshape(7, 4999), motif)


# ------------------------------------------------------- telomere run stats

def _runs_across(rng, B, L, motif):
    """Codes 0-4 where every row holds stride-k runs placed to cross the
    bitset's 32-position words and its 32-lane groups (1,024 positions): a
    run ending on each boundary, one starting on it and one spanning it,
    a run at position 0 and one ending at the row's last start."""
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    m = np.array(motif, np.uint8)
    k = len(m)
    if L < k:
        return codes
    for r in range(B):
        c = int(rng.integers(1, max(2, L // k // 2)))
        for edge in (32, 64, 512, 1024):
            if edge >= L:
                break
            s = [edge - c * k, edge, edge - (c * k) // 2][r % 3]
            s = max(0, min(s, L - c * k))
            codes[r, s:s + c * k] = np.tile(m, c)
        codes[r, :k * min(c, L // k)] = np.tile(m, min(c, L // k))
        codes[r, L - k:] = m
    return codes


@pytest.mark.parametrize("motif", ["TTAGGG", "CCCTAA", "AAAAAA", "k1", "k16",
                                   "k17", "k64", "k65"])
@pytest.mark.parametrize("B,L", [(64, 31), (64, 32), (64, 33), (64, 63),
                                 (64, 64), (64, 65), (257, 450), (32, 1024),
                                 (32, 1025), (8, 4096), (8, 4097), (3, 5)])
def test_telo_run_stats_kernel_word_and_lane_boundaries(cuda_device, B, L,
                                                        motif):
    """Both routes against the plain version: the bitset (rows of up to
    4,096 bases, motifs of up to 64 codes) and the row walk (longer rows,
    and motifs past 64 codes, read from device memory), on runs that cross
    a word or a lane."""
    mt = CCCTAA if motif == "CCCTAA" else _motif(motif)
    rng = np.random.default_rng([B, L, len(mt), 5])
    codes = torch.from_numpy(_runs_across(rng, B, L, mt)).to(cuda_device)
    for mrb in (24, 12, 0):
        want = telo_run_stats_ref(codes, mt, mrb)
        before = telo_run_stats.launches
        got = telo_run_stats(codes, mt, mrb)
        torch.cuda.synchronize()
        assert telo_run_stats.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(want[0].sum()) > 0 or L < len(mt)


@pytest.mark.parametrize("B,L", [(4096, 450), (4096, 1800), (8, 100_003)])
def test_telo_run_stats_one_launch_no_upload(cuda_device, monkeypatch, B, L):
    """A call is one device kernel: no motif upload (a motif of up to 64
    codes is a kernel argument), no cast of the terminal flags, and only
    its three outputs allocated."""
    from torch.profiler import ProfilerActivity, profile
    from cornetto_tpu_torch.kernels import telo

    def no_upload(*_a):
        raise AssertionError("the motif was uploaded")
    monkeypatch.setattr(telo, "_motif_on", no_upload)
    rng = np.random.default_rng([B, L, 9])
    codes = torch.from_numpy(_codes(rng, B, L)).to(cuda_device)
    telo_run_stats(codes, TTAGGG)               # build and load first
    torch.cuda.synchronize()
    # the first profiler session of a process may start its device tracing
    # after the call (it once saw no device event): a first session primes
    # it
    with profile(activities=[ProfilerActivity.CUDA]):
        telo_run_stats(codes, TTAGGG)
        torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = telo_run_stats(codes, TTAGGG)
        torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        allocs + 3
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1 and "stats" in device[0], device
    for g, w in zip(got, telo_run_stats_ref(codes, TTAGGG)):
        assert torch.equal(g, w)


# ------------------------------------------------------- read-until ticks

def _replay_reads(codes, n, seed):
    """n reads of 600-2,400 bases of the draft's contigs, ACGT only."""
    rng = np.random.default_rng([seed, 19])
    out = []
    for i in range(n):
        c = codes[int(rng.integers(0, len(codes)))]
        ln = int(rng.integers(600, 2401))
        s = int(rng.integers(0, max(len(c) - ln, 0) + 1))
        out.append(("r%d" % i, "".join(ACGT[c[s:s + ln]]), False))
    return out


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("case", [DECIDE_CASES[0], DECIDE_CASES[7]])
def test_device_chunk_ticks_match_the_cpu(cuda_device, case, depth):
    """DeviceChunkEngine on the card (scatter, gather and the fused kernel
    a tick, one launch a batch) against ChunkDecisionEngine on the CPU:
    the same replay metrics and decisions."""
    from cornetto_tpu_torch.livefish import chunks
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    idx, panel, codes = _decide_index(case, 448)
    reads = _replay_reads(codes, 60, case[0])
    got = {}
    for name, cls, dev in (("card", chunks.DeviceChunkEngine, cuda_device),
                           ("cpu", chunks.ChunkDecisionEngine, "cpu")):
        eng = SingleChipEngine(idx, panel, device=dev)
        ce = cls(eng, n_channels=16, chunk_len=448, batch=16,
                 policy=chunks.ChunkPolicy(max_chunks=4),
                 pipeline_depth=depth)
        decs, ticks = [], [0]
        process = ce.process

        def counted(events):
            ticks[0] += bool(events)
            out = process(events)
            decs.extend(out)
            return out
        ce.process = counted
        before = decide_packed.launches
        m = chunks.replay_read_until(ce, reads, unblock_overhead=100)
        torch.cuda.synchronize()
        got[name] = (vars(m), sorted(
            (d.read_id, d.action, d.n_chunks, d.contig, d.pos, d.nhits)
            for d in decs))
        if name == "card":
            assert decide_packed.launches - before == ticks[0] > 0
    assert got["card"] == got["cpu"]
    assert got["card"][0]["n_reads"] == 60


def test_device_chunk_tick_surfaces_a_length_the_kernel_refuses(cuda_device):
    """L = max_chunks * chunk_len past what the fused kernel's shared
    memory holds (240,000 bases: 348 KB a read's group, past the 227 KB a
    block may have) raises from the kernel's launch; nothing clamps
    it."""
    from cornetto_tpu_torch.livefish import chunks
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    idx, panel, _ = _decide_index(DECIDE_CASES[0], 450)
    eng = SingleChipEngine(idx, panel, device=cuda_device)
    ce = chunks.DeviceChunkEngine(eng, n_channels=2, chunk_len=60_000,
                                  batch=2)
    with pytest.raises(RuntimeError, match="decide kernel launch failed"):
        ce.process([chunks.ChunkEvent(0, "r0", "ACGT" * 15_000)])


# ---------------------------------------------------- sharded votes, policy

def _one_contig_index(ep, w=10):
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    codes = [np.random.default_rng(31).integers(0, 4, size=60_000,
                                                dtype=np.uint8)]
    idx = build_index([("c0", "".join(ACGT[codes[0]]))], n_shards=ep, w=w)
    return idx, build_panel_mask(idx, [("c0", 0, 30_000)]), codes


@functools.lru_cache(maxsize=None)
def _votes_case(n_ctg, ep, two_choice):
    """(the ep-shard index, its panel, 64 reads packed as (packed, nmask,
    lengths)) of a seeded draft of n_ctg contigs: tests/_decide_cases.py's
    draft and batch (ambiguous, tied and no-hit reads among them), or one
    random contig sampled plainly."""
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    if n_ctg == 1:
        idx, panel, codes = _one_contig_index(ep)
        rng = np.random.default_rng(32)
        reads = np.stack([codes[0][s:s + 450] for s in
                          rng.integers(0, 60_000 - 450, size=64)])
        reads[::7] = rng.integers(0, 4, size=reads[::7].shape)
        packed, _ = pack_reads(reads)
        return idx, panel, (packed, None, None)
    idx1, panel1, codes = dc.index(8, n_ctg, two_choice, L=450)
    packed, nmask, lengths, _ = dc.batch(8, idx1, panel1, codes, "lengths")
    names = ["c%d" % i for i in range(n_ctg)]
    idx = build_index(((n, "".join(ACGT[c])) for n, c in zip(names, codes)),
                      n_shards=ep, two_choice=two_choice)
    rows = [(n, 0, len(c)) for n, c in zip(names[::2], codes[::2])]
    return idx, build_panel_mask(idx, rows), (packed, nmask, lengths)


# (contigs in the draft, C the kernels are given): C = 1; C = 3; C = 87,
# the human-scale draft's count (the plain version's scatter-add side);
# C = 300; and one past the largest C whose planes fit shared memory
# (global atomics), with the panel padded by contigs no read hits
VOTES_C = [(1, 1), (3, 3), (87, 87), (300, 300), (3, "past")]


def _padded_panel(panel, C):
    out = np.zeros((C, panel.shape[1]), dtype=bool)
    out[:panel.shape[0]] = panel
    return out


@pytest.mark.parametrize("two_choice", [True, False])
@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("n_ctg,C", VOTES_C)
def test_sharded_votes_and_policy_match_plain(cuda_device, n_ctg, C, ep,
                                              two_choice):
    """Each shard's votes kernel against its plain version on the same card
    tensors (owner masks at ep 1, 2, 4), in one block and in ep parts; the
    planes summed over the shards through the policy kernel against the
    plain policy; one launch a call."""
    idx, panel, (packed, nmask, lengths) = _votes_case(n_ctg, ep,
                                                       two_choice)
    C = shared_limit() + 1 if C == "past" else C
    put = lambda a: None if a is None else torch.from_numpy(a).to(  # noqa
        cuda_device)
    h, v = extract_minima(put(packed), put(nmask), 450, idx.k, idx.w,
                          lengths=put(lengths))
    total = None
    for shard in range(ep):
        bt = put(np.ascontiguousarray(idx.btable[shard]))
        args = (h, v, bt, idx.bucket_shift, idx.two_choice, ep, shard, C)
        before = sharded_votes.launches
        got = sharded_votes(*args)
        parts = sharded_votes(*args, parts=ep)
        torch.cuda.synchronize()
        assert sharded_votes.launches == before + 2
        want = sharded_votes_ref(*args)
        assert got.shape == (9, 64, C) and torch.equal(got, want)
        assert torch.equal(parts, sharded_votes_ref(*args, parts=ep))
        assert torch.equal(parts.reshape(ep, 9, 64 // ep, C).transpose(0, 1)
                           .reshape(9, 64, C), got)
        total = got if total is None else total + got
    assert int(total[0].sum()) > 0
    pn = put(_padded_panel(panel, C))
    before = policy_from_stats.launches
    outs = policy_from_stats(total, pn, 3, 1000)
    torch.cuda.synchronize()
    assert policy_from_stats.launches == before + 1
    for g, r in zip(outs, policy_from_stats_ref(total.cpu(), pn.cpu(), 3,
                                                1000)):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)


@pytest.mark.parametrize("C", [3, "past"])
def test_sharded_votes_of_a_batch_with_no_hit(cuda_device, C):
    """No valid window (an all-N batch): every plane is zero in both the
    shared-memory and the global-atomics form, and the policy proceeds on
    contig 0 at position 0."""
    idx, panel, _ = _votes_case(3, 2, True)
    C = shared_limit() + 1 if C == "past" else C
    h = torch.randint(-2**31, 2**31 - 1, (64, 44), dtype=torch.int32,
                      device=cuda_device)
    v = torch.zeros((64, 44), dtype=torch.bool, device=cuda_device)
    bt = torch.from_numpy(np.ascontiguousarray(idx.btable[1])).to(
        cuda_device)
    got = sharded_votes(h, v, bt, idx.bucket_shift, True, 2, 1, C)
    assert got.shape == (9, 64, C) and not got.any()
    outs = policy_from_stats(got, torch.from_numpy(_padded_panel(
        panel, C)).to(cuda_device), 3, 1000)
    assert outs[0].tolist() == [1] * 64
    assert not any(o.any() for o in outs[1:])


@pytest.mark.parametrize("C", [1, 5, 32, 33, 87, 6457])
def test_policy_kernel_takes_the_first_maximum(cuda_device, C):
    """Votes drawn from 0..2, so most rows tie: the warp's lanes stride over
    the columns and the kernel must pick the first maximum, as argmax
    does; planes with negative (wrapped) sums and a random panel."""
    rng = np.random.default_rng(C)
    b = 257
    stats = rng.integers(-3, 2**20, size=(9, b, C)).astype(np.int32)
    stats[0] = rng.integers(0, 3, size=(b, C))
    stats[0, 0] = 2                                  # a row of all ties
    stats[0, 1, C // 2:] = 5                         # ties past lane 0
    stats[1] = rng.integers(0, 3, size=(b, C))
    panel = rng.random((C, 7)) < 0.5
    want = policy_from_stats_ref(torch.from_numpy(stats),
                                 torch.from_numpy(panel), 2, 1000)
    got = policy_from_stats(torch.from_numpy(stats).to(cuda_device),
                            torch.from_numpy(panel).to(cuda_device), 2, 1000)
    torch.cuda.synchronize()
    assert int(got[1][0]) == 0 and int(got[1][1]) == C // 2
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)


@pytest.mark.parametrize("C", [1, "past"])
def test_votes_kernels_at_long_reads(cuda_device, C):
    """Reads of 1800 bases at w = 5 (357 windows a read, eight lanes a
    group), the planes in shared memory (C = 1) and past it (global
    atomics, the panel padded): the votes kernel against its plain version
    at ep = 1, 2, in one block and in ep parts, and the policy on the
    summed planes against the plain policy."""
    L = 1800
    idx1, panel, codes = _one_contig_index(1, w=5)
    rng = np.random.default_rng(33)
    reads = np.stack([codes[0][s:s + L] for s in
                      rng.integers(0, 60_000 - L, size=32)])
    reads[::5] = rng.integers(0, 4, size=reads[::5].shape)
    packed, _ = pack_reads(reads)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    h, v = extract_minima(put(packed), None, L, idx1.k, idx1.w)
    assert h.shape[1] == 357
    C = shared_limit() + 1 if C == "past" else C
    pn = put(_padded_panel(panel, C))
    for ep in (1, 2):
        idx = idx1 if ep == 1 else _one_contig_index(ep, w=5)[0]
        total = 0
        for shard in range(ep):
            bt = put(np.ascontiguousarray(idx.btable[shard]))
            args = (h, v, bt, idx.bucket_shift, idx.two_choice, ep, shard, C)
            for parts in {1, ep}:
                got = sharded_votes(*args, parts=parts)
                torch.cuda.synchronize()
                assert torch.equal(got, sharded_votes_ref(*args,
                                                          parts=parts))
            total = total + sharded_votes(*args)
        assert int(total[0].sum()) > 0
        outs = policy_from_stats(total, pn, 3, 1000)
        want = policy_from_stats_ref(total, pn, 3, 1000)
        for g, w in zip(outs, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_sharded_votes_rejects_a_misaligned_table(cuda_device):
    idx, _, _ = _votes_case(3, 2, True)
    flat = torch.from_numpy(np.ascontiguousarray(idx.btable[0])).to(
        cuda_device).reshape(-1)
    rows = idx.btable.shape[1] // 2                  # a power of two
    view = flat[1:1 + rows * 8].reshape(rows, 8)     # 4 bytes off
    h = torch.zeros((4, 3), dtype=torch.int32, device=cuda_device)
    v = torch.ones((4, 3), dtype=torch.bool, device=cuda_device)
    before = sharded_votes.launches
    with pytest.raises(ValueError):
        sharded_votes(h, v, view, idx.bucket_shift, True, 2, 0, 3)
    assert sharded_votes.launches == before


# ------------------------------------- every output element written (0xA5)

@pytest.mark.parametrize("n", [700, 300_000, 3 << 20, 50 << 20])
def test_poison_reaches_torch_empty(cuda_device, n):
    """After poison_freed_blocks a torch.empty of the small pool (700 B,
    300 kB) or the large one (3 MiB, 50 MiB) holds 0xA5, with live inputs
    in partly used segments beside it."""
    keep = [torch.ones(m, dtype=torch.uint8, device=cuda_device)
            for m in (100, 5000, 70_000, 1_500_000)]
    rc.poison_freed_blocks(cuda_device)
    t = torch.empty(n, dtype=torch.uint8, device=cuda_device)
    assert bool((t == rc.POISON).all())
    assert all(bool((k == 1).all()) for k in keep)


@pytest.mark.parametrize("name", sorted(rc.CASES))
def test_every_output_element_written(cuda_device, name):
    """The wrapper's outputs (torch.empty) land on 0xA5 and equal the
    plain version's: no element is left unwritten, at ragged shapes."""
    assert rc.check(name, cuda_device, poison=True) == []


# ------------------------------ guard pages (tests/_torch_fence_alloc.c)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fenced(code: str, mode: str):
    """Run ``code`` in a fresh process whose allocations sit against guard
    regions (``mode`` after / before)."""
    prelude = ("import sys, torch\nsys.path.insert(0, 'tests')\n"
               "import _torch_ragged_cases as rc\n"
               "rc.install_fence(%r)\n" % mode)
    env = {k: v for k, v in os.environ.items() if k != "CORNETTO_FORCE_CPU"}
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


# window_sums' C entry point on a 4096-int32 tensor: a read of the whole
# tensor, then one of n elements from x + shift
WINDOW_READS = """
from cornetto_tpu_torch.kernels import _build
fn = _build.bind("window_sum", "cornetto_window_sums", "piilillpp")
x = torch.ones(4096, dtype=torch.int32, device="cuda")
out = torch.empty(1, dtype=torch.int64, device="cuda")
for n, shift in ((4096, 0), (%d, %d)):
    _build.launch(fn, "window_sums kernel", x.device,
                  x.data_ptr() + 4 * shift, 0, 1, n, n, 1, 1, out.data_ptr())
    torch.cuda.synchronize()
    print("sum", n, shift, int(out.item()), flush=True)
"""


@pytest.mark.parametrize("mode", ["after", "before"])
def test_guard_pages_catch_an_access_outside_a_tensor(cuda_device, mode):
    """The fence's own check, in one process: a read of the whole tensor
    passes; then one that runs a megabyte past its end (after) or starts
    a megabyte before its start (before) faults."""
    far = (4096 + (1 << 18), 0) if mode == "after" else (4096, -(1 << 18))
    proc = _fenced(WINDOW_READS % far, mode)
    assert "sum 4096 0 4096" in proc.stdout, proc.stderr[-2000:]
    assert proc.returncode != 0 and "sum %d %d" % far not in proc.stdout
    assert "illegal memory access" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("mode", ["after", "before"])
def test_ragged_cases_inside_guard_pages(cuda_device, mode):
    """Every ragged case with each tensor against a guard region: no
    kernel reads or writes past a tensor's 16-byte granule (after) or
    before its start (before), and each result equals the plain
    version's."""
    proc = _fenced("dev = torch.device('cuda')\n"
                   "for name in rc.CASES:\n"
                   "    assert rc.check(name, dev) == [], name\n"
                   "print('cases', len(rc.CASES))\n", mode)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "cases %d" % len(rc.CASES) in proc.stdout
