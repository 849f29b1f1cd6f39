"""Telomere-motif scans of the port (cornetto_tpu_torch.kernels.telo)
against the JAX package: the match mask and the run statistics against both
telo_scan functions and the Pallas kernels in interpret mode (as
tests/test_pallas_telo.py runs them), at that file's shapes plus the
doubling cap, L < k, N codes and both motifs; the contig-long mask and
the match positions against pallas_telo.telo_match_mask_long around its
65,536-base chunk; the walk over the positions against the walk over the
mask and the memchr scan (seeded and hypothesis inputs).  Integers
and booleans throughout; tolerance: exact equality.  Inputs from a numpy
seed.  On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those versions on the card
(tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from cornetto_tpu.kernels.pallas_telo import telo_match_mask_long as jax_long
from cornetto_tpu.kernels.pallas_telo import (telo_match_mask_pallas,
                                              telo_run_stats_pallas)
from cornetto_tpu.kernels.telo_scan import (telo_match_mask_jax,
                                            telo_run_stats_jax)
from cornetto_tpu_torch.kernels.minimizer import encode_bytes
from cornetto_tpu_torch.kernels.telo import (scan_runs_from_mask,
                                             scan_runs_from_positions,
                                             telo_match_mask,
                                             telo_match_mask_long,
                                             telo_match_mask_ref,
                                             telo_match_positions,
                                             telo_run_stats,
                                             telo_run_stats_ref)
from cornetto_tpu_torch.tools.telofind import scan_runs

TTAGGG = (3, 3, 0, 2, 2, 2)
CCCTAA = (1, 1, 1, 3, 0, 0)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain versions run many small ops that gain nothing from torch's
    intra-op threads, and the suite's parallel workers would oversubscribe
    the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(rng, B, L, motif=TTAGGG, plant=True):
    """tests/test_pallas_telo.py's reads: codes 0-4 (4 = N) with a
    terminal, an internal and a tail run planted."""
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    if plant:
        telo = np.tile(np.array(motif, np.uint8), min(60, L // 12))
        codes[0, :len(telo)] = telo
        codes[1 % B, 37:37 + len(telo)] = telo
        codes[2 % B, L - len(telo):] = telo
    return codes


def _assert_stats(codes, motif, min_run_bases=24, xla=True):
    want = telo_run_stats_pallas(jnp.asarray(codes), motif,
                                 min_run_bases=min_run_bases, interpret=True)
    if xla:                              # telo_scan needs L >= k
        for a, b in zip(want, telo_run_stats_jax(jnp.asarray(codes), motif,
                                                 min_run_bases)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    before = telo_run_stats.launches
    got = telo_run_stats(torch.from_numpy(codes), motif, min_run_bases)
    assert telo_run_stats.launches == before         # CPU: no kernel launch
    ref = telo_run_stats_ref(torch.from_numpy(codes), motif, min_run_bases)
    for w, g, r, dt in zip(want, got, ref,
                           (torch.int32, torch.int32, torch.bool)):
        assert g.dtype == dt and g.shape == (codes.shape[0],)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, r)
    return got


@pytest.mark.parametrize("motif", [TTAGGG, CCCTAA])
@pytest.mark.parametrize("B,L", [(4, 512), (32, 4096), (7, 300), (1, 128)])
def test_stats_match_jax(B, L, motif):
    rng = np.random.default_rng(B * 1000 + L)
    _assert_stats(_codes(rng, B, L, motif), motif)


@pytest.mark.parametrize("L,copies,longest", [(18, 3, 2), (19, 3, 2),
                                              (42, 7, 7), (24, 4, 4),
                                              (30, 5, 4), (6, 1, 1)])
def test_stats_doubling_cap(L, copies, longest):
    """The run is capped at 2^ceil(log2(max(m // k, 1))) copies: a read of
    L = 18 holding the motif 3 times reports 2."""
    codes = np.full((2, L), 4, dtype=np.uint8)
    codes[:, :6 * copies] = np.tile(np.array(TTAGGG, np.uint8), copies)
    codes[1, :6] = 0                 # the run starts at 6: not terminal
    n, lng, term = _assert_stats(codes, TTAGGG, min_run_bases=12)
    assert n.tolist() == [copies, copies - 1]
    assert int(lng[0]) == longest
    assert bool(term[0]) == (longest >= 2) and not bool(term[1])


def test_stats_terminal_only_at_position_0():
    """terminal tests the run starting at position 0, not the read's end."""
    codes = np.full((2, 300), 4, dtype=np.uint8)
    codes[0, 300 - 60:] = np.tile(np.array(TTAGGG, np.uint8), 10)
    codes[1, :60] = np.tile(np.array(TTAGGG, np.uint8), 10)
    n, lng, term = _assert_stats(codes, TTAGGG)
    assert lng.tolist() == [10, 10] and term.tolist() == [False, True]


def _runs_across(rng, B, L, motif):
    """Codes 0-4 with stride-k runs placed about the CUDA bitset's
    32-position words and 32-lane groups (1,024 positions): ending on a
    boundary, starting on it or spanning it, row by row; every row also
    starts with a run and ends with a match."""
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    m = np.array(motif, np.uint8)
    k = len(m)
    for r in range(B):
        c = int(rng.integers(1, max(2, L // k // 2)))
        for edge in (32, 64, 1024):
            if edge >= L:
                break
            s = [edge - c * k, edge, edge - (c * k) // 2][r % 3]
            s = max(0, min(s, L - c * k))
            codes[r, s:s + c * k] = np.tile(m, c)
        codes[r, :k * min(c, L // k)] = np.tile(m, min(c, L // k))
        codes[r, L - k:] = m
    return codes


@pytest.mark.parametrize("motif", [TTAGGG, CCCTAA])
@pytest.mark.parametrize("L", [31, 32, 33, 63, 64, 65, 1023, 1024, 1025])
def test_stats_word_and_lane_boundaries(L, motif):
    """Runs that cross a 32-position word or a 32-lane group (1,024
    positions) of the CUDA bitset, and lengths about both, against the JAX
    functions."""
    rng = np.random.default_rng([L, len(motif), motif[0]])
    codes = _runs_across(rng, 9, L, motif)
    for min_run_bases in (24, 0):
        n, _, _ = _assert_stats(codes, motif, min_run_bases)
    assert int(n.sum()) > 0


@pytest.mark.parametrize("L", [1, 3, 5])
def test_stats_and_mask_shorter_than_motif(L):
    codes = np.full((3, L), 3, dtype=np.uint8)
    n, lng, term = _assert_stats(codes, TTAGGG, xla=False)
    assert n.tolist() == lng.tolist() == [0, 0, 0] and not term.any()
    got = telo_match_mask(torch.from_numpy(codes), TTAGGG)
    want = telo_match_mask_pallas(jnp.asarray(codes), TTAGGG, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


@pytest.mark.parametrize("motif", [TTAGGG, CCCTAA, (0,), (2, 1)])
def test_mask_matches_jax(motif):
    rng = np.random.default_rng(len(motif))
    codes = _codes(rng, 16, 1024, motif if len(motif) == 6 else TTAGGG)
    want = np.asarray(telo_match_mask_pallas(jnp.asarray(codes), motif,
                                             interpret=True))
    xla = np.asarray(telo_match_mask_jax(jnp.asarray(codes), motif))
    got = telo_match_mask(torch.from_numpy(codes), motif)
    assert got.dtype == torch.int8 and got.shape == codes.shape
    np.testing.assert_array_equal(got.numpy(), want)
    m = xla.shape[1]
    np.testing.assert_array_equal(got.numpy()[:, :m].astype(bool), xla)
    assert not got[:, m:].any()
    assert torch.equal(got, telo_match_mask_ref(torch.from_numpy(codes),
                                                motif))
    # N codes (4) never match, even against each other
    assert not got.numpy()[codes == 4].any()


@pytest.mark.parametrize("n", [5, 65_530, 65_536, 65_541, 131_078])
def test_mask_long_matches_jax(monkeypatch, n):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    rng = np.random.default_rng(n)
    seq = rng.integers(0, 5, size=n).astype(np.uint8)
    telo = np.tile(np.array(TTAGGG, np.uint8), 8)
    if n > 65_600:                    # runs across the 65,536-base chunk
        seq[65_520:65_520 + len(telo)] = telo
    seq[:min(n, len(telo))] = telo[:min(n, len(telo))]
    want = jax_long(seq, TTAGGG, interpret=True)
    got = telo_match_mask_long(seq, TTAGGG)
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        telo_match_mask_long(torch.from_numpy(seq), TTAGGG), want)


@pytest.mark.parametrize("n", [6, 65_530, 65_541, 131_078])
def test_match_positions_match_jax(monkeypatch, n):
    """The mask compacted where it lies: np.flatnonzero of the JAX
    package's contig-long mask, sorted int64; no kernel launch on the CPU,
    and stats get the mask's and the compaction's seconds."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    rng = np.random.default_rng([n, 7])
    seq = rng.integers(0, 5, size=n).astype(np.uint8)
    telo = np.tile(np.array(TTAGGG, np.uint8), 8)
    if n > 65_600:                    # runs across the 65,536-base chunk
        seq[65_520:65_520 + len(telo)] = telo
    seq[-min(n, len(telo)):] = telo[:min(n, len(telo))]
    for motif in (TTAGGG, CCCTAA):
        want = np.flatnonzero(jax_long(seq, motif, interpret=True))
        before, stats = telo_match_mask.launches, {}
        got = telo_match_positions(torch.from_numpy(seq), motif, stats=stats)
        assert telo_match_mask.launches == before
        assert got.dtype == torch.int64 and got.dim() == 1
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats["kernel"] >= 0 and stats["compact"] >= 0
    short = telo_match_positions(torch.from_numpy(seq[:5]), TTAGGG)
    assert short.dtype == torch.int64 and short.numel() == 0


def test_encode_bytes_equals_encode_seq():
    """telofind's encode of the uppercased bytes (one bytes.translate pass)
    gives the JAX package's encode_seq codes for every byte value, in a
    writable array."""
    from cornetto_tpu.kernels.minimizer import encode_seq
    text = bytes(range(256)) * 3 + b"ACGTNacgtn"
    got = encode_bytes(text)
    np.testing.assert_array_equal(got, encode_seq(text.decode("latin-1")))
    assert got.dtype == np.uint8 and got.flags.writeable
    assert encode_bytes(b"").shape == (0,)


def _walks_agree(text: bytes, motif: bytes):
    """The positions walk against the mask walk and the memchr scan."""
    codes = torch.from_numpy(encode_bytes(text))
    mc = encode_bytes(motif).tolist()
    mask = telo_match_mask_long(codes, mc)
    pos = telo_match_positions(codes, mc)
    got = scan_runs_from_positions(pos, len(motif), len(text))
    assert got == scan_runs_from_mask(mask, len(motif))
    assert got == list(scan_runs(text, motif))
    assert scan_runs_from_positions(pos.numpy(), len(motif), len(text)) == got
    return got


@pytest.mark.parametrize("text,motif,n_rows", [
    (b"AAAAAAAAAAAAAAAAAAAA", b"AAAAAA", 1),         # period 1 < k
    (b"CAAAAAAAAAAAAG" + b"A" * 7, b"AAAAAA", 2),
    (b"TATATATATATATAT", b"TATATA", 1),              # period 2 < k
    (b"TTAGGG" * 5, b"TTAGGG", 1),                   # both ends
    (b"TTAGGGTTAGGCTTAGGG" + b"ACGT" * 3 + b"TTAGGG", b"TTAGGG", 3),
    (b"ACGTACGTACGTNNNN", b"TTAGGG", 0),             # no match
    (b"TTAG", b"TTAGGG", 0),                         # n < k
    (b"", b"TTAGGG", 0),
    (b"TTAGGGTTAGG", b"TTAGGG", 1),
    (b"GGGGGGGGG", b"G", 1)])
def test_positions_walk_equals_mask_walk_and_scan(monkeypatch, text, motif,
                                                  n_rows):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    assert len(_walks_agree(text, motif)) == n_rows


@pytest.mark.parametrize("seed", range(4))
def test_positions_walk_seeded(monkeypatch, seed):
    """Seeded contigs of tandem arrays, broken copies and self-overlapping
    motifs at both ends."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    rng = np.random.default_rng([seed, 21])
    for motif in (b"TTAGGG", b"CCCTAA", b"AAAAAA", b"TATATA", b"AT", b"C"):
        parts = []
        for _ in range(40):
            r = rng.random()
            if r < 0.4:
                parts.append(motif * int(rng.integers(1, 9)))
            elif r < 0.6:
                parts.append(motif[:int(rng.integers(1, len(motif) + 1))])
            else:
                parts.append(bytes(rng.choice(list(b"ACGTN"),
                                              int(rng.integers(1, 30)))))
        _walks_agree(motif * 3 + b"".join(parts) + motif * 2, motif)


@settings(max_examples=60, deadline=None, database=None)
@given(text=st.text(alphabet="ACGTN", max_size=120),
       motif=st.sampled_from(["TTAGGG", "CCCTAA", "AAAAAA", "TATATA", "AT",
                              "A", "ACGTACGTA"]))
def test_positions_walk_hypothesis(text, motif):
    import os
    old = os.environ.get("CORNETTO_FORCE_CPU")
    os.environ["CORNETTO_FORCE_CPU"] = "1"
    try:
        _walks_agree(text.encode(), motif.encode())
    finally:
        if old is None:
            del os.environ["CORNETTO_FORCE_CPU"]
        else:
            os.environ["CORNETTO_FORCE_CPU"] = old


@pytest.mark.parametrize("bad", ["dtype", "dim", "noncontig", "motif_code",
                                 "motif_empty", "empty", "device"])
def test_wrappers_reject_bad_input(bad):
    codes = torch.zeros((4, 100), dtype=torch.uint8)
    motif = TTAGGG
    if bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "dim":
        codes = codes.reshape(400)
    elif bad == "noncontig":
        codes = torch.zeros((100, 4), dtype=torch.uint8).t()
    elif bad == "motif_code":
        motif = (3, 3, 4)
    elif bad == "motif_empty":
        motif = ()
    elif bad == "empty":
        codes = torch.zeros((0, 100), dtype=torch.uint8)
    elif bad == "device":
        codes = torch.zeros((4, 100), dtype=torch.uint8, device="meta")
    for fn in (telo_match_mask, telo_run_stats):
        with pytest.raises((ValueError, TypeError)):
            fn(codes, motif)
