"""Decision engine of the port (cornetto_tpu_torch.livefish.decide) against
the JAX package's: the 9 vote planes, the split-sum position means, argmax
ties, the 6 decision outputs and the fused rows.  Integer results,
tolerance 0, inputs from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cornetto_tpu.kernels.minimizer import encode_seq, pack_reads
from cornetto_tpu.livefish import decide as jd
from cornetto_tpu.livefish.index import build_index, build_panel_mask
from cornetto_tpu_torch.livefish import decide as td

BASES = np.array(list("ACGT"))


def _genome(seed, sizes):
    rng = np.random.default_rng(seed)
    return {n: "".join(BASES[rng.integers(0, 4, s)]) for n, s in sizes}


def _i32(h_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(h_u32, np.uint32)
                            .view(np.int32))


def _planes_equal(got, want):
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("two_choice", [True, False])
@pytest.mark.parametrize("n_ctg", [3, 70])       # dense / scatter branch
def test_lookup_votes_matches_jax(two_choice, n_ctg):
    size = 60000 // n_ctg
    genome = _genome(30 + n_ctg, [("c%d" % i, size) for i in range(n_ctg)])
    g = dict(genome)
    # an exact repeat across contigs: ambiguous hashes, two-slot path
    g["c1"] = g["c0"][:size // 2] + g["c1"][size // 2:]
    idx = build_index(g, n_shards=1, two_choice=two_choice)
    assert idx.two_choice == two_choice
    rng = np.random.default_rng(40 + n_ctg)
    n = int(idx.shard_counts[0])
    real = idx.hashes[0, rng.integers(0, n, size=300)]
    junk = rng.integers(0, 2**32, size=80, dtype=np.uint64).astype(np.uint32)
    top = (junk[:20] | np.uint32(0x80000000))            # top bit set
    q = np.concatenate([real, junk, top])
    rng.shuffle(q)
    q = q.reshape(25, 16)
    assert (q >= 0x80000000).any()
    valid = rng.random(q.shape) < 0.9
    want = jd._lookup_votes(jnp.asarray(idx.btable[0]), idx.bucket_shift,
                            jnp.asarray(q), jnp.asarray(valid), n_ctg,
                            two_choice)
    got = td._lookup_votes(torch.from_numpy(idx.btable[0]),
                           idx.bucket_shift, _i32(q),
                           torch.from_numpy(valid), n_ctg, two_choice)
    _planes_equal(got, want)
    assert int(got[4].sum()) > 0                   # ambiguous hits seen


def test_fingerprint_lookup_exact():
    """The exact-lookup fixture of test_pallas_extract: every indexed
    minimizer is found with its exact contig and position, ambiguous ones
    with both occurrences, and the planes equal the JAX lookup's."""
    rng = np.random.default_rng(3)
    g1 = BASES[rng.integers(0, 4, 30000)]
    g1[20000:23000] = g1[2000:5000]          # exact repeat -> ambiguity
    genome = {"c1": "".join(g1),
              "c2": "".join(BASES[rng.integers(0, 4, 20000)])}
    idx = build_index(genome, n_shards=1)
    assert idx.dropped_frac == 0.0
    n = int(idx.shard_counts[0])
    h = idx.hashes[0, :n]
    pos_raw = idx.positions[0, :n]
    amb = pos_raw < 0
    assert amb.any()
    pos = pos_raw & 0x7FFFFFFF
    got = td._lookup_votes(torch.from_numpy(idx.btable[0]),
                           idx.bucket_shift, _i32(h[:, None]),
                           torch.ones((n, 1), dtype=torch.bool), 2,
                           idx.two_choice)
    want = jd._lookup_votes(jnp.asarray(idx.btable[0]), idx.bucket_shift,
                            jnp.asarray(h[:, None]),
                            jnp.ones((n, 1), dtype=bool), 2, idx.two_choice)
    _planes_equal(got, want)
    (votes, votes_un, nu_hi, nu_lo, votes_amb,
     a1_hi, a1_lo, a2_hi, a2_lo) = (x.numpy().astype(np.int64) for x in got)
    rows = np.arange(n)
    exp_ctg = idx.contigs[0, :n]
    assert (votes.sum(axis=1) == 1).all()
    np.testing.assert_array_equal(votes[rows, exp_ctg], 1)
    np.testing.assert_array_equal(votes_un[rows, exp_ctg], (~amb) * 1)
    np.testing.assert_array_equal(votes_amb[rows, exp_ctg], amb * 1)
    numer_un = (nu_hi << 16) + nu_lo
    np.testing.assert_array_equal(numer_un[rows, exp_ctg][~amb], pos[~amb])
    numer_a1 = (a1_hi << 16) + a1_lo
    numer_a2 = (a2_hi << 16) + a2_lo
    first = np.flatnonzero(amb[:-1] & (h[:-1] == h[1:]))
    assert len(first)
    for i in first:
        for r in (i, i + 1):
            assert numer_a1[r, exp_ctg[r]] == pos[i]
            assert numer_a2[r, exp_ctg[r]] == pos[i + 1]


def test_mean_split_matches_jax():
    rng = np.random.default_rng(9)
    n = rng.integers(0, 2**14, size=5000).astype(np.int32)
    n[:5] = 0                                  # empty: clamped to 1
    hi = (rng.integers(0, 2**15, size=5000) * np.maximum(n, 1)
          // 2**6).astype(np.int32)
    lo = (rng.integers(0, 2**16, size=5000) * np.maximum(n, 1)
          // 2**6).astype(np.int32)
    want = np.asarray(jd._mean_split(jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(n)))
    got = td._mean_split(torch.from_numpy(hi), torch.from_numpy(lo),
                         torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = ((hi.astype(np.int64) << 16) + lo) // np.maximum(n, 1)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)


def test_est_exact_on_chromosome_scale_positions():
    """The chromosome-scale fixture of test_livefish: positions relocated
    to ~240 Mb keep an exact, unwrapped mean, equal to the JAX engine's."""
    rng = np.random.default_rng(21)
    genome = {"big": "".join(BASES[rng.integers(0, 4, 40_000)])}
    idx = build_index(genome, n_shards=1)
    bt = np.array(idx.btable[0])
    OFF = 240_000_000
    K = bt.shape[1] // 2
    pw = bt[:, K:]
    ct = np.stack([(bt[:, K // 2 + s // 2] >> (16 * (s % 2))) & 0xFFFF
                   for s in range(K)], axis=1)
    used = ct != 0xFFFF
    amb = (pw < 0) & used
    base = np.where(used, (pw & 0x7FFFFFFF) + OFF, pw)
    bt[:, K:] = np.where(amb, base | np.int32(-2**31),
                         np.where(used, base, pw))
    q = idx.hashes[0, :64][None, :]
    panel = np.zeros((1, 128), bool)
    got = td._decide_from_minima(
        torch.from_numpy(bt), _i32(q), torch.ones(q.shape, dtype=torch.bool),
        torch.from_numpy(panel), 3, 1000, idx.bucket_shift, idx.two_choice)
    want = jd._decide_from_minima(
        jnp.asarray(bt), jnp.asarray(q), jnp.ones(q.shape, bool),
        jnp.asarray(panel), 3, 1000, idx.bucket_shift,
        two_choice=idx.two_choice)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    exp_pos = (idx.positions[0, :64].astype(np.int64) & 0x7FFFFFFF) + OFF
    is_amb = idx.positions[0, :64] < 0
    exp = int(exp_pos[~is_amb].sum() // max((~is_amb).sum(), 1)) \
        if (~is_amb).any() else int(exp_pos[is_amb].sum() // is_amb.sum())
    assert int(got[2][0]) == exp >= OFF


def test_argmax_tie_takes_first_contig():
    """A read whose unambiguous hits split evenly between two contigs is
    assigned the lower contig id, as jnp.argmax does."""
    genome = _genome(55, [("a", 20000), ("b", 20000), ("c", 20000)])
    idx = build_index(genome, n_shards=1)
    n = int(idx.shard_counts[0])
    h, c, p = (idx.hashes[0, :n], idx.contigs[0, :n], idx.positions[0, :n])
    uniq = p >= 0
    hb = h[uniq & (c == 1)][:3]
    hc = h[uniq & (c == 2)][:3]
    q = np.stack([np.concatenate([hc, hb]), np.concatenate([hb, hc])])
    panel = build_panel_mask(idx, [("b", 0, 20000)])
    args_t = (torch.from_numpy(idx.btable[0]), _i32(q),
              torch.ones(q.shape, dtype=torch.bool), torch.from_numpy(panel),
              3, 1000, idx.bucket_shift, idx.two_choice)
    got = td._decide_from_minima(*args_t)
    want = jd._decide_from_minima(
        jnp.asarray(idx.btable[0]), jnp.asarray(q), jnp.ones(q.shape, bool),
        jnp.asarray(panel), 3, 1000, idx.bucket_shift,
        two_choice=idx.two_choice)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), [1, 1])   # "b" beats "c"
    np.testing.assert_array_equal(got[3].numpy(), [3, 3])
    np.testing.assert_array_equal(got[0].numpy(), [0, 0])   # b is panel


def _decision_fixture(n_ctg=2):
    sizes = [("c1", 30000), ("c2", 20000)] if n_ctg == 2 else \
        [("c%d" % i, 1500) for i in range(n_ctg)]
    genome = _genome(11 + n_ctg, sizes)
    idx = build_index(genome, n_shards=1)
    first = sizes[0][0]
    panel = build_panel_mask(idx, [(first, 0, sizes[0][1] // 2)])
    rng = np.random.default_rng(12)
    L = 400
    B = 32
    reads = np.zeros((B, L), dtype=np.uint8)
    names = list(genome)
    for i in range(B // 2):
        ctg = genome[names[i % len(names)]]
        s = int(rng.integers(0, len(ctg) - L))
        reads[i] = encode_seq(ctg[s:s + L])
    reads[B // 2:] = rng.integers(0, 4, size=(B // 2, L)).astype(np.uint8)
    return idx, panel, reads, rng


@pytest.mark.parametrize("variant", ["nmask", "nfree", "lengths"])
@pytest.mark.parametrize("n_ctg", [2, 70])
def test_decision_core_packed_matches_jax(variant, n_ctg):
    idx, panel, reads, rng = _decision_fixture(n_ctg)
    B, L = reads.shape
    lengths = None
    if variant == "nmask":
        reads[rng.random(reads.shape) < 0.01] = 4
    elif variant == "lengths":
        lengths = rng.integers(60, L + 1, size=B).astype(np.int32)
        for i in range(B):
            reads[i, lengths[i]:] = 0
    packed, nmask = pack_reads(reads)
    nm = nmask if variant == "nmask" else None
    kw = dict(L=L, k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
              bucket_shift=idx.bucket_shift, two_choice=idx.two_choice)
    want = jd.decision_core_packed(
        jnp.asarray(idx.btable[0]), jnp.asarray(packed),
        None if nm is None else jnp.asarray(nm), jnp.asarray(panel),
        use_pallas=True, interpret=True,
        lengths=None if lengths is None else jnp.asarray(lengths), **kw)
    st = td.state_from_index(idx, panel, "cpu")
    got = td.decision_core_packed(
        st.btable, torch.from_numpy(packed),
        None if nm is None else torch.from_numpy(nm), st.panel,
        lengths=None if lengths is None else torch.from_numpy(lengths), **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3][:B // 2].min()) >= 3 or variant == "lengths"
    # the fused (2, B) rows decode to the same four outputs
    fused = td.decision_core_packed_fused(
        st.btable, torch.from_numpy(packed),
        None if nm is None else torch.from_numpy(nm), st.panel,
        lengths=None if lengths is None else torch.from_numpy(lengths), **kw)
    fused_j = jd.decision_core_packed_fused(
        jnp.asarray(idx.btable[0]), jnp.asarray(packed),
        None if nm is None else jnp.asarray(nm), jnp.asarray(panel),
        lengths=None if lengths is None else jnp.asarray(lengths),
        use_pallas=True, interpret=True, **kw)
    assert fused.shape == (2, B) and fused.dtype == torch.int32
    np.testing.assert_array_equal(fused.numpy(), np.asarray(fused_j))
    for g, w in zip(jd.unpack_fused(fused.numpy()), want[:4]):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_engine_decide_matches_jax_engine():
    """SingleChipEngine.decide on unpacked codes (packed on the host, then
    the extraction path) equals the JAX engine's decide."""
    idx, panel, reads, rng = _decision_fixture()
    reads[rng.random(reads.shape) < 0.005] = 4
    want = jd.SingleChipEngine(idx, panel).decide(reads)
    got = td.SingleChipEngine(idx, panel, device="cpu").decide(reads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_state_from_index_carries_the_table():
    idx, panel, _, _ = _decision_fixture()
    st = td.state_from_index(idx, panel, "cpu")
    assert st.btable.dtype == torch.int32 and st.panel.dtype == torch.bool
    np.testing.assert_array_equal(st.btable.numpy(), idx.btable[0])
    np.testing.assert_array_equal(st.panel.numpy(), panel)
    assert (st.k, st.w, st.bucket_shift, st.two_choice) == (
        idx.k, idx.w, idx.bucket_shift, idx.two_choice)
