"""The fused decision step of the port (cornetto_tpu_torch/kernels/decide.py)
on the CPU: ``decide_packed`` (its plain version here) against the JAX
package's decision_core_packed and decision_core_packed_fused, and a numpy
emulation of the CUDA kernel's per-read hit-list algorithm
(csrc/decide.cu) against the dense plain version.  Integer results,
tolerance 0; the index and the reads come from numpy seeds
(tests/_decide_cases.py): all three validity variants, two_choice on and
off, C = 3, 64, 65 and 300 contigs (both sides of the plain version's
one-hot / scatter switch), min_hits 0 and 3, reads with no hit, reads
with ambiguous hits only, two-contig vote ties, estimates in the panel's
last bin, a table at high occupancy (hits split across both probes) and
tables of 8 and 16 slots a bucket."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cornetto_tpu.livefish import decide as jd
from cornetto_tpu_torch.kernels.decide import _lookup_votes, decide_packed
from cornetto_tpu_torch.kernels.extract import extract_minima_ref
from cornetto_tpu_torch.kernels.minimizer import pack_reads
import _decide_cases as dc  # tests/, on sys.path under pytest

L = 450
SEED = 8
# (C, two_choice, bases besides the last contig, slots a bucket)
CASES = [(c, tc, 60_000, 4) for c in (3, 64, 65, 300) for tc in (True,
                                                                   False)]
EXTRA = [(4, True, 3_000_000, 4), (5, True, 60_000, 8),
         (5, False, 60_000, 16)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _index(C, two_choice, total, slots):
    return dc.index(SEED, C, two_choice, L=L, slots=slots, total=total)


@functools.lru_cache(maxsize=None)
def _batch(C, two_choice, total, slots, variant):
    idx, panel, codes = _index(C, two_choice, total, slots)
    B = 128 if total > 60_000 else 64
    return dc.batch(SEED, idx, panel, codes, variant, B=B, L=L)


def _kw(idx, min_hits):
    return dict(L=L, k=idx.k, w=idx.w, min_hits=min_hits, bin_size=1000,
                bucket_shift=idx.bucket_shift, two_choice=idx.two_choice)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port(case, variant, min_hits, fused=False):
    idx, panel, _ = _index(*case)
    packed, nmask, lengths, _ = _batch(*case, variant)
    return decide_packed(torch.from_numpy(idx.btable[0]), _t(packed),
                         _t(nmask), torch.from_numpy(panel),
                         lengths=_t(lengths), fused=fused,
                         **_kw(idx, min_hits))


def _check_special_rows(case, variant, min_hits, out):
    """The reads made for a branch reach it."""
    idx, panel, _ = _index(*case)
    rows = _batch(*case, variant)[3]
    d, best, est, nh, hq, est2 = (o.numpy() for o in out)
    none = rows["junk"] + rows["empty"]
    np.testing.assert_array_equal(nh[none], 0)
    np.testing.assert_array_equal(best[none], 0)
    np.testing.assert_array_equal(est[none], 0)
    np.testing.assert_array_equal(est2[none], 0)
    np.testing.assert_array_equal(
        d[none], 0 if min_hits <= 0 and panel[0, 0] else 1)
    amb = rows["ambiguous"]
    assert (hq[amb] == 0).all() and (nh[amb] > 0).all()
    assert (best[amb] == 0).all()             # the first copy's contig
    assert (est2[amb] != est[amb]).any()      # the second copy's estimate
    assert (est[rows["last_bin"]] // 1000 == panel.shape[1] - 1).all()
    assert (best[rows["last_bin"]] == case[0] - 1).all()
    assert (d[rows["last_bin"]] == 0).all()   # in the panel: unblock


def _tie_rows_take_the_smaller_contig(case, variant, out):
    idx, panel, _ = _index(*case)
    packed, nmask, lengths, rows = _batch(*case, variant)
    tie = rows["tie"]
    h, v = extract_minima_ref(_t(packed), _t(nmask), L, idx.k, idx.w,
                              lengths=_t(lengths))
    votes = _lookup_votes(torch.from_numpy(idx.btable[0]),
                          idx.bucket_shift, h, v, panel.shape[0],
                          idx.two_choice)[0].numpy()
    best, nh = out[1].numpy(), out[3].numpy()
    for r in tie:
        top = np.flatnonzero(votes[r] == votes[r].max())
        if variant == "nfree":                # made to tie without Ns
            assert len(top) >= 2
        assert best[r] == top[0] and nh[r] == votes[r].max()


@pytest.mark.parametrize("min_hits", [0, 3])
@pytest.mark.parametrize("variant", dc.VARIANTS)
@pytest.mark.parametrize("case", CASES + EXTRA)
def test_decide_packed_matches_jax(case, variant, min_hits):
    idx, panel, _ = _index(*case)
    packed, nmask, lengths, _ = _batch(*case, variant)
    kw = _kw(idx, min_hits)
    jargs = (jnp.asarray(idx.btable[0]), jnp.asarray(packed), _j(nmask),
             jnp.asarray(panel))
    want = jd.decision_core_packed(*jargs, use_pallas=True, interpret=True,
                                   lengths=_j(lengths), **kw)
    got = _port(case, variant, min_hits)
    assert len(got) == len(want) == 6
    for g, w, dt in zip(got, want, [torch.int8] + [torch.int32] * 5):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_f = jd.decision_core_packed_fused(*jargs, use_pallas=True,
                                           interpret=True,
                                           lengths=_j(lengths), **kw)
    got_f = _port(case, variant, min_hits, fused=True)
    assert got_f.shape == (2, packed.shape[0])
    assert got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    _check_special_rows(case, variant, min_hits, got)
    _tie_rows_take_the_smaller_contig(case, variant, got)


# ------------------------------------------------- the kernel's algorithm

SENT = 0xFFFFFFFF


def _hash32(x):
    m = np.uint64(0xFFFFFFFF)
    x = x.astype(np.uint64)
    x = (~x + (x << np.uint64(21))) & m
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & m
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & m
    x = x ^ (x >> np.uint64(28))
    return (x + (x << np.uint64(31))) & m


def _window_minima(packed, nmask, lengths, L, k, w):
    """csrc/minimizer.cuh: each window's first k-mer built in k base steps,
    then rolled w - 1 steps; rolling N flags; minimum kept per window."""
    B = packed.shape[0]
    codes = ((packed[:, :, None] >> np.arange(0, 8, 2, dtype=np.uint8))
             & 3).reshape(B, -1)[:, :L].astype(np.uint64)
    nflag = np.zeros((B, L), dtype=np.uint64) if nmask is None else \
        np.unpackbits(nmask, axis=1, bitorder="little")[:, :L].astype(
            np.uint64)
    nwin = (L - k + 1) // w
    length = np.full(B, L) if lengths is None or nmask is not None else \
        lengths.astype(np.int64)
    kmask = np.uint64((1 << (2 * k)) - 1)
    fwd = np.zeros((B, nwin), dtype=np.uint64)
    rev = np.zeros_like(fwd)
    nrun = np.zeros_like(fwd)
    best = np.full((B, nwin), SENT, dtype=np.uint64)
    for t in range(w + k - 1):
        q = np.arange(nwin) * w + t
        c = codes[:, q]
        fwd = ((fwd << np.uint64(2)) | c) & kmask
        rev = (rev >> np.uint64(2)) | ((np.uint64(3) - c)
                                       << np.uint64(2 * (k - 1)))
        nrun = ((nrun << np.uint64(1)) | nflag[:, q]) & np.uint64(
            (1 << k) - 1)
        if t >= k - 1:
            ok = (nrun == 0) & (q[None, :] < length[:, None])
            h = np.where(ok, _hash32(np.minimum(fwd, rev)), SENT)
            best = np.minimum(best, h)
    return best


def _probe(row, K, want, m):
    for s in range(K):
        fp = (int(row[s // 2]) >> (16 * (s % 2))) & 0xFFFF
        ct = (int(row[K // 2 + s // 2]) >> (16 * (s % 2))) & 0xFFFF
        if fp != want or ct == 0xFFFF:
            continue
        if not m["found"]:
            m.update(found=True, contig=ct, pos1=int(row[K + s]))
        elif not m["has2"]:
            m.update(has2=True, pos2=int(row[K + s]))


def _mean_split(hi, lo, n):
    n = max(n, 1)
    q = hi // n
    return (q << 16) + (((hi - q * n) << 16) + lo) // n


def _emulate(btable, bucket_shift, two_choice, panel, minima, min_hits,
             bin_size):
    """csrc/decide.cu, one read at a time: hits (contig, ambiguity, p1,
    p2) in slot order into a list, each hit's contig counted over the
    list, (most votes, smallest id), the best contig's sums, the policy."""
    nb, width = btable.shape
    K, log2b = width // 2, nb.bit_length() - 1
    C, bins = panel.shape
    out = [[] for _ in range(6)]
    for mins in minima:
        hits = []
        for q in (int(x) for x in mins):
            if q == SENT:
                continue
            b1 = (q >> bucket_shift) & (nb - 1)
            fp = q >> (bucket_shift + log2b)
            m = dict(found=False, has2=False, contig=0, pos1=0, pos2=0)
            _probe(btable[b1], K, fp, m)
            if two_choice:
                g = ((fp * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - log2b)
                _probe(btable[b1 ^ (g & (nb - 1))], K, fp | (1 << 15), m)
            if m["found"] and m["contig"] < C:
                p1 = m["pos1"] & 0x7FFFFFFF
                p2 = m["pos2"] & 0x7FFFFFFF if m["has2"] else p1
                hits.append((m["contig"], m["pos1"] < 0, p1, p2))
        votes, best = 0, 0
        for c, _, _, _ in hits:
            n = sum(1 for h in hits if h[0] == c)
            if n > votes or (n == votes and c < best):
                votes, best = n, c
        mine = [h for h in hits if h[0] == best]
        un = [h[2] for h in mine if not h[1]]
        am = [(h[2], h[3]) for h in mine if h[1]]
        est1 = _mean_split(sum(p >> 16 for p, _ in am),
                           sum(p & 0xFFFF for p, _ in am), len(am))
        est = _mean_split(sum(p >> 16 for p in un),
                          sum(p & 0xFFFF for p in un), len(un)) \
            if un else est1
        est2 = est if un else _mean_split(
            sum(p >> 16 for _, p in am), sum(p & 0xFFFF for _, p in am),
            len(am))
        b = min(max(est // bin_size, 0), bins - 1)
        d = 0 if votes >= min_hits and panel[best, b] else 1
        for o, v in zip(out, (d, best, est, votes, len(un), est2)):
            o.append(v)
    return [np.array(o, dtype=np.int8 if i == 0 else np.int32)
            for i, o in enumerate(out)]


@pytest.mark.parametrize("min_hits", [0, 3])
@pytest.mark.parametrize("variant", dc.VARIANTS)
@pytest.mark.parametrize("case", CASES + EXTRA)
def test_hit_list_emulation_matches_dense(case, variant, min_hits):
    idx, panel, _ = _index(*case)
    packed, nmask, lengths, _ = _batch(*case, variant)
    minima = _window_minima(packed, nmask, lengths, L, idx.k, idx.w)
    got = _emulate(np.asarray(idx.btable[0], dtype=np.int64),
                   idx.bucket_shift, idx.two_choice, panel, minima,
                   min_hits, 1000)
    want = _port(case, variant, min_hits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_emulation_minima_match_the_plain_extraction():
    rng = np.random.default_rng(SEED)
    for k, w, Lx in ((15, 10, 450), (1, 1, 37), (7, 3, 100), (15, 1, 15),
                     (13, 50, 200)):
        reads = rng.integers(0, 4, size=(6, Lx)).astype(np.uint8)
        reads[rng.random(reads.shape) < 0.03] = 4
        packed, nmask = pack_reads(reads)
        lengths = rng.integers(0, Lx + 1, size=6).astype(np.int32)
        for nm, ln in ((None, None), (None, lengths), (nmask, None)):
            got = _window_minima(packed, nm, ln, Lx, k, w)
            h, _ = extract_minima_ref(_t(packed), _t(nm), Lx, k, w,
                                      lengths=_t(ln))
            np.testing.assert_array_equal(
                got.astype(np.uint32), h.numpy().view(np.uint32))


def test_decide_packed_checks_its_inputs():
    case = CASES[0]
    idx, panel, _ = _index(*case)
    packed, _, _, _ = _batch(*case, "nfree")
    bt, pk, pn = (torch.from_numpy(idx.btable[0]), torch.from_numpy(packed),
                  torch.from_numpy(panel))
    kw = _kw(idx, 3)
    with pytest.raises(TypeError):
        decide_packed(bt.to(torch.int64), pk, None, pn, **kw)
    with pytest.raises(TypeError):
        decide_packed(bt, pk, None, pn.to(torch.uint8), **kw)
    with pytest.raises(ValueError):
        decide_packed(bt[:-1], pk, None, pn, **kw)       # not 2^b rows
    with pytest.raises(ValueError):
        decide_packed(bt[:, :6].contiguous(), pk, None, pn, **kw)
    with pytest.raises(ValueError):
        decide_packed(bt, pk, None, pn.t(), **kw)        # not contiguous
    with pytest.raises(ValueError):
        decide_packed(bt, pk, None, pn, **dict(kw, bin_size=0))
    with pytest.raises(ValueError):
        decide_packed(bt, pk[:, :-1].contiguous(), None, pn, **kw)
    before = decide_packed.launches
    decide_packed(bt, pk, None, pn, **kw)
    assert decide_packed.launches == before      # the CPU runs no kernel
