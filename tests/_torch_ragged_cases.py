"""Every CUDA entry point of the port at small ragged shapes, each beside
its plain version on the same card tensors: lengths that are not multiples
of 4, 8 or 16, batches that are not a multiple of a block's groups, single
rows, and inputs that are views at an odd byte offset where the wrapper
takes them.

These are the cases of ``chip_smoke.py --sanitize-cases`` (the run that
compute-sanitizer's tools wrap) and of two checks of
tests/test_torch_cuda_kernels.py: with the caching allocator's freed
blocks filled with 0xA5 before each wrapper call
(``poison_freed_blocks``), so that an output element the kernel leaves
unwritten shows as a difference; and on the guard-page allocator
(``install_fence``), so that an access outside a tensor faults.

``CASES`` maps a name to ``make(dev) -> call``: ``call()`` launches the
wrapper on inputs already on ``dev`` and returns its outputs.  The inputs
come from numpy seeds, so ``make(cpu)()`` is the plain version on the same
inputs (a wrapper takes its plain version for CPU tensors); ``check``
holds the two equal.  Imports only numpy, torch and the port (with
tests/_decide_cases.py), so it runs where JAX is not installed."""

import functools

import numpy as np
import torch

from cornetto_tpu_torch.kernels.decide import decide_packed
from cornetto_tpu_torch.kernels.extract import extract_minima
from cornetto_tpu_torch.kernels.sdust import sdust_dp
from cornetto_tpu_torch.kernels.telo import (telo_match_mask,
                                             telo_match_positions,
                                             telo_run_stats)
from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                              shared_limit, sharded_votes)
from cornetto_tpu_torch.kernels.window_sum import window_sums
from cornetto_tpu_torch.livefish.index import build_index, build_panel_mask
import _decide_cases as dc  # tests/, on sys.path

ACGT = np.array(list("ACGT"))
TTAGGG = (3, 3, 0, 2, 2, 2)
POISON = 0xA5

# every wrapper the cases launch: its launch counter lives on it
WRAPPERS = (decide_packed, extract_minima, window_sums, sdust_dp,
            telo_match_mask, telo_run_stats, sharded_votes,
            policy_from_stats)


def poison_freed_blocks(dev, small_mib: int = 16, large_mib: int = 256):
    """Fill the caching allocator's free memory on ``dev`` with 0xA5, so
    that the next ``torch.empty`` lands on poison.  Every free block of
    the small pool (requests of at most 1 MiB) and every free block of
    the large pool over 1 MiB (the only ones a large request can take) is
    allocated at its exact size, which best-fit serves from that block;
    then fresh segments are added: ``small_mib`` MiB of whole 2 MiB small
    segments and about ``large_mib`` MiB of large ones (a request larger
    than half of it may land on fresh memory).  All are filled and
    freed."""
    mib = 1 << 20
    torch.cuda.synchronize(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    sizes = [blk["size"] for seg in torch.cuda.memory_snapshot()
             if seg["device"] == index
             for blk in seg["blocks"] if blk["state"] == "inactive"
             and (blk["size"] <= mib) == (seg["segment_type"] == "small")]
    sizes += [mib] * small_mib
    # large_mib in halves (128, 64, 32, 32 MiB for 256); 2 + 4 + 6 + 8 MiB
    # fill one 20 MiB segment, the allocator's unit for requests under 10 MiB
    half = large_mib // 2
    while half >= 64:
        sizes.append(half * mib)
        half //= 2
    sizes += [32 * mib, 32 * mib, 2 * mib, 4 * mib, 6 * mib, 8 * mib]
    held = [torch.empty(n, dtype=torch.uint8, device=dev)
            for n in sorted(sizes, reverse=True)]
    for t in held:
        t.fill_(POISON)
    torch.cuda.synchronize(dev)
    del held


def install_fence(mode: str) -> None:
    """Route this process's CUDA allocations through the guard-page
    allocator of tests/_torch_fence_alloc.c (built with ``cc`` into
    build/kernels/): each tensor against an unmapped region after its end
    (``mode`` "after") or before its start ("before"), so that an access
    outside it faults.  Call before the process's first CUDA allocation."""
    import os
    import subprocess
    from torch.utils.cpp_extension import CUDA_HOME
    from cornetto_tpu_torch.kernels import _build
    if not CUDA_HOME:
        raise RuntimeError("the guard-page allocator needs the CUDA toolkit")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_fence_alloc.c")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = str(_build.BUILD_DIR / "libfence_alloc.so")
    tmp = "%s.%d.tmp" % (so, os.getpid())
    proc = subprocess.run(
        [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC", "-I",
         os.path.join(CUDA_HOME, "include"), src, "-L",
         os.path.join(CUDA_HOME, "lib64", "stubs"), "-lcuda", "-o", tmp],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("building the guard-page allocator failed:\n"
                           + proc.stderr)
    os.replace(tmp, so)
    os.environ["CORNETTO_FENCE"] = mode
    torch.cuda.memory.change_current_allocator(
        torch.cuda.memory.CUDAPluggableAllocator(so, "fence_malloc",
                                                 "fence_free"))


def _put(dev, a, offset: int = 0):
    """numpy -> a contiguous tensor on dev; with ``offset`` a view that
    starts ``offset`` elements into a larger buffer."""
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return t.to(dev)
    buf = torch.zeros(t.numel() + offset + 7, dtype=t.dtype, device=dev)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t.to(dev))
    return view


# ------------------------------------------------------ decision, extraction

@functools.lru_cache(maxsize=None)
def _decide_index(L: int):
    return dc.index(8, 3, True, L=L)


def _reads(B: int, L: int, variant: str):
    """(packed, nmask or None, lengths or None) of B reads of L bases: rows
    of dc.batch's draft (junk, ambiguous, tied, genomic), cut to B."""
    idx, panel, codes = _decide_index(L)
    packed, nmask, lengths, _ = dc.batch(8, idx, panel, codes, variant,
                                         B=max(B, 24), L=L)
    cut = lambda a: None if a is None else a[:B]  # noqa: E731
    return cut(packed), cut(nmask), cut(lengths)


def _decide(B, L, variant, fused, offset=0):
    def make(dev):
        idx, panel, _ = _decide_index(L)
        packed, nmask, lengths = _reads(B, L, variant)
        args = (_put(dev, idx.btable[0]), _put(dev, packed, offset),
                _put(dev, nmask, offset), _put(dev, panel))
        kw = dict(L=L, k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
                  bucket_shift=idx.bucket_shift, two_choice=idx.two_choice,
                  lengths=_put(dev, lengths, offset), fused=fused)
        return lambda: decide_packed(*args, **kw)
    return make


def _extract(B, L, variant, offset=0, k=15, w=10):
    def make(dev):
        packed, nmask, lengths = _reads(B, L, variant)
        args = (_put(dev, packed, offset), _put(dev, nmask, offset), L, k, w)
        ln = _put(dev, lengths, offset)
        return lambda: extract_minima(*args, lengths=ln)
    return make


# ---------------------------------------------------------------- window sum

def _window(dtype, rows, n, window, stride, offset=0):
    def make(dev):
        rng = np.random.default_rng([rows, n, window, stride, offset])
        if dtype == torch.uint16:
            x = rng.integers(0, 1 << 16, size=(rows, n)).astype(np.uint16)
        else:
            x = rng.integers(-2**31, 2**31, size=(rows, n)).astype(np.int32)
        t = _put(dev, x, offset)
        if rows == 1:
            t = t[0]
        return lambda: window_sums(t, window, stride)
    return make


# ---------------------------------------------------------------- SDUST

def _sdust_rows(n, clen, seed):
    """Random rows, short-period repeats, a homopolymer, N runs and
    separated bursts (an overflow row)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, size=(n, clen)).astype(np.uint8)
    for r in range(n):
        kind = r % 5
        if kind == 1:
            rows[r] = np.tile(rng.integers(0, 4, rng.integers(1, 6)),
                              clen)[:clen]
        elif kind == 2:
            rows[r] = rng.integers(0, 4)
        elif kind == 3:
            rows[r, rng.integers(0, clen, 5)] = 4
        elif kind == 4:
            for j, s in enumerate(range(0, clen - 10, 20)):
                rows[r, s:s + 8] = j % 4
    rows[:, -1] = 4                              # a row ends in an N
    return rows


def _sdust(n, W, T, core, budget, offset=3):
    def make(dev):
        clen = 4 * W + core + W + 8
        rows = _sdust_rows(n, clen, [n, W, core])
        # rows at odd offsets of one buffer, apart by clen + 5
        flat = np.full(offset + n * (clen + 5), 4, dtype=np.uint8)
        off = offset + np.arange(n, dtype=np.int64) * (clen + 5)
        for r in range(n):
            flat[off[r]:off[r] + clen] = rows[r]
        codes, row_off = _put(dev, flat), _put(dev, off)
        return lambda: sdust_dp(codes, row_off, clen, T, W, budget=budget)
    return make


# ---------------------------------------------------------------- telomere

def _motif(k):
    if k == 6:
        return TTAGGG
    return tuple(np.random.default_rng([k, 3]).integers(0, 4, k).tolist())


def _telo_codes(B, L, motif, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    m = np.array(motif, np.uint8)
    k = len(m)
    for r in range(B):
        if L >= k:
            c = max(1, min(L // k, 40))
            s = int(rng.integers(0, L - c * k + 1))
            codes[r, s:s + c * k] = np.tile(m, c)
            codes[r, :k] = m
            codes[r, L - k:] = m
    return codes


def _mask(B, L, k, offset=0):
    def make(dev):
        motif = _motif(k)
        codes = _put(dev, _telo_codes(B, L, motif, [B, L, k]), offset)
        return lambda: telo_match_mask(codes, motif)
    return make


def _positions(n, k, offset=0):
    def make(dev):
        motif = _motif(k)
        codes = _put(dev, _telo_codes(1, n, motif, [n, k])[0], offset)
        return lambda: telo_match_positions(codes, motif)
    return make


def _stats(B, L, k, offset=0):
    def make(dev):
        motif = _motif(k)
        codes = _put(dev, _telo_codes(B, L, motif, [B, L, k, 1]), offset)
        return lambda: telo_run_stats(codes, motif)
    return make


# ------------------------------------------------------ sharded votes, policy

@functools.lru_cache(maxsize=None)
def _votes_index(n_ctg: int, ep: int, L: int):
    """A 2-shard (ep) index of dc's seeded draft of n_ctg contigs, its panel,
    and the minima of a dc batch of 38 reads (37 rows + 1: parts 2)."""
    idx1, panel1, codes = dc.index(8, n_ctg, True, L=L)
    names = ["c%d" % i for i in range(n_ctg)]
    idx = build_index(((n, "".join(ACGT[c])) for n, c in zip(names, codes)),
                      n_shards=ep, two_choice=True)
    panel = build_panel_mask(idx, [(n, 0, len(c)) for n, c in
                                   zip(names[::2], codes[::2])])
    packed, nmask, lengths, _ = dc.batch(8, idx1, panel1, codes, "lengths",
                                         B=38, L=L)
    h, v = extract_minima(torch.from_numpy(packed), None, L, idx.k, idx.w,
                          lengths=torch.from_numpy(lengths))
    return idx, panel, h.numpy(), v.numpy()


def _past(dev):
    """One contig past the largest C whose planes the votes kernel keeps in
    shared memory (the kernel library says; on the CPU, where it is not
    built, its 227 KiB over nine int32 planes)."""
    return (shared_limit() if dev.type == "cuda" else 227 * 1024 // 36) + 1


def _padded(panel, C):
    out = np.zeros((C, panel.shape[1]), dtype=bool)
    out[:panel.shape[0]] = panel
    return out


def _votes(C, shard, parts, offset=0):
    def make(dev):
        idx, _, h, v = _votes_index(87, 2, 451)
        Cn = _past(dev) if C == "past" else C
        args = (_put(dev, h, offset), _put(dev, v, offset),
                _put(dev, idx.btable[shard]), idx.bucket_shift,
                idx.two_choice, 2, shard, Cn)
        return lambda: sharded_votes(*args, parts=parts)
    return make


def _policy(C, b):
    def make(dev):
        idx, panel, h, v = _votes_index(87, 2, 451)
        Cn = _past(dev) if C == "past" else C
        rows = np.arange(b) % h.shape[0]
        total = 0
        for shard in range(2):
            total = total + sharded_votes(
                torch.from_numpy(h[rows]), torch.from_numpy(v[rows]),
                torch.from_numpy(idx.btable[shard]), idx.bucket_shift,
                idx.two_choice, 2, shard, Cn)
        stats = _put(dev, total.numpy())
        pn = _put(dev, _padded(panel, Cn))
        return lambda: policy_from_stats(stats, pn, 3, 1000)
    return make


CASES = {}
for _v in dc.VARIANTS:
    for _B, _L in ((1, 451), (37, 301), (24, 97)):
        CASES["decide_%s_%dx%d" % (_v, _B, _L)] = _decide(_B, _L, _v, False)
    CASES["decide_%s_fused_37x301_view" % _v] = _decide(37, 301, _v, True,
                                                        offset=3)
    CASES["extract_%s_1x451" % _v] = _extract(1, 451, _v)
    CASES["extract_%s_37x301_view" % _v] = _extract(37, 301, _v, offset=5)
CASES["extract_nfree_24x97_k1_w33"] = _extract(24, 97, "nfree", k=1, w=33)
for _dt, _name in ((torch.uint16, "u16"), (torch.int32, "i32")):
    CASES["window_%s_3x1001_w37_s5" % _name] = _window(_dt, 3, 1001, 37, 5)
    CASES["window_%s_1x7_w3_s1" % _name] = _window(_dt, 1, 7, 3, 1)
    CASES["window_%s_2x4099_w2500_s50_view" % _name] = _window(
        _dt, 2, 4099, 2500, 50, offset=1)
CASES["sdust_light_5x_w32"] = _sdust(5, 32, 14, 64, budget=0)
CASES["sdust_heavy_5x_w32"] = _sdust(5, 32, 14, 64, budget=1)
CASES["sdust_light_heavy_1x_w64"] = _sdust(1, 64, 20, 128, budget=1)
CASES["sdust_default_budget_9x_w3"] = _sdust(9, 3, 5, 64, budget=None)
for _B, _L, _k in ((3, 17, 6), (1, 15, 6), (2, 5, 6), (5, 4097, 6),
                   (3, 301, 1), (2, 1001, 37), (2, 333, 100)):
    CASES["mask_%dx%d_k%d" % (_B, _L, _k)] = _mask(_B, _L, _k)
CASES["mask_3x1001_k6_view"] = _mask(3, 1001, 6, offset=7)
CASES["positions_10001_k6_view"] = _positions(10_001, 6, offset=9)
CASES["positions_3_k6"] = _positions(3, 6)
for _B, _L, _k in ((1, 31, 6), (7, 33, 6), (37, 1025, 6), (3, 4097, 6),
                   (2, 5000, 6), (5, 450, 100), (33, 450, 1)):
    CASES["stats_%dx%d_k%d" % (_B, _L, _k)] = _stats(_B, _L, _k)
CASES["stats_37x451_k6_view"] = _stats(37, 451, 6, offset=11)
for _C in (87, "past"):
    for _shard, _parts in ((0, 1), (1, 2)):
        CASES["votes_C%s_shard%d_parts%d" % (_C, _shard, _parts)] = _votes(
            _C, _shard, _parts)
    CASES["votes_C%s_view" % _C] = _votes(_C, 0, 2, offset=1)
    CASES["policy_C%s_b37" % _C] = _policy(_C, 37)
CASES["policy_C87_b1"] = _policy(87, 1)


def flat(out):
    """A wrapper's result as a list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def check(name, dev, poison: bool = False):
    """Run one case on ``dev``; returns the differences from the plain
    version on the CPU (an empty list when equal)."""
    want = CASES[name](torch.device("cpu"))()
    call = CASES[name](dev)
    if poison:
        poison_freed_blocks(dev)
    got = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    got, want = flat(got), flat(want)
    if len(got) != len(want):
        return ["%d outputs, the plain version %d" % (len(got), len(want))]
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            bad.append("output %d: %s %s, plain %s %s"
                       % (i, g.dtype, tuple(g.shape), w.dtype,
                          tuple(w.shape)))
        elif not torch.equal(g.cpu(), w.cpu()):
            diff = (g.cpu() != w.cpu()).sum().item()
            bad.append("output %d: %d of %d elements differ"
                       % (i, diff, g.numel()))
    return bad
