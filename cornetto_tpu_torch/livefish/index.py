"""Sharded minimizer index of a draft assembly.

The TPU-native replacement for readfish's minimap2 index in the adaptive-
sampling loop (SURVEY.md §7 item 7): minimizers of the draft are extracted
host-side, sorted by hash, and partitioned into E shards by the LOW
log2(E) hash bits (the expert-parallel axis of the decision mesh).  Each
shard is a sorted (hash, contig, pos) table padded to a common static size
plus a bucketed device layout for one-gather lookups.

Low bits, not hash ranges, on purpose: minimizer hashes are window MINIMA,
so their values are strongly skewed toward small numbers — range-sharding
on the top bits would put most of a genome in shard 0 and overload the low
buckets (observed: the bucket directory grew 8x past its Poisson size
before meeting the overflow bound).  The low bits of the mixed hash stay
uniform regardless of the window-min skew, balancing both the shards and
the bucket loads.
"""

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from cornetto_tpu_torch.kernels.minimizer import (DEFAULT_K, DEFAULT_W,
                                                  encode_seq,
                                                  minimizers_native,
                                                  minimizers_np)
from cornetto_tpu_torch.utils import profiling


@dataclass
class MinimizerIndex:
    # shard tables, each (E, N_pad)
    hashes: np.ndarray      # uint32, padded with 0xFFFFFFFF
    contigs: np.ndarray     # int32, padded with -1
    positions: np.ndarray   # int32
    shard_counts: np.ndarray  # (E,) int32 true sizes
    contig_names: List[str]
    contig_lens: np.ndarray  # (C,) int64
    k: int
    w: int
    # bucketed device layout: bucket b of shard e holds up to `bucket_slots`
    # (K) entries whose hash satisfies ((h >> bucket_shift) & (2^B-1)) == b,
    # where bucket_shift = log2(E) (shard bits below, bucket bits next).
    # A lookup is then exactly ONE row-gather — the TPU-friendly
    # alternative to binary search, whose ~20 dependent gather rounds
    # dominate runtime.  Row layout (2K x int32, K a power of two <= 16):
    #   words 0..K/2-1   = uint16 fingerprint pairs (fp_s | fp_{s+1}<<16)
    #   words K/2..K-1   = uint16 contig-id pairs   (0xFFFF = empty slot)
    #   words K..2K-1    = int32 ref positions      (sign bit = ambiguous,
    #                                                i.e. multi-occurrence
    #                                                hash — MAPQ<20 analog)
    # K stays 4 (32-byte rows): measured on v5e, the row-gather has a
    # hard fast-path cliff past 32-byte rows (K=8 rows cost 6x, K=16 7x
    # per query — bench_probe2/round-5 microbenches), so capacity comes
    # from TWO-CHOICE placement instead of wider rows.  With two_choice,
    # every entry may live in its home bucket b1 = (h >> log2E) & (2^B-1)
    # or in b2 = b1 ^ g(fp), g(fp) = (fp * 0x9E3779B1) >> (32 - B);
    # greedy filling (less-full bucket wins, tie -> home) holds overflow
    # drops under 0.5% up to ~72% slot occupancy where single-choice
    # needed <= 27% — about half the directory bytes at 3 Gbp (round-4
    # verdict item 4) — at the cost of a second, independent (and thus
    # pipelineable) 32-byte gather per lookup.
    # The fingerprint fp = h >> (log2(E) + B) is EXACT, not
    # probabilistic: shard + bucket (+ the placement tag in bit 15 of
    # the stored half under two_choice: a b2-probe match implies
    # b1(h') = b2(q) ^ g(fp) = b1(q)) pin the low hash bits, so only the
    # top 32-log2(E)-B bits carry information; the build forces
    # B >= 17-log2(E) (two_choice, 15-bit fp + tag) or B >= 16-log2(E)
    # (legacy) so they fit the uint16 half.
    btable: np.ndarray = None     # (E, 2^B, 2K) int32
    bucket_shift: int = 0         # = log2(E)
    bucket_slots: int = 4
    dropped_frac: float = 0.0     # overflow entries dropped at build
    two_choice: bool = True       # tagged two-choice placement (above)

    @property
    def n_shards(self) -> int:
        # hashes is None when built with keep_tables=False (btable is the
        # runtime structure; the padded tables are debug/test surface)
        return (self.hashes.shape[0] if self.hashes is not None
                else self.btable.shape[0])


def build_index(contigs, n_shards: int = 1,
                k: int = DEFAULT_K, w: int = DEFAULT_W,
                repeat_cap: int = 256, bucket_slots: int = 4,
                keep_tables: bool = True,
                max_overflow: float = 0.005,
                two_choice: bool = True) -> MinimizerIndex:
    """contigs: {name: sequence} dict OR an iterable of (name, sequence)
    pairs — pass a generator at whole-genome scale so each contig string
    is freed after extraction.  n_shards must be a power of two.

    The table keeps the first TWO occurrences per unique hash; entries of
    hashes that occur more than once carry an AMBIGUITY mark (the sign bit
    of the stored position).  Ambiguous hits are what MAPQ<20 filtering
    removes in the aligned pipeline: the decision layer counts them toward
    mapping votes but excludes them from the high-confidence tally, and
    the second occurrence lets a read from either copy of an exact repeat
    split its coverage mass across both copies instead of piling onto the
    first (round-3 EVAL_ALIGNERFREE failure: the repeat SOURCE copy drew
    2x coverage and was wrongly rejected).  Hashes occurring more than
    `repeat_cap` times are dropped entirely (repeat masking).  A per-shard
    bucket directory bounds device lookups to 32-byte row-gathers
    holding `bucket_slots` fingerprinted entries; the directory width
    grows until bucket-overflow drops stay below `max_overflow` (0.5%:
    dropped hashes are uniform-random extra repeat masking — reads carry
    ~45 minimizers, so the sensitivity cost is noise — while each extra
    width doubling doubles the multi-GB table).  With `two_choice`
    (default) entries place greedily into the emptier of two candidate
    buckets (see the MinimizerIndex layout comment), which meets the
    overflow bound at ~2x the occupancy — half the table bytes — for
    one extra independent gather at lookup; callers of the raw
    decision_core functions must pass the index's two_choice flag.

    Extraction, dedup and the bucket fill run in C when a compiler is
    available (native/minimizer_native.c — the NumPy twins below are the
    validated fallback; round-3's all-NumPy build cost 1,936 s / 31.9 GB
    at 3 Gbp).  keep_tables=False skips the per-shard padded
    (hashes, contigs, positions) arrays — the decision engine needs only
    `btable`, and at 3 Gbp the padded tables are ~3.6 GB of RAM and
    checkpoint weight (the CLI index build passes False).

    Under a profiler the build's stages are the spans index.extract,
    index.sort, index.dedup and index.fill (the shard tables and the
    bucket directory).
    """
    import ctypes
    from cornetto_tpu_torch import native
    assert n_shards & (n_shards - 1) == 0, "n_shards must be a power of two"
    assert bucket_slots in (4, 8, 16), \
        "row layout packs uint16 pairs: slots must be 4, 8 or 16"
    items = contigs.items() if hasattr(contigs, "items") else contigs
    lib = native.load("minimizer_native", "minimizer_native.c")
    extract = minimizers_native if lib is not None else minimizers_np
    names = []
    lens_list = []
    # grow-in-place accumulators: per-contig list + one concatenate held
    # BOTH copies of the 3.6 GB (h, c, p) triple at 3 Gbp — the round-5
    # phase profile put the build's whole-genome RSS peak in this stage
    # stack-up (extract 3.7 -> concat 6.9 -> argsort 10.0 GB)
    cap = 1 << 20
    n_total = 0
    h = np.empty(cap, np.uint32)
    c = np.empty(cap, np.int32)
    p = np.empty(cap, np.int32)
    with profiling.span("index.extract"):
        for ci, (name, seq) in enumerate(items):
            names.append(name)
            lens_list.append(len(seq))
            pos, hh = extract(encode_seq(seq), k=k, w=w)
            need = n_total + len(hh)
            if need > cap:
                cap = max(need, cap + (cap >> 1))

                def _grow(a):
                    g = np.empty(cap, a.dtype)
                    g[:n_total] = a[:n_total]
                    return g
                h, c, p = _grow(h), _grow(c), _grow(p)
            h[n_total:need] = hh
            c[n_total:need] = ci
            p[n_total:need] = pos
            n_total = need
            del seq, pos, hh
    assert len(names) < 0xFFFF, "contig ids are uint16 in the device table"
    lens = np.array(lens_list, dtype=np.int64)
    h = h[:n_total]
    c = c[:n_total]
    p = p[:n_total]
    with profiling.span("index.sort"):
        if lib is not None and len(h):
            # threaded stable LSD radix by hash (native/minimizer_native.c):
            # np.argsort cost ~100 s + an int64 index array at 3 Gbp; four
            # memory-bound 8-bit passes with payloads take seconds and the
            # ping-pong buffers stay under the btable-phase peak
            import ctypes as _ct
            h2 = np.empty_like(h)
            c2 = np.empty_like(c)
            p2 = np.empty_like(p)
            pv = _ct.c_void_p
            lib.mz_radix_sort(pv(h.ctypes.data), pv(c.ctypes.data),
                              pv(p.ctypes.data), _ct.c_int64(len(h)),
                              pv(h2.ctypes.data), pv(c2.ctypes.data),
                              pv(p2.ctypes.data),
                              _ct.c_int(min(__import__("os").cpu_count() or 1,
                                            16)))
            del h2, c2, p2
        else:
            # NumPy twin: stable argsort = the same permutation (sort-phase
            # peak discipline: int32 order indices, one array re-ordered at
            # a time so the old buffer frees before the next copy)
            order = np.argsort(h, kind="stable")
            if len(h) < (1 << 31):
                order = order.astype(np.int32)
            h = h[order]
            c = c[order]
            p = p[order]
            del order
    log2e = int(n_shards).bit_length() - 1
    with profiling.span("index.dedup"):
        if lib is not None and len(h):
            # in-place C dedup (write index never exceeds read index)
            lib.mz_dedup.restype = ctypes.c_int64
            pv = ctypes.c_void_p
            m = lib.mz_dedup(pv(h.ctypes.data), pv(c.ctypes.data),
                             pv(p.ctypes.data), ctypes.c_int64(len(h)),
                             ctypes.c_int64(repeat_cap),
                             pv(h.ctypes.data), pv(c.ctypes.data),
                             pv(p.ctypes.data))
            h, c, p = h[:m], c[:m], p[:m]
        elif len(h):
            # NumPy twin: dedupe to the first TWO occurrences per unique hash
            # (stable sort = occurrences stay in (contig, position) order);
            # mark multi-occurrence hashes ambiguous via the position sign bit
            uniq_first = np.empty(len(h), dtype=bool)
            uniq_first[0] = True
            uniq_first[1:] = h[1:] != h[:-1]
            starts = np.flatnonzero(uniq_first)
            counts_per = np.diff(np.append(starts, len(h)))
            ok = counts_per <= repeat_cap
            first = starts[ok]
            second = starts[ok & (counts_per > 1)] + 1
            keep = np.sort(np.concatenate([first, second]))
            amb = np.repeat(counts_per[ok] > 1, np.minimum(counts_per[ok], 2))
            h, c, p = h[keep], c[keep], p[keep]
            p = np.where(amb, p | np.int32(-2**31), p).astype(np.int32)
    with profiling.span("index.fill"):
        # low-bit sharding: shard s owns hashes with (h & (E-1)) == s — the
        # low bits stay uniform despite the window-min value skew (see module
        # docstring), so shards are balanced
        shard_id = (h & np.uint32(n_shards - 1)).astype(np.int64)
        counts = np.bincount(shard_id, minlength=n_shards).astype(np.int32)

        H = C = P = None
        if keep_tables or lib is None:
            n_pad = max(int(counts.max()) if len(counts) else 1, 1)
            # round up so the padded table tiles the VPU lanes
            n_pad = -(-n_pad // 128) * 128
            H = np.full((n_shards, n_pad), 0xFFFFFFFF, dtype=np.uint32)
            C = np.full((n_shards, n_pad), -1, dtype=np.int32)
            P = np.zeros((n_shards, n_pad), dtype=np.int32)
            for s in range(n_shards):
                sel = shard_id == s
                ns = int(counts[s])
                # h sorted ascending -> per-shard sorted too
                H[s, :ns] = h[sel]
                C[s, :ns] = c[sel]
                P[s, :ns] = p[sel]
        del shard_id

        if lib is not None:
            btable, bshift, dropped = _build_buckets_native(
                lib, h, c, p, counts, log2e, bucket_slots, max_overflow,
                two_choice)
        else:
            btable, bshift, dropped = _build_buckets(
                H, C, P, counts, log2e, bucket_slots, max_overflow,
                two_choice)
    return MinimizerIndex(H, C, P, counts, names, lens, k, w,
                          btable=btable, bucket_shift=bshift,
                          bucket_slots=bucket_slots, dropped_frac=dropped,
                          two_choice=two_choice)


def _bucket_B0(counts: np.ndarray, log2e: int, K: int,
               two_choice: bool = True) -> int:
    """Initial bucket-directory width: same formula both build paths use,
    so native and NumPy builds pick identical B (and identical tables).
    Starts at ~100% nominal occupancy (mean load K per bucket) — the
    overflow-bound loop then grows B to the SMALLEST directory meeting
    max_overflow, rather than anchoring at 50% occupancy and only ever
    growing (which left tables needlessly half-empty).  two_choice needs
    a 15-bit fingerprint + placement tag, hence the higher 17-log2e
    floor."""
    max_n = max(int(counts.max()) if len(counts) else 1, 1)
    B = max(int(np.ceil(np.log2(max(max_n // max(K, 1), 2)))), 3,
            (17 if two_choice else 16) - log2e)
    # cap so fp_shift = log2e + B stays < 32 (a 32-bit shift is undefined)
    return min(B, 28, 31 - log2e)


def _build_buckets_native(lib, h, c, p, counts, log2e: int, K: int,
                          max_overflow: float = 0.005,
                          two_choice: bool = True):
    """C single-pass bucket fill (native/minimizer_native.c): a cheap
    counting pass per trial width picks the smallest directory B >= the
    initial estimate meeting the overflow bound (no trial tables), then
    one ascending-hash pass writes btable rows directly — no fps/cts/pos
    temporaries and no per-shard argsort (round 3: 133 s / 12.3 GB at
    50M entries; this path is ~3 s / table-sized).  With two_choice the
    counting pass replays the exact greedy placement decisions
    (mz_bucket_count2) instead of a plain histogram."""
    import ctypes
    pv = ctypes.c_void_p
    lib.mz_bucket_fill.restype = ctypes.c_int64
    lib.mz_bucket_fill2.restype = ctypes.c_int64
    lib.mz_bucket_count2.restype = ctypes.c_int64
    n = len(h)
    total = int(counts.sum())
    B = _bucket_B0(counts, log2e, K, two_choice)
    Bmax = min(28, 31 - log2e)
    n_shards = len(counts)
    while True:
        if two_choice:
            cnt = np.zeros(n_shards << B, dtype=np.uint8)
            dropped = int(lib.mz_bucket_count2(
                pv(h.ctypes.data), ctypes.c_int64(n), ctypes.c_int(log2e),
                ctypes.c_int(B), ctypes.c_int(K),
                pv(cnt.ctypes.data))) if n else 0
            del cnt
        else:
            hist = np.zeros(n_shards << B, dtype=np.int32)
            if n:
                lib.mz_bucket_hist(pv(h.ctypes.data), ctypes.c_int64(n),
                                   ctypes.c_int(log2e), ctypes.c_int(B),
                                   pv(hist.ctypes.data))
            dropped = int(np.maximum(hist - K, 0).sum(dtype=np.int64))
        frac = dropped / total if total else 0.0
        if frac <= max_overflow or B >= Bmax:
            break
        B += 1
    btable = np.empty((n_shards, 1 << B, 2 * K), dtype=np.int32)
    lib.mz_btable_init(ctypes.c_void_p(btable.ctypes.data),
                       ctypes.c_int64(n_shards << B), ctypes.c_int(K),
                       ctypes.c_int(min(__import__("os").cpu_count() or 1,
                                        16)))
    if n:
        fill = lib.mz_bucket_fill2 if two_choice else lib.mz_bucket_fill
        got = fill(
            pv(h.ctypes.data), pv(c.ctypes.data), pv(p.ctypes.data),
            ctypes.c_int64(n), ctypes.c_int(log2e), ctypes.c_int(B),
            ctypes.c_int(K), pv(btable.ctypes.data))
        frac = got / total if total else 0.0
    return btable, log2e, frac


def _fill_two_choice_np(h, c, p, fps, cts, pos, log2e: int, B: int,
                        K: int) -> int:
    """Sequential NumPy/Python twin of mz_bucket_fill2 (exact same greedy
    decisions, validated bit-for-bit by tests): entries in ascending-hash
    order place into the emptier of (b1, b1 ^ g(fp)); the second
    occurrence of an ambiguous pair follows its pair's bucket.  Fine at
    test scale; whole-genome builds use the C kernel."""
    mask = (1 << B) - 1
    fp_shift = log2e + B
    fill = np.zeros(fps.shape[0], np.int32)
    dropped = 0
    prev_b = -1
    prev_h = None
    for i in range(len(h)):
        x = int(h[i])
        b1 = (x >> log2e) & mask
        fp = x >> fp_shift
        b2 = b1 ^ (((fp * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - B))
        if prev_h == x:
            # second of an ambiguous pair: follow the first
            if prev_b >= 0 and fill[prev_b] < K:
                t = prev_b
            else:
                t = b2 if prev_b == b1 else b1
                if prev_b < 0 or fill[t] >= K:
                    t = -1
        elif fill[b1] <= fill[b2]:
            t = b1 if fill[b1] < K else (b2 if fill[b2] < K else -1)
        else:
            t = b2 if fill[b2] < K else (b1 if fill[b1] < K else -1)
        if t < 0:
            dropped += 1
            prev_b = -1
        else:
            s = fill[t]
            fps[t, s] = fp | (0x8000 if (t == b2 and b2 != b1) else 0)
            cts[t, s] = int(c[i]) & 0xFFFF
            pos[t, s] = p[i]
            fill[t] += 1
            prev_b = t
        prev_h = x
    return dropped


def _build_buckets(H: np.ndarray, C: np.ndarray, P: np.ndarray,
                   counts: np.ndarray, log2e: int, K: int,
                   max_overflow: float = 0.005, two_choice: bool = True):
    """Pack each shard's (sorted, unique) hash table into the (2^B, 2K)
    int32 fingerprinted row layout (see MinimizerIndex).  Bucket id = hash
    bits [log2E, log2E+B) — low bits, uniform under the window-min value
    skew; fingerprint = the remaining TOP bits, h >> (log2E + B).  B grows
    until bucket overflow (entries beyond K slots, dropped — extra repeat
    masking) is below `max_overflow`; B is floored so the fingerprint
    (plus the two_choice placement tag) fits the uint16 half."""
    assert K in (4, 8, 16), "row layout packs uint16 pairs"
    n_shards = H.shape[0]
    B = _bucket_B0(counts, log2e, K, two_choice)
    Bmax = min(28, 31 - log2e)
    while True:
        fp_shift = log2e + B
        assert 32 - fp_shift <= (15 if two_choice else 16), \
            (fp_shift, B, log2e)
        n_buckets = 1 << B
        fps = np.zeros((n_shards, n_buckets, K), dtype=np.uint32)
        cts = np.full((n_shards, n_buckets, K), 0xFFFF, dtype=np.uint32)
        pos = np.zeros((n_shards, n_buckets, K), dtype=np.int32)
        dropped = 0
        total = 0
        for s in range(n_shards):
            n = int(counts[s])
            if n == 0:
                continue
            h = H[s, :n]
            if two_choice:
                dropped += _fill_two_choice_np(
                    h, C[s, :n], P[s, :n], fps[s], cts[s], pos[s],
                    log2e, B, K)
                total += n
                continue
            buckets = ((h >> np.uint32(log2e))
                       & np.uint32(n_buckets - 1)).astype(np.int64)
            # buckets are low bits: not monotone in sorted h — order by
            # bucket (stably, keeping the lowest-hash-first slot order)
            order = np.argsort(buckets, kind="stable")
            hb = buckets[order]
            start = np.searchsorted(hb, np.arange(n_buckets))
            rank = np.arange(n) - start[hb]
            keep = rank < K
            slot_b = hb[keep]
            slot_k = rank[keep]
            fps[s, slot_b, slot_k] = h[order][keep] >> np.uint32(fp_shift)
            cts[s, slot_b, slot_k] = C[s, :n][order][keep] \
                .astype(np.uint32)
            pos[s, slot_b, slot_k] = P[s, :n][order][keep]
            dropped += int(n - keep.sum())
            total += n
        frac = dropped / total if total else 0.0
        if frac <= max_overflow or B >= Bmax:
            btable = np.empty((n_shards, n_buckets, 2 * K), dtype=np.int32)
            for j in range(K // 2):
                btable[:, :, j] = (
                    fps[:, :, 2 * j] | (fps[:, :, 2 * j + 1] << 16)) \
                    .view(np.int32)
                btable[:, :, K // 2 + j] = (
                    cts[:, :, 2 * j] | (cts[:, :, 2 * j + 1] << 16)) \
                    .view(np.int32)
            btable[:, :, K:] = pos
            return btable, log2e, frac
        B += 1


def build_panel_mask(index: MinimizerIndex, panel_rows,
                     bin_size: int = 1000) -> np.ndarray:
    """(C, BINS) bool — True where a position bin falls in the reject panel
    (the bigenough boring-bits BED, i.e. readfish unblock targets)."""
    name_to_id = {n: i for i, n in enumerate(index.contig_names)}
    n_bins = int(-(-index.contig_lens.max() // bin_size)) if \
        len(index.contig_lens) else 1
    n_bins = max(-(-n_bins // 128) * 128, 128)
    mask = np.zeros((len(index.contig_names), n_bins), dtype=bool)
    for c, s, e in panel_rows:
        ci = name_to_id.get(c)
        if ci is None:
            continue
        mask[ci, s // bin_size:-(-e // bin_size)] = True
    return mask
