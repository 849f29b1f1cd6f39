"""Plain reference of the read-until cell: the draft's minimizer index built
again from the draft, the panel mask from the panel rows, and each read's
decisions chunk by chunk, in plain PyTorch and NumPy, with the bucket
placement rule as a loop in plain C (place.c: a sequential rule over ~10^8
entries).  It imports nothing of the program and takes nothing the program
made.

The index: the canonical k-mer hashes of every contig (minimap2's 32-bit
finalizer), one entry a stride-w window (its first minimum; a window whose
minimum is 0xFFFFFFFF holds none), sorted by hash with ties in (contig,
position) order; a hash found more than repeat_cap times is dropped, one
found more than once keeps its first two entries, both marked ambiguous;
the entries go in ascending-hash order into a
table of 2^B buckets of K slots by the greedy two-choice rule (place.c),
B the least at or above the first guess that drops at most max_overflow
of them.  The table's layout is not the reference's: it keeps each hash
whose first entry was placed, with that entry, and finds it by binary
search (the table's probe finds a hash's first entry first, and drops a
second entry whose first was dropped).

A read is decided on its prefix of 1, 2, ... chunks: the stride-w window
minima of its hashes over the engine's fixed width (max_chunks chunks; a
k-mer counts where it lies inside the prefix), each looked up in the table
(the hash's first kept entry gives the contig and position), votes a
contig, the best contig the first with the most votes, its position the
floor of the mean of its unambiguous hits (else of its ambiguous ones),
and then the policy: mapped with min_hits votes, unblock when the
position's bin lies in the panel, else stop receiving; not mapped after
max_chunks chunks, a final proceed.
"""

import numpy as np
import torch

from portbench.reference import native

U32 = 0xFFFFFFFF
PROCEED, UNBLOCK, STOP_RECEIVING = 0, 1, 2


def hash32(x: torch.Tensor) -> torch.Tensor:
    """minimap2's invertible 32-bit finalizer on int64 values."""
    x = ((~x) + (x << 21)) & U32
    x = x ^ (x >> 24)
    x = (x + (x << 3) + (x << 8)) & U32
    x = x ^ (x >> 14)
    x = (x + (x << 2) + (x << 4)) & U32
    x = x ^ (x >> 28)
    return (x + (x << 31)) & U32


def kmer_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(..., L) int64 codes 0-3 -> (..., L - k + 1) hashes of the canonical
    k-mers (the lesser of the forward word and its reverse complement)."""
    m = codes.shape[-1] - k + 1
    fwd = torch.zeros(codes.shape[:-1] + (m,), dtype=torch.int64,
                      device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[..., j:j + m]
        fwd = (fwd << 2) | c
        rev = rev | ((3 - c) << (2 * j))
    return hash32(torch.minimum(fwd, rev))


def contig_minima(codes: torch.Tensor, k: int, w: int, block: int = 1 << 22):
    """(hashes, positions) int64 of one contig's window minima."""
    n = codes.shape[0]
    nwin = (n - k + 1) // w
    hs, ps = [], []
    for j0 in range(0, nwin, block):
        j1 = min(nwin, j0 + block)
        x = codes[j0 * w:j1 * w + k - 1].to(torch.int64)
        hw = kmer_hashes(x, k).view(j1 - j0, w)
        arg = torch.argmin(hw, dim=1)        # the first minimum
        h = hw.gather(1, arg[:, None])[:, 0]
        p = torch.arange(j0, j1, device=codes.device) * w + arg
        keep = h != U32
        hs.append(h[keep])
        ps.append(p[keep])
        del x, hw
    return torch.cat(hs), torch.cat(ps)


class Table:
    """The reference's index: the hashes whose first entry the table keeps,
    ascending, each with that entry's contig, position and ambiguity."""

    def __init__(self, keys, contig, pos, amb, B, dropped, entries):
        self.keys, self.contig, self.pos, self.amb = keys, contig, pos, amb
        self.B, self.dropped, self.entries = B, dropped, entries


def build_table(codes, starts, lens, index: dict, device,
                narrower: int = 0) -> Table:
    """The index of the contigs codes[starts[i]:starts[i] + lens[i]] as
    index (k, w, repeat_cap, bucket_slots, max_overflow) states.
    narrower > 0 takes a directory that many bits narrower than the
    rule's: the control's table, which drops more entries."""
    if not index["two_choice"]:
        raise ValueError("the reference builds two-choice tables only")
    k, w, K = index["k"], index["w"], index["bucket_slots"]
    g = torch.from_numpy(codes).to(device)
    hs, cs, ps = [], [], []
    for ci, (s, n) in enumerate(zip(starts, lens)):
        h, p = contig_minima(g[int(s):int(s) + int(n)], k, w)
        hs.append(h)
        ps.append(p)
        cs.append(torch.full_like(h, ci))
    del g
    h, order = torch.sort(torch.cat(hs), stable=True)
    c, p = torch.cat(cs)[order], torch.cat(ps)[order]
    del hs, cs, ps, order
    _, counts = torch.unique_consecutive(h, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    ok = counts <= index["repeat_cap"]
    keep, _ = torch.sort(torch.cat([first[ok],
                                    first[ok & (counts > 1)] + 1]))
    amb = torch.repeat_interleave(counts > 1, counts)[keep]
    h = h[keep].cpu().numpy().astype(np.uint32)
    c, p, amb = c[keep].cpu().numpy(), p[keep].cpu().numpy(), \
        amb.cpu().numpy()
    n = len(h)
    lib = native.load("place")
    place = np.empty(n, dtype=np.uint8)
    B = min(max(int(np.ceil(np.log2(max(n // K, 2)))), 3, 17), 28)
    while True:
        load = np.zeros(1 << B, dtype=np.uint8)
        dropped = lib.pb_place(h.ctypes.data, n, B, K, load.ctypes.data,
                               place.ctypes.data)
        if dropped <= index["max_overflow"] * n or B >= 28:
            break
        B += 1
    if narrower:
        B -= narrower
        load = np.zeros(1 << B, dtype=np.uint8)
        dropped = lib.pb_place(h.ctypes.data, n, B, K, load.ctypes.data,
                               place.ctypes.data)
    # a hash's first entry is the one a lookup finds: where the first is
    # dropped, the second is too
    lead = np.ones(n, bool)
    lead[1:] = h[1:] != h[:-1]
    sel = lead & (place != 0)
    return Table(h[sel].astype(np.int64), c[sel], p[sel], amb[sel], B,
                 int(dropped), n)


def panel_mask(contigs, rows, bin_size: int) -> np.ndarray:
    """(C, bins) bool: the bins each panel row touches; bins rounded up to
    a multiple of 128."""
    ids = {name: i for i, (name, _) in enumerate(contigs)}
    bins = -(-max(n for _, n in contigs) // bin_size)
    mask = np.zeros((len(contigs), max(-(-bins // 128) * 128, 128)), bool)
    for name, s, e in rows:
        mask[ids[name], s // bin_size:-(-e // bin_size)] = True
    return mask


def lookup(table: Table, q: np.ndarray):
    """(found, contig, pos, ambiguous) of each int64 hash in q."""
    i = np.minimum(np.searchsorted(table.keys, q), len(table.keys) - 1)
    found = table.keys[i] == q
    return (found, np.where(found, table.contig[i], 0),
            np.where(found, table.pos[i], 0), found & table.amb[i])


def decide(table: Table, h: np.ndarray, valid: np.ndarray, panel, C: int,
           policy: dict):
    """(unblock, best, mapped) of each read from its window minima h (n,
    M) and their validity."""
    found, contig, p1, ambig = lookup(table, h)
    found &= valid
    n = h.shape[0]
    cell = (np.arange(n)[:, None] * C + contig).reshape(-1)

    def plane(v):
        return np.bincount(cell, weights=v.reshape(-1).astype(np.float64),
                           minlength=n * C).astype(np.int64).reshape(n, C)
    un, am = found & ~ambig, found & ambig
    votes, votes_un, votes_amb = plane(found), plane(un), plane(am)
    sum_un, sum_amb = plane(np.where(un, p1, 0)), plane(np.where(am, p1, 0))
    best = np.argmax(votes, axis=1)           # the first maximum
    r = np.arange(n)
    nhits, hq, va = votes[r, best], votes_un[r, best], votes_amb[r, best]
    est = np.where(hq > 0, sum_un[r, best] // np.maximum(hq, 1),
                   sum_amb[r, best] // np.maximum(va, 1))
    mapped = nhits >= policy["min_hits"]
    b = np.clip(est // policy["bin_size"], 0, panel.shape[1] - 1)
    return mapped & panel[best, b], best, mapped


def read_decisions(table: Table, heads: np.ndarray, lengths, panel, C: int,
                   index: dict, policy: dict, chunk_len: int, device):
    """Each read's final (action, contig, chunks consumed)."""
    k, w = index["k"], index["w"]
    n, L = heads.shape
    nwin = (L - k + 1) // w
    h = kmer_hashes(torch.from_numpy(heads).to(device).to(torch.int64), k)
    i = torch.arange(L - k + 1, device=device)
    lengths = torch.as_tensor(np.asarray(lengths), device=device)
    action = np.full(n, PROCEED)
    contig = np.full(n, -1)
    chunks = np.zeros(n, np.int64)
    open_ = np.ones(n, bool)
    for j in range(1, policy["max_chunks"] + 1):
        ln = torch.clamp(lengths, max=j * chunk_len)
        hj = torch.where(i[None, :] + (k - 1) < ln[:, None], h, U32)
        hw = hj[:, :nwin * w].view(n, nwin, w).amin(dim=2).cpu().numpy()
        unblock, best, mapped = decide(table, hw, hw != U32, panel, C,
                                       policy)
        now = open_ & (mapped | (j == policy["max_chunks"]))
        action[now & mapped] = np.where(unblock[now & mapped], UNBLOCK,
                                        STOP_RECEIVING)
        contig[now & mapped] = best[now & mapped]
        chunks[now] = j
        open_ &= ~now
    return action, contig, chunks
