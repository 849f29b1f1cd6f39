"""Iteration-order-faithful emulation of klib khash string maps.

Several reference tools print results while iterating a khash table in bucket
order (reference: src/asmstats.c:430-457 telo_table contig scan,
src/telomere_breaks.c:133-148 final report loop).  Their golden outputs
therefore bake in khash's open-addressing layout.  This class reproduces the
exact bucket layout produced by the X31 string hash, triangular probing and
0.77-load-factor kick-out rehash of khash.h, so that iteration order — and
hence output byte order — matches the C binary.

Only the operations the reference tools use are implemented (put/get/iterate;
no deletions occur in any output-order-sensitive path).
"""

from typing import Iterator


def x31_hash(s: str) -> int:
    h = 0
    for ch in s.encode("latin-1"):
        h = ((h << 5) - h + ch) & 0xFFFFFFFF
    return h


def _kroundup32(x: int) -> int:
    x -= 1
    x |= x >> 1
    x |= x >> 2
    x |= x >> 4
    x |= x >> 8
    x |= x >> 16
    return (x + 1) & 0xFFFFFFFF


class KHashStr:
    """str -> value map with khash-identical bucket iteration order."""

    __slots__ = ("n_buckets", "size", "n_occupied", "upper_bound",
                 "keys", "vals", "used", "_index")

    def __init__(self):
        self.n_buckets = 0
        self.size = 0
        self.n_occupied = 0
        self.upper_bound = 0
        self.keys: list = []
        self.vals: list = []
        self.used: list = []
        self._index = {}  # shadow dict for O(1) membership

    def __len__(self) -> int:
        return self.size

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get(self, key: str, default=None):
        i = self._index.get(key)
        return default if i is None else self.vals[i]

    def __getitem__(self, key: str):
        return self.vals[self._index[key]]

    def __setitem__(self, key: str, val) -> None:
        i, absent = self.put(key)
        self.vals[i] = val

    def put(self, key: str):
        """Insert; returns (bucket_index, absent) like kh_put (absent=1 if new)."""
        if self.n_occupied >= self.upper_bound:
            if self.n_buckets > (self.size << 1):
                self._resize(self.n_buckets - 1)
            else:
                self._resize(self.n_buckets + 1)
        mask = self.n_buckets - 1
        i = x31_hash(key) & mask
        step = 0
        while self.used[i] and self.keys[i] != key:
            step += 1
            i = (i + step) & mask
        if not self.used[i]:
            self.keys[i] = key
            self.used[i] = True
            self.size += 1
            self.n_occupied += 1
            self._index[key] = i
            return i, 1
        return i, 0

    def _resize(self, new_n_buckets: int) -> None:
        # Faithful port of khash.h kh_resize: walk old buckets in order and
        # place each live element into the new flag array with a kick-out loop
        # (an element landing on a not-yet-rehashed old slot evicts it and the
        # evicted element is placed immediately).  The placement *order*
        # determines the final layout, so the kick-out chain must be exact.
        new_n = _kroundup32(new_n_buckets)
        if new_n < 4:
            new_n = 4
        if self.size >= int(new_n * 0.77 + 0.5):
            return
        old_n = self.n_buckets
        new_mask = new_n - 1
        new_used = [False] * new_n
        width = max(new_n, old_n)
        keys = self.keys + [None] * (width - len(self.keys))
        vals = self.vals + [None] * (width - len(self.vals))
        live = list(self.used) + [False] * (width - len(self.used))
        for j in range(old_n):
            if live[j]:
                key, val = keys[j], vals[j]
                live[j] = False
                while True:
                    i = x31_hash(key) & new_mask
                    step = 0
                    while new_used[i]:
                        step += 1
                        i = (i + step) & new_mask
                    new_used[i] = True
                    if i < old_n and live[i]:
                        keys[i], key = key, keys[i]
                        vals[i], val = val, vals[i]
                        live[i] = False
                    else:
                        keys[i] = key
                        vals[i] = val
                        break
        self.keys = keys[:new_n]
        self.vals = vals[:new_n]
        self.used = new_used
        self.n_buckets = new_n
        self.n_occupied = self.size
        self.upper_bound = int(new_n * 0.77 + 0.5)
        self._index = {self.keys[i]: i for i in range(new_n) if new_used[i]}

    def items(self) -> Iterator:
        """Iterate (key, value) in khash bucket order (kh_begin..kh_end)."""
        for i in range(self.n_buckets):
            if self.used[i]:
                yield self.keys[i], self.vals[i]

    def keys_in_order(self):
        return [k for k, _ in self.items()]
