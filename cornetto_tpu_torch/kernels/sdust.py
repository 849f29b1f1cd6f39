"""SDUST DP over independent chunks: counterpart of
cornetto_tpu/kernels/pallas_sdust.py (sdust_pallas_chunks, sdust_pallas).

``sdust_dp`` launches the hand-written CUDA kernels (csrc/sdust.cu: a light
pass of one thread per chunk running the sequential DP, which hands every
chunk past ``budget`` find_perfect row-steps to a heavy pass of one warp per
chunk) for tensors on a CUDA device and runs the plain PyTorch version
``sdust_dp_ref`` for tensors on the CPU; on a CUDA tensor it launches or
raises, never falls back.  A row of the DP is
``clen`` codes (0-3 bases, 4 = N) at ``codes[row_off[r]:]``, so one upload
of a padded contig serves all its chunks; ``sdust_chunks`` is the
``(n, CLEN)`` row-matrix form of sdust_pallas_chunks on top of it.

``sdust_device`` is sdust_pallas: the chunk plan, N-proximal spans and
re-run of overflow rows on the native DP, and the clip-and-union
``assemble`` (the port's copies: kernels/sdust_chunked.py,
native/sdust.py), so it is bit-identical to the sequential DP.

The JAX kernel's ring holds ROWS = 64 words, so its results are defined for
W - 2 <= 64 only; the port takes 3 <= W <= 66 (``check_window``).  Its
find_perfect sweep starts at window row 1, which differs from the
sequential DP when an eviction empties the window (row 0 then adds its
word's count): that needs T < 5, so ``sdust_device`` takes T >= 5 and
``sdust_dp`` keeps the JAX kernel's result for every T (``check_params``).
"""

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.kernels import _build
from cornetto_tpu_torch.kernels.sdust_chunked import (DEF_W, assemble,
                                                      encode, find_n_sites,
                                                      plan_from_sites,
                                                      run_host_spans)
from cornetto_tpu_torch.native.sdust import sdust as sdust_exact
from cornetto_tpu_torch.utils import profiling

_KERNEL = "sdust"
SD_WLEN = 3
ROWS = 64        # ring capacity and number of word values
GSLOT = 128      # pending-interval start slots of the JAX kernel
W_MIN, W_MAX = SD_WLEN, ROWS + SD_WLEN - 1
T_MIN = 5
_BIG = 1 << 30
# find_perfect row-steps after which the light pass hands a row to the heavy
# pass (dense satellite takes ~60 a base, random sequence a few hundred a
# chunk).  Few rows leave most SMs idle, so a low budget gives every row
# with any dense stretch a warp of its own; many rows fill the card, and a
# high budget keeps the rows of a few hundred row-steps in the light pass,
# 32 to a warp.  The budget grows with the rows per SM between the two
# (PERF.md; chip_smoke.py phase 11 sweeps it from 384 rows to 121,412).
BUDGET_MIN, BUDGET_MAX = 16, 4096
BUDGET_PER_ROW_PER_SM = 4


def default_budget(n: int, device) -> int:
    """The light pass's budget for n rows on a CUDA device: 4 row-steps
    per row per SM, within 16..4096."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(max(BUDGET_PER_ROW_PER_SM * n // sms, BUDGET_MIN), BUDGET_MAX)


def check_window(W: int) -> None:
    """Raises ValueError unless 3 <= W <= 66 (the ring of ROWS words)."""
    if not W_MIN <= W <= W_MAX:
        raise ValueError(
            "sdust device DP: window W=%d is outside %d..%d (the DP ring "
            "holds %d words, W - 2 <= %d); use --backend host"
            % (W, W_MIN, W_MAX, ROWS, ROWS))


def check_params(W: int, T: int) -> None:
    """Raises ValueError unless the chunked DP equals the sequential DP at
    (W, T): 3 <= W <= 66 and T >= 5."""
    check_window(W)
    if T < T_MIN:
        raise ValueError(
            "sdust device DP: threshold T=%d is below %d; there an eviction "
            "can empty the window and the DP (as the JAX kernel's) departs "
            "from the sequential one; use --backend host" % (T, T_MIN))


def max_intervals(clen: int) -> int:
    """Interval slots per row (sdust_pallas_chunks' MAXI); a row that
    reports this many or more is an overflow row."""
    return max(clen // 48, 16)


# ------------------------------------------------------------ plain version

class _LaneDP:
    """The JAX kernel's lane-parallel DP (pallas_sdust._sdust_kernel) on
    torch tensors: one lane per row, (ROWS, lanes) ring (newest word in row
    0) and histograms, (GSLOT, lanes) start-group planes.  Every
    lax.cond(any) / fori_loop / while_loop of the JAX kernel is Python
    control flow on .any().  find_perfect's backward sweep is evaluated for
    all rows of the window at once (see _find_perfect)."""

    def __init__(self, planes: torch.Tensor, T: int, W: int):
        self.codes = planes                          # (CLEN, lanes) int64
        self.T, self.W = T, W
        self.NW = W - SD_WLEN + 1
        clen, n = planes.shape
        self.clen, self.n = clen, n
        self.maxi = max_intervals(clen)
        dev = planes.device
        z = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)  # noqa
        self.iota_r = torch.arange(ROWS, device=dev)[:, None]
        self.lanes = torch.arange(n, device=dev)
        self.ring, self.cw, self.cv = z(ROWS, n), z(ROWS, n), z(ROWS, n)
        self.Gs, self.Gf, self.Gr, self.Gl = (z(GSLOT, n), z(GSLOT, n),
                                              z(GSLOT, n), z(GSLOT, n))
        self.Gu = torch.zeros((GSLOT, n), dtype=torch.bool, device=dev)
        self.rv, self.rw, self.L, self.lenw = z(n), z(n), z(n), z(n)
        self.lrun, self.tw = z(n), z(n)
        self.res_s, self.res_f, self.outn = z(n), z(n), z(n)
        self.res_has = torch.zeros(n, dtype=torch.bool, device=dev)
        self.outs, self.outf = z(self.maxi, n), z(self.maxi, n)
        self.steps = z(n)        # find_perfect row-steps of each row

    # -- intervals
    def _emit(self, emit):
        at = self.outn
        sel = emit & (at < self.maxi)
        if sel.any():
            lane = self.lanes[sel]
            self.outs[at[sel], lane] = self.res_s[sel]
            self.outf[at[sel], lane] = self.res_f[sel]
        self.outn = at + emit.long()

    def _save_masked(self, thresh, mask):
        """save_masked_regions(thresh) (src/sdust/sdust.c:88-102): save the
        newest entry of the minimum-start group below thresh, merge it into
        the res tail, delete every group below thresh."""
        below = self.Gu & (self.Gs < thresh) & mask
        fire = below.any(0)
        if not fire.any():
            return
        min_s = torch.where(below, self.Gs, _BIG).amin(0)
        p_f = torch.where(below & (self.Gs == min_s), self.Gf, 0).sum(0)
        ovl = fire & self.res_has & (min_s <= self.res_f)
        new_seg = fire & ~ovl
        self._emit(new_seg & self.res_has)
        self.res_f = torch.where(ovl, torch.maximum(self.res_f, p_f),
                                 self.res_f)
        self.res_s = torch.where(new_seg, min_s, self.res_s)
        self.res_f = torch.where(new_seg, p_f, self.res_f)
        self.res_has = self.res_has | new_seg
        self.Gu = self.Gu & ~below

    def _flush(self, thresh0, mask):
        """The N / end flush: save_masked with a rising threshold until the
        groups drain (at most W + GSLOT + 8 steps, as the JAX kernel)."""
        for k in range(self.W + GSLOT + 8):
            alive = (self.Gu & mask).any(0)
            if not alive.any():
                return
            self._save_masked(thresh0 + k, mask & alive)

    def _shift_window(self, t, mask):
        """src/sdust/sdust.c:66-86: pop the oldest word when the window is
        full, push t, run the cv * 10 > 2T eviction."""
        m = mask.long()
        full = mask & (self.lenw >= self.NW)
        s = self.ring[self.NW - 1:self.NW]
        self.cw.scatter_add_(0, s, -full.long()[None])
        self.rw = self.rw - torch.where(full, self.cw.gather(0, s)[0], 0)
        shrink = full & (self.L >= self.lenw)
        self.L = self.L - shrink.long()
        self.cv.scatter_add_(0, s, -shrink.long()[None])
        self.rv = self.rv - torch.where(shrink, self.cv.gather(0, s)[0], 0)
        self.lenw = torch.where(mask, (self.lenw + 1).clamp(max=self.NW),
                                self.lenw)
        ring = torch.where(mask, torch.roll(self.ring, 1, 0), self.ring)
        ring[0] = torch.where(mask, t, ring[0])
        self.ring = ring
        t1 = t[None]
        self.L = self.L + m
        self.rw = self.rw + m * self.cw.gather(0, t1)[0]
        self.cw.scatter_add_(0, t1, m[None])
        self.rv = self.rv + m * self.cv.gather(0, t1)[0]
        self.cv.scatter_add_(0, t1, m[None])
        evict = mask & (self.cv.gather(0, t1)[0] * 10 > (self.T << 1))
        if not evict.any():
            return
        # pops run oldest-first until the oldest occurrence of t pops: the
        # new v-window is every row newer than that occurrence
        occ = (self.ring == t) & (self.iota_r < self.L)
        j_old = torch.where(occ, self.iota_r, -1).amax(0)
        L_new = torch.where(evict, j_old, self.L)
        cv = torch.zeros_like(self.cv).scatter_add_(
            0, self.ring, (self.iota_r < L_new).long())
        self.cv = torch.where(evict, cv, self.cv)
        self.rv = torch.where(evict, (self.cv * (self.cv - 1) // 2).sum(0),
                              self.rv)
        self.L = L_new

    def _find_perfect(self, start, fp):
        """src/sdust/sdust.c:104-128 on the lanes in fp, for all rows rr of
        the sweep at once.  The sweep's running (max_r, max_l) only ever
        takes the ratio maximum of what it has seen: the pending groups
        with start >= the candidate's (incorporated before the test, strict
        >) and the earlier firing candidates (>=, and a candidate that is
        not inserted is below the maximum already).  So candidate rr is
        inserted iff it fires and r/l >= the maximum of those ratios.
        Ratios are compared as float64: r <= C(64, 2) and l < 64, so two
        different ratios differ by more than 1/4096 and equal ratios round
        to the same double; the comparison is exact."""
        idx = fp.nonzero()[:, 0]
        ring, cv = self.ring[:, idx], self.cv[:, idx]
        L, lenw, st = self.L[idx], self.lenw[idx], start[idx]
        rr = self.iota_r
        act = (rr >= L) & (rr < lenw) & (rr >= 1)                # (64, k)
        self.steps[idx] += act.sum(0)
        # c[t_rr] when row rr is reached: cv plus the sweep's earlier rows
        earlier = act[None, :, :] & (rr[None, :, :] < rr[:, None, :])
        same = ring[:, None, :] == ring[None, :, :]
        cnt = (same & earlier).sum(1)
        inc = torch.where(act, cv.gather(0, ring) + cnt, 0)
        r_acc = self.rv[idx] + inc.cumsum(0)
        fire = act & (r_acc * 10 > self.T * rr)
        if not fire.any():
            return
        ninf = float("-inf")
        ratio = r_acc.double() / rr.clamp(min=1).double()
        cand = torch.where(fire, ratio, ninf)
        prev = torch.cat([torch.full_like(cand[:1], ninf),
                          cand.cummax(0).values[:-1]])
        # pending groups by d = (group start) - st, 0 <= d < ROWS
        Gs, Gr, Gl, Gu = (self.Gs[:, idx], self.Gr[:, idx], self.Gl[:, idx],
                          self.Gu[:, idx])
        d = torch.where(Gu, Gs - st, ROWS).clamp(0, ROWS)
        g = torch.where(Gu, Gr.double() / Gl.clamp(min=1).double(), ninf)
        by_d = torch.full((ROWS + 1, len(idx)), ninf, dtype=torch.float64,
                          device=ring.device).scatter_reduce_(
            0, d, g, "amax")[:ROWS]
        suffix = by_d.flip(0).cummax(0).values.flip(0)
        e_s = lenw - 1 - rr + st
        gmax = suffix.gather(0, (lenw - 1 - rr).clamp(0, ROWS - 1))
        best = torch.maximum(prev, gmax)
        ins = fire & (ratio >= best)
        # insert into slot e_s & 127: the newest finish overwrites, the
        # group's winner changes only for a strictly better ratio
        slot = e_s & (GSLOT - 1)
        gr, gl, gu = Gr.gather(0, slot), Gl.gather(0, slot), Gu.gather(0, slot)
        win = ~gu | (r_acc * gl > gr * rr)
        to = torch.where(ins, slot, GSLOT)
        e_f = (lenw + (SD_WLEN - 1) + st).expand_as(slot)
        for name, val in (("Gs", e_s), ("Gf", e_f),
                          ("Gr", torch.where(win, r_acc, gr)),
                          ("Gl", torch.where(win, rr.expand_as(gl), gl)),
                          ("Gu", torch.ones_like(gu))):
            plane = getattr(self, name)
            buf = torch.cat([plane[:, idx], plane[:1, idx]])
            buf.scatter_(0, to, val.to(plane.dtype))
            plane[:, idx] = buf[:GSLOT]

    def run(self):
        W, T = self.W, self.T
        for i in range(self.clen):
            b = self.codes[i]
            isN = b >= 4
            l_old = self.lrun
            flush = isN & self.Gu.any(0)
            if flush.any():
                th0 = (l_old - W + 1).clamp(min=0) + (i + 1 - l_old)
                self._flush(torch.where(flush, th0, _BIG), flush)
            self.lrun = torch.where(isN, 0, l_old + 1)
            self.tw = torch.where(isN, 0, ((self.tw << 2) | b.clamp(max=3))
                                  & (ROWS - 1))
            ready = ~isN & (self.lrun >= SD_WLEN)
            if not ready.any():
                continue
            start = (self.lrun - W).clamp(min=0) + (i + 1 - self.lrun)
            self._save_masked(start, ready)
            self._shift_window(self.tw, ready)
            fp = ready & (self.rw * 10 > self.L * T)
            if fp.any():
                self._find_perfect(start, fp)
        # end of the row: the virtual N at i == CLEN
        l_old = self.lrun
        th0 = (l_old - W + 1).clamp(min=0) + (self.clen + 1 - l_old)
        self._flush(th0, torch.ones_like(self.res_has))
        self._emit(self.res_has)
        i32 = torch.int32
        return (self.outs.t().to(i32).contiguous(),
                self.outf.t().to(i32).contiguous(), self.outn.to(i32),
                self.steps)


def _check(codes, row_off, clen: int, W: int) -> None:
    if not isinstance(codes, torch.Tensor) or codes.dim() != 1 or \
            codes.dtype != torch.uint8:
        raise TypeError("codes must be a 1-D uint8 tensor")
    if not isinstance(row_off, torch.Tensor) or row_off.dim() != 1 or \
            row_off.dtype != torch.int64:
        raise TypeError("row_off must be a 1-D int64 tensor")
    if not (codes.is_contiguous() and row_off.is_contiguous()):
        raise ValueError("codes and row_off must be contiguous")
    if row_off.device != codes.device:
        raise ValueError("codes and row_off must be on one device")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % codes.device)
    if not 1 <= len(row_off) < 1 << 31:
        raise ValueError("1..2^31-1 rows (got %d)" % len(row_off))
    if not 1 <= clen < 1 << 30:
        raise ValueError("clen must be in 1..2^30-1 (got %d)" % clen)
    check_window(W)
    if int(row_off.min()) < 0 or int(row_off.max()) + clen > len(codes):
        raise ValueError("a row runs past the codes")


def sdust_dp_ref(codes: torch.Tensor, row_off: torch.Tensor, clen: int,
                 T: int = 20, W: int = DEF_W, return_steps: bool = False):
    """Plain PyTorch version of ``sdust_dp`` (same arguments and result);
    runs on any device.  return_steps: also return each row's count of
    find_perfect row-steps ((n,) int64), the work the light pass budgets."""
    _check(codes, row_off, clen, W)
    pos = row_off[None, :] + torch.arange(clen, device=codes.device)[:, None]
    *out, steps = _LaneDP(codes[pos].long(), T, W).run()
    return (*out, steps) if return_steps else tuple(out)


def sdust_dp(codes: torch.Tensor, row_off: torch.Tensor, clen: int,
             T: int = 20, W: int = DEF_W, budget: int = None,
             stats: dict = None):
    """The SDUST DP of each row codes[row_off[r] : row_off[r] + clen]
    (uint8 codes, 4 = N; the row's end is an N).  Returns (starts,
    finishes, count): int32 (n, MAXI), (n, MAXI) and (n,) with
    MAXI = max_intervals(clen), the first min(count, MAXI) intervals of
    each row in row-local coordinates, zero elsewhere.  A count >= MAXI
    marks an overflow row (its intervals are incomplete).

    A CUDA input launches the light pass and then the heavy pass over the
    rows past ``budget`` find_perfect row-steps (default
    ``default_budget(n, device)``), on the current stream without
    synchronising, and adds one to ``sdust_dp.launches`` for each launch;
    ``budget=0`` is the light pass alone over every row.  stats:
    optional dict; the call adds the passes' milliseconds (CUDA events;
    ``light_ms``, ``heavy_ms``) and the number of heavy rows
    (``heavy_rows``) to it, which synchronises the card."""
    _check(codes, row_off, clen, W)
    if budget is not None and budget < 0:
        raise ValueError("budget must be >= 0 (got %d)" % budget)
    if codes.device.type == "cpu":
        return sdust_dp_ref(codes, row_off, clen, T, W)
    n, maxi = len(row_off), max_intervals(clen)
    dev = codes.device
    if budget is None:
        budget = default_budget(n, dev)
    starts = torch.zeros((n, maxi), dtype=torch.int32, device=dev)
    fins = torch.zeros_like(starts)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    heavy_rows = torch.empty(n, dtype=torch.int32, device=dev)
    n_heavy = torch.zeros(1, dtype=torch.int32, device=dev)
    light = _build.bind(_KERNEL, "cornetto_sdust_light", "ppiiiiiipppppp")
    heavy = _build.bind(_KERNEL, "cornetto_sdust_heavy", "ppiiiiipppppp")
    args = (codes.data_ptr(), row_off.data_ptr())
    outs = (starts.data_ptr(), fins.data_ptr(), count.data_ptr(),
            heavy_rows.data_ptr(), n_heavy.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if stats is not None else None
        if ev:
            ev[0].record(stream)
        _build.launch(light, "sdust light-pass", dev, *args, n, clen, T, W,
                      maxi, budget, *outs)
        sdust_dp.launches += 1
        if ev:
            ev[1].record(stream)
        if budget:
            _build.launch(heavy, "sdust heavy-pass", dev, *args, n, clen, T,
                          W, maxi, *outs)
            sdust_dp.launches += 1
        if ev:
            ev[2].record(stream)
            ev[2].synchronize()
            for key, v in (("light_ms", ev[0].elapsed_time(ev[1])),
                           ("heavy_ms", ev[1].elapsed_time(ev[2])),
                           ("heavy_rows", int(n_heavy.item()))):
                stats[key] = stats.get(key, 0) + v
    return starts, fins, count


sdust_dp.launches = 0


def _row_lists(starts, fins, count, maxi: int):
    """Tensors of sdust_dp -> (per-row interval lists, overflow mask)."""
    s, f, c = starts.cpu().numpy(), fins.cpu().numpy(), count.cpu().numpy()
    overflow = c >= maxi
    per_row = [[] for _ in range(len(c))]
    for r in np.flatnonzero((c > 0) & ~overflow):
        k = int(c[r])
        per_row[r] = list(zip(s[r, :k].tolist(), f[r, :k].tolist()))
    return per_row, overflow


def _rows_args(rows: torch.Tensor):
    if not isinstance(rows, torch.Tensor) or rows.dim() != 2:
        raise TypeError("rows must be a 2-D uint8 tensor")
    n, clen = rows.shape
    off = torch.arange(n, dtype=torch.int64, device=rows.device) * clen
    return rows.reshape(-1), off, clen


def sdust_chunks(rows: torch.Tensor, T: int = 20, W: int = DEF_W):
    """rows (n, CLEN) uint8 codes (4 = N).  Returns (per-row interval lists
    in row-local coordinates, overflow mask): sdust_pallas_chunks' result.
    On a CUDA tensor this is one kernel launch (``sdust_dp``)."""
    codes, off, clen = _rows_args(rows)
    return _row_lists(*sdust_dp(codes, off, clen, T, W), max_intervals(clen))


def sdust_chunks_ref(rows: torch.Tensor, T: int = 20, W: int = DEF_W):
    """Plain PyTorch version of ``sdust_chunks``."""
    codes, off, clen = _rows_args(rows)
    return _row_lists(*sdust_dp_ref(codes, off, clen, T, W),
                      max_intervals(clen))


def plan_rows(codes: np.ndarray, W: int = DEF_W, core: int = 2048,
              sites: np.ndarray = None):
    """The shared chunk plan of one sequence's codes (0-3, 4 = N) and the
    rows of ``sdust_dp`` over it: (chunks, host spans, padded codes, row
    offsets, clen).  Row r is padded[a_r : a_r + clen]: ctx = 4W N's before
    the sequence and core + W + 8 after, so each row holds exactly
    sdust_pallas' codes.  padded and the offsets are None without chunks.
    sites: find_n_sites(codes), where the caller has it."""
    if sites is None:
        sites = find_n_sites(codes)
    a, chunks, host = plan_from_sites(len(codes), sites, core, W)
    ctx = 4 * W
    clen = ctx + core + W + 8
    if not chunks:
        return chunks, host, None, None, clen
    padded = np.empty(len(codes) + clen, dtype=np.uint8)
    padded[:ctx] = 4
    padded[ctx:ctx + len(codes)] = codes
    padded[ctx + len(codes):] = 4
    return chunks, host, padded, a, clen


def sdust_device(seq: bytes, T: int = 20, W: int = DEF_W, core: int = 2048,
                 device=None, stats: dict = None):
    """SDUST of one sequence with the DP on ``device`` (default
    device.resolve_device()): the shared chunk plan, one ``sdust_dp`` over
    all chunks of the padded sequence, the N-proximal spans and the
    overflow rows on the shared native DP, the shared assemble.  Equal to
    sdust_pallas and to the sequential DP.

    stats: optional dict; the call adds its counts (chunks, n_sites: the N
    positions the plan indexed, overflow_rows, host_span_bases,
    heavy_rows), its seconds per part (plan, h2d, kernel,
    readback, overflow, host_spans, assemble) and the kernel's passes in
    milliseconds (light_ms, heavy_ms) to it, synchronising the card at the
    end of each part.  Under a profiler each part is the span
    ``sdust.<part>``, timed by the same clock (utils.profiling.lap)."""
    check_params(W, T)
    dev = resolve_device(device)
    acc = {} if stats is None else stats

    def lap(part):
        return profiling.lap("sdust." + part, stats, dev)

    with lap("plan") as span:
        codes = encode(seq)
        sites = find_n_sites(codes)
        span.count(n_sites=len(sites))
        chunks, host, padded, a, clen = plan_rows(codes, W, core,
                                                  sites=sites)
    ctx = 4 * W
    per_chunk = []
    overflow = np.zeros(0, dtype=bool)
    if chunks:
        with lap("h2d"):
            codes_t = torch.from_numpy(padded).to(dev)
            off_t = torch.from_numpy(a).to(dev)
        with lap("kernel"):
            out = sdust_dp(codes_t, off_t, clen, T, W, stats=stats)
        with lap("readback"):
            per_row, overflow = _row_lists(*out, max_intervals(clen))
        with lap("overflow"):
            for r, (ca, _b, c0, stop) in enumerate(chunks):
                if overflow[r]:
                    per_chunk.append(sdust_exact(seq[c0:stop], T=T, W=W))
                elif per_row[r]:
                    d = ca - ctx - c0          # row-local -> slice-local
                    per_chunk.append([(s + d, f + d)
                                      for s, f in per_row[r]])
                else:
                    per_chunk.append(per_row[r])
    with lap("host_spans"):
        host_parts = run_host_spans(seq, host, T, W)
    with lap("assemble"):
        res = assemble(per_chunk, chunks, host_parts, W)
    for key, n in (("chunks", len(chunks)), ("n_sites", len(sites)),
                   ("overflow_rows", int(overflow.sum())),
                   ("host_span_bases", sum(min(b + W + 8, len(seq)) - q
                                           for q, _a, b in host))):
        acc[key] = acc.get(key, 0) + n
    return res
