#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (cornetto_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU with the CUDA toolkit (nvcc).  Run from the root of a
checkout.  It:

1. prints the card, its power limit and the toolchain;
2. builds the minimizer-extraction kernel from cornetto_tpu_torch/csrc;
3. holds the kernel bit-equal to its plain PyTorch version on the card in
   all three validity variants, and times both; the same for the window-sum
   kernel in 11 cases (chr1's two tracks timed, with x.unfold(...).sum(...)
   as the library yardstick);
4. builds a seeded synthetic draft at human scale (GRCh38's chromosome
   lengths, 3.09 Gbp in 87 contigs), its minimizer index (the port's host
   index build) and a panel of half its 1 Mb blocks, under build/smoke/
   (reused on a rerun with the same seed), and uploads the index;
5. runs 64 full batches of 4096 sampled 450-base reads plus a short tail
   through `cornetto_tpu_torch.cli livefish run`, checking one row per read
   and one kernel launch per batch; it then runs a second draft small
   enough for 15-mer seeds to be nearly unique (24 Mbp, 96 contigs) through
   the same entry point and requires >= 99% right contigs and decisions on
   genomic reads and `proceed` on every junk read;
6. decides the first two batches again on the CPU (plain versions) and
   requires byte-identical rows;
7. prints end-to-end reads/s and the per-layer times of one batch;
8. runs `boringbits` / `noboringbits` through `cornetto_tpu_torch.cli` with
   the four golden option sets on test_data/synth and requires output
   byte-equal to test_data/golden and window-sum launches;
9. at human scale: window stats of seeded uint16 depth and MQ tracks for
   all 87 contigs on the card against the plain version, then
   `create-panel --ranged-bedgraph` on chr1-chr3 (689 Mbp) against a
   CORNETTO_FORCE_CPU=1 run, byte for byte;
10. one aligner-free iteration, `cornetto_tpu_torch.cli flow` on a 32 Mbp
   draft with coverage holes and ~430k reads (livefish cov -> create-panel
   -> telostats -> livefish index), checking the launches and the panel,
   then `livefish cov` on two batches on the card against the CPU;
11. writes the annotation draft of phase 13 (reused per seed) and holds
   the SDUST, telomere-mask and run-stats kernels equal to their plain
   versions on the card (SDUST in both designs, the light + heavy passes
   and PR 3's single pass, on seeded mixed chunks at core 512, also at
   W = 3, 4, 8 and 66 with T = 5 or 14 and a budget of 16 row-steps, and at
   the main path's shape, core 2048, on chunks of the draft's 20 Mb slice
   plus overflow rows; chr1's length as one row; read batches with
   telomeric arrays and the doubling-cap cases), and times both; SDUST's
   two designs are timed in turns (old, new, new, old) on the slice chunks
   alone, the seeded rows alone, the costliest row alone (by the plain
   version's find_perfect row-steps) and the main-path case; then the two
   passes' time against the light pass's budget on the main-path case and
   on 1,024 chunks to all of chr1's of the cut, each held equal to PR 3's
   single pass;
12. runs the annotation goldens (sdust, telofind on the device backends,
   the default and named, telowin, telobreaks) through
   `cornetto_tpu_torch.cli` on the card, byte-equal to test_data/golden;
13. the annotation chain at human scale: chr1-chr3 (689 Mbp) with seeded
   satellites, telomere arrays and N gaps through `sdust` and `telofind`
   (their default, device backends), then `telowin` and `telobreaks` on
   their outputs and read tagging with the run-stats kernel; a second sdust
   run gives the per-part split and the SDUST kernel's time as light pass
   plus heavy pass with the number of heavy rows; telofind byte-equal to
   its `--backend host` on the whole cut, sdust on a 20 Mb slice;
14. runs the `cuda`-marked tests of tests/test_torch_cuda_kernels.py
   through `python -m pytest --noconftest -m cuda` in a subprocess (the
   file imports neither jax nor the JAX package) and requires every test
   it collects to pass.

Phase 2 builds the four kernel sources in parallel; phases 3 and 11 hold
each kernel bit-equal to its plain PyTorch version on the card.  Imports
nothing of the JAX package: the index, the parsers and the host DP are the
port's own.  Prints the numbers, each phase's seconds, a {"kernels": [...]}
line (each kernel's launches on its main path, error, time, plain time,
bound and the bound's kind, and the time of one PyTorch call computing the
same function where there is one), the nvidia-smi name/power line, and
last {"ok": true, "device": {...}}.  Any failure exits non-zero with no
result.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, READ_LEN, K, W = 4096, 450, 15, 10
FULL_BATCHES, TAIL = 64, 1000
KERNELS = ("extract_minima", "window_sum", "sdust", "telo")
WIN, INC = 2500, 50                      # boringbits' default window

# the least time the card could take for a kernel's work (bound_ms): its
# bytes (each input read once, each output written once) over the HBM rate
# of an H100 SXM, or its integer operations over the card's int32 rate
# (64 INT32 lanes an SM x 132 SMs x 1.98 GHz boost clock), whichever is the
# larger.  Operations a unit of work, counted from what the function must
# compute: a k-mer position of extraction (2-bit decode, forward and
# reverse-complement update, canonical min, the 7-step hash finalizer,
# validity and window min); a base step of the SDUST DP (word update,
# save, window shift with its counters and the find_perfect test); a
# find_perfect row-step (count lookup and update, the r update, the firing
# test, the ratio comparisons); a byte compare of the motif match, counted
# as the input needs them when each start stops at its first mismatch
# (early_exit_compares).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
EXTRACT_OPS_KMER = 25
SDUST_OPS_BASE, SDUST_OPS_ROW_STEP = 20, 8


def early_exit_compares(x, motif) -> int:
    """Byte compares a match of motif at every start of x's rows needs when
    each start stops at its first mismatch (starts past L - k included:
    they stop at the row's end)."""
    import torch
    k, L = len(motif), x.shape[-1]
    alive = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    total = 0
    for j, m in enumerate(motif):
        total += int(alive[..., :L - j].sum(dtype=torch.int64))
        alive[..., :L - j] &= x[..., j:] == m
        alive[..., L - j:] = False
    return total


def bound(work):
    """(bound_ms, bound_by) of a kernel's {"bytes", "ops"}."""
    by_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = work["ops"] / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")

# GRCh38 primary assembly chromosome lengths (chr1..chr22, chrX, chrY)
GRCH38 = [248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
          159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
          114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
          58617616, 64444167, 46709983, 50818468, 156040895, 57227415]


def fail(msg: str):
    sys.stderr.write("chip_smoke: FAIL: %s\n" % msg)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------- drafts

def human_draft(seed: int):
    """87 contig lengths summing to GRCh38's 3.09 Gbp: chr1-chr3 whole
    (largest 249 Mb), every other chromosome cut in 4 at seeded points."""
    import numpy as np
    rng = np.random.default_rng([seed, 1])
    out = []
    for ci, n in enumerate(GRCH38):
        if ci < 3:
            out.append(("chr%d" % (ci + 1), n))
            continue
        cuts = np.sort(rng.integers(n // 10, n - n // 10, size=3))
        edges = [0, *cuts.tolist(), n]
        for j in range(4):
            out.append(("chr%d_%d" % (ci + 1, j), edges[j + 1] - edges[j]))
    return out


def small_draft():
    """96 contigs of 250 kb (24 Mbp): 15-mers nearly unique."""
    return [("ctg%d" % i, 250_000) for i in range(96)]


def genome_codes(seed: int, contigs):
    import numpy as np
    return [np.random.default_rng([seed, 2, i]).integers(
        0, 4, size=n, dtype=np.uint8) for i, (_, n) in enumerate(contigs)]


def panel_rows(seed: int, contigs, block: int):
    """A seeded half of each contig's blocks as BED rows."""
    import numpy as np
    rng = np.random.default_rng([seed, 3])
    rows = []
    for name, n in contigs:
        for b in range(-(-n // block)):
            if rng.random() < 0.5:
                rows.append((name, b * block, min((b + 1) * block, n)))
    return rows


def build_or_load_index(path: str, contigs, codes, rows):
    """Build (or reuse) the index + panel checkpoint at path(.npz)."""
    import numpy as np
    from cornetto_tpu_torch.dist.checkpoint import save_index
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    stamp = path + ".done"
    if os.path.exists(stamp) and os.path.exists(path + ".npz"):
        log("index: reusing %s.npz" % path)
        return
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    t0 = time.perf_counter()
    idx = build_index(((name, ascii_[c].tobytes().decode("ascii"))
                       for (name, _), c in zip(contigs, codes)),
                      n_shards=1, k=K, w=W, keep_tables=False)
    panel = build_panel_mask(idx, rows)
    save_index(path, idx, panel_mask=panel)
    open(stamp, "w").close()
    dt = time.perf_counter() - t0
    log("index: built %d contigs, %.3f Gbp, %d buckets x %d slots, dropped "
        "%.4f%%, in %.1f s -> %s.npz"
        % (len(contigs), sum(n for _, n in contigs) / 1e9,
           idx.btable.shape[1], idx.bucket_slots, 100 * idx.dropped_frac,
           dt, path))


def write_reads(path: str, seed: int, contigs, codes, rows, block: int,
                n_reads: int):
    """Sample n_reads FASTQ records: ~2% junk, the rest whole inside one
    panel-or-not block (half each), half reverse-complemented; batch 0 has
    reads with interior Ns, batch 1 short reads.  Returns the truth as
    (contig id or -1 for junk, expected decision) per read."""
    import numpy as np
    rng = np.random.default_rng([seed, 4])
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    lens = np.array([n for _, n in contigs], dtype=np.int64)
    in_panel = {(name, s // block) for name, s, _ in rows}
    # per contig: the blocks that hold a whole read, panel and not
    pools = []
    for name, n in contigs:
        ok = [b for b in range(-(-n // block))
              if min((b + 1) * block, n) - b * block > READ_LEN]
        pools.append(([b for b in ok if (name, b) in in_panel],
                      [b for b in ok if (name, b) not in in_panel]))
    ctg = rng.choice(len(contigs), size=n_reads, p=lens / lens.sum())
    want_panel = rng.random(n_reads) < 0.5
    junk = rng.random(n_reads) < 0.02
    rc = rng.random(n_reads) < 0.5
    u_block, u_start = rng.random(n_reads), rng.random(n_reads)
    seq_len = np.full(n_reads, READ_LEN, dtype=np.int64)
    short = np.arange(BATCH, min(2 * BATCH, n_reads))[::16]
    seq_len[short] = rng.integers(120, READ_LEN, size=len(short))
    mat = rng.integers(0, 4, size=(n_reads, READ_LEN), dtype=np.uint8)
    truth_ctg = np.where(junk, -1, ctg)
    truth_dec = np.array(["proceed"] * n_reads, dtype=object)
    for i in np.flatnonzero(~junk):
        c = int(ctg[i])
        pan, non = pools[c]
        pool, is_pan = (pan, True) if (want_panel[i] and pan) or not non \
            else (non, False)
        b = pool[int(u_block[i] * len(pool))]
        lo = b * block
        hi = min(lo + block, contigs[c][1]) - READ_LEN
        s = lo + int(u_start[i] * (hi - lo + 1))
        mat[i] = codes[c][s:s + READ_LEN]
        if is_pan:
            truth_dec[i] = "unblock"
    mat[rc] = 3 - mat[rc, ::-1]
    text = ascii_[mat]
    n_rows = np.arange(min(BATCH, n_reads))[::64]         # interior Ns
    for i in n_rows:
        text[i, rng.integers(20, READ_LEN - 20, size=3)] = ord("N")
    qual = b"I" * READ_LEN
    with open(path, "wb") as f:
        for i in range(n_reads):
            ln = int(seq_len[i])
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, text[i, :ln].tobytes(),
                                            qual[:ln]))
    return truth_ctg, truth_dec


def run_cli(idx_path: str, fq: str, tsv: str):
    from cornetto_tpu_torch.cli import main
    with open(tsv, "w") as f, contextlib.redirect_stdout(f):
        rc = main(["cornetto", "livefish", "run", idx_path, fq])
    if rc != 0:
        fail("livefish run exited %d" % rc)
    with open(tsv) as f:
        return f.read().splitlines()


def score(rows, names, truth_ctg, truth_dec):
    """-> (genomic right contig, right decision, both, junk proceed)
    fractions."""
    import numpy as np
    if len(rows) != len(truth_ctg):
        fail("%d rows for %d reads" % (len(rows), len(truth_ctg)))
    ok_ctg = np.zeros(len(rows), bool)
    ok_dec = np.zeros(len(rows), bool)
    for line in rows:
        rid, dec, ctg = line.split("\t")[:3]
        i = int(rid[1:])
        t = truth_ctg[i]
        ok_ctg[i] = t < 0 or ctg == names[t]
        ok_dec[i] = dec == truth_dec[i]
    gen = truth_ctg >= 0
    return (float(ok_ctg[gen].mean()), float(ok_dec[gen].mean()),
            float((ok_ctg & ok_dec)[gen].mean()), float(ok_dec[~gen].mean()))


# ---------------------------------------------------------------- device

def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi failed: %s" % smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0].strip()
    from cornetto_tpu_torch.kernels._build import nvcc_path
    nv = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                        text=True, timeout=60)
    log("[1 device] %s | torch %s | CUDA %s | python %s"
        % (card, torch.__version__, torch.version.cuda,
           sys.version.split()[0]))
    log("[1 device] nvcc: %s" % nv.stdout.strip().splitlines()[-1])
    log("[1 device] cards visible: %d, using %s"
        % (torch.cuda.device_count(), torch.cuda.get_device_name(0)))
    return card


def phase_build():
    """Every kernel, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from cornetto_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        for fut in [ex.submit(_build.load, name) for name in KERNELS]:
            fut.result()
    dt = time.perf_counter() - t0
    for name in KERNELS:
        info = _build.build_info.get(name)
        log("[2 build] %s.cu -> %s (%s)"
            % (name, _build.library_path(name),
               "nvcc %.2f s" % info[0] if info else "cached"))
        if info:
            for line in info[1].splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log("[2 build]   ptxas: %s" % line.strip())
    log("[2 build] all %d kernels in %.2f s" % (len(KERNELS), dt))
    return dt


def _kernel_inputs(seed, B, L, k, variant, dev):
    import numpy as np
    import torch
    from cornetto_tpu_torch.kernels.minimizer import pack_reads
    rng = np.random.default_rng([seed, B, L, k])
    reads = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = None
    if variant == "nmask":
        reads[rng.random((B, L)) < 0.01] = 4
    elif variant == "lengths":
        lengths = np.full(B, L, dtype=np.int32)
        short = rng.random(B) < 0.25
        lengths[short] = rng.integers(k - 1, L, size=int(short.sum()))
    packed, nmask = pack_reads(reads)
    nm = nmask if variant == "nmask" else None
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in (packed, nm, lengths)]


def phase_kernels(seed: int):
    """Kernel vs plain on the card; returns the main-path timing row."""
    import torch
    from cornetto_tpu_torch.kernels.extract import (extract_minima,
                                                    extract_minima_ref)
    dev = torch.device("cuda")
    shapes = [(4096, 450, 15, 10), (512, 1800, 15, 10), (64, 1024, 13, 8)]
    worst = 0
    timing = {}
    for B, L, k, w in shapes:
        for variant in ("nfree", "lengths", "nmask"):
            pk, nm, ln = _kernel_inputs(seed, B, L, k, variant, dev)
            h, v = extract_minima(pk, nm, L, k, w, lengths=ln)
            torch.cuda.synchronize()
            hr, vr = extract_minima_ref(pk, nm, L, k, w, lengths=ln)
            err = int((h.to(torch.int64) & 0xFFFFFFFF).sub(
                hr.to(torch.int64) & 0xFFFFFFFF).abs().max())
            vbad = int((v != vr).sum())
            worst = max(worst, err)
            line = ("[3 kernel] (%d, %d) k=%d w=%d %-7s max_abs_err=%d "
                    "valid_mismatch=%d" % (B, L, k, w, variant, err, vbad))
            if (B, L) == (4096, 450):
                ms = cuda_ms(lambda: extract_minima(pk, nm, L, k, w,
                                                    lengths=ln), 200)
                ms_ref = cuda_ms(lambda: extract_minima_ref(
                    pk, nm, L, k, w, lengths=ln), 10)
                m = (L - k + 1) // w
                timing[variant] = dict(
                    ms=ms, plain_ms=ms_ref, bytes=pk.numel() + B * m * 5,
                    ops=B * (L - k + 1) * EXTRACT_OPS_KMER)
                line += " kernel %.4f ms plain %.4f ms" % (ms, ms_ref)
            log(line)
            if err or vbad or not torch.equal(h, hr):
                fail("kernel disagrees with its plain version at "
                     "(%d, %d) %s" % (B, L, variant))
    # argmax ties on the card: the first maximum, as jnp.argmax
    t = torch.tensor([[3, 7, 7, 1], [0, 0, 0, 0], [5, 2, 5, 5]],
                     dtype=torch.int32, device=dev)
    got = torch.argmax(t, dim=1).tolist()
    log("[3 kernel] argmax ties on the card -> %s" % got)
    if got != [1, 0, 0]:
        fail("torch.argmax does not return the first maximum on the card")
    return worst, timing


# ---------------------------------------------------------------- panel path

# (name, N, W, S, rows, dtype): chr1 at the defaults (the main path's
# shape), the TPU kernel's stride-1 contract, odd windows, W % S != 0 on an
# odd N, W = 1, W past the JAX path's int32 limit, N < W, an N that is a
# prime, int32 values across the whole range ("int32full"), and an N
# shorter than one 16-byte vector of either type
WS_CASES = [("chr1", 248_956_422, WIN, INC, 2, "uint16"),
            ("stride1", 1 << 24, WIN, 1, 1, "int32"),
            ("odd", 10_000_019, 999, 37, 2, "uint16"),
            ("w%s", 10_000_019, 1000, 37, 2, "uint16"),
            ("w1", 1_000_003, 1, 1, 2, "int32"),
            ("w40000", 10_000_019, 40_000, INC, 2, "uint16"),
            ("n<w", 1000, WIN, INC, 2, "uint16"),
            ("prime", 15_485_863, WIN, INC, 2, "int32"),
            ("i32full", 10_000_019, 1000, 37, 2, "int32full"),
            ("n<vec", 3, 2, 1, 3, "uint16"),
            ("n<vec32", 3, 2, 1, 3, "int32full")]


def phase_window_kernel(seed: int):
    """Window-sum kernel vs plain on the card; returns (worst error, chr1
    (kernel ms, plain ms))."""
    import torch
    from cornetto_tpu_torch.kernels.window_sum import (n_windows,
                                                       window_sums,
                                                       window_sums_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst, timing = 0, None
    for name, n, w, s, rows, dt in WS_CASES:
        lo, hi = (-1 << 31, 1 << 31) if dt == "int32full" else (0, 65536)
        x = torch.randint(lo, hi, (rows, n), generator=gen, device=dev,
                          dtype=torch.int64)
        if dt == "int32full":            # window sums far past int32
            x[0, :n // 2] = hi - 1
            x[-1, :n // 2] = lo
        x = x.to(torch.uint16 if dt == "uint16" else torch.int32)
        nw = n if s == 1 else n_windows(n, w, s)
        got = window_sums(x, w, s, nw)
        torch.cuda.synchronize()
        ref = window_sums_ref(x, w, s, nw)
        err = int((got - ref).abs().max())
        worst = max(worst, err)
        line = ("[3 kernel] window_sum %-7s (%d, %d) %s W=%d S=%d nw=%d "
                "max_abs_err=%d" % (name, rows, n, dt, w, s, nw, err))
        if name == "chr1":
            ms = cuda_ms(lambda: window_sums(x, w, s, nw), 20, warmup=3)
            ms_ref = cuda_ms(lambda: window_sums_ref(x, w, s, nw), 5,
                             warmup=2)
            # the library yardstick: one PyTorch call for the full windows,
            # on an int64 copy of the tracks (a reduction to another dtype
            # first casts the whole unfolded view: 185 GiB at chr1)
            src = x.to(torch.int64)
            lib = lambda: src.unfold(-1, w, s).sum(-1, dtype=torch.int64)  # noqa
            full = lib()
            lib_same = torch.equal(full, got[:, :full.shape[1]])
            lib_ms = cuda_ms(lib, 5, warmup=2)
            timing = dict(ms=ms, plain_ms=ms_ref, library_ms=lib_ms,
                          bytes=x.numel() * x.element_size() + rows * nw * 8,
                          ops=rows * (n + nw))
            line += (" kernel %.4f ms plain %.4f ms; x.unfold(-1, W, S)"
                     ".sum(-1, dtype=torch.int64) on %s %.4f ms on its %d "
                     "full windows, equal: %s"
                     % (ms, ms_ref, src.dtype, lib_ms, full.shape[1],
                        lib_same))
            if not lib_same:
                fail("the library yardstick disagrees with the kernel")
            del full, src
        log(line)
        if err or not torch.equal(got, ref):
            fail("window-sum kernel disagrees with its plain version in "
                 "case %s" % name)
        del x, got, ref
        torch.cuda.empty_cache()
    return worst, timing


CUDA_TESTS = "tests/test_torch_cuda_kernels.py"


def phase_cuda_tests(work: str):
    """The `cuda`-marked tests through pytest in a subprocess (no conftest:
    tests/conftest.py imports jax); every test the file collects must
    pass."""
    import xml.etree.ElementTree as ET
    xml = os.path.join(work, "cuda_tests.xml")
    if os.path.exists(xml):
        os.remove(xml)
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
           "no:cacheprovider", "-m", "cuda", CUDA_TESTS,
           "--junitxml=" + xml]
    env = {k: v for k, v in os.environ.items()
           if k != "CORNETTO_FORCE_CPU"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=900)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    if not os.path.exists(xml):
        fail("pytest wrote no report (exit %d):\n%s\n%s"
             % (proc.returncode, proc.stdout[-3000:], proc.stderr[-2000:]))
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k)) for k in ("tests", "failures", "errors",
                                        "skipped")}
    passed = n["tests"] - n["failures"] - n["errors"] - n["skipped"]
    log("[14 cuda tests] %s: %d collected, %d passed, %d failed, %d errors, "
        "%d skipped, pytest exit %d, %.1f s (%s)"
        % (" ".join(cmd[2:-1]), n["tests"], passed, n["failures"],
           n["errors"], n["skipped"], proc.returncode, secs, tail[0]))
    if proc.returncode != 0 or not n["tests"] or passed != n["tests"]:
        fail("the cuda tests did not all pass:\n%s" % proc.stdout[-4000:])


GOLDEN_RUNS = [
    ("boring_t1.txt", "boringbits", ["-m", "10000", "-e", "1000", "-L",
                                     "0.6", "-Q", "0.6", "-H", "1.6"]),
    ("fun_t2.txt", "noboringbits", ["-H", "2.5", "-L", "0.5", "-Q", "0.5",
                                    "-m", "10000", "-e", "1000"]),
    ("fun_default.txt", "noboringbits", []),
    ("boring_odd.txt", "boringbits", ["-w", "999", "-i", "37", "-m",
                                      "20000", "-e", "3000"]),
]


@contextlib.contextmanager
def force_cpu():
    """CORNETTO_FORCE_CPU=1 inside the block: the port's plain versions."""
    old = os.environ.get("CORNETTO_FORCE_CPU")
    os.environ["CORNETTO_FORCE_CPU"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["CORNETTO_FORCE_CPU"]
        else:
            os.environ["CORNETTO_FORCE_CPU"] = old


def run_cli_quiet(argv, stdout_path: str, stderr_path: str) -> None:
    """One port CLI command in this process, stdout and stderr to files."""
    from cornetto_tpu_torch.cli import main as cli
    with open(stdout_path, "w") as fo, open(stderr_path, "w") as fe, \
            contextlib.redirect_stdout(fo), contextlib.redirect_stderr(fe):
        rc = cli(["cornetto"] + argv)
    if rc != 0:
        with open(stderr_path) as f:
            tail = f.read()[-2000:]
        fail("%s exited %d:\n%s" % (" ".join(argv[:2]), rc, tail))


def phase_goldens(work: str):
    """boringbits / noboringbits on the card against the C-oracle goldens."""
    from cornetto_tpu_torch.kernels.window_sum import window_sums
    synth = os.path.join(HERE, "test_data", "synth")
    gold = os.path.join(HERE, "test_data", "golden")
    for golden, cmd, extra in GOLDEN_RUNS:
        out = os.path.join(work, golden)
        window_sums.launches = 0
        run_cli_quiet([cmd, os.path.join(synth, "cov-total.bg"), "-q",
                       os.path.join(synth, "cov-mq20.bg")] + extra,
                      out, out + ".err")
        launches = window_sums.launches
        with open(out, "rb") as a, open(os.path.join(gold, golden),
                                        "rb") as b:
            same = a.read() == b.read()
        log("[8 goldens] %s %s: byte-equal to the golden: %s, window-sum "
            "launches %d" % (cmd, golden, same, launches))
        if not same or launches == 0:
            fail("%s %s: output differs from the golden or no kernel launch"
                 % (cmd, golden))


def seeded_tracks(seed: int, ci: int, n: int, unit: int = 1):
    """Piecewise-constant uint16 depth and MQ-depth tracks of one contig, in
    ceil(n / unit) steps: runs of seeded length at ~30x with low, high,
    zero and low-MQ stretches."""
    import numpy as np
    rng = np.random.default_rng([seed, 5, ci])
    m = -(-n // unit)
    k = max(2 * n // 100_000, 4)
    edges = np.concatenate([[0], np.sort(rng.integers(0, m, size=k - 1)),
                            [m]])
    kind = rng.choice(5, size=k, p=[0.8, 0.06, 0.05, 0.04, 0.05])
    base = rng.integers(26, 35, size=k)
    dep = np.select([kind == 1, kind == 2, kind == 3],
                    [base // 6, base * 3, 0], base)
    mq = np.where(kind == 4, dep // 10,
                  np.maximum(dep - rng.integers(0, 3, size=k), 0))
    runs = np.diff(edges)
    return (np.repeat(dep.astype(np.uint16), runs),
            np.repeat(mq.astype(np.uint16), runs))


def write_panel_inputs(path: str, seed: int, contigs) -> None:
    """draft.fasta (single-line records), 1 kb-ranged cov-total / cov-mq20
    tracks and a lowQ BED for contigs, under path (reused per seed)."""
    import numpy as np
    stamp = os.path.join(path, ".done")
    if os.path.exists(stamp):
        log("[9 panel] reusing %s" % path)
        return
    os.makedirs(path, exist_ok=True)
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(os.path.join(path, "draft.fasta"), "wb") as f:
        for (name, _), codes in zip(contigs, genome_codes(seed, contigs)):
            f.write(b">%s\n" % name.encode())
            f.write(ascii_[codes].tobytes())
            f.write(b"\n")
    with open(os.path.join(path, "draft.cov-total.bg"), "w") as ft, \
            open(os.path.join(path, "draft.cov-mq20.bg"), "w") as fm, \
            open(os.path.join(path, "draft.bp.p_ctg.lowQ.bed"), "w") as fq:
        for ci, (name, n) in enumerate(contigs):
            d, m = seeded_tracks(seed, ci, n, unit=1000)
            st = np.arange(len(d), dtype=np.int64) * 1000
            en = np.minimum(st + 1000, n)
            for f, v in ((ft, d), (fm, m)):
                f.write("".join("%s\t%d\t%d\t%d\n" % row for row in zip(
                    [name] * len(d), st.tolist(), en.tolist(), v.tolist())))
            fq.write("%s\t%d\t%d\n" % (name, n // 3, n // 3 + 9000))
    open(stamp, "w").close()


def panel_stages(err_path: str):
    """'panel-stage <name>: <s> s' markers of a create-panel run."""
    out = {}
    with open(err_path) as f:
        for line in f:
            if "panel-stage " in line:
                name, rest = line.split("panel-stage ", 1)[1].split(": ", 1)
                out[name] = float(rest.split(" s", 1)[0])
    return out


def create_panel(src: str, run_dir: str):
    """`create-panel --ranged-bedgraph` through the port's CLI in run_dir on
    links to src's inputs; returns (wall s, stage times, window-stats s)."""
    from cornetto_tpu_torch.tools import boringbits as tbb
    if os.path.isdir(run_dir):
        shutil.rmtree(run_dir)
    os.makedirs(run_dir)
    for name in ("draft.fasta", "draft.cov-total.bg", "draft.cov-mq20.bg",
                 "draft.bp.p_ctg.lowQ.bed"):
        os.symlink(os.path.join(src, name), os.path.join(run_dir, name))
    stats_s = [0.0]
    real = tbb.window_stats

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            stats_s[0] += time.perf_counter() - t0
    tbb.window_stats = timed
    try:
        with contextlib.chdir(run_dir):
            t0 = time.perf_counter()
            run_cli_quiet(["create-panel", "draft.fasta",
                           "--ranged-bedgraph"], "create.out", "create.err")
            wall = time.perf_counter() - t0
    finally:
        tbb.window_stats = real
    return wall, panel_stages(os.path.join(run_dir, "create.err")), \
        stats_s[0]


def tree_bytes(root: str):
    """Every file a create-panel run wrote under root, but its stderr log
    (timings) and the input links."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            p = os.path.join(base, name)
            if name != "create.err" and not os.path.islink(p):
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def phase_human_panel(seed: int, work: str, contigs):
    """Window stats at human scale on the card against the plain version,
    then create-panel on chr1-chr3 on the card against the CPU."""
    import numpy as np
    import torch
    from cornetto_tpu_torch.kernels.window_sum import (window_stats,
                                                       window_sums,
                                                       window_sums_ref)
    numbers = {}
    worst = 0
    n_win = 0
    stats_s = 0.0
    window_sums.launches = 0
    for ci, (name, n) in enumerate(contigs):
        d, m = seeded_tracks(seed, ci, n)
        t0 = time.perf_counter()
        st, end, dd, mm = window_stats(d, m, WIN, INC)
        stats_s += time.perf_counter() - t0
        n_win += len(st)
        x = torch.from_numpy(np.stack([d, m])).cuda()
        div = torch.from_numpy(np.maximum(end.astype(np.int64) - st, 1))
        ref = torch.div(window_sums_ref(x, WIN, INC, len(st)), div.cuda(),
                        rounding_mode="floor").cpu().numpy()
        err = int(max(np.abs(dd.astype(np.int64) - ref[0]).max(),
                      np.abs(mm.astype(np.int64) - ref[1]).max()))
        worst = max(worst, err)
        if err:
            fail("window stats of %s differ from the plain version" % name)
        del x, ref
    launches = window_sums.launches
    numbers["human_windows_per_s"] = n_win / stats_s
    log("[9 panel] window stats of %d contigs (%d bp, %d windows of %d/%d) "
        "on the card in %.3f s = %.0f windows/s (H2D of both uint16 tracks, "
        "kernel, division and readback); %d window-sum launches; equal to "
        "the plain version: max_abs_err %d"
        % (len(contigs), sum(n for _, n in contigs), n_win, WIN, INC,
           stats_s, n_win / stats_s, launches, worst))
    if launches != len(contigs):
        fail("%d window-sum launches for %d contigs"
             % (launches, len(contigs)))
    torch.cuda.empty_cache()

    cut = contigs[:3]                            # chr1-chr3, see PERF.md
    src = os.path.join(work, "panel_s%d" % seed)
    t0 = time.perf_counter()
    write_panel_inputs(src, seed, cut)
    log("[9 panel] create-panel inputs: %d contigs, %d bp, 1 kb-ranged "
        "tracks, ready in %.1f s" % (len(cut), sum(n for _, n in cut),
                                    time.perf_counter() - t0))
    window_sums.launches = 0
    wall, stages, ws_s = create_panel(src, os.path.join(work, "panel_card"))
    launches = window_sums.launches
    with force_cpu():
        cpu_wall, _, cpu_ws = create_panel(src, os.path.join(work,
                                                             "panel_cpu"))
    card_tree = tree_bytes(os.path.join(work, "panel_card"))
    same = card_tree == tree_bytes(os.path.join(work, "panel_cpu"))
    with open(os.path.join(work, "panel_card", "draft.boringbits.bed")) as f:
        panel_bp = sum(int(r.split("\t")[2]) - int(r.split("\t")[1])
                       for r in f)
    numbers["create_panel"] = dict(
        wall=wall, assembly_bed=stages.get("assembly-bed", 0.0),
        parse=stages.get("fun-windows", 0.0) - ws_s, stats=ws_s,
        chain=stages.get("interval-chain", 0.0),
        bigenough=stages.get("bigenough", 0.0))
    log("[9 panel] create-panel --ranged-bedgraph on chr1-chr3: card %.2f s "
        "(window-sum launches %d), CPU plain %.2f s (window stats %.2f s); "
        "%d files byte-identical: %s; panel %d bp"
        % (wall, launches, cpu_wall, cpu_ws, len(card_tree), same,
           panel_bp))
    if not same or launches != len(cut) or not panel_bp:
        fail("create-panel on the card differs from the CPU run, launched "
             "%d times for %d contigs, or wrote an empty panel"
             % (launches, len(cut)))
    return worst, numbers


ITER_CONTIGS = [("it%d" % i, 4_500_000) for i in range(7)] + \
    [("it7", 500_000)]
HOLE = 100_000


def write_iteration_inputs(path: str, seed: int):
    """A 32 Mbp draft (7 x 4.5 Mb + 500 kb) with one seeded 100 kb coverage
    hole per long contig and ~6x reads of 450 bases avoiding the holes.
    Returns (fasta, fastq, n_reads, holes)."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng([seed, 6])
    codes = [np.random.default_rng([seed, 7, i]).integers(
        0, 4, size=n, dtype=np.uint8) for i, (_, n) in enumerate(ITER_CONTIGS)]
    holes = {name: int(rng.integers(1_000_000, n - 1_000_000))
             for name, n in ITER_CONTIGS if n >= 1_000_000}
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    fasta = os.path.join(path, "draft.fasta")
    with open(fasta, "wb") as f:
        for (name, _), c in zip(ITER_CONTIGS, codes):
            f.write(b">%s\n%s\n" % (name.encode(), ascii_[c].tobytes()))
    open(os.path.join(path, "draft.bp.p_ctg.lowQ.bed"), "w").close()
    lens = np.array([n for _, n in ITER_CONTIGS], dtype=np.int64)
    n_reads = int(lens.sum() * 6 // READ_LEN)
    ctg = rng.choice(len(ITER_CONTIGS), size=n_reads, p=lens / lens.sum())
    start = np.zeros(n_reads, dtype=np.int64)
    bad = np.ones(n_reads, dtype=bool)
    while bad.any():                     # redraw reads that touch a hole
        start[bad] = (rng.random(int(bad.sum()))
                      * (lens[ctg[bad]] - READ_LEN + 1)).astype(np.int64)
        h = np.array([holes.get(name, -2 * HOLE)
                      for name, _ in ITER_CONTIGS])[ctg]
        bad = (start > h - READ_LEN) & (start < h + HOLE)
    fq = os.path.join(path, "reads.fq")
    offs = np.arange(READ_LEN)
    qual = b"I" * READ_LEN
    with open(fq, "wb") as f:
        for ci in range(len(ITER_CONTIGS)):
            idx = np.flatnonzero(ctg == ci)
            text = ascii_[codes[ci][start[idx, None] + offs]]
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, t.tobytes(), qual)
                             for i, t in zip(idx.tolist(), text)))
    return fasta, fq, n_reads, holes


def phase_iteration(seed: int, work: str):
    """One aligner-free iteration through `cornetto_tpu_torch.cli flow`."""
    import torch
    from cornetto_tpu_torch.kernels.extract import extract_minima
    from cornetto_tpu_torch.kernels.window_sum import window_sums
    path = os.path.join(work, "iter_s%d" % seed)
    t0 = time.perf_counter()
    fasta, fq, n_reads, holes = write_iteration_inputs(path, seed)
    log("[10 iteration] draft %d contigs, %d bp, %d reads of %d written in "
        "%.1f s" % (len(ITER_CONTIGS), sum(n for _, n in ITER_CONTIGS),
                    n_reads, READ_LEN, time.perf_counter() - t0))
    wd = os.path.join(path, "wd")
    if os.path.isdir(wd):
        shutil.rmtree(wd)
    cfg = os.path.join(path, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"aligner_free": True}, f)
    extract_minima.launches = 0
    window_sums.launches = 0
    t0 = time.perf_counter()
    run_cli_quiet(["flow", wd, fasta, fq, "--config", cfg],
                  os.path.join(path, "flow.out"), os.path.join(path,
                                                               "flow.err"))
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    ext, ws = extract_minima.launches, window_sums.launches
    n_batches = -(-n_reads // BATCH)
    with open(os.path.join(wd, ".flow.iteration.json")) as f:
        secs = {k: v["secs"] for k, v in json.load(f)["done"].items()}
    rows = []
    with open(os.path.join(wd, "draft.boringbits.bed")) as f:
        for line in f:
            c, s, e = line.split("\t")[:3]
            rows.append((c, int(s), int(e)))
    lens = dict(ITER_CONTIGS)
    short_rows = [r for r in rows if lens[r[0]] < 800_000]
    in_holes = [r for r in rows if r[0] in holes and
                r[2] > holes[r[0]] - 40_000 and
                r[1] < holes[r[0]] + HOLE + 40_000]
    npz = os.path.exists(os.path.join(wd, "draft.livefish.npz"))
    log("[10 iteration] flow in %.2f s (steps %s); extraction launches %d "
        "for %d cov batches; window-sum launches %d; panel %d rows, %d bp, "
        "%d on contigs < 800 kb, %d within 40 kb of a hole; "
        "draft.livefish.npz written: %s"
        % (flow_s, secs, ext, n_batches, ws, len(rows),
           sum(e - s for _, s, e in rows), len(short_rows), len(in_holes),
           npz))
    if ext != n_batches or ws == 0 or not rows or short_rows or in_holes \
            or not npz:
        fail("the iteration's launches or panel are wrong")

    # livefish cov on the first two batches: card against CPU
    head = os.path.join(path, "head.fq")
    with open(fq, "rb") as src, open(head, "wb") as dst:
        for _ in range(2 * BATCH * 4):
            dst.write(src.readline())
    idx = os.path.join(wd, "draft.livefish")
    outs = {}
    for dev in ("card", "cpu"):
        pre = os.path.join(path, "head_" + dev)
        with force_cpu() if dev == "cpu" else contextlib.nullcontext():
            run_cli_quiet(["livefish", "cov", idx, head, "-o", pre],
                          pre + ".out", pre + ".err")
        outs[dev] = []
        for suffix in (".cov-total.bg", ".cov-mq20.bg"):
            with open(pre + suffix, "rb") as f:
                outs[dev].append(f.read())
    same = outs["card"] == outs["cpu"]
    log("[10 iteration] livefish cov of %d reads: card and CPU bedgraphs "
        "byte-identical: %s" % (2 * BATCH, same))
    if not same:
        fail("livefish cov bedgraphs differ between the card and the CPU")

    # livefish cov over all the reads, index already built
    pre = os.path.join(path, "all")
    t0 = time.perf_counter()
    run_cli_quiet(["livefish", "cov", idx, fq, "-o", pre], pre + ".out",
                  pre + ".err")
    torch.cuda.synchronize()
    cov_s = time.perf_counter() - t0
    return ws, {"flow_s": flow_s, "flow_steps": secs,
                "cov_reads_per_s": n_reads / cov_s, "cov_s": cov_s,
                "n_reads": n_reads}


# ---------------------------------------------------------------- annotation

TTAGGG, CCCTAA = (3, 3, 0, 2, 2, 2), (1, 1, 1, 3, 0, 0)
SLICE = 20_000_000                       # chr1's head, checked on the host
# (start, unit, length) written into chr1's first 20 Mb: one satellite of
# each period 1-6, the contig-start and an interstitial telomere, a
# telomere inside a satellite (a telobreaks hit) and three N gaps
SLICE_FEATURES = [(0, "CCCTAA", 9_000), (2_000_000, "A", 3_000),
                  (3_000_000, "AT", 5_000), (4_000_000, "ATT", 8_000),
                  (5_000_000, "AATG", 12_000), (6_000_000, "ATTCC", 20_000),
                  (7_000_000, "GGAATC", 30_000), (9_000_000, "TTAGGG", 3_000),
                  (10_000_000, "ATTCC", 10_000),
                  (10_004_000, "TTAGGG", 2_000), (13_000_000, "N", 100),
                  (15_000_000, "N", 5_000), (17_000_000, "N", 50_000)]
SAT_UNITS = ["A", "AT", "ATT", "AATG", "ATTCC", "GGAATC"]


def _tile(unit: str, n: int):
    import numpy as np
    return np.frombuffer((unit * (n // len(unit) + 1))[:n].encode(),
                         dtype=np.uint8)


def write_annotation_draft(path: str, seed: int, contigs):
    """draft.fasta: contigs (chr1-chr3) of seeded random sequence with
    ~1% of bases in short-period satellite arrays (periods 1-6, 1-50 kb),
    (CCCTAA)n / (TTAGGG)n arrays of 5-15 kb at the contig ends and three
    interstitial ones of 1-3 kb, and twenty N gaps of 100-50,000 bp per
    contig; chr1's first 20 Mb holds SLICE_FEATURES and no seeded feature,
    and is also written alone to slice.fasta.  Reused per seed.  Returns
    (draft, slice) paths and the feature counts."""
    import numpy as np
    draft = os.path.join(path, "draft.fasta")
    slice_fa = os.path.join(path, "slice.fasta")
    stamp = os.path.join(path, ".done")
    counts_path = os.path.join(path, "counts.json")
    if os.path.exists(stamp):
        with open(counts_path) as f:
            return draft, slice_fa, json.load(f)
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng([seed, 8])
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    counts = dict(sat_arrays=0, sat_bp=0, telo_arrays=0, telo_bp=0, gaps=0,
                  gap_bp=0)

    def put(text, s, unit, n):
        n = min(n, len(text) - s)
        text[s:s + n] = _tile(unit, n)
        kind = ("gap" if unit == "N" else "telo" if unit in
                ("TTAGGG", "CCCTAA") else "sat")
        counts[kind + ("s" if kind == "gap" else "_arrays")] += 1
        counts[kind + "_bp"] += n

    with open(draft, "wb") as f:
        for i, (name, n) in enumerate(contigs):
            text = ascii_[np.random.default_rng([seed, 2, i]).integers(
                0, 4, size=n, dtype=np.uint8)]
            lo = SLICE + 1_000_000 if i == 0 else 1_000_000
            feats = [(int(rng.integers(lo, n - 1_000_000)), unit, int(ln))
                     for unit, ln in zip(
                         rng.choice(["TTAGGG", "CCCTAA"], 3),
                         rng.integers(1_000, 3_001, 3))]
            feats += [(0, "CCCTAA", int(rng.integers(5_000, 15_001)))]
            end = int(rng.integers(5_000, 15_001))
            feats += [(n - end, "TTAGGG", end)]
            feats += [(int(rng.integers(lo, n - 1_000_000)), "N",
                       int(np.exp(rng.uniform(np.log(100), np.log(50_000)))))
                      for _ in range(20)]
            if i == 0:
                feats = [f for f in feats if f[0] >= SLICE] + SLICE_FEATURES
            sat = []
            bp = 0
            while bp < n // 100:
                p = int(rng.integers(1, 7))
                unit = SAT_UNITS[p - 1] if rng.random() < 0.5 else \
                    "".join("ACGT"[j] for j in rng.integers(0, 4, p))
                ln = int(np.exp(rng.uniform(np.log(1_000), np.log(50_000))))
                sat.append((int(rng.integers(lo, n - 1_000_000)), unit, ln))
                bp += ln
            # satellites first, then telomeres, then gaps on top
            for s, unit, ln in sat + sorted(
                    feats, key=lambda x: (x[1] == "N", x[0])):
                put(text, s, unit, ln)
            f.write(b">%s\n" % name.encode())
            f.write(text.tobytes())
            f.write(b"\n")
            if i == 0:
                with open(slice_fa, "wb") as fs:
                    fs.write(b">%s_head\n%s\n" % (name.encode(),
                                                   text[:SLICE].tobytes()))
            del text
    with open(counts_path, "w") as f:
        json.dump(counts, f)
    open(stamp, "w").close()
    return draft, slice_fa, counts


def _sdust_rows(seed: int, n: int, clen: int):
    """Seeded chunks of every kind: random, short-period repeats,
    homopolymers, interior Ns, separated homopolymer bursts (overflow
    rows), leading N runs, 70% poly-A."""
    import numpy as np
    rng = np.random.default_rng([seed, 9, clen])
    rows = rng.integers(0, 4, size=(n, clen)).astype(np.uint8)
    for r in range(n):
        kind = r % 7
        if kind == 1:
            rows[r] = np.tile(rng.integers(0, 4, rng.integers(1, 7)),
                              clen)[:clen]
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


def _telo_reads(seed: int, B: int, L: int):
    """(B, L) codes 0-4 (1% N) in which a tenth of the reads carry a
    TTAGGG or CCCTAA array of 1..L/6 copies at the start, the middle or the
    end."""
    import numpy as np
    rng = np.random.default_rng([seed, 10, B, L])
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4
    for r in np.flatnonzero(rng.random(B) < 0.1) if L >= 6 else []:
        motif = TTAGGG if rng.random() < 0.5 else CCCTAA
        c = int(rng.integers(1, L // 6 + 1))
        s = [0, (L - 6 * c) // 2, L - 6 * c][int(rng.integers(0, 3))]
        codes[r, s:s + 6 * c] = np.tile(np.array(motif, np.uint8), c)
    return codes


def timed_ms(fn):
    """(fn(), its time in ms by CUDA events, synchronised)."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _slice_rows(seed: int, slice_fa: str, W: int, core: int):
    """Rows at the main path's shape, as sdust_device lays them out (one
    padded sequence, row offsets into it): the slice's chunks that hold a
    planted feature or an N, random chunks of the slice up to 320, and 64
    seeded rows of every kind after it (the homopolymer bursts overflow).
    Returns (codes, row offsets, clen, number of feature chunks)."""
    import numpy as np
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.kernels.sdust import plan_rows
    from cornetto_tpu_torch.kernels.sdust_core import _NT4
    seq = next(read_fastx(slice_fa)).seq.encode("latin-1")
    chunks, _host, padded, a, clen = plan_rows(
        _NT4[np.frombuffer(seq, dtype=np.uint8)], W, core)
    feats = [(s, s + ln) for s, _u, ln in SLICE_FEATURES]
    near = {r for r, (_a, _b, c0, stop) in enumerate(chunks)
            if any(c0 < hi and stop > lo for lo, hi in feats)}
    rng = np.random.default_rng([seed, 12])
    rest = np.setdiff1d(np.arange(len(chunks)), sorted(near))
    pick = sorted(near) + sorted(rng.choice(rest, max(320 - len(near), 0),
                                            replace=False).tolist())
    synth = _sdust_rows(seed, 64, clen)
    codes = np.concatenate([padded, synth.reshape(-1)])
    off = np.concatenate([a[pick], len(padded) + np.arange(64) * clen])
    return codes, off, clen, len(near)


def _check_sdust(label, codes, off, clen, T=20, W=64, budget=None,
                 need_overflow=True, need_heavy=True):
    """sdust_dp (the two passes at ``budget``, default the wrapper's, and
    PR 3's single pass: budget 0) against sdust_dp_ref on the card; fails
    on any difference, when the heavy rows are not the rows whose
    find_perfect row-steps (the plain version's count) pass the budget, or
    when no row went to the heavy pass (need_heavy) or overflowed
    (need_overflow).  Returns (max_abs_err, plain_ms, each row's
    find_perfect row-steps, heavy rows, intervals)."""
    import torch
    from cornetto_tpu_torch.kernels.sdust import (default_budget,
                                                  max_intervals, sdust_dp,
                                                  sdust_dp_ref)
    stats = {}
    got = sdust_dp(codes, off, clen, T, W, budget=budget, stats=stats)
    old = sdust_dp(codes, off, clen, T, W, budget=0)
    (*ref, steps), plain_ms = timed_ms(
        lambda: sdust_dp_ref(codes, off, clen, T, W, return_steps=True))
    err = max(int((g.long() - r.long()).abs().max())
              for out in (got, old) for g, r in zip(out, ref))
    maxi = max_intervals(clen)
    n_over = int((got[2] >= maxi).sum())
    n_iv = int(got[2].clamp(max=maxi).sum())
    log("[11 annotation kernels] sdust %s, T=%d W=%d budget %s (%d rows x "
        "%d codes, MAXI %d): max_abs_err=%d (starts, finishes, counts; two "
        "passes and PR 3's single pass), %d overflow rows, %d intervals, %d "
        "heavy rows; find_perfect row-steps %d in all, %d in the costliest "
        "row; plain %.1f ms"
        % (label, T, W, "default" if budget is None else budget, len(off),
           clen, maxi, err, n_over, n_iv, stats["heavy_rows"],
           int(steps.sum()), int(steps.max()), plain_ms))
    if err or not all(torch.equal(g, r) for out in (got, old)
                      for g, r in zip(out, ref)):
        fail("sdust kernel disagrees with its plain version (%s)" % label)
    b = default_budget(len(off), codes.device) if budget is None else budget
    if stats["heavy_rows"] != int((steps > b).sum()):
        fail("sdust: %d heavy rows, %d rows past the budget (%s)"
             % (stats["heavy_rows"], int((steps > b).sum()), label))
    if (need_overflow and not n_over) or (need_heavy and
                                          not stats["heavy_rows"]):
        fail("no overflow row or no heavy row in the sdust check (%s)"
             % label)
    return err, plain_ms, steps.cpu(), stats["heavy_rows"], n_iv


def _sdust_turns(label, codes, off, clen):
    """PR 3's single pass (budget 0) and the two passes timed in turns
    (old, new, new, old) on one input: (old ms, new ms, heavy rows)."""
    from cornetto_tpu_torch.kernels.sdust import sdust_dp
    old = lambda: sdust_dp(codes, off, clen, budget=0)  # noqa: E731
    new = lambda: sdust_dp(codes, off, clen)            # noqa: E731
    t = [cuda_ms(fn, 5, warmup=2) for fn in (old, new, new, old)]
    stats = {}
    sdust_dp(codes, off, clen, stats=stats)
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    log("[11 annotation kernels] sdust turns on %s (%d rows): PR 3 single "
        "pass %.4f / %.4f ms, two passes %.4f / %.4f ms (light %.4f + heavy "
        "%.4f ms, %d heavy rows): %.1fx"
        % (label, len(off), t[0], t[3], t[1], t[2], stats["light_ms"],
           stats["heavy_ms"], stats["heavy_rows"], o / n))
    return o, n, stats["heavy_rows"]


def _sdust_budget_sweep(seed: int, draft: str, main_case, budgets):
    """The two passes' time against the light pass's budget (the default
    for the row count first) on the main-path case and on seeded subsets of
    chr1's chunks of the cut (1,024 to all 121,412 rows), each result held
    equal to PR 3's single pass (budget 0, timed too).  Returns
    {"rows/budget": {ms, light_ms, heavy_ms, heavy_rows}}."""
    import numpy as np
    import torch
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.kernels.sdust import (default_budget, plan_rows,
                                                  sdust_dp)
    from cornetto_tpu_torch.kernels.sdust_core import _NT4
    dev = torch.device("cuda")
    seq = next(read_fastx(draft)).seq.encode("latin-1")
    _c, _h, padded, a, clen = plan_rows(_NT4[np.frombuffer(seq, np.uint8)])
    del seq
    c1 = torch.from_numpy(padded).to(dev)
    rng = np.random.default_rng([seed, 13])
    cases = [("main-path case", *main_case)]
    for n in (1024, 2048, 4096, 16384, len(a)):
        pick = np.sort(rng.choice(len(a), n, replace=False)) \
            if n < len(a) else np.arange(len(a))
        cases.append(("chr1 %d chunks" % n, c1,
                      torch.from_numpy(a[pick]).to(dev), clen))
    sweep = {}
    for name, codes, off, cl in cases:
        want = sdust_dp(codes, off, cl, budget=0)
        line = []
        for b in (default_budget(len(off), dev), *budgets):
            run = lambda: sdust_dp(codes, off, cl, budget=b)  # noqa: E731
            if not all(torch.equal(x, y) for x, y in zip(run(), want)):
                fail("sdust at budget %d differs from budget 0 on %s"
                     % (b, name))
            ms = cuda_ms(run, 3, warmup=1)
            st = {}
            sdust_dp(codes, off, cl, budget=b, stats=st)
            sweep["%d/%d" % (len(off), b)] = dict(ms=ms, **st)
            line.append("%d: %.3f (%d)" % (b, ms, st["heavy_rows"]))
        log("[11 annotation kernels] sdust budget sweep on %s (%d rows, "
            "default budget %d): budget: two-pass ms (heavy rows) %s"
            % (name, len(off), default_budget(len(off), dev),
               ", ".join(line)))
    del c1
    return sweep


def phase_annotation_kernels(seed: int, slice_fa: str, draft: str):
    """The SDUST, mask and run-stats kernels against their plain versions
    on the card; returns {name: {err, ms, plain_ms, bytes, ops, ...}}.
    SDUST (both designs) is held at core 512 on seeded rows and at the main
    path's shape (W=64, core 2048) on rows of the annotation slice's chunk
    plan, where PR 3's single pass and the two passes are timed in turns on
    the slice chunks, the seeded rows, the costliest row and all of them;
    its ms and plain_ms are the main-path case's."""
    import torch
    from cornetto_tpu_torch.kernels.sdust import max_intervals
    from cornetto_tpu_torch.kernels.telo import (_steps_for, telo_match_mask,
                                                 telo_match_mask_ref,
                                                 telo_run_stats,
                                                 telo_run_stats_ref)
    dev = torch.device("cuda")
    out = {}
    W, n = 64, 448
    clen = 4 * W + 512 + W + 8
    rows = torch.from_numpy(_sdust_rows(seed, n, clen)).to(dev)
    err, *_ = _check_sdust("seeded, W=64 core=512", rows.reshape(-1),
                           torch.arange(n, device=dev) * clen, clen)
    del rows
    # the window's ends and the lowest threshold the CLI takes, on rows of
    # every kind at core 512, with a budget low enough that the satellite
    # rows cross it (NW = 64 fills the row-mask words; at W = 3 the window
    # is one word and find_perfect takes no row-step, so no row is heavy)
    for W_, T_ in ((66, 5), (66, 14), (3, 5), (4, 5), (8, 5), (8, 14)):
        cl = 4 * W_ + 512 + W_ + 8
        rows = torch.from_numpy(_sdust_rows(seed + W_, 112, cl)).to(dev)
        e, *_ = _check_sdust("seeded, core=512", rows.reshape(-1),
                             torch.arange(112, device=dev) * cl, cl, T_, W_,
                             budget=16, need_overflow=False,
                             need_heavy=W_ > 3)
        err = max(err, e)
    del rows
    codes, off, clen, n_feat = _slice_rows(seed, slice_fa, W, 2048)
    codes, off = torch.from_numpy(codes).to(dev), torch.from_numpy(off).to(dev)
    err2, plain_ms, steps, heavy, n_iv = _check_sdust(
        "main-path shape, W=64 core=2048: %d slice chunks (%d with a "
        "feature or an N) + 64 seeded" % (len(off) - 64, n_feat),
        codes, off, clen)
    # the tail: PR 3's design against the two passes on the slice chunks
    # alone, the seeded rows alone, the costliest row alone, and all rows
    worst = int(steps.argmax())
    turns = {}
    for name, part in (("slice chunks", off[:-64]), ("seeded rows", off[-64:]),
                       ("costliest row (%d)" % worst, off[worst:worst + 1]),
                       ("main-path case", off)):
        turns[name] = _sdust_turns(name, codes, part.contiguous(), clen)
    old_ms, ms, _ = turns["main-path case"]
    sweep = _sdust_budget_sweep(seed, draft, (codes, off, clen),
                                (0, 16, 64, 256, 1024, 4096, 16384))
    n = len(off)
    span = torch.sort(off).values.cpu()
    row_bytes = int(torch.minimum(span[1:] - span[:-1],
                                  torch.tensor(clen)).sum()) + clen
    out_row = 8 * max_intervals(clen) + 4        # starts, finishes, count
    work = dict(bytes=row_bytes + 8 * n + n * out_row,
                ops=SDUST_OPS_BASE * n * clen
                + SDUST_OPS_ROW_STEP * int(steps.sum()))
    out["sdust"] = dict(err=max(err, err2), ms=ms, plain_ms=plain_ms,
                        old_ms=old_ms, heavy_rows=heavy, turns=turns,
                        sweep=sweep,
                        row_steps=int(steps.sum()), intervals=n_iv, **work)
    del codes, off
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(seed)
    chr1 = torch.randint(0, 5, (1, GRCH38[0]), generator=gen, device=dev,
                         dtype=torch.uint8)
    chr1[0, :9000] = torch.tensor(CCCTAA * 1500, dtype=torch.uint8)
    chr1[0, -9000:] = torch.tensor(TTAGGG * 1500, dtype=torch.uint8)
    reads = torch.from_numpy(_telo_reads(seed, 4096, 450)).to(dev)
    worst = 0
    for name, x in (("chr1 (1, %d)" % GRCH38[0], chr1),
                    ("reads (4096, 450)", reads)):
        for motif in (TTAGGG, CCCTAA):
            got = telo_match_mask(x, motif)
            ref = telo_match_mask_ref(x, motif)
            e = int((got.int() - ref.int()).abs().max())
            worst = max(worst, e)
            log("[11 annotation kernels] telo_match_mask %s motif %s: "
                "max_abs_err=%d, %d matches"
                % (name, motif, e, int(got.sum(dtype=torch.int64))))
            if e or not torch.equal(got, ref):
                fail("mask kernel disagrees with its plain version")
            del got, ref
    ms = cuda_ms(lambda: telo_match_mask(chr1, TTAGGG), 20, warmup=3)
    plain_ms = cuda_ms(lambda: telo_match_mask_ref(chr1, TTAGGG), 3,
                       warmup=1)
    log("[11 annotation kernels] telo_match_mask chr1 (1, %d): kernel %.4f "
        "ms plain %.4f ms" % (GRCH38[0], ms, plain_ms))
    n, cmp = GRCH38[0], early_exit_compares(chr1, TTAGGG)
    log("[11 annotation kernels] telo_match_mask chr1: %d byte compares "
        "with early exit (%.3f a base)" % (cmp, cmp / n))
    out["telo_match_mask"] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                  bytes=2 * n, ops=cmp)
    del chr1
    torch.cuda.empty_cache()

    worst, timing = 0, None
    for B, L in ((4096, 450), (4096, 1800), (4096, 18), (4096, 19),
                 (4096, 42), (64, 5)):
        x = torch.from_numpy(_telo_reads(seed, B, L)).to(dev)
        for motif in (TTAGGG, CCCTAA):
            got = telo_run_stats(x, motif)
            ref = telo_run_stats_ref(x, motif)
            e = max(int((g.int() - r.int()).abs().max())
                    for g, r in zip(got, ref))
            worst = max(worst, e)
            log("[11 annotation kernels] telo_run_stats (%d, %d) motif %s: "
                "max_abs_err=%d, reads with a match %d, longest %d copies, "
                "terminal %d" % (B, L, motif, e, int((got[0] > 0).sum()),
                                 int(got[1].max()), int(got[2].sum())))
            if e or not all(torch.equal(g, r) for g, r in zip(got, ref)):
                fail("run-stats kernel disagrees with its plain version")
        if (B, L) == (4096, 450):
            timing = (cuda_ms(lambda: telo_run_stats(x, TTAGGG), 50),
                      cuda_ms(lambda: telo_run_stats_ref(x, TTAGGG), 10))
            log("[11 annotation kernels] telo_run_stats (4096, 450): kernel "
                "%.4f ms plain %.4f ms" % timing)
    B, L, m = 4096, 450, len(TTAGGG)
    out["telo_run_stats"] = dict(
        err=worst, ms=timing[0], plain_ms=timing[1], bytes=B * L + 9 * B,
        ops=B * L * (2 * m + 3 * _steps_for(L, m)))
    # the doubling cap: 3 copies in 18 bases report 2, as the JAX function
    cap = torch.tensor([TTAGGG * 3], dtype=torch.uint8, device=dev)
    n_, longest, _ = telo_run_stats(cap, TTAGGG)
    log("[11 annotation kernels] (TTAGGG)x3 in 18 bases: %d matches, "
        "longest %d (capped at 2^steps)" % (int(n_[0]), int(longest[0])))
    if int(longest[0]) != 2:
        fail("the run-stats kernel does not keep the doubling cap")
    return out


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_annotation_goldens(work: str):
    """sdust / telofind (device backends: the default, and named),
    telowin and telobreaks through the port's CLI on the card against the
    C-oracle goldens."""
    from cornetto_tpu_torch.kernels.sdust import sdust_dp
    from cornetto_tpu_torch.kernels.telo import telo_match_mask
    asm = os.path.join(HERE, "test_data", "synth", "asm.fasta")
    gold = os.path.join(HERE, "test_data", "golden")
    g = lambda name: os.path.join(gold, name)  # noqa: E731
    runs = [("sdust.txt", ["sdust", asm]),
            ("sdust_w32t14.txt", ["sdust", "-w", "32", "-t", "14",
                                  "--backend", "device", asm]),
            ("telofind.txt", ["telofind", asm]),
            ("telofind_ccctaa.txt", ["telofind", asm, "CCCTAA", "--backend",
                                     "device"]),
            ("telowin.txt", ["telowin", g("telomere.txt"), "99.9", "0.4"]),
            ("telowin2.txt", ["telowin", g("telomere.txt"), "95", "0.3"]),
            ("telobreaks.txt", ["telobreaks", g("lens.txt"), g("sdust.txt"),
                                g("telomere.txt")])]
    for golden, argv in runs:
        out = os.path.join(work, "annot_" + golden)
        sdust_dp.launches = telo_match_mask.launches = 0
        run_cli_quiet(argv, out, out + ".err")
        launches = sdust_dp.launches + telo_match_mask.launches
        same = _same_file(out, g(golden))
        log("[12 annotation goldens] %s -> %s: byte-equal to the golden: %s, "
            "kernel launches %d" % (" ".join(a for a in argv if HERE not in a),
                                    golden, same, launches))
        device = argv[0] in ("sdust", "telofind")
        if not same or (device and launches == 0):
            fail("%s: output differs from the golden or no kernel launch"
                 % golden)


def phase_annotation(seed: int, draft: str, slice_fa: str, contigs):
    """The annotation chain on the chr1-chr3 cut through the port's CLI:
    sdust and telofind on the card, telowin and telobreaks on their
    outputs, read tagging with the run-stats kernel; then sdust's per-part
    split from a second run; telofind against the host backend on the
    whole cut, sdust on the 20 Mb slice."""
    import numpy as np
    import torch
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.kernels.minimizer import encode_seq
    from cornetto_tpu_torch.kernels.sdust import sdust_dp
    from cornetto_tpu_torch.kernels.telo import (telo_match_mask,
                                                 telo_run_stats,
                                                 telo_run_stats_ref)
    from cornetto_tpu_torch.tools import sdust as tsd
    total = sum(n for _, n in contigs)
    secs = {}
    p = lambda name: os.path.join(os.path.dirname(draft), name)  # noqa: E731

    # the main path (sdust and telofind on their default, device backends):
    # counts to 0, drive, read
    sdust_dp.launches = telo_match_mask.launches = 0
    telo_run_stats.launches = 0
    t0 = time.perf_counter()
    run_cli_quiet(["sdust", draft], p("sdust.txt"), p("sdust.err"))
    torch.cuda.synchronize()
    secs["sdust"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli_quiet(["telofind", draft], p("telofind.txt"), p("telofind.err"))
    torch.cuda.synchronize()
    secs["telofind"] = time.perf_counter() - t0
    with open(p("lens.txt"), "w") as f:
        f.write("".join("%s\t%d\n" % c for c in contigs))
    shutil.copy(p("telofind.txt"), p("telomere.txt"))   # awk: same fields
    t0 = time.perf_counter()
    run_cli_quiet(["telowin", p("telomere.txt"), "99.9", "0.4"],
                  p("telowin.txt"), p("telowin.err"))
    secs["telowin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli_quiet(["telobreaks", p("lens.txt"), p("sdust.txt"),
                   p("telomere.txt")], p("telobreaks.txt"),
                  p("telobreaks.err"))
    secs["telobreaks"] = time.perf_counter() - t0
    # read tagging: batches of reads drawn from the slice, 3% from its
    # telomere arrays, through the run-stats kernel with both motifs
    rec = next(read_fastx(slice_fa))
    head = encode_seq(rec.seq)
    rng = np.random.default_rng([seed, 11])
    tel = [(s, ln) for s, u, ln in SLICE_FEATURES if u in ("TTAGGG",
                                                           "CCCTAA")]
    tagged = {"reads": 0, "with_match": 0, "longest_ge_4": 0, "terminal": 0}
    t0 = time.perf_counter()
    tag_batches = []
    for L in (450, 450, 450, 450, 1800, 1800):
        starts = rng.integers(0, SLICE - L, size=BATCH)
        pick = np.flatnonzero(rng.random(BATCH) < 0.03)
        s, ln = np.array(tel)[rng.integers(0, len(tel), len(pick))].T
        starts[pick] = s + (rng.random(len(pick)) * np.maximum(
            ln - L // 2, 1)).astype(np.int64)
        x = torch.from_numpy(head[starts[:, None] + np.arange(L)]).cuda()
        tag_batches.append(x)
        for motif in (TTAGGG, CCCTAA):
            n_, longest, term = telo_run_stats(x, motif)
            tagged["reads"] += BATCH
            tagged["with_match"] += int((n_ > 0).sum())
            tagged["longest_ge_4"] += int((longest >= 4).sum())
            tagged["terminal"] += int(term.sum())
    torch.cuda.synchronize()
    secs["tagging"] = time.perf_counter() - t0
    launches = {"sdust": sdust_dp.launches,
                "telo_match_mask": telo_match_mask.launches,
                "telo_run_stats": telo_run_stats.launches}
    # tagging against the plain version (not counted)
    for x in tag_batches:
        for motif in (TTAGGG, CCCTAA):
            if not all(torch.equal(a, b) for a, b in zip(
                    telo_run_stats(x, motif), telo_run_stats_ref(x, motif))):
                fail("read tagging differs from the plain version")

    # sdust's per-part split: a second run of the same entry point that
    # synchronises the card at the end of each part
    stats = {}
    t0 = time.perf_counter()
    with open(p("sdust_split.txt"), "w") as f:
        tsd.run(draft, backend="device", out=f, stats=stats)
    torch.cuda.synchronize()
    secs["sdust_split"] = time.perf_counter() - t0
    split_same = _same_file(p("sdust.txt"), p("sdust_split.txt"))

    # checks: telofind on the host over the whole cut, sdust on the slice
    t0 = time.perf_counter()
    run_cli_quiet(["telofind", draft, "--backend", "host"],
                  p("telofind_host.txt"), p("telofind_host.err"))
    secs["telofind_host"] = time.perf_counter() - t0
    tf_same = _same_file(p("telofind.txt"), p("telofind_host.txt"))
    t0 = time.perf_counter()
    run_cli_quiet(["sdust", "--backend", "device", slice_fa],
                  p("slice_device.txt"), p("slice_device.err"))
    torch.cuda.synchronize()
    secs["sdust_slice_device"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli_quiet(["sdust", "--backend", "host", slice_fa],
                  p("slice_host.txt"), p("slice_host.err"))
    secs["sdust_slice_host"] = time.perf_counter() - t0
    sd_same = _same_file(p("slice_device.txt"), p("slice_host.txt"))
    # the cut's chr1 rows well inside the slice equal the slice's rows
    with open(p("sdust.txt")) as f:
        cut_head = [r.split("\t", 1)[1] for r in f
                    if r.startswith(contigs[0][0] + "\t")
                    and int(r.split("\t")[2]) < SLICE - 1000]
    with open(p("slice_host.txt")) as f:
        slice_head = [r.split("\t", 1)[1] for r in f
                      if int(r.split("\t")[2]) < SLICE - 1000]
    head_same = cut_head == slice_head

    rows = {}
    for name in ("sdust.txt", "telofind.txt", "telowin.txt",
                 "telobreaks.txt", "slice_host.txt"):
        with open(p(name)) as f:
            rows[name] = f.read().splitlines()
    masked = sum(int(r.split("\t")[2]) - int(r.split("\t")[1])
                 for r in rows["sdust.txt"])
    win_ctgs = {r.split("\t")[1] for r in rows["telowin.txt"]
                if r.startswith("Window")}
    parts = {k: stats.get(k, 0.0) for k in (
        "plan", "h2d", "kernel", "readback", "overflow", "host_spans",
        "assemble")}
    log("[13 annotation] sdust (device, the default) on the cut (CLI): %.2f s "
        "wall = %.2f Mb/s; %d rows, %d bp masked"
        % (secs["sdust"], total / secs["sdust"] / 1e6, len(rows["sdust.txt"]),
           masked))
    log("[13 annotation] sdust split (second run, synchronised per part): "
        "%.2f s wall; %d chunks, %d overflow rows, %d host-span bases; parts: "
        "%s, FASTA read + rest %.2f s; output equal to the CLI run's: %s"
        % (secs["sdust_split"], stats.get("chunks", 0),
           stats.get("overflow_rows", 0), stats.get("host_span_bases", 0),
           ", ".join("%s %.3f s" % kv for kv in parts.items()),
           secs["sdust_split"] - sum(parts.values()), split_same))
    log("[13 annotation] sdust kernel on the cut (split run, CUDA events): "
        "light pass %.3f ms + heavy pass %.3f ms = %.3f ms over %d launches; "
        "%d heavy rows of %d chunks"
        % (stats.get("light_ms", 0.0), stats.get("heavy_ms", 0.0),
           stats.get("light_ms", 0.0) + stats.get("heavy_ms", 0.0),
           2 * len(contigs), stats.get("heavy_rows", 0),
           stats.get("chunks", 0)))
    log("[13 annotation] telofind (device, the default) on the cut: %.2f s "
        "(%.2f Mb/s), host backend %.2f s; %d rows; byte-equal: %s"
        % (secs["telofind"], total / secs["telofind"] / 1e6,
           secs["telofind_host"], len(rows["telofind.txt"]), tf_same))
    log("[13 annotation] sdust on the %d bp slice: device %.2f s, host "
        "(native DP) %.2f s; %d rows; byte-equal: %s; the cut's chr1 rows "
        "ending before %d equal the slice's: %s (%d rows)"
        % (SLICE, secs["sdust_slice_device"], secs["sdust_slice_host"],
           len(rows["slice_host.txt"]), sd_same, SLICE - 1000, head_same,
           len(cut_head)))
    log("[13 annotation] telowin %.2f s: %d rows, windows on %s; telobreaks "
        "%.2f s: %d rows; read tagging %.2f s: %s"
        % (secs["telowin"], len(rows["telowin.txt"]), sorted(win_ctgs),
           secs["telobreaks"], len(rows["telobreaks.txt"]), secs["tagging"],
           tagged))
    log("[13 annotation] main-path launches: %s" % launches)
    if not (tf_same and sd_same and head_same and cut_head and split_same):
        fail("annotation outputs differ from the host backends")
    if win_ctgs != {c for c, _ in contigs} or not rows["telobreaks.txt"] \
            or not tagged["terminal"] or not masked:
        fail("the annotation chain missed a planted feature")
    if min(launches.values()) == 0 or launches["sdust"] != 2 * len(contigs) \
            or launches["telo_match_mask"] != 2 * len(contigs):
        fail("an annotation kernel was not launched as expected: %s"
             % launches)
    return launches, secs, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "cornetto_tpu_torch")):
        fail("cornetto_tpu_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")

    clock = [time.perf_counter()]
    phase_s = {}

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 2)
        clock[0] = now

    card = phase_device()
    lap("1 device")
    phase_build()
    lap("2 build")
    max_err, ktimes = phase_kernels(args.seed)
    ws_err, ws_times = phase_window_kernel(args.seed)
    lap("3 kernel")

    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.native.fastq_pack import iter_packed_batches
    from cornetto_tpu_torch.kernels.extract import (extract_minima,
                                                    extract_minima_ref)
    from cornetto_tpu_torch.livefish import decide as td
    from cornetto_tpu_torch.livefish.stream import stream_decisions

    work = os.path.join(HERE, "build", "smoke")
    os.makedirs(work, exist_ok=True)

    # [4] state at human scale
    contigs = human_draft(args.seed)
    t0 = time.perf_counter()
    codes = genome_codes(args.seed, contigs)
    rows_bed = panel_rows(args.seed, contigs, 1_000_000)
    log("[4 state] draft: %d contigs, %d bp, largest %d bp, generated in "
        "%.1f s" % (len(contigs), sum(n for _, n in contigs),
                    max(n for _, n in contigs), time.perf_counter() - t0))
    idx_path = os.path.join(work, "human_s%d" % args.seed)
    build_or_load_index(idx_path, contigs, codes, rows_bed)
    t0 = time.perf_counter()
    idx, panel, _ = load_index(idx_path)
    torch.cuda.reset_peak_memory_stats()
    eng = td.SingleChipEngine(idx, panel, device="cuda")  # state_from_index
    eng.contig_names = idx.contig_names
    state = eng.state
    torch.cuda.synchronize()
    log("[4 state] uploaded btable %s = %d bytes, panel %s, in %.1f s; "
        "max_memory_allocated %d bytes"
        % (tuple(state.btable.shape),
           state.btable.numel() * state.btable.element_size(),
           tuple(state.panel.shape), time.perf_counter() - t0,
           torch.cuda.max_memory_allocated()))
    lap("4 state")

    # [5] the slice end to end through the CLI
    n_reads = FULL_BATCHES * BATCH + TAIL
    fq = os.path.join(work, "human_s%d.fq" % args.seed)
    t0 = time.perf_counter()
    truth = write_reads(fq, args.seed, contigs, codes, rows_bed, 1_000_000,
                        n_reads)
    log("[5 slice] wrote %d reads (%d batches of %d) in %.1f s"
        % (n_reads, -(-n_reads // BATCH), BATCH, time.perf_counter() - t0))
    del codes
    tsv = os.path.join(work, "human_s%d.tsv" % args.seed)
    torch.cuda.reset_peak_memory_stats()
    extract_minima.launches = 0
    t0 = time.perf_counter()
    rows = run_cli(idx_path, fq, tsv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = extract_minima.launches
    n_batches = -(-n_reads // BATCH)
    log("[5 slice] livefish run: %d rows in %.2f s (index load + upload "
        "included), %d kernel launches for %d batches, max_memory_allocated "
        "%d bytes" % (len(rows), cli_s, launches, n_batches,
                      torch.cuda.max_memory_allocated()))
    if launches != n_batches:
        fail("extraction kernel launched %d times for %d batches"
             % (launches, n_batches))
    names = [n for n, _ in contigs]
    acc = score(rows, names, *truth)
    log("[5 slice] human-scale accuracy: right contig %.4f, right decision "
        "%.4f, both %.4f (genomic reads); junk proceed %.4f" % acc)

    small = small_draft()
    s_codes = genome_codes(args.seed, small)
    s_rows = panel_rows(args.seed, small, 50_000)
    s_idx = os.path.join(work, "small_s%d" % args.seed)
    build_or_load_index(s_idx, small, s_codes, s_rows)
    s_fq = os.path.join(work, "small_s%d.fq" % args.seed)
    s_truth = write_reads(s_fq, args.seed, small, s_codes, s_rows, 50_000,
                          16 * BATCH + TAIL)
    s_rowsout = run_cli(s_idx, s_fq, os.path.join(work, "small.tsv"))
    s_acc = score(s_rowsout, [n for n, _ in small], *s_truth)
    log("[5 slice] 24 Mbp accuracy: right contig %.4f, right decision %.4f, "
        "both %.4f (genomic reads); junk proceed %.4f" % s_acc)
    if s_acc[2] < 0.99 or s_acc[3] < 1.0:
        fail("decisions on the 24 Mbp draft below 99%% right or a junk "
             "read unblocked: %s" % (s_acc,))
    lap("5 slice")

    # [6] card against CPU on the first two batches
    head = os.path.join(work, "head.fq")
    with open(fq, "rb") as src, open(head, "wb") as dst:
        for _ in range(2 * BATCH * 4):
            dst.write(src.readline())
    os.environ["CORNETTO_FORCE_CPU"] = "1"
    try:
        t0 = time.perf_counter()
        cpu_rows = run_cli(idx_path, head, os.path.join(work, "head.tsv"))
    finally:
        del os.environ["CORNETTO_FORCE_CPU"]
    same = cpu_rows == rows[:2 * BATCH]
    log("[6 cpu] %d CPU rows (plain versions) in %.1f s, identical to the "
        "card's: %s" % (len(cpu_rows), time.perf_counter() - t0, same))
    if not same:
        fail("CPU rows differ from the card's rows")
    lap("6 cpu")

    # [7] numbers
    with open(os.devnull, "w") as dn:
        t0 = time.perf_counter()
        total, _ = stream_decisions(eng, fq, BATCH, READ_LEN, out=dn)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nparse = sum(pb.count for pb in iter_packed_batches(fq, BATCH, READ_LEN))
    parse_s = time.perf_counter() - t0
    pb = next(b for b in iter_packed_batches(fq, BATCH, READ_LEN)
              if b.nmask is None and b.count == BATCH)
    pk = torch.from_numpy(pb.packed).cuda()
    kw = eng._kw(READ_LEN)
    step = lambda: td.decision_core_packed_fused(state.btable, pk, None,
                                                 state.panel, **kw)
    ms_step = cuda_ms(step, 20)
    ms_ext = cuda_ms(lambda: extract_minima(pk, None, READ_LEN, K, W), 50)
    ms_h2d = cuda_ms(lambda: torch.from_numpy(pb.packed).cuda(), 20)
    out = step()
    ms_d2h = cuda_ms(lambda: out.cpu(), 20)
    ms_step_ref = cuda_ms(lambda: td._decide_from_minima(
        state.btable, *extract_minima_ref(pk, None, READ_LEN, K, W),
        state.panel, 3, 1000, state.bucket_shift, state.two_choice), 5)
    log("[7 numbers] %s" % card)
    log("[7 numbers] FASTQ->TSV %d reads in %.3f s = %.0f reads/s "
        "(index resident; %s)" % (total, e2e_s, total / e2e_s, card))
    log("[7 numbers] host parse+pack alone: %.0f reads/s" % (nparse
                                                           / parse_s))
    log("[7 numbers] per 4096-read batch: device step %.4f ms (extraction "
        "kernel %.4f ms, lookup+votes+policy %.4f ms), same step with the "
        "plain extraction %.4f ms; H2D packed %.4f ms; D2H fused %.4f ms "
        "(%s)" % (ms_step, ms_ext, ms_step - ms_ext, ms_step_ref, ms_h2d,
                  ms_d2h, card))
    del eng, state, idx, panel
    torch.cuda.empty_cache()
    lap("7 numbers")

    # [8]-[10] the panel path
    phase_goldens(work)
    lap("8 goldens")
    hp_err, hp = phase_human_panel(args.seed, work, contigs)
    lap("9 panel")
    ws_launches, it = phase_iteration(args.seed, work)
    lap("10 iteration")

    # [11]-[13] the annotation path, on a draft of chr1-chr3
    draft, slice_fa, counts = write_annotation_draft(
        os.path.join(work, "annot_s%d" % args.seed), args.seed, contigs[:3])
    log("[11 annotation draft] %d contigs, %d bp (%s), slice %d bp"
        % (3, sum(n for _, n in contigs[:3]), counts, SLICE))
    lap("11 annotation draft")
    ak = phase_annotation_kernels(args.seed, slice_fa, draft)
    lap("11 annotation kernels")
    phase_annotation_goldens(work)
    lap("12 annotation goldens")
    an_launches, an_secs, an_stats = phase_annotation(
        args.seed, draft, slice_fa, contigs[:3])
    lap("13 annotation")
    torch.cuda.empty_cache()
    phase_cuda_tests(work)
    lap("14 cuda tests")
    log("[7 numbers] window-sum kernel at chr1, (2, 248956422) uint16, "
        "W=%d S=%d: %.4f ms, plain %.4f ms, x.unfold(...).sum(...) %.4f ms "
        "(%s)" % (WIN, INC, ws_times["ms"], ws_times["plain_ms"],
                  ws_times["library_ms"], card))
    log("[7 numbers] human-scale window stats, 87 contigs: %.0f windows/s "
        "(%s)" % (hp["human_windows_per_s"], card))
    log("[7 numbers] create-panel --ranged-bedgraph, chr1-chr3 on the card: "
        "%(wall).2f s wall = assembly bed %(assembly_bed).2f + fun windows "
        "(parse+thresholds %(parse).2f, window stats %(stats).2f) + "
        "interval chain %(chain).2f + bigenough %(bigenough).2f (%(card)s)"
        % dict(hp["create_panel"], card=card))
    log("[7 numbers] livefish cov: %d reads in %.2f s = %.0f reads/s "
        "(32 Mbp index load included; %s)"
        % (it["n_reads"], it["cov_s"], it["cov_reads_per_s"], card))
    log("[7 numbers] aligner-free iteration: flow %.2f s, steps %s (%s)"
        % (it["flow_s"], it["flow_steps"], card))
    log("[7 numbers] annotation, chr1-chr3 689 Mbp: sdust (device) %.2f s "
        "(kernel %.3f ms light + %.3f ms heavy, %d heavy rows, in the split "
        "run), telofind (device) %.2f s, --backend host %.2f s; sdust on "
        "the 20 Mb slice: device %.2f s, host %.2f s (%s)"
        % (an_secs["sdust"], an_stats.get("light_ms", 0.0),
           an_stats.get("heavy_ms", 0.0), an_stats.get("heavy_rows", 0),
           an_secs["telofind"], an_secs["telofind_host"],
           an_secs["sdust_slice_device"], an_secs["sdust_slice_host"], card))
    sd = ak["sdust"]
    log("[7 numbers] sdust kernel at the main path's shape (384 rows, core "
        "2048): two passes %.4f ms (%d heavy rows), PR 3's single pass %.4f "
        "ms, plain %.1f ms; bound %.4f ms (%s) (%s)"
        % (sd["ms"], sd["heavy_rows"], sd["old_ms"], sd["plain_ms"],
           *bound(sd), card))
    log("[phases] seconds: %s; total %.1f s"
        % (json.dumps(phase_s), sum(phase_s.values())))

    table = [
        ("extract_minima", "extract_minima", "pallas_extract.py:161",
         launches, max_err, ktimes["nfree"]),
        ("window_sum", "window_sum", "pallas_window.py:37", ws_launches,
         max(ws_err, hp_err), ws_times),
        ("sdust", "sdust", "pallas_sdust.py:316", an_launches["sdust"],
         ak["sdust"]["err"], ak["sdust"]),
        ("telo_match_mask", "telo", "pallas_telo.py:63",
         an_launches["telo_match_mask"], ak["telo_match_mask"]["err"],
         ak["telo_match_mask"]),
        ("telo_run_stats", "telo", "pallas_telo.py:147",
         an_launches["telo_run_stats"], ak["telo_run_stats"]["err"],
         ak["telo_run_stats"])]
    kernels = []
    for name, src, replaces, n_launch, err, t in table:
        b_ms, b_by = bound(t)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cornetto_tpu_torch/csrc/%s.cu" % src,
            "replaces": "cornetto_tpu/kernels/%s" % replaces,
            "launches": n_launch, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
