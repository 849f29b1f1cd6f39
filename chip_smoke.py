#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (cornetto_tpu_torch).

    python3 chip_smoke.py [--seed N] [--votes-against DIR]
    python3 chip_smoke.py --sanitize-cases | --sanitize

Needs one NVIDIA GPU with the CUDA toolkit (nvcc).  Run from the root of a
checkout.  With --votes-against DIR (another checkout, such as the parent
commit's, unpacked under build/), phase 16 also times DIR's votes and
policy kernels in turns with this checkout's on its batch and index.

--sanitize-cases runs only every kernel entry point at the small ragged
shapes of tests/_torch_ragged_cases.py against its plain version and exits
1 on any difference.  --sanitize builds the kernels and runs --sanitize-cases four times, under
compute-sanitizer's memcheck, racecheck, initcheck and synccheck
(--error-exitcode 1, PYTORCH_NO_CUDA_MEMORY_CACHING=1 so that each
torch.empty is an allocation of its own), with one line a tool; it fails
on a missing tool or any report.  It is not a phase of the full run:
on the H100 this script is run on, every tool refuses the card ("Device
not supported"; PERF.md section 7).  The full run:

1. prints the card, its power limit and the toolchain;
2. builds the six kernel sources of cornetto_tpu_torch/csrc;
3. holds the extraction kernel bit-equal to its plain PyTorch version on
   the card in all three validity variants, and times both; the fused
   decision kernel (extraction, lookup, votes and policy in one launch)
   bit-equal to its plain version in both output forms on small seeded
   indexes (tests/_decide_cases.py: C = 3 and 300, two_choice on and off,
   min_hits 0 and 3, a table at high occupancy; reads with no hit, with
   ambiguous hits only, tied between two contigs, at the panel's last bin)
   and, once phase 4 has the human-scale index on the card, on 4096 x 450
   reads in the three validity variants, a 1000-read tail and 512 x 1800
   reads, timed beside the plain step; the window-sum kernel in 11 cases
   (chr1's two tracks timed, with x.unfold(...).sum(...) as the library
   yardstick);
4. builds a seeded synthetic draft at human scale (GRCh38's chromosome
   lengths, 3.09 Gbp in 87 contigs, with 10,000 copies of one 1,500-base
   repeat element planted in it), its minimizer index (the port's host
   index build; also hash-sharded in two, for phase 16) and a panel of
   half its 1 Mb blocks, under build/smoke/ (reused on a rerun with the
   same seed), and uploads the index;
5. runs 64 full batches of 4096 sampled 450-base reads plus a short tail
   through `cornetto_tpu_torch.cli livefish run`, checking one row per read
   and one fused-kernel launch per batch (no standalone extraction); it then runs a second draft small
   enough for 15-mer seeds to be nearly unique (24 Mbp, 96 contigs) through
   the same entry point and requires >= 99% right contigs and decisions on
   genomic reads and `proceed` on every junk read;
6. decides the first two batches again on the CPU (plain versions) and
   requires byte-identical rows;
7. prints end-to-end reads/s, host parse+pack alone, the fused kernel's
   time beside its bound, the step through decision_core_packed_fused and
   the earlier step (the extraction kernel, then lookup, votes and policy
   as torch ops);
8. runs `boringbits` / `noboringbits` through `cornetto_tpu_torch.cli` with
   the four golden option sets on test_data/synth and requires output
   byte-equal to test_data/golden and window-sum launches;
9. at human scale: window stats of seeded uint16 depth and MQ tracks for
   all 87 contigs on the card against the plain version, then
   `create-panel --ranged-bedgraph` on chr1-chr3 (689 Mbp) against a
   CORNETTO_FORCE_CPU=1 run, byte for byte;
10. one aligner-free iteration, `cornetto_tpu_torch.cli flow` on a 32 Mbp
   draft with coverage holes and ~430k reads (livefish cov -> create-panel
   -> telostats -> livefish index), checking the launches (one fused
   decision launch per `cov` batch) and the panel, then `livefish cov` on
   two batches on the card against the CPU;
11. writes the annotation draft of phase 13 (reused per seed) and holds
   the SDUST, telomere-mask and run-stats kernels equal to their plain
   versions on the card (SDUST in both designs, the light + heavy passes
   and PR 3's single pass, on seeded mixed chunks at core 512, also at
   W = 3, 4, 8 and 66 with T = 5 or 14 and a budget of 16 row-steps, and at
   the main path's shape, core 2048, on chunks of the draft's 20 Mb slice
   plus overflow rows; chr1's length as one row; the run stats on read
   batches with telomeric arrays at RS_SHAPES: the doubling-cap lengths,
   lengths about the bitset's words and lanes, and rows past the bitset's
   4,096 bases on the row walk, each bit-equal to the plain version for
   both motifs and timed by CUDA-graph replay; at (4096, 450) and (4096,
   1800) the row walk, the first design, too), and times both; SDUST's
   two designs are timed in turns (old, new, new, old) on the slice chunks
   alone, the seeded rows alone, the costliest row alone (by the plain
   version's find_perfect row-steps) and the main-path case; then the two
   passes' time against the light pass's budget on the main-path case and
   on 1,024 chunks to all of chr1's of the cut, each held equal to PR 3's
   single pass; the mask also at (4097, 451), (3, 17), (2, 5) and (1, 15)
   with k = 1, 6, 37 and 100 and the self-overlapping AAAAAA and TATATA,
   and on views 1-15 bytes past a 16-byte boundary, each with
   telo_match_positions against nonzero of the plain mask; chr1's mask
   timed beside its bound, and with the compaction;
12. runs the annotation goldens (sdust, telofind on the device backends,
   the default and named, telowin, telobreaks) through
   `cornetto_tpu_torch.cli` on the card, byte-equal to test_data/golden;
13. the annotation chain at human scale: chr1-chr3 (689 Mbp) with seeded
   satellites, telomere arrays and N gaps through `sdust` and `telofind`
   (their default, device backends), then `telowin` and `telobreaks` on
   their outputs and read tagging with the run-stats kernel; a second sdust
   run gives the per-part split and the SDUST kernel's time as light pass
   plus heavy pass with the number of heavy rows; telofind byte-equal to
   its `--backend host` on the whole cut, sdust on a 20 Mb slice; second
   telofind runs through `tools.telofind.run(stats=...)` on both backends
   give its per-part split (FASTA read, uppercase + encode, H2D, kernel,
   compaction, readback, host walk, output), their output equal to the CLI
   run's;
14. runs the `cuda`-marked tests of tests/test_torch_cuda_kernels.py
   through `python -m pytest --noconftest -m cuda` in a subprocess (the
   file imports neither jax nor the JAX package) and requires every test
   it collects to pass;
15. `livefish replay` (the read-until chunk engine) on the human-scale
   index through `cornetto_tpu_torch.cli`, 60,000 seeded reads of 2-20 kb
   (written in phase 5 as FASTA, about half starting in a panel block, 30%
   starting inside a copy of a repeat element planted in the draft, which
   the index masks, so that a head longer than about a chunk is decided on
   a later chunk's accumulated prefix) in 448-base
   chunks: host and device state at 512 channels (a MinION flow cell, the
   CLI's default) and at 3000 (about a PromethION flow cell, 20 reads a
   channel), their stdout byte-equal, with ticks/s, decisions/s, fused
   launches a tick and the decisions by the chunks they consumed (the run
   fails if no read is decided after its first chunk); the
   card's host state byte-equal to a CORNETTO_FORCE_CPU=1 run on the first
   256 reads; then one device tick at 512 and 3000 channels (scatter,
   gather, fused kernel) held equal to the plain step and timed by graph
   replay, and its device operations from torch.profiler;
16. the multi-device runtime (cornetto_tpu_torch/dist, make_sharded_engine)
   on the one card: an NCCL process group of one rank deciding phase 5's
   65 batches at (dp, ep) = (1, 1), bit-equal to SingleChipEngine, with
   one launch of the fused step a batch (no planes, no reduce-scatter);
   two gloo processes sharing the card (this script with --dist-rank), at
   (1, 2) on the 2-shard index, held to the plain looped-shard oracle and
   compared with the 1-shard engine, with one extraction, one votes and
   one policy launch a batch a rank, and at (2, 1), held to
   SingleChipEngine, plus an sp scan of chr1's length held to the
   single-device window stats; the votes and policy kernels against their
   plain versions at C = 1, 87 and past the shared-memory limit, timed by
   graph replay, the policy beside an empty kernel's launch floor; the
   sharded step's per-stage split from CUDA events; each gloo rank's (1,
   2) engine state (its 2.15 GB table shard and the panel)
   through dist.checkpoint.save_sharded and load_sharded into fresh
   tensors on the card, timed, and the reloaded engine's rows held to the
   first run's (reported with phase 18);
17. the host subcommands through `cornetto_tpu_torch.cli`: `telostats` on
   test_data/gen_synth_pipe.py's assembly and on test_data/synth, each
   byte-equal to test_data/golden/pipelines/{telo,telosmall} with
   telomere-mask launches, and on phase 13's chr1-chr3 cut on the card
   against a CORNETTO_FORCE_CPU=1 run (both walls); `recreate-panel`
   against its golden panel; `sdust -w 67` and `-t 4` on the default
   backend (the host DP, no SDUST launch) byte-equal to `--backend host`,
   and `--backend device -w 67` exiting 1; fa2bed, seq, telocontigs, nx,
   report, asmstats and fixasm against their goldens; `depth` over BED
   regions of test_data/example.bam against its reads' CIGARs, and a
   `bammerge` of it with itself (with and without its .bai) whose depth
   is twice the input's;
18. eval and recovery: `minidot` on its three EPS goldens; `create-panel`
   (the card's window sums) and `recreate-panel`, each followed by
   `hapnetto` with gen_synth_pipe.py's haplotype PAFs, byte-equal to
   test_data/golden/pipelines/{create,recreate} (pasm_dip.* included);
   `minidot -f 2 --png` on a PAF of phase 13's chr1-chr3 cut built by
   construction (5 Mb blocks, one contig on the reverse strand) and
   `gfa2fa` on a GFA of the cut's S-lines (byte-equal to the cut's
   FASTA); `flow-eval` on the cut with command templates standing for
   minimap2 (writing that PAF), quast, compleasm and yak (minidotplot,
   telostats with its mask launches and asmstats run for real), every
   file byte-equal to a CORNETTO_FORCE_CPU=1 run's; `refine` over two
   iterations of contigs past its 40 Mbp minimum with telomere arrays
   planted at their ends (the ends from `telostats` on the card), in a
   process of its own for its peak RSS; the crash-injected stream
   (tests/_torch_ckpt_worker.py) under NCCL at (1, 1) on the human-scale
   index in 4096-read batches: the uninterrupted oracle and a life killed
   at each of mid_part:1, after_part:1 and after_ckpt:2, then each
   resumed, its decisions.tsv and tallies byte-identical to the oracle's,
   the oracle's rows equal to SingleChipEngine's on the same batches.

Phase 2 builds the six kernel sources in parallel; phases 3, 11 and 16
hold each kernel bit-equal to its plain PyTorch version on the card.  Imports
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
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, READ_LEN, K, W = 4096, 450, 15, 10
FULL_BATCHES, TAIL = 64, 1000
KERNELS = ("extract_minima", "decide", "votes", "window_sum", "sdust",
           "telo")
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
# (early_exit_compares); a 32-position word of the run stats' match
# bitset, four bytes a compare (an XOR and an OR for each of its 8 words a
# motif code) and 3 ops a doubling step (stats_word_ops; the TPU kernel's
# dense count, 2k byte compares and 3 ops a doubling step a base, is
# printed beside it: the first design was held to it).  The fused
# decision step moves the packed reads
# (with their bitmap or lengths), one bucket row a probe of each valid
# window of this run's reads, a panel byte and its outputs a read; its
# operations are counted as extraction's (decide_work).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
EXTRACT_OPS_KMER = 25
SDUST_OPS_BASE, SDUST_OPS_ROW_STEP = 20, 8
# run-stats shapes of phase 11: the read batches at 450 and 1800 (the main
# shapes, timed against the first design too), the doubling-cap lengths, rows
# shorter than the motif, lengths about the bitset's 32-position words and
# its 32-lane groups (1,024 positions), the bitset's longest row and rows
# past it (the row walk)
RS_SHAPES = [(4096, 450), (4096, 1800), (4096, 18), (4096, 19), (4096, 42),
             (64, 5), (4096, 31), (4096, 32), (4096, 33), (4096, 1024),
             (4096, 1025), (256, 4096), (64, 4097), (2, 1_000_003)]
STATS_BITSET_MAX_L = 4096            # csrc/telo.cu's kStatsMaxL


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


def stats_word_ops(B: int, L: int, k: int, steps: int) -> int:
    """Operations of the run stats at (B, L) at the bitset's granularity
    (see above); the dense count is B * L * (2 k + 3 steps)."""
    return B * (-(-max(L - k + 1, 0) // 32)) * (16 * k + 3 * steps)


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


def build_or_load_index(path: str, contigs, codes, rows, n_shards: int = 1):
    """Build (or reuse) the index + panel checkpoint at path(.npz), its
    table hash-sharded n_shards ways."""
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
                      n_shards=n_shards, k=K, w=W, keep_tables=False)
    panel = build_panel_mask(idx, rows)
    save_index(path, idx, panel_mask=panel)
    open(stamp, "w").close()
    dt = time.perf_counter() - t0
    log("index: built %d contigs, %.3f Gbp, %d shards x %d buckets x %d "
        "slots, dropped %.4f%%, in %.1f s -> %s.npz"
        % (len(contigs), sum(n for _, n in contigs) / 1e9, n_shards,
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


def graph_ms(fn, n: int = 100, reps: int = 5) -> float:
    """Device time of one call of fn: n calls captured in a CUDA graph,
    the best of reps replays timed with CUDA events over n.  Leaves out
    the host's cost of a call (the Python wrapper, the ctypes launch),
    which back-to-back calls timed with cuda_ms include."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / n)
    del g
    return best


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
                if any(w in line for w in ("entry function", "registers",
                                           "smem", "spill")):
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
                call = lambda: extract_minima(pk, nm, L, k, w,  # noqa
                                              lengths=ln)
                ms = graph_ms(call)
                ms_call = cuda_ms(call, 200)
                ms_ref = cuda_ms(lambda: extract_minima_ref(
                    pk, nm, L, k, w, lengths=ln), 10)
                m = (L - k + 1) // w
                timing[variant] = dict(
                    ms=ms, call_ms=ms_call, plain_ms=ms_ref,
                    bytes=pk.numel() + B * m * 5,
                    ops=B * (L - k + 1) * EXTRACT_OPS_KMER)
                line += (" kernel %.4f ms (graph replay), %.4f ms a "
                         "wrapper call back to back, plain %.4f ms"
                         % (ms, ms_call, ms_ref))
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


def decide_work(btable, two_choice, pk, nm, ln, L, fused, valid_windows):
    """{"bytes", "ops"} of one fused decision step (see bound)."""
    B = pk.shape[0]
    row = btable.shape[1] * 4
    probes = 2 if two_choice else 1
    inputs = pk.numel() + (0 if nm is None else nm.numel()) + \
        (0 if ln is None else ln.numel() * 4)
    outputs = B * (8 if fused else 21)
    return dict(bytes=inputs + valid_windows * probes * row + B + outputs,
                ops=B * (L - K + 1) * EXTRACT_OPS_KMER)


def _check_decide(label, btable, pk, nm, ln, panel, L, k, w, min_hits,
                  bucket_shift, two_choice):
    """The fused kernel against its plain version in both output forms;
    returns the largest absolute difference (fails unless 0)."""
    import torch
    from cornetto_tpu_torch.kernels.decide import (decide_packed,
                                                   decide_packed_ref)
    kw = dict(L=L, k=k, w=w, min_hits=min_hits, bin_size=1000,
              bucket_shift=bucket_shift, two_choice=two_choice, lengths=ln)
    worst = 0
    for fused in (False, True):
        got = decide_packed(btable, pk, nm, panel, fused=fused, **kw)
        torch.cuda.synchronize()
        want = decide_packed_ref(btable, pk, nm, panel, fused=fused, **kw)
        got, want = ((got,), (want,)) if fused else (got, want)
        for g, r in zip(got, want):
            same = g.dtype == r.dtype and torch.equal(g, r)
            err = int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
            worst = max(worst, err, 0 if same else 1)
    if worst:
        fail("the fused decision kernel disagrees with its plain version: "
             "%s" % label)
    return worst


def phase_decide_small(seed: int):
    """The fused kernel on the seeded small indexes of the tests."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _decide_cases as dc
    dev = torch.device("cuda")
    put = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa
    n = worst = 0
    for C, tc, total in [(3, True, 60_000), (3, False, 60_000),
                         (300, True, 60_000), (300, False, 60_000),
                         (4, True, 3_000_000)]:
        idx, panel, codes = dc.index(seed, C, tc, L=READ_LEN, total=total)
        bt, pn = put(idx.btable[0]), put(panel)
        for variant in dc.VARIANTS:
            packed, nmask, lengths, rows = dc.batch(seed, idx, panel, codes,
                                                    variant, B=128)
            for min_hits in (0, 3):
                worst = max(worst, _check_decide(
                    (C, tc, total, variant, min_hits), bt, put(packed),
                    put(nmask), put(lengths), pn, READ_LEN, idx.k, idx.w,
                    min_hits, idx.bucket_shift, tc))
                n += 1
    log("[3 kernel] decide: %d small-index cases (C = 3 and 300, "
        "two_choice on and off, min_hits 0 and 3, a table at high "
        "occupancy; no-hit, ambiguous-only, tied and last-bin reads), both "
        "output forms, max_abs_err=%d" % (n, worst))
    return worst


def _human_reads(seed: int, contigs, codes, B: int, L: int, variant: str):
    """B seeded reads of L bases of the human-scale draft (2% junk, half
    reverse-complemented) in a validity variant, packed on the host."""
    import numpy as np
    from cornetto_tpu_torch.kernels.minimizer import pack_reads
    rng = np.random.default_rng([seed, 9, B, L, len(variant)])
    lens = np.array([n for _, n in contigs], dtype=np.int64)
    ctg = rng.choice(len(contigs), size=B, p=lens / lens.sum())
    reads = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    for i in np.flatnonzero(rng.random(B) >= 0.02):
        c = int(ctg[i])
        s0 = int(rng.integers(0, lens[c] - L + 1))
        reads[i] = codes[c][s0:s0 + L]
    rc = rng.random(B) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    lengths = None
    if variant == "nmask":
        reads[rng.random((B, L)) < 0.01] = 4
        reads[0] = 4
    elif variant == "lengths":
        lengths = np.full(B, L, dtype=np.int32)
        short = rng.random(B) < 0.25
        lengths[short] = rng.integers(0, L, size=int(short.sum()))
    packed, nmask = pack_reads(reads)
    return packed, (nmask if variant == "nmask" else None), lengths


def phase_decide_human(seed: int, state, contigs, codes):
    """The fused kernel on the human-scale index: the decision loop's
    batch in the three validity variants, a short tail and the chunk
    engine's longest reads, then times at (4096, 450) N-free.  Returns
    (worst error, timing row)."""
    import torch
    from cornetto_tpu_torch.kernels.decide import (decide_packed,
                                                   decide_packed_ref)
    from cornetto_tpu_torch.kernels.extract import extract_minima_ref
    dev = torch.device("cuda")
    put = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa
    bt, pn = state.btable, state.panel
    worst, timing = 0, None
    cases = [(BATCH, READ_LEN, v) for v in ("nfree", "lengths", "nmask")] + \
        [(TAIL, READ_LEN, "lengths")] + \
        [(512, 1800, v) for v in ("nfree", "lengths", "nmask")]
    for B, L, variant in cases:
        pk, nm, ln = (put(a) for a in _human_reads(seed, contigs, codes, B,
                                                   L, variant))
        err = _check_decide(("human", B, L, variant), bt, pk, nm, ln, pn, L,
                            K, W, 3, state.bucket_shift, state.two_choice)
        worst = max(worst, err)
        _, valid = extract_minima_ref(pk, nm, L, K, W, lengths=ln)
        nvalid = int(valid.sum())
        line = ("[3 kernel] decide human-scale (%d, %d) %-7s valid windows "
                "%d, max_abs_err=%d" % (B, L, variant, nvalid, err))
        if (B, L, variant) == (BATCH, READ_LEN, "nfree"):
            kw = dict(L=L, k=K, w=W, min_hits=3, bin_size=1000,
                      bucket_shift=state.bucket_shift,
                      two_choice=state.two_choice, fused=True)
            call = lambda: decide_packed(bt, pk, None, pn, **kw)  # noqa
            ms = graph_ms(call)
            ms_call = cuda_ms(call, 200)
            ms_ref = cuda_ms(lambda: decide_packed_ref(bt, pk, None, pn,
                                                       **kw), 5)
            timing = dict(decide_work(bt, state.two_choice, pk, None, None,
                                      L, True, nvalid),
                          ms=ms, call_ms=ms_call, plain_ms=ms_ref,
                          library_ms=None, valid_windows=nvalid)
            b_ms, b_by = bound(timing)
            line += (" fused kernel %.4f ms (graph replay), %.4f ms a "
                     "wrapper call back to back; bound %.4f ms (%s, %d "
                     "bytes) = %.1f%% of it reached; plain step %.4f ms"
                     % (ms, ms_call, b_ms, b_by, timing["bytes"],
                        100 * b_ms / ms, ms_ref))
        log(line)
        del pk, nm, ln
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


SANITIZER_TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")


def sanitize_cases():
    """--sanitize-cases: every case of tests/_torch_ragged_cases.py on the
    card against its plain version; one JSON line (cases, differences,
    launches a wrapper); exits 1 on a difference or on a wrapper the
    cases never launched."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_ragged_cases as rc
    dev = torch.device("cuda")
    before = {w.__name__: w.launches for w in rc.WRAPPERS}
    bad = {}
    for name in rc.CASES:
        diff = rc.check(name, dev)
        if diff:
            bad[name] = diff
    launches = {w.__name__: w.launches - before[w.__name__]
                for w in rc.WRAPPERS}
    print(json.dumps({"cases": len(rc.CASES), "differ": bad,
                      "launches": launches}), flush=True)
    if bad:
        fail("%d ragged cases differ from their plain versions" % len(bad))
    if not all(launches.values()):
        fail("a wrapper was never launched: %s" % launches)


def sanitizer_path():
    """compute-sanitizer of the CUDA toolkit PyTorch found, else the one on
    PATH, else None (as kernels/_build.py::nvcc_path finds nvcc)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "compute-sanitizer")
        if os.path.exists(cand):
            return cand
    return shutil.which("compute-sanitizer")


def phase_sanitize(work: str):
    """--sanitize: --sanitize-cases under each compute-sanitizer tool; each
    tool's whole report goes to build/smoke/sanitize_<tool>.log.  Fails on
    a missing tool, a tool's non-zero exit or any error it counts."""
    tool = sanitizer_path()
    if tool is None:
        fail("compute-sanitizer not found in $CUDA_HOME/bin or on PATH")
    ver = subprocess.run([tool, "--version"], capture_output=True,
                         text=True, timeout=60)
    log("[19 sanitize] %s: %s" % (tool, " ".join(
        ver.stdout.strip().splitlines()[-1:])))
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    env.pop("CORNETTO_FORCE_CPU", None)
    results = []
    for name in SANITIZER_TOOLS:
        cmd = [tool, "--tool", name, "--error-exitcode", "1",
               sys.executable, os.path.join(HERE, "chip_smoke.py"),
               "--sanitize-cases"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=600)
        secs = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        with open(os.path.join(work, "sanitize_%s.log" % name), "w") as f:
            f.write(out)
        counts = [int(x) for x in re.findall(
            r"(?:ERROR SUMMARY|RACECHECK SUMMARY): (\d+)", out)]
        launched = [json.loads(ln) for ln in proc.stdout.splitlines()
                    if ln.startswith('{"cases"')]
        refused = "Device not supported" in out
        results.append(dict(tool=name, exit=proc.returncode,
                            errors=sum(counts), seconds=round(secs, 2),
                            refused=refused,
                            launches=launched[0]["launches"] if launched
                            else None))
        log("[19 sanitize] %s: exit %d, %d errors, %.2f s%s, kernels "
            "launched: %s" % (name, proc.returncode, sum(counts), secs,
                              " (the tool refused the card: Device not "
                              "supported)" if refused else "",
                              results[-1]["launches"]))
    print(json.dumps({"sanitize": results}), flush=True)
    if any(r["exit"] or r["errors"] or r["launches"] is None
           for r in results):
        fail("compute-sanitizer: a tool failed or reported errors (see "
             "build/smoke/sanitize_<tool>.log)")


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


def run_cli_quiet(argv, stdout_path: str, stderr_path: str,
                  rc_want: int = 0) -> None:
    """One port CLI command in this process, stdout and stderr to files;
    fails unless it exits rc_want."""
    from cornetto_tpu_torch.cli import main as cli
    with open(stdout_path, "w") as fo, open(stderr_path, "w") as fe, \
            contextlib.redirect_stdout(fo), contextlib.redirect_stderr(fe):
        try:
            rc = cli(["cornetto"] + argv)
        except SystemExit as e:          # log.die
            rc = e.code
    if rc != rc_want:
        with open(stderr_path) as f:
            tail = f.read()[-2000:]
        fail("%s exited %d, not %d:\n%s" % (" ".join(argv[:2]), rc, rc_want,
                                             tail))


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
    """Every file a run wrote under root, but create-panel's stderr log
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
    from cornetto_tpu_torch.kernels.decide import decide_packed
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
    decide_packed.launches = 0
    window_sums.launches = 0
    t0 = time.perf_counter()
    run_cli_quiet(["flow", wd, fasta, fq, "--config", cfg],
                  os.path.join(path, "flow.out"), os.path.join(path,
                                                               "flow.err"))
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    dec, ext = decide_packed.launches, extract_minima.launches
    ws = window_sums.launches
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
    log("[10 iteration] flow in %.2f s (steps %s); fused decision launches "
        "%d for %d cov batches (standalone extraction %d); window-sum "
        "launches %d; panel %d rows, %d bp, %d on contigs < 800 kb, %d "
        "within 40 kb of a hole; draft.livefish.npz written: %s"
        % (flow_s, secs, dec, n_batches, ext, ws, len(rows),
           sum(e - s for _, s, e in rows), len(short_rows), len(in_holes),
           npz))
    if dec != n_batches or ext or ws == 0 or not rows or short_rows \
            or in_holes or not npz:
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
# tools.telofind.run(stats=)'s parts on each backend
TF_PARTS = ("read", "encode", "h2d", "kernel", "compact", "readback", "walk",
            "output")
TF_HOST_PARTS = ("read", "encode", "walk", "output")
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


def _planted(rng, B: int, L: int, motif):
    """(B, L) codes 0-4 with the motif at the start, in a tandem array and
    at the end of each row long enough to hold it."""
    import numpy as np
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    m = np.array(motif, np.uint8)
    k = len(m)
    for r in range(B) if L >= k else []:
        c = max(1, min(L // k, 4))
        s = int(rng.integers(0, L - c * k + 1))
        codes[r, s:s + c * k] = np.tile(m, c)
        codes[r, :k] = m
        codes[r, L - k:] = m
    return codes


def _mask_cases(seed: int, dev):
    """The mask kernel against its plain version, and telo_match_positions
    against nonzero of the plain mask, in the cases beyond chr1 and the
    reads: ragged shapes (rows of odd length, rows shorter than a thread's
    16 positions, L < k), k = 1, k = 37 and k = 100 (past the 64 codes the
    kernel stages), self-overlapping motifs, and contiguous views that start
    1-15 bytes past a 16-byte boundary.  Returns the worst error."""
    import numpy as np
    import torch
    from cornetto_tpu_torch.kernels.telo import (telo_match_mask,
                                                 telo_match_mask_ref,
                                                 telo_match_positions)
    rng = np.random.default_rng([seed, 14])
    motifs = {"TTAGGG": TTAGGG, "k1": (2,), "AAAAAA": (0,) * 6,
              "TATATA": (3, 0) * 3,
              "k37": tuple(rng.integers(0, 4, 37).tolist()),
              "k100": tuple(rng.integers(0, 4, 100).tolist())}

    def check(x, motif):
        got = telo_match_mask(x, motif)
        ref = telo_match_mask_ref(x, motif)
        flat = x.reshape(-1)
        pos = telo_match_positions(flat, motif)
        want = torch.nonzero(telo_match_mask_ref(flat.reshape(1, -1),
                                                 motif)[0], as_tuple=True)[0]
        if not torch.equal(got, ref) or not torch.equal(pos, want):
            return max(int((got.int() - ref.int()).abs().max()), 1), 0
        return 0, int(ref.sum(dtype=torch.int64))

    worst, lines = 0, []
    for B, L in ((4097, 451), (3, 17), (2, 5), (1, 15)):
        for name, motif in motifs.items():
            x = torch.from_numpy(_planted(rng, B, L, motif)).to(dev)
            e, n = check(x, motif)
            worst = max(worst, e)
            lines.append("(%d, %d) %s: %d/%d" % (B, L, name, e, n))
    n_views = 0
    for off in range(1, 16):
        for name in ("TTAGGG", "k100"):
            base = torch.from_numpy(_planted(
                rng, 1, 1_000_016, motifs[name])).to(dev).reshape(-1)
            view = base[off:off + 1_000_000]
            if view.data_ptr() % 16 != off:
                fail("the view at offset %d is not %d bytes past a 16-byte "
                     "boundary" % (off, off))
            for shape in ((1, 1_000_000), (8, 125_000)):
                e, _ = check(view.reshape(shape), motifs[name])
                worst = max(worst, e)
                n_views += 1
    log("[11 annotation kernels] telo_match_mask further cases, (B, L) "
        "motif: max_abs_err/matches %s; %d unaligned views (offsets 1-15, "
        "TTAGGG and k = 100, (1, 1e6) and (8, 125000)); positions equal to "
        "nonzero of the plain mask in every case; max_abs_err=%d"
        % ("; ".join(lines), n_views, worst))
    if worst:
        fail("mask kernel or positions disagree with the plain version in a "
             "further case")
    return worst


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
    from cornetto_tpu_torch.kernels.telo import (_stats_launch, _steps_for,
                                                 telo_match_mask,
                                                 telo_match_mask_ref,
                                                 telo_match_positions,
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
    worst = max(worst, _mask_cases(seed, dev))
    ms = cuda_ms(lambda: telo_match_mask(chr1, TTAGGG), 20, warmup=3)
    plain_ms = cuda_ms(lambda: telo_match_mask_ref(chr1, TTAGGG), 3,
                       warmup=1)
    pos_ms = cuda_ms(lambda: telo_match_positions(chr1[0], TTAGGG), 20,
                     warmup=3)
    n, cmp = GRCH38[0], early_exit_compares(chr1, TTAGGG)
    b_ms, _ = bound(dict(bytes=2 * n, ops=cmp))
    log("[11 annotation kernels] telo_match_mask chr1 (1, %d): kernel %.4f "
        "ms (bound %.4f ms, bytes: %.1f%% of it), plain %.4f ms; "
        "telo_match_positions (kernel + compaction on the card) %.4f ms"
        % (GRCH38[0], ms, b_ms, 100 * b_ms / ms, plain_ms, pos_ms))
    log("[11 annotation kernels] telo_match_mask chr1: %d byte compares "
        "with early exit (%.3f a base)" % (cmp, cmp / n))
    out["telo_match_mask"] = dict(err=worst, ms=ms, plain_ms=plain_ms,
                                  positions_ms=pos_ms, bytes=2 * n, ops=cmp)
    del chr1
    torch.cuda.empty_cache()

    worst, times = 0, {}
    k = len(TTAGGG)
    for B, L in RS_SHAPES:
        steps = _steps_for(L - k + 1, k)
        x = torch.from_numpy(_telo_reads(seed, B, L)).to(dev)
        # the first design at the main shapes: the row walk (route 1) into
        # outputs allocated once, and the cast of its terminal bytes to
        # bool that its wrapper made (its motif upload, a host copy, cannot
        # be captured)
        old = None if L not in (450, 1800) else (
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.uint8, device=dev))
        for motif in (TTAGGG, CCCTAA):
            ref = telo_run_stats_ref(x, motif)
            runs = [("bitset" if L <= STATS_BITSET_MAX_L else "row walk",
                     telo_run_stats(x, motif))]
            if old:
                _stats_launch(x, motif, 24, 1, *old[:3])
                runs.append(("row walk (first design)", old[:3]))
            for name, got in runs:
                e = max(int((g.int() - r.int()).abs().max())
                        for g, r in zip(got, ref))
                worst = max(worst, e)
                log("[11 annotation kernels] telo_run_stats (%d, %d) motif "
                    "%s, %s: max_abs_err=%d, reads with a match %d, longest "
                    "%d copies, terminal %d"
                    % (B, L, motif, name, e, int((got[0] > 0).sum()),
                       int(got[1].max()), int(got[2].sum())))
                if e or not all(g.dtype == r.dtype and torch.equal(g, r)
                                for g, r in zip(got, ref)):
                    fail("run-stats kernel disagrees with its plain version")
        t = dict(ms=graph_ms(lambda: telo_run_stats(x, TTAGGG)))
        line = "graph replay %.4f ms" % t["ms"]
        if old:
            t.update(
                old_ms=graph_ms(lambda: (_stats_launch(x, TTAGGG, 24, 1,
                                                       *old[:3]),
                                         old[3].to(torch.bool))),
                call_ms=cuda_ms(lambda: telo_run_stats(x, TTAGGG), 200),
                plain_ms=cuda_ms(lambda: telo_run_stats_ref(x, TTAGGG), 10),
                bytes=B * L + 9 * B,
                ops=stats_word_ops(B, L, k, steps),
                dense_ops=B * L * (2 * k + 3 * steps))
            b_ms, b_by = bound(t)
            dense_ms = t["dense_ops"] / INT32_OPS_PER_S * 1e3
            line += ("; the first design (row walk + bool cast) %.4f ms "
                     "(graph replay); a wrapper call back to back %.4f ms; "
                     "plain %.4f ms; "
                     "bound %.4f ms (%s; %d bytes, %d word ops) = %.1f%% of "
                     "it reached; the TPU kernel's dense count, %d ops, "
                     "over the int32 rate: %.4f ms"
                     % (t["old_ms"], t["call_ms"], t["plain_ms"], b_ms, b_by,
                        t["bytes"], t["ops"], 100 * b_ms / t["ms"],
                        t["dense_ops"], dense_ms))
        times[(B, L)] = t
        log("[11 annotation kernels] telo_run_stats (%d, %d) TTAGGG: %s"
            % (B, L, line))
        del x, old
    out["telo_run_stats"] = dict(err=worst, times=times,
                                 **times[(4096, 450)])
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
    from cornetto_tpu_torch.tools import telofind as ttf
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
    # telofind's per-part split on both backends: second runs of the entry
    # point, the device one synchronising the card at the end of each part
    tf_split = {}
    for backend in ("device", "host"):
        st = tf_split[backend] = {}
        t0 = time.perf_counter()
        with open(p("telofind_split_%s.txt" % backend), "w") as f:
            ttf.run(draft, out=f, backend=backend, stats=st)
        torch.cuda.synchronize()
        st["wall"] = time.perf_counter() - t0
        st["same"] = _same_file(p("telofind.txt"),
                                p("telofind_split_%s.txt" % backend))
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
    for backend, parts in (("device", TF_PARTS), ("host", TF_HOST_PARTS)):
        st = tf_split[backend]
        log("[13 annotation] telofind split, %s backend (second run%s): "
            "%.2f s wall; %d contigs, %d bases, %d positions read back; "
            "parts: %s, rest %.3f s; output equal to the CLI run's: %s"
            % (backend, ", synchronised per part" if backend == "device"
               else "", st["wall"], st["contigs"], st["bases"],
               st.get("positions", 0),
               ", ".join("%s %.3f s" % (k, st.get(k, 0.0)) for k in parts),
               st["wall"] - sum(st.get(k, 0.0) for k in parts), st["same"]))
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
    if not (tf_same and sd_same and head_same and cut_head and split_same
            and all(st["same"] for st in tf_split.values())):
        fail("annotation outputs differ from the host backends")
    if win_ctgs != {c for c, _ in contigs} or not rows["telobreaks.txt"] \
            or not tagged["terminal"] or not masked:
        fail("the annotation chain missed a planted feature")
    if min(launches.values()) == 0 or launches["sdust"] != 2 * len(contigs) \
            or launches["telo_match_mask"] != 2 * len(contigs):
        fail("an annotation kernel was not launched as expected: %s"
             % launches)
    return launches, secs, stats, tf_split


# ---------------------------------------------------------------- replay

# 20 reads a channel at 3000 channels (about 117 at 512): 60,000 reads of
# 2-20 kb, 0.66 Gbp, so each cell runs hundreds of ticks and of fused
# launches; the CPU check takes the first 256
REPLAY_READS, REPLAY_CPU_READS = 60_000, 256
# a repeat family planted in the human draft (phase 4): REPEAT_COPIES
# copies, either strand, of one seeded REPEAT_LEN-base element, as an L1
# family (15 Mbp, 0.49% of the genome; L1 is 17%).  A copy's minimizers
# depend on its strand and its start modulo the window stride (20
# classes); with 10,000 copies each minimizer of any piece of the element
# still occurs more often than the index's repeat cap (256), so the index
# masks them: the element is unmappable.  (Random sequence is no unmappable
# head at 3.09 Gbp: nearly every 15-mer minimizer of it is in the index,
# so a random 448-base chunk always reaches min_hits on some contig.)
REPEAT_LEN, REPEAT_COPIES = 1500, 10_000
# a share of the replay reads starts inside a copy: a 200-1,500-base piece
# of the element in place of the read's first bases, so a head longer
# than about a chunk is decided on the accumulated prefix of a later
# chunk (chunk slots 1-3 of the device state)
REPLAY_REPEAT_SHARE, REPLAY_REPEAT_HEAD = 0.3, (200, 1500)
# bases a chunk: the CLI's 450 is not a multiple of 4, which the device
# state's 2-bit chunk slots need, so both states take 448 (~1 s of a pore)
REPLAY_CHUNK = 448
# (label, channels = batch): the CLI's default, a MinION flow cell; about a
# PromethION flow cell
REPLAY_CELLS = [("MinION", 512), ("PromethION", 3000)]


def plant_repeats(seed: int, contigs, codes):
    """Write REPEAT_COPIES seeded copies of one REPEAT_LEN-base element
    into the draft's codes, in place, half of them reverse-complemented;
    returns the element."""
    import numpy as np
    rng = np.random.default_rng([seed, 19])
    elem = rng.integers(0, 4, size=REPEAT_LEN, dtype=np.uint8)
    lens = np.array([n for _, n in contigs], dtype=np.int64)
    for _ in range(REPEAT_COPIES):
        c = int(rng.choice(len(contigs), p=lens / lens.sum()))
        s = int(rng.integers(0, lens[c] - REPEAT_LEN))
        codes[c][s:s + REPEAT_LEN] = elem if rng.random() < 0.5 \
            else 3 - elem[::-1]
    return elem


def write_replay_reads(path: str, seed: int, contigs, codes, rows,
                       block: int, n_reads: int, elem):
    """n_reads seeded full-length reads of 2-20 kb (uniform) of the draft
    as FASTA, half reverse-complemented, about half starting inside a
    panel block, REPLAY_REPEAT_SHARE of them with a head of the repeat
    element elem; returns (the number of bases, the number of repeat
    heads)."""
    import numpy as np
    rng = np.random.default_rng([seed, 17])
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    lens = np.array([n for _, n in contigs], dtype=np.int64)
    names = [n for n, _ in contigs]
    panel = {}
    for name, st, _ in rows:
        panel.setdefault(name, []).append(st // block)
    total = heads = 0
    with open(path, "wb") as f:
        for i in range(n_reads):
            ln = int(rng.integers(2000, 20001))
            c = int(rng.choice(len(contigs), p=lens / lens.sum()))
            blocks = panel.get(names[c], [])
            if rng.random() < 0.5 and blocks:
                b = blocks[int(rng.integers(0, len(blocks)))]
                s = b * block + int(rng.integers(0, block))
            else:
                s = int(rng.integers(0, lens[c]))
            s = max(0, min(s, int(lens[c]) - ln))
            read = codes[c][s:s + ln]
            if rng.random() < 0.5:
                read = 3 - read[::-1]
            if rng.random() < REPLAY_REPEAT_SHARE:
                hl = int(rng.integers(REPLAY_REPEAT_HEAD[0],
                                      REPLAY_REPEAT_HEAD[1] + 1))
                o = int(rng.integers(0, REPEAT_LEN - hl + 1))
                head = elem[o:o + hl]
                if rng.random() < 0.5:
                    head = 3 - head[::-1]
                read = np.concatenate([head, read[hl:]])
                heads += 1
            f.write(b">rr%d\n%s\n" % (i, ascii_[read].tobytes()))
            total += ln
    return total, heads


def _replay(idx_path: str, fq: str, argv, out: str):
    """One `livefish replay` through the port's CLI in this process, its
    stdout to out: (stdout text, stats) with the replay's own seconds
    (replay_read_until, the index load left out), its ticks (process()
    calls), decisions and fused kernel launches, counted from 0; the
    decisions by the chunks they consumed (by_chunks) and the reads'
    final decisions (unblock, stop receiving, or proceed at max_chunks) by
    the same (final_by_chunks)."""
    import torch
    from cornetto_tpu_torch.kernels.decide import decide_packed
    from cornetto_tpu_torch.livefish import chunks
    st = dict(ticks=0, decisions=0, replay_s=0.0, by_chunks={},
              final_by_chunks={})
    last = chunks.ChunkPolicy().max_chunks       # the CLI's -m default
    saved = {}

    def counted(cls, name):
        fn = saved[(cls, name)] = getattr(cls, name)

        def wrap(self, *a):
            res = fn(self, *a)
            st["ticks"] += name == "process"
            st["decisions"] += len(res)
            for d in res:
                n = d.n_chunks
                st["by_chunks"][n] = st["by_chunks"].get(n, 0) + 1
                if d.action != chunks.PROCEED or n >= last:
                    st["final_by_chunks"][n] = \
                        st["final_by_chunks"].get(n, 0) + 1
            return res
        setattr(cls, name, wrap)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        res = saved["replay"](*a, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        st["replay_s"] += time.perf_counter() - t0
        return res
    for cls in (chunks.ChunkDecisionEngine, chunks.DeviceChunkEngine):
        for name in ("process", "drain"):
            if name in vars(cls):
                counted(cls, name)
    saved["replay"] = chunks.replay_read_until
    chunks.replay_read_until = timed
    decide_packed.launches = 0
    try:
        run_cli_quiet(["livefish", "replay", idx_path, fq] + argv, out,
                      out + ".err")
    finally:
        chunks.replay_read_until = saved.pop("replay")
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)
    st["launches"] = decide_packed.launches
    with open(out) as f:
        return f.read(), st


def _tick_device(state, eng, C: int, chunk_len: int = REPLAY_CHUNK,
                 max_chunks: int = 4):
    """One device tick at C channels on the human-scale index: the fused
    result of chunk_tick_core held equal to the plain step on the gathered
    prefixes, its device time by graph replay (scatter + gather + fused
    kernel, inputs on the card), a whole decide_chunk_tick (the packed
    host upload included) back to back, and the device operations of one
    decide_chunk_tick from torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cornetto_tpu_torch.kernels.decide import decide_packed_ref
    from cornetto_tpu_torch.livefish import decide as td
    rng = np.random.default_rng([C, 18])
    nb, L = chunk_len // 4, chunk_len * max_chunks
    rows = rng.integers(0, 256, size=(C, nb), dtype=np.uint8)
    sc = np.arange(C, dtype=np.int32)
    slots = rng.integers(0, max_chunks, size=C).astype(np.int32)
    dc = rng.permutation(C).astype(np.int32)
    lengths = (chunk_len * rng.integers(1, max_chunks + 1, size=C)
               ).astype(np.int32)
    buf = eng.init_chunk_state(C, chunk_len, max_chunks)
    buf.copy_(torch.randint(0, 256, buf.shape, dtype=torch.uint8,
                            device=buf.device))
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = (dev(rows), dev(sc).long(), dev(slots).long(), dev(dc).long(),
            dev(lengths), state.panel)
    kw = eng._kw(L)
    _, fused = td.chunk_tick_core(buf, state.btable, *args[:5], args[5],
                                  **kw)
    g = buf.index_select(0, args[3]).reshape(C, -1)
    want = decide_packed_ref(state.btable, g, None, state.panel,
                             lengths=args[4], fused=True, **kw)
    err = int((fused.long() - want.long()).abs().max())
    if err or not torch.equal(fused, want):
        fail("replay tick at %d channels disagrees with the plain step" % C)
    ms = graph_ms(lambda: td.chunk_tick_core(buf, state.btable, *args[:5],
                                             args[5], **kw))
    call_ms = cuda_ms(lambda: eng.decide_chunk_tick(buf, rows, sc, slots, dc,
                                                    lengths), 50)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decide_chunk_tick(buf, rows, sc, slots, dc, lengths)[1].cpu()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(err=err, ms=ms, call_ms=call_ms, ops=ops)


def phase_replay(seed: int, work: str, idx_path: str, fq: str):
    """`livefish replay` on the human-scale index through the port's CLI:
    host and device state at 512 and 3000 channels (stdout byte-equal),
    host state on the card against a CORNETTO_FORCE_CPU=1 run on the first
    reads; ticks/s, decisions/s and launches a tick; then the device tick
    in this process (equal to the plain step, timed by graph replay, its
    device operations)."""
    import torch
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.livefish import decide as td
    res = {}
    for cell, C in REPLAY_CELLS:
        outs = {}
        for state in ("host", "device"):
            out, st = _replay(idx_path, fq, ["-c", str(REPLAY_CHUNK),
                                             "-n", str(C), "-b", str(C),
                                             "--state", state],
                              os.path.join(work, "replay_%d_%s.txt"
                                           % (C, state)))
            outs[state] = out
            res[(C, state)] = st
            log("[15 replay] %s, %d channels, --state %s: %d ticks, %d "
                "decisions in %.2f s of replay = %.1f ticks/s, %.0f "
                "decisions/s; %d fused decision launches = %.3f a tick; "
                "report %s"
                % (cell, C, state, st["ticks"], st["decisions"],
                   st["replay_s"], st["ticks"] / st["replay_s"],
                   st["decisions"] / st["replay_s"], st["launches"],
                   st["launches"] / st["ticks"],
                   out.strip().replace("\n", "; ").replace("\t", " ")))
            fin = st["final_by_chunks"]
            later = sum(v for n, v in fin.items() if n > 1)
            st["later_share"] = later / max(sum(fin.values()), 1)
            log("[15 replay] %s, %d channels, --state %s: decisions by "
                "chunks consumed %s; reads' final decisions by chunks "
                "consumed %s: %.2f%% after the first chunk"
                % (cell, C, state, dict(sorted(st["by_chunks"].items())),
                   dict(sorted(fin.items())), 100 * st["later_share"]))
            if not st["launches"] or not st["decisions"] or not later:
                fail("replay at %d channels (%s) launched no fused kernel, "
                     "decided nothing or decided every read on its first "
                     "chunk" % (C, state))
        same = outs["host"] == outs["device"]
        log("[15 replay] %d channels: host and device state stdout "
            "byte-equal: %s" % (C, same))
        if not same or "unblocked\t0\n" in outs["host"]:
            fail("replay at %d channels: the states differ or nothing was "
                 "unblocked" % C)
    head = os.path.join(work, "replay_head.fa")
    with open(fq, "rb") as src, open(head, "wb") as dst:
        for _ in range(2 * REPLAY_CPU_READS):
            dst.write(src.readline())
    argv = ["-c", str(REPLAY_CHUNK), "-n", "64", "-b", "64"]
    card, _ = _replay(idx_path, head, argv,
                      os.path.join(work, "replay_head_card.txt"))
    t0 = time.perf_counter()
    with force_cpu():
        cpu, _ = _replay(idx_path, head, argv,
                         os.path.join(work, "replay_head_cpu.txt"))
    log("[15 replay] first %d reads, 64 channels: the card's stdout "
        "byte-equal to a CORNETTO_FORCE_CPU=1 run's (%.1f s): %s"
        % (REPLAY_CPU_READS, time.perf_counter() - t0, card == cpu))
    if card != cpu:
        fail("replay on the card differs from the CPU run")
    idx, panel, _ = load_index(idx_path)
    eng = td.SingleChipEngine(idx, panel, device="cuda")
    del idx
    for _, C in REPLAY_CELLS:
        t = res[(C, "tick")] = _tick_device(eng.state, eng, C)
        kernels = [o for o in t["ops"] if "emcpy" not in o]
        log("[15 replay] device tick at %d x %d: scatter + gather + fused "
            "kernel %.4f ms by graph replay, max_abs_err=%d against the "
            "plain step; decide_chunk_tick back to back (packed upload "
            "included) %.4f ms; one tick's device operations (profiler): %d "
            "kernels + %d copies: %s"
            % (C, 4 * REPLAY_CHUNK, t["ms"], t["err"], t["call_ms"],
               len(kernels), len(t["ops"]) - len(kernels), t["ops"]))
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- dist

# the two-process layouts of phase 16 decide this many of phase 5's full
# batches; the sp scan is chr1's length at boringbits' default window
DIST_BATCHES = 4
DIST_RANKS = 2
DIST_TIMEOUT_S = 600


def stream_args(pb):
    """(packed, nmask, lengths) of a parsed batch's rows in the form
    `livefish run` passes them (livefish/stream.py): the N bitmap with the
    lengths folded in when the batch has an N, else the lengths unless
    every read is full."""
    import numpy as np
    n = pb.count
    if pb.nmask is None:
        lens = pb.lengths[:n]
        return pb.packed[:n], None, None if (lens == READ_LEN).all() \
            else lens
    nm = pb.nmask[:n].copy()
    pos = np.arange(nm.shape[1] * 8, dtype=np.int32)
    pad = pos[None, :] >= pb.lengths[:n, None]
    nm |= np.packbits(pad, axis=1, bitorder="little")[:, :nm.shape[1]]
    return pb.packed[:n], nm, None


def chr1_depth(seed: int):
    """A seeded depth track of chr1's length (int32, 0..65535)."""
    import numpy as np
    return np.random.default_rng([seed, 21]).integers(
        0, 65536, size=GRCH38[0], dtype=np.int32)


def split_ms(engine, args, n: int = 20):
    """The sharded step on this rank's uploaded rows, n times: (ms a step,
    {stage: ms}) from CUDA events recorded as each stage is issued
    (ShardedEngine.step's mark)."""
    import torch
    stages = {}
    evs = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        evs.append((name, e))
    for _ in range(3):
        engine.step(*args, READ_LEN)
    torch.cuda.synchronize()
    for _ in range(n):
        mark("start")
        engine.step(*args, READ_LEN, mark=mark)
    torch.cuda.synchronize()
    for (_, a), (name, b) in zip(evs, evs[1:]):
        if name != "start":
            stages[name] = stages.get(name, 0.0) + a.elapsed_time(b) / n
    return sum(stages.values()), stages


def votes_work(h, v, btable, two_choice, ep, shard, C):
    """{"bytes", "ops"} of one shard's votes (see bound): the gathered
    hashes and flags, one bucket row a probe of each valid window the
    shard owns, the dense planes written; 8 ops a slot compared."""
    owned = int((v & ((h & (ep - 1)) == shard)).sum())
    probes = 2 if two_choice else 1
    K = btable.shape[1] // 2
    return dict(bytes=h.numel() * 5 + owned * probes * K * 8
                + 9 * h.shape[0] * C * 4,
                ops=owned * probes * K * 8, owned=owned)


def policy_work(b, C):
    """{"bytes", "ops"} of the policy on (9, b, C) planes: the votes plane,
    the best contig's other eight words and panel byte a read, the outputs;
    a compare a vote."""
    return dict(bytes=b * C * 4 + b * (8 * 4 + 1 + 21), ops=b * C)


EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void cornetto_empty_kernel() {}
extern "C" int cornetto_empty(int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cornetto_empty_kernel<<<blocks, 256, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


@functools.lru_cache(maxsize=None)
def _empty_kernel():
    """cornetto_empty(blocks, stream) of EMPTY_CU, built with the kernels'
    nvcc flags into build/smoke/empty/."""
    import ctypes
    from cornetto_tpu_torch.kernels import _build
    out = os.path.join(HERE, "build", "smoke", "empty")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, "empty.cu"), os.path.join(out, "libempty.so")
    with open(src, "w") as f:
        f.write(EMPTY_CU)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).cornetto_empty
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return fn


def launch_floor_ms(blocks: int) -> float:
    """This card's launch floor: the graph-replay time of an empty kernel
    of `blocks` blocks of 256 threads, launched through ctypes as the
    wrappers launch theirs."""
    import torch
    fn = _empty_kernel()

    def launch():
        if fn(blocks, torch.cuda.current_stream().cuda_stream):
            fail("the empty kernel did not launch")
    return graph_ms(launch)


def phase_dist_kernels(seed, work, idx2_path, batch, against, card):
    """The votes and policy kernels against their plain versions on the
    human-scale 2-shard index (ep = 2, shards 0 and 1) at C = 1, 87 and one
    past the shared-memory limit; timed by CUDA-graph replay at the (1, 2) layout's shapes,
    the policy beside an empty kernel of its grid (the launch floor), and
    with ``against`` (a checkout) in turns with that checkout's kernels
    (votes_turns).  Returns (worst error, votes timing, policy timing)."""
    import torch
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.kernels.extract import extract_minima
    from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                                  policy_from_stats_ref,
                                                  shared_limit,
                                                  sharded_votes,
                                                  sharded_votes_ref)
    dev = torch.device("cuda")
    idx, panel, _ = load_index(idx2_path)
    bts = [torch.from_numpy(idx.btable[s]).to(dev) for s in range(2)]
    C0 = panel.shape[0]
    pk, nm, ln = (None if a is None else torch.from_numpy(a).to(dev)
                  for a in batch)
    h, v = extract_minima(pk, nm, READ_LEN, K, W, lengths=ln)
    worst, tv, tp = 0, None, None
    for C in (1, C0, shared_limit() + 1):
        stats = 0
        for s in range(2):
            args = (h, v, bts[s], idx.bucket_shift, idx.two_choice, 2, s, C)
            got = sharded_votes(*args, parts=2)
            torch.cuda.synchronize()
            want = sharded_votes_ref(*args, parts=2)
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err, 0 if torch.equal(got, want) else 1)
            stats = stats + got.transpose(0, 1).reshape(9, -1, C)
            if C == C0 and s == 0:
                tv = dict(votes_work(h, v, bts[s], idx.two_choice, 2, s, C),
                          ms=graph_ms(lambda: sharded_votes(*args, parts=2)),
                          plain_ms=cuda_ms(lambda: sharded_votes_ref(
                              *args, parts=2), 5),
                          library_ms=None)
        pn = torch.zeros((C, panel.shape[1]), dtype=torch.bool, device=dev)
        pn[:min(C, C0)] = torch.from_numpy(panel[:min(C, C0)]).to(dev)
        outs = policy_from_stats(stats, pn, 3, 1000)
        torch.cuda.synchronize()
        for g, r in zip(outs, policy_from_stats_ref(stats, pn, 3, 1000)):
            err = int((g.long() - r.long()).abs().max())
            worst = max(worst, err, 0 if torch.equal(g, r) else 1)
        if C == C0:
            half = stats[:, :stats.shape[1] // 2].contiguous()
            tp = dict(policy_work(half.shape[1], C),
                      ms=graph_ms(lambda: policy_from_stats(half, pn, 3,
                                                            1000)),
                      plain_ms=cuda_ms(lambda: policy_from_stats_ref(
                          half, pn, 3, 1000), 5),
                      library_ms=None,
                      # the policy's grid: a warp a read
                      floor_ms=launch_floor_ms(-(-half.shape[1] * 32 // 256)))
            panel0 = pn
        log("[16 dist] votes + policy kernels, ep = 2, shards 0 and 1, (%d, "
            "%d) hashes, C = %d (%s): max_abs_err=%d so far"
            % (h.shape[0], h.shape[1], C, "shared memory"
               if C <= shared_limit() else "global atomics", worst))
    del bts, idx
    torch.cuda.empty_cache()
    if worst:
        fail("the votes or policy kernel disagrees with its plain version")
    if against:
        votes_turns(work, idx2_path, h, v, panel0, against, card)
    return worst, tv, tp


def votes_turns(work, idx2_path, h, v, panel, other, card):
    """This checkout's votes and policy kernels timed in turns with those
    of another checkout ``other`` at the (1, 2) layout's shapes: four
    processes, other, this, this, other, each ``chip_smoke.py --votes-time
    CHECKOUT`` on the same hashes, 2-shard index and panel; fails unless
    every run's outputs are the same."""
    import numpy as np
    np.savez(os.path.join(work, "votes_turns.npz"), h=h.cpu().numpy(),
             v=v.cpu().numpy(), panel=panel.cpu().numpy())
    runs = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--votes-time",
             os.path.abspath(root), "--dist-work", work, "--dist-index2",
             idx2_path], cwd=HERE, capture_output=True, text=True,
            timeout=DIST_TIMEOUT_S)
        if proc.returncode != 0:
            fail("--votes-time %s exited %d:\n%s"
                 % (root, proc.returncode, proc.stdout + proc.stderr))
        runs.append(json.loads(proc.stdout.splitlines()[-1]))
    for what in ("votes_0_ms", "votes_1_ms", "policy_ms"):
        log("[16 dist] in turns, %s (other: %s): other %.4f / %.4f ms, this "
            "%.4f / %.4f ms by graph replay (%s)"
            % (what[:-3], other, runs[0][what], runs[3][what],
               runs[1][what], runs[2][what], card))
    if len({r["digest"] for r in runs}) != 1:
        fail("the two checkouts' votes or policy outputs differ")


def votes_time(args):
    """One process of votes_turns (chip_smoke.py --votes-time CHECKOUT
    ...): that checkout's sharded_votes on both shards (parts = 2) and
    policy_from_stats on the first half of their summed planes, timed by
    graph replay; prints one JSON line of the times and a digest of the
    outputs."""
    import hashlib
    import numpy as np
    import torch
    import cornetto_tpu_torch
    root = os.path.abspath(args.votes_time)
    if not os.path.abspath(cornetto_tpu_torch.__file__).startswith(
            root + os.sep):
        fail("cornetto_tpu_torch came from %s, not %s"
             % (cornetto_tpu_torch.__file__, root))
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                                  sharded_votes)
    dev = torch.device("cuda")
    d = np.load(os.path.join(args.dist_work, "votes_turns.npz"))
    h, v, pn = (torch.from_numpy(d[k]).to(dev) for k in ("h", "v", "panel"))
    idx, _, _ = load_index(args.dist_index2)
    C = pn.shape[0]
    digest, out, stats = hashlib.sha256(), {}, 0
    for s in range(2):
        a = (h, v, torch.from_numpy(idx.btable[s]).to(dev), idx.bucket_shift,
             idx.two_choice, 2, s, C)
        got = sharded_votes(*a, parts=2)
        digest.update(got.cpu().numpy().tobytes())
        stats = stats + got.transpose(0, 1).reshape(9, -1, C)
        out["votes_%d_ms" % s] = graph_ms(lambda: sharded_votes(*a, parts=2))
    half = stats[:, :stats.shape[1] // 2].contiguous()
    for o in policy_from_stats(half, pn, 3, 1000):
        digest.update(o.cpu().numpy().tobytes())
    out["policy_ms"] = graph_ms(lambda: policy_from_stats(half, pn, 3, 1000))
    out["digest"] = digest.hexdigest()
    print(json.dumps(out))


def phase_dist(seed: int, work: str, idx_path: str, idx2_path: str,
               fq: str, card: str, against=None):
    """The multi-device runtime (cornetto_tpu_torch/dist, the sharded
    engine) on the one card: NCCL at world size 1 over phase 5's batches,
    bit-equal to SingleChipEngine; two gloo processes on the card at (1, 2)
    on the 2-shard index (held to the plain looped-shard oracle) and (2, 1)
    on the 1-shard index (held to SingleChipEngine), and an sp scan of
    chr1's length held to the single-device window stats; the votes and
    policy kernels alone.  Returns the kernel rows' timings and launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from cornetto_tpu_torch.dist import multihost
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.kernels.decide import decide_packed
    from cornetto_tpu_torch.kernels.extract import extract_minima
    from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                                  sharded_votes)
    from cornetto_tpu_torch.kernels.window_sum import window_stats
    from cornetto_tpu_torch.livefish import decide as td
    from cornetto_tpu_torch.native.fastq_pack import iter_packed_batches

    # [a] NCCL, world size 1, (dp, ep) = (1, 1) on the 1-shard index
    rdv = os.path.join(work, "rdv_nccl")
    if os.path.exists(rdv):
        os.remove(rdv)
    t0 = time.perf_counter()
    if not multihost.initialize(init_method="file://" + rdv, world_size=1,
                                rank=0):
        fail("multihost.initialize started no process group")
    backend = dist.get_backend()
    if backend != "nccl":
        fail("the card's process group runs %s, not nccl" % backend)
    idx, panel, _ = load_index(idx_path)
    eng1 = td.SingleChipEngine(idx, panel, device="cuda")
    engS = td.make_sharded_engine(make_mesh({"dp": 1, "ep": 1}), idx, panel)
    del idx
    batches = [stream_args(pb)
               for pb in iter_packed_batches(fq, BATCH, READ_LEN)]
    log("[16 dist] NCCL process group of 1 rank, mesh (1, 1), index and "
        "engines up in %.1f s; %d batches" % (time.perf_counter() - t0,
                                              len(batches)))
    for fn in (extract_minima, sharded_votes, policy_from_stats,
               decide_packed):
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [engS.decide_packed(pk, nm, READ_LEN, lengths=ln)
            for pk, nm, ln in batches]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(extract=extract_minima.launches,
                    votes=sharded_votes.launches,
                    policy=policy_from_stats.launches,
                    decide=decide_packed.launches)
    n = len(batches)
    # ep = 1: the fused step, one launch a batch, no planes
    if launches != dict(extract=0, votes=0, policy=0, decide=n):
        fail("the sharded engine's launches over %d batches: %s"
             % (n, launches))
    single, bad = [], 0
    for (pk, nm, ln), got in zip(batches, outs):
        want = eng1.decide_packed(pk, nm, READ_LEN, lengths=ln)
        bad += sum(not (g.dtype == w.dtype and torch.equal(g, w))
                   for g, w in zip(got, want))
        if len(single) < DIST_BATCHES:
            single.append([w.cpu().numpy() for w in want])
    log("[16 dist] NCCL (1, 1): %d batches (%d reads) in %.3f s, launches "
        "%s; all six outputs bit-equal to SingleChipEngine.decide_packed: %s"
        % (n, sum(len(b[0]) for b in batches), run_s, launches, bad == 0))
    if bad:
        fail("the sharded engine at (1, 1) differs from SingleChipEngine in "
             "%d outputs" % bad)
    full = [b for b in batches if len(b[0]) == BATCH][:DIST_BATCHES]
    args = engS.upload(*full[0])
    step_ms, split = split_ms(engS, args)
    call_ms = cuda_ms(lambda: engS.decide_packed(*full[0][:2], READ_LEN,
                                                 lengths=full[0][2]), 20)
    one_ms = cuda_ms(lambda: eng1.decide_packed(*full[0][:2], READ_LEN,
                                                lengths=full[0][2]), 20)
    timing = {"(1, 1) nccl": dict(step_ms=step_ms, call_ms=call_ms,
                                  split=split)}
    log("[16 dist] NCCL (1, 1), per 4096-read batch: step %.4f ms = %s; a "
        "decide_packed call (upload included) %.4f ms back to back; "
        "SingleChipEngine.decide_packed (one launch) %.4f ms (%s)"
        % (step_ms, " + ".join("%s %.4f" % kv for kv in split.items()),
           call_ms, one_ms, card))
    del eng1, engS, outs
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # [b] two gloo processes on the one card
    np.savez(os.path.join(work, "dist_batches.npz"), **{
        "%d/%s" % (i, k): a for i, b in enumerate(full)
        for k, a in zip(("packed", "nmask", "lengths"), b) if a is not None})
    rdv = os.path.join(work, "rdv_gloo")
    if os.path.exists(rdv):
        os.remove(rdv)
    t0 = time.perf_counter()
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--dist-rank", str(r), "--dist-work", work, "--dist-index",
         idx_path, "--dist-index2", idx2_path], env=env, cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(DIST_RANKS)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=DIST_TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            log("[16 dist] rank %d: %s" % (r, line))
        if p.returncode != 0:
            fail("gloo rank %d exited %d" % (r, p.returncode))
    res = [dict(np.load(os.path.join(work, "dist_r%d.npz" % r)))
           for r in range(DIST_RANKS)]
    log("[16 dist] two gloo processes on the card: %.1f s" % (
        time.perf_counter() - t0))
    bad = agree = rows = 0
    for i in range(len(full)):
        for r in range(DIST_RANKS):
            for j in range(6):
                ep2 = res[r]["ep2/%d/%d" % (i, j)]
                oracle = res[0]["oracle/%d/%d" % (i, j)]
                dp2 = res[r]["dp2/%d/%d" % (i, j)]
                bad += not (ep2.dtype == oracle.dtype
                            and np.array_equal(ep2, oracle))
                bad += not (dp2.dtype == single[i][j].dtype
                            and np.array_equal(dp2, single[i][j]))
        same = np.ones(BATCH, dtype=bool)
        for j in range(6):
            same &= res[0]["ep2/%d/%d" % (i, j)] == single[i][j]
        agree += int(same.sum())
        rows += BATCH
    log("[16 dist] gloo (1, 2) on the 2-shard index: all six outputs of both "
        "ranks bit-equal to the plain looped-shard oracle on %d batches; "
        "(2, 1) on the 1-shard index bit-equal to SingleChipEngine: %s; "
        "(1, 2) rows whose six outputs equal the 1-shard engine's: %d of %d "
        "(%.4f%%)" % (len(full), bad == 0, agree, rows, 100 * agree / rows))
    if bad:
        fail("the two-process layouts differ from their oracles in %d "
             "outputs" % bad)
    ckpt = {k: max(float(res[r]["ckpt/" + k]) for r in range(DIST_RANKS))
            for k in ("save_s", "load_s")}
    ckpt["bytes"] = int(res[0]["ckpt/bytes"])
    ok = all(bool(res[r]["ckpt/" + k]) for r in range(DIST_RANKS)
             for k in ("same", "rows"))
    log("[16 dist] (phase 18's recovery check) save_sharded of each gloo "
        "rank's (1, 2) engine state (%d bytes on rank 0: its table shard "
        "and the panel) %.2f s, load_sharded into fresh tensors on the card "
        "%.2f s (the slower rank's); state bit-equal and the reloaded "
        "engine's rows equal to the first run's on both ranks: %s (%s)"
        % (ckpt["bytes"], ckpt["save_s"], ckpt["load_s"], ok, card))
    if not ok:
        fail("save_sharded / load_sharded did not give the (1, 2) engine "
             "its state back")
    depth = chr1_depth(seed)
    t0 = time.perf_counter()
    st0, end0, m0, _ = window_stats(depth, depth, WIN, INC)
    one_s = time.perf_counter() - t0
    same = all(np.array_equal(res[r]["sp/" + k], a) for r in range(2)
               for k, a in (("st", st0), ("end", end0), ("means", m0)))
    log("[16 dist] sp scan, 2 ranks over gloo, chr1 (%d) W=%d S=%d: %d "
        "windows equal to the single-device window_stats: %s; %.3f s a rank "
        "(%.3f s single-device, two tracks)"
        % (GRCH38[0], WIN, INC, len(m0), same, float(res[0]["sp/s"]),
           one_s))
    if not same:
        fail("the sp scan differs from the single-device window stats")
    for name in ("ep2", "dp2"):
        split = {k.split("/")[-1]: float(res[0][k]) for k in res[0]
                 if k.startswith("split/%s/" % name)}
        timing["%s gloo" % name] = dict(
            step_ms=sum(split.values()), call_ms=float(res[0]["call/" + name]),
            split=split)
        log("[16 dist] gloo %s, per 4096-read batch, rank 0: step %.4f ms = "
            "%s; a decide_packed call (upload included) %.4f ms back to back "
            "(two processes on one card; no gloo figure stands for NCCL; "
            "%s)" % ("(1, 2)" if name == "ep2" else "(2, 1)",
                     sum(split.values()),
                     " + ".join("%s %.4f" % kv for kv in split.items()),
                     float(res[0]["call/" + name]), card))
    with open(os.path.join(work, "gloo_cuda_r0.json")) as f:
        log("[16 dist] gloo asked to take CUDA tensors (the port's "
            "collectives stage them through pinned host memory instead; "
            "send/recv not asked): %s" % f.read())

    # the (1, 2) layout's extraction, votes and policy launches (the ep > 1
    # route), both ranks, over the first run of its batches
    ep2_launches = {k: sum(int(res[r]["launches/" + k])
                           for r in range(DIST_RANKS))
                    for k in ("extract", "votes", "policy", "decide")}
    log("[16 dist] gloo (1, 2), both ranks, %d batches: launches %s"
        % (len(full), ep2_launches))
    each = DIST_RANKS * len(full)
    if ep2_launches != dict(extract=each, votes=each, policy=each,
                            decide=0):
        fail("the (1, 2) layout's votes and policy launches: %s"
             % ep2_launches)
    launches.update(votes=ep2_launches["votes"],
                    policy=ep2_launches["policy"])

    # [c] the kernels alone
    err, tv, tp = phase_dist_kernels(seed, work, idx2_path, full[0], against,
                                     card)
    for name, t in (("votes", tv), ("policy", tp)):
        b_ms, b_by = bound(t)
        log("[16 dist] %s kernel at the (1, 2) layout's shapes: %.4f ms by "
            "graph replay, bound %.4f ms (%s, %d bytes) = %.1f%% of it "
            "reached, plain %.4f ms (%s)"
            % (name, t["ms"], b_ms, b_by, t["bytes"], 100 * b_ms / t["ms"],
               t["plain_ms"], card))
    log("[16 dist] launch floor: an empty kernel of the policy's grid, "
        "launched through ctypes, %.4f ms by graph replay (%s)"
        % (tp["floor_ms"], card))
    return dict(launches=launches, err=err, votes=tv, policy=tp,
                timing=timing, ckpt=ckpt)


def sharded_round_trip(eng, batches, work: str, out):
    """On every gloo rank: the (1, 2) engine's state (this rank's table
    shard and the panel) through dist.checkpoint.save_sharded and
    load_sharded into -1-filled tensors on the card, timed; the engine on
    the reloaded state decides the batches again.  Returns the npz
    entries: seconds, bytes, and whether the state and the rows came back
    bit for bit (against ``out``'s first decisions)."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from cornetto_tpu_torch.dist.checkpoint import load_sharded, save_sharded
    path = os.path.join(work, "sharded_ep2")
    tree = {"btable": eng.state.btable, "panel": eng.state.panel}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    save_sharded(path, tree)
    dist.barrier()
    save_s = time.perf_counter() - t0
    fresh = {k: torch.full_like(v, -1) for k, v in tree.items()}
    dist.barrier()
    t0 = time.perf_counter()
    back = load_sharded(path, fresh)
    torch.cuda.synchronize()
    dist.barrier()
    load_s = time.perf_counter() - t0
    same = all(back[k] is fresh[k] and torch.equal(back[k], v)
               for k, v in tree.items())
    nbytes = sum(v.numel() * v.element_size() for v in tree.values())
    del tree
    eng.state = dataclasses.replace(eng.state, **back)
    rows = all(np.array_equal(o.cpu().numpy(), out["ep2/%d/%d" % (i, j)])
               for i, b in enumerate(batches)
               for j, o in enumerate(eng.decide_packed(
                   b[0], b[1], READ_LEN, lengths=b[2])))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(path)
    return {"ckpt/save_s": save_s, "ckpt/load_s": load_s,
            "ckpt/bytes": nbytes, "ckpt/same": same, "ckpt/rows": rows}


def dist_worker(args):
    """One of phase 16's two gloo ranks on the card (chip_smoke.py
    --dist-rank R ...): the (1, 2) layout on the 2-shard index with rank
    0 computing the plain looped-shard oracle, the (2, 1) layout on the
    1-shard index, the sp scan of chr1's length, the step's split, and
    which collectives gloo refuses on CUDA tensors; writes
    <work>/dist_r<R>.npz and <work>/gloo_cuda_r<R>.json."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from cornetto_tpu_torch.dist import multihost
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.dist.mesh import make_mesh
    from cornetto_tpu_torch.dist.scan import sharded_window_stats
    from cornetto_tpu_torch.kernels.decide import (_lookup_votes,
                                                   _policy_from_stats)
    from cornetto_tpu_torch.kernels.extract import extract_minima_ref
    from cornetto_tpu_torch.kernels.decide import decide_packed
    from cornetto_tpu_torch.kernels.extract import extract_minima
    from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                                  sharded_votes)
    from cornetto_tpu_torch.livefish import decide as td
    rank, work = args.dist_rank, args.dist_work
    multihost.initialize(
        init_method="file://" + os.path.join(work, "rdv_gloo"),
        world_size=DIST_RANKS, rank=rank, backend="gloo",
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S - 60))
    dev = torch.device("cuda", torch.cuda.current_device())
    data = np.load(os.path.join(work, "dist_batches.npz"))
    batches = []
    for i in range(DIST_BATCHES):
        if "%d/packed" % i in data.files:
            batches.append(tuple(
                data["%d/%s" % (i, k)] if "%d/%s" % (i, k) in data.files
                else None for k in ("packed", "nmask", "lengths")))
    out = {}
    for name, (dp, ep), path in (("ep2", (1, 2), args.dist_index2),
                                 ("dp2", (2, 1), args.dist_index)):
        mesh = make_mesh({"dp": dp, "ep": ep})
        idx, panel, _ = load_index(path)
        eng = td.make_sharded_engine(mesh, idx, panel)
        kernels = (extract_minima, sharded_votes, policy_from_stats,
                   decide_packed)
        for fn in kernels:
            fn.launches = 0
        for i, b in enumerate(batches):
            for j, o in enumerate(eng.decide_packed(b[0], b[1], READ_LEN,
                                                    lengths=b[2])):
                out["%s/%d/%d" % (name, i, j)] = o.cpu().numpy()
        if name == "ep2":
            for key, fn in zip(("extract", "votes", "policy", "decide"),
                               kernels):
                out["launches/" + key] = fn.launches
            out.update(sharded_round_trip(eng, batches, work, out))
        _, split = split_ms(eng, eng.upload(*batches[0]), 10)
        for k, ms in split.items():
            out["split/%s/%s" % (name, k)] = ms
        out["call/" + name] = cuda_ms(lambda: eng.decide_packed(
            batches[0][0], batches[0][1], READ_LEN, lengths=batches[0][2]),
            10, warmup=2)
        if ep == 2 and rank == 0:
            # the plain looped-shard oracle: every shard's owner-filtered
            # plain lookup on the card, summed, then the plain policy
            pn = torch.from_numpy(panel).to(dev)
            for i, b in enumerate(batches):
                pk, nm, ln = (None if a is None else torch.from_numpy(a).to(
                    dev) for a in b)
                h, v = extract_minima_ref(pk, nm, READ_LEN, K, W,
                                          lengths=ln)
                planes = 0
                for s in range(ep):
                    bt = torch.from_numpy(idx.btable[s]).to(dev)
                    planes = planes + torch.stack(_lookup_votes(
                        bt, idx.bucket_shift, h, v, pn.shape[0],
                        idx.two_choice, owner=(ep, s)))
                    del bt
                for j, o in enumerate(_policy_from_stats(planes, pn, 3,
                                                         1000)):
                    out["oracle/%d/%d" % (i, j)] = o.cpu().numpy()
        del eng, idx
        torch.cuda.empty_cache()
        dist.barrier()
    depth = chr1_depth(args.seed)
    t0 = time.perf_counter()
    res = sharded_window_stats(make_mesh({"sp": DIST_RANKS}), depth,
                               len(depth), WIN, INC)
    out["sp/s"] = time.perf_counter() - t0
    for k, a in zip(("st", "end", "means"), res):
        out["sp/" + k] = a
    np.savez(os.path.join(work, "dist_r%d.npz" % rank), **out)
    # which collectives gloo takes CUDA tensors for, and with what result,
    # asked of gloo itself once the work is done (dist/collectives.py
    # never passes it one)
    x = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(2 * DIST_RANKS, dtype=torch.int32, device=dev)
    probes = (
        ("all_gather_into_tensor",
         torch.empty(4 * DIST_RANKS, dtype=torch.int32, device=dev),
         lambda o: dist.all_gather_into_tensor(o, x),
         torch.arange(1, DIST_RANKS + 1).repeat_interleave(4)),
        ("reduce_scatter_tensor",
         torch.empty(2, dtype=torch.int32, device=dev),
         lambda o: dist.reduce_scatter_tensor(o, ones),
         torch.full((2,), DIST_RANKS)))
    refused = {}
    for op, o, call, want in probes:
        try:
            call(o)
            torch.cuda.synchronize()
            refused[op] = "took it, %s values" % (
                "right" if o.cpu().tolist() == want.tolist() else "WRONG")
        except Exception as e:  # a report of what gloo takes, no fallback
            refused[op] = "refused: %s: %s" % (
                type(e).__name__, str(e).splitlines()[0][:120])
    with open(os.path.join(work, "gloo_cuda_r%d.json" % rank), "w") as f:
        json.dump(refused, f)
    dist.destroy_process_group()
    print("rank %d of %d: done" % (rank, DIST_RANKS))


# ---------------------------------------------------------------- host tools

# example.bam's reads lie on chr22 (19,979,850-20,032,355); depth runs over
# BED regions, never the whole genome (its references are GRCh38's: a
# per-base table of every reference would be ~60 GB)
DEPTH_REGIONS = [("chr22", 19_979_000, 20_040_000), ("chr22", 0, 2_000),
                 ("chr21", 500, 900)]


def _in_dir(path: str, inputs):
    """A fresh directory holding links to the inputs ({name: source})."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    for name, src in inputs.items():
        os.symlink(src, os.path.join(path, name))
    return path


def _cli_in(path: str, argv, rc_want: int = 0):
    """run_cli_quiet with path as the working directory: (stdout bytes,
    stderr bytes before the CLI's footer)."""
    out, err = path + ".stdout", path + ".stderr"
    with contextlib.chdir(path):
        run_cli_quiet(argv, out, err, rc_want)
    with open(out, "rb") as fo, open(err, "rb") as fe:
        o, e = fo.read(), fe.read()
    return o, e[:e.rfind(b"[main] Version:")]


def _pipe_inputs(path: str) -> str:
    """test_data/gen_synth_pipe.py's inputs (the telo, create and recreate
    goldens'): the assembly, lowQ BED, haplotype PAFs and 1-bp bedgraphs,
    these written here as the generator's DataFrame.to_csv writes them
    (the card's machine has no pandas)."""
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "test_data"))
    import gen_synth_pipe as gsp
    stamp = os.path.join(path, ".done-" + gsp.VERSION)
    if not os.path.exists(stamp):
        os.makedirs(path, exist_ok=True)
        gsp.OUT = path
        rng = np.random.default_rng(20260819)            # as gsp.ensure()
        seqs = gsp.gen_fasta(rng)
        with open(os.path.join(path, "pasm.cov-total.bg"), "w") as ft, \
                open(os.path.join(path, "pasm.cov-mq20.bg"), "w") as fm:
            for name, ln in gsp.CONTIGS:
                depth, mq = gsp._depth_profile(rng, name, ln)
                head = ["%s\t%d\t%d\t" % (name, i, i + 1)
                        for i in range(ln)]
                for f, col in ((ft, depth), (fm, mq)):
                    f.write("".join([h + "%d\n" % v for h, v in
                                     zip(head, col.tolist())]))
        gsp.gen_lowq(None)
        gsp.gen_haps(seqs)
        open(stamp, "w").close()
    return path


def _depth_rows(out: bytes):
    return [int(r.rsplit(b"\t", 1)[1]) for r in out.splitlines()]


def phase_host_tools(seed: int, work: str, draft: str):
    """Phase 17: telostats, recreate-panel, sdust's default-backend
    routing and the host tools through the port's CLI on the card."""
    import numpy as np
    import torch
    from cornetto_tpu_torch.io.bam import BamFile
    from cornetto_tpu_torch.kernels.sdust import sdust_dp
    from cornetto_tpu_torch.kernels.telo import telo_match_mask
    root = os.path.join(work, "host")
    os.makedirs(root, exist_ok=True)
    synth = os.path.join(HERE, "test_data", "synth")
    gold = os.path.join(HERE, "test_data", "golden")
    pgold = os.path.join(gold, "pipelines")
    pipe = _pipe_inputs(os.path.join(work, "synth_pipe"))
    asm = os.path.join(synth, "asm.fasta")
    res = {}

    def golden(path, name):
        with open(os.path.join(path, name), "rb") as f:
            return f.read()

    # telostats on the two pipeline goldens: stdout and the ends BED
    for sub, fa in (("telo", os.path.join(pipe, "pasm.fasta")),
                    ("telosmall", asm)):
        local = os.path.basename(fa)
        d = _in_dir(os.path.join(root, "telostats_" + sub), {local: fa})
        telo_match_mask.launches = 0
        out, _ = _cli_in(d, ["telostats", local])
        launches = telo_match_mask.launches
        bed = local.rsplit(".", 1)[0] + ".windows.0.4.50kb.ends.bed"
        same = out == golden(os.path.join(pgold, sub), "telostats.stdout") \
            and tree_bytes(d)[bed] == golden(os.path.join(pgold, sub), bed)
        log("[17 host tools] telostats %s: stdout and %s byte-equal to "
            "golden/pipelines/%s: %s, telomere-mask launches %d"
            % (local, bed, sub, same, launches))
        if not same or launches == 0:
            fail("telostats %s differs from its golden or launched no mask "
                 "kernel" % local)

    # telostats on phase 13's chr1-chr3 cut: the card against the CPU
    walls = {}
    trees = {}
    for where in ("card", "cpu"):
        d = _in_dir(os.path.join(root, "telostats_cut_" + where),
                    {"draft.fasta": draft})
        telo_match_mask.launches = 0
        t0 = time.perf_counter()
        if where == "cpu":
            with force_cpu():
                _cli_in(d, ["telostats", "draft.fasta"])
        else:
            _cli_in(d, ["telostats", "draft.fasta"])
            torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0
        walls[where + "_launches"] = telo_match_mask.launches
        with open(d + ".stdout", "rb") as f:
            trees[where] = dict(tree_bytes(d), stdout=f.read())
    same = trees["card"] == trees["cpu"]
    ends = trees["card"]["draft.windows.0.4.50kb.ends.bed"].count(b"\n")
    log("[17 host tools] telostats on the chr1-chr3 cut: card %.2f s (%d "
        "telomere-mask launches), CORNETTO_FORCE_CPU=1 %.2f s (%d); stdout "
        "and all %d files byte-equal: %s; %d telomere regions at contig ends"
        % (walls["card"], walls["card_launches"], walls["cpu"],
           walls["cpu_launches"], len(trees["card"]) - 1, same, ends))
    if not same or walls["card_launches"] != 6 or walls["cpu_launches"] \
            or not ends:
        fail("telostats on the cut: the card's output differs from the "
             "CPU's, or the launches are not one a contig and strand")
    # where the card run's time goes past telofind (phase 13 times it): a
    # second FASTA read (telostats reads the lengths apart) and telowin on
    # the run's telomere file
    from cornetto_tpu_torch.io.fasta import read_fastx
    d = os.path.join(root, "telostats_cut_card")
    t0 = time.perf_counter()
    n_bp = sum(len(rec.seq) for rec in read_fastx(draft))
    walls["fasta_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli_quiet(["telowin", os.path.join(d, "tmp_draft_telostats",
                                           "draft.telomere"), "99.9", "0.4"],
                  d + ".telowin", d + ".telowin.err")
    walls["telowin"] = time.perf_counter() - t0
    with open(os.path.join(d, "tmp_draft_telostats", "draft.telomere"),
              "rb") as f:
        walls["telomere_rows"] = sum(1 for _ in f)
    log("[17 host tools] telostats split, alone: FASTA read of the %d bp "
        "%.2f s, telowin on its %d telomere rows %.2f s"
        % (n_bp, walls["fasta_read"], walls["telomere_rows"],
           walls["telowin"]))
    res["telostats_cut"] = walls

    # recreate-panel
    d = _in_dir(os.path.join(root, "recreate"), {
        f: os.path.join(pipe, f) for f in ("pasm.fasta",
                                           "pasm.bp.p_ctg.lowQ.bed")})
    _cli_in(d, ["recreate-panel", "pasm.fasta"])
    tree = tree_bytes(d)
    same = all(tree.get(f) == golden(os.path.join(pgold, "recreate"), f)
               for f in ("pasm.boringbits.bed", "pasm.boringbits.txt"))
    log("[17 host tools] recreate-panel pasm.fasta: pasm.boringbits.{bed,"
        "txt} byte-equal to golden/pipelines/recreate: %s" % same)
    if not same:
        fail("recreate-panel differs from its golden")

    # sdust's default backend outside the device DP's range is the host
    # DP; an explicit --backend device still refuses
    d = _in_dir(os.path.join(root, "sdust"), {"asm.fasta": asm})
    for opt in (["-w", "67"], ["-t", "4"]):
        sdust_dp.launches = 0
        dflt, _ = _cli_in(d, ["sdust"] + opt + ["asm.fasta"])
        launches = sdust_dp.launches
        host, _ = _cli_in(d, ["sdust"] + opt + ["--backend", "host",
                                                "asm.fasta"])
        log("[17 host tools] sdust %s (default backend): %d rows, "
            "byte-equal to --backend host: %s, SDUST launches %d"
            % (" ".join(opt), dflt.count(b"\n"), dflt == host, launches))
        if dflt != host or not dflt or launches:
            fail("sdust %s: the default backend differs from the host DP"
                 % " ".join(opt))
    out, err = _cli_in(d, ["sdust", "-w", "67", "--backend", "device",
                           "asm.fasta"], rc_want=1)
    log("[17 host tools] sdust -w 67 --backend device: exit 1, %r"
        % err.decode().strip()[:80])
    if out or b"W=67 is outside" not in err:
        fail("sdust -w 67 --backend device did not refuse")

    # the host tools' goldens: (name, argv, inputs, stdout golden, stderr
    # golden, {written file: golden}, exit code)
    asmstats_in = {f: os.path.join(gold, f) for f in (
        "fixasm_fixed.paf", "telo_fixed.bed", "report_fixed.tsv",
        "order.fasta", "trim_in.paf", "telo.bed")}
    asmstats = ["asmstats", "fixasm_fixed.paf", "telo_fixed.bed", "-r",
                "report_fixed.tsv"]
    fix_in = {"asm.fasta": asm,
              "asm_to_ref.paf": os.path.join(synth, "asm_to_ref.paf"),
              "trim_in.paf": os.path.join(gold, "trim_in.paf")}
    cases = [
        ("fa2bed", ["fa2bed", "asm.fasta"], {"asm.fasta": asm},
         "fa2bed.txt", None, {}, 0),
        ("seq_30k", ["seq", "reads.fastq"],
         {"reads.fastq": os.path.join(synth, "reads.fastq")},
         "seq_30k.txt", "seq_30k.stderr", {}, 0),
        ("seq_1k", ["seq", "-m", "1000", "reads.fastq"],
         {"reads.fastq": os.path.join(synth, "reads.fastq")},
         "seq_1k.txt", "seq_1k.stderr", {}, 0),
        ("telocontigs", ["telocontigs", "asm.fasta", "telo.bed"],
         {"asm.fasta": asm, "telo.bed": os.path.join(gold, "telo.bed")},
         "telocontigs.txt", None, {}, 0),
        ("nx", ["nx", "asm.fasta"], {"asm.fasta": asm}, "nx.txt", None, {},
         0),
        ("ngx", ["nx", "-g", "200K", "asm.fasta"], {"asm.fasta": asm},
         "ngx.txt", None, {}, 0),
        ("report", ["report", "asm.fasta", "asm.fasta"], {"asm.fasta": asm},
         "report.txt", None, {}, 0),
        ("asmstats", asmstats, asmstats_in, "asmstats.txt", None, {}, 0),
        ("asmstats_human1", asmstats + ["-s", "human1"], asmstats_in,
         "asmstats_human1.txt", None, {}, 0),
        ("asmstats_human2", asmstats + ["-s", "human2"], asmstats_in,
         "asmstats_human2.txt", None, {}, 0),
        ("asmstats_fastaorder", asmstats + ["-s", "order.fasta"],
         asmstats_in, "asmstats_fastaorder.txt", None, {}, 0),
        # the reference stops mid-report here: the same partial output
        ("asmstats_trim", ["asmstats", "trim_in.paf", "telo.bed", "-r",
                           "report_fixed.tsv", "--trim-pat-mat"],
         asmstats_in, "asmstats_trim.txt", None, {}, 1),
        ("fixasm", ["fixasm", "asm.fasta", "asm_to_ref.paf", "-m",
                    "missing.txt", "-r", "report.tsv", "-w", "fixed.paf"],
         fix_in, "fixasm_fixed.fasta", "fixasm.stderr",
         {"missing.txt": "fixasm_missing.txt",
          "report.tsv": "fixasm_report.tsv",
          "fixed.paf": "fixasm_fixed.paf"}, 0),
        ("fixasm_trim", ["fixasm", "asm.fasta", "trim_in.paf", "-r",
                         "r.tsv", "--trim-pat-mat"], fix_in,
         "trim_fixed.fasta", None, {"r.tsv": "trim_report.tsv"}, 0)]
    for name, argv, inputs, gout, gerr, gfiles, rc in cases:
        d = _in_dir(os.path.join(root, name), inputs)
        out, err = _cli_in(d, argv, rc)
        want = golden(gold, gout)
        if name == "report":
            # each row starts with the assembly's path as given
            want = re.sub(rb"(?m)^[^#\t][^\t]*\t", b"asm.fasta\t", want)
        same = out == want and (gerr is None or err == golden(gold, gerr)) \
            and tree_bytes(d) == {k: golden(gold, v) for k, v in gfiles.items()}
        log("[17 host tools] %s: byte-equal to golden/%s%s%s: %s"
            % (" ".join(argv), gout, " and " + gerr if gerr else "",
               "".join(" and " + v for v in gfiles.values()), same))
        if not same:
            fail("%s differs from its golden" % name)

    # depth on example.bam over DEPTH_REGIONS, against the CIGARs' tally
    bam_path = os.path.join(HERE, "test_data", "example.bam")
    alns = [a for a in BamFile(bam_path).alignments()
            if not (a.flag & 0x704)]
    with open(os.path.join(root, "regions.bed"), "w") as f:
        f.write("".join("%s\t%d\t%d\n" % r for r in DEPTH_REGIONS))
    bam_in = {"example.bam": bam_path,
              "example.bam.bai": bam_path + ".bai",
              "regions.bed": os.path.join(root, "regions.bed")}
    n_rows = sum(e - b for _, b, e in DEPTH_REGIONS)
    for opts, ops in (([], (0, 7, 8)), (["-g"], (0, 7, 8)),
                      (["-J"], (0, 2, 7, 8)), (["-Q", "61"], ())):
        d = _in_dir(os.path.join(root, "depth" + "".join(opts)), bam_in)
        out, _ = _cli_in(d, ["depth", "-b", "regions.bed"] + opts
                         + ["example.bam"])
        rows = _depth_rows(out)
        want = sum(ln for a in alns for op, ln in a.cigar if op in ops
                   and a.mapq >= (61 if "-Q" in opts else 0))
        log("[17 host tools] %s: %d rows, total depth %d, the kept reads' "
            "CIGARs give %d" % (" ".join(["depth", "-b", "regions.bed"] + opts
                                         + ["example.bam"]), len(rows),
                                sum(rows), want))
        if len(rows) != n_rows or sum(rows) != want:
            fail("depth %s disagrees with the CIGARs" % " ".join(opts))
        if not opts:
            base = np.array(rows)
    # bammerge of example.bam with itself doubles the depth everywhere
    for no_index in (False, True):
        tag = "_noindex" if no_index else ""
        d = _in_dir(os.path.join(root, "bammerge" + tag), bam_in)
        _cli_in(d, ["bammerge"] + (["--no-index"] if no_index else [])
                + ["merged.bam", "example.bam", "example.bam"])
        out, _ = _cli_in(d, ["depth", "-b", "regions.bed", "merged.bam"])
        has_bai = os.path.exists(os.path.join(d, "merged.bam.bai"))
        twice = np.array_equal(np.array(_depth_rows(out)), 2 * base)
        log("[17 host tools] bammerge%s merged.bam example.bam example.bam: "
            ".bai written: %s; depth twice the input's at all %d "
            "positions: %s" % (" --no-index" if no_index else "", has_bai,
                               n_rows, twice))
        if not twice or has_bai == no_index:
            fail("bammerge%s: the merged depth is not twice the input's"
                 % tag)
    return res


# ------------------------------------------------------- eval and recovery

# refine's draft: two iterations, each with a contig past
# refine.MIN_CONTIG_LEN (40 Mbp) with (CCCTAA)n / (TTAGGG)n arrays at both
# ends (the second a copy of the first: contained), a contig with one
# array, a fragment of the first and a new short one; (name, length,
# arrays at the start / end, source): a source names the contig (and its
# span) that the record copies.  refine's host minimizers cost ~0.35 s a
# Mbp (on a CPU core), 86 Mbp of them here
REFINE_ITERS = [
    [("tA", 40_500_000, True, True, None),
     ("tX", 5_000_000, True, False, None)],
    [("tA2", 40_500_000, True, True, ("tA", 0, 40_500_000)),
     ("fragA", 2_000_000, False, False, ("tA", 5_000_000, 7_000_000)),
     ("tC", 3_000_000, False, False, None)]]
REFINE_TELO = 10_000
# the crash-injected stream: 3 full batches and a tail (4 batches); a
# life's group gives up after CRASH_TIMEOUT_S in a collective
CRASH_READS = 3 * BATCH + 1000
CRASH_POINTS = ("mid_part:1", "after_part:1", "after_ckpt:2")
CRASH_TIMEOUT_S = 300
PIPE_INPUTS = ("pasm.fasta", "pasm.cov-total.bg", "pasm.cov-mq20.bg",
               "pasm.bp.p_ctg.lowQ.bed", "pasm_hap1_to_asm.paf",
               "pasm_hap2_to_asm.paf")
MINIDOT_GOLDENS = [
    (["minidot", "-f", "2", "fixasm_fixed.paf"], "minidot.eps"),
    (["minidot", "asm_to_ref.paf"], "minidot_raw.eps"),
    (["minidot", "-m", "50", "-i", "0.05", "-s", "500", "-w", "800", "-d",
      "asm_to_ref.paf"], "minidot_opts.eps")]


def cut_paf(path: str, contigs, block: int = 5_000_000) -> int:
    """A PAF of the cut against itself, built by construction: every
    contig in 5 Mb blocks onto itself, the second contig's on the reverse
    strand (so fixasm turns it round).  Returns the rows written."""
    n_rows = 0
    with open(path, "w") as f:
        for i, (name, n) in enumerate(contigs):
            for qs in range(0, n, block):
                qe = min(qs + block, n)
                ts, te = (qs, qe) if i != 1 else (n - qe, n - qs)
                f.write("%s\t%d\t%d\t%d\t%s\t%s\t%d\t%d\t%d\t%d\t%d\t60"
                        "\ttp:A:P\n" % (name, n, qs, qe, "-" if i == 1 else
                                         "+", name, n, ts, te,
                                         qe - qs - (qe - qs) // 1000,
                                         qe - qs))
                n_rows += 1
    return n_rows


def write_refine_draft(path: str, seed: int):
    """REFINE_ITERS as iter1.fasta and iter2.fasta (reused per seed)."""
    import numpy as np
    stamp = os.path.join(path, ".done")
    fas = [os.path.join(path, "iter%d.fasta" % (i + 1))
           for i in range(len(REFINE_ITERS))]
    if os.path.exists(stamp):
        return fas
    os.makedirs(path, exist_ok=True)
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    made = {}
    for it, fa in zip(REFINE_ITERS, fas):
        with open(fa, "wb") as f:
            for j, (name, n, start, end, src) in enumerate(it):
                if src is None:
                    text = ascii_[np.random.default_rng(
                        [seed, 18, len(made)]).integers(0, 4, size=n,
                                                        dtype=np.uint8)]
                    if start:
                        text[:REFINE_TELO] = _tile("CCCTAA", REFINE_TELO)
                    if end:
                        text[n - REFINE_TELO:] = _tile("TTAGGG", REFINE_TELO)
                    made[name] = text
                else:
                    text = made[src[0]][src[1]:src[2]]
                f.write(b">%s\n%s\n" % (name.encode(), text.tobytes()))
    open(stamp, "w").close()
    return fas


def _ckpt_lives(specs, idx_path: str, fq: str):
    """Start one crash-stream life a spec (workdir, crash spec), all at
    once: the NCCL rank of tests/_torch_ckpt_worker.py at (1, 1) on the
    index, with a fresh rendezvous file.  Returns a function that waits for
    them and returns [(exit code, output)] in the specs' order."""
    env = dict(os.environ, PYTHONPATH=HERE)
    for k in ("CORNETTO_FORCE_CPU", "LOCAL_RANK"):
        env.pop(k, None)
    procs = []
    for wdir, crash in specs:
        os.makedirs(wdir, exist_ok=True)
        rdv = os.path.join(wdir, "rdv.%d" % time.monotonic_ns())
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "tests",
                                          "_torch_ckpt_worker.py"),
             "0", "1", rdv, wdir, fq, crash, "--index", idx_path,
             "--batch", str(BATCH), "--read-len", str(READ_LEN),
             "--timeout", str(CRASH_TIMEOUT_S)], env=env, cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return lambda: _ckpt_wait(procs)


def _ckpt_wait(procs):
    res = []
    try:
        for p in procs:
            text = p.communicate(timeout=CRASH_TIMEOUT_S + 120)[0].decode(
                errors="replace")
            res.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def phase_eval_recovery(seed: int, work: str, draft: str, contigs,
                        idx_path: str, fq: str, card: str):
    """Phase 18: minidot and hapnetto on their goldens, minidot and gfa2fa
    on the chr1-chr3 cut, flow-eval on the cut (card against
    CORNETTO_FORCE_CPU=1), refine over two iterations of 40+ Mbp contigs,
    and the crash-injected stream under NCCL on the human-scale index.
    Returns the walls."""
    import torch
    from cornetto_tpu_torch.kernels.telo import telo_match_mask
    from cornetto_tpu_torch.kernels.window_sum import window_sums
    root = os.path.join(work, "eval")
    os.makedirs(root, exist_ok=True)
    synth = os.path.join(HERE, "test_data", "synth")
    gold = os.path.join(HERE, "test_data", "golden")
    pgold = os.path.join(gold, "pipelines")
    walls = {}

    def golden(path, name):
        with open(os.path.join(path, name), "rb") as f:
            return f.read()

    # [a] minidot on its three EPS goldens
    d = _in_dir(os.path.join(root, "minidot"), {
        "fixasm_fixed.paf": os.path.join(gold, "fixasm_fixed.paf"),
        "asm_to_ref.paf": os.path.join(synth, "asm_to_ref.paf")})
    for argv, g in MINIDOT_GOLDENS:
        out, _ = _cli_in(d, argv)
        same = out == golden(gold, g)
        log("[18 eval] %s: byte-equal to golden/%s: %s"
            % (" ".join(argv), g, same))
        if not same:
            fail("%s differs from golden/%s" % (" ".join(argv), g))

    # [b] hapnetto after create-panel (the card's window sums) and after
    # recreate-panel, with the given haplotype PAFs: the golden trees
    pipe = _pipe_inputs(os.path.join(work, "synth_pipe"))
    hap = ["--hap1-paf", "pasm_hap1_to_asm.paf", "--hap2-paf",
           "pasm_hap2_to_asm.paf"]
    for flavour in ("create", "recreate"):
        d = _in_dir(os.path.join(root, "hapnetto_" + flavour),
                    {f: os.path.join(pipe, f) for f in PIPE_INPUTS})
        window_sums.launches = 0
        t0 = time.perf_counter()
        _cli_in(d, [flavour + "-panel", "pasm.fasta"])
        _cli_in(d, ["hapnetto", "pasm"] + hap
                + (["--recreate"] if flavour == "recreate" else []))
        wall = time.perf_counter() - t0
        tree = tree_bytes(d)
        want = sorted(os.listdir(os.path.join(pgold, flavour)))
        same = len(want) == 4 and all(
            tree.get(f) == golden(os.path.join(pgold, flavour), f)
            for f in want)
        log("[18 eval] %s-panel + hapnetto%s pasm: %s byte-equal to "
            "golden/pipelines/%s: %s; window-sum launches %d; %.2f s"
            % (flavour, " --recreate" if flavour == "recreate" else "",
               ", ".join(want), flavour, same, window_sums.launches, wall))
        if not same or (flavour == "create" and not window_sums.launches):
            fail("hapnetto after %s-panel differs from its golden tree"
                 % flavour)

    # [c] minidot and gfa2fa at the cut's scale
    cut = contigs[:3]
    paf = os.path.join(root, "cut.paf")
    n_rows = cut_paf(paf, cut)
    d = _in_dir(os.path.join(root, "minidot_cut"), {"cut.paf": paf})
    t0 = time.perf_counter()
    out, _ = _cli_in(d, ["minidot", "-f", "2", "--png", "cut.png",
                         "cut.paf"])
    walls["minidot"] = time.perf_counter() - t0
    png = tree_bytes(d).get("cut.png", b"")
    log("[18 eval] minidot -f 2 --png on the cut's %d-row PAF: %d EPS "
        "lines, %d PNG bytes, %.2f s" % (n_rows, out.count(b"\n"), len(png),
                                         walls["minidot"]))
    if out.count(b" L\n") != n_rows or not png.startswith(b"\x89PNG"):
        fail("minidot on the cut's PAF: not one line a row, or no PNG")
    gfa = os.path.join(root, "cut.gfa")
    with open(draft, "rb") as src, open(gfa, "wb") as dst:
        while True:
            name = src.readline()
            if not name:
                break
            dst.write(b"S\t%s\t%s" % (name[1:].rstrip(b"\n"),
                                      src.readline()))
    d = _in_dir(os.path.join(root, "gfa2fa"), {"cut.gfa": gfa})
    t0 = time.perf_counter()
    _cli_in(d, ["gfa2fa", "cut.gfa"])
    walls["gfa2fa"] = time.perf_counter() - t0
    same = _same_file(d + ".stdout", draft)
    log("[18 eval] gfa2fa on the cut's S-lines (%d bp): byte-equal to the "
        "cut's FASTA: %s, %.2f s" % (sum(n for _, n in cut), same,
                                     walls["gfa2fa"]))
    if not same:
        fail("gfa2fa on the cut differs from the cut")

    # [d] flow-eval on the cut, minimap2 a template writing the PAF above,
    # quast / compleasm / yak templates standing for those tools; on the
    # card, then with CORNETTO_FORCE_CPU=1
    digests = {}
    for where in ("card", "cpu"):
        # one directory for both runs: the outputs name the paths given
        base = _in_dir(os.path.join(root, "flow_eval"),
                       {"ref.fasta": draft, "asm.fasta": draft})
        with open(os.path.join(base, "cfg.json"), "w") as f:
            json.dump({"threads": 8, "lineage": "primates", "tools": {
                "minimap2_asm": "cat %s > {out}" % paf,
                "quast": "mkdir -p {out_dir} && echo quast {threads} > "
                         "{out_dir}/report.txt",
                "compleasm": "mkdir -p {out_dir} && echo compleasm "
                             "{lineage} > {out_dir}/summary.txt",
                "yak_count": "echo yak > {out}",
                "yak_qv": "echo QV 50 > {out}"}}, f)
        telo_match_mask.launches = 0
        argv = ["flow-eval", os.path.join(base, "wd"),
                os.path.join(base, "ref.fasta"),
                os.path.join(base, "asm.fasta"), "--config", "cfg.json"]
        t0 = time.perf_counter()
        if where == "cpu":
            with force_cpu():
                _cli_in(base, argv)
        else:
            _cli_in(base, argv)
            torch.cuda.synchronize()
        walls["flow_eval_" + where] = time.perf_counter() - t0
        walls["flow_eval_%s_launches" % where] = telo_match_mask.launches
        digests[where] = tree_bytes(base)
        del digests[where][os.path.join("wd", ".flow.eval.json")]  # times
        if where == "card":
            with open(os.path.join(base, "wd", "asm.fasta.telostats.txt")) \
                    as f:
                t2t = int(re.search(r"contigs with 2 telo:\t(\d+)",
                                    f.read()).group(1))
    same = digests["card"] == digests["cpu"]
    log("[18 eval] flow-eval on the chr1-chr3 cut (minidotplot --paf, "
        "telostats, asmstats, templates for minimap2, quast, compleasm and "
        "yak): card %.2f s (%d telomere-mask launches), CORNETTO_FORCE_CPU=1 "
        "%.2f s (%d); all %d files byte-equal: %s; %d contigs with two "
        "telomeres (%s)"
        % (walls["flow_eval_card"], walls["flow_eval_card_launches"],
           walls["flow_eval_cpu"], walls["flow_eval_cpu_launches"],
           len(digests["card"]), same, t2t, card))
    want = {"wd/asm.eps", "wd/asm.fixed.fasta",
            "wd/asm.fasta.asmstats.txt", "wd/asm.fasta.yak.txt",
            "wd/quast_out/report.txt", "ref.fasta.yak"} - set(digests["card"])
    if not same or want or walls["flow_eval_card_launches"] != 6 or \
            walls["flow_eval_cpu_launches"] or not t2t:
        fail("flow-eval on the cut: the card's files differ from the CPU's, "
             "%s missing, or not 6 mask launches, or no contig with two "
             "telomeres" % sorted(want))
    shutil.rmtree(os.path.join(root, "flow_eval"))

    # [e] the crash-injected stream under NCCL at (1, 1) on the human-scale
    # index: its first wave (the uninterrupted oracle and a life killed at
    # each crash point) starts here and runs beside [f]; then the resumed
    # lives, beside the oracle's check against SingleChipEngine.  Each
    # resumed decisions.tsv and tally byte-identical to the oracle's.
    crash_fq = os.path.join(root, "crash.fq")
    with open(fq, "rb") as src, open(crash_fq, "wb") as dst:
        for _ in range(4 * CRASH_READS):
            dst.write(src.readline())
    n_batches = -(-CRASH_READS // BATCH)
    cdirs = {c: os.path.join(root, "crash_" + c.replace(":", "_"))
             for c in ("none",) + CRASH_POINTS}
    for c in cdirs.values():
        if os.path.isdir(c):
            shutil.rmtree(c)
    t_crash = time.perf_counter()
    wave1 = _ckpt_lives([(cdirs[c], c) for c in cdirs], idx_path, crash_fq)

    # [f] refine over two iterations: telostats (the card's mask) gives
    # each one's contig ends, refine curates in a process of its own; the
    # CLI footer's peak RAM (ru_maxrss) carries over what the process that
    # exec'd it had reached, so refine is started from a small Python
    # process in between, not from this one
    fas = write_refine_draft(os.path.join(work, "refine_s%d" % seed), seed)
    d = _in_dir(os.path.join(root, "refine"), {
        os.path.basename(fa): fa for fa in fas})
    beds = []
    for fa in fas:
        _cli_in(d, ["telostats", os.path.basename(fa)])
        beds.append(os.path.basename(fa)[:-len(".fasta")]
                    + ".windows.0.4.50kb.ends.bed")
    argv = ["refine", "curated"] + [x for fa, bed in zip(fas, beds)
                                    for x in (os.path.basename(fa), bed)]
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", "import subprocess, sys; "
         "sys.exit(subprocess.call(sys.argv[1:]))", sys.executable, "-m",
         "cornetto_tpu_torch.cli"] + argv, cwd=d, capture_output=True,
        text=True, timeout=900, env=dict(os.environ, PYTHONPATH=HERE))
    walls["refine"] = time.perf_counter() - t0
    m = re.search(r"Peak RAM: ([0-9.]+) GB", p.stderr)
    if p.returncode != 0 or m is None:
        fail("refine exited %d:\n%s" % (p.returncode, p.stderr[-2000:]))
    walls["refine_peak_gb"] = float(m.group(1))
    from cornetto_tpu_torch.io.fasta import read_fastx
    got = [(r.name, len(r.seq)) for r in read_fastx(
        os.path.join(d, "curated.fasta"))]
    want = [("A_1_t2t_tA", 40_500_000), ("A_2_nont2t_tC", 3_000_000)]
    log("[18 eval] refine over two iterations (%s bp; the ends from "
        "telostats on the card), beside the crash stream's first wave: "
        "%.2f s, peak RSS %.3f GB (the CLI's footer); curated %s"
        % (" + ".join(str(sum(n for _, n, _, _, _ in it))
                      for it in REFINE_ITERS),
           walls["refine"], walls["refine_peak_gb"], got))
    if got != want or p.stdout.count("has 1 T2T") != 2:
        fail("refine curated %s, not %s" % (got, want))

    wave1 = wave1()
    walls["crash_wave1"] = time.perf_counter() - t_crash
    rc, text = wave1[0]
    computed = [int(x) for x in re.findall(r"batch (\d+) computed", text)]
    if rc != 0 or "DONE" not in text or computed != list(range(n_batches)):
        fail("the crash stream's oracle exited %d:\n%s" % (rc, text[-3000:]))
    with open(os.path.join(cdirs["none"], "decisions.tsv"), "rb") as f:
        want = f.read()
    tally = re.search(r"tallies (.+)", text).group(1)
    log("[18 recovery] crash stream oracle: %d reads in %d batches of %d, "
        "NCCL (1, 1) on the human-scale index, a checkpoint (index, panel, "
        "tallies) after every batch: exit 0" % (CRASH_READS, n_batches,
                                               BATCH))
    for c, (rc, text) in zip(CRASH_POINTS, wave1[1:]):
        log("[18 recovery] crashed life %s: exit %d" % (c, rc))
        if rc != 9 or "CRASH " + c not in text or os.path.exists(
                os.path.join(cdirs[c], "decisions.tsv")):
            fail("the life crashed at %s exited %d:\n%s"
                 % (c, rc, text[-3000:]))
    t0 = time.perf_counter()
    wave2 = _ckpt_lives([(cdirs[c], "none") for c in CRASH_POINTS],
                        idx_path, crash_fq)
    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    from cornetto_tpu_torch.livefish.stream import batches_from_fastq
    idx, panel, _ = load_index(idx_path)
    eng = SingleChipEngine(idx, panel, device="cuda")
    del idx
    rows = []
    for rb in batches_from_fastq(crash_fq, BATCH, READ_LEN):
        d_, best, est, nh = (x.cpu().numpy() for x in eng.decide(
            rb.codes)[:4])
        rows += ["%s\t%d\t%d\t%d\t%d\n" % (rb.ids[j], int(d_[j]),
                                            int(best[j]), int(est[j]),
                                            int(nh[j]))
                 for j in range(rb.count)]
    same = "".join(rows).encode() == want
    del eng
    torch.cuda.empty_cache()
    wave2 = wave2()
    walls["crash_wave2"] = time.perf_counter() - t0
    for c, (rc, text) in zip(CRASH_POINTS, wave2):
        kind, i = c.split(":")
        cursor = int(i) + (1 if kind == "after_ckpt" else 0)
        computed = [int(x) for x in re.findall(r"batch (\d+) computed",
                                               text)]
        with open(os.path.join(cdirs[c], "decisions.tsv"), "rb") as f:
            got = f.read()
        m = re.search(r"tallies (.+)", text)
        ok = got == want and m is not None and m.group(1) == tally
        log("[18 recovery] resumed after %s: exit %d, resumed at cursor %d, "
            "recomputed batches %s; decisions.tsv and tallies byte-identical "
            "to the oracle's: %s" % (c, rc, cursor, computed, ok))
        if rc != 0 or not ok or computed != list(range(cursor,
                                                       n_batches)) or \
                (cursor and "resumed at cursor %d" % cursor not in text):
            fail("the life resumed after %s differs from the oracle:\n%s"
                 % (c, text[-3000:]))
    log("[18 recovery] the oracle's %d rows equal SingleChipEngine.decide's "
        "on the same batches: %s; walls: the first wave (oracle and crashes) "
        "and refine beside it %.1f s, the resumes and the SingleChipEngine "
        "check beside them %.1f s (%s)"
        % (len(rows), same, walls["crash_wave1"], walls["crash_wave2"],
           card))
    if not same:
        fail("the crash stream's oracle differs from SingleChipEngine")
    for c in cdirs.values():
        shutil.rmtree(c)
    return walls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    # one of phase 16's gloo ranks, started by the script itself
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-work", help=argparse.SUPPRESS)
    ap.add_argument("--dist-index", help=argparse.SUPPRESS)
    ap.add_argument("--dist-index2", help=argparse.SUPPRESS)
    ap.add_argument("--votes-against", metavar="DIR",
                    help="another checkout whose votes and policy kernels "
                    "phase 16 times in turns with this one's")
    # one process of those turns, started by the script itself
    ap.add_argument("--votes-time", help=argparse.SUPPRESS)
    ap.add_argument("--sanitize-cases", action="store_true",
                    help="only every kernel at small ragged shapes against "
                    "its plain version")
    ap.add_argument("--sanitize", action="store_true",
                    help="only --sanitize-cases under each "
                    "compute-sanitizer tool")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "cornetto_tpu_torch")):
        fail("cornetto_tpu_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    if args.dist_rank is not None:
        dist_worker(args)
        return
    if args.votes_time is not None:
        sys.path.insert(0, os.path.abspath(args.votes_time))
        votes_time(args)
        return
    if args.sanitize_cases:
        sanitize_cases()
        return
    if args.sanitize:
        phase_device()
        phase_build()
        work = os.path.join(HERE, "build", "smoke")
        os.makedirs(work, exist_ok=True)
        phase_sanitize(work)
        return

    clock = [time.perf_counter()]
    phase_s = {}

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 2)
        clock[0] = now
        log("[phases] %s: %.2f s" % (name, phase_s[name]))

    card = phase_device()
    lap("1 device")
    phase_build()
    lap("2 build")
    max_err, ktimes = phase_kernels(args.seed)
    dec_err = phase_decide_small(args.seed)
    ws_err, ws_times = phase_window_kernel(args.seed)
    lap("3 kernel")

    from cornetto_tpu_torch.dist.checkpoint import load_index
    from cornetto_tpu_torch.native.fastq_pack import iter_packed_batches
    from cornetto_tpu_torch.kernels.decide import decide_packed, pack_fused
    from cornetto_tpu_torch.kernels.extract import extract_minima
    from cornetto_tpu_torch.livefish import decide as td
    from cornetto_tpu_torch.livefish.stream import stream_decisions

    work = os.path.join(HERE, "build", "smoke")
    os.makedirs(work, exist_ok=True)

    # [4] state at human scale
    contigs = human_draft(args.seed)
    t0 = time.perf_counter()
    codes = genome_codes(args.seed, contigs)
    elem = plant_repeats(args.seed, contigs, codes)
    rows_bed = panel_rows(args.seed, contigs, 1_000_000)
    log("[4 state] draft: %d contigs, %d bp, largest %d bp, %d copies of a "
        "%d-base repeat element, generated in %.1f s"
        % (len(contigs), sum(n for _, n in contigs),
           max(n for _, n in contigs), REPEAT_COPIES, REPEAT_LEN,
           time.perf_counter() - t0))
    idx_path = os.path.join(work, "human_s%d" % args.seed)
    build_or_load_index(idx_path, contigs, codes, rows_bed)
    # the same draft's table in two hash shards, for phase 16's (1, 2)
    idx2_path = os.path.join(work, "human2_s%d" % args.seed)
    build_or_load_index(idx2_path, contigs, codes, rows_bed, n_shards=2)
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
    err, dec_t = phase_decide_human(args.seed, state, contigs, codes)
    dec_err = max(dec_err, err)
    lap("3 decide, human-scale")

    # [5] the slice end to end through the CLI
    n_reads = FULL_BATCHES * BATCH + TAIL
    fq = os.path.join(work, "human_s%d.fq" % args.seed)
    t0 = time.perf_counter()
    truth = write_reads(fq, args.seed, contigs, codes, rows_bed, 1_000_000,
                        n_reads)
    log("[5 slice] wrote %d reads (%d batches of %d) in %.1f s"
        % (n_reads, -(-n_reads // BATCH), BATCH, time.perf_counter() - t0))
    rfq = os.path.join(work, "replay_s%d.fa" % args.seed)
    t0 = time.perf_counter()
    r_bases, r_heads = write_replay_reads(rfq, args.seed, contigs, codes,
                                          rows_bed, 1_000_000, REPLAY_READS,
                                          elem)
    log("[5 slice] wrote %d replay reads of 2-20 kb (%d bases, %d with a "
        "repeat head) in %.1f s" % (REPLAY_READS, r_bases, r_heads,
                                    time.perf_counter() - t0))
    del codes
    tsv = os.path.join(work, "human_s%d.tsv" % args.seed)
    torch.cuda.reset_peak_memory_stats()
    extract_minima.launches = 0
    decide_packed.launches = 0
    t0 = time.perf_counter()
    rows = run_cli(idx_path, fq, tsv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = decide_packed.launches
    n_batches = -(-n_reads // BATCH)
    log("[5 slice] livefish run: %d rows in %.2f s (index load + upload "
        "included), %d fused decision launches and %d standalone extraction "
        "launches for %d batches, max_memory_allocated %d bytes"
        % (len(rows), cli_s, launches, extract_minima.launches, n_batches,
           torch.cuda.max_memory_allocated()))
    if launches != n_batches or extract_minima.launches:
        fail("fused decision kernel launched %d times (extraction %d) for %d "
             "batches" % (launches, extract_minima.launches, n_batches))
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

    def old_step():
        d, b, e, nh, _, _ = td._decide_from_minima(
            state.btable, *extract_minima(pk, None, READ_LEN, K, W),
            state.panel, kw["min_hits"], kw["bin_size"], state.bucket_shift,
            state.two_choice)
        return pack_fused(d, b, e, nh)
    decide_packed.launches = 0
    ms_step = cuda_ms(step, 200)
    if decide_packed.launches != 210:
        fail("decision_core_packed_fused launched the fused kernel %d times "
             "in 210 steps" % decide_packed.launches)
    ms_old = cuda_ms(old_step, 20)
    ms_old_graph = graph_ms(old_step, 20)
    ms_step2 = cuda_ms(step, 200)
    ms_step_graph = graph_ms(step)
    ms_ext = cuda_ms(lambda: extract_minima(pk, None, READ_LEN, K, W), 200)
    ms_h2d = cuda_ms(lambda: torch.from_numpy(pb.packed).cuda(), 20)
    out = step()
    if not torch.equal(out, old_step()):
        fail("the fused step disagrees with the earlier step")
    ms_d2h = cuda_ms(lambda: out.cpu(), 20)
    b_ms, b_by = bound(dec_t)
    log("[7 numbers] %s" % card)
    log("[7 numbers] FASTQ->TSV %d reads in %.3f s = %.0f reads/s "
        "(index resident; %s)" % (total, e2e_s, total / e2e_s, card))
    log("[7 numbers] host parse+pack alone: %.0f reads/s" % (nparse
                                                           / parse_s))
    log("[7 numbers] per 4096-read batch: device step through "
        "decision_core_packed_fused %.4f ms, again %.4f ms (one launch, "
        "back to back; %.4f ms by graph replay); earlier step (extraction "
        "kernel + torch lookup, votes, policy) %.4f ms back to back, %.4f "
        "ms by graph replay; standalone extraction kernel %.4f ms a "
        "wrapper call; H2D packed %.4f ms; D2H fused %.4f ms (%s)"
        % (ms_step, ms_step2, ms_step_graph, ms_old, ms_old_graph, ms_ext,
           ms_h2d, ms_d2h, card))
    log("[7 numbers] fused decision kernel at (4096, 450) N-free on the "
        "human-scale index: %.4f ms, bound %.4f ms (%s: %d bytes, %d valid "
        "windows x %d probes x 32 B gathered) = %.1f%% of the bound reached; "
        "plain step %.4f ms (%s)"
        % (dec_t["ms"], b_ms, b_by, dec_t["bytes"], dec_t["valid_windows"],
           2 if state.two_choice else 1, 100 * b_ms / dec_t["ms"],
           dec_t["plain_ms"], card))
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
    an_launches, an_secs, an_stats, tf_split = phase_annotation(
        args.seed, draft, slice_fa, contigs[:3])
    lap("13 annotation")
    torch.cuda.empty_cache()
    phase_cuda_tests(work)
    lap("14 cuda tests")
    rp = phase_replay(args.seed, work, idx_path, rfq)
    lap("15 replay")
    dd = phase_dist(args.seed, work, idx_path, idx2_path, fq, card,
                    args.votes_against)
    lap("16 dist")
    ht = phase_host_tools(args.seed, work, draft)
    lap("17 host tools")
    er = phase_eval_recovery(args.seed, work, draft, contigs, idx_path, fq,
                             card)
    lap("18 eval and recovery")
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
    ts = ht["telostats_cut"]
    log("[7 numbers] telostats, chr1-chr3 689 Mbp: on the card %.2f s, "
        "CORNETTO_FORCE_CPU=1 %.2f s; alone, a FASTA read %.2f s and "
        "telowin %.2f s (%s)" % (ts["card"], ts["cpu"], ts["fasta_read"],
                                 ts["telowin"], card))
    tf = tf_split["device"]
    log("[7 numbers] telofind on the device, split run: %.2f s = %s (%s)"
        % (tf["wall"], " + ".join("%s %.3f" % (k, tf.get(k, 0.0))
                                  for k in TF_PARTS), card))
    tm = ak["telo_match_mask"]
    log("[7 numbers] telomere mask kernel at chr1: %.4f ms, bound %.4f ms "
        "(%s), plain %.4f ms; with the compaction %.4f ms (%s)"
        % (tm["ms"], *bound(tm), tm["plain_ms"], tm["positions_ms"], card))
    sd = ak["sdust"]
    log("[7 numbers] sdust kernel at the main path's shape (384 rows, core "
        "2048): two passes %.4f ms (%d heavy rows), PR 3's single pass %.4f "
        "ms, plain %.1f ms; bound %.4f ms (%s) (%s)"
        % (sd["ms"], sd["heavy_rows"], sd["old_ms"], sd["plain_ms"],
           *bound(sd), card))
    for (B, L), t in ak["telo_run_stats"]["times"].items():
        if "old_ms" in t:
            log("[7 numbers] telomere run-stats kernel at (%d, %d): %.4f ms "
                "by graph replay (the first design, row walk + bool cast, "
                "%.4f ms), a wrapper call back to back %.4f ms, bound %.4f "
                "ms (%s), "
                "plain %.4f ms (%s)" % (B, L, t["ms"], t["old_ms"],
                                        t["call_ms"], *bound(t),
                                        t["plain_ms"], card))
    for _, C in REPLAY_CELLS:
        h, d, t = rp[(C, "host")], rp[(C, "device")], rp[(C, "tick")]
        log("[7 numbers] livefish replay at %d channels, %d reads: %d "
            "ticks, %d fused launches, %.2f%% of the final decisions after "
            "the first chunk; host state %.1f ticks/s, %.0f decisions/s; "
            "device state %.1f ticks/s, %.0f decisions/s; device tick %.4f "
            "ms by graph replay (%s)"
            % (C, REPLAY_READS, d["ticks"], d["launches"],
               100 * d["later_share"], h["ticks"] / h["replay_s"],
               h["decisions"] / h["replay_s"], d["ticks"] / d["replay_s"],
               d["decisions"] / d["replay_s"], t["ms"], card))
    log("[7 numbers] eval and recovery: flow-eval on the chr1-chr3 cut, "
        "card %.2f s, CORNETTO_FORCE_CPU=1 %.2f s; minidot on the cut's PAF "
        "%.2f s, gfa2fa of its S-lines %.2f s; refine over two iterations "
        "%.2f s, peak RSS %.3f GB (beside the crash stream's first wave); "
        "crash stream waves %.1f + %.1f s; "
        "save_sharded / load_sharded of the (1, 2) gloo ranks' %d-byte "
        "shards %.2f / %.2f s (%s)"
        % (er["flow_eval_card"], er["flow_eval_cpu"], er["minidot"],
           er["gfa2fa"], er["refine"], er["refine_peak_gb"],
           er["crash_wave1"], er["crash_wave2"], dd["ckpt"]["bytes"],
           dd["ckpt"]["save_s"], dd["ckpt"]["load_s"], card))
    log("[phases] seconds: %s; total %.1f s"
        % (json.dumps(phase_s), sum(phase_s.values())))

    for name, t in dd["timing"].items():
        log("[7 numbers] sharded decision step %s, per 4096-read batch: "
            "%.4f ms = %s; a decide_packed call %.4f ms (%s)"
            % (name, t["step_ms"], " + ".join(
                "%s %.4f" % kv for kv in t["split"].items()), t["call_ms"],
               card))
    table = [
        # extraction runs inside the fused kernel on the main path: its
        # launches are the fused kernel's, its times the standalone's
        ("extract_minima", "extract_minima",
         "kernels/pallas_extract.py:161", launches, max_err,
         ktimes["nfree"]),
        ("decide", "decide", "kernels/pallas_extract.py:161", launches,
         dec_err, dec_t),
        # XLA in the JAX package: _decide_from_minima with ep_axis
        ("votes", "votes", "livefish/decide.py:254",
         dd["launches"]["votes"], dd["err"], dd["votes"]),
        ("policy", "votes", "livefish/decide.py:268",
         dd["launches"]["policy"], dd["err"], dd["policy"]),
        ("window_sum", "window_sum", "kernels/pallas_window.py:37",
         ws_launches, max(ws_err, hp_err), ws_times),
        ("sdust", "sdust", "kernels/pallas_sdust.py:316",
         an_launches["sdust"], ak["sdust"]["err"], ak["sdust"]),
        ("telo_match_mask", "telo", "kernels/pallas_telo.py:63",
         an_launches["telo_match_mask"], ak["telo_match_mask"]["err"],
         ak["telo_match_mask"]),
        ("telo_run_stats", "telo", "kernels/pallas_telo.py:147",
         an_launches["telo_run_stats"], ak["telo_run_stats"]["err"],
         ak["telo_run_stats"])]
    kernels = []
    for name, src, replaces, n_launch, err, t in table:
        b_ms, b_by = bound(t)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cornetto_tpu_torch/csrc/%s.cu" % src,
            "replaces": "cornetto_tpu/%s" % replaces,
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
