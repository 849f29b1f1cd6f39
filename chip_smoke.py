#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (cornetto_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU with the CUDA toolkit (nvcc).  Run from the root of a
checkout.  It:

1. prints the card, its power limit and the toolchain;
2. builds the minimizer-extraction kernel from cornetto_tpu_torch/csrc;
3. holds the kernel bit-equal to its plain PyTorch version on the card in
   all three validity variants, and times both;
4. builds a seeded synthetic draft at human scale (GRCh38's chromosome
   lengths, 3.09 Gbp in 87 contigs), its minimizer index (shared host
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
7. prints end-to-end reads/s and the per-layer times of one batch.

Prints a {"kernels": [...]} line, the nvidia-smi name/power line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero with no result.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, READ_LEN, K, W = 4096, 450, 15, 10
FULL_BATCHES, TAIL = 64, 1000

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
    from cornetto_tpu.dist.checkpoint import save_index
    from cornetto_tpu.livefish.index import build_index, build_panel_mask
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
    from cornetto_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("extract_minima")
    dt = time.perf_counter() - t0
    info = _build.build_info.get("extract_minima")
    log("[2 build] extract_minima.cu -> %s in %.2f s"
        % (_build.library_path("extract_minima"), dt))
    if info:
        for line in info[1].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log("[2 build]   ptxas: %s" % line.strip())
    return dt


def _kernel_inputs(seed, B, L, k, variant, dev):
    import numpy as np
    import torch
    from cornetto_tpu.kernels.minimizer import pack_reads
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
                timing[variant] = (ms, ms_ref)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "cornetto_tpu_torch")) or \
            not os.path.isdir(os.path.join(HERE, "cornetto_tpu")):
        fail("cornetto_tpu_torch/ and cornetto_tpu/ not found beside "
             "chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")

    card = phase_device()
    phase_build()
    max_err, ktimes = phase_kernels(args.seed)

    from cornetto_tpu.dist.checkpoint import load_index
    from cornetto_tpu.native.fastq_pack import iter_packed_batches
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
    ms, plain_ms = ktimes["nfree"]
    print(json.dumps({"kernels": [{
        "name": "extract_minima", "route": "cuda",
        "source": "cornetto_tpu_torch/csrc/extract_minima.cu",
        "replaces": "cornetto_tpu/kernels/pallas_extract.py:161",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
