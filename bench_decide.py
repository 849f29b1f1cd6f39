#!/usr/bin/env python3
"""The fused decision kernel's design choices timed on the card.

    python3 bench_decide.py [--seed N]

Needs one NVIDIA GPU with the CUDA toolkit (nvcc); run from the root of a
checkout.  Builds variants of cornetto_tpu_torch/csrc/decide.cu and
extract_minima.cu, in parallel, into build/kernels/variants/, each with
its own copy of csrc/minimizer.cuh differing from the source in one or
two places:

- the lanes a read: 8, 16 or 32, whichever leaves the fewest lanes idle
  over the read's windows (the source; 16 at L = 450), or a warp (32)
  for every read;
- a window's codes and N flags read from shared memory once into a 64-bit
  register when its k + w - 1 bases fit in 32 (the source), or a word at
  a time as longer windows are.

The batch: 4096 seeded reads of 450 bases in each validity variant
(N-free, 25% shorter lengths, 1% Ns), and a table of the human-scale
index's shape (2^27 buckets x 4 slots, 4.29 GB) whose buckets are empty
but for the batch's own window minima, planted in the first probe's
bucket with seeded contigs (87) and positions (10% marked ambiguous), so
every valid window hits and the gathers are random 32-byte rows as at
human scale.  Each variant's outputs are held equal to the plain PyTorch
version (kernels/decide.py::decide_packed_ref, fused form, two_choice on),
then the variants are timed in turns (a, b, ..., b, a): the device time
of one launch by CUDA-graph replay of 100 launches, for extraction and
for the fused step.  Prints one line a case, the card's name and power
limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
GROUPS = "for (int g = 16; g >= 8; g >>= 1)"
REGISTER = "if (steps <= 32) {"
B, L, K, W, NB_LOG2, C, BINS = 4096, 450, 15, 10, 27, 87, 256


def build_variants():
    """{name: (extract fn, decide fn)} of every variant, one nvcc a
    source, all started together."""
    from cornetto_tpu_torch.kernels import _build
    head = (_build.CSRC / "minimizer.cuh").read_text()
    if GROUPS not in head or REGISTER not in head:
        raise SystemExit("bench_decide: minimizer.cuh no longer has '%s' "
                         "and '%s'" % (GROUPS, REGISTER))
    fixed = head.replace(GROUPS, "for (int g = 16; g >= 32; g >>= 1)")
    heads = {"source (8-32 lanes a read, window register)": head,
             "a warp a read": fixed,
             "no window register": head.replace(REGISTER,
                                                "if (steps <= 0) {"),
             "a warp a read, no window register": fixed.replace(
                 REGISTER, "if (steps <= 0) {")}
    procs = {}
    for i, (name, text) in enumerate(heads.items()):
        out = _build.BUILD_DIR / "variants" / ("decide_v%d" % i)
        out.mkdir(parents=True, exist_ok=True)
        (out / "minimizer.cuh").write_text(text)
        for src in ("extract_minima", "decide"):
            cu = out / (src + ".cu")
            cu.write_text((_build.CSRC / (src + ".cu")).read_text())
            so = out / ("lib%s.so" % src)
            procs[name, src] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(cu)], stderr=subprocess.PIPE, text=True))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for (name, src), (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit("nvcc failed for %s %s:\n%s" % (name, src, err))
        regs = sorted({ln.split(":", 1)[1].strip() for ln in err.splitlines()
                       if "registers" in ln})
        print("%s, %s.cu: ptxas %s" % (name, src, regs), flush=True)
        lib = ctypes.CDLL(str(so))
        if src == "extract_minima":
            fn = lib.cornetto_extract_minima
            fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
        else:
            fn = lib.cornetto_decide_packed
            fn.argtypes = [vp, vp, vp, vp, ci, ci, vp] + [ci] * 10 + \
                [vp] * 8
        fn.restype = ci
        libs.setdefault(name, {})[src] = fn
    return libs


def planted_table(seed, minima, dev):
    """(2^27, 8) int32 rows, empty but for each valid window minimum in
    slot 0 of its first-probe bucket (bucket_shift 0)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    bt = torch.zeros((1 << NB_LOG2, 8), dtype=torch.int32, device=dev)
    bt[:, 2:4] = -1                                 # contig 0xFFFF: empty
    q = torch.cat([h[v] for h, v in minima]).to(torch.int64) & 0xFFFFFFFF
    bucket = q & ((1 << NB_LOG2) - 1)
    ctg = torch.randint(0, C, q.shape, generator=gen, device=dev)
    pos = torch.randint(0, 1 << 31, q.shape, generator=gen, device=dev)
    amb = torch.rand(q.shape, generator=gen, device=dev) < 0.1
    pos = torch.where(amb, pos - (1 << 31), pos)    # sign bit: ambiguous
    bt[bucket, 0] = (q >> NB_LOG2).to(torch.int32)
    bt[bucket, 2] = (ctg - 65536).to(torch.int32)   # 0xFFFF in slot 1
    bt[bucket, 4] = pos.to(torch.int32)
    return bt


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_decide: needs an NVIDIA GPU")
    from chip_smoke import graph_ms
    from cornetto_tpu_torch.kernels.decide import decide_packed_ref
    from cornetto_tpu_torch.kernels.extract import extract_minima_ref
    from cornetto_tpu_torch.kernels.minimizer import pack_reads
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    libs = build_variants()
    dev = torch.device("cuda")
    rng = np.random.default_rng([args.seed, 17])
    batches = {}
    for variant in ("nfree", "lengths", "nmask"):
        reads = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
        lengths = None
        if variant == "nmask":
            reads[rng.random((B, L)) < 0.01] = 4
        elif variant == "lengths":
            lengths = np.full(B, L, dtype=np.int32)
            short = rng.random(B) < 0.25
            lengths[short] = rng.integers(0, L, size=int(short.sum()))
        packed, nmask = pack_reads(reads)
        batches[variant] = [None if a is None else torch.from_numpy(a).to(dev)
                            for a in (packed, nmask if variant == "nmask"
                                      else None, lengths)]
    bt = planted_table(args.seed, [extract_minima_ref(pk, nm, L, K, W,
                                                      lengths=ln)
                                   for pk, nm, ln in batches.values()], dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    panel = torch.rand((C, BINS), generator=gen, device=dev) < 0.5
    hmin = torch.empty((B, (L - K + 1) // W), dtype=torch.int32, device=dev)
    valid = torch.empty(hmin.shape, dtype=torch.bool, device=dev)
    fused = torch.empty((2, B), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def extract(name, pk, nm, ln):
        err = libs[name]["extract_minima"](
            ptr(pk), ptr(nm), ptr(ln), B, L, K, W, hmin.data_ptr(),
            valid.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit("%s: CUDA error %d" % (name, err))
        return hmin, valid

    def decide(name, pk, nm, ln):
        err = libs[name]["decide"](
            ptr(pk), ptr(nm), ptr(ln), bt.data_ptr(), NB_LOG2, 4,
            panel.data_ptr(), C, BINS, B, L, K, W, 3, 1000, 0, 1,
            fused.data_ptr(), None, None, None, None, None, None,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit("%s: CUDA error %d" % (name, err))
        return fused

    names = list(libs)
    for variant, (pk, nm, ln) in batches.items():
        want_h = extract_minima_ref(pk, nm, L, K, W, lengths=ln)
        want = decide_packed_ref(bt, pk, nm, panel, L=L, k=K, w=W,
                                 min_hits=3, bin_size=1000, bucket_shift=0,
                                 two_choice=True, lengths=ln, fused=True)
        nvalid = int(want_h[1].sum())
        for name in names:
            h, v = extract(name, pk, nm, ln)
            if not (torch.equal(h, want_h[0]) and torch.equal(v, want_h[1])
                    and torch.equal(decide(name, pk, nm, ln), want)):
                raise SystemExit("%s differs from the plain version (%s)"
                                 % (name, variant))
        for what, fn in (("extraction", extract), ("fused step", decide)):
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(graph_ms(lambda: fn(name, pk, nm, ln)))
            print("(%d, %d) %s, %s (%d valid windows, each planted), ms a "
                  "launch by graph replay, in turns: %s (%s)"
                  % (B, L, variant, what, nvalid,
                     "; ".join("%s %.4f / %.4f" % (n, *t)
                               for n, t in times.items()), card),
                  flush=True)
    print(card)


if __name__ == "__main__":
    main()
