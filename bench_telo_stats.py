#!/usr/bin/env python3
"""The telomere run-stats kernel's design choices timed on the card.

    python3 bench_telo_stats.py [--seed N]

Needs one NVIDIA GPU with the CUDA toolkit (nvcc); run from the root of a
checkout.  Builds variants of cornetto_tpu_torch/csrc/telo.cu, in parallel,
into build/kernels/variants/, each differing from the source in one of
the bitset kernel's two choices:

- kStatsLanes, the lanes a read: 16 or 32 (the source);
- the run lengths: by doubling on the bitset (the source), or by a
  per-start walk on it (each run's first match walks the run, up to the
  cap), a variant this script carries as its own text (WALK_RUNS) and
  puts in place of the source's doubling and lifting.

Each variant, and the row walk (route 1 of the source's build: a block
a read, byte compares with an early exit), is held bit-equal to the plain
PyTorch version, then timed by CUDA-graph replay (the launch alone, the
outputs allocated once) in turns (a, b, ..., b, a) at (4096, 450) and
(4096, 1800) on chip_smoke's read batches (a tenth of the reads with a
TTAGGG or CCCTAA array, 1% N), and at (4096, 450) with every read one
TTAGGG array of 1-75 copies (the walk's worst case).  Prints one line a
case, the card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
LANES = "constexpr int kStatsLanes = 32;"
# the source's doubling and lifting: from its first line up to the lane-0
# writes of the three outputs
DOUBLING = ("  // level t + 1 = level t", "  if (lane == 0) {\n    n_out[row]")
# the per-start walk on level 0 (own[a] holds the lane's words of it)
WALK_RUNS = """\
  {
    const int cap = 1 << steps;
#pragma unroll
    for (int a = 0; a < W; ++a) {
      const int j = lane + a * G;
      uint32_t w = own[a];
      while (w) {
        const int i = 32 * j + __ffs(w) - 1;
        w &= w - 1u;
        if (i >= k && ((lv[(i - k) >> 5] >> ((i - k) & 31)) & 1u)) continue;
        int run = 1;
        for (int p = i + k;
             run < cap && p < m && ((lv[p >> 5] >> (p & 31)) & 1u); p += k)
          ++run;
        longest = max(longest, run);
        if (i == 0) run0 = run;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      longest = max(longest, __shfl_xor_sync(gmask, longest, o));
  }
"""


def build_variants():
    """{name: ctypes library} of every variant, one nvcc each, together."""
    from cornetto_tpu_torch.kernels import _build
    src = (_build.CSRC / "telo.cu").read_text()
    if src.count(LANES) != 1 or src.count(DOUBLING[0]) != 1 \
            or src.count(DOUBLING[1]) != 1:
        raise SystemExit("bench_telo_stats: telo.cu no longer has '%s' and "
                         "the doubling's bounds %s" % (LANES, DOUBLING))
    texts = {}
    for lanes in (16, 32):
        lane_src = src.replace(LANES,
                               "constexpr int kStatsLanes = %d;" % lanes)
        a, b = lane_src.index(DOUBLING[0]), lane_src.index(DOUBLING[1])
        texts["%d lanes, doubling" % lanes] = lane_src
        texts["%d lanes, walk" % lanes] = (lane_src[:a] + WALK_RUNS
                                           + lane_src[b:])
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = out / ("telo_stats_v%d.cu" % i)
        cu.write_text(text)
        so = out / ("libtelo_stats_v%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, err))
        entry, regs = "?", []
        for ln in err.splitlines():
            if "entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif "registers" in ln and "stats" in entry:
                regs.append("%s: %s" % (entry, ln.split(":", 1)[1].strip()))
        print("%s: ptxas %s" % (name, regs), flush=True)
        lib = ctypes.CDLL(str(so))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cornetto_telo_stats.restype = ci
        lib.cornetto_telo_stats.argtypes = [vp, cl, cl, ctypes.c_char_p, vp,
                                            ci, ci, ci, ci, vp, vp, vp, vp]
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_telo_stats: needs an NVIDIA GPU")
    from chip_smoke import TTAGGG, _telo_reads, graph_ms
    from cornetto_tpu_torch.kernels.telo import _steps_for, telo_run_stats_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    libs = build_variants()
    dev = torch.device("cuda")
    runs = [(name, lib, 0) for name, lib in libs.items()]
    runs.append(("row walk (first design)", libs["32 lanes, doubling"], 1))

    rng = np.random.default_rng([args.seed, 16])
    arrays = np.full((4096, 450), 4, dtype=np.uint8)
    for r in range(4096):
        c = int(rng.integers(1, 76))
        s = int(rng.integers(0, 450 - 6 * c + 1))
        arrays[r, s:s + 6 * c] = np.tile(np.array(TTAGGG, np.uint8), c)
    cases = [("(4096, 450) reads", _telo_reads(args.seed, 4096, 450)),
             ("(4096, 1800) reads", _telo_reads(args.seed, 4096, 1800)),
             ("(4096, 450) every read an array", arrays)]
    for label, host in cases:
        x = torch.from_numpy(host).to(dev)
        B, L = x.shape
        k = len(TTAGGG)
        outs = (torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))
        want = telo_run_stats_ref(x, TTAGGG)

        def launch(lib, route):
            err = lib.cornetto_telo_stats(
                x.data_ptr(), B, L, bytes(TTAGGG), None, k,
                _steps_for(L - k + 1, k), -(-24 // k), route,
                *(o.data_ptr() for o in outs),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit("CUDA error %d" % err)

        for name, lib, route in runs:
            for o in outs:
                o.zero_()
            launch(lib, route)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                raise SystemExit("%s differs from the plain version on %s"
                                 % (name, label))
        times = {name: [] for name, _, _ in runs}
        for name, lib, route in runs + runs[::-1]:
            times[name].append(graph_ms(lambda: launch(lib, route)))
        print("%s, TTAGGG, ms by graph replay in turns: %s (%s)"
              % (label, "; ".join("%s %.4f / %.4f" % (n, *t)
                                  for n, t in times.items()), card),
              flush=True)
    print(card)


if __name__ == "__main__":
    main()
