#!/usr/bin/env python3
"""The telomere-mask kernel's design choices timed on the card.

    python3 bench_telo_mask.py [--seed N]

Needs one NVIDIA GPU with the CUDA toolkit (nvcc); run from the root of a
checkout.  Builds variants of cornetto_tpu_torch/csrc/telo.cu, in parallel,
into build/kernels/variants/, each differing from the source in one
constant:

- kGroups, the groups of 16 positions a thread owns: 1, 2 (the source), 4
  and 8.  More groups put more bytes in flight a block and leave fewer
  blocks an SM;
- the dispatch on the motif length: the 16-code instance for k <= 16 and
  the 64-code one above (the source), or the 64-code one for every k.

Each variant's mask of a seeded chr1-long row (248,956,422 codes 0-4) is
held equal to the plain PyTorch version, then the variants are timed with
CUDA events in turns (a, b, ..., b, a) at k = 1, 6, 16, 37 and 100, the
launch alone (motif already on the card).  Prints one line a case, the
card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
GROUPS = "constexpr int kGroups = 2;"
DISPATCH = "if (k <= 16)"


def build_variants():
    """{name: ctypes library} of every variant, one nvcc each, together."""
    from cornetto_tpu_torch.kernels import _build
    src = (_build.CSRC / "telo.cu").read_text()
    if GROUPS not in src or DISPATCH not in src:
        raise SystemExit("bench_telo_mask: telo.cu no longer has '%s' and "
                         "'%s'" % (GROUPS, DISPATCH))
    texts = {"groups=%d" % g:
             src.replace(GROUPS, "constexpr int kGroups = %d;" % g)
             for g in (1, 2, 4, 8)}
    texts["64-code instance for every k"] = src.replace(DISPATCH,
                                                         "if (k <= 0)")
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = out / ("telo_v%d.cu" % i)
        cu.write_text(text)
        so = out / ("libtelo_v%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, err))
        regs = [ln.split(":", 1)[1].strip() for ln in err.splitlines()
                if "registers" in ln]
        print("%s: ptxas %s" % (name, regs), flush=True)
        lib = ctypes.CDLL(str(so))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cornetto_telo_mask.restype = ci
        lib.cornetto_telo_mask.argtypes = [vp, cl, cl, vp, ci, vp, vp]
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
        raise SystemExit("bench_telo_mask: needs an NVIDIA GPU")
    from chip_smoke import GRCH38, TTAGGG, cuda_ms
    from cornetto_tpu_torch.kernels.telo import telo_match_mask_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    row = torch.randint(0, 5, (1, GRCH38[0]), generator=gen, device=dev,
                        dtype=torch.uint8)
    out = torch.empty(row.shape, dtype=torch.int8, device=dev)

    def launch(name, mt):
        err = libs[name].cornetto_telo_mask(
            row.data_ptr(), 1, row.shape[1], mt.data_ptr(), mt.numel(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit("%s: CUDA error %d" % (name, err))
        return out

    rng = np.random.default_rng([args.seed, 15])
    for k in (1, 6, 16, 37, 100):
        motif = TTAGGG if k == 6 else tuple(rng.integers(0, 4, k).tolist())
        mt = torch.tensor(motif, dtype=torch.uint8, device=dev)
        ref = telo_match_mask_ref(row, motif)
        for name in libs:
            if not torch.equal(launch(name, mt), ref):
                raise SystemExit("%s differs from the plain version at k = "
                                 "%d" % (name, k))
        del ref
        names = list(libs)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cuda_ms(lambda: launch(name, mt), 30,
                                       warmup=5))
        print("chr1 (1, %d), k = %d, ms in turns: %s (%s)"
              % (GRCH38[0], k, "; ".join("%s %.4f / %.4f" % (n, *t)
                                         for n, t in times.items()), card),
              flush=True)
    print(card)


if __name__ == "__main__":
    main()
