#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port (cornetto_tpu_torch).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  The cell
is BENCHMARK.json's entry of that name; its configuration is
portbench/configs/<config>.json, its traffic mix portbench/traffic/
<traffic>.json, whose "runner" names the module of portbench/runners/ that
sets up, drives and checks it, and each per-layer metric is read by
portbench/layers/<metric>.py.

A run sets up (timed from the start of this script: imports, the card, the
runner's parts), measures for --seconds, reads the card's memory peak,
frees the program's state, checks what the window produced against the
plain reference, and prints one JSON line last on stdout: with --trace 0
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, busy
and window seconds and a breakdown (the runner's window opens
torch.profiler over what it traces).  The checks, each number beside its
limit, are also the last lines on stderr.  Run as a script, it keeps numpy
and torch to one intra-op thread.  Exit 2 without enough cards, 3
if JAX or the JAX package was loaded; no result is printed then.

--control puts the cell's control (the reference with one guarantee of
the configuration broken) in the program's place for the check, which
has to print correct: false; the benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # One intra-op thread, waiting passively, before numpy and torch load:
    # torch's idle OpenMP workers otherwise spin at about half a core each
    # after every parallel copy, beside the main thread that the host-bound
    # cells time, and its speed then swings by half within a run.
    os.environ.update(OMP_NUM_THREADS="1", OMP_WAIT_POLICY="PASSIVE",
                      OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "cornetto_tpu"}
TOP = 10          # entries of each breakdown list


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the cell's control in the program's place "
                   "(it has to come out not correct); the benchmark's own "
                   "runs never pass this")
    return p.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line(device) -> str:
    import torch
    if device.type != "cuda":
        return "device: cpu (no card)"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "power limit not measured"
    return "device: %s (%s), torch %s, CUDA %s" % (
        torch.cuda.get_device_name(device), limit, torch.__version__,
        torch.version.cuda)


def main(argv=None, allow_cpu: bool = False, root: Path = ROOT) -> int:
    """allow_cpu: run on the CPU where no card is found, and root: read
    BENCHMARK.json and portbench's data files there (tests only, with
    CORNETTO_FORCE_CPU=1 so that the port takes its plain versions)."""
    a = parse(argv)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    import torch
    cell = harness.cell(a.workload, root)
    cfg = harness.config(cell["config"], root)
    mix = harness.traffic(cell["traffic"], root)
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= cell["chips"]:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        sys.stderr.write("portbench: %s needs %d CUDA device(s), found %d\n"
                         % (a.workload, cell["chips"],
                            torch.cuda.device_count()
                            if torch.cuda.is_available() else 0))
        return 2
    print(card_line(device), flush=True)
    run = harness.Run(cell, cfg, mix, a.seed, a.seconds, a.trace == 1,
                      device)
    rnr = harness.runner(mix["runner"])
    t_import = time.perf_counter() - T_START
    st = rnr.setup(run)
    run.trace = harness.Trace(run.trace_on, device)
    harness.sync(device)
    setup_s = time.perf_counter() - T_START
    print("setup: %.3f s = imports and card %.3f s + %s" % (
        setup_s, t_import, " + ".join("%s %.3f s" % kv
                                      for kv in run.setup.items())),
          flush=True)
    rnr.window(run, st)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    rnr.release(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rnr.check(run, st, control=a.control)
    print("check: %.3f s; counts %s" % (
        time.perf_counter() - t,
        json.dumps({k: v for k, v in run.counts.items()
                    if not isinstance(v, (list, dict))})), flush=True)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write("portbench: loaded %s\n" % ", ".join(bad))
        return 3
    e2e, per_layer = harness.metrics_of(a.workload, root)
    metrics = {}
    if run.trace_on:
        for m in per_layer:
            v = harness.layer_reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        run.metrics["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": run.metrics[m["name"]],
                                  "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in run.checks)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace_on:
        tr = run.trace
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in tr.kernels.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": sorted(([n, s] for n, s in tr.idle_by_span.items()),
                                key=lambda x: -x[1])[:TOP]}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    for n, v, lim in run.checks:
        sys.stderr.write("check %s: %s (limit %s)%s\n"
                         % (n, v, lim, "" if v <= lim else " FAILED"))
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
