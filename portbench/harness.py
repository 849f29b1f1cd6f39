"""The benchmark's shared machinery: the registry of cells, configurations,
traffic mixes and per-layer readers (all found by name under portbench/),
seeds, the run record, host spans and the reduction of a torch.profiler
trace to busy time, idle gaps and kernel times.

Nothing here imports the program under test (cornetto_tpu_torch) or JAX.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# seed streams: one number a use, so no two uses draw the same numbers
DRAFT, REPEAT, PANEL, READS, CHECK, FEATURES, WARMUP = range(1, 8)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json."""
    for w in load_json(root / "BENCHMARK.json")["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def metrics_of(name: str, root: Path = ROOT):
    """(end_to_end, per_layer) metric entries that the cell reports: those
    whose "workloads" name it, or that have no "workloads" key."""
    bench = load_json(root / "BENCHMARK.json")

    def mine(m):
        return name in m.get("workloads", [name])
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "portbench" / "configs" / (name + ".json"))


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "portbench" / "traffic" / (name + ".json"))


def runner(name: str):
    """portbench/runners/<name>.py: the code that drives one kind of
    traffic through the program."""
    return importlib.import_module("portbench.runners." + name)


def layer_reader(metric: str, root: Path = ROOT):
    """portbench/layers/<metric>.py's read(run) -> number or None."""
    path = root / "portbench" / "layers" / (metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_layer_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for one use of one seed."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit torch.Generator seed for one use of one seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def percentile(values, weights, q: float) -> float:
    """The q-quantile of values each repeated weights times (nearest rank,
    the smallest value with at least q of the weight at or below it)."""
    v = np.asarray(values, dtype=np.float64)
    w = np.asarray(weights, dtype=np.int64)
    order = np.argsort(v, kind="stable")
    cum = np.cumsum(w[order])
    k = int(np.searchsorted(cum, q * cum[-1], side="left"))
    return float(v[order][min(k, len(v) - 1)])


def idle_pct(run) -> float:
    """The device's idle share of the traced window, in %."""
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_pct(run, nbytes: float, ops: float, *kernels: str):
    """The kernels' roofline share over the traced window in %, None where
    they did not run."""
    from portbench import roofline
    t = run.trace.kernel_s(*kernels)
    return 100.0 * roofline.bound_s(nbytes, ops) / t if t > 0 else None


class Run:
    """One run of one cell: its inputs, and what the run measures, checks
    and counts, for run.py to print and the per-layer readers to read."""

    def __init__(self, cell, cfg, mix, seed, seconds, trace, device):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.device = device
        self.setup = {}          # set-up part -> seconds
        self.metrics = {}        # end-to-end metric -> value
        self.checks = []         # (name, value, limit): value <= limit
        self.attempted = self.failed = 0
        self.counts = {}         # the runner's counts for the readers
        self.trace = None        # Trace after a traced window

    def part(self, name: str):
        """Time a set-up part into self.setup."""
        return _Lap(self.setup, name, self.device)


class _Lap:
    def __init__(self, acc, name, device):
        self.acc, self.name, self.device = acc, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        sync(self.device)
        self.acc[self.name] = self.acc.get(self.name, 0.0) + \
            time.perf_counter() - self.t0


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def thread_ticks() -> dict:
    """Clock ticks of user and system time of each of this process's
    threads so far, by (thread id, name), from /proc/self/task."""
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open("/proc/self/task/%s/stat" % tid) as f:
                s = f.read()
        except OSError:
            continue
        name = s[s.index("(") + 1:s.rindex(")")]
        f = s[s.rindex(")") + 2:].split()
        out[(tid, name)] = int(f[11]) + int(f[12])
    return out


class HostMeter:
    """The host's side of a window: the share of it in which the process
    and its main thread ran on a core, the busiest threads, and the time and
    number of Python's garbage collections."""

    def __init__(self):
        self.gc_s, self.gc_n, self._gc_t0 = 0.0, [0, 0, 0], None
        self.summary = {}

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n[info["generation"]] += 1
            self._gc_t0 = None

    def __enter__(self):
        gc.callbacks.append(self._gc)
        self._threads = thread_ticks()
        self._t0 = (time.perf_counter(), time.process_time(),
                    time.thread_time())
        return self

    def __exit__(self, *exc):
        t1 = (time.perf_counter(), time.process_time(), time.thread_time())
        gc.callbacks.remove(self._gc)
        threads = thread_ticks()
        wall = t1[0] - self._t0[0]
        hz = os.sysconf("SC_CLK_TCK")
        busiest = sorted(((round((t - self._threads.get(k, 0)) / hz / wall,
                                 3), k[1]) for k, t in threads.items()),
                         reverse=True)[:6]
        self.summary = dict(
            wall_s=round(wall, 3),
            process_cpu_share=round((t1[1] - self._t0[1]) / wall, 4),
            main_thread_cpu_share=round((t1[2] - self._t0[2]) / wall, 4),
            busiest_threads=[[n, c] for c, n in busiest],
            threads=len(threads), cores=os.cpu_count(),
            gc_s=round(self.gc_s, 4), gc_by_generation=self.gc_n)


class Trace:
    """torch.profiler over what a traced run's window traces (the runner
    opens it, a no-op in other runs): the traced window and the runner's
    host spans are CPU annotations, so device activity and host spans
    share one clock.  After the window: busy_s
    (the union of kernel, copy and set time inside the window), window_s,
    the device time of each kernel, and the idle gaps by the host span
    they fell in."""

    WINDOW = "pb:window"

    def __init__(self, on: bool, device):
        self.on, self.device = on, device
        self.active = False      # the profiler is recording
        self.busy_s = self.window_s = None
        self.kernels = {}        # device operation name -> seconds
        self.idle_by_span = {}   # host span -> idle seconds inside it

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.active = True
            try:
                with record_function(self.WINDOW):
                    yield
                sync(self.device)
            finally:
                self.active = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._reduce(prof.profiler.kineto_results.events())

    def span(self, name: str):
        """A host span (while the profiler records; free otherwise)."""
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function("pb:" + name)

    def kernel_s(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(s for n, s in self.kernels.items()
                   if any(x in n for x in needles))

    def _reduce(self, events) -> None:
        spans, dev = [], []
        w0 = w1 = None
        for e in events:
            name = e.name()
            if e.device_type().name == "CPU":
                if name == self.WINDOW:
                    w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
                elif name.startswith("pb:"):
                    spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                  name[3:]))
            elif not e.is_user_annotation() \
                    and not name.startswith("Activity Buffer"):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name))
        if w0 is None:
            raise RuntimeError("the profiler recorded no window")
        self.window_s = (w1 - w0) * 1e-9
        busy = 0
        gaps = []
        cur = w0
        for s, t, name in sorted(dev):
            self.kernels[name] = self.kernels.get(name, 0.0) + (t - s) * 1e-9
            s, t = max(s, w0), min(t, w1)
            if t <= cur:
                continue
            if s > cur:
                gaps.append((cur, s))
            busy += t - max(s, cur)
            cur = t
        if cur < w1:
            gaps.append((cur, w1))
        self.busy_s = busy * 1e-9
        self.idle_by_span = _attribute(gaps, spans)


def _attribute(gaps, spans):
    """Idle seconds by the innermost host span over each gap's midpoint
    ("other" where none is)."""
    out = {}
    spans.sort()
    starts = np.array([s for s, _, _ in spans], dtype=np.int64)
    for a, b in gaps:
        mid = (a + b) // 2
        label = "other"
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        # spans nest, so the covering span that starts last is the
        # innermost; the runners' spans tile the window, so it is near
        for j in range(i, max(i - 64, -1), -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return out
