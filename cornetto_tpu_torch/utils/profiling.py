"""Profiling hooks of the port: counterpart of
cornetto_tpu/utils/profiling.py (a jax.profiler trace around a region).
The reference exposes a --profile-cpu sectional-timing knob
(reference: src/cornetto.c:252-272); here CORNETTO_PROFILE=<dir> wraps the
region in a torch.profiler trace (``maybe_trace``).

``span(name)`` marks a part of the program in whatever torch profiler is
recording (``maybe_trace``'s, or any other): a ``record_function`` named
``cornetto.<name>``, so the span lies in the same trace as the card's
kernels and copies, on one clock, and an entry of an in-memory tally
(``tally()``: calls, total and self seconds, summed counts) that a reader
of the trace's numbers can take without parsing it.  With no profiler
recording a span costs one check and records nothing.  ``lap`` is a span
that also keeps a call's per-part seconds for its ``stats=`` dict.
"""

import contextlib
import os
import threading
import time

import torch

from cornetto_tpu_torch.utils import logging as log

PREFIX = "cornetto."

_tally = {}                  # span name -> its entry (see tally())
_lock = threading.Lock()
_local = threading.local()   # .stack: the recording spans entered


@contextlib.contextmanager
def maybe_trace(tag: str):
    """With CORNETTO_PROFILE=<dir> set, a torch.profiler trace of the
    region (the CPU, and the card's CUDA activity when the port's device is
    ``cuda``: a card is present and CORNETTO_FORCE_CPU is not 1) exported
    as a Chrome trace under <dir>/<tag>/; always logs the section's wall
    time at VERBOSE level (the reference's sectional timers)."""
    trace_dir = os.environ.get("CORNETTO_PROFILE")
    t0 = time.time()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if os.environ.get("CORNETTO_FORCE_CPU") != "1" \
                and torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        out = os.path.join(trace_dir, tag)
        os.makedirs(out, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
    else:
        yield
    log.verbose("%s in %.2f seconds" % (tag, time.time() - t0))


class _Off:
    """The span of a region that nothing records: shared, does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    """A recorded span, and/or a lap of a call's ``stats``."""

    __slots__ = ("name", "counts", "stats", "device", "_rf", "_parent",
                 "_t0", "_child")

    def __init__(self, name: str, counts: dict, stats=None, device=None):
        self.name, self.counts = name, counts
        self.stats, self.device = stats, device
        self._rf = self._parent = None

    def count(self, **counts) -> None:
        """Add integer counts to the span's (known only inside it)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            from torch.profiler import record_function
            self._rf = record_function(PREFIX + self.name)
            self._rf.__enter__()
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            self._parent = stack[-1] if stack else None
            stack.append(self)
        self._child = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.stats is not None and self.device is not None \
                and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        if self.stats is not None:
            key = self.name.rsplit(".", 1)[-1]
            self.stats[key] = self.stats.get(key, 0.0) + dt
        if self._rf is not None:
            _local.stack.pop()
            parent = self._parent
            if parent is not None:
                parent._child += dt
            with _lock:
                e = _tally.get(self.name)
                if e is None:
                    e = _tally[self.name] = dict(
                        calls=0, total_s=0.0, self_s=0.0, counts={},
                        parent=parent.name if parent is not None else None)
                e["calls"] += 1
                e["total_s"] += dt
                e["self_s"] += dt - self._child
                for k, v in self.counts.items():
                    e["counts"][k] = e["counts"].get(k, 0) + int(v)
            self._rf.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a torch profiler records, so that spans are recorded: for a
    count that costs something to work out."""
    return torch.autograd._profiler_enabled()


def span(name: str, **counts):
    """A context that marks the region as the span ``name`` while a torch
    profiler records: ``record_function("cornetto." + name)`` and the
    tally's entry of ``name`` (one call, its seconds, the sums of the
    integer ``counts``, and more through ``count()`` inside).  With no
    profiler recording it is a shared no-op.  A span never synchronises the
    card: on a card it times the host's part, and the trace shows the
    device's."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, counts)


def lap(name: str, stats: dict = None, device=None):
    """``span(name)`` over one part of a call that keeps per-part seconds:
    where ``stats`` is given, the part's seconds are added to
    stats[<the last dotted part of name>] (``sdust.plan`` -> ``plan``),
    after synchronising ``device`` at the part's end when it is a card,
    whether or not a profiler records.  One clock times both."""
    if stats is None:
        return span(name)
    return _Span(name, {}, stats, device)


def tally() -> dict:
    """The spans recorded since the last reset(): name -> {"calls",
    "total_s", "self_s" (total_s less the time of spans inside it),
    "counts" (name -> sum), "parent" (the span it first ran inside, or
    None)}."""
    with _lock:
        return {k: dict(v, counts=dict(v["counts"]))
                for k, v in _tally.items()}


def reset() -> None:
    """Forget the tally."""
    with _lock:
        _tally.clear()


def log_tally() -> None:
    """The tally at VERBOSE level: each span's calls and self seconds."""
    for name, e in sorted(tally().items(), key=lambda kv: -kv[1]["self_s"]):
        log.verbose("span %s: %d calls, %.3f s self" % (
            name, e["calls"], e["self_s"]))
