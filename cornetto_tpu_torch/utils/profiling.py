"""Profiling hook of the port: counterpart of
cornetto_tpu/utils/profiling.py (a jax.profiler trace around a region).
The reference exposes a --profile-cpu sectional-timing knob
(reference: src/cornetto.c:252-272); here CORNETTO_PROFILE=<dir> wraps the
region in a torch.profiler trace."""

import contextlib
import os
import time

import torch

from cornetto_tpu_torch.utils import logging as log


@contextlib.contextmanager
def maybe_trace(tag: str):
    """With CORNETTO_PROFILE=<dir> set, a torch.profiler trace of the
    region (the CPU, and the card's CUDA activity when the port's device is
    ``cuda``: a card is present and CORNETTO_FORCE_CPU is not 1) exported as a Chrome trace under <dir>/<tag>/; always logs
    the section's wall time at VERBOSE level (the reference's sectional
    timers)."""
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
