"""The device's idle share of the annotation window: 100 x (1 - busy /
window), busy the union of the kernels', copies' and sets' time
(torch.profiler)."""

from portbench import harness


def read(run):
    return harness.idle_pct(run)
