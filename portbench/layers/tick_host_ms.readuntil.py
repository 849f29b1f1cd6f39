"""The mean time of a tick's DeviceChunkEngine.process() call over the
first half of the traced run (timed with the profiler off), the
benchmark's span around it (host clock): staging, upload, the fused step
and the decisions' readback and resolve."""


def read(run):
    return run.counts["tick_host_ms"]
