"""The 95th percentile, over every chunk handed in during the first half of
the traced read-until run (timed with the profiler off), of the time from
handing it to DeviceChunkEngine.process() to its decision coming back
(that call returns it), host clock.  The closed loop runs at the engine's
capacity, so its tail is a per-layer metric with no bound, not an
end-to-end one."""


def read(run):
    return run.counts["decision_p95_ms"]
