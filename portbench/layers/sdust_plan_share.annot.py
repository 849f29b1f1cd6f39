"""The share of `sdust`'s time that its chunk planner takes
(kernels/sdust_chunked.py plan_chunks and the row layout): the "plan" part
of tools.sdust.run(stats=) over the jobs' sdust seconds, in %."""


def read(run):
    stats = run.counts.get("sdust_stats")
    if not stats or not run.counts["sdust_s"]:
        return None
    return 100.0 * stats.get("plan", 0.0) / run.counts["sdust_s"]
