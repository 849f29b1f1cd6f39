"""The share of `telofind`'s time that the FASTA read (io/fasta.py) and the
uppercase and encode take: the "read" and "encode" parts of
tools.telofind.run(stats=) over the jobs' telofind seconds, in %."""


def read(run):
    stats = run.counts.get("telofind_stats")
    if not stats or not run.counts["telofind_s"]:
        return None
    return 100.0 * (stats.get("read", 0.0) + stats.get("encode", 0.0)) \
        / run.counts["telofind_s"]
