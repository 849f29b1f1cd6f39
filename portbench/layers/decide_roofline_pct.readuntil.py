"""The fused decision kernel's (csrc/decide.cu) roofline share over the
traced half of the read-until run: the least time of the rows its ticks
decided (roofline.decide_work: a row a channel handed a chunk, its
prefix's length) over the kernel's device time (torch.profiler)."""

from portbench import harness, roofline


def read(run):
    cl, ix = run.mix["chunk_len"], run.cfg["index"]
    rows = {n * cl: c for n, c in
            enumerate(run.counts["decide_rows_by_chunks"]) if n and c}
    L = cl * run.cfg["policy"]["max_chunks"]
    nbytes, ops = roofline.decide_work(rows, L, ix["k"], ix["w"],
                                       ix["two_choice"])
    return harness.roofline_pct(run, nbytes, ops, "decide_kernel")
