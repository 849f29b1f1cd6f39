"""The telomere mask kernel's (csrc/telo.cu mask_kernel) roofline share over
the annotation window: the least time of finding both strands' matches
in every job's contig (roofline.telo_mask_work: the codes read once, the
match positions written) over the kernel's device time."""

from portbench import harness


def read(run):
    if "telo_mask_bytes" not in run.counts:
        return None
    return harness.roofline_pct(run, run.counts["telo_mask_bytes"],
                                run.counts["telo_mask_ops"], "mask_kernel")
