"""The SDUST kernels' (csrc/sdust.cu, light and heavy pass) roofline share
over the annotation window: the least time of the DP over the jobs' bases
(roofline.sdust_work; find_perfect's row-steps are left out, so this is a
lower bound of the share) over the two kernels' device time."""

from portbench import harness, roofline


def read(run):
    nbytes, ops = roofline.sdust_work(run.counts["bases"],
                                      run.counts["sdust_rows"])
    return harness.roofline_pct(run, nbytes, ops, "sdust_light_kernel",
                                "sdust_heavy_kernel")
