"""pytest plugin of the port's native sanitizer lane
(tests/test_torch_sanitize.py): before any test runs, it loads the JAX
package's native kernels, the port's tests' reference, from their plain
builds, so that every sanitizer report in the lane is one of the port's
copies.  The JAX package's own lane (tests/run_sanitized.sh) sanitizes
those."""

import os

# (name, source, cflags) as cornetto_tpu's modules load them
JAX_NATIVE = [
    ("minimizer_native", "minimizer_native.c", ("-O3",)),
    ("sdust_native", "sdust_native.c", ("-O2",)),
    ("fastq_pack", "fastq_pack.c", ("-O3",)),
    ("depth_write", "depth_write.c", ("-O3",)),
    ("tsv_format", "tsv_format.c", ("-O3",)),
    ("bedgraph_native", "bedgraph_native.c", ("-O3",)),
]


def pytest_configure(config):
    from cornetto_tpu import native
    flag = os.environ.pop("CORNETTO_NATIVE_SANITIZE", None)
    try:
        for name, source, cflags in JAX_NATIVE:
            assert native.load(name, source, cflags) is not None, name
    finally:
        if flag is not None:
            os.environ["CORNETTO_NATIVE_SANITIZE"] = flag
