"""The port's native C under ASan + UBSan: the counterpart of the JAX
package's sanitizer lane (``tests/run_sanitized.sh``) for the port's ctypes
glue, the buffer sizes and strides it hands the C kernels.

``CORNETTO_NATIVE_SANITIZE=1`` makes ``cornetto_tpu_torch.native`` build
every kernel with ``-fsanitize=address,undefined -fno-sanitize-recover=all
-g`` into ``build/native/_<name>.asan.so``.  The host python is not
ASan-linked, so each run here is a subprocess with libasan and libubsan
preloaded; any report aborts it.

- ``test_fastq_pack_sanitized_matches_plain`` (tier 1): crafted FASTQ
  batches through the sanitized and the plain ``fastq_pack.c``, same bytes.
- ``test_sdust_native_sanitized_matches_plain`` (tier 1): the SDUST DP on
  edge inputs; an input with nothing masked once passed NULL to memcpy.
- ``test_ragged_cases_are_valid`` (tier 1): every case of
  tests/_torch_ragged_cases.py (``chip_smoke.py --sanitize-cases``, the
  poisoned-allocator tests) is taken by its wrapper on the CPU.
- ``test_native_test_files_under_asan`` (slow tier, ``--runslow``): the
  port's test files that reach ``native.load``, whole, under the sanitizers
  (``-s``, so that a report is not lost with pytest's capture when the
  process aborts).  The JAX package's kernels, their reference, load from
  plain builds there (tests/_torch_plain_reference.py): its own lane,
  tests/run_sanitized.sh, sanitizes those.
"""

import json
import os
import subprocess
import sys

import pytest

from cornetto_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's test files whose code paths load a native kernel
NATIVE_TEST_FILES = [
    "tests/test_torch_stream.py",        # fastq_pack, tsv_format
    "tests/test_torch_decide.py",        # fastq_pack, minimizer_native
    "tests/test_torch_sdust.py",         # sdust_native
    "tests/test_torch_create_panel.py",  # bedgraph_native
    "tests/test_torch_coverage.py",      # fastq_pack, bedgraph_native
    "tests/test_torch_tools.py",         # depth_write, bedgraph_native, ...
    "tests/test_torch_chunks.py",        # minimizer_native, tsv_format
]

# crafted inputs: name -> FASTQ bytes
FASTQ_CASES = {
    "mixed": (b"@a\nACGTACGTAC\n+\nIIIIIIIIII\n"
              b"@long read longer than L\n" + b"ACGT" * 20 + b"\n+\n"
              + b"I" * 80 + b"\n"
              b"@empty\n\n+\n\n"
              b"@nrun\nACGNNNNNNNNNNTTGCA\n+\n" + b"I" * 18 + b"\n"
              b"@lead_trail_n\nNNACGTNN\n+\nIIIIIIII\n"
              b"@alln\nNNNNNNNNNNNNNNNNNNNNN\n+\n" + b"I" * 21 + b"\n"
              b"@lower\nacgtnacgt\n+\nIIIIIIIII\n"),
    "truncated_record": b"@a\nACGTACGT\n+\nIIIIIIII\n@b\nACGTAC\n+\n",
    "truncated_quality": b"@a\nACGTACGT\n+\nIIIIIIII\n@b\nACGTAC\n+\nIII",
    "no_final_newline": b"@a\nACGTACGTACGTACGTACG\n+\nIIIIIIIIIIIIIIIIIII",
    "only_empty": b"@e1\n\n+\n\n@e2\n\n+\n\n",
    "exact_L": b"@x\n" + b"ACGTN" * 3 + b"AC\n+\n" + b"I" * 17 + b"\n",
}

# packs every case at L = 17 (not a multiple of 4 or 8), 3 reads a batch,
# from 7-byte and whole-file chunks; prints one JSON object
PACK_SCRIPT = r"""
import hashlib, json, os, sys
from cornetto_tpu_torch import native
from cornetto_tpu_torch.native import fastq_pack as fp
res = {}
for name in sorted(os.listdir(sys.argv[1])):
    path = os.path.join(sys.argv[1], name)
    for chunk in (7, 1 << 20):
        h = hashlib.sha256()
        try:
            for pb in fp.iter_packed_batches(path, 3, 17, chunk=chunk):
                h.update(pb.packed[:pb.count].tobytes())
                h.update(b"-" if pb.nmask is None
                         else pb.nmask[:pb.count].tobytes())
                h.update(pb.lengths[:pb.count].tobytes())
                h.update("\t".join(pb.ids).encode())
            res["%s/%d" % (name, chunk)] = h.hexdigest()
        except fp.NativeParseError:
            res["%s/%d" % (name, chunk)] = "NativeParseError"
lib = native._LIBS.get("fastq_pack")
print(json.dumps({"lib": lib._name if lib is not None else None,
                  "out": res}))
"""


def _runtime(name: str) -> str:
    cc = os.environ.get("CC", "cc")
    try:
        out = subprocess.run([cc, "-print-file-name=" + name],
                             capture_output=True, text=True).stdout.strip()
    except OSError:
        return ""
    return out if os.path.isabs(out) else ""   # bare name: not installed


def _sanitized_env():
    asan, ubsan = _runtime("libasan.so"), _runtime("libubsan.so")
    if not asan or not ubsan:
        pytest.skip("libasan.so / libubsan.so not installed "
                    "(cc -print-file-name returns the bare name)")
    env = dict(os.environ)
    env.update(
        CORNETTO_NATIVE_SANITIZE="1",
        LD_PRELOAD="%s %s" % (asan, ubsan),
        ASAN_OPTIONS="detect_leaks=0:halt_on_error=1:abort_on_error=1",
        UBSAN_OPTIONS="halt_on_error=1:abort_on_error=1:print_stacktrace=1",
        CORNETTO_FORCE_CPU="1")
    return env


# the SDUST DP on edge inputs (nothing masked, all N, empty, a result
# list past the wrapper's first guess); prints one JSON object
SDUST_SCRIPT = r"""
import json
import numpy as np
from cornetto_tpu_torch import native
from cornetto_tpu_torch.native.sdust import sdust
rng = np.random.default_rng(3)
rand = bytes(np.array(list(b"ACGT"), dtype=np.uint8)[rng.integers(0, 4, 3000)])
seqs = [b"", b"A", b"ACG", b"N" * 500, rand, b"A" * 2000,
        b"ATTCC" * 400 + b"N" * 7 + b"ACGT" * 30,
        b"".join(b"AAAAAAAAAAAAAAAAAAAAAAA" + bytes([c]) for c in rand[:600])]
res = [sdust(s, T=T, W=W) for s in seqs for T, W in ((20, 64), (5, 3))]
lib = native._LIBS.get("sdust_native")
print(json.dumps({"lib": lib._name if lib is not None else None,
                  "out": res}))
"""


def _run(script, arg, env):
    proc = subprocess.run([sys.executable, "-c", script, arg], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _plain(env):
    return {k: v for k, v in env.items()
            if k not in ("CORNETTO_NATIVE_SANITIZE", "LD_PRELOAD")}


def test_fastq_pack_sanitized_matches_plain(tmp_path):
    env = _sanitized_env()
    (tmp_path / "fq").mkdir()
    for name, data in FASTQ_CASES.items():
        (tmp_path / "fq" / (name + ".fq")).write_bytes(data)
    san = _run(PACK_SCRIPT, str(tmp_path / "fq"), env)
    plain = _run(PACK_SCRIPT, str(tmp_path / "fq"), _plain(env))
    assert san["lib"] == os.path.join(native.BUILD_DIR,
                                      "_fastq_pack.asan.so")
    assert plain["lib"] == os.path.join(native.BUILD_DIR, "_fastq_pack.so")
    assert san["out"] == plain["out"]
    # the native parser took every well-formed case (a parse error sends
    # the caller to the Python parser, which would hide the C path)
    assert san["out"]["mixed.fq/7"] != "NativeParseError"
    assert san["out"]["only_empty.fq/1048576"] != "NativeParseError"



def test_sdust_native_sanitized_matches_plain():
    env = _sanitized_env()
    san = _run(SDUST_SCRIPT, "", env)
    plain = _run(SDUST_SCRIPT, "", _plain(env))
    assert san["lib"] == os.path.join(native.BUILD_DIR,
                                      "_sdust_native.asan.so")
    assert plain["lib"] == os.path.join(native.BUILD_DIR,
                                        "_sdust_native.so")
    assert san["out"] == plain["out"]
    assert san["out"][6] == [] and san["out"][10] == [[0, 2000]]


@pytest.mark.slow
def test_native_test_files_under_asan():
    env = _sanitized_env()
    env.pop("CORNETTO_FORCE_CPU")   # the test files set what they need
    env["PYTHONPATH"] = os.path.join(ROOT, "tests")   # the plugin
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-x", "-q", "-s", "-p",
         "no:cacheprovider", "-p", "no:randomly", "-p",
         "_torch_plain_reference", *NATIVE_TEST_FILES],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, (proc.stdout[-6000:], proc.stderr[-6000:])
    for name in ("fastq_pack", "tsv_format", "sdust_native",
                 "bedgraph_native", "minimizer_native", "depth_write"):
        assert os.path.exists(os.path.join(native.BUILD_DIR,
                                           "_%s.asan.so" % name)), name



def test_ragged_cases_are_valid():
    """Each ragged case's inputs pass its wrapper's checks and give the
    plain version's result on the CPU (the card runs the same cases)."""
    import torch
    import _torch_ragged_cases as rc
    assert {n.split("_")[0] for n in rc.CASES} == {
        "decide", "extract", "window", "sdust", "mask", "positions",
        "stats", "votes", "policy"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in rc.CASES:
            assert rc.check(name, torch.device("cpu")) == [], name
    finally:
        torch.set_num_threads(threads)
