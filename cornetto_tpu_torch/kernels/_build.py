"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface; it is compiled with nvcc
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the root of the checkout, at first use, and loaded with ctypes.  The
library's file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header rebuilds.  A
failed build raises: nothing falls back to a plain version on a CUDA tensor.

Every entry point returns an int; one that launches returns a cudaError_t
and takes the stream as its last argument.  ``bind`` types an entry point,
``launch`` calls one on a device's current stream and raises on a nonzero
return.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -lineinfo adds the line tables that let compute-sanitizer's reports name
# a .cu line; it leaves the generated code as it is
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs = {}
# argument letters of bind -> ctypes type
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "s": ctypes.c_char_p}
# name -> (seconds, nvcc's stderr incl. the -Xptxas -v register report)
# for kernels built by this process
build_info = {}


def nvcc_path() -> str:
    """The nvcc of the CUDA toolkit PyTorch found, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build cornetto_tpu_torch/csrc kernels")
    return found


def library_path(name: str) -> Path:
    """build/kernels/lib<name>-<key>.so, the key a hash of csrc/<name>.cu,
    the headers it may include and the flags."""
    h = hashlib.sha256((CSRC / (name + ".cu")).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / ("lib%s-%s.so" % (name, key))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / (name + ".cu"))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s (exit %d):\n%s\n%s"
                               % (name, proc.returncode, " ".join(cmd),
                                  proc.stderr))
        os.replace(tmp, so)    # atomic: concurrent builds agree
        build_info[name] = (time.perf_counter() - t0, proc.stderr)
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    return lib


def bind(name: str, entry: str, args: str):
    """Entry point ``entry`` of ``csrc/<name>.cu`` (built and loaded at first
    use), typed on first use: returns int, one argument a letter of
    ``args`` (p a pointer, i an int, l a long long, s a char pointer)."""
    fn = getattr(load(name), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in args]
    return fn


def launch(fn, what: str, device, *args) -> None:
    """Call a bound entry point with ``args`` and the current stream of
    ``device``, without synchronising; a nonzero return raises."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (what, err))
