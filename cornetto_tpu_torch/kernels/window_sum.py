"""Sliding-window sums and window depth statistics: counterpart of
cornetto_tpu/kernels/window_sum.py (window_stats_jax, _window_sums_strided)
and cornetto_tpu/kernels/pallas_window.py::sliding_window_sum_pallas.

``window_sums`` launches the hand-written CUDA kernel (csrc/window_sum.cu)
for tensors on a CUDA device and runs the plain PyTorch version
``window_sums_ref`` for tensors on the CPU; on a CUDA tensor it launches or
raises, never falls back.  ``window_stats`` is the boringbits window scan on
top of it, equal to ``window_stats_numpy`` for every window size (sums are
int64, so the JAX path's int32 limit of W <= 32767 does not apply).  PyTorch
runs eagerly, so there are no padded jit buckets.  ``n_windows`` and the
exact host twin ``window_stats_numpy`` are copies of the JAX module's.
"""

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.kernels import _build
from cornetto_tpu_torch.utils import logging as log
from cornetto_tpu_torch.utils.cformat import c_div

_KERNEL = "window_sum"
_DTYPES = {torch.int32: 0, torch.uint16: 1}


def n_windows(length: int, window_size: int, window_inc: int) -> int:
    """Reference window count (src/boringbits_main.c:338-339): C truncating
    division, clamped to >= 1."""
    n = c_div(length - window_size + window_inc - 1, window_inc) + 1
    return max(n, 1)


def window_stats_numpy(depth: np.ndarray, mq_depth: np.ndarray,
                       window_size: int, window_inc: int):
    """Returns (st, end, mean_depth, mean_mq_depth) int32 arrays, exact."""
    length = len(depth)
    nw = n_windows(length, window_size, window_inc)
    st = np.arange(nw, dtype=np.int64) * window_inc
    end = np.minimum(st + window_size, length)
    cs = np.zeros(length + 1, dtype=np.int64)
    np.cumsum(depth.astype(np.int64), out=cs[1:])
    cs_mq = np.zeros(length + 1, dtype=np.int64)
    np.cumsum(mq_depth.astype(np.int64), out=cs_mq[1:])
    div = end - st
    d = (cs[end] - cs[st]) // div
    mq = (cs_mq[end] - cs_mq[st]) // div
    return (st.astype(np.int32), end.astype(np.int32),
            d.astype(np.int32), mq.astype(np.int32))


def resolve_backend(backend: str) -> str:
    """'auto' -> 'torch' on device.resolve_device() (raises without a card
    unless CORNETTO_FORCE_CPU=1); 'numpy' keeps the host twin
    window_stats_numpy; 'jax' exits 1."""
    if backend == "jax":
        log.die("--backend jax is not available in cornetto_tpu_torch "
                "(auto or numpy)")
    if backend != "auto":
        return backend
    resolve_device()
    return "torch"


def _n_out(n: int, stride: int, n_out) -> int:
    return -(-n // stride) if n_out is None else int(n_out)


def window_sums_ref(x: torch.Tensor, window: int, stride: int = 1,
                    n_out=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result as
    ``window_sums``); runs on any device."""
    n = x.shape[-1]
    n_out = _n_out(n, stride, n_out)
    cs = torch.nn.functional.pad(x.to(torch.int64).cumsum(dim=-1), (1, 0))
    j = torch.arange(n_out, dtype=torch.int64, device=x.device) * stride
    return cs[..., (j + window).clamp(max=n)] - cs[..., j.clamp(max=n)]


def _check(x, window, stride, n_out) -> int:
    """Validates the arguments; returns n_out with its default filled in."""
    if not isinstance(x, torch.Tensor) or x.dim() not in (1, 2):
        raise ValueError("x must be a 1-D or 2-D tensor")
    if x.dtype not in _DTYPES:
        raise TypeError("x must be int32 or uint16 (got %s)" % x.dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not (1 <= window < 1 << 31 and 1 <= stride < 1 << 62):
        raise ValueError("window in 1..2^31-1 and stride >= 1 (got %d, %d)"
                         % (window, stride))
    n_out = _n_out(x.shape[-1], stride, n_out)
    if n_out < 1:
        raise ValueError("no window to sum (n_out=%d)" % n_out)
    if x.dim() == 2 and not 1 <= x.shape[0] <= 65535:
        raise ValueError("1..65535 rows (got %d)" % x.shape[0])
    return n_out


def window_sums(x: torch.Tensor, window: int, stride: int = 1,
                n_out=None) -> torch.Tensor:
    """x (n,) or (rows, n) int32 or uint16.  Returns int64 (..., n_out) with
    out[..., j] = sum(x[..., j*stride : min(j*stride + window, n)]), zero
    past the end; n_out defaults to ceil(n / stride).  With stride 1 this is
    sliding_window_sum_pallas's result.

    A CUDA input launches the kernel on the current stream without
    synchronising (one launch for all rows) and adds one to
    ``window_sums.launches``."""
    n_out = _check(x, window, stride, n_out)
    if x.device.type == "cpu":
        return window_sums_ref(x, window, stride, n_out)
    if x.device.type != "cuda":
        raise ValueError("unsupported device %s" % x.device)
    rows = 1 if x.dim() == 1 else x.shape[0]
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=torch.int64,
                      device=x.device)
    fn = _build.bind(_KERNEL, "cornetto_window_sums", "piilillpp")
    _build.launch(fn, "window_sums kernel", x.device, x.data_ptr(),
                  _DTYPES[x.dtype], rows, x.shape[-1], window, stride, n_out,
                  out.data_ptr())
    window_sums.launches += 1
    return out


window_sums.launches = 0


def _upload(depth: np.ndarray, mq_depth: np.ndarray, dev) -> torch.Tensor:
    """(2, n) tensor of the two tracks on dev: uint16 tracks (what the
    bedgraph parsers return) go up as they are, anything else as int32."""
    u16 = depth.dtype == mq_depth.dtype == np.uint16
    dt = np.uint16 if u16 else np.int32
    x = torch.empty((2, len(depth)),
                    dtype=torch.uint16 if u16 else torch.int32, device=dev)
    for row, a in zip(x, (depth, mq_depth)):
        row.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)))
    return x


def window_stats(depth: np.ndarray, mq_depth: np.ndarray, window_size: int,
                 window_inc: int):
    """Returns (st, end, mean_depth, mean_mq_depth) int32 numpy arrays,
    equal to window_stats_numpy: both tracks go up in one (2, n) tensor, one
    window_sums call sums them, the truncating division by the
    (end-clamped) window length runs on the device, and one readback
    returns the means.  Runs on device.resolve_device()."""
    length = len(depth)
    nw = n_windows(length, window_size, window_inc)
    dev = resolve_device()
    sums = window_sums(_upload(depth, mq_depth, dev), window_size,
                       window_inc, nw)
    st = np.arange(nw, dtype=np.int64) * window_inc
    end = np.minimum(st + window_size, length)
    div = torch.from_numpy(np.maximum(end - st, 1)).to(dev)
    means = torch.div(sums, div, rounding_mode="floor").to(torch.int32)
    d, mq = means.cpu().numpy()
    return st.astype(np.int32), end.astype(np.int32), d, mq
