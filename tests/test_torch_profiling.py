"""The port's profiling hook (cornetto_tpu_torch/utils/profiling.py)
against the JAX package's test of its own (tests/test_kernels_misc.py::
test_maybe_trace_logs), and its torch.profiler trace on the CPU."""

import json

import torch

from cornetto_tpu_torch.utils.profiling import maybe_trace


def test_maybe_trace_logs(capsys, monkeypatch):
    monkeypatch.delenv("CORNETTO_PROFILE", raising=False)
    with maybe_trace("unit-test-section"):
        pass
    err = capsys.readouterr().err
    assert "unit-test-section in" in err


def test_maybe_trace_writes_a_chrome_trace(capsys, monkeypatch, tmp_path):
    """CORNETTO_PROFILE=<dir>: the region's torch.profiler trace lands in
    <dir>/<tag>/trace.json (CPU activity only when the device is the
    CPU), and the wall time is logged as without it."""
    monkeypatch.setenv("CORNETTO_PROFILE", str(tmp_path))
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    with maybe_trace("traced-section"):
        torch.arange(1000, dtype=torch.int64).sum()
    events = json.loads((tmp_path / "traced-section" / "trace.json")
                        .read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    assert "traced-section in" in capsys.readouterr().err
