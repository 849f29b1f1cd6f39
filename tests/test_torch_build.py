"""The CUDA kernel build cache (cornetto_tpu_torch/kernels/_build.py): a
built library's name carries a hash of its ``.cu`` source, of the shared
headers ``csrc/*.cuh`` and of the nvcc flags, so editing only a header
that a kernel includes rebuilds it rather than loading a stale library.
Needs no nvcc: only the library's path is computed."""

import hashlib

import pytest

from cornetto_tpu_torch.kernels import _build

KERNELS = ("extract_minima", "window_sum", "sdust", "telo", "decide")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "x.cu").write_text('#include "h.cuh"\nint x;\n')
    (tmp_path / "y.cu").write_text("int y;\n")
    (tmp_path / "h.cuh").write_text("int h = 1;\n")
    return tmp_path


def _source_only_key(csrc, name):
    """The key before headers were hashed: the .cu bytes and the flags."""
    return hashlib.sha256((csrc / (name + ".cu")).read_bytes() + " ".join(
        _build.NVCC_FLAGS).encode()).hexdigest()[:16]


def test_editing_only_a_header_changes_the_library(csrc):
    before, old_before = _build.library_path("x"), _source_only_key(csrc,
                                                                     "x")
    (csrc / "h.cuh").write_text("int h = 2;\n")
    after = _build.library_path("x")
    # the fault: a key of the source alone does not see the header
    assert _source_only_key(csrc, "x") == old_before
    # the repair
    assert after != before
    assert after.parent == csrc / "build"
    assert after.name.startswith("libx-") and after.suffix == ".so"
    (csrc / "h.cuh").write_text("int h = 1;\n")
    assert _build.library_path("x") == before          # same bytes, same key


def test_key_follows_source_flags_and_new_headers(csrc, monkeypatch):
    base = _build.library_path("x")
    (csrc / "x.cu").write_text('#include "h.cuh"\nint x2;\n')
    edited = _build.library_path("x")
    assert edited != base
    (csrc / "g.cuh").write_text("int g;\n")
    assert _build.library_path("x") != edited
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("x") != _build.library_path("y") != base
    assert _build.library_path("x").name.startswith("libx-")


def test_the_ports_kernels_have_sources_and_distinct_libraries():
    paths = [_build.library_path(n) for n in KERNELS]
    assert len(set(paths)) == len(KERNELS)
    for name, p in zip(KERNELS, paths):
        assert (_build.CSRC / (name + ".cu")).exists()
        assert p.parent == _build.BUILD_DIR
    for name in ("extract_minima", "decide"):
        src = (_build.CSRC / (name + ".cu")).read_text()
        assert '#include "minimizer.cuh"' in src
