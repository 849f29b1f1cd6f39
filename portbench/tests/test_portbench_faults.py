"""Each cell's checks fail their control and the faults the cell can have:
runs of the tiny cells on the CPU with the timed path broken underneath
come out not correct, and so do runs that judge the cell's control (the
reference with a guarantee broken) in the program's place (--control)."""

import json

import pytest
import torch

import _tiny
from portbench import run

SEED = 2 ** 31 + 5


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    from cornetto_tpu_torch.tools import sdust
    # the plain SDUST DP costs ~1-4 ms a base step of a row on the CPU
    monkeypatch.setattr(sdust, "CORE", 128)
    return _tiny.data_root(tmp_path)


def _result(root, capsys, workload, *extra, seconds=1):
    assert run.main(["--workload", workload, "--seed", str(SEED),
                     "--seconds", str(seconds), "--trace", "0", *extra],
                    allow_cpu=True, root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_runs_are_correct(root, capsys):
    for workload in (_tiny.RU, _tiny.AN):
        assert _result(root, capsys, workload)["correct"]


@pytest.mark.parametrize("workload, number", [
    (_tiny.RU, "reads_off"), (_tiny.AN, "sdust_rows_off")])
def test_controls_fail(root, capsys, workload, number):
    # a window long enough for a job of each tiny contig
    res = _result(root, capsys, workload, "--control", seconds=4)
    assert not res["correct"] and res["checks"][number]["value"] > 0


def _state_unchanged(monkeypatch):
    """The chunk engine's tick decides without writing the new chunks."""
    from cornetto_tpu_torch.livefish import decide

    def tick(buf, btable, rows, s_chans, s_slots, d_chans, lengths,
             panel_mask, **kw):
        g = buf.index_select(0, d_chans).reshape(d_chans.shape[0], -1)
        return buf, decide.decision_core_packed_fused(
            btable, g, None, panel_mask, lengths=lengths, **kw)
    monkeypatch.setattr(decide, "chunk_tick_core", tick)


def _half_left_out(monkeypatch):
    """Half of each tick's decisions never come back."""
    from cornetto_tpu_torch.livefish import chunks
    resolve = chunks.DeviceChunkEngine._resolve
    monkeypatch.setattr(chunks.DeviceChunkEngine, "_resolve",
                        lambda self, e: resolve(self, e)[::2])


def _answer_altered(monkeypatch):
    """Every decision's unblock bit flipped where it is read back."""
    from cornetto_tpu_torch.livefish import chunks
    unpack = chunks.unpack_fused

    def flipped(arr):
        d, best, est, nhits = unpack(arr)
        return 1 - d, best, est, nhits
    monkeypatch.setattr(chunks, "unpack_fused", flipped)


def _sdust_unwritten(monkeypatch):
    """The SDUST DP leaves its outputs as it found them: no intervals."""
    from cornetto_tpu_torch.kernels import sdust
    dp = sdust.sdust_dp
    monkeypatch.setattr(sdust, "sdust_dp", lambda *a, **kw: tuple(
        torch.zeros_like(x) for x in dp(*a, **kw)))


def _sdust_half_rows(monkeypatch):
    """Every other chunk of the plan left out."""
    from cornetto_tpu_torch.kernels import sdust
    plan = sdust.plan_rows

    def half(*a, **kw):
        chunks, host, padded, off, clen = plan(*a, **kw)
        if not chunks:
            return chunks, host, padded, off, clen
        return chunks[::2], host, padded, off[::2].copy(), clen
    monkeypatch.setattr(sdust, "plan_rows", half)


def _sdust_row_altered(monkeypatch):
    """Each interval's end moved one base where sdust_device returns it."""
    from cornetto_tpu_torch.tools import sdust
    dev = sdust.sdust_device
    monkeypatch.setattr(sdust, "sdust_device", lambda *a, **kw: [
        (s, e + 1) for s, e in dev(*a, **kw)])


@pytest.mark.parametrize("workload, fault", [
    (_tiny.RU, _state_unchanged), (_tiny.RU, _half_left_out),
    (_tiny.RU, _answer_altered), (_tiny.AN, _sdust_unwritten),
    (_tiny.AN, _sdust_half_rows), (_tiny.AN, _sdust_row_altered)])
def test_faults_are_not_correct(root, capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    assert not _result(root, capsys, workload)["correct"]
