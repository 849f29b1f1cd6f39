"""The plain reference against the program's CPU path at tiny sizes: the
same entry of every hash as the program's index finds, the same rows as the
program's sequential SDUST DP over whole contigs and as its host telofind,
and a whole tiny read-until run judged correct."""

import json

import numpy as np
import torch

import _tiny
from portbench import draft, harness, run
from portbench.runners import annot as annot_runner
from portbench.runners import readuntil as ru_runner
from portbench.reference import annot as ref_annot
from portbench.reference import readuntil as ref_ru

CPU = torch.device("cpu")
SEED = 2 ** 31 + 3


def _tiny_cfg(tmp_path, name):
    root = _tiny.data_root(tmp_path)
    cell = harness.cell(name, root)
    return root, harness.config(cell["config"], root), \
        harness.traffic(cell["traffic"], root)


def _program_entries(btable: np.ndarray):
    """Each hash in the program's bucket table with the entry its probe
    finds first (the home bucket's slots, then the alternate's): keys,
    contigs, positions, ambiguity, and how many entries sit in their
    alternate bucket."""
    nb, K = btable.shape[0], btable.shape[1] // 2
    B = nb.bit_length() - 1
    halves = btable.view(np.uint16).reshape(nb, 4 * K).astype(np.int64)
    fps, cts = halves[:, :K], halves[:, K:2 * K]
    pos = btable[:, K:].astype(np.int64)
    tag, fp = fps >> 15, fps & 0x7FFF
    b = np.arange(nb, dtype=np.int64)[:, None]
    home = np.where(tag == 1, b ^ (((fp * 0x9E3779B1) & 0xFFFFFFFF)
                                   >> (32 - B)), b)
    key = home | (fp << B)
    order = tag * K + np.arange(K)[None, :]
    occ = cts != 0xFFFF
    key, order, ct, ps = key[occ], order[occ], cts[occ], pos[occ]
    i = np.lexsort((order, key))
    lead = np.ones(len(i), bool)
    lead[1:] = key[i][1:] != key[i][:-1]
    i = i[lead]
    return (key[i], ct[i], ps[i] & 0x7FFFFFFF, ps[i] < 0,
            int((tag[occ] == 1).sum()))


def test_reference_index_is_the_programs(tmp_path):
    """A table full enough that the placement drops entries and puts
    others in their alternate bucket: the program's probe finds the same
    entry of every hash as the reference's search."""
    from cornetto_tpu_torch.livefish.index import build_index
    _, cfg, _ = _tiny_cfg(tmp_path, _tiny.RU)
    cfg["contigs"] = [["c1", 2600000], ["c2", 2400000]]
    codes, starts, _, _ = ru_runner.inputs(cfg, SEED, CPU)
    lens = [n for _, n in cfg["contigs"]]
    ix = dict(cfg["index"], max_overflow=0.3)
    got = build_index(
        ((name, draft.ASCII[codes[s:s + n]].tobytes().decode())
         for (name, n), s in zip(cfg["contigs"], starts)),
        k=ix["k"], w=ix["w"], repeat_cap=ix["repeat_cap"],
        bucket_slots=ix["bucket_slots"], max_overflow=ix["max_overflow"],
        keep_tables=False)
    want = ref_ru.build_table(codes, starts, lens, ix, CPU)
    keys, ct, pos, amb, in_alt = _program_entries(got.btable[0])
    assert got.btable.shape[1] == 1 << want.B
    assert want.dropped == round(got.dropped_frac * want.entries) > 0
    assert in_alt > 0 and amb.any()
    assert np.array_equal(keys, want.keys)
    assert np.array_equal(ct, want.contig)
    assert np.array_equal(pos, want.pos)
    assert np.array_equal(amb, want.amb)
    narrow = ref_ru.build_table(codes, starts, lens, ix, CPU, narrower=1)
    assert narrow.B == want.B - 1 and narrow.dropped > want.dropped


def test_reference_sdust_and_telofind_are_the_programs(tmp_path):
    from cornetto_tpu_torch.native.sdust import sdust
    from cornetto_tpu_torch.tools import telofind
    _, cfg, mix = _tiny_cfg(tmp_path, _tiny.AN)
    texts, feats = annot_runner.inputs(cfg, SEED, CPU)
    ck = mix["check"]
    for ci, ((name, _), text) in enumerate(zip(cfg["contigs"], texts)):
        whole = sdust(text.tobytes(), T=20, W=64)
        wins = ref_annot.windows(ck, SEED, ci, text, feats[ci])
        assert len(wins) >= 6
        for a, b in wins:
            assert ref_annot.sdust_window(text, a, b, ck["context"], 20,
                                          64) == ref_annot.clip(whole, a, b)
        path = tmp_path / (name + ".fa")
        path.write_bytes(b">%s\n%s\n" % (name.encode(), text.tobytes()))
        with open(tmp_path / "out.txt", "w") as f:
            telofind.run(str(path), "TTAGGG", out=f, backend="host")
        got = (tmp_path / "out.txt").read_text().splitlines()
        assert got == ref_annot.telofind_rows(name, text, "TTAGGG")
        assert any("\t1\t0\t" in r for r in got)


def test_tiny_readuntil_run_is_correct(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    root = _tiny.data_root(tmp_path)
    assert run.main(["--workload", _tiny.RU, "--seed", str(SEED),
                     "--seconds", "2", "--trace", "1"], allow_cpu=True,
                    root=root) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    counts = json.loads(out[-2].split("counts ", 1)[1])
    assert res["correct"] and counts["checked_later"] > 0
    assert set(res["metrics"]) == {"device_idle_pct.readuntil",
                                   "tick_host_ms.readuntil",
                                   "decision_p95_ms.readuntil"}
    assert res["device"]["window_s"] > 0 and res["breakdown"]["idle_gaps"]
