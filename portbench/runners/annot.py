"""The annotation cell's runner: the draft's contigs, each written as a FASTA
of its own, annotated one after another by the program's `sdust`
(tools/sdust.py run) and then `telofind` (tools/telofind.py run), both on
their default, device backends, round and round until the window closes.
A job that starts inside the window runs to its end, and the window closes
when the last one ends, so the rate is whole jobs' bases over their time.
"""

import io
import json
import os
import tempfile
import time

import numpy as np

from portbench import draft, harness


def _write(path: str, name: str, text: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        f.write(text.tobytes())
        f.write(b"\n")


def inputs(cfg: dict, seed: int, device):
    """Each contig as ASCII with its features written in, and the
    features."""
    codes, starts = draft.genome(cfg, seed, device)
    return draft.annotation_text(cfg, seed, codes, starts)


def setup(run: harness.Run) -> dict:
    from cornetto_tpu_torch.tools import sdust, telofind
    cfg, mix, seed, dev = run.cfg, run.mix, run.seed, run.device
    with run.part("draft"):
        texts, feats = inputs(cfg, seed, dev)
    with run.part("fasta"):
        tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        paths = []
        for (name, _), text in zip(cfg["contigs"], texts):
            paths.append(os.path.join(tmp.name, name + ".fa"))
            _write(paths[-1], name, text)
    with run.part("warmup"):
        warm = os.path.join(tmp.name, "warmup.fa")
        _write(warm, cfg["contigs"][0][0], texts[0][:mix["warmup_bases"]])
        _job(sdust, telofind, mix, warm, None)
        os.unlink(warm)
    return dict(sdust=sdust, telofind=telofind, tmp=tmp, paths=paths,
                texts=texts, feats=feats)


def _job(sdust, telofind, mix, path, stats):
    """One job: sdust, then telofind, on one FASTA: (sdust rows, telofind
    rows, sdust seconds, telofind seconds)."""
    sd, tf = mix["sdust"], mix["telofind"]
    out_s, out_t = io.StringIO(), io.StringIO()
    a = time.perf_counter()
    sdust.run(path, T=sd["T"], W=sd["W"], out=out_s, backend="device",
              stats=None if stats is None else stats["sdust"])
    b = time.perf_counter()
    telofind.run(path, tf["motif"], out=out_t, backend="device",
                 stats=None if stats is None else stats["telofind"])
    c = time.perf_counter()
    return out_s.getvalue(), out_t.getvalue(), b - a, c - b


def window(run: harness.Run, st: dict) -> None:
    trace, cfg = run.trace, run.cfg
    stats = dict(sdust={}, telofind={}) if run.trace_on else None
    jobs = []
    bases = 0
    with trace.window(), harness.HostMeter() as host:
        t0 = time.perf_counter()
        now = t0
        while now < t0 + run.seconds:
            ci = len(jobs) % len(st["paths"])
            with trace.span("job:" + cfg["contigs"][ci][0]):
                jobs.append((ci, *_job(st["sdust"], st["telofind"], run.mix,
                                       st["paths"][ci], stats)))
            bases += cfg["contigs"][ci][1]
            now = time.perf_counter()
    window_s = now - t0
    run.attempted = len(jobs)
    run.metrics["annot_mbp_per_s"] = bases / 1e6 / window_s
    run.counts.update(
        window_s=window_s, jobs=len(jobs), bases=bases,
        sdust_s=sum(j[3] for j in jobs), telofind_s=sum(j[4] for j in jobs),
        sdust_rows=sum(j[1].count("\n") for j in jobs),
        job_contigs=[j[0] for j in jobs], host=host.summary)
    if stats is not None:
        run.counts["sdust_stats"] = stats["sdust"]
        run.counts["telofind_stats"] = stats["telofind"]
        for k in ("chunks", "heavy_rows", "overflow_rows", "host_span_bases"):
            run.counts["sdust_" + k] = stats["sdust"].get(k, 0)
    st["jobs"] = jobs
    print("window: jobs (contig, sdust s, telofind s) %s; host %s" % ([
        (cfg["contigs"][j[0]][0], round(j[3], 3), round(j[4], 3))
        for j in jobs], json.dumps(host.summary)), flush=True)


def release(st: dict) -> None:
    st["tmp"].cleanup()


def check(run: harness.Run, st: dict, control: bool = False) -> None:
    """Every job's telofind rows against the reference's, and its sdust rows
    on the seeded windows of its contig.  control: in place of each job's
    sdust rows, the reference's SDUST run on each control_core-long piece
    of the window alone, with no context or overlap (the step a chunked
    kernel would take without the planner)."""
    from portbench.reference import annot as ref
    cfg, mix, ck = run.cfg, run.mix, run.mix["check"]
    texts = st["texts"]
    wins = [ref.windows(ck, run.seed, ci, texts[ci], st["feats"][ci])
            for ci in range(len(texts))]
    sd = mix["sdust"]
    want_sd = ref.sdust_windows(texts, wins, ck["context"], sd["T"], sd["W"])
    ctl = ref.sdust_windows(texts, wins, ck["context"], sd["T"], sd["W"],
                            chunk=ck["control_core"]) if control else None
    want_tf = {}
    sd_off = tf_off = 0
    for ci, rows_s, rows_t, _, _ in st["jobs"]:
        name = cfg["contigs"][ci][0]
        if ci not in want_tf:
            want_tf[ci] = ref.telofind_rows(name, texts[ci],
                                            mix["telofind"]["motif"])
        tf_off += ref.rows_off(rows_t.splitlines(), want_tf[ci])
        got = [(int(r[1]), int(r[2])) for r in
               (line.split("\t") for line in rows_s.splitlines())
               if r[0] == name]
        for a, b in wins[ci]:
            mine = ctl[(ci, a, b)] if control else ref.clip(got, a, b)
            sd_off += ref.rows_off(mine, want_sd[(ci, a, b)])
    run.counts.update(sdust_windows=sum(len(w) for w in wins),
                      sdust_window_bases=sum(b - a for w in wins
                                             for a, b in w),
                      sdust_window_rows=sum(len(v) for v in want_sd.values()))
    run.checks.append(("sdust_rows_off", sd_off, 0))
    run.checks.append(("telofind_rows_off", tf_off, 0))
    run.checks.append(("no_job", int(not st["jobs"]), 0))
    if run.trace_on:
        _mask_work(run, st)


def _mask_work(run: harness.Run, st: dict) -> None:
    """The telomere mask's work in the traced window: each job's two
    strands over its contig's codes."""
    import torch
    from portbench import roofline
    motif = run.mix["telofind"]["motif"]
    rmotif = motif[::-1].translate(str.maketrans("ACGT", "TGCA"))
    lut = np.full(256, 4, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    per = {}
    nbytes = ops = 0
    for ci in run.counts["job_contigs"]:
        if ci not in per:
            x = torch.from_numpy(lut[st["texts"][ci]]).to(run.device)
            per[ci] = [roofline.telo_mask_work(x, lut[np.frombuffer(
                m.encode(), np.uint8)].tolist()) for m in (motif, rmotif)]
            del x
        for b_, o in per[ci]:
            nbytes += b_
            ops += o
    run.counts.update(telo_mask_bytes=nbytes, telo_mask_ops=ops)
