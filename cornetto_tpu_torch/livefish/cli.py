"""`cornetto livefish` subcommands on the PyTorch engine: counterpart of
cornetto_tpu/livefish/cli.py.  ``run``, ``cov`` and ``replay`` (the
read-until chunk engine, livefish.chunks, with ``--state host|device``) run
the port's engine; ``index`` (the native index build, written in the shared
``.npz`` format) and ``toml`` are copies of the JAX package's host
commands."""

import sys

import numpy as np

from cornetto_tpu_torch.utils import logging as log

NOT_PORTED = "not yet ported to cornetto_tpu_torch"


def _load_index_or_die(path):
    import os
    from cornetto_tpu_torch.dist.checkpoint import load_index
    f = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(f):
        log.die("index not found: %s (build one with: cornetto livefish "
                "index <draft.fasta> -o %s)" % (f, path))
    return load_index(path)


def _cmd_index(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.dist.checkpoint import save_index
    from cornetto_tpu_torch.io.bed import read_bed3
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    opts, args = _getopt.gnu_getopt(argv, "o:s:p:k:w:",
                                    ["output=", "shards=", "panel=",
                                     "kmer=", "window="])
    out_path = "livefish_index"
    shards = 1
    panel_path = None
    k, w = 15, 10
    for flag, val in opts:
        if flag in ("-o", "--output"):
            out_path = val
        elif flag in ("-s", "--shards"):
            shards = int(val)
        elif flag in ("-p", "--panel"):
            panel_path = val
        elif flag in ("-k", "--kmer"):
            k = int(val)
        elif flag in ("-w", "--window"):
            w = int(val)
    if len(args) != 1:
        sys.stderr.write("Usage: cornetto livefish index <draft.fasta> "
                         "[-o out] [-s shards] [-p panel.bed]\n")
        return 1
    # stream (name, seq) pairs: each contig string frees right after
    # extraction instead of pinning the whole genome (~3 GB at 3 Gbp);
    # keep_tables=False: the engine needs only btable — the padded
    # per-shard tables triple RAM + checkpoint size at genome scale
    idx = build_index(((rec.name, rec.seq) for rec in read_fastx(args[0])),
                      n_shards=shards, k=k, w=w, keep_tables=False)
    panel = None
    if panel_path:
        panel = build_panel_mask(idx, read_bed3(panel_path))
    save_index(out_path, idx, panel_mask=panel)
    log.info("index: %d shards x %d buckets x %d slots, %d contigs -> "
             "%s.npz" % (idx.n_shards, idx.btable.shape[1],
                         idx.bucket_slots, len(idx.contig_names), out_path))
    return 0


def _cmd_run(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.io.bed import read_bed3
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    from cornetto_tpu_torch.livefish.index import build_panel_mask
    from cornetto_tpu_torch.livefish.stream import stream_decisions
    opts, args = _getopt.gnu_getopt(argv, "b:l:p:",
                                    ["batch=", "read-len=", "panel="])
    batch, read_len = 4096, 450
    panel_path = None
    for flag, val in opts:
        if flag in ("-b", "--batch"):
            batch = int(val)
        elif flag in ("-l", "--read-len"):
            read_len = int(val)
        elif flag in ("-p", "--panel"):
            panel_path = val
    if len(args) != 2:
        sys.stderr.write("Usage: cornetto livefish run <index> <reads.fastq> "
                         "[-b batch] [-l read_len] [-p panel.bed]\n")
        return 1
    idx, panel, _ = _load_index_or_die(args[0])
    if panel_path:
        panel = build_panel_mask(idx, read_bed3(panel_path))
    if panel is None:
        log.die("no panel: build the index with -p or pass -p here")
    eng = SingleChipEngine(idx, panel)
    eng.contig_names = idx.contig_names
    total, accepted = stream_decisions(eng, args[1], batch=batch,
                                       read_len=read_len)
    sys.stderr.write("reads: %d\taccepted: %d\trejected: %d\n"
                     % (total, accepted, total - accepted))
    return 0


def _cmd_replay(argv) -> int:
    """read-until replay: feed full reads chunk-by-chunk through the
    3-way (proceed/unblock/stop_receiving) per-channel state machine and
    report adaptive-sampling savings — the control-loop validation the
    reference delegates to a live sequencer (docs/protocol.md:137-161)."""
    import getopt as _getopt
    from cornetto_tpu_torch.io.bed import read_bed3
    from cornetto_tpu_torch.io.fasta import read_fastx
    from cornetto_tpu_torch.livefish.chunks import (ChunkDecisionEngine,
                                                    ChunkPolicy,
                                                    DeviceChunkEngine,
                                                    replay_read_until)
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    from cornetto_tpu_torch.livefish.index import build_panel_mask
    opts, args = _getopt.gnu_getopt(
        argv, "c:n:m:p:b:u:d:",
        ["chunk=", "channels=", "max-chunks=", "panel=", "batch=",
         "unblock-overhead=", "pipeline-depth=", "state="])
    chunk_len, channels, max_chunks, batch = 450, 512, 4, 512
    panel_path = None
    overhead = 500
    pipeline_depth = 0
    state = "host"
    for flag, val in opts:
        if flag in ("-c", "--chunk"):
            chunk_len = int(val)
        elif flag in ("-n", "--channels"):
            channels = int(val)
        elif flag in ("-m", "--max-chunks"):
            max_chunks = int(val)
        elif flag in ("-p", "--panel"):
            panel_path = val
        elif flag in ("-b", "--batch"):
            batch = int(val)
        elif flag in ("-u", "--unblock-overhead"):
            overhead = int(val)
        elif flag in ("-d", "--pipeline-depth"):
            pipeline_depth = int(val)
        elif flag == "--state":
            state = val
    if len(args) != 2:
        sys.stderr.write("Usage: cornetto livefish replay <index> "
                         "<reads.fastq> [-c chunk] [-n channels] "
                         "[-m max_chunks] [-p panel.bed] "
                         "[-u unblock_overhead] [-d pipeline_depth] "
                         "[--state host|device]\n")
        return 1
    idx, panel, _ = _load_index_or_die(args[0])
    if panel_path:
        panel = build_panel_mask(idx, read_bed3(panel_path))
    if panel is None:
        log.die("no panel: build the index with -p or pass -p here")
    if state not in ("host", "device"):
        log.die("--state must be host or device (got %s)" % state)
    # --state device keeps accumulated per-channel prefixes ON DEVICE and
    # uploads only each tick's new chunk bytes (DeviceChunkEngine);
    # requires pure-ACGT chunks and chunk_len % 4 == 0
    cls = DeviceChunkEngine if state == "device" else ChunkDecisionEngine
    if state == "device" and chunk_len % 4:
        log.die("--state device needs chunk_len % 4 == 0")
    eng = cls(SingleChipEngine(idx, panel),
              n_channels=channels, chunk_len=chunk_len,
              policy=ChunkPolicy(max_chunks=max_chunks),
              batch=batch, pipeline_depth=pipeline_depth)
    reads = [(rec.name, rec.seq, False) for rec in read_fastx(args[1])]
    m = replay_read_until(eng, reads, unblock_overhead=overhead)
    out = sys.stdout
    out.write("reads\t%d\n" % m.n_reads)
    out.write("unblocked\t%d\n" % m.n_unblocked)
    out.write("stop_receiving\t%d\n" % m.n_stop_receiving)
    out.write("no_decision\t%d\n" % m.n_no_decision)
    out.write("mean_decision_chunks\t%.2f\n" % m.mean_decision_chunks)
    out.write("bases_sequenced\t%d\n" % m.bases_sequenced)
    out.write("bases_without_as\t%d\n" % m.bases_without_as)
    if m.bases_without_as:
        out.write("bases_saved_pct\t%.2f\n"
                  % (100.0 * (1 - m.bases_sequenced / m.bases_without_as)))
    return 0


def _cmd_cov(argv) -> int:
    """Aligner-free coverage tracks: estimate cov-total / cov-mq20
    bedgraphs from livefish index hits while deciding, replacing the
    protocol's minimap2 + samtools realignment step (reference:
    shitflow/create-launch.pbs.sh:61-67) for iteration panels."""
    import getopt as _getopt
    from cornetto_tpu_torch.livefish.coverage import (CoverageParams,
                                                      CoverageTally,
                                                      stream_coverage)
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    opts, args = _getopt.gnu_getopt(
        argv, "o:b:l:s:q:", ["output=", "batch=", "read-len=", "bin=",
                             "hq-hits="])
    prefix = "livefish"
    batch, read_len = 4096, 450
    bin_size, hq_hits = 1000, 8
    for flag, val in opts:
        if flag in ("-o", "--output"):
            prefix = val
        elif flag in ("-b", "--batch"):
            batch = int(val)
        elif flag in ("-l", "--read-len"):
            read_len = int(val)
        elif flag in ("-s", "--bin"):
            bin_size = int(val)
        elif flag in ("-q", "--hq-hits"):
            hq_hits = int(val)
    if len(args) != 2:
        sys.stderr.write("Usage: cornetto livefish cov <index> "
                         "<reads.fastq> [-o prefix] [-b batch] [-l read_len] "
                         "[-s bin] [-q hq_hits]\n")
        return 1
    idx, panel, _ = _load_index_or_die(args[0])
    if panel is None:
        # coverage needs decisions but no reject panel: accept everything
        panel = np.zeros((len(idx.contig_names), 128), dtype=bool)
    eng = SingleChipEngine(idx, panel)
    tally = CoverageTally(idx, CoverageParams(bin_size=bin_size,
                                              hq_hits=hq_hits))
    total, accepted = stream_coverage(eng, tally, args[1], batch=batch,
                                      read_len=read_len)
    tot_p = prefix + ".cov-total.bg"
    mq_p = prefix + ".cov-mq20.bg"
    tally.write_bedgraphs(tot_p, mq_p)
    sys.stderr.write("reads: %d\tmapped tracks -> %s, %s\n"
                     % (total, tot_p, mq_p))
    return 0


def _cmd_toml(argv) -> int:
    from cornetto_tpu_torch.io.readfish import write_readfish_toml
    if len(argv) != 2:
        sys.stderr.write("Usage: cornetto livefish toml <ref.mmi> "
                         "<targets.csv>\n")
        return 1
    write_readfish_toml(sys.stdout, reference_mmi=argv[0],
                        targets_csv=argv[1])
    return 0


def main(argv) -> int:
    if not argv:
        sys.stderr.write(
            "Usage: cornetto livefish <index|run|replay|cov|toml> ...\n")
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        return _cmd_index(rest)
    if cmd == "run":
        return _cmd_run(rest)
    if cmd == "cov":
        return _cmd_cov(rest)
    if cmd == "toml":
        return _cmd_toml(rest)
    if cmd == "replay":
        return _cmd_replay(rest)
    sys.stderr.write("Unknown livefish command %s\n" % cmd)
    return 1
