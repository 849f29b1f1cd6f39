"""The host's time a tick in the chunk engine's event loop (livefish/chunks.py
DeviceChunkEngine._stage: the read-id check, encode_seq, the ACGT, length
and short-piece checks, the staging lists): the self seconds of the
program's span chunks.stage over the calls of chunks.process, in ms, in
the traced half.  None off the card or where the program has no such
span."""


def read(run):
    if run.device.type != "cuda":
        return None
    from cornetto_tpu_torch.utils import profiling
    tally = getattr(profiling, "tally", dict)()
    tick, span = tally.get("chunks.process"), tally.get("chunks.stage")
    if not tick or not span:
        return None
    return 1e3 * span["self_s"] / tick["calls"]
