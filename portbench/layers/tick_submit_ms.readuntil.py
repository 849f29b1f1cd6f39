"""The host's time a tick in the chunk engine's launch of a batch, less the
upload (livefish/chunks.py DeviceChunkEngine._submit: the staging arrays,
the 2-bit pack and the fused step's launches): the self seconds of the
program's span chunks.submit over the calls of chunks.process, in ms, in
the traced half.  None off the card or where the program has no such
span."""


def read(run):
    if run.device.type != "cuda":
        return None
    from cornetto_tpu_torch.utils import profiling
    tally = getattr(profiling, "tally", dict)()
    tick, span = tally.get("chunks.process"), tally.get("chunks.submit")
    if not tick or not span:
        return None
    return 1e3 * span["self_s"] / tick["calls"]
