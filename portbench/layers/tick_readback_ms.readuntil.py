"""The host's time a tick waiting on the card and copying the decisions back
(livefish/chunks.py ChunkDecisionEngine._resolve's read of the fused
result): the self seconds of the program's span chunks.readback over the
calls of chunks.process, in ms, in the traced half.  None off the card or
where the program has no such span."""


def read(run):
    if run.device.type != "cuda":
        return None
    from cornetto_tpu_torch.utils import profiling
    tally = getattr(profiling, "tally", dict)()
    tick, span = tally.get("chunks.process"), tally.get("chunks.readback")
    if not tick or not span:
        return None
    return 1e3 * span["self_s"] / tick["calls"]
