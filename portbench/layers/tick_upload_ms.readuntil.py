"""The host's time a tick in the upload of the tick's chunks
(livefish/decide.py SingleChipEngine.decide_chunk_tick: the host buffer,
pin_memory() and the copy without blocking): the self seconds of the
program's span decide.upload over the calls of chunks.process, in ms, in
the traced half.  None off the card or where the program has no such
span."""


def read(run):
    if run.device.type != "cuda":
        return None
    from cornetto_tpu_torch.utils import profiling
    tally = getattr(profiling, "tally", dict)()
    tick, span = tally.get("chunks.process"), tally.get("decide.upload")
    if not tick or not span:
        return None
    return 1e3 * span["self_s"] / tick["calls"]
