"""The fused decision step's useful rows over its launched rows: 100 times
the sum of the count live (rows that decide a channel) over the sum of
the count rows (rows launched) on the program's span chunks.submit, in
the traced half, in %.  None off the card or where the program has no
such span."""


def read(run):
    if run.device.type != "cuda":
        return None
    from cornetto_tpu_torch.utils import profiling
    tally = getattr(profiling, "tally", dict)()
    span = tally.get("chunks.submit")
    if not span or not span["counts"].get("rows"):
        return None
    return 100.0 * span["counts"].get("live", 0) / span["counts"]["rows"]
