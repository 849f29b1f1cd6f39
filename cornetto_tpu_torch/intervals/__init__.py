"""Interval algebra on BED rows (a copy of ``cornetto_tpu.intervals``)."""
