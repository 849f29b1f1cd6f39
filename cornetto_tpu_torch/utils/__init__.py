"""Host helpers of the port: C-semantics formatting, logging, timing and
argument parsing (copies of ``cornetto_tpu.utils`` that the port uses)."""
