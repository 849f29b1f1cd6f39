"""Panel pipelines of the port (counterparts of ``cornetto_tpu.pipelines``;
the interval algebra and writers are shared)."""
