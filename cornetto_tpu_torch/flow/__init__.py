"""The iteration orchestrator on the port (counterpart of
``cornetto_tpu.flow``, with its own copy of the DAG runner)."""
