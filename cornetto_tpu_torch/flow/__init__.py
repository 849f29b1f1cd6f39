"""The iteration orchestrator on the port (counterpart of
``cornetto_tpu.flow``; the DAG runner is shared)."""
