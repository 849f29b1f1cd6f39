"""Panel pipelines of the port (counterparts of ``cornetto_tpu.pipelines``):
create-panel and a copy of telostats."""
