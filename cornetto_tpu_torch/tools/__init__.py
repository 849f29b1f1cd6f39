"""Host tools of the port whose scan runs on the device (counterparts of
``cornetto_tpu.tools``; parsers and printers are shared)."""
