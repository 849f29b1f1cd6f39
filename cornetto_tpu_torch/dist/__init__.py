"""Index persistence of the port (``checkpoint``: the shared ``.npz`` index
format)."""
