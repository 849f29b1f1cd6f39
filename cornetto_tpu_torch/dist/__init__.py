"""The port's multi-device runtime on torch.distributed (``multihost``,
``mesh``, ``collectives``, ``scan``) and its index persistence
(``checkpoint``: the shared ``.npz`` index format)."""
