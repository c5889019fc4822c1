"""Launchers (port of ``repro.launch``): the device mesh over the ranks of
a ``torch.distributed`` process group (``mesh``) and the serving launcher
(``serve``).  The train launcher and its sharding rules are ROADMAP A,
slice 16b (dense training); the multi-pod dry-run is slice 16e."""
