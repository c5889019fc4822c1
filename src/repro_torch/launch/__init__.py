"""Launchers (port of ``repro.launch``): the device mesh over the ranks of
a ``torch.distributed`` process group.  The multi-pod dry-run, train and
serve launchers are ROADMAP A, slice 16."""
