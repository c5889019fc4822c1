"""Launchers (port of ``repro.launch``): the device meshes over the ranks
of a ``torch.distributed`` process group (``mesh``: the host mesh and the
production mesh), the per-arch sharding decisions (``sharding``), the
serving launcher (``serve``) and the training launcher (``train``, one
rank or several).  The multi-pod dry-run (the reference's ``dryrun``) is
ROADMAP A, slice 16f."""
from ..models.common import ShardingRules

# the single-device run's rules: no axis is sharded
RULES = ShardingRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                      vocab=None, experts=None, fsdp=None, head_dim=None,
                      state=None, act_heads=None)
