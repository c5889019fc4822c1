"""Launchers (port of ``repro.launch``): the device meshes over the ranks
of a ``torch.distributed`` process group (``mesh``: the host mesh and the
production mesh), the per-arch sharding decisions (``sharding``), the
serving launcher (``serve``), the training launcher (``train``, one
rank or several) and the multi-pod dry run (``dryrun``: every cell
placed on the production meshes and its sharded train, prefill or
decode step traced on ``meta`` tensors over a fake process group)."""
from ..models.common import ShardingRules

# the single-device run's rules: no axis is sharded
RULES = ShardingRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                      vocab=None, experts=None, fsdp=None, head_dim=None,
                      state=None, act_heads=None)
