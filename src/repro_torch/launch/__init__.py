"""Launchers (port of ``repro.launch``): the device mesh over the ranks of
a ``torch.distributed`` process group (``mesh``), the serving launcher
(``serve``) and the one-rank training launcher (``train``).  The sharding
rules, the production mesh, the multi-rank training run and the multi-pod
dry-run are ROADMAP A, slice 16e."""
from ..models.common import ShardingRules

# the single-device run's rules: no axis is sharded
RULES = ShardingRules(batch=(), heads=None, kv_heads=None, d_ff=None,
                      vocab=None, experts=None, fsdp=None, head_dim=None,
                      state=None, act_heads=None)
