"""Constrained (matroid / "fair") diversity maximization (port of
``repro.constrained``, batch and streaming).

Given ``m`` groups and a label-count matroid over them — exact quotas
``|S ∩ G_g| = q_g``, quota ranges, transversal slot eligibility or laminar
nested caps — maximize a diversity objective over feasible bases (the fair
variant of the paper's problem, Ceccarello et al., arXiv:2002.03175).

* ``coreset``: per-group core-sets, all m GMM runs in lock-step on the
  single-sweep engine whose sweep is the B4 kernel on the card;
* ``matroid``: the numpy oracles (the port's own copy);
* ``solver``: feasible greedy + oracle-checked local search on the union;
* ``streaming``: one SMM state per group;
* ``mapreduce``: the simulated ℓ-reducer run, all reducers' groups in one
  grouped-engine run, and the mesh path over ``torch.distributed``, one
  rank a reducer.

The legacy drivers ``fair_diversity_maximize`` and
``fair_streaming_diversity`` route through ``repro_torch.diversify``, the
front door.
"""
from .coreset import (GroupedCoreset, fair_diversity_maximize,
                      grouped_adaptive, grouped_coreset)
from .matroid import (LaminarMatroid, Matroid, PartitionMatroid,
                      TransversalMatroid, as_matroid)
from .solver import (brute_force_constrained, constrained_solve,
                     feasible_greedy, local_search, solve_and_value)
from .mapreduce import (FairCoreset, mr_fair_diversity, mr_grouped_coreset,
                        simulate_fair_mr)
from .streaming import FairStreamingCoreset, fair_streaming_diversity

__all__ = [
    "GroupedCoreset", "grouped_coreset", "grouped_adaptive",
    "constrained_solve", "feasible_greedy", "local_search",
    "brute_force_constrained", "solve_and_value", "FairStreamingCoreset",
    "Matroid", "PartitionMatroid", "TransversalMatroid", "LaminarMatroid",
    "as_matroid", "FairCoreset", "mr_grouped_coreset", "mr_fair_diversity",
    "simulate_fair_mr", "fair_diversity_maximize", "fair_streaming_diversity",
]
