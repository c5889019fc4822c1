"""The port's sharding decisions (``repro_torch.launch.sharding``, the
models' ``param_specs`` / ``cache_specs``, the optimizers'
``state_specs``) against the reference's, entry for entry.

Both packages read a stand-in mesh: the reference's ``rules_for`` reads
``shape`` (a dict), ``axis_names`` and ``devices`` (an array of the mesh's
shape, as a ``jax.sharding.Mesh`` has), the port's ``mesh_dim_names`` and
``shape``.  Every arch, full and reduced, every applicable shape cell, on
the meshes (4, 1), (2, 2) and (1, 4) ``("data", "model")`` and (2, 2, 2)
``("pod", "data", "model")``: ``rules_for`` field by field,
``param_specs`` and ``cache_specs`` by ``keystr`` path, ``batch_struct``
and ``cache_struct``'s shapes, dtypes and specs, and both optimizers'
``state_specs``.  Then the DTensor placements a spec names
(``placements``), and the production mesh's size check.
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

import repro.launch.sharding as RS
import repro.models as RM
import repro.train as RT
from repro.configs import get_config as ref_config

import repro_torch.models as M
from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import P
from repro_torch.train import Adafactor, AdamW

MESHES = {"4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class PortMesh:
    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


class RefMesh:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _ref_items(tree):
    """keystr path -> leaf of a reference tree, a PartitionSpec a leaf."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {jax.tree_util.keystr(p): x for p, x in flat}


def _port_items(tree, path=""):
    """The same paths over the port's dicts and NamedTuples."""
    if isinstance(tree, P) or not isinstance(tree, (dict, tuple)):
        return {path: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_items(tree[k], f"{path}[{k!r}]"))
        return out
    out = {}
    for f in tree._fields:
        out.update(_port_items(getattr(tree, f), f"{path}.{f}"))
    return out


def _specs_equal(got, want, what):
    g, w = _port_items(got), _ref_items(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert isinstance(g[k], P), (what, k)
        assert tuple(g[k]) == tuple(w[k]), (what, k, g[k], w[k])


def _shapes_equal(got, want, what):
    g, w = _port_items(got), _ref_items(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert g[k].device.type == "meta", (what, k)
        assert tuple(g[k].shape) == tuple(w[k].shape), (what, k)
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), (what, k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch, reduced, mesh):
    shape, names = MESHES[mesh]
    cfg, rcfg = get_config(arch, reduced), ref_config(arch, reduced)
    pm, rm = PortMesh(shape, names), RefMesh(shape, names)
    cells = [c for c in SHAPES.values() if applicable(cfg, c)]
    assert cells
    for cell in cells:
        what = (arch, reduced, mesh, cell.name)
        rules = S.rules_for(cfg, cell, pm)
        rrules = RS.rules_for(rcfg, cell, rm)
        assert dataclasses.asdict(rules) == dataclasses.asdict(rrules), what
        pspecs = M.param_specs(cfg, rules)
        rpspecs = RM.param_specs(rcfg, rrules)
        _specs_equal(pspecs, rpspecs, what + ("params",))
        _specs_equal(M.cache_specs(cfg, rules), RM.cache_specs(rcfg, rrules),
                     what + ("cache_specs",))
        (bs, bsp), (rbs, rbsp) = (S.batch_struct(cfg, cell, rules),
                                  RS.batch_struct(rcfg, cell, rrules))
        _shapes_equal(bs, rbs, what + ("batch",))
        _specs_equal(bsp, rbsp, what + ("batch specs",))
        (cs, csp), (rcs, rcsp) = (S.cache_struct(cfg, cell, rules),
                                  RS.cache_struct(rcfg, cell, rrules))
        _shapes_equal(cs, rcs, what + ("cache",))
        _specs_equal(csp, rcsp, what + ("cache struct specs",))
        for opt, ropt in ((AdamW(), RT.AdamW()),
                          (Adafactor(), RT.Adafactor()),
                          (Adafactor(beta1=0.9), RT.Adafactor(beta1=0.9))):
            _specs_equal(opt.state_specs(pspecs), ropt.state_specs(rpspecs),
                         what + (type(opt).__name__, opt))


def test_partition_spec_normalizes_as_jax():
    for entries in ((("data",), None), ((), "model"), (("pod", "data"),),
                    ()):
        assert tuple(P(*entries)) == tuple(RefP(*entries)), entries
    assert P("a", "b")[:-1] == P("a")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    pm = PortMesh((2, 2, 2), ("pod", "data", "model"))
    assert S.placements(pm, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements(pm, P()) == (Replicate(),) * 3
    assert S.placements(pm, P(None, "data")) == (Replicate(), Shard(1),
                                                 Replicate())
    with pytest.raises(ValueError, match="lacks"):
        S.placements(PortMesh((4,), ("data",)), P("model"))
    with pytest.raises(ValueError, match="twice"):
        S.placements(pm, P("data", "data"))
    with pytest.raises(ValueError, match="order"):
        S.placements(pm, P(("data", "pod")))
    tree = S.named(pm, AdamW().state_specs({"w": P("data", "model")}))
    assert tree.step == (Replicate(),) * 3
    assert tree.mu["w"] == (Replicate(), Shard(0), Shard(1))


def test_production_mesh_names_its_world_size(tmp_path):
    from test_torch_mesh import one_rank_mesh
    with one_rank_mesh(tmp_path):
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh()
        with pytest.raises(ValueError, match="512 ranks"):
            make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recompute_sees_the_forward_mesh(remat):
    """The backward pass on the card runs on the autograd engine's thread,
    outside the forward's context: a checkpointed layer's recompute must
    still see the mesh the forward saw (the MoE layer reads it).  Here the
    backward runs on a thread of its own."""
    import threading

    import torch

    from repro_torch.models.common import (current_mesh, maybe_remat,
                                           set_current_mesh)
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", True),
                              remat=remat)
    seen = []

    def layer(x):
        seen.append(current_mesh())
        return torch.tanh(x @ x.T).sum(0)

    sentinel = object()
    x = torch.randn(4, 4, requires_grad=True)
    set_current_mesh(sentinel)
    try:
        y = maybe_remat(layer, cfg)(x).sum()
    finally:
        set_current_mesh(None)
    grads = []
    t = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(grads) == 1
    assert len(seen) == 2 and all(m is sentinel for m in seen), seen
