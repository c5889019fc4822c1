"""The port's checkpoint manager against the reference's: the same on-disk
layout (``arrays.npz`` keyed by ``jax.tree_util.keystr`` paths plus
``meta.json``), so a checkpoint written by either package restores in the
other; atomic rename, keep_k, async save, the schema and template checks;
and a ``StreamingCoreset`` saved by one package, restored by the other and
continued equals the uninterrupted stream (bit for bit: the SMM state of
both packages is the same arrays, and the continuation runs on the port's
plain CPU path either way).  Across gloo CPU ranks: a tree of DTensors
saved at 4 ranks restores re-sharded at 2 (the reference's elastic
test)."""
import json
import os
import subprocess
import sys
import textwrap
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.core.smm import StreamingCoreset as RefStream
from repro_torch.checkpoint import (SCHEMA_VERSION, CheckpointError,
                                    CheckpointManager, ShapeDtype)
from repro_torch.checkpoint.manager import keystr_paths
from repro_torch.core.smm import StreamingCoreset


class S(NamedTuple):
    T: object
    v: object


def _trees():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    return [
        {"prefix": a, "st": S(a + 1, np.int32(3)), "l": [a, (a * 2,)]},
        [a, {"b": a, "a": (a, None)}],
        {3: a, 1: a + 1},
        S(T={"z": a, "y": [a]}, v=(a,)),
    ]


@pytest.mark.parametrize("i", range(4))
def test_keystr_paths_equal_jax(i):
    tree = _trees()[i]
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert keystr_paths(tree) == want


def test_issue_example_paths():
    a = np.zeros(2, np.float32)
    tree = {"prefix": a, "st": S(a, a), "l": [a, (a,)]}
    assert keystr_paths(tree) == ["['l'][0]", "['l'][1][0]", "['prefix']",
                                  "['st'].T", "['st'].v"]


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "n": np.int32(7), "mask": rng.random(5) > 0.5,
            "st": S(T=rng.normal(size=(2, 2)).astype(np.float32),
                    v=np.arange(3, dtype=np.int32))}


def _assert_tree_equal(got, want):
    for (pg, lg), (pw, lw) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(np.asarray, got))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(np.asarray, want))[0]):
        assert jax.tree_util.keystr(pg) == jax.tree_util.keystr(pw)
        np.testing.assert_array_equal(np.asarray(lg), np.asarray(lw))
        assert np.asarray(lg).dtype == np.asarray(lw).dtype


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, S):
        return S(*(_to_torch(x) for x in tree))
    return torch.as_tensor(np.asarray(tree))


def test_port_writes_reference_restores(tmp_path):
    tree = _tree_np()
    CheckpointManager(str(tmp_path)).save(5, _to_torch(tree),
                                          extra={"note": "port"})
    ref = RefManager(str(tmp_path))
    assert ref.latest_step() == 5
    assert ref.read_meta(5) == {"step": 5, "schema_version": SCHEMA_VERSION,
                                "extra": {"note": "port"}}
    template = jax.tree_util.tree_map(jnp.asarray, tree)
    _assert_tree_equal(ref.restore(5, template), tree)


def test_reference_writes_port_restores(tmp_path):
    tree = _tree_np(1)
    RefManager(str(tmp_path)).save(3, jax.tree_util.tree_map(jnp.asarray,
                                                             tree))
    mgr = CheckpointManager(str(tmp_path))
    got = mgr.restore(3, _to_torch(tree))
    assert isinstance(got["w"], torch.Tensor) and isinstance(got["st"], S)
    assert got["n"].dtype == torch.int32 and got["mask"].dtype == torch.bool
    _assert_tree_equal({k: (S(*(x.numpy() for x in v)) if isinstance(v, S)
                            else v.numpy()) for k, v in got.items()}, tree)
    # (shape, dtype) stand-ins restore too, each leaf at its saved shape
    stand = {"w": ShapeDtype((4, 3), torch.float32),
             "n": ShapeDtype((), np.int32),
             "mask": ShapeDtype((5,), torch.bool),
             "st": S(T=ShapeDtype((2, 2), torch.float64),
                     v=ShapeDtype((3,), torch.int32))}
    got = mgr.restore(3, stand, device="cpu")
    assert got["st"].T.dtype == torch.float64
    np.testing.assert_array_equal(got["st"].T.numpy(),
                                  tree["st"].T.astype(np.float64))
    step, latest = mgr.restore_latest(stand)
    assert step == 3 and torch.equal(latest["w"], got["w"])


def test_byte_layout_equals_reference(tmp_path):
    tree = _tree_np(2)
    CheckpointManager(str(tmp_path / "port")).save(1, _to_torch(tree))
    RefManager(str(tmp_path / "ref")).save(
        1, jax.tree_util.tree_map(jnp.asarray, tree))
    for name in ("arrays.npz", "meta.json"):
        a = (tmp_path / "port" / "step_000000001" / name).read_bytes()
        b = (tmp_path / "ref" / "step_000000001" / name).read_bytes()
        if name == "meta.json":
            assert json.loads(a) == json.loads(b)
        else:
            pa = np.load(tmp_path / "port" / "step_000000001" / name)
            pb = np.load(tmp_path / "ref" / "step_000000001" / name)
            assert sorted(pa.files) == sorted(pb.files)
            for k in pa.files:
                np.testing.assert_array_equal(pa[k], pb[k])
                assert pa[k].dtype == pb[k].dtype


def test_atomic_rename_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=2)
    x = {"a": torch.arange(3.0)}
    for step in (1, 2, 3, 4):
        mgr.save(step, x)
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    # a leftover tmp directory (a killed writer) is never read as a step
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert mgr.latest_step() == 4
    mgr.save(4, {"a": torch.ones(3)})          # overwrite replaces atomically
    assert torch.equal(mgr.restore(4, x)["a"], torch.ones(3))


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=3)
    x = torch.arange(1000, dtype=torch.float32)
    mgr.save(1, {"x": x}, blocking=False)
    x.add_(1.0)                                # the host copy was taken
    mgr.save(2, {"x": x}, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    got = mgr.restore(1, {"x": x})["x"]
    assert torch.equal(got, torch.arange(1000, dtype=torch.float32))


def test_schema_mismatch_and_missing_leaf_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)})
    meta = tmp_path / "step_000000001" / "meta.json"
    data = json.loads(meta.read_text())
    data["schema_version"] = SCHEMA_VERSION + 1
    meta.write_text(json.dumps(data))
    with pytest.raises(CheckpointError, match="schema_version"):
        mgr.read_meta(1)
    with pytest.raises(CheckpointError, match="'b'"):
        mgr.restore(1, {"a": torch.zeros(2), "b": torch.zeros(2)})
    with pytest.raises(CheckpointError, match="unreadable"):
        mgr.read_meta(7)
    # shardings= re-shards onto a DeviceMesh (slice 10b); a None leaf
    # restores unsharded
    from torch.distributed.tensor import DTensor, Replicate
    from test_torch_mesh import one_rank_mesh
    with one_rank_mesh(tmp_path) as mesh:
        got = mgr.restore(1, {"a": torch.zeros(2)},
                          shardings={"a": (mesh, [Replicate()])})
        assert isinstance(got["a"], DTensor)
        assert torch.equal(got["a"].to_local(), torch.zeros(2))
    plain = mgr.restore(1, {"a": torch.zeros(2)}, shardings={"a": None})
    assert type(plain["a"]) is torch.Tensor


_ELASTIC = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.checkpoint import CheckpointManager

    ckpt, what, store = sys.argv[1], sys.argv[2], sys.argv[3]
    rank, world = int(sys.argv[4]), int(sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    mgr = CheckpointManager(ckpt, keep_k=2)
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "g": torch.arange(30, dtype=torch.int32).reshape(10, 3),
            "r": torch.tensor([2.5, -1.0]), "n": np.int32(7)}
    if what == "save":
        grid = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("pod", "data"))
        mgr.save(1, {"w": distribute_tensor(tree["w"], mesh, [Shard(0)]),
                     "g": distribute_tensor(tree["g"], grid,
                                            [Replicate(), Shard(0)]),
                     "r": distribute_tensor(tree["r"], grid,
                                            [Replicate(), Replicate()]),
                     "n": tree["n"]})
        # a mesh short of the process group is refused on its ranks,
        # before any collective
        sub = DeviceMesh("cpu", [0, 1], mesh_dim_names=("data",))
        if rank < 2:
            leaf = distribute_tensor(tree["w"], sub, [Shard(0)])
            try:
                mgr.save(2, {"w": leaf})
            except ValueError as e:
                assert "spans the process group" in str(e), e
            else:
                raise AssertionError("a sub-mesh save did not raise")
        dist.barrier()
        assert CheckpointManager(ckpt).all_steps() == [1]
    else:
        got = mgr.restore(1, tree, shardings={"w": (mesh, [Shard(0)]),
                                              "g": None, "r": None,
                                              "n": None})
        w = got["w"]
        assert isinstance(w, DTensor) and w.placements == (Shard(0),)
        assert torch.equal(w.to_local(),
                           tree["w"][rank * 8 // world:(rank + 1) * 8 // world])
        assert torch.equal(w.full_tensor(), tree["w"])
        for key in ("g", "r"):
            assert torch.equal(got[key], tree[key]), key
        assert int(got["n"]) == 7
    dist.destroy_process_group()
    print("OK")
""")


def _ranks(tmp_path, what, world):
    from conftest import SUBPROC_ENV
    store = tmp_path / f"store_{what}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ELASTIC, str(tmp_path / "ckpt"), what,
         str(store), str(r), str(world)], env=dict(SUBPROC_ENV,
                                                   OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "OK" in so, se[-2000:]


def test_elastic_restore_across_rank_counts(tmp_path):
    """Saved by 4 gloo ranks (each DTensor, on a 1-D or a (2, 2) mesh,
    gathered to rank 0, which writes; a mesh of 2 of the 4 ranks is
    refused), restored re-sharded onto a 2-rank mesh with
    ``shardings=``."""
    _ranks(tmp_path, "save", 4)
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [1]
    _ranks(tmp_path, "load", 2)


def test_bfloat16_leaf_round_trips_through_float32(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    mgr.save(1, {"x": x})
    assert np.load(tmp_path / "step_000000001" /
                   "arrays.npz")["['x']"].dtype == np.float32
    assert torch.equal(mgr.restore(1, {"x": x})["x"], x)


def _stream_pts(n=640, d=4, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("mode", ["plain", "ext", "gen"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stream_saved_by_one_restored_by_other(tmp_path, mode, writer):
    pts = _stream_pts()
    chunks = [pts[i * 64:(i + 1) * 64] for i in range(10)]
    whole = StreamingCoreset(4, 16, 4, mode=mode, device="cpu")
    for c in chunks:
        whole.update(c)
    if writer == "port":
        first = StreamingCoreset(4, 16, 4, mode=mode, device="cpu")
        for c in chunks[:5]:
            first.update(c)
        first.save(CheckpointManager(str(tmp_path)), 5)
        ref, step = RefStream.restore(RefManager(str(tmp_path)))
        assert step == 5 and ref.n_seen == 320
        got, _ = StreamingCoreset.restore(RefManager(str(tmp_path)),
                                          device="cpu")
    else:
        first = RefStream(4, 16, 4, mode=mode)
        for c in chunks[:5]:
            first.update(c)
        first.save(RefManager(str(tmp_path)), 5)
        got, step = StreamingCoreset.restore(CheckpointManager(str(tmp_path)),
                                             device="cpu")
        assert step == 5
    for c in chunks[5:]:
        got.update(c)
    a, b = whole.finalize(), got.finalize()
    assert torch.equal(a.points, b.points)
    assert a.cert.radius == b.cert.radius and a.cert.scale == b.cert.scale
    assert whole.phase_log == got.phase_log
    assert whole.generation == got.generation


def test_stream_restore_empty_dir_and_counter(tmp_path):
    from repro_torch.obs.trace import RunTrace, activate

    got, step = StreamingCoreset.restore(CheckpointManager(str(tmp_path)))
    assert got is None and step is None
    smm = StreamingCoreset(2, 8, 4, device="cpu")
    smm.update(_stream_pts(5))                  # still in the prefix buffer
    tr = RunTrace(enabled=True)
    with activate(tr):
        smm.save(CheckpointManager(str(tmp_path)), 1)
    assert tr.counters["checkpoints_written"] == 1
    back, _ = StreamingCoreset.restore(CheckpointManager(str(tmp_path)),
                                       device="cpu")
    assert back.n_seen == 5 and back.state is None
    assert torch.equal(torch.cat(back._prefix), torch.cat(smm._prefix))
