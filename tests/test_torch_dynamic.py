"""The port's dynamic index (``repro_torch.dynamic``) against the reference's
(``repro.dynamic``) on the CPU's plain path.

* Integer-lattice points (coordinates in [-50, 50], d = 4 and 8) make both
  packages exact: every squared distance is an integer below 2^24, so the
  reference's fp32 factorized numpy and the port's float64-summed tiles
  agree bit for bit, and so must every ``state_dict`` array, the phase
  log, the rebuild count and the query's ids and certificate, after every
  op of a churn stream with inserts, deletes of centers and of members and
  a triggered rebuild.
* Gaussian x 10 float data (euclidean, cosine): the reference cancels in
  fp32 (about eps·|x|² ≈ 1e-4 to 1e-3 in d² at |x| ≈ 30–75), the port sums
  in float64 and rounds once, so a ``dist <= r`` comparison may be decided
  differently and the structures may part.  There the port's own cover and
  packing invariants are held exactly at every active level, and the
  certificate against the reference's to rtol 5e-3 when the two structures
  agree on their center sets.
* The blocked greedy against a sequential oracle of the reference's loop
  (``src/repro/dynamic/levels.py:125-139``, a test helper here), bit for
  bit, under heavy ties: duplicates, distances of exactly r, blocks of 1,
  of a few points and of more than the far set.
* Checkpoints in both directions (port to reference and back), replayed
  to equal state; kill/resume inside the port; a schema mismatch raises.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.dynamic import DynamicIndex as RefIndex
from repro.dynamic import RebuildPolicy as RefPolicy
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.dynamic import (Delete, DynamicIndex, Insert,
                                 LevelStructure, RebuildPolicy,
                                 as_update_ops, is_update_stream, stream_dim)
from repro_torch.dynamic import levels
from repro_torch.dynamic.levels import Rows

ARRAYS = ("points", "alive", "radii", "center", "assign", "adist", "dirty",
          "frozen", "cover")


def _lattice(rng, n, d):
    return rng.integers(-50, 51, size=(n, d)).astype(np.float32)


def _gauss(rng, n, d):
    return (rng.normal(size=(n, d)) * 10.0).astype(np.float32)


def _assert_states_equal(ref, port):
    ra, rm = ref.state_dict()
    pa, pm = port.state_dict()
    assert set(ra) == set(pa) == set(ARRAYS)
    for name in ARRAYS:
        assert pa[name].dtype == ra[name].dtype, name
        assert pa[name].shape == ra[name].shape, name
        np.testing.assert_array_equal(pa[name], ra[name], err_msg=name)
    assert pm == rm


def _cert_dict(cert):
    return dataclasses.asdict(cert)


def _churn(rng, gen, n0, d, rounds=8, batch=60, kill=70):
    """A churn stream: a boot insert, then alternating deletes (some live
    ids, chosen by the caller's index) and inserts.  Returns the boot batch
    and the per-round insert batches; deletes are chosen during replay."""
    return gen(rng, n0, d), [gen(rng, batch, d) for _ in range(rounds)]


# --------------------------------------------------------------------------
# update-op vocabulary
# --------------------------------------------------------------------------

def test_update_ops_vocabulary():
    pts = np.zeros((50, 3), np.float32)
    assert not is_update_stream(pts)
    assert not is_update_stream([pts])                  # chunk stream
    assert not is_update_stream([])
    assert is_update_stream([Insert(pts), ("delete", [0, 1])])
    ops = as_update_ops(pts)                            # array sugar
    assert len(ops) == 1 and isinstance(ops[0], Insert)
    ops = as_update_ops(torch.as_tensor(pts))           # tensor sugar
    assert len(ops) == 1 and isinstance(ops[0], Insert)
    ops = as_update_ops([("insert", pts), Delete([3])])
    assert isinstance(ops[0], Insert) and isinstance(ops[1], Delete)
    with pytest.raises(ValueError, match="element 1"):
        as_update_ops([Insert(pts), "nonsense"])
    with pytest.raises(ValueError, match="materialized"):
        as_update_ops(iter([Insert(pts)]))
    assert stream_dim([Delete([0]), Insert(torch.zeros(4, 7))]) == 7
    assert stream_dim([Delete([0])]) is None


# --------------------------------------------------------------------------
# the blocked greedy against the sequential loop
# --------------------------------------------------------------------------

def _oracle_fold(center, assign, adist, ids, r, D):
    """The reference's ``LevelStructure._fold`` for one level, on numpy
    arrays, with ``D`` the full distance matrix of the point store (the
    port's plain oracle): the absorption pass, then the sequential greedy
    loop of ``levels.py:125-139`` verbatim.  Returns True iff the center
    set changed."""
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return False
    cen = np.flatnonzero(center)
    far = ids
    if cen.size:
        Dc = D[np.ix_(ids, cen)]
        j = np.argmin(Dc, axis=1)
        dnear = Dc[np.arange(ids.size), j]
        covered = dnear <= r
        cov = ids[covered]
        assign[cov] = cen[j[covered]]
        adist[cov] = dnear[covered]
        far = ids[~covered]
    if far.size == 0:
        return False
    mind = np.full(far.size, np.inf, np.float32)
    near = np.full(far.size, -1, np.int64)
    for i in range(far.size):
        if mind[i] <= r:
            assign[far[i]] = far[near[i]]
            adist[far[i]] = float(mind[i])
            continue
        center[far[i]] = True
        assign[far[i]] = far[i]
        adist[far[i]] = 0.0
        row = D[far[i], far]
        upd = row < mind
        mind[upd] = row[upd]
        near[upd] = i
    return True


def _tie_points(kind, rng):
    if kind == "duplicates":
        base = _lattice(rng, 40, 3)
        return np.concatenate([base, base[::-1], base, base[:7]])
    if kind == "exactly_r":
        # 3-4-5 lattice: many pairs at distance exactly 5 = r
        g = np.stack(np.meshgrid(np.arange(0, 16, 3), np.arange(0, 17, 4)),
                     -1).reshape(-1, 2).astype(np.float32)
        return np.concatenate([g, g + np.float32([0, 5]), g[::2]])
    return _lattice(rng, 150, 4)


@pytest.mark.parametrize("kind", ["duplicates", "exactly_r", "lattice"])
@pytest.mark.parametrize("block", [1, 3, 17, 64, 10_000])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_blocked_greedy_equals_sequential_oracle(kind, block, metric):
    """Two folds into one level (the second against the first's centers)
    equal the sequential loop bit for bit on ``center``/``assign``/
    ``adist``, for every block size, under ties: duplicates (distance 0),
    distances of exactly r, equidistant centers."""
    rng = np.random.default_rng(5)
    pts = _tie_points(kind, rng)
    rng.shuffle(pts)
    n = pts.shape[0]
    idx = DynamicIndex(dim=pts.shape[1], metric=metric, device="cpu")
    x = torch.as_tensor(pts)
    rows = Rows(x, torch.sum(x * x, dim=1) if metric == "euclidean"
                else None)
    D = idx._dist(rows, rows).numpy()
    r = np.float32(5.0)
    lv = LevelStructure(np.array([r]), lambda i: Rows(
        rows.points[i], None if rows.sq is None else rows.sq[i]),
        idx._dist, max_centers=10 ** 6, device="cpu")
    lv.block = block
    lv.ensure_rows(n)
    center = np.zeros(n, bool)
    assign = np.full(n, -1, np.int32)
    adist = np.zeros(n, np.float32)
    first = rng.permutation(n // 2)
    second = np.arange(n // 2, n)
    for ids in (first, second):
        want = _oracle_fold(center, assign, adist, ids, float(r), D)
        got = lv._fold(0, torch.as_tensor(ids))
        assert got == want
        np.testing.assert_array_equal(lv.center[0].numpy(), center)
        np.testing.assert_array_equal(lv.assign[0].numpy(), assign)
        np.testing.assert_array_equal(lv.adist[0].numpy(), adist)
    assert center.sum() > 1
    if kind == "exactly_r":
        assert (adist == r).any()


def test_resolve_decides_a_chain():
    """A path graph (each candidate within r of the next only) is the
    deepest dependency the device resolution meets: alternate candidates
    are accepted, as the sequential loop accepts them."""
    from repro_torch.dynamic.levels import _resolve

    c = 23
    adj = torch.zeros((c, c), dtype=torch.bool)
    adj[torch.arange(c - 1), torch.arange(1, c)] = True
    syncs = [0]
    acc = _resolve(adj, syncs)
    assert acc.tolist() == [i % 2 == 0 for i in range(c)]
    assert syncs[0] >= 1


# --------------------------------------------------------------------------
# integer lattice: bit-equal to the reference through a churn stream
# --------------------------------------------------------------------------

def _replay_both(metric, d, seed=0, budget=16):
    rng = np.random.default_rng(seed)
    boot, batches = _churn(rng, _lattice, 400, d)
    pol = dict(levels=8, max_deleted_frac=0.3)
    ref = RefIndex(dim=d, metric=metric, budget=budget,
                   policy=RefPolicy(**pol))
    port = DynamicIndex(dim=d, metric=metric, budget=budget,
                        policy=RebuildPolicy(**pol), device="cpu")
    np.testing.assert_array_equal(ref.insert(boot), port.insert(boot))
    _assert_states_equal(ref, port)
    for j, batch in enumerate(batches):
        # delete some of level 2's centers and some members
        alive = np.flatnonzero(ref._alive)
        centers = np.flatnonzero(ref._levels.center[2] & ref._alive) \
            if ref._levels is not None else alive[:0]
        kill = np.union1d(rng.choice(centers, size=min(3, centers.size),
                                     replace=False),
                          rng.choice(alive, size=40, replace=False))
        ref.delete(kill)
        port.delete(torch.as_tensor(kill) if j % 2 else kill)
        _assert_states_equal(ref, port)
        np.testing.assert_array_equal(ref.insert(batch), port.insert(batch))
        _assert_states_equal(ref, port)
        qr, qp = ref.query(5), port.query(5)
        np.testing.assert_array_equal(qp.ids, qr.ids)
        np.testing.assert_array_equal(qp.solution.numpy(), qr.solution)
        assert _cert_dict(qp.cert) == _cert_dict(qr.cert)
        assert qp.level == qr.level
        _assert_states_equal(ref, port)
    return ref, port


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_lattice_churn_bit_equal_to_reference(metric, d, monkeypatch):
    monkeypatch.setattr(levels, "BLOCK", 64)
    ref, port = _replay_both(metric, d)
    assert port.rebuilds == ref.rebuilds >= 2      # boot + a churn rebuild
    assert port.phase_log == ref.phase_log
    assert [e for e, _ in port.phase_log][:2] == ["boot", "rebuild"]
    assert port.host_syncs > 0


@pytest.mark.parametrize("block", [1, 7, 4096])
def test_lattice_parity_any_block(block, monkeypatch):
    """The block of the greedy pass changes nothing (d = 4, euclidean)."""
    monkeypatch.setattr(levels, "BLOCK", block)
    _replay_both("euclidean", 4, seed=1)


def test_lattice_remote_clique_query():
    rng = np.random.default_rng(2)
    pts = _lattice(rng, 300, 4)
    ref, port = RefIndex(dim=4, budget=24), DynamicIndex(dim=4, budget=24,
                                                         device="cpu")
    ref.insert(pts)
    port.insert(pts)
    qr = ref.query(6, measure="remote-clique")
    qp = port.query(6, measure="remote-clique")
    np.testing.assert_array_equal(qp.ids, qr.ids)
    assert _cert_dict(qp.cert) == _cert_dict(qr.cert)


def test_insert_delete_query_basics():
    idx = DynamicIndex(dim=5, budget=32, device="cpu")
    ids = idx.insert(_gauss(np.random.default_rng(0), 200, 5))
    np.testing.assert_array_equal(ids, np.arange(200))
    assert idx.n_alive == 200 and idx.booted
    idx.delete(ids[:40])
    assert idx.n_alive == 160
    q = idx.query(6)
    assert tuple(q.solution.shape) == (6, 5)
    assert len(set(q.ids.tolist())) == 6 and np.all(q.ids >= 40)
    assert q.cert.kind == "dynamic" and q.cert.deletions_absorbed == 40
    with pytest.raises(ValueError, match="already deleted"):
        idx.delete([0])
    with pytest.raises(ValueError, match="unknown id"):
        idx.delete([10_000])
    with pytest.raises(ValueError, match="dim"):
        idx.insert(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="triangle"):
        DynamicIndex(dim=3, metric="sqeuclidean", device="cpu")
    small = DynamicIndex(dim=2, device="cpu")
    small.insert(np.zeros((1, 2), np.float32))   # one point: not booted
    assert not small.booted
    with pytest.raises(ValueError, match="live points"):
        small.query(2)


def test_buffers_grow_by_doubling():
    idx = DynamicIndex(dim=3, device="cpu")
    rng = np.random.default_rng(4)
    caps = []
    for _ in range(12):
        idx.insert(_gauss(rng, 37, 3))
        caps.append(idx._pts_buf.shape[0])
    assert idx.n_rows == 12 * 37
    assert len(set(caps)) <= 5          # 37 -> 74 -> 148 -> 296 -> 592
    assert idx._levels.center_buf.shape[1] >= idx.n_rows


# --------------------------------------------------------------------------
# float data: invariants, and certificates against the reference
# --------------------------------------------------------------------------

def _check_invariants(idx):
    """Cover and packing at every active level, with the index's own
    distance oracle: every live point's center is a live center within
    r_l, at the recorded distance; live centers pairwise farther than
    r_l."""
    lv = idx._levels
    alive = idx._alive
    live = torch.nonzero(alive).flatten()
    for lev in range(lv.L):
        if lv.frozen[lev]:
            break
        r = float(lv.radii[lev])
        a = lv.assign[lev][live].long()
        assert bool((a >= 0).all())
        assert bool(lv.center[lev][a].all() and alive[a].all())
        # the recorded distance was measured center -> point or point ->
        # center; the other orientation may differ at a float64 near-tie
        # (a center's own entry is 0 by definition, not a measured self-
        # distance, which the factorized form leaves at rounding size)
        member = a != live
        d = idx._pair(live[member], a[member]).diagonal()
        torch.testing.assert_close(d, lv.adist[lev][live][member],
                                   rtol=1e-6, atol=1e-6)
        assert bool((lv.adist[lev][live][~member] == 0).all())
        assert bool((lv.adist[lev][live] <= r).all())
        cen = lv.centers_of(lev, alive)
        if cen.numel() > 1:
            dc = idx._pair(cen, cen)
            off = ~torch.eye(cen.numel(), dtype=torch.bool)
            assert bool((dc[off] > r).all()), lev
        if not lv.dirty[lev]:
            assert float(lv.adist[lev][live].max()) <= float(lv.cover[lev])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_float_churn_invariants_and_certificates(metric, monkeypatch):
    """Gaussian x 10 data: the port's invariants hold after every op; its
    certificate is within rtol 5e-3 of the reference's wherever the two
    chose the same query centers (the fp32-cancellation difference above
    can move a center in or out; then only the invariants are held)."""
    rng = np.random.default_rng(7)
    d = 8
    boot, batches = _churn(rng, _gauss, 500, d, rounds=6)
    pol = dict(max_deleted_frac=0.3)
    ref = RefIndex(dim=d, metric=metric, budget=32, policy=RefPolicy(**pol))
    monkeypatch.setattr(levels, "BLOCK", 128)
    port = DynamicIndex(dim=d, metric=metric, budget=32, device="cpu",
                        policy=RebuildPolicy(**pol))
    ref.insert(boot)
    port.insert(boot)
    _check_invariants(port)
    compared = 0
    for batch in batches:
        kill = rng.choice(np.flatnonzero(ref._alive), size=80,
                          replace=False)
        for idx in (ref, port):
            idx.delete(kill)
            idx.insert(batch)
        _check_invariants(port)
        qr, qp = ref.query(6), port.query(6)
        assert qp.cert.kind == "dynamic"
        assert qp.cert.updates_since_rebuild == qr.cert.updates_since_rebuild
        assert qp.cert.deletions_absorbed == qr.cert.deletions_absorbed
        same = (qp.level == qr.level and qp.coreset.size == qr.coreset.size
                and np.array_equal(
                    port._levels.centers_of(qp.level, port._alive).numpy(),
                    ref._levels.centers_of(qr.level, ref._alive)))
        if same:
            compared += 1
            np.testing.assert_allclose(qp.cert.radius, qr.cert.radius,
                                       rtol=5e-3)
            np.testing.assert_allclose(qp.cert.scale, qr.cert.scale,
                                       rtol=5e-3)
    assert port.rebuilds == ref.rebuilds
    assert compared >= 1


# --------------------------------------------------------------------------
# checkpoints: both directions, kill/resume, schema
# --------------------------------------------------------------------------

def _lattice_ops(seed=3, d=5, rounds=10):
    rng = np.random.default_rng(seed)
    ops = [("insert", _lattice(rng, 300, d))]
    for j in range(rounds):
        if j % 3 == 2:
            ops.append(("delete", np.arange(j * 15, j * 15 + 15)))
        else:
            ops.append(("insert", _lattice(rng, 40, d)))
    return ops


def _apply(idx, op):
    (idx.insert if op[0] == "insert" else idx.delete)(op[1])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ops = _lattice_ops()
    port = DynamicIndex(dim=5, budget=24, device="cpu")
    ref = RefIndex(dim=5, budget=24)
    for op in ops[:6]:
        _apply(port, op)
        _apply(ref, op)
    port.save(CheckpointManager(str(tmp_path)), 6)
    back, step = RefIndex.restore(RefManager(str(tmp_path)))
    assert step == 6
    _assert_states_equal(back, port)
    for op in ops[6:]:
        _apply(back, op)
        _apply(ref, op)
    _assert_states_equal(back, DynamicIndex.from_state_dict(
        *ref.state_dict(), device="cpu"))
    assert _cert_dict(back.query(6).cert) == _cert_dict(ref.query(6).cert)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ops = _lattice_ops(seed=4)
    ref = RefIndex(dim=5, budget=24)
    port = DynamicIndex(dim=5, budget=24, device="cpu")
    for op in ops[:7]:
        _apply(ref, op)
        _apply(port, op)
    ref.save(RefManager(str(tmp_path)), 7)
    back, step = DynamicIndex.restore(CheckpointManager(str(tmp_path)),
                                      device="cpu")
    assert step == 7
    _assert_states_equal(ref, back)
    for op in ops[7:]:
        _apply(back, op)
        _apply(port, op)
        _apply(ref, op)
    _assert_states_equal(ref, back)
    _assert_states_equal(ref, port)
    qa, qb = back.query(6), port.query(6)
    np.testing.assert_array_equal(qa.ids, qb.ids)
    assert qa.cert == qb.cert


def test_kill_resume_bit_identical_inside_the_port(tmp_path):
    rng = np.random.default_rng(9)
    ops = [("insert", _gauss(rng, 300, 6))] + [
        ("delete", np.arange(j * 15, j * 15 + 15)) if j % 3 == 2 else
        ("insert", _gauss(rng, 40, 6)) for j in range(12)]
    whole = DynamicIndex(dim=6, budget=32, device="cpu")
    part = DynamicIndex(dim=6, budget=32, device="cpu")
    for op in ops:
        _apply(whole, op)
    for op in ops[:8]:
        _apply(part, op)
    mgr = CheckpointManager(str(tmp_path))
    part.save(mgr, 8)
    back, _ = DynamicIndex.restore(mgr, device="cpu")
    same = DynamicIndex.from_state_dict(*part.state_dict(), device="cpu")
    for op in ops[8:]:
        _apply(back, op)
        _apply(same, op)
    for idx in (back, same):
        a, b = whole.state_dict(), idx.state_dict()
        for name in ARRAYS:
            np.testing.assert_array_equal(a[0][name], b[0][name])
        assert a[1] == b[1]
    for idx in (back, same):
        qa, qb = whole.query(8), idx.query(8)
        assert torch.equal(qa.solution, qb.solution) and qa.cert == qb.cert


def test_checkpoint_schema_version_mismatch(tmp_path):
    idx = DynamicIndex(dim=5, budget=32, device="cpu")
    idx.insert(_gauss(np.random.default_rng(0), 100, 5))
    mgr = CheckpointManager(str(tmp_path))
    idx.save(mgr, 1)
    meta_path = os.path.join(str(tmp_path), "step_000000001", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["schema_version"] = 999
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(CheckpointError, match="schema_version=999"):
        DynamicIndex.restore(mgr, device="cpu")
    del meta["schema_version"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    back, step = DynamicIndex.restore(mgr, device="cpu")
    assert step == 1 and back.n_alive == 100
    assert DynamicIndex.restore(CheckpointManager(str(tmp_path / "none")),
                                device="cpu") == (None, None)


def test_unbooted_state_round_trips():
    idx = DynamicIndex(dim=3, device="cpu")
    idx.insert(np.ones((1, 3), np.float32))
    arrays, meta = idx.state_dict()
    assert not meta["booted"] and arrays["center"].shape == (10, 1)
    back = DynamicIndex.from_state_dict(arrays, meta, device="cpu")
    back.insert(np.zeros((3, 3), np.float32))
    idx.insert(np.zeros((3, 3), np.float32))
    assert back.booted and idx.booted
    for name in ARRAYS:
        np.testing.assert_array_equal(back.state_dict()[0][name],
                                      idx.state_dict()[0][name])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DynamicIndex(dim=3)
    with pytest.raises(ValueError, match="CUDA"):
        DynamicIndex(dim=3, device="cpu", use_pallas=True)


@pytest.mark.parametrize("modname", ["repro_torch.dynamic.index",
                                     "repro_torch.api"])
def test_module_doctests(modname):
    """The docstring examples of the dynamic index and the facade run (on
    the CPU's plain path)."""
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(modname),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0
