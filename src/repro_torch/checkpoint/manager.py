"""Atomic, async checkpointing (port of ``repro.checkpoint.manager``).

Layout per step, the reference's byte for byte::

    <dir>/step_000123.tmp/     (written first)
        meta.json              ({"step", "schema_version", "extra"})
        arrays.npz             (flattened leaves keyed by tree path)
    <dir>/step_000123/         (atomic rename when complete)

* atomic: readers never see partial checkpoints (write-tmp + rename, with
  the payload files, the tmp directory and then the parent fsynced);
* async: ``save(..., blocking=False)`` copies the tensors to the host and
  hands them to a writer thread; ``wait()`` joins it;
* keep_k garbage collection.

``arrays.npz`` is keyed by the paths ``jax.tree_util.keystr`` gives, made
here without JAX from the port's own flattening of dicts (keys sorted,
``['name']``), lists and tuples (``[i]``) and NamedTuples (``.field``), so a
checkpoint written by either package restores in the other.  A leaf is a
tensor, a numpy array or a scalar; ``None`` is an empty subtree, as in JAX.

Across the ranks of a ``torch.distributed`` mesh: a tree holding
``DTensor`` leaves is saved by every rank of the process group together,
at once (``blocking=False`` too: the gather is a collective).  The
leaves' meshes must span the group; each leaf, placed ``Shard(d)`` on any
dim or ``Replicate`` along each mesh axis (several mesh axes may split
one dim, in mesh order, each evenly), is gathered to the first rank of
the first leaf's mesh alone, which writes, and then the ranks meet at a
barrier.  ``restore(shardings=)`` re-shards each leaf onto a
``DeviceMesh`` of any size (``distribute_tensor``), so a run saved at 4
ranks resumes at 2; a template leaf that is a DTensor comes back placed
as it is, unless ``shardings`` says otherwise.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import is_dtensor


class CheckpointError(RuntimeError):
    """A checkpoint is unreadable or incompatible with the restore template
    (e.g. a template leaf missing from the archive — a renamed field, a
    truncated write on a non-atomic filesystem, or the wrong directory)."""


# Version of the on-disk checkpoint layout (meta.json + arrays.npz keying),
# the reference's.  ``read_meta`` refuses checkpoints written by another
# schema; checkpoints predating the field are schema 1.
SCHEMA_VERSION = 1


class ShapeDtype(NamedTuple):
    """A restore-template leaf standing for an array of this dtype (the
    port's ``jax.ShapeDtypeStruct``).  ``shape`` is informational: the
    archive's array keeps its own shape, as in the reference."""
    shape: Tuple[int, ...]
    dtype: Any


def _fsync_dir(path: str) -> None:
    """Fsync a directory so the rename/creation it contains is durable (on
    platforms whose dirs can't be opened for fsync, degrade gracefully)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                                  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:                                  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, ShapeDtype):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _items(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}[{i}]")
    else:
        yield path, tree


def keystr_paths(tree):
    """The ``jax.tree_util.keystr`` path of every leaf of ``tree``, in
    flattening order."""
    return [p for p, _ in _items(tree)]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view: an async save must not see
    the caller's later writes)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype.is_floating_point and leaf.dtype not in (
                torch.float16, torch.float32, torch.float64):
            leaf = leaf.to(torch.float32)       # bf16 & co: no numpy dtype
        return leaf.to("cpu", copy=True).numpy()
    arr = np.array(leaf)
    if arr.dtype.kind not in "fiub?" or str(arr.dtype) == "bfloat16":
        # npz can't serialize ml_dtypes — store as f32; the restore
        # template's dtype casts back losslessly
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> dict:
    return {path: _host(leaf) for path, leaf in _items(tree)}


def _sharded_writer(leaves) -> int:
    """The global rank that writes a tree with the DTensor ``leaves``: the
    first rank of the first leaf's mesh.  Every leaf's mesh must span the
    whole process group (every rank saves, and the gathers and the
    barrier run over the default group) and be placed ``Shard`` or
    ``Replicate`` along each axis, each split dim even."""
    import torch.distributed as dist

    world = dist.get_world_size()
    for path, leaf in leaves:
        mesh = leaf.device_mesh
        if mesh.size() != world:
            raise ValueError(
                f"leaf {path!r} lives on a mesh of {mesh.size()} ranks in a "
                f"process group of {world}: a tree with DTensor leaves is "
                f"saved by a mesh that spans the process group")
        if not all(pl.is_replicate() or pl.is_shard()
                   for pl in leaf.placements):
            raise ValueError(
                f"leaf {path!r} is placed {tuple(leaf.placements)}: a saved "
                f"DTensor is Shard or Replicate along each mesh axis")
        for d, n in _splits(leaf).items():
            if leaf.shape[d] % n:
                raise ValueError(
                    f"leaf {path!r}: dim {d} of size {leaf.shape[d]} does "
                    f"not split evenly over {n} ranks")
    return int(leaves[0][1].device_mesh.mesh.reshape(-1)[0])


def _splits(leaf) -> dict:
    """tensor dim -> the number of blocks the DTensor ``leaf`` splits it
    into."""
    out = {}
    for i, pl in enumerate(leaf.placements):
        if pl.is_shard():
            out[pl.dim] = out.get(pl.dim, 1) * int(leaf.device_mesh.size(i))
    return out


def _block(leaf, coord) -> tuple:
    """The slices of the full array that the shard of the rank at mesh
    coordinate ``coord`` holds: along each dim, its block in row-major
    order of the mesh dims that split it (mesh order, as DTensor deals
    nested shards)."""
    index = [0] * leaf.ndim
    for i, pl in enumerate(leaf.placements):
        if pl.is_shard():
            index[pl.dim] = (index[pl.dim] * int(leaf.device_mesh.size(i))
                             + int(coord[i]))
    splits = _splits(leaf)
    out = []
    for d, size in enumerate(leaf.shape):
        per = size // splits.get(d, 1)
        out.append(slice(index[d] * per, (index[d] + 1) * per))
    return tuple(out)


def _gather_to(leaf, writer: int):
    """The full array of the DTensor ``leaf`` on rank ``writer`` (None on
    the others), from one copy of each shard: the ranks at coordinate 0 of
    the replicated axes send their local shard and coordinate, which the
    writer puts in its block."""
    import torch.distributed as dist

    mesh, placements = leaf.device_mesh, leaf.placements
    coord = mesh.get_coordinate()
    copy = not any(coord[i] for i, pl in enumerate(placements)
                   if pl.is_replicate())
    box = [None] * dist.get_world_size() if dist.get_rank() == writer else None
    dist.gather_object((list(coord), _host(leaf.to_local())) if copy
                       else None, box, dst=writer)
    if box is None:
        return None
    parts = [b for b in box if b is not None]
    out = np.empty(tuple(leaf.shape), dtype=parts[0][1].dtype)
    for c, part in parts:
        out[_block(leaf, c)] = part
    return out


def _leaf_shardings(template, shardings) -> dict:
    """keystr path -> ``(mesh, placements)`` of the ``shardings`` tree, read
    along the template's structure (a template leaf's entry may be None:
    that leaf is restored unsharded)."""
    out = {}

    def walk(t, s, path):
        if t is None:
            return
        if s is None:
            out.update((p, None) for p, _ in _items(t, path))
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s[k], f"{path}[{k!r}]")
        elif _is_namedtuple(t) and not isinstance(t, ShapeDtype):
            for f in t._fields:
                walk(getattr(t, f), getattr(s, f), f"{path}.{f}")
        elif isinstance(t, (list, tuple)) and not isinstance(t, ShapeDtype):
            for i, v in enumerate(t):
                walk(v, s[i], f"{path}[{i}]")
        else:
            out[path] = s

    walk(template, shardings, "")
    return out


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), np.dtype(dtype))).dtype


def _rebuild(tree, fill, path: str = ""):
    """``tree``'s structure with every leaf replaced by ``fill(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, ShapeDtype):
        return fill(path, tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, fill, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fill, f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fill, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fill(path, tree)


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3):
        self.dir = directory
        self.keep_k = keep_k
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             blocking: bool = True):
        # copy to the host BEFORE handing to the writer thread, so the
        # caller may overwrite its device tensors at once
        meta = {"step": int(step), "schema_version": SCHEMA_VERSION,
                "extra": extra or {}}
        sharded = [(p, leaf) for p, leaf in _items(tree) if is_dtensor(leaf)]
        if sharded:
            self.wait()
            self._save_sharded(step, tree, sharded, meta)
            return
        arrays = _flatten(tree)
        if blocking:
            self._write(step, arrays, meta)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, meta), daemon=True)
            self._thread.start()

    def _save_sharded(self, step: int, tree, sharded, meta: dict):
        """Every rank's part of saving a tree with DTensor leaves: each
        leaf gathered to the writer (``_sharded_writer``), which alone
        copies the other leaves and writes; then a barrier of the group."""
        import torch.distributed as dist

        writer = _sharded_writer(sharded)
        full = {p: _gather_to(leaf, writer) for p, leaf in sharded}
        if dist.get_rank() == writer:
            self._write(step, {p: full[p] if p in full else _host(leaf)
                               for p, leaf in _items(tree)}, meta)
        dist.barrier()

    def _write(self, step: int, arrays: dict, meta: dict):
        with self._lock:
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            # fsync both payload files, then the tmp dir, BEFORE the rename:
            # the atomic rename only guarantees readers never see a partial
            # checkpoint if the contents are durable when the name appears
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_dir(self.dir)
            self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, *, shardings=None, device=None):
        """Restore into the structure of ``template`` (a tree of tensors,
        arrays or ``ShapeDtype`` stand-ins): every leaf comes back as a
        tensor of the template leaf's dtype, on ``device`` (default: the
        template tensor's device, the CPU for other leaves).  ``shardings``
        (a tree of the template's structure whose leaves are ``(mesh,
        placements)`` pairs, or None) re-shards each leaf onto its
        ``DeviceMesh`` with ``distribute_tensor``: every rank of that mesh
        restores together, and the mesh may have another size than the one
        that saved; each rank reads the archive and keeps its shard.  A
        template leaf that is a DTensor, with no ``shardings`` entry,
        comes back placed as it is."""
        spec = {} if shardings is None else _leaf_shardings(template,
                                                            shardings)
        path = os.path.join(self.dir, f"step_{step:09d}")
        data = np.load(os.path.join(path, "arrays.npz"))

        def fill(key, leaf):
            if key not in data.files:
                raise CheckpointError(
                    f"checkpoint step {step} at {path!r} has no array for "
                    f"template leaf {key!r} (archive holds "
                    f"{sorted(data.files)}); the template structure does "
                    f"not match what was saved")
            dev = device
            if dev is None:
                dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            dtype = getattr(leaf, "dtype", None)
            dtype = _torch_dtype(np.asarray(leaf).dtype if dtype is None
                                 else dtype)
            out = torch.as_tensor(np.asarray(data[key]), dtype=dtype,
                                  device=dev)
            place = spec.get(key)
            if place is None and key not in spec and is_dtensor(leaf):
                place = (leaf.device_mesh, leaf.placements)
            if place is not None:
                from torch.distributed.tensor import distribute_tensor
                mesh, placements = place
                out = distribute_tensor(out, mesh, list(placements),
                                        src_data_rank=None)
            return out

        return _rebuild(template, fill)

    def read_meta(self, step: int) -> dict:
        """The meta.json of one checkpoint (``{"step", "extra"}``) — lets a
        restorer recover host-side context (e.g. a streaming run's phase log)
        saved via ``save(..., extra=...)``."""
        path = os.path.join(self.dir, f"step_{step:09d}", "meta.json")
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointError(
                f"checkpoint step {step}: unreadable meta.json at "
                f"{path!r}: {e}") from e
        found = meta.get("schema_version", 1)
        if found != SCHEMA_VERSION:
            raise CheckpointError(
                f"checkpoint step {step} at {path!r} was written with "
                f"schema_version={found}; this build reads "
                f"schema_version={SCHEMA_VERSION} — re-create the "
                "checkpoint (or restore with a matching build)")
        return meta

    def restore_latest(self, template, *, shardings=None, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template, shardings=shardings,
                                  device=device)
