"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``repro.launch.dryrun`` pieces.

* Placements: for every arch × applicable shape × both production meshes
  (66 cells), every leaf's local shape and each tree's per-rank bytes
  (params, optimizer state, batch, cache) equal the reference's
  ``NamedSharding(AbstractMesh(...), spec).shard_shape(shape)`` under the
  reference's own ``rules_for`` and specs.  Both sides read a shape-only
  mesh: no devices, no ranks (the reference's ``rules_for`` reads
  ``len(mesh.devices)`` on decode cells, so its stand-in has a devices
  array).  A mesh on which some dims do not divide is reported invalid on
  exactly the leaves where the reference's ``shard_shape`` raises.
* Traces: one subprocess, started once for the module with
  ``OMP_NUM_THREADS=1`` (so no xdist worker keeps a default process
  group), runs reduced granite-moe, internlm2 and mamba2 train steps on a
  (2, 2) fake mesh, reduced internlm2 serve steps there (a batch-split
  prefill, a split-KV decode under ``pad_heads`` and a context-parallel
  decode), internlm2-1.8b's full-width split-KV decode of batch 8 over
  2,048 slots on (2, 2) (the card's (d_tp) cell, its bytes reckoned from
  the config), granite-moe's full-width ``train_4k`` cell on (16, 16),
  gemma-2b's full-width ``decode_32k`` cell on (16, 16), the paper cell
  on (16, 16) (exact GMM) and (2, 16, 16) (b = 8), an invalid cell,
  granite-moe with its experts gathered (``shard_map_moe=False``) and a
  call under a real group; a second subprocess runs the command line.
  ``tests/test_torch_sharded_serve.py`` holds the serve traces' bytes to
  its gloo ranks'.
"""
import json
import pickle
import subprocess
import sys
import textwrap
import time
import types

from conftest import SUBPROC_ENV

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.launch import dryrun

TIMEOUT = 300
REDUCED = ("granite-moe-1b-a400m", "internlm2-1.8b", "mamba2-130m")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, shape, mp) for mp in (False, True) for arch in ARCH_IDS
         for shape, cell in SHAPES.items()
         if applicable(get_config(arch), cell)]
# the reference's JSON keys (``compile_s`` becomes ``trace_s``)
REFERENCE_KEYS = {"flops_per_device", "bytes_per_device",
                  "collective_bytes_per_device", "collective_total",
                  "xla_flops_single_visit", "xla_bytes_single_visit",
                  "collective_single_visit", "argument_bytes",
                  "output_bytes", "temp_bytes", "peak_bytes", "arch",
                  "shape", "chips", "params", "active_ratio", "trace_s"}

_TRACES = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import current_mesh

    OUT = sys.argv[1]
    rec = {"imported_without_group": not dist.is_initialized()}

    def after():
        return {"group": dist.is_initialized(),
                "mesh": current_mesh() is not None}

    def record(trace, meta):
        info = dryrun.analyze(trace)
        info.update(meta)
        return info

    def small_mesh(shape):
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    cell = ShapeCell("train", "train", 32, 8)
    for arch in @REDUCED@:
        with dryrun.fake_group(4):
            rec[arch] = record(*dryrun.lower_config(
                get_config(arch, reduced=True), cell, small_mesh((2, 2))))
        rec[arch]["after"] = after()
    internlm2 = get_config("internlm2-1.8b", reduced=True)
    for name, cfg, serve in (
            ("prefill", internlm2, ShapeCell("prefill", "prefill", 32, 8)),
            ("split_kv", dataclasses.replace(
                internlm2, attn_shard="pad_heads", attn_pad_to=4),
             ShapeCell("decode", "decode", 32, 8)),
            ("context_parallel", internlm2,
             ShapeCell("decode", "decode", 32, 2))):
        with dryrun.fake_group(4):
            rec[name] = record(*dryrun.lower_config(cfg, serve,
                                                    small_mesh((2, 2))))
        rec[name]["after"] = after()
    # (d_tp): internlm2-1.8b at full width, split-KV decode of batch 8 over
    # 2,048 slots on (2, 2)
    with dryrun.fake_group(4):
        rec["d_tp"] = record(*dryrun.lower_config(
            get_config("internlm2-1.8b"), ShapeCell("decode", "decode", 2048,
                                                    8), small_mesh((2, 2))))
    rec["d_tp"]["after"] = after()
    with dryrun.fake_group(256):
        rec["full_decode"] = record(*dryrun.lower_cell(
            "gemma-2b", "decode_32k", make_production_mesh()))
    rec["full_decode"]["after"] = after()
    with dryrun.fake_group(256):
        rec["full"] = record(*dryrun.lower_cell(
            "granite-moe-1b-a400m", "train_4k", make_production_mesh()))
    rec["full"]["after"] = after()
    with dryrun.fake_group(256):
        rec["paper"] = record(*dryrun.lower_paper_cell(
            make_production_mesh()))
    with dryrun.fake_group(512):
        rec["paper_mp"] = record(*dryrun.lower_paper_cell(
            make_production_mesh(multi_pod=True), batch_b=8))
    with dryrun.fake_group(6):
        rec["invalid"] = record(*dryrun.lower_cell(
            "gemma-2b", "train_4k", small_mesh((2, 3))))
    with dryrun.fake_group(4):
        rec["gathered_experts"] = record(*dryrun.lower_config(
            get_config("granite-moe-1b-a400m", reduced=True), cell,
            small_mesh((2, 2)), shard_map_moe=False))
    rec["gathered_experts"]["after"] = after()
    dist.init_process_group("gloo", init_method="file://" + OUT + "/store",
                            rank=0, world_size=1)
    try:
        with dryrun.fake_group(4):
            rec["real_group"] = None
    except RuntimeError as e:
        rec["real_group"] = str(e)
    dist.destroy_process_group()
    with open(os.path.join(OUT, "traces.pkl"), "wb") as f:
        pickle.dump(rec, f)
""").replace("@REDUCED@", repr(REDUCED))


@pytest.fixture(scope="module", autouse=True)
def traced(tmp_path_factory):
    """Start the trace subprocess and the command line once, at the
    module's first test; ``wait(who)`` returns their results."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(SUBPROC_ENV, OMP_NUM_THREADS="1")
    procs = {
        "traces": subprocess.Popen(
            [sys.executable, "-c", _TRACES, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "gemma-2b", "--shape", "train_4k", "--out",
             str(out / "gemma-2b_train_4k.json")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    deadline = time.monotonic() + TIMEOUT
    done = {}

    def wait(who):
        if who not in done:
            p = procs[who]
            so, se = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            assert p.returncode == 0, f"{who} exited {p.returncode}:\n{se}"
            done[who] = so
        if who == "traces":
            with open(out / "traces.pkl", "rb") as f:
                return pickle.load(f)
        with open(out / "gemma-2b_train_4k.json") as f:
            return json.load(f), done[who]

    try:
        yield wait
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# placements against the reference (in process, shape-only meshes)
# ---------------------------------------------------------------------------

def _port_mesh(sizes, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=sizes)


def _reference_placed(arch, shape, sizes, names):
    """name -> (path -> local shape or None where ``shard_shape`` raises,
    bytes) of the reference's params, optimizer state, batch and cache
    under its own rules and specs on the mesh shape ``sizes``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    import repro.models as RM
    from repro.configs import SHAPES as RSHAPES, get_config as rget
    from repro.launch.sharding import batch_struct, cache_struct, rules_for
    from repro.train import default_optimizer

    cfg, cell = rget(arch), RSHAPES[shape]
    stand_in = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, sizes)),
                                     devices=np.empty(sizes))
    rules = rules_for(cfg, cell, stand_in)
    pshapes, pspecs = RM.param_shapes(cfg), RM.param_specs(cfg, rules)
    trees = {"params": (pshapes, pspecs)}
    if cell.kind == "train":
        opt = default_optimizer(cfg)
        trees["opt_state"] = (opt.state_shapes(pshapes),
                              opt.state_specs(pspecs))
        trees["batch"] = batch_struct(cfg, cell, rules)
    else:
        if cell.kind == "prefill":
            trees["batch"] = batch_struct(cfg, cell, rules)
        else:
            bt = rules.resolve("batch")
            trees["batch"] = ({"tokens": jax.ShapeDtypeStruct(
                (cell.global_batch, 1), jnp.int32)},
                {"tokens": JP(bt, None)})
        trees["cache"] = cache_struct(cfg, cell, rules)
    mesh = AbstractMesh(tuple(sizes), tuple(names))
    out = {}
    for name, (shapes, specs) in trees.items():
        is_spec = lambda x: isinstance(x, JP)
        flat_specs = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=is_spec)[0]
        flat_shapes = jax.tree_util.tree_leaves(shapes)
        assert len(flat_specs) == len(flat_shapes), name
        local, nbytes = {}, 0
        for (path, spec), sds in zip(flat_specs, flat_shapes):
            key = jax.tree_util.keystr(path)
            try:
                shp = NamedSharding(mesh, spec).shard_shape(tuple(sds.shape))
            except ValueError:
                local[key] = None
                continue
            local[key] = tuple(shp)
            nbytes += int(np.prod(shp, dtype=np.int64)) * np.dtype(
                sds.dtype).itemsize
        out[name] = (local, nbytes)
    return out


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}"
                              for a, s, m in CELLS])
def test_placements_equal_the_references(arch, shape, multi_pod):
    sizes, names = MESHES[multi_pod]
    got = dryrun.place_cell(get_config(arch), SHAPES[shape],
                            _port_mesh(sizes, names))
    assert got["invalid"] == [], got["invalid"]
    want = _reference_placed(arch, shape, sizes, names)
    assert sorted(got["trees"]) == sorted(want)
    for name, (local, nbytes) in want.items():
        tree = got["trees"][name]
        assert tree["local"] == local, name
        assert tree["bytes"] == nbytes, name
    assert got["argument_bytes"] == sum(b for _, b in want.values())


def test_cells_are_the_references_66():
    assert len(CELLS) == 66


def test_invalid_placement_is_the_references():
    """On a (2, 3) mesh gemma-2b's train cell has dims that do not split
    over 3 ranks: the port reports exactly the leaves on which the
    reference's ``shard_shape`` raises."""
    sizes, names = (2, 3), ("data", "model")
    got = dryrun.place_cell(get_config("gemma-2b"), SHAPES["train_4k"],
                            _port_mesh(sizes, names))
    want = _reference_placed("gemma-2b", "train_4k", sizes, names)
    bad = {f"{name}{path}" for name, (local, _) in want.items()
           for path, shp in local.items() if shp is None}
    assert bad and {path for path, _, _ in got["invalid"]} == bad
    for path, d, why in got["invalid"]:
        assert "does not split over 3 ranks" in why, (path, d, why)


def test_paper_body_refuses_bf16_points():
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        dryrun.paper_body(torch.zeros((8, 4), dtype=torch.bfloat16), None, 2)


# ---------------------------------------------------------------------------
# the traces
# ---------------------------------------------------------------------------

def _check_traced(info):
    assert REFERENCE_KEYS <= set(info), REFERENCE_KEYS - set(info)
    assert info["valid"] and info["null_reason"] is None
    assert np.isfinite(info["flops_per_device"])
    assert info["flops_per_device"] > 0
    coll = info["collective_bytes_per_device"]
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert coll[kind] > 0, (kind, coll)
    assert coll["all-to-all"] == 0
    assert info["collective_total"] == sum(coll.values())
    assert info["argument_bytes"] == sum(
        info["argument_bytes_by_tree"].values()) > 0
    assert info["peak_bytes"] > info["argument_bytes"]
    for key in dryrun._XLA_ONLY:
        assert info[key] is None, key
    assert info["after"] == {"group": False, "mesh": False}


@pytest.mark.parametrize("arch", REDUCED)
def test_reduced_trace_on_a_fake_2x2_mesh(traced, arch):
    """A reduced train cell on (2, 2): the transformers' ``head_dim``
    attention exchanges RoPE's partner columns point to point (the
    collective-permutes); mamba2 has no attention."""
    info = traced("traces")[arch]
    _check_traced(info)
    assert info["chips"] == 4
    permuted = info["collective_bytes_per_device"]["collective-permute"]
    assert (permuted > 0) == (arch != "mamba2-130m"), permuted


def _check_serve(info):
    assert REFERENCE_KEYS <= set(info), REFERENCE_KEYS - set(info)
    assert info["valid"] and info["null_reason"] is None
    assert np.isfinite(info["flops_per_device"])
    assert info["flops_per_device"] > 0
    coll = info["collective_bytes_per_device"]
    assert coll["reduce-scatter"] == 0, coll
    assert coll["all-to-all"] == 0, coll
    assert info["collective_total"] == sum(coll.values())
    assert set(info["argument_bytes_by_tree"]) == {"params", "batch",
                                                   "cache"}
    assert info["peak_bytes"] > info["argument_bytes"]
    assert info["after"] == {"group": False, "mesh": False}


@pytest.mark.parametrize("cell,combine", [
    ("prefill", False), ("split_kv", True), ("context_parallel", True)])
def test_reduced_serve_trace_on_a_fake_2x2_mesh(traced, cell, combine):
    """A serve cell traces its sharded step: the tensor-parallel products
    all-reduce in every cell, and a decode over a cache split over
    ``kv_seq`` (``combine``) all-reduces its softmax partials too (max,
    then the sums); the params' ``fsdp`` dim is gathered where the rules
    keep it (the prefill, the context-parallel decode of batch 2), and the
    split-KV decode (``fsdp=None``, every ``model``-split leaf kept)
    gathers nothing.  The ``head_dim`` cells (the prefill and the
    context-parallel decode) exchange RoPE's partner columns point to
    point; the split-KV decode under ``pad_heads`` (one query) none."""
    info = traced("traces")[cell]
    _check_serve(info)
    coll = info["collective_bytes_per_device"]
    assert coll["all-reduce"] > 0, coll
    assert (coll["collective-permute"] > 0) == (cell != "split_kv"), coll
    assert (coll["all-gather"] == 0) == (info["rules"]["fsdp"] is None)
    assert (coll["all-gather"] == 0) == (cell == "split_kv"), coll
    assert (info["rules"]["kv_seq"] is not None) == combine
    assert info["rules"]["kv_seq"] == {"prefill": None, "split_kv": "model",
                                       "context_parallel": "data"}[cell]


def test_tensor_parallel_decode_cell_to_the_byte(traced):
    """(d_tp), internlm2-1.8b's split-KV decode of batch 8 over 2,048 slots
    on (2, 2): every ``model``-split leaf kept (``fsdp=None``), so nothing
    is all-gathered, and the all-reduces are, to the byte, the ones the
    specs give a rank of 4 rows: the embedding's sum and each layer's
    MLP row sum, (4, 1, D) fp32 each; each layer's split softmax, its max
    (4, KV, H / KV, 1) and its sums (4, KV, H / KV, 1, hd + 1) fp32; the
    next tokens' argmax over the split vocab, a max (4,) fp32 and an index
    (4,) int64."""
    info = traced("traces")["d_tp"]
    _check_serve(info)
    cfg = get_config("internlm2-1.8b")
    assert info["rules"]["kv_seq"] == "model" and info["rules"]["fsdp"] is None
    rows, f32 = 4, 4
    g = cfg.num_heads // cfg.num_kv_heads
    layer = (rows * cfg.d_model * f32
             + rows * cfg.num_kv_heads * g * f32
             + rows * cfg.num_kv_heads * g * (cfg.head_dim + 1) * f32)
    want = rows * cfg.d_model * f32 + cfg.num_layers * layer + rows * (
        f32 + 8)
    coll = info["collective_bytes_per_device"]
    assert coll == {"all-gather": 0, "all-reduce": want, "reduce-scatter": 0,
                    "all-to-all": 0, "collective-permute": 0}, (coll, want)
    # the params a rank holds: the attention and norms whole, the MLPs and
    # the vocab halved
    from repro_torch import models as M
    from repro_torch.tree import tree_items
    whole = split = 0
    for path, leaf in tree_items(M.param_shapes(cfg)):
        n = leaf.numel() * leaf.element_size()
        if any(k in path for k in ("w_gate", "w_up", "w_down", "embed",
                                   "head")):
            split += n
        else:
            whole += n
    assert info["argument_bytes_by_tree"]["params"] == whole + split // 2


def test_full_width_decode_cell_on_16x16(traced):
    """gemma-2b's decode on (16, 16): one query a step takes the plain
    attention under ``pad_heads``, so nothing is permuted."""
    info = traced("traces")["full_decode"]
    _check_serve(info)
    assert info["collective_bytes_per_device"]["collective-permute"] == 0
    assert (info["arch"], info["shape"], info["chips"]) == (
        "gemma-2b", "decode_32k", 256)
    assert info["rules"]["kv_seq"] == "model"
    placed = dryrun.place_cell(get_config("gemma-2b"), SHAPES["decode_32k"],
                               _port_mesh(*MESHES[False]))
    assert info["argument_bytes"] == placed["argument_bytes"]


def test_full_width_train_cell_on_16x16(traced):
    """granite-moe's published ``pad_heads`` on (16, 16): its 16 heads are
    their own padding, so each rank's block of the padded heads is its
    block of the real ones and the context's re-split permutes nothing."""
    info = traced("traces")["full"]
    _check_traced(info)
    assert info["collective_bytes_per_device"]["collective-permute"] == 0
    assert (info["arch"], info["shape"], info["chips"]) == (
        "granite-moe-1b-a400m", "train_4k", 256)
    placed = dryrun.place_cell(get_config("granite-moe-1b-a400m"),
                               SHAPES["train_4k"],
                               _port_mesh(*MESHES[False]))
    assert info["argument_bytes"] == placed["argument_bytes"]


@pytest.mark.parametrize("which,rows,chips,sweeps", [
    ("paper", 4194304, 256, 2048), ("paper_mp", 2097152, 512, 257)])
def test_paper_cell(traced, which, rows, chips, sweeps):
    info = traced("traces")[which]
    assert info["chips"] == chips and info["shard_rows"] == rows
    assert info["shard_bytes"] == rows * 64 * 4 == info["argument_bytes"]
    assert info["collective_bytes_per_device"]["all-gather"] == (
        chips * 2048 * 64 * 4)
    assert info["collective_bytes_per_device"]["all-reduce"] == 4
    assert info["sweeps"] == sweeps
    assert info["sweep_bytes"] == rows * 64 * 4 + 2 * rows * 4
    assert info["sweeps_bytes"] == sweeps * info["sweep_bytes"]
    assert info["flops_per_device"] > 0


def test_invalid_cell_is_reported_not_raised(traced):
    info = traced("traces")["invalid"]
    assert not info["valid"] and info["invalid"]
    assert info["flops_per_device"] is None
    assert info["null_reason"] == "invalid placement"


def test_gathered_experts_raise_naming_the_roadmap(traced):
    """``shard_map_moe=False`` (the reference's ``--no-shard-map-moe``)
    once raised, naming ROADMAP B; the sharded step now gathers the
    experts on every rank when no mesh is current, so the cell traces:
    the experts' all-gather adds to the shard_map step's, and the MoE pair
    over ``model`` no longer all-reduces."""
    got = traced("traces")
    info = got["gathered_experts"]
    _check_traced(info)
    kept = got["granite-moe-1b-a400m"]["collective_bytes_per_device"]
    coll = info["collective_bytes_per_device"]
    assert coll["all-gather"] > kept["all-gather"], (coll, kept)
    assert coll["all-reduce"] < kept["all-reduce"], (coll, kept)


def test_fake_group_refuses_a_real_group_and_cleans_up(traced):
    got = traced("traces")
    assert got["imported_without_group"]
    assert "already initialized" in got["real_group"]


def test_command_line_writes_the_cell(traced):
    info, stdout = traced("cli")
    assert "== gemma-2b × train_4k (16x16) ==" in stdout
    assert (info["arch"], info["shape"], info["multi_pod"]) == (
        "gemma-2b", "train_4k", False)
    assert REFERENCE_KEYS <= set(info)
    assert info["valid"] and info["flops_per_device"] > 0
    assert info["torch"] == torch.__version__
