"""The port stands alone and never falls back: ``repro_torch`` imports
neither ``jax`` nor ``repro``, a CUDA request without a card raises, the
kernel switch refuses CPU tensors, and the kernel build module imports on a
machine without ``nvcc`` and raises only when a build is asked for."""
import importlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import device as port_device
from repro_torch.kernels import build

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.core, "
            "repro_torch.core.smm, repro_torch.kernels, "
            "repro_torch.kernels.pairwise, repro_torch.obs, "
            "repro_torch.data.selection, repro_torch.interop\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"(from|import)\s+repro(\.|\s|$))", re.M)
    scanned = list(PORT.rglob("*.py"))
    assert PORT / "core" / "smm.py" in scanned
    assert PORT / "kernels" / "pairwise.py" in scanned
    hits = [str(p) for p in scanned if pat.search(p.read_text())]
    assert not hits, hits


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((16, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.diversify(pts, k=2)          # the default device
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.as_points(pts)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.plan(repro_torch.ProblemSpec(points=pts, k=2))


def test_stream_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((16, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.diversify(iter([pts]), k=2)
    from repro_torch.core import StreamingCoreset
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingCoreset(2, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        StreamingCoreset(2, 8, 2, device="cpu", use_pallas=True)


def test_kernel_switch_refuses_cpu_tensors():
    pts = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        repro_torch.diversify(pts, k=2, execution=repro_torch.ExecutionSpec(
            device="cpu", use_pallas=True))
    gmm_mod = importlib.import_module("repro_torch.core.gmm")
    with pytest.raises(ValueError, match="CUDA"):
        gmm_mod.gmm(torch.as_tensor(pts), 4, use_pallas=True)
    # manhattan has no kernel mode: "auto" is the plain sweep, True raises
    assert not port_device.resolve_use_pallas("auto", torch.device("cuda"),
                                              "manhattan")
    assert port_device.resolve_use_pallas("auto", torch.device("cuda"),
                                          "cosine")
    assert not port_device.resolve_use_pallas("auto", torch.device("cpu"),
                                              "cosine")
    with pytest.raises(ValueError, match="no kernel path"):
        port_device.resolve_use_pallas(True, torch.device("cuda"),
                                       "manhattan")


def test_cuda_launch_path_rejects_cpu_tensors():
    from repro_torch.kernels.gmm_topb import gmm_topb_cuda
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="contiguous float32"):
        gmm_topb_cuda(x, x[:2], torch.zeros(8), torch.zeros(8),
                      torch.ones(8, dtype=torch.bool), mode="sqeuclidean",
                      p=2)


def test_build_module_needs_nvcc_only_when_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    assert build.LAUNCHES.keys() == {"gmm_topb", "gmm_update_select",
                                     "pairwise"}
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()
    assert not any(tmp_path.iterdir())


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'gmm_sweep.cu(1): error: broken' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="error: broken"):
        build.library()
    lib_dir = tmp_path / "out" / build._digest()
    assert not list(lib_dir.glob("*.so"))


def _smoke(*args):
    root = SRC.parent
    env = {"PATH": os.environ.get("PATH", "/usr/bin"),
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                           *args], capture_output=True, text=True, env=env,
                          cwd=root, timeout=600)


def test_chip_smoke_refuses_without_a_card():
    out = _smoke()
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_rehearsal_drives_the_main_path_on_cpu():
    # the script's phases at a tiny size with the plain versions: agreement
    # checks and the main-path calls run; no build, no ok line
    out = _smoke("--rehearse")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last == '{"phase": "rehearsal", "ok": true}'
    assert '"ok": true, "device"' not in out.stdout
