"""Build and bind the CUDA kernels in ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The build happens at first
use, never at import (a machine without ``nvcc`` imports this module and
raises only when a kernel is asked for), into ``build/kernels/<digest>/``
under the repository root, keyed by a hash of the sources and flags so a
stale library is never loaded.  A missing ``nvcc`` or a failed build raises
with the compiler's output.

``LAUNCHES`` counts kernel launches per wrapper (``gmm_topb``,
``gmm_update_select``, ``pairwise``, ``gmm_grouped_topb``); each wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

LAUNCHES = {"gmm_topb": 0, "gmm_update_select": 0, "pairwise": 0,
            "gmm_grouped_topb": 0}

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_LIB = None
# what the last build printed and how long it took (read by chip_smoke.py)
BUILD_INFO = {"seconds": None, "log": "", "path": None, "cached": None}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_gmm_sweep.argtypes = [vp] * 9 + [ci] * 7 + [vp]
    lib.repro_gmm_sweep.restype = ci
    lib.repro_pairwise.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.repro_pairwise.restype = ci
    lib.repro_grouped_sweep.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    lib.repro_grouped_sweep.restype = ci
    lib.repro_error_string.argtypes = [ci]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds):
    """Run the commands side by side (their output goes to
    ``BUILD_INFO["log"]``); raise with the output of the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    BUILD_INFO["log"] += "".join(logs)
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{log}")


def _compile_and_link(nvcc: str, tmp_dir: Path, out: Path) -> None:
    """One nvcc per source, all started together, then one link.  The
    library is written under a temporary name and renamed, so concurrent
    first uses never load a half-written one."""
    BUILD_INFO["log"] = ""
    srcs = [src for src in _sources() if src.suffix == ".cu"]
    objs = [tmp_dir / (src.stem + ".o") for src in srcs]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
              for o, src in zip(objs, srcs)])
    tmp_lib = tmp_dir / LIB_NAME
    _run_all([[nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)]])
    os.replace(tmp_lib, out)


def library():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = BUILD_ROOT / _digest() / LIB_NAME
    t0 = time.perf_counter()
    cached = out.exists()
    if not cached:
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "building the CUDA kernels needs nvcc (not on PATH, not "
                "under $CUDA_HOME/bin or /usr/local/cuda/bin)")
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
            _compile_and_link(nvcc, Path(tmp_dir), out)
    _LIB = _bind(out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(out),
                      cached=cached)
    return _LIB


def check(rc: int) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {rc} ({msg})")
