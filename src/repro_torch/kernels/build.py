"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded with
``ctypes``.  All sources are compiled at once, one ``nvcc`` process each,
so the build takes as long as its slowest file.  Libraries go into
``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of every source and header and of the
flags, so an edited source rebuilds and an unchanged one loads at once.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
last_build: dict = {}        # seconds of the last build, ptxas reports


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; returns name -> .so path."""
    out_dir = BUILD_ROOT / source_hash()
    sources = sorted(CSRC.glob("*.cu"))
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in sources}
    todo = [p for p in sources if not libs[p.stem].exists()]
    if not todo:                 # built already: the logs beside the libs
        logs = {p.stem: (out_dir / f"{p.stem}.log").read_text()
                for p in sources if (out_dir / f"{p.stem}.log").exists()}
        last_build.update(seconds=0.0, logs=logs)
        return libs
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed, logs = [], {}
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[src.stem] = log
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[src.stem])     # atomic: no half-written lib
    last_build.update(seconds=time.perf_counter() - t0, logs=logs)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on demand)."""
    if name not in _LIBS:
        libs = build_all()
        if name not in libs:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        _LIBS[name] = ctypes.CDLL(str(libs[name]))
    return _LIBS[name]
