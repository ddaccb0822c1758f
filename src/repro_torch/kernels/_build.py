"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C function and compiles on its
own into ``build/repro_torch/lib<name>-<hash>.so`` at the repository
root, where the hash covers the sources and the flags, so an edited
source builds anew. ``build()`` starts one nvcc per missing library,
all at once, and waits for them; ``load(name)`` builds on first use.
nvcc exists only on a machine with the CUDA toolkit: nothing here runs
when the port stays on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("prf_fused_decode", "prf_fused_prefill", "linear_attn_scan",
           "prf_featmap", "prf_decode_step", "wkv6_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and spill report) of the
    library's last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one
    nvcc process per source, all started together. Returns seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        if proc.wait() != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        logs = "\n".join(f"--- {n} ---\n{build_log(n)[-4000:]}"
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
