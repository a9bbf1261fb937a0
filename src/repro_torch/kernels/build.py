"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library with a
plain C interface -> ``ctypes``.

Sources live in ``repro_torch/csrc/<name>.cu``. Each is compiled for
``sm_90a`` at first use into ``build/kernels/`` at the repository root
(listed in ``.gitignore``), under a file name that carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads. Nothing here runs at import time: the CPU tests import every
module on hosts without ``nvcc``.

``start``/``finish`` split the build so several sources compile at once
(one ``nvcc`` process each); :func:`load` builds one if needed and
returns its ``ctypes.CDLL``. Builds use IEEE division and ``expf``: no
``--use_fast_math`` (the attention kernel must divide and round like the
reference's quantizer).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "load", "start", "finish",
           "build_all", "ptxas_report"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("transitive_forest", "transitive_forest_dense",
           "transitive_forest_sparse", "paged_attention", "transitive_gemm",
           "w4a8_gemm", "rg_lru")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built on this host")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def start(name: str):
    """Start compiling ``name`` unless its library is built; returns the
    job to hand to :func:`finish`, or None."""
    target = _target(name)
    if target.exists():
        return None
    cmd = [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, target, log, time.perf_counter()


def finish(job) -> None:
    """Wait for a :func:`start` job; raise with the compiler log on error."""
    if job is None:
        return
    proc, tmp, target, log, _ = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {target.name}:\n"
                           f"{log.read_text()[-4000:]}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source at once (one nvcc each), then wait.
    Returns the seconds each source's nvcc took (those already built are
    left out)."""
    jobs = {n: job for n in names if (job := start(n)) is not None}
    seconds: dict[str, float] = {}
    while len(seconds) < len(jobs):
        for name, job in jobs.items():
            if name not in seconds and job[0].poll() is not None:
                seconds[name] = time.perf_counter() - job[4]
        time.sleep(0.05)
    errors = []
    for job in jobs.values():
        try:
            finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name`` on this host, or '' if it was not built here."""
    log = BUILD_DIR / f"{name}.log"
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        finish(start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib
