"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launch functions and becomes its
own shared library ``build/kernels/<name>-<digest>.so``, compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

``digest`` hashes the source and the flags, so an edited source
rebuilds and an unchanged one is reused. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for all of them;
any failed build raises with the compiler's output. Nothing is built
when this module is imported: the first launch builds what it needs.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("hp_join", "horner_push", "spmm", "cin")

_lock = threading.Lock()
# the wrappers' launch counters are bumped under this lock: the serving
# frontend's replica workers launch from several threads
counter_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # name -> nvcc output (ptxas -v report)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda; "
                           "the port's CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, in parallel. Returns {name: seconds} of the
    builds it ran; raises RuntimeError if any build failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [nm for nm in names if not library_path(nm).exists()]
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for nm in todo:
        tmp = library_path(nm).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{nm}.cu")]
        procs[nm] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     tmp)
    times, failed = {}, []
    for nm, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        times[nm] = time.perf_counter() - t0
        build_log[nm] = out
        if proc.returncode != 0:
            failed.append(f"{nm}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(nm))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
