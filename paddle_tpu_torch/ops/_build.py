"""Build the CUDA kernels of ``ops/csrc`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``_build/lib<name>-<sha>.so`` (the digest of the source
and of every shared ``csrc/*.cuh`` header names the file, so an edited
source never loads a stale build), and is loaded with ``ctypes``.  Every C
entry returns ``cudaGetLastError()`` after its launch; ``check`` turns a
nonzero code into an exception.  A failed build raises: nothing falls back
to the plain PyTorch path.

Building happens at first use, never at import: the CPU tests import every
module on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or "
            "/usr/local/cuda); the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names) -> dict:
    """Compile the named kernel sources, one ``nvcc`` process each, all
    started together.  Returns ``{name: compiler output}`` (``-Xptxas -v``
    register, shared-memory and spill lines; ``"cached"`` for a library
    already built from the same source).  Raises when any build fails."""
    jobs = {}
    for name in names:
        src, so = _paths(name)
        if os.path.exists(so):
            jobs[name] = (so, None, None)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (so, tmp, proc)
    logs, failed = {}, []
    for name, (so, tmp, proc) in jobs.items():
        if proc is None:
            logs[name] = "cached"
            continue
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an ``int`` CUDA error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            for fn, argtypes in signatures.items():
                entry = getattr(lib, fn)
                entry.argtypes = list(argtypes)
                entry.restype = ctypes.c_int
            err = lib.error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def resources(lib: ctypes.CDLL, entry, *args) -> tuple:
    """(registers, local bytes a thread) of the kernel that ``args`` name,
    as a ``*_resources`` C entry reads them with ``cudaFuncGetAttributes``;
    local bytes past 0 mean the kernel spills or keeps a stack."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    check(lib, entry(*args, ctypes.byref(regs), ctypes.byref(local)),
          entry.__name__)
    return regs.value, local.value
