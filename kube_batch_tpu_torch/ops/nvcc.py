"""Build and load the port's CUDA kernels: one shared library per source
under csrc/, compiled with nvcc for sm_90a into the package's _build
directory at first use and bound through ctypes (a plain C interface, no
PyTorch headers, so a build takes seconds).

A library's file name carries a hash of its source and of the shared
headers (csrc/*.cuh), so an edited source rebuilds. ``build`` compiles
several sources at once, one nvcc process each. A source that does not
compile, a missing nvcc, or a library that does not load raises
``KernelBuildError``: the solver ladder re-raises it rather than feed a
breaker, since it would fail every cycle.

Builds and loads are thread-safe: in-process federation runs several
scheduling threads whose first solves may reach ``Library.load`` at once,
so one module lock covers the check, the build and the bind, and each
compiler writes a temporary named for its process and its thread before
the atomic rename.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from typing import Callable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# Serializes build() and Library.load() across the process's threads.
_LOCK = threading.RLock()


class KernelBuildError(RuntimeError):
    """A kernel's library cannot be built from its source or loaded."""


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_digest(name)}.so")


# nvcc processes started by this process: a warm path that builds a kernel
# again is a regression (a source or its hash changed under a running
# scheduler), so a smoke reads this around its warm phases.
builds = 0


def build(names: list[str]) -> dict[str, str]:
    """Compile csrc/<name>.cu for every name whose library is not built
    yet, all at once; returns name -> compiler output ("" when the library
    was already there). No FMA contraction (-fmad=false) and no fast math:
    the kernels' float32 results must equal their plain versions' bit for
    bit. Raises KernelBuildError naming the source when nvcc fails or
    cannot be started."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names: list[str]) -> dict[str, str]:
    global builds
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    logs: dict[str, str] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            logs[name] = ""
            continue
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [
            nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
            "-I", CSRC_DIR, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu"),
        ]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise KernelBuildError(f"cannot start nvcc for {name}.cu: {e}") from e
        builds += 1
        procs[name] = (path, tmp, proc)
    failed = []
    for name, (path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return logs


class Library:
    """One kernel's shared library, built and bound on first ``load``;
    ``bind`` sets the ctypes signatures of its entry points."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]) -> None:
        self.name = name
        self._bind = bind
        self.lib = None
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        with _LOCK:
            if self.lib is None:
                self.build_log = build([self.name])[self.name]
                try:
                    lib = ctypes.CDLL(library_path(self.name))
                except OSError as e:
                    raise KernelBuildError(f"cannot load the {self.name} kernel's library: {e}") from e
                lib.kbt_error_string.argtypes = [ctypes.c_int]
                lib.kbt_error_string.restype = ctypes.c_char_p
                self._bind(lib)
                self.lib = lib
        return self.lib

    def error(self, err: int) -> str:
        return self.load().kbt_error_string(err).decode()
