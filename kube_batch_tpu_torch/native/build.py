"""Build the native hot-loop extension with the system toolchain.

No pip, no pybind11: the module is plain CPython C API, compiled with g++
straight against this interpreter's headers into the package's _build
directory (never beside the source). The file name carries a hash of the
source, the compile command and the interpreter's extension suffix, so an
edited source rebuilds and a stale build is never loaded. ``ensure()`` is
idempotent and safe under concurrent builds (a per-process temporary
file, then an atomic ``os.replace``).

Manual (re)build:  python -m kube_batch_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "_hotloops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
COMPILER = "g++"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def _include() -> str:
    return sysconfig.get_paths()["include"]


def _suffix() -> str:
    return sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def _digest() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((COMPILER, *FLAGS, _include(), _suffix())).encode())
    return h.hexdigest()[:16]


def artifact_path() -> str:
    return os.path.join(BUILD_DIR, f"_hotloops_{_digest()}{_suffix()}")


def compiler_version() -> str:
    """The first line of ``g++ --version``."""
    out = subprocess.run([COMPILER, "--version"], capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[0] if out.stdout else ""


def ensure(verbose: bool = False) -> str:
    """Build when missing; return the artifact path. Raises RuntimeError
    with the compiler's output when the build fails (no toolchain, no
    Python headers)."""
    out = artifact_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    include = _include()
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"no Python.h under {include}: this interpreter's headers are not installed")
    # A build killed mid-compile leaves its pid-stamped temporary behind:
    # sweep old ones, age-gated so another process's live temporary
    # is never removed from under its linker.
    cutoff = time.time() - 300
    for stale in os.listdir(BUILD_DIR):
        if stale.startswith("_hotloops_") and stale.endswith(".tmp"):
            p = os.path.join(BUILD_DIR, stale)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.unlink(p)
            except OSError:
                pass
    tmp = f"{out}.{os.getpid()}.tmp"  # per process: concurrent builds race on os.replace, not on the write
    cmd = [COMPILER, *FLAGS, f"-I{include}", SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {COMPILER}: {e}") from e
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"{COMPILER} failed on {SOURCE} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic against concurrent importers
    return out


if __name__ == "__main__":
    print(ensure(verbose=True))
