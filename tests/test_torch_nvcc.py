"""The kernel build under threads (ops/nvcc.py), on the CPU: the compiler
and the loader are stubbed, so no nvcc and no card are needed.

In-process federation runs one scheduling thread per shard, and their
first solves reach ``Library.load`` together on a fresh ``_build/``: the
compiler must start once, and each compiler's temporary must be its own.
"""

from __future__ import annotations

import os
import threading
import time

import pytest

from kube_batch_tpu_torch.ops import nvcc


class _FakeProc:
    """An nvcc that takes a while and then writes its ``-o`` file."""

    def __init__(self, cmd, started: list, **_kw) -> None:
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = None
        started.append(self.out)

    def communicate(self):
        time.sleep(0.05)
        with open(self.out, "wb") as f:
            f.write(b"\x7fELF")
        self.returncode = 0
        return "ptxas info: 0 bytes spill", None


class _FakeLib:
    def __init__(self) -> None:
        self.kbt_error_string = lambda err: b"ok"


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    started: list = []
    loads: list = []
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(
        nvcc.subprocess, "Popen", lambda cmd, **kw: _FakeProc(cmd, started, **kw)
    )

    def fake_cdll(path):
        loads.append(path)
        return _FakeLib()

    monkeypatch.setattr(nvcc.ctypes, "CDLL", fake_cdll)
    return started, loads, tmp_path


@pytest.mark.parametrize("threads", [2, 8])
def test_concurrent_loads_start_the_compiler_once(stubbed, threads):
    started, loads, tmp_path = stubbed
    binds = []
    lib = nvcc.Library("fused_solve", lambda cdll: binds.append(cdll))
    barrier = threading.Barrier(threads)
    got, errors = [], []

    def worker():
        barrier.wait()
        try:
            got.append(lib.load())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errors
    assert len(started) == 1
    assert len(loads) == 1 and len(binds) == 1
    assert len(got) == threads and all(g is got[0] for g in got)
    assert os.listdir(tmp_path) == [os.path.basename(nvcc.library_path("fused_solve"))]
    assert lib.build_log.startswith("ptxas info")


def test_the_temporary_is_named_for_the_process_and_the_thread(stubbed):
    started, _loads, _tmp = stubbed
    nvcc.build(["block_step"])
    assert started == [
        f"{nvcc.library_path('block_step')}.{os.getpid()}.{threading.get_ident()}.tmp"
    ]
    # a built library is not rebuilt
    assert nvcc.build(["block_step"]) == {"block_step": ""}
    assert len(started) == 1


def test_concurrent_builds_of_different_sources_each_compile_once(stubbed):
    started, _loads, tmp_path = stubbed
    names = ["fused_solve", "block_step"]
    barrier = threading.Barrier(4)

    def worker(i):
        barrier.wait()
        nvcc.build([names[i % 2]])

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert sorted(os.path.basename(p).split("_")[0] for p in started) == [
        "libblock", "libfused"
    ]
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(nvcc.library_path(n)) for n in names
    )
