"""The port's native hot loops (kube_batch_tpu_torch/native/_hotloops.cpp)
against their Python twins, against the JAX package's native module, and
inside the actions.

The module is built with g++ at first use into the port's _build
directory; these tests need it (no skip: the toolchain and the Python
headers are part of the test host). They pin, on the port's own objects:
- each native function against the Python loop it replaces: status flips,
  node_name sets, residency-clone sharing (api/job_info.py
  clone_for_residency), status-index dicts, the pop-order sort, the
  extracted columns;
- the guards on half-initialised objects, which raise before any
  mutation, and the bulk_dispatch / finish_columns contracts;
- each port function's output equal to the JAX package's native
  function's on the same inputs (the two extension modules, both named
  ``_hotloops``, loaded side by side);
- B1's class numbering: native first-occurrence order against
  ``np.unique``'s sorted order, equal binds and SolveState;
- the ``torch_allocate`` action with the native loops on and off, each
  equal bind for bind to the JAX ``xla_allocate``, and the fault points
  ``native.load``, ``native.prepass``, ``native.dispatch`` and
  ``native.class_dedup``, whose degraded paths give the same outcome.
"""

from __future__ import annotations

import gc
import logging
import os
import random

import numpy as np
import pytest
import torch

import kube_batch_tpu.native as jax_native
import kube_batch_tpu_torch.actions.torch_allocate as TA
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import faults, metrics, native
from kube_batch_tpu_torch import log as pkg_log
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.resource_info import MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_SCALAR, Resource
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.native import build as native_build
from kube_batch_tpu_torch.ops import encode as E
from kube_batch_tpu_torch.ops import encode_cache
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.solve import allocate, solver_arrays
from kube_batch_tpu_torch.testing import build_task

from test_torch_actions import SCENARIOS, TORCH, make, torch_run
from test_torch_encode import WORLDS, build_world

lib = native.load()  # the tests need the module: a build failure fails them
JAX_LIB = jax_native.lib

NATIVE_FUNCTIONS = (
    "bulk_assign", "bulk_set_slot", "collect_pending", "extract_task_columns", "extract_node_columns",
    "class_dedup", "bulk_dispatch", "finish_columns", "bulk_res_axpy",
)


@pytest.fixture(autouse=True)
def _clean_state():
    """Native and cache switches on, counters zeroed, no armed fault, a
    cold cache: test order and xdist workers cannot leak state."""
    native.set_enabled(True)
    encode_cache.set_enabled(True)
    encode_cache.get().invalidate_all("test")
    faults.registry.reset()
    native.reset_counts()
    pkg_log.set_verbosity(0)
    yield
    native.set_enabled(True)
    encode_cache.set_enabled(True)
    encode_cache.get().invalidate_all("test")
    faults.registry.reset()
    native.reset_counts()
    pkg_log.set_verbosity(0)


def _mk_tasks(n):
    return [build_task(namespace="ns", name=f"p{i}", req={"cpu": 1.0}) for i in range(n)]


def _run_python_twin(tasks, tkeys, node_tasks, node_names, rows, nrows, allocs, counts):
    """The loop _Replayer._assign_segments_py runs for volume-less rows."""
    segments = []
    pos = 0
    for cnt in counts:
        alloc_d, pipe_d = {}, {}
        for i in range(pos, pos + cnt):
            task = tasks[rows[i]]
            if allocs[i]:
                task.volume_ready = True
                task.status = TaskStatus.ALLOCATED
                alloc_d[task.uid] = task
            else:
                task.status = TaskStatus.PIPELINED
                pipe_d[task.uid] = task
            task.node_name = node_names[nrows[i]]
            node_tasks[nrows[i]][tkeys[rows[i]]] = task.clone_for_residency()
        pos += cnt
        segments.append((alloc_d, pipe_d))
    return segments


# -- the loader and the build -------------------------------------------------


def test_module_builds_into_the_build_directory_with_a_source_hash():
    path = native_build.artifact_path()
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert os.path.basename(path).startswith(f"_hotloops_{native_build._digest()}")
    assert os.path.exists(path) and lib.__file__ == path
    assert not any(f.endswith((".so", ".tmp")) for f in os.listdir(os.path.dirname(native_build.SOURCE)))


def test_both_hotloops_modules_coexist():
    assert JAX_LIB is not None, "the JAX package's native module is not built"
    assert lib is not JAX_LIB
    assert lib.__name__ == "kube_batch_tpu_torch.native._hotloops"
    assert JAX_LIB.__name__ == "kube_batch_tpu.native._hotloops"
    assert os.path.realpath(lib.__file__) != os.path.realpath(JAX_LIB.__file__)
    for fn in NATIVE_FUNCTIONS:
        assert callable(getattr(lib, fn)) and getattr(lib, fn) is not getattr(JAX_LIB, fn)


def test_switch_off_gives_none():
    native.set_enabled(False)
    assert native.get() is None
    native.set_enabled(True)
    assert native.get() is lib


def test_build_failure_raises_and_a_failed_load_is_counted(monkeypatch):
    monkeypatch.setattr(native_build, "COMPILER", "no-such-compiler-kbt")
    with pytest.raises(RuntimeError, match="no-such-compiler-kbt"):
        native_build.ensure()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    assert native.get() is None
    assert native.fallbacks["load"] == 1
    assert native.get() is None and native.fallbacks["load"] == 1  # counted once, not retried


# -- bulk_assign ----------------------------------------------------------------


class TestBulkAssign:
    def test_matches_python_twin(self):
        rng = np.random.default_rng(7)
        n, n_nodes = 200, 7
        rows = rng.permutation(n).tolist()
        nrows = rng.integers(0, n_nodes, n).tolist()
        allocs = rng.integers(0, 2, n).astype(np.uint8)
        counts = [50, 100, 0, 50]
        tasks_a, tasks_b = _mk_tasks(n), _mk_tasks(n)
        tkeys = [f"{t.namespace}/{t.name}" for t in tasks_a]
        nt_a = [dict() for _ in range(n_nodes)]
        nt_b = [dict() for _ in range(n_nodes)]
        nn = [f"node-{i}" for i in range(n_nodes)]
        seg_n = lib.bulk_assign(
            tasks_a, tkeys, nt_a, nn, rows, nrows, allocs.tobytes(), counts,
            TaskStatus.ALLOCATED, TaskStatus.PIPELINED,
        )
        seg_p = _run_python_twin(tasks_b, tkeys, nt_b, nn, rows, nrows, allocs.tolist(), counts)
        assert len(seg_n) == len(seg_p) == 4
        for (an, pn), (ap, pp) in zip(seg_n, seg_p):
            assert list(an) == list(ap)  # same uids, same insertion order
            assert list(pn) == list(pp)
        for ta, tb in zip(tasks_a, tasks_b):
            assert ta.status is tb.status
            assert ta.node_name == tb.node_name
            assert ta.volume_ready == tb.volume_ready
        for da, db in zip(nt_a, nt_b):
            assert list(da) == list(db)
            for k in da:
                assert da[k].status is db[k].status and da[k].node_name == db[k].node_name

    def test_int64_buffers_match_int_lists(self):
        tasks_a, tasks_b = _mk_tasks(6), _mk_tasks(6)
        tkeys = [f"ns/p{i}" for i in range(6)]
        nt_a, nt_b = [dict(), dict()], [dict(), dict()]
        rows, nrows = [5, 0, 3, 1, 4, 2], [1, 0, 1, 0, 0, 1]
        args = (bytes([1, 0, 1, 1, 0, 1]), [2, 4], TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        a = lib.bulk_assign(tasks_a, tkeys, nt_a, ["a", "b"], rows, nrows, *args)
        b = lib.bulk_assign(
            tasks_b, tkeys, nt_b, ["a", "b"], np.asarray(rows, np.int64), np.asarray(nrows, np.int64), *args
        )
        assert [(list(x), list(y)) for x, y in a] == [(list(x), list(y)) for x, y in b]
        assert [list(d) for d in nt_a] == [list(d) for d in nt_b]

    def test_clone_shares_resources_and_detaches_status(self):
        tasks = _mk_tasks(1)
        nt = [dict()]
        lib.bulk_assign(tasks, ["ns/p0"], nt, ["n0"], [0], [0], bytes([1]), [1],
                        TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        clone = nt[0]["ns/p0"]
        t = tasks[0]
        assert clone is not t and type(clone) is type(t)
        assert clone.resreq is t.resreq and clone.init_resreq is t.init_resreq
        assert clone.pod is t.pod and clone.uid == t.uid
        assert clone.status is TaskStatus.ALLOCATED
        t.status = TaskStatus.BINDING  # later dispatch flip
        assert clone.status is TaskStatus.ALLOCATED  # resident unaffected

    def test_volume_rows_raise_without_mutation(self):
        tasks = _mk_tasks(2)
        tasks[1].pod.volumes = ["claim-1"]
        before = [(t.status, t.node_name, t.volume_ready) for t in tasks]
        nt = [dict()]
        with pytest.raises(ValueError, match="volume"):
            lib.bulk_assign(tasks, ["ns/p0", "ns/p1"], nt, ["n0"], [0, 1], [0, 0],
                            bytes([1, 1]), [2], TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        assert [(t.status, t.node_name, t.volume_ready) for t in tasks] == before
        assert not nt[0]

    def test_pipelined_rows_skip_volume_guard(self):
        tasks = _mk_tasks(1)
        tasks[0].pod.volumes = ["claim-1"]
        nt = [dict()]
        lib.bulk_assign(tasks, ["ns/p0"], nt, ["n0"], [0], [0], bytes([0]), [1],
                        TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        assert tasks[0].status is TaskStatus.PIPELINED
        assert not tasks[0].volume_ready

    def test_clone_survives_collection(self):
        tasks = _mk_tasks(3)
        nt = [dict()]
        lib.bulk_assign(tasks, [f"ns/p{i}" for i in range(3)], nt, ["n0"], [0, 1, 2], [0, 0, 0],
                        bytes([1, 1, 1]), [3], TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        clones = dict(nt[0])
        del tasks, nt
        gc.collect()  # clones are GC-untracked; refcounting must keep them
        for c in clones.values():
            assert c.uid and c.status is TaskStatus.ALLOCATED

    def test_length_mismatch_rejected(self):
        tasks = _mk_tasks(1)
        with pytest.raises(ValueError):
            lib.bulk_assign(tasks, ["ns/p0"], [{}], ["n0"], [0, 0], [0], bytes([1]), [1],
                            TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        with pytest.raises(IndexError):
            lib.bulk_assign(tasks, ["ns/p0"], [{}], ["n0"], [5], [0], bytes([1]), [1],
                            TaskStatus.ALLOCATED, TaskStatus.PIPELINED)


# -- collect_pending and the extractors -----------------------------------------


def _pending_jobs(seed=11):
    rng = random.Random(seed)
    jobs = []
    for j in range(6):
        job = JobInfo(uid=f"job-{j}")
        for i in range(rng.randint(0, 12)):
            t = build_task(
                namespace="ns", name=f"j{j}t{i}",
                req=rng.choice([{"cpu": 1.0}, {"cpu": 0.5}, None]),
                priority=rng.choice([None, 1, 5, 9]),
            )
            t.pod.metadata.creation_timestamp = rng.choice([100.0, 200.0, 300.0])
            if rng.random() < 0.3:
                t.pod.node_selector["zone"] = "a"
            if rng.random() < 0.2:
                t.pod.containers[0].ports = [8080]
            if rng.random() < 0.1:
                t.pod.volumes = ["claim"]
            job.add_task_info(t)
        jobs.append(job)
    return jobs


def _collect(lib_, jobs):
    return lib_.collect_pending(jobs, TaskStatus.PENDING, MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR)


class TestCollectPending:
    def test_matches_python_extraction(self):
        jobs = _pending_jobs()
        got = _collect(lib, jobs)
        assert len(got) == len(jobs)
        for (n_tasks, flags), job in zip(got, jobs):
            want = [t for t in job.task_status_index.get(TaskStatus.PENDING, {}).values()
                    if not t.resreq.is_empty()]
            want.sort(key=lambda t: (-t.priority, t.pod.metadata.creation_timestamp, t.uid))
            assert [t.uid for t in n_tasks] == [t.uid for t in want]
            for t, fl in zip(n_tasks, flags):
                plain = (
                    not t.pod.node_selector and t.pod.affinity is None and not t.pod.tolerations
                    and not t.pod.volumes and len(t.pod.containers) == 1 and not t.pod.containers[0].ports
                )
                assert bool(fl) == plain, t.uid

    def test_empty_resreq_excluded(self):
        job = JobInfo(uid="j")
        job.add_task_info(build_task(namespace="ns", name="be", req=None))
        job.add_task_info(build_task(namespace="ns", name="real", req={"cpu": 1.0}))
        ((tasks, _),) = _collect(lib, [job])
        assert [t.name for t in tasks] == ["real"]

    def test_extract_task_columns_matches_python(self):
        tasks = [t for job in _pending_jobs() for t in job.tasks.values()]
        job_idx = {uid: i for i, uid in enumerate(sorted({t.job for t in tasks}))}
        for dtype in (np.float32, np.float64):
            req, res = np.zeros((64, 2), dtype), np.zeros((64, 2), dtype)
            job_out = np.zeros(64, np.int32)
            hs, rhs = np.zeros(64, bool), np.zeros(64, bool)
            lib.extract_task_columns(tasks, job_idx, req, res, job_out, hs, rhs)
            n = len(tasks)
            np.testing.assert_array_equal(req[:n, 0], np.asarray([t.init_resreq.milli_cpu for t in tasks], dtype))
            np.testing.assert_array_equal(req[:n, 1], np.asarray([t.init_resreq.memory for t in tasks], dtype))
            np.testing.assert_array_equal(res[:n, 0], np.asarray([t.resreq.milli_cpu for t in tasks], dtype))
            np.testing.assert_array_equal(job_out[:n], [job_idx[t.job] for t in tasks])
            assert not hs.any() and not rhs.any() and not req[n:].any()

    def test_extract_node_columns_matches_python(self):
        cluster = torch_testing.FakeCache(build_world(TORCH.models, "preempt_mix_2000_40_seed1")).snapshot()
        nodes = [cluster.nodes[k] for k in sorted(cluster.nodes)]
        out = np.zeros((4, 128, 2), np.float32)
        lib.extract_node_columns(nodes, ("idle", "releasing", "used", "allocatable"), out)
        for a, attr in enumerate(("idle", "releasing", "used", "allocatable")):
            want = np.asarray([getattr(n, attr).to_vector(()) for n in nodes], np.float32)
            np.testing.assert_array_equal(out[a, : len(nodes)], want)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_encode_with_and_without_native_agree(world, dtype):
    """The port's encoder with the native extractors on and off, at both
    dtypes: every array byte-identical (one world, snapshotted per encode),
    and the native path really ran."""
    fc = torch_testing.FakeCache(build_world(TORCH.models, world))

    def enc():
        c = fc.snapshot()
        return E.encode_session(c.jobs, c.nodes, c.queues, dtype=dtype)

    encode_cache.set_enabled(False)
    a = enc()
    assert native.calls["collect_pending"] == 1 and not native.fallbacks
    native.set_enabled(False)
    native.reset_counts()
    b = enc()
    assert not native.calls
    assert [t.uid for t in a.tasks] == [t.uid for t in b.tasks]
    assert set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        x, y = np.asarray(a.arrays[k]), np.asarray(b.arrays[k])
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


# -- guards on half-initialised objects ------------------------------------------


class TestHalfInitializedGuards:
    """Unset __slots__ members surface as AttributeError (with the
    exception set), never a crash; count inconsistencies raise before any
    mutation."""

    def test_bulk_assign_counts_mismatch_raises_premutation(self):
        tasks = _mk_tasks(3)
        before = [(t.status, t.node_name, t.volume_ready) for t in tasks]
        nt = [dict()]
        for bad_counts in ([2], [4], [2, 2]):  # under / over / over-split
            with pytest.raises(ValueError, match="count"):
                lib.bulk_assign(tasks, [f"ns/p{i}" for i in range(3)], nt, ["n0"], [0, 1, 2], [0, 0, 0],
                                bytes([1, 1, 1]), bad_counts, TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
            assert [(t.status, t.node_name, t.volume_ready) for t in tasks] == before
            assert not nt[0]

    def test_bulk_assign_null_pod_slot_raises(self):
        tasks = _mk_tasks(2)
        del tasks[1].pod  # the C-level member is now NULL
        nt = [dict()]
        with pytest.raises(AttributeError, match="pod"):
            lib.bulk_assign(tasks, ["ns/p0", "ns/p1"], nt, ["n0"], [0, 1], [0, 0],
                            bytes([1, 1]), [2], TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        assert not nt[0]

    def test_bulk_assign_null_uid_slot_raises(self):
        tasks = _mk_tasks(2)
        del tasks[0].uid  # would be a NULL dict key in the mutation loop
        nt = [dict()]
        with pytest.raises(AttributeError, match="uid"):
            lib.bulk_assign(tasks, ["ns/p0", "ns/p1"], nt, ["n0"], [0, 1], [0, 0],
                            bytes([0, 0]), [2], TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
        assert not nt[0]
        assert tasks[1].status is not TaskStatus.PIPELINED

    def test_collect_pending_null_pod_slot_raises(self):
        job = JobInfo(uid="j")
        t = build_task(namespace="ns", name="ghost", req={"cpu": 1.0})
        job.add_task_info(t)
        del t.pod
        with pytest.raises(AttributeError):
            _collect(lib, [job])

    def test_extract_task_columns_null_scalars_slot_raises(self):
        t = build_task(namespace="ns", name="t0", req={"cpu": 1.0})
        t.job = "j"
        del t.resreq.scalars
        args = (np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32), np.zeros(1, np.int32),
                np.zeros(1, np.uint8), np.zeros(1, np.uint8))
        with pytest.raises(AttributeError, match="scalars"):
            lib.extract_task_columns([t], {"j": 0}, *args)

    def test_extract_task_columns_short_buffers_raise(self):
        t = build_task(namespace="ns", name="t0", req={"cpu": 1.0})
        t.job = "j"
        args = (np.zeros((1, 1), np.float32), np.zeros((1, 2), np.float32), np.zeros(1, np.int32),
                np.zeros(1, np.uint8), np.zeros(1, np.uint8))
        with pytest.raises(ValueError, match="shape"):
            lib.extract_task_columns([t], {"j": 0}, *args)


class TestBulkSetSlot:
    def test_sets_every_object(self):
        tasks = _mk_tasks(50)
        lib.bulk_set_slot(tasks, "status", TaskStatus.BINDING)
        assert all(t.status is TaskStatus.BINDING for t in tasks)

    def test_non_slot_attr_rejected(self):
        with pytest.raises(AttributeError):
            lib.bulk_set_slot(_mk_tasks(1), "not_a_slot", 1)
        with pytest.raises(TypeError):
            lib.bulk_set_slot(_mk_tasks(1), "clone", 1)  # a method, not a member slot

    def test_empty_list_ok(self):
        lib.bulk_set_slot([], "status", TaskStatus.BINDING)


def test_histogram_observe_many_matches_observe():
    from kube_batch_tpu.metrics import Histogram as JaxHistogram

    buckets = [0.1, 1.0, 10.0]
    h1, h2, h3 = (metrics.Histogram(n, "", buckets) for n in "abc")
    ref = JaxHistogram("ref", "", buckets)
    vals = [0.05, 0.1, 0.5, 1.0, 5.0, 50.0]
    for v in vals:
        h1.observe(v)
        ref.observe(v, {"k": "v"})
    h2.observe_many(np.asarray(vals))
    h3.observe_many(vals)
    assert h1.snapshot() == h2.snapshot() == h3.snapshot() == ref.snapshot()
    h2.observe_many(np.asarray([]))
    h3.observe_many([], {"k": "v"})
    assert h2.snapshot() == h1.snapshot() and h3.snapshot({"k": "v"})["count"] == 0


# -- bulk_dispatch, bulk_res_axpy, finish_columns contracts -------------------------


def _allocated_job(uid, names, status=TaskStatus.ALLOCATED):
    job = JobInfo(uid=uid)
    for name in names:
        t = build_task(namespace="ns", name=name, req={"cpu": 1.0})
        job.add_task_info(t)
        job.update_task_status(t, status)
    return job


class TestPrepassContracts:
    """Every mutating entry point fails before any mutation, so the Python
    twins never double-apply."""

    def test_bulk_dispatch_bad_index_raises_premutation(self):
        good = _allocated_job("g", ["t0"])

        class Weird:
            task_status_index = "not-a-dict"

        with pytest.raises(TypeError, match="task_status_index"):
            lib.bulk_dispatch([good, Weird()], bytes([1, 1]), TaskStatus.ALLOCATED, TaskStatus.BINDING)
        assert TaskStatus.ALLOCATED in good.task_status_index
        assert TaskStatus.BINDING not in good.task_status_index

    def test_bulk_dispatch_moves_buckets_and_returns_tasks(self):
        jobs = [_allocated_job(f"j{j}", [f"j{j}t{i}" for i in range(4)]) for j in range(3)]
        out = lib.bulk_dispatch(jobs, bytes([1, 0, 1]), TaskStatus.ALLOCATED, TaskStatus.BINDING)
        assert [t.name for t in out] == [f"j{j}t{i}" for j in (0, 2) for i in range(4)]
        for j, job in enumerate(jobs):
            if j == 1:
                assert TaskStatus.ALLOCATED in job.task_status_index
            else:
                assert TaskStatus.ALLOCATED not in job.task_status_index
                assert len(job.task_status_index[TaskStatus.BINDING]) == 4

    def test_bulk_dispatch_merges_into_existing_binding_bucket(self):
        job = _allocated_job("j", ["pre"], TaskStatus.BINDING)
        t = build_task(namespace="ns", name="t0", req={"cpu": 1.0})
        job.add_task_info(t)
        job.update_task_status(t, TaskStatus.ALLOCATED)
        out = lib.bulk_dispatch([job], bytes([1]), TaskStatus.ALLOCATED, TaskStatus.BINDING)
        assert [x.name for x in out] == ["t0"]
        assert set(job.task_status_index[TaskStatus.BINDING]) == {"ns-pre", t.uid}
        assert TaskStatus.ALLOCATED not in job.task_status_index

    def test_bulk_res_axpy_mixed_types_raise_premutation(self):
        a = Resource(milli_cpu=1000.0, memory=2048.0)
        deltas = np.asarray([[100.0, 10.0], [100.0, 10.0]], np.float64)
        with pytest.raises(TypeError):
            lib.bulk_res_axpy([a, object()], deltas, 1)
        assert a.milli_cpu == 1000.0 and a.memory == 2048.0

    def test_bulk_res_axpy_applies_dense_dims(self):
        rs = [Resource(milli_cpu=1000.0, memory=2048.0, scalars={"x": 1.0}) for _ in range(3)]
        deltas = np.asarray([[100.0, 10.0, 5.0], [200.0, 20.0, 5.0], [300.0, 30.0, 5.0]], np.float64)
        lib.bulk_res_axpy(rs, deltas, -1)
        assert [r.milli_cpu for r in rs] == [900.0, 800.0, 700.0]
        assert [r.memory for r in rs] == [2038.0, 2028.0, 2018.0]
        assert all(r.scalars == {"x": 1.0} for r in rs)  # scalar dims stay with the Python side

    def test_finish_columns_matches_python_builds(self):
        tasks = _mk_tasks(5)
        for i, t in enumerate(tasks):
            t.node_name = f"node-{i}"
            t.pod.metadata.creation_timestamp = 100.0 + i
        row_of = {t.uid: r for r, t in enumerate(tasks)}
        task_keys = [f"{t.namespace}/{t.name}" for t in tasks]
        rb, cb, keys, hostnames = lib.finish_columns(tasks, row_of, task_keys, TaskStatus.BINDING)
        assert np.frombuffer(rb, np.int64).tolist() == list(range(5))
        assert np.frombuffer(cb, np.float64).tolist() == [100.0 + i for i in range(5)]
        assert keys == task_keys
        assert hostnames == [f"node-{i}" for i in range(5)]
        assert all(t.status is TaskStatus.BINDING for t in tasks)

    def test_finish_columns_unencoded_task_keys_lazily(self):
        tasks = _mk_tasks(2)
        for t in tasks:
            t.node_name = "n0"
        rb, _, keys, _ = lib.finish_columns(tasks, {tasks[0].uid: 0}, ["ns/p0"], None)
        assert np.frombuffer(rb, np.int64).tolist() == [0, -1]
        assert keys == ["ns/p0", "ns/p1"]
        assert tasks[0].status is TaskStatus.PENDING and tasks[1].status is TaskStatus.PENDING


# -- the port's module against the JAX package's, on the same inputs -----------------


def _summary(x):
    """A comparable view of a native function's output."""
    if isinstance(x, (list, tuple)):
        return type(x)(_summary(v) for v in x)
    if isinstance(x, dict):
        return {k: _summary(v) for k, v in x.items()}
    if isinstance(x, (bytes, str, int, float, type(None))):
        return x
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if hasattr(x, "uid") and hasattr(x, "status"):
        return ("task", x.uid, x.status, x.node_name, x.volume_ready)
    raise TypeError(type(x))


def _world_state(tasks, extra=()):
    return [(t.uid, t.status, t.node_name, t.volume_ready) for t in tasks] + list(extra)


def _case(fn, seed):
    """A maker of one native function's inputs: each call makes fresh,
    identical inputs from the seed and returns them with a reader of the
    state the function mutates."""
    rng = np.random.default_rng(seed)
    n, n_nodes = 64, 5
    rows = rng.permutation(n).tolist()
    nrows = rng.integers(0, n_nodes, n).tolist()
    allocs = rng.integers(0, 2, n).astype(np.uint8).tobytes()
    cut = sorted(rng.integers(0, n, 2).tolist())

    def tasks_():
        ts = _mk_tasks(n)
        for i, t in enumerate(ts):
            t.node_name = f"node-{i % n_nodes}"
            t.pod.metadata.creation_timestamp = float(i % 7)
        return ts

    if fn == "bulk_assign":
        def build():
            ts = tasks_()
            nt = [dict() for _ in range(n_nodes)]
            args = (ts, [f"ns/{t.name}" for t in ts], nt, [f"node-{i}" for i in range(n_nodes)],
                    np.asarray(rows, np.int64), np.asarray(nrows, np.int64), allocs,
                    [cut[0], cut[1] - cut[0], n - cut[1]], TaskStatus.ALLOCATED, TaskStatus.PIPELINED)
            return args, lambda: _world_state(ts, [(k, v.status, v.node_name) for d in nt for k, v in d.items()])
        return build
    if fn == "bulk_set_slot":
        def build():
            ts = tasks_()
            return (ts, "status", TaskStatus.BINDING), lambda: _world_state(ts)
        return build
    if fn == "collect_pending":
        def build():
            jobs = _pending_jobs(seed)
            return (jobs, TaskStatus.PENDING, MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR), lambda: []
        return build
    if fn == "extract_task_columns":
        def build():
            jobs = _pending_jobs(seed)
            ts = [t for j in jobs for t in j.tasks.values()]
            outs = (np.zeros((128, 2), np.float32), np.zeros((128, 2), np.float32), np.zeros(128, np.int32),
                    np.zeros(128, bool), np.zeros(128, bool))
            job_idx = {uid: i for i, uid in enumerate(sorted({t.job for t in ts}))}
            return (ts, job_idx, *outs), lambda: [_summary(o) for o in outs]
        return build
    if fn == "extract_node_columns":
        def build():
            c = torch_testing.FakeCache(build_world(TORCH.models, "multi_queue_400_40")).snapshot()
            out = np.zeros((4, 128, 2), np.float64)
            nodes = [c.nodes[k] for k in sorted(c.nodes)]
            return (nodes, ("idle", "releasing", "used", "allocatable"), out), lambda: [_summary(out)]
        return build
    if fn == "class_dedup":
        def build():
            r = np.random.default_rng(seed)
            key = np.ascontiguousarray(r.integers(0, 3, (200, 4)).astype(np.float64))
            return (key,), lambda: []
        return build
    if fn == "bulk_dispatch":
        def build():
            jobs = [_allocated_job(f"j{j}", [f"j{j}t{i}" for i in range(3)]) for j in range(5)]
            mask = bytes(int(b) for b in np.random.default_rng(seed).integers(0, 2, 5))
            return (jobs, mask, TaskStatus.ALLOCATED, TaskStatus.BINDING), lambda: [
                (j.uid, {s.name: list(d) for s, d in j.task_status_index.items()}) for j in jobs]
        return build
    if fn == "finish_columns":
        def build():
            ts = tasks_()
            row_of = {t.uid: r for r, t in enumerate(ts) if r % 3}
            return (ts, row_of, [f"ns/{t.name}" for t in ts], TaskStatus.BINDING), lambda: _world_state(ts)
        return build
    if fn == "bulk_res_axpy":
        def build():
            r = np.random.default_rng(seed)
            rs = [Resource(milli_cpu=float(r.integers(0, 9000)), memory=float(r.integers(0, 1 << 30)))
                  for _ in range(20)]
            d = np.ascontiguousarray(r.integers(0, 1000, (20, 3)).astype(np.float64))
            return (rs, d, -1), lambda: [(x.milli_cpu, x.memory) for x in rs]
        return build
    raise KeyError(fn)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", NATIVE_FUNCTIONS)
def test_port_function_equals_the_jax_packages(fn, seed):
    """The port's native function and the JAX package's, each on its own
    fresh copy of the same port objects: the same return value and the
    same mutations."""
    assert JAX_LIB is not None, "the JAX package's native module is not built"
    build = _case(fn, seed)
    args, state = build()
    got = _summary(getattr(lib, fn)(*args))
    got_state = state()
    args, state = build()
    want = _summary(getattr(JAX_LIB, fn)(*args))
    assert got == want
    assert got_state == state()


# -- B1's class numbering: native first-occurrence against np.unique --------------------


@pytest.mark.parametrize("world", [
    ("preempt_mix", (2000, 40), {"seed": 1}),
    ("preempt_mix", (1500, 200), {}),
    ("multi_tenant_ml", (8, 8, 3), {}),
    ("multi_tenant_ml", (12, 6, 4), {"seed": 2}),
])
def test_class_numbering_gives_equal_state_and_binds(world):
    """B1's plain version on one snapshot packed with native class_dedup
    (first-occurrence class order) and with np.unique (sorted order): the
    packed class tables differ, the SolveState and the binds do not."""
    fn, args, kwargs = world
    cluster = getattr(TORCH.models, fn)(*args, **kwargs)
    _, arrays = solver_arrays(cluster)
    a = arrays_from_numpy(arrays)
    n = {k: np.asarray(v) for k, v in a.items()}
    _, first_native, inv_native = fs._class_inverse(n)
    assert native.calls["class_dedup"] == 1
    state_native = fs.FusedSolver(a, True, True, device="cpu").solve()
    binds_native = allocate(cluster, device="cpu")
    native.set_enabled(False)
    _, first_sorted, inv_sorted = fs._class_inverse(n)
    state_sorted = fs.FusedSolver(a, True, True, device="cpu").solve()
    binds_sorted = allocate(cluster, device="cpu")
    # the same classes (row sets), numbered differently
    assert len(first_native) == len(first_sorted)
    assert np.array_equal(first_native[inv_native], first_sorted[inv_sorted])
    if len(first_native) > 2:
        assert not np.array_equal(first_native, first_sorted)
    for f in state_native._fields:
        x, y = getattr(state_native, f), getattr(state_sorted, f)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f
    assert (binds_native.binds, binds_native.pipelined) == (binds_sorted.binds, binds_sorted.pipelined)
    assert binds_native.binds


def test_class_dedup_fault_takes_np_unique():
    cluster = TORCH.models.multi_tenant_ml(8, 8, 3)
    _, arrays = solver_arrays(cluster)
    n = {k: np.asarray(v) for k, v in arrays_from_numpy(arrays).items()}
    want = fs._class_inverse(n)
    faults.registry.arm("native.class_dedup", count=1)
    before = metrics.fault_injections.value({"point": "native.class_dedup"})
    got = fs._class_inverse(n)
    assert metrics.fault_injections.value({"point": "native.class_dedup"}) == before + 1
    native.set_enabled(False)
    sorted_ = fs._class_inverse(n)
    assert all(np.array_equal(x, y) for x, y in zip(got, sorted_))
    assert np.array_equal(want[1][want[2]], got[1][got[2]])


# -- the action: native on and off against xla_allocate --------------------------


ACTION_KEYS = sorted(SCENARIOS) + ["multi_tenant_ml_8_8_3", "preempt_mix_2000_40_seed1"]


def _make_cluster(key, P):
    return build_world(P.models, key) if key in WORLDS else make(key, P)


@pytest.mark.parametrize("key", ACTION_KEYS)
def test_torch_allocate_native_on_and_off_equal_xla_allocate(key):
    from test_torch_actions import JAX

    from kube_batch_tpu.testing import x64_enabled
    from test_xla_allocate import run_and_capture

    with x64_enabled(False):
        state, want_binds = run_and_capture("xla_allocate", _make_cluster(key, JAX), _conf_text())
    want = {uid: (st.name, node) for uid, (st, node) in state.items()}
    got_on = torch_run(key, "default", cluster=_make_cluster(key, TORCH))
    assert not native.fallbacks
    stepped = bool(got_on[2].last_timings.get("host_steps"))
    if got_on[1]:
        assert native.calls["bulk_assign"] >= 1 and native.calls["bulk_res_axpy"] >= 1
        assert native.calls["bulk_dispatch" if not stepped else "finish_columns"] >= 1
    native.set_enabled(False)
    native.reset_counts()
    got_off = torch_run(key, "default", cluster=_make_cluster(key, TORCH))
    assert not native.calls
    assert got_on[:2] == got_off[:2] == (want, want_binds)


def _conf_text():
    from test_torch_actions import CONFS

    return CONFS["default"]


@pytest.mark.parametrize("point", ["native.load", "native.prepass", "native.dispatch", "native.class_dedup"])
def test_fault_points_give_the_same_outcome(point):
    """Each armed native fault point fires once, counts a fallback (or the
    np.unique numbering), meters the fault, and the cycle's outcome equals
    the unfaulted one."""
    key = "preempt_mix_2000_40_seed1"
    want = torch_run(key, "default", cluster=_make_cluster(key, TORCH))[:2]
    native.reset_counts()
    faults.registry.arm(point, count=1)
    before = metrics.fault_injections.value({"point": point})
    got = torch_run(key, "default", cluster=_make_cluster(key, TORCH))[:2]
    assert metrics.fault_injections.value({"point": point}) == before + 1
    assert got == want
    fn = {"native.load": "load", "native.prepass": "bulk_assign", "native.dispatch": "bulk_dispatch"}.get(point)
    if fn is not None:
        assert native.fallbacks[fn] == 1
    if point == "native.load":
        assert not native.calls["bulk_assign"]
    if point == "native.dispatch":
        # the Python dispatch barrier ran, then the per-task column pass
        assert native.calls["finish_columns"] == 1


def test_dispatch_gate_reads_the_package_verbosity_not_the_logger():
    key = "preempt_mix_2000_40_seed1"
    logger = logging.getLogger(TA.__name__)
    saved = logger.level
    logger.setLevel(logging.DEBUG)  # a host application's logging setup
    try:
        want = torch_run(key, "default", cluster=_make_cluster(key, TORCH))[:2]
        assert native.calls["bulk_dispatch"] == 1
        native.reset_counts()
        pkg_log.set_verbosity(4)
        got = torch_run(key, "default", cluster=_make_cluster(key, TORCH))[:2]
        assert not native.calls["bulk_dispatch"] and native.calls["finish_columns"] == 1
    finally:
        logger.setLevel(saved)
    assert got == want


def test_dispatch_latency_metric_counts_every_bind():
    key = "preempt_mix_2000_40_seed1"
    before = metrics.task_scheduling_latency.snapshot()["count"]
    _, binds, _, _ = torch_run(key, "default", cluster=_make_cluster(key, TORCH))
    after = metrics.task_scheduling_latency.snapshot()
    assert after["count"] - before == len(binds) > 0


def test_volume_rows_in_bulk_take_the_python_twin(monkeypatch):
    """A custom encoder's bulk row with volume claims: the untrusted
    prepass raises before any mutation, the segment replays in Python
    (binding the volumes), the fallback is counted."""
    key = "volume_task"
    want = torch_run(key, "default", cluster=_make_cluster(key, TORCH))[:2]
    native.reset_counts()
    encode_session = TA.encode_session

    def untrusted(*args, **kwargs):
        enc = encode_session(*args, **kwargs)
        enc.arrays["task_host_only"] = np.zeros_like(enc.arrays["task_host_only"])
        enc.host_only = []
        enc.arrays.pop("task_created")
        return enc

    monkeypatch.setattr(TA, "encode_session", untrusted)
    got = torch_run(key, "default", cluster=_make_cluster(key, TORCH))[:2]
    assert native.fallbacks["bulk_assign"] == 1
    assert got == want
