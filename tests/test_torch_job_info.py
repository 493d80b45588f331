"""The port's ``TaskInfo`` / ``JobInfo`` bookkeeping (kube_batch_tpu_torch/api/job_info.py),
case for case with tests/test_job_info.py.

Every JAX case keeps its name and its assertions and runs on both
packages: each case is a function of the package's namespace that checks
the reference's expectation and returns what it read as plain values (a
resource as its fields, a status by name), and the test asserts the two
packages read the same. No JAX case is left out.
"""

from __future__ import annotations

import types
from importlib import import_module

import pytest


def _ns(root: str) -> types.SimpleNamespace:
    api = import_module(f"{root}.api")
    job_info = import_module(f"{root}.api.job_info")
    apis = import_module(f"{root}.apis.types")
    t = import_module(f"{root}.testing")
    return types.SimpleNamespace(
        JobInfo=api.JobInfo, Resource=api.Resource, TaskStatus=api.TaskStatus, TaskInfo=job_info.TaskInfo,
        get_job_id=job_info.get_job_id, PodPhase=apis.PodPhase, build_pod=t.build_pod,
        build_resource_list=t.build_resource_list, build_task=t.build_task,
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")


def both(case):
    ref, got = case(JAX), case(PORT)
    assert got == ref


def rl(P, cpu, mem):
    return P.build_resource_list(cpu, mem)


def plain(r) -> tuple:
    return (r.milli_cpu, r.memory, dict(r.scalars or {}))


def index(job) -> dict:
    return {st.name: sorted(tasks) for st, tasks in job.task_status_index.items()}


# -- TaskInfo --------------------------------------------------------------------


def test_new_task_from_pending_pod():
    def case(P):
        t = P.build_task(name="p1", req=rl(P, "1", "1G"))
        assert t.status == P.TaskStatus.PENDING
        assert t.resreq == P.Resource.from_resource_list(rl(P, "1", "1G"))
        assert t.priority == 1  # default (job_info.go:80)
        return t.status.name, plain(t.resreq), t.priority

    both(case)


def test_status_from_phase_and_node():
    def case(P):
        got = (
            P.build_task(phase=P.PodPhase.RUNNING, node_name="n1").status,
            P.build_task(phase=P.PodPhase.PENDING, node_name="n1").status,
            P.build_task(phase=P.PodPhase.SUCCEEDED).status,
            P.build_task(phase=P.PodPhase.FAILED).status,
        )
        S = P.TaskStatus
        assert got == (S.RUNNING, S.BOUND, S.SUCCEEDED, S.FAILED)
        return [s.name for s in got]

    both(case)


def test_releasing_when_deleting():
    def case(P):
        pod = P.build_pod(name="doomed", phase=P.PodPhase.RUNNING, node_name="n1")
        pod.metadata.deletion_timestamp = 123.0
        st = P.TaskInfo(pod).status
        assert st == P.TaskStatus.RELEASING
        return st.name

    both(case)


def test_job_id_from_annotation():
    def case(P):
        pod = P.build_pod(namespace="ns", name="p", group_name="pg1")
        got = (P.get_job_id(pod), P.get_job_id(P.build_pod(name="orphan")))
        assert got == ("ns/pg1", "")
        return got

    both(case)


def test_clone_isolates_resources():
    def case(P):
        t = P.build_task(req=rl(P, "1", "1G"))
        c = t.clone()
        c.resreq.add(P.Resource(milli_cpu=1))
        assert t.resreq != c.resreq
        return plain(t.resreq), plain(c.resreq)

    both(case)


# -- JobInfo ---------------------------------------------------------------------


def test_add_task_updates_aggregates():
    def case(P):
        job = P.JobInfo("ns/j1")
        t1 = P.build_task(name="p1", req=rl(P, "1", "1G"), group_name="j1")
        t2 = P.build_task(name="p2", req=rl(P, "2", "2G"), group_name="j1", node_name="n1",
                          phase=P.PodPhase.RUNNING)
        job.add_task_info(t1)
        job.add_task_info(t2)
        assert len(job.tasks) == 2
        assert job.total_request == P.Resource.from_resource_list(rl(P, "3", "3G"))
        # only the running task is allocated
        assert job.allocated == P.Resource.from_resource_list(rl(P, "2", "2G"))
        assert set(job.task_status_index) == {P.TaskStatus.PENDING, P.TaskStatus.RUNNING}
        return plain(job.total_request), plain(job.allocated), index(job)

    both(case)


def test_delete_task_restores_aggregates():
    def case(P):
        job = P.JobInfo("ns/j1")
        t1 = P.build_task(name="p1", req=rl(P, "1", "1G"))
        t2 = P.build_task(name="p2", req=rl(P, "2", "2G"), node_name="n1", phase=P.PodPhase.RUNNING)
        job.add_task_info(t1)
        job.add_task_info(t2)
        job.delete_task_info(t2)
        assert len(job.tasks) == 1
        assert job.total_request == P.Resource.from_resource_list(rl(P, "1", "1G"))
        assert job.allocated.is_empty()
        assert P.TaskStatus.RUNNING not in job.task_status_index
        return plain(job.total_request), index(job)

    both(case)


def test_delete_missing_raises():
    def case(P):
        job = P.JobInfo("ns/j1")
        with pytest.raises(KeyError):
            job.delete_task_info(P.build_task(name="ghost"))
        return len(job.tasks)

    both(case)


def test_update_task_status_moves_index():
    def case(P):
        job = P.JobInfo("ns/j1")
        t = P.build_task(name="p1", req=rl(P, "1", "1G"))
        job.add_task_info(t)
        job.update_task_status(t, P.TaskStatus.ALLOCATED)
        assert P.TaskStatus.PENDING not in job.task_status_index
        assert t.uid in job.task_status_index[P.TaskStatus.ALLOCATED]
        assert job.allocated == P.Resource.from_resource_list(rl(P, "1", "1G"))
        return index(job), plain(job.allocated)

    both(case)


def test_gang_predicates():
    def case(P):
        job = P.JobInfo("ns/j1")
        job.min_available = 2
        t1 = P.build_task(name="p1", req=rl(P, "1", "1G"))
        t2 = P.build_task(name="p2", req=rl(P, "1", "1G"))
        job.add_task_info(t1)
        job.add_task_info(t2)
        seen = [(job.valid_task_num(), job.ready_task_num(), job.ready())]
        assert seen[0] == (2, 0, False)
        job.update_task_status(t1, P.TaskStatus.ALLOCATED)
        seen.append((job.ready_task_num(), job.ready()))
        assert seen[1] == (1, False)
        job.update_task_status(t2, P.TaskStatus.PIPELINED)
        seen.append((job.waiting_task_num(), job.pipelined(), job.ready()))
        assert seen[2] == (1, True, False)  # ready + waiting >= min
        job.update_task_status(t2, P.TaskStatus.BOUND)
        assert job.ready()
        return seen

    both(case)


def test_fit_error_histogram():
    def case(P):
        job = P.JobInfo("ns/j1")
        job.nodes_fit_delta = {
            "n1": P.Resource(milli_cpu=-10),
            "n2": P.Resource(milli_cpu=-10, memory=-1),
        }
        msg = job.fit_error()
        assert "0/2 nodes are available" in msg
        assert "2 insufficient cpu" in msg
        assert "1 insufficient memory" in msg
        empty = P.JobInfo("ns/empty").fit_error()
        assert empty == "0 nodes are available"
        return msg, empty

    both(case)


def test_clone():
    def case(P):
        job = P.JobInfo("ns/j1")
        job.min_available = 2
        job.queue = "q1"
        job.add_task_info(P.build_task(name="p1", req=rl(P, "1", "1G")))
        c = job.clone()
        assert c.uid == job.uid and c.queue == "q1" and c.min_available == 2
        assert len(c.tasks) == 1
        # mutating the clone must not affect the original
        c.update_task_status(next(iter(c.tasks.values())), P.TaskStatus.ALLOCATED)
        assert job.ready_task_num() == 0
        return index(job), index(c)

    both(case)
