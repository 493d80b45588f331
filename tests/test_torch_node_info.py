"""The port's ``NodeInfo`` accounting (kube_batch_tpu_torch/api/node_info.py),
case for case with tests/test_node_info.py.

Every JAX case keeps its name and its assertions and runs on both
packages: each case is a function of the package's namespace that checks
the reference's expectation and returns what it read as plain values
(each resource as its fields), and the test asserts the two packages read
the same. No JAX case is left out.
"""

from __future__ import annotations

import types
from importlib import import_module

import pytest


def _ns(root: str) -> types.SimpleNamespace:
    api = import_module(f"{root}.api")
    apis = import_module(f"{root}.apis.types")
    t = import_module(f"{root}.testing")
    return types.SimpleNamespace(
        NodeInfo=api.NodeInfo, Resource=api.Resource, TaskStatus=api.TaskStatus, PodPhase=apis.PodPhase,
        build_node=t.build_node, build_resource_list=t.build_resource_list, build_task=t.build_task,
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")


def both(case):
    ref, got = case(JAX), case(PORT)
    assert got == ref


def rl(P, cpu, mem):
    return P.build_resource_list(cpu, mem)


def make_node(P, cpu="8", mem="8G"):
    return P.NodeInfo(P.build_node("n1", rl(P, cpu, mem)))


def running(P, name, cpu, mem):
    return P.build_task(name=name, req=rl(P, cpu, mem), node_name="n1", phase=P.PodPhase.RUNNING)


def plain(r) -> tuple:
    return (r.milli_cpu, r.memory, dict(r.scalars or {}))


def books(ni) -> tuple:
    return plain(ni.idle), plain(ni.used), plain(ni.releasing), len(ni.tasks)


# -- add and remove --------------------------------------------------------------


def test_add_task_consumes_idle():
    def case(P):
        ni = make_node(P)
        ni.add_task(running(P, "p1", "1", "1G"))
        ni.add_task(running(P, "p2", "2", "2G"))
        assert ni.idle == P.Resource.from_resource_list(rl(P, "5", "5G"))
        assert ni.used == P.Resource.from_resource_list(rl(P, "3", "3G"))
        assert len(ni.tasks) == 2
        return books(ni)

    both(case)


def test_remove_task_restores_idle():
    def case(P):
        ni = make_node(P)
        t1, t2 = running(P, "p1", "1", "1G"), running(P, "p2", "2", "2G")
        ni.add_task(t1)
        ni.add_task(t2)
        ni.remove_task(t1)
        assert ni.idle == P.Resource.from_resource_list(rl(P, "6", "6G"))
        assert ni.used == P.Resource.from_resource_list(rl(P, "2", "2G"))
        return books(ni)

    both(case)


def test_add_duplicate_raises():
    def case(P):
        ni = make_node(P)
        t = running(P, "p1", "1", "1G")
        ni.add_task(t)
        with pytest.raises(KeyError):
            ni.add_task(t)
        return books(ni)

    both(case)


def test_remove_missing_raises():
    def case(P):
        ni = make_node(P)
        with pytest.raises(KeyError):
            ni.remove_task(P.build_task(name="ghost", node_name="n1"))
        return books(ni)

    both(case)


# -- status accounting -----------------------------------------------------------


def test_releasing_task():
    def case(P):
        ni = make_node(P)
        t = running(P, "p1", "2", "2G")
        t.status = P.TaskStatus.RELEASING
        ni.add_task(t)
        assert ni.idle == P.Resource.from_resource_list(rl(P, "6", "6G"))
        assert ni.releasing == P.Resource.from_resource_list(rl(P, "2", "2G"))
        assert ni.used == P.Resource.from_resource_list(rl(P, "2", "2G"))
        during = books(ni)
        ni.remove_task(t)
        assert ni.idle == P.Resource.from_resource_list(rl(P, "8", "8G"))
        assert ni.releasing.is_empty()
        return during, books(ni)

    both(case)


def test_pipelined_task_rides_releasing():
    def case(P):
        ni = make_node(P)
        rel = running(P, "victim", "2", "2G")
        rel.status = P.TaskStatus.RELEASING
        ni.add_task(rel)
        pipe = P.build_task(name="incoming", req=rl(P, "2", "2G"), node_name="n1")
        pipe.status = P.TaskStatus.PIPELINED
        ni.add_task(pipe)
        assert ni.releasing.is_empty()  # 2G releasing - 2G pipelined
        assert ni.idle == P.Resource.from_resource_list(rl(P, "6", "6G"))
        return books(ni)

    both(case)


def test_task_clone_isolation():
    def case(P):
        ni = make_node(P)
        t = running(P, "p1", "1", "1G")
        ni.add_task(t)
        t.status = P.TaskStatus.RELEASING  # the caller's copy
        ni.remove_task(t)  # looked up by key; the node's clone is still RUNNING
        assert ni.idle == P.Resource.from_resource_list(rl(P, "8", "8G"))
        assert ni.releasing.is_empty()
        return books(ni)

    both(case)


# -- set_node and clone ----------------------------------------------------------


def test_set_node_recomputes():
    def case(P):
        ni = make_node(P, "4", "4G")
        ni.add_task(running(P, "p1", "1", "1G"))
        ni.set_node(P.build_node("n1", rl(P, "16", "16G")))
        assert ni.allocatable == P.Resource.from_resource_list(rl(P, "16", "16G"))
        assert ni.idle == P.Resource.from_resource_list(rl(P, "15", "15G"))
        assert ni.used == P.Resource.from_resource_list(rl(P, "1", "1G"))
        return plain(ni.allocatable), books(ni)

    both(case)


def test_clone():
    def case(P):
        ni = make_node(P)
        ni.add_task(running(P, "p1", "1", "1G"))
        c = ni.clone()
        assert c.idle == ni.idle and c.used == ni.used and len(c.tasks) == 1
        c.add_task(running(P, "p2", "1", "1G"))
        assert len(ni.tasks) == 1  # original untouched
        return books(ni), books(c)

    both(case)
