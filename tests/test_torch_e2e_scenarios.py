"""The reference's e2e scenarios through the port, case for case with
tests/test_e2e_scenarios.py, each held against the JAX package on the same
world (jax x64 off).

- ``test_multiple_preemption``: the same name. The JAX case runs the
  serial pipeline conf (``enqueue, reclaim, allocate, backfill,
  preempt``) in a live server loop; here a JAX server and a port server
  run that conf side by side on the same store contents, and both gangs
  must bind with victims evicted, the stores equal. The twin pipeline's
  run of the same scenario is
  tests/test_torch_e2e.py::test_scenario_through_the_live_loop_equals_the_jax_server[multiple_preemption].
- ``test_task_priority_within_one_job`` and
  ``test_hostport_conflicts_spread_across_nodes``: the same names; one
  session of the port's serial ``allocate`` over a FakeCache, task states
  and binds equal to the JAX action's (their live-loop runs are
  test_torch_e2e.py's ``[task_priority]`` and ``[hostport]``).
- ``test_xla_parity_on_these_scenarios``:
  ``test_torch_allocate_parity_on_these_scenarios``; the port's
  ``torch_allocate`` (the fused rung's plain version, the size floor off)
  against its serial ``allocate`` and the JAX ``xla_allocate``.
"""

from __future__ import annotations

from kube_batch_tpu.testing import x64_enabled

from test_torch_e2e import multiple_preemption, multiple_preemption_done
from test_torch_server import JAX, PORT, Twin, pods_state

FULL_PIPELINE_CONF = """
actions: "enqueue, reclaim, allocate, backfill, preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def test_multiple_preemption(tmp_path):
    """reference job.go:182-221: a low-priority job holds the whole
    cluster; two higher-priority gangs arrive and both carve out their
    minimum through preempt, end to end through the live loop."""
    conf = tmp_path / "conf.yaml"
    conf.write_text(FULL_PIPELINE_CONF)
    with Twin(tmp_path, str(conf), str(conf), period=0.05, seed=multiple_preemption) as tw:
        tw.settle(multiple_preemption_done, "both high-priority gangs bound", timeout=60)
        tw.cycles(3)  # the outcome is a fixed point of the loop
        state = tw.same(lambda c, P: pods_state(c.srv.store))
    low_left = [n for n, _ in state if n.startswith("low-")]
    assert len(low_left) < 8, "no victim was preempted"
    assert [a.name for a in tw.port.srv.scheduler.actions] == ["enqueue", "reclaim", "allocate", "backfill", "preempt"]


def task_priority_cluster(P):
    t = P.t
    nodes = [t.build_node("n0", t.build_resource_list(cpu=4, memory="8Gi", pods=10))]
    pods = [t.build_pod(name=f"worker-{i}", group_name="job", req=t.build_resource_list(cpu=1, memory="512Mi"),
                        priority=1) for i in range(8)]
    pods.append(t.build_pod(name="master", group_name="job", req=t.build_resource_list(cpu=1, memory="512Mi"),
                            priority=9))
    return t.build_cluster(pods, nodes, [t.build_pod_group("job", min_member=4)], [t.build_queue("default")])


def hostport_cluster(P):
    t = P.t
    nodes = [t.build_node(f"n{i}", t.build_resource_list(cpu=8, memory="8Gi", pods=20)) for i in range(3)]
    pods = []
    for i in range(6):
        pod = t.build_pod(name=f"hp-{i}", group_name="hp-job", req=t.build_resource_list(cpu=1, memory="512Mi"))
        pod.containers[0].ports = [28080]
        pods.append(pod)
    return t.build_cluster(pods, nodes, [t.build_pod_group("hp-job", min_member=3)], [t.build_queue("default")])


def session(P, action_name: str, cluster):
    """One session of ``action_name`` over a FakeCache of ``cluster``:
    (task states by uid, binds)."""
    from importlib import import_module

    import_module(f"{P.name}.actions")
    import_module(f"{P.name}.plugins")
    fw = import_module(f"{P.name}.framework")
    conf = import_module(f"{P.name}.conf")
    args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}} if action_name == "torch_allocate" else {}
    cache = P.t.FakeCache(cluster)
    ssn = fw.open_session(cache, conf.parse_scheduler_conf(FULL_PIPELINE_CONF).tiers, args)
    fw.get_action(action_name).execute(ssn)
    state = {t.uid: (t.status.name, t.node_name)
             for j in ssn.jobs.values() for d in j.task_status_index.values() for t in d.values()}
    fw.close_session(ssn)
    return state, dict(cache.binder.binds)


def both_serial(make):
    with x64_enabled(False):
        ref = session(JAX, "allocate", make(JAX))
    got = session(PORT, "allocate", make(PORT))
    assert got == ref
    return got


def test_task_priority_within_one_job():
    """reference job.go:291-330: the master-priority task and the
    highest-priority workers win the four slots."""
    _, binds = both_serial(task_priority_cluster)
    assert len(binds) == 4
    assert "default/master" in binds, "master-priority task must win a slot"
    assert sum(1 for k in binds if k.startswith("default/worker-")) == 3


def test_hostport_conflicts_spread_across_nodes():
    """reference predicates.go:78-105: 2*nn pods sharing one host port on
    nn nodes: exactly nn bind, one a node, nn stay pending."""
    state, _ = both_serial(hostport_cluster)
    bound_nodes = [node for _, node in state.values() if node]
    assert len(bound_nodes) == 3 and len(set(bound_nodes)) == 3, state
    assert sum(1 for st, _ in state.values() if st == "PENDING") == 3


def test_torch_allocate_parity_on_these_scenarios():
    """The device rung reproduces the TaskPriority and Hostport outcomes
    exactly: the port's torch_allocate equals its serial allocate and the
    JAX xla_allocate (the Multiple Preemption loop is held by
    test_multiple_preemption and tests/test_torch_e2e.py)."""
    for make in (task_priority_cluster, hostport_cluster):
        with x64_enabled(False):
            ref = session(JAX, "xla_allocate", make(JAX))
        got = session(PORT, "torch_allocate", make(PORT))
        assert got == session(PORT, "allocate", make(PORT)) == ref, make.__name__
