"""tests/test_e2e_scenarios.py's scenarios through the port as a process:
each world is seeded into a store, the port's `SchedulerServer` runs the
twin pipeline conf (examples/scheduler-conf-torch-pipeline.yaml with
``device: cpu``) in its live loop, and the store it leaves must equal
what the JAX package's server leaves under its TPU conf
(examples/scheduler-conf-tpu.yaml, jax x64 off) on the same world: the
same pods bound to the same nodes and the same victims evicted. Each
scenario also asserts what its JAX twin asserts.
"""

from __future__ import annotations

import pytest

from test_torch_server import Twin, example, pods_state


def multiple_preemption(P, store):
    """reference job.go:182-221 ("Multiple Preemption"): a low-priority
    job holds the whole cluster; two higher-priority gangs arrive and
    both carve out their min members through preempt."""
    t = P.t
    for i in range(4):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=2, memory="4Gi", pods=10)))
    store.create_pod_group(t.build_pod_group("low", min_member=1))
    for i in range(8):
        store.create_pod(t.build_pod(
            name=f"low-{i}", group_name="low", node_name=f"n{i // 2}", phase=P.types.PodPhase.RUNNING,
            req=t.build_resource_list(cpu=1, memory="1Gi"), priority=1))
    for g in ("high-a", "high-b"):
        store.create_pod_group(t.build_pod_group(g, min_member=2))
        for i in range(2):
            store.create_pod(t.build_pod(name=f"{g}-{i}", group_name=g,
                                         req=t.build_resource_list(cpu=1, memory="1Gi"), priority=9))


def multiple_preemption_done(store):
    pods = {p.metadata.name: p for p in store.list("pods")}
    return all(pods.get(f"{g}-{i}") is not None and pods[f"{g}-{i}"].node_name
               for g in ("high-a", "high-b") for i in range(2))


def multiple_preemption_check(state):
    assert len([n for n, _ in state if n.startswith("low-")]) < 8, "no victim was preempted"


def task_priority(P, store):
    """reference job.go:291-330 ("TaskPriority"): one job whose tasks
    carry different priorities on a cluster with room for only half; the
    master-priority task wins a slot."""
    t = P.t
    store.create_node(t.build_node("n0", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    store.create_pod_group(t.build_pod_group("job", min_member=4))
    for i in range(8):
        store.create_pod(t.build_pod(name=f"worker-{i}", group_name="job",
                                     req=t.build_resource_list(cpu=1, memory="512Mi"), priority=1))
    store.create_pod(t.build_pod(name="master", group_name="job",
                                 req=t.build_resource_list(cpu=1, memory="512Mi"), priority=9))


def task_priority_done(store):
    return sum(1 for p in store.list("pods") if p.node_name) == 4


def task_priority_check(state):
    bound = [n for n, node in state if node]
    assert len(bound) == 4 and "master" in bound
    assert sum(1 for n in bound if n.startswith("worker-")) == 3


def hostport(P, store):
    """reference predicates.go:78-105 ("Hostport"): 2*nn pods sharing one
    hostPort on nn nodes; exactly nn bind, one per node."""
    t = P.t
    for i in range(3):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=8, memory="8Gi", pods=20)))
    store.create_pod_group(t.build_pod_group("hp-job", min_member=3))
    for i in range(6):
        pod = t.build_pod(name=f"hp-{i}", group_name="hp-job", req=t.build_resource_list(cpu=1, memory="512Mi"))
        pod.containers[0].ports = [28080]
        store.create_pod(pod)


def hostport_done(store):
    return sum(1 for p in store.list("pods") if p.node_name) == 3


def hostport_check(state):
    nodes = [node for _, node in state if node]
    assert len(nodes) == 3 and len(set(nodes)) == 3


SCENARIOS = {
    "multiple_preemption": (multiple_preemption, multiple_preemption_done, multiple_preemption_check),
    "task_priority": (task_priority, task_priority_done, task_priority_check),
    "hostport": (hostport, hostport_done, hostport_check),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_through_the_live_loop_equals_the_jax_server(tmp_path, name):
    seed, done, check = SCENARIOS[name]
    with Twin(tmp_path, example("scheduler-conf-tpu.yaml"),
              example("scheduler-conf-torch-pipeline.yaml", tmp_path, cpu=True),
              period=0.1, seed=seed) as tw:
        tw.settle(done, name, timeout=60)
        tw.cycles(3)  # the outcome must be a fixed point of the loop
        state = tw.same(lambda c, P: pods_state(c.srv.store))
        tw.same(lambda c, P: c.items("podgroups"))
    check(state)
    assert [a.name for a in tw.port.srv.scheduler.actions] == [
        "enqueue", "torch_reclaim", "torch_allocate", "torch_backfill", "torch_preempt"]


def preempt_mix_objects(P, *args):
    """A package's ``preempt_mix`` world as the objects a client would
    create in a store (PodGroups Pending): the generator's own objects,
    taken before ``build_cluster`` flips their phases."""
    from unittest import mock

    with mock.patch.object(P.models, "build_cluster", lambda *objects: objects):
        return P.models.preempt_mix(*args)


def test_the_store_path_equals_the_fakecache_path_and_the_jax_store_path(tmp_path):
    """``preempt_mix(2000, 40, seed=1)``: one cycle of the twin pipeline
    over a store-fed cache binds and evicts exactly what the same cycle
    over ``FakeCache`` does (a store-fed cache lists jobs in its own
    order, and its PodGroups arrive Pending for enqueue), and what the
    JAX package's store path does under its TPU conf."""
    import importlib

    from kube_batch_tpu.testing import x64_enabled

    from test_torch_store import JAX, PORT

    for P in (JAX, PORT):
        P.models = importlib.import_module(f"{P.name}.models")
    conf = example("scheduler-conf-torch-pipeline.yaml", tmp_path, cpu=True)

    def store_cycle(P, conf):
        store = P.store.ClusterStore()
        PORT.t.seed_store(store, *preempt_mix_objects(P, 2000, 40, 25, 1))
        cache = P.cache.SchedulerCache(store)
        P.sched.Scheduler(cache, conf).run_once()
        cache.stop()
        return pods_state(store)

    port = store_cycle(PORT, conf)
    with x64_enabled(False):
        assert port == store_cycle(JAX, example("scheduler-conf-tpu.yaml"))

    fake = PORT.t.FakeCache(PORT.models.preempt_mix(2000, 40, seed=1))
    PORT.sched.Scheduler(fake, conf).run_once()
    evicted = set(fake.evictor.evicts)
    assert evicted
    want = sorted(
        (pod.name, fake.binder.binds.get(f"{pod.namespace}/{pod.name}", pod.node_name))
        for pod in PORT.models.preempt_mix_objects(2000, 40, 25, 1)[0]
        if f"{pod.namespace}/{pod.name}" not in evicted
    )
    assert port == want
