"""The port's `SchedulerCache` against the JAX package's: the cases of
tests/test_cache.py, each run once through either package's store and
cache on the same sequence of store events. Each case asserts what its
JAX twin asserts, on both packages, and returns the cache's mirror and
snapshot field by field (jobs, task statuses and nodes, node idle, used
and releasing, queues, priorities, PodGroup phases); the port's must equal
the JAX package's.
"""

from __future__ import annotations

import dataclasses

import pytest

from test_torch_store import JAX, PORT, norm, resource, wait_until


def task_view(t) -> tuple:
    return (t.status.name, t.node_name, resource(t.resreq), t.job)


def job_view(P, job) -> tuple:
    pg = job.pod_group
    return (
        job.name, job.namespace, job.queue, job.min_available, job.priority,
        pg.status.phase.value if pg is not None else None,
        P.cache.shadow_pod_group(pg) if pg is not None else None,
        norm(job.pdb),
        tuple(sorted((uid, task_view(t)) for uid, t in job.tasks.items())),
    )


def node_view(ni) -> tuple:
    return (
        ni.node is None, resource(ni.idle), resource(ni.used), resource(ni.releasing),
        resource(ni.allocatable), tuple(sorted(ni.tasks)),
        norm(ni.node.conditions) if ni.node is not None else None,
    )


def cluster_view(P, jobs, nodes, queues) -> dict:
    return {
        "jobs": {uid: job_view(P, j) for uid, j in jobs.items()},
        "nodes": {name: node_view(n) for name, n in nodes.items()},
        "queues": {name: (q.name, q.weight) for name, q in queues.items()},
    }


def mirror(P, cache) -> dict:
    with cache._mutex:
        return cluster_view(P, cache.jobs, cache.nodes, cache.queues)


def snap(P, cache) -> dict:
    s = cache.snapshot()
    return cluster_view(P, s.jobs, s.nodes, s.queues)


def only_task(cache):
    return next(iter(next(iter(cache.jobs.values())).tasks.values()))


class FailingBinder:
    def __init__(self, store, fail_times):
        self._store = store
        self.fail_times = fail_times
        self.calls = 0

    def bind(self, pod, hostname):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("injected bind failure")
        self._store.update_pod(dataclasses.replace(pod, node_name=hostname))


# -- the cases of tests/test_cache.py, in its order ---------------------------


def add_pod_accounts_on_node(P, store, cache):
    t = P.t
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8, memory="16Gi", pods=100)))
    store.create_pod(t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING,
                                 req=t.build_resource_list(cpu=2, memory="4Gi")))
    ni = cache.nodes["n1"]
    assert resource(ni.used) == (2000.0, 4 * 2**30, ())
    assert resource(ni.idle)[:2] == (6000.0, 12 * 2**30)
    assert len(ni.tasks) == 1


def node_arriving_after_pods_replays_accounting(P, store, cache):
    t = P.t
    store.create_pod(t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING,
                                 req=t.build_resource_list(cpu=2)))
    assert cache.nodes["n1"].node is None
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    assert resource(cache.nodes["n1"].idle)[0] == 6000.0


def shadow_pod_group_for_annotationless_pod(P, store, cache):
    store.create_pod(P.t.build_pod(name="solo", req=P.t.build_resource_list(cpu=1)))
    job = next(iter(cache.jobs.values()))
    assert P.cache.shadow_pod_group(job.pod_group) and job.min_available == 1
    assert job.queue == "default" and job.pod_group.status.phase.value == "Inqueue"


def shadow_group_shares_controller(P, store, cache):
    for i in range(3):
        pod = P.t.build_pod(name=f"rs-{i}", req=P.t.build_resource_list(cpu=1))
        pod.metadata.owner_job = "rs-frontend"
        store.create_pod(pod)
    assert len(cache.jobs) == 1 and len(next(iter(cache.jobs.values())).tasks) == 3


def other_scheduler_pending_pod_filtered(P, store, cache):
    store.create_pod(P.t.build_pod(name="alien", scheduler_name="default-scheduler"))
    assert not cache.jobs


def other_scheduler_running_pod_occupies_node(P, store, cache):
    t = P.t
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    store.create_pod(t.build_pod(name="alien", node_name="n1", phase=P.types.PodPhase.RUNNING,
                                 scheduler_name="default-scheduler", req=t.build_resource_list(cpu=3)))
    assert resource(cache.nodes["n1"].idle)[0] == 5000.0 and not cache.jobs


def pod_group_binds_tasks_and_default_queue(P, store, cache):
    t = P.t
    store.create_pod_group(t.build_pod_group("pg1", min_member=2))
    for n in ("m1", "m2"):
        store.create_pod(t.build_pod(name=n, group_name="pg1", req=t.build_resource_list(cpu=1)))
    job = cache.jobs["default/pg1"]
    assert job.min_available == 2 and len(job.tasks) == 2 and job.queue == "default"


def pdb_gang_source(P, store, cache):
    ty = P.types
    pdb = ty.PodDisruptionBudget(metadata=ty.ObjectMeta(name="pdb1", namespace="default"), min_available=2)
    store.create_pdb(pdb)
    job = cache.jobs["default/pdb1"]
    assert job.pdb is pdb and job.min_available == 2 and job.queue == "default"


def snapshot_priority_class_resolution(P, store, cache):
    t, ty = P.t, P.types
    store.create_queue(t.build_queue("default"))
    store.create_priority_class(ty.PriorityClass(metadata=ty.ObjectMeta(name="high"), value=1000))
    store.create_priority_class(ty.PriorityClass(metadata=ty.ObjectMeta(name="base"), value=7, global_default=True))
    pg_hi = t.build_pod_group("hi")
    pg_hi.spec.priority_class_name = "high"
    store.create_pod_group(pg_hi)
    store.create_pod_group(t.build_pod_group("lo"))
    store.create_pod(t.build_pod(name="h", group_name="hi"))
    store.create_pod(t.build_pod(name="l", group_name="lo"))
    first = snap(P, cache)
    assert first["jobs"]["default/hi"][4] == 1000 and first["jobs"]["default/lo"][4] == 7
    store.delete_priority_class("base")
    second = snap(P, cache)
    assert second["jobs"]["default/lo"][4] == 0
    return {"first": first, "second": second}


def snapshot_skips_job_with_missing_queue(P, store, cache):
    t = P.t
    store.create_queue(t.build_queue("default"))
    store.create_pod_group(t.build_pod_group("orphan", queue="nonexistent"))
    store.create_pod(t.build_pod(name="o", group_name="orphan"))
    first = snap(P, cache)
    assert "default/orphan" not in first["jobs"]
    store.create_pod_group(t.build_pod_group("ok", queue="default"))
    store.create_pod(t.build_pod(name="k", group_name="ok"))
    second = snap(P, cache)
    assert "default/ok" in second["jobs"]
    return {"first": first, "second": second}


def snapshot_is_deep_clone(P, store, cache):
    t = P.t
    store.create_queue(t.build_queue("default"))
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    store.create_pod(t.build_pod(name="p", req=t.build_resource_list(cpu=1)))
    s = cache.snapshot()
    job = next(iter(s.jobs.values()))
    task = next(iter(job.tasks.values()))
    job.update_task_status(task, P.api.TaskStatus.ALLOCATED)
    s.nodes["n1"].add_task(task)
    assert only_task(cache).status == P.api.TaskStatus.PENDING
    assert resource(cache.nodes["n1"].idle)[0] == 8000.0
    return {"session": cluster_view(P, s.jobs, s.nodes, s.queues)}


def bind_round_trip(P, store, cache):
    t = P.t
    cache.run()
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    store.create_pod(t.build_pod(name="p1", req=t.build_resource_list(cpu=2)))
    cache.bind(only_task(cache), "n1")
    wait_until(lambda: store.get_pod("default", "p1").node_name == "n1", what="bind write-back")
    wait_until(lambda: only_task(cache).status == P.api.TaskStatus.BOUND, what="Binding -> Bound")
    assert resource(cache.nodes["n1"].used)[0] == 2000.0 and len(cache.nodes["n1"].tasks) == 1


def failed_bind_resyncs_task(P, store, cache):
    binder = FailingBinder(store, fail_times=10**9)
    sc = P.cache.SchedulerCache(store, binder=binder)
    sc.run()
    try:
        store.create_node(P.t.build_node("n1", P.t.build_resource_list(cpu=8)))
        store.create_pod(P.t.build_pod(name="p1", req=P.t.build_resource_list(cpu=2)))
        sc.bind(only_task(sc), "n1")
        wait_until(lambda: binder.calls >= 1, what="binder attempt")
        wait_until(lambda: only_task(sc).status == P.api.TaskStatus.PENDING, what="resync back to Pending")
        assert resource(sc.nodes["n1"].used) == (0.0, 0.0, ())
        assert store.get_pod("default", "p1").node_name == ""
        return {"resynced": mirror(P, sc)}
    finally:
        sc.stop()


def evict_releases_then_deletes(P, store, cache):
    t = P.t
    cache.run()
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    store.create_pod(t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING,
                                 req=t.build_resource_list(cpu=2)))
    cache.evict(only_task(cache), "preempted")
    wait_until(lambda: store.get_pod("default", "p1") is None, what="evict delete")
    wait_until(lambda: not cache.nodes["n1"].tasks, what="node cleanup")
    assert resource(cache.nodes["n1"].idle)[0] == 8000.0


def terminated_job_gc(P, store, cache):
    cache.run()
    store.create_pod_group(P.t.build_pod_group("pg1"))
    store.create_pod(P.t.build_pod(name="m1", group_name="pg1"))
    assert "default/pg1" in cache.jobs
    store.delete_pod("default", "m1")
    store.delete_pod_group("default", "pg1")
    wait_until(lambda: "default/pg1" not in cache.jobs, what="job GC")


def shadow_job_gc_after_pod_delete(P, store, cache):
    cache.run()
    store.create_pod(P.t.build_pod(name="solo", req=P.t.build_resource_list(cpu=1)))
    assert len(cache.jobs) == 1
    store.delete_pod("default", "solo")
    wait_until(lambda: not cache.jobs, what="shadow job GC")


def pdb_does_not_stomp_podgroup_queue(P, store, cache):
    ty = P.types
    store.create_pod_group(P.t.build_pod_group("pg1", queue="research"))
    store.create_pdb(ty.PodDisruptionBudget(
        metadata=ty.ObjectMeta(name="pdb1", namespace="default", owner_job="default/pg1"), min_available=2))
    assert cache.jobs["default/pg1"].queue == "research"


def unschedulable_condition_writes_through_store(P, store, cache):
    store.create_queue(P.t.build_queue("default"))
    store.create_pod(P.t.build_pod(name="p1", req=P.t.build_resource_list(cpu=1)))
    cache.record_job_status_event(next(iter(cache.jobs.values())))
    conds = store.get_pod("default", "p1").conditions
    assert any(c.type == "PodScheduled" and c.status == "False" for c in conds)
    return {"conditions": norm(conds)}


def node_update_reconciles_resources(P, store, cache):
    t = P.t
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    store.create_pod(t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING,
                                 req=t.build_resource_list(cpu=2)))
    store.update_node(t.build_node("n1", t.build_resource_list(cpu=16)))
    ni = cache.nodes["n1"]
    assert resource(ni.idle)[0] == 14000.0 and resource(ni.used)[0] == 2000.0


def delete_node(P, store, cache):
    store.create_node(P.t.build_node("n1", P.t.build_resource_list(cpu=8)))
    store.delete_node("n1")
    assert "n1" not in cache.nodes


def pod_update_resize_reaccounts(P, store, cache):
    t = P.t
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    pod = t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING, req=t.build_resource_list(cpu=2))
    store.create_pod(pod)
    resized = t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING, req=t.build_resource_list(cpu=4))
    resized.metadata.uid = pod.metadata.uid
    store.update_pod(resized)
    assert resource(cache.nodes["n1"].used)[0] == 4000.0
    assert len(next(iter(cache.jobs.values())).tasks) == 1


def shadow_job_member_delete_does_not_strand(P, store, cache):
    store.create_pod(P.t.build_pod(name="solo", req=P.t.build_resource_list(cpu=1)))
    job = next(iter(cache.jobs.values()))
    assert len(job.tasks) == 1
    store.delete_pod("default", "solo")
    assert not job.tasks


def terminated_pod_lifecycle_does_not_strand_task(P, store, cache):
    t, ph = P.t, P.types.PodPhase
    cache.run()
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    pod = t.build_pod(name="p1", node_name="n1", phase=ph.RUNNING, req=t.build_resource_list(cpu=2))
    store.create_pod(pod)
    done = t.build_pod(name="p1", node_name="n1", phase=ph.SUCCEEDED, req=t.build_resource_list(cpu=2))
    done.metadata.uid = pod.metadata.uid
    store.update_pod(done)
    assert resource(cache.nodes["n1"].idle)[0] == 8000.0
    assert len(next(iter(cache.jobs.values())).tasks) == 1
    store.update_pod(done)
    succeeded = mirror(P, cache)
    store.delete_pod("default", "p1")
    wait_until(lambda: not cache.jobs, what="terminated shadow job GC")
    return {"succeeded": succeeded}


def node_condition_change_reaches_mirror(P, store, cache):
    store.create_node(P.t.build_node("n1", P.t.build_resource_list(cpu=8)))
    broken = P.t.build_node("n1", P.t.build_resource_list(cpu=8))
    broken.conditions = [P.types.NodeCondition(type="Ready", status="False")]
    store.update_node(broken)
    assert not cache.nodes["n1"].node.ready()


def cache_stop_then_run_resyncs_again(P, store, cache):
    binder = FailingBinder(store, fail_times=3)
    sc = P.cache.SchedulerCache(store, binder=binder)
    sc.run()
    sc.stop()
    sc.run()
    try:
        store.create_node(P.t.build_node("n1", P.t.build_resource_list(cpu=8)))
        store.create_pod(P.t.build_pod(name="p1", req=P.t.build_resource_list(cpu=2)))
        sc.bind(only_task(sc), "n1")
        wait_until(lambda: binder.calls >= 1, what="first bind attempt")
        wait_until(lambda: only_task(sc).status == P.api.TaskStatus.PENDING, what="resync after restart")
        return {"resynced": mirror(P, sc)}
    finally:
        sc.stop()


def group_annotation_requires_podgroup_to_snapshot(P, store, cache):
    store.create_queue(P.t.build_queue("default"))
    store.create_pod(P.t.build_pod(name="waiting", group_name="late-pg"))
    assert "default/late-pg" in cache.jobs
    before = snap(P, cache)
    assert "default/late-pg" not in before["jobs"]
    store.create_pod_group(P.t.build_pod_group("late-pg"))
    after = snap(P, cache)
    assert "default/late-pg" in after["jobs"]
    return {"before": before, "after": after}


def annotated_pod_survives_group_annotation(P, store, cache):
    pod = P.t.build_pod(name="g1", group_name="pg1", req=P.t.build_resource_list(cpu=1))
    assert P.types.GROUP_NAME_ANNOTATION_KEY in pod.metadata.annotations
    store.create_pod_group(P.t.build_pod_group("pg1"))
    store.create_pod(pod)
    assert len(cache.jobs["default/pg1"].tasks) == 1


CASES = [
    add_pod_accounts_on_node,
    node_arriving_after_pods_replays_accounting,
    shadow_pod_group_for_annotationless_pod,
    shadow_group_shares_controller,
    other_scheduler_pending_pod_filtered,
    other_scheduler_running_pod_occupies_node,
    pod_group_binds_tasks_and_default_queue,
    pdb_gang_source,
    snapshot_priority_class_resolution,
    snapshot_skips_job_with_missing_queue,
    snapshot_is_deep_clone,
    bind_round_trip,
    failed_bind_resyncs_task,
    evict_releases_then_deletes,
    terminated_job_gc,
    shadow_job_gc_after_pod_delete,
    pdb_does_not_stomp_podgroup_queue,
    unschedulable_condition_writes_through_store,
    node_update_reconciles_resources,
    delete_node,
    pod_update_resize_reaccounts,
    shadow_job_member_delete_does_not_strand,
    terminated_pod_lifecycle_does_not_strand_task,
    node_condition_change_reaches_mirror,
    cache_stop_then_run_resyncs_again,
    group_annotation_requires_podgroup_to_snapshot,
    annotated_pod_survives_group_annotation,
]


def run_case(case, P) -> dict:
    store = P.store.ClusterStore()
    cache = P.cache.SchedulerCache(store)
    try:
        extra = case(P, store, cache) or {}
        return {"mirror": mirror(P, cache), "snapshot": snap(P, cache), **extra}
    finally:
        cache.stop()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_cache_equals_the_jax_cache(case):
    jax, port = run_case(case, JAX), run_case(case, PORT)
    assert port == jax


def _gang_store(P):
    t = P.t
    store = P.store.ClusterStore()
    store.create_queue(t.build_queue("default"))
    for i in range(3):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    store.create_pod_group(t.build_pod_group("pg", min_member=3))
    for i in range(4):
        store.create_pod(t.build_pod(name=f"p{i}", group_name="pg", req=t.build_resource_list(cpu=1, memory="1Gi")))
    return store


def bind_many_round_trip(P):
    """bind_many: one mutex round, one pool submission; every pair lands
    Bound through the store's echo, and a pair whose task vanished
    resyncs instead of aborting the batch."""
    store = _gang_store(P)
    cache = P.cache.SchedulerCache(store)
    cache.run()
    try:
        tasks = sorted(next(iter(cache.jobs.values())).tasks.values(), key=lambda t: t.name)
        ghost = P.api.TaskInfo(P.t.build_pod(name="ghost", group_name="pg"))
        ghost.job = "default/pg"
        cache.bind_many([(t, f"n{i % 3}") for i, t in enumerate(tasks)] + [(ghost, "n0")])
        wait_until(lambda: all(p.node_name for p in store.list("pods")), what="bulk write-back")
        wait_until(lambda: all(t.status == P.api.TaskStatus.BOUND for t in next(iter(cache.jobs.values())).tasks.values()),
                   what="all Bound")
        return {"mirror": mirror(P, cache), "pods": sorted(norm(p) for p in store.list("pods"))}
    finally:
        cache.stop()


def bind_write_fault_retries_in_place(P):
    """bind.write fires once: the write is retried in place and lands,
    with write_retries_total{op="bind"} counting the retry."""
    store = _gang_store(P)
    cache = P.cache.SchedulerCache(store)
    before = P.metrics.write_retries.value({"op": "bind"})
    P.faults.registry.arm("bind.write", count=1)
    try:
        task = sorted(next(iter(cache.jobs.values())).tasks.values(), key=lambda t: t.name)[0]
        cache.bind(task, "n1")  # the pool is off: the write runs inline
    finally:
        P.faults.registry.disarm()
    assert store.get_pod("default", "p0").node_name == "n1"
    return {"retries": P.metrics.write_retries.value({"op": "bind"}) - before, "mirror": mirror(P, cache)}


def evict_write_fault_exhausts_retries_then_resyncs(P, monkeypatch):
    """evict.write past KBT_WRITE_RETRIES: the pod stays in the store and
    the task goes back through the resync queue to its store state."""
    monkeypatch.setenv("KBT_WRITE_RETRIES", "0")
    t = P.t
    store = P.store.ClusterStore()
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
    store.create_pod(t.build_pod(name="p1", node_name="n1", phase=P.types.PodPhase.RUNNING,
                                 req=t.build_resource_list(cpu=2)))
    cache = P.cache.SchedulerCache(store)
    cache.run()
    P.faults.registry.arm("evict.write", count=1)
    try:
        cache.evict(only_task(cache), "preempted")
        wait_until(lambda: only_task(cache).status == P.api.TaskStatus.RUNNING, what="resync to Running")
    finally:
        P.faults.registry.disarm()
        cache.stop()
    assert store.get_pod("default", "p1") is not None
    return {"mirror": mirror(P, cache)}


def resync_terminal_drop(P, monkeypatch):
    """A resync that keeps failing is dropped after KBT_RESYNC_MAX_RETRIES
    attempts and counted in resync_dropped_total."""
    monkeypatch.setenv("KBT_RESYNC_MAX_RETRIES", "2")
    store = _gang_store(P)
    cache = P.cache.SchedulerCache(store)
    task = next(iter(cache.jobs.values())).tasks["default-p0"]

    def boom(_task):
        raise RuntimeError("store unreachable")

    cache._sync_task = boom
    before = P.metrics.resync_dropped.value()
    cache.run()
    try:
        cache.resync_task(task)
        wait_until(lambda: P.metrics.resync_dropped.value() - before >= 1, what="terminal drop")
        wait_until(lambda: len(cache._err_tasks) == 0, what="queue empty")
    finally:
        cache.stop()
    return {"dropped": P.metrics.resync_dropped.value() - before}


@pytest.mark.parametrize("case", [bind_many_round_trip, bind_write_fault_retries_in_place],
                         ids=lambda c: c.__name__)
def test_write_side_equals_the_jax_cache(case):
    assert case(PORT) == case(JAX)


@pytest.mark.parametrize("case", [evict_write_fault_exhausts_retries_then_resyncs, resync_terminal_drop],
                         ids=lambda c: c.__name__)
def test_write_side_faults_equal_the_jax_cache(case, monkeypatch):
    assert case(PORT, monkeypatch) == case(JAX, monkeypatch)


def test_bind_many_opens_a_dispatch_span(tmp_path, monkeypatch):
    """bind_many's host side runs under a ``dispatch`` span, child of the
    span that called it, as in the JAX package."""
    from kube_batch_tpu_torch import obs

    monkeypatch.setenv("KBT_FLIGHT_RECORDER", str(tmp_path))
    obs.configure("on")
    obs.recorder.clear()
    try:
        store = _gang_store(PORT)
        cache = PORT.cache.SchedulerCache(store)
        tasks = list(next(iter(cache.jobs.values())).tasks.values())
        with obs.span("cycle"):
            cache.bind_many([(t, "n0") for t in tasks[:2]])
        spans = {s["name"]: s for s in obs.recorder.spans()}
        assert spans["dispatch"]["attrs"]["binds"] == 2
        assert spans["dispatch"]["parent_id"] == spans["cycle"]["span_id"]
        assert obs.check_tree(obs.recorder.spans()) == []
    finally:
        obs.configure()
        obs.recorder.clear()


def test_store_events_feed_the_encode_cache():
    """Every informer event the cache handles reaches the encode cache's
    dirty feed, with the kind and key the JAX cache sends."""
    from kube_batch_tpu_torch.ops import encode_cache

    seen = []

    def listener(kind, key, obj, old):
        seen.append((kind, key, obj is not None, old is not None))

    encode_cache.add_store_listener(listener)
    try:
        store = _gang_store(PORT)
        PORT.cache.SchedulerCache(store)
        pod = store.get_pod("default", "p0")
        store.update_pod(dataclasses.replace(pod, node_name="n0"))
        store.delete_pod("default", "p1")
        store.update_node(PORT.t.build_node("n0", PORT.t.build_resource_list(cpu=8)))
        store.delete_queue("default")
    finally:
        encode_cache.remove_store_listener(listener)
    assert ("pods", pod.metadata.uid, True, True) in seen
    assert ("pods", "default-p1", False, True) in seen
    assert ("nodes", "n0", True, True) in seen and ("queues", "default", False, True) in seen
    assert sum(1 for s in seen if s[0] == "pods") == 4 + 2
