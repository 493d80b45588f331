"""The port's volume lifecycle against the JAX package's: the cases of
tests/test_volumes.py (assume-at-allocate / bind-at-dispatch through
``StoreVolumeBinder`` over either package's store), each run once per
package. Every case asserts what its JAX twin asserts, on both packages,
and returns the store's PVs, PVCs and pods, the binder's assumptions and
the session's task states; the port's must equal the JAX package's.

Through a session, the port's ``allocate`` (serial) and ``torch_allocate``
(``device: cpu``, the kernel's plain version) are held against the JAX
package's ``allocate`` and ``xla_allocate`` (jax x64 off).
"""

from __future__ import annotations

import dataclasses

import pytest

from kube_batch_tpu.testing import x64_enabled

from test_torch_store import JAX, PORT, norm, store_contents, wait_until

TIERS = """
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""
ACTIONS = {"serial": {"kube_batch_tpu": "allocate", "kube_batch_tpu_torch": "allocate"},
           "device": {"kube_batch_tpu": "xla_allocate", "kube_batch_tpu_torch": "torch_allocate"}}
ARGS = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}


def inqueue(P, pg):
    # allocate skips Pending-phase PodGroups (the enqueue action's gate);
    # these cases drive allocate directly
    pg.status.phase = P.types.PodGroupPhase.INQUEUE
    return pg


def new_store(P):
    s = P.store.ClusterStore()
    s.create_queue(P.t.build_queue("default"))
    return s


def term(P, zone):
    return P.types.NodeSelectorTerm(key="zone", values=[zone])


def assumed(binder) -> dict:
    return {uid: dict(v) for uid, v in binder._assumed.items()}


def raises(P, fn) -> str:
    with pytest.raises(P.cache_mod.VolumeBindingError) as exc:
        fn()
    return str(exc.value)


# -- binder unit behavior ------------------------------------------------------


def assume_picks_smallest_fitting_pv(P, store):
    t = P.t
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=4)))
    store.create_storage_class(t.build_storage_class("fast"))
    store.create_persistent_volume(t.build_pv("big", capacity="100Gi", storage_class="fast"))
    store.create_persistent_volume(t.build_pv("small", capacity="2Gi", storage_class="fast"))
    store.create_persistent_volume(t.build_pv("wrong-class", capacity="2Gi", storage_class="slow"))
    store.create_persistent_volume_claim(t.build_pvc("c1", storage_class="fast", request="1Gi"))
    task = P.api.TaskInfo(t.build_pod(name="p1", req=t.build_resource_list(cpu=1), volumes=["c1"]))
    binder.allocate_volumes(task, "n1")
    assert binder._assumed[task.uid] == {"default/c1": "small"} and task.volume_ready is False
    first = assumed(binder)
    binder.bind_volumes(task)
    assert task.volume_ready is True
    assert store.get("persistentvolumes", "small").claim_ref == "default/c1"
    pvc = store.get("persistentvolumeclaims", "default/c1")
    assert pvc.volume_name == "small" and pvc.phase.value == "Bound"
    return {"assumed": first, "after": assumed(binder)}


def assume_respects_pv_topology_and_reservation(P, store):
    t = P.t
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(t.build_node("na", labels={"zone": "a"}))
    store.create_node(t.build_node("nb", labels={"zone": "b"}))
    store.create_persistent_volume(t.build_pv("pv-a", node_affinity=[term(P, "a")]))
    store.create_persistent_volume_claim(t.build_pvc("c1", request="1Gi"))
    store.create_persistent_volume_claim(t.build_pvc("c2", request="1Gi"))
    t1 = P.api.TaskInfo(t.build_pod(name="p1", volumes=["c1"]))
    errors = [raises(P, lambda: binder.allocate_volumes(t1, "nb"))]
    binder.allocate_volumes(t1, "na")
    t2 = P.api.TaskInfo(t.build_pod(name="p2", volumes=["c2"]))
    errors.append(raises(P, lambda: binder.allocate_volumes(t2, "na")))
    binder.forget(t1.uid)
    binder.allocate_volumes(t2, "na")
    return {"errors": errors, "assumed": assumed(binder), "reserved": dict(binder._reserved)}


def unknown_claim_fails_assume(P, store):
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(P.t.build_node("n1"))
    task = P.api.TaskInfo(P.t.build_pod(name="p1", volumes=["nope"]))
    return {"error": raises(P, lambda: binder.allocate_volumes(task, "n1"))}


def two_claims_one_pod_distinct_pvs(P, store):
    t = P.t
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(t.build_node("n1"))
    store.create_persistent_volume(t.build_pv("small", capacity="2Gi"))
    store.create_persistent_volume(t.build_pv("big", capacity="20Gi"))
    store.create_persistent_volume_claim(t.build_pvc("c1", request="1Gi"))
    store.create_persistent_volume_claim(t.build_pvc("c2", request="1Gi"))
    task = P.api.TaskInfo(t.build_pod(name="p1", volumes=["c1", "c2"]))
    binder.allocate_volumes(task, "n1")
    assert sorted(binder._assumed[task.uid].values()) == ["big", "small"]
    binder.bind_volumes(task)
    assert store.get("persistentvolumeclaims", "default/c1").volume_name == "small"
    assert store.get("persistentvolumeclaims", "default/c2").volume_name == "big"


def failed_bind_keeps_assumptions_for_retry(P, store):
    t = P.t
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(t.build_node("n1"))
    store.create_persistent_volume(t.build_pv("pv1"))
    store.create_persistent_volume_claim(t.build_pvc("c1", request="1Gi"))
    task = P.api.TaskInfo(t.build_pod(name="p1", volumes=["c1"]))
    binder.allocate_volumes(task, "n1")
    store.delete_persistent_volume("pv1")
    errors = [raises(P, lambda: binder.bind_volumes(task))]
    assert binder._assumed[task.uid] == {"default/c1": "pv1"}
    errors.append(raises(P, lambda: binder.bind_volumes(task)))
    store.create_persistent_volume(t.build_pv("pv1"))
    binder.bind_volumes(task)
    assert store.get("persistentvolumeclaims", "default/c1").volume_name == "pv1"
    return {"errors": errors}


def bound_claim_pins_pod_to_volume_topology(P, store):
    t = P.t
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(t.build_node("na", labels={"zone": "a"}))
    store.create_node(t.build_node("nb", labels={"zone": "b"}))
    pv = t.build_pv("pv-a", node_affinity=[term(P, "a")])
    store.create_persistent_volume(
        dataclasses.replace(pv, claim_ref="default/c1", phase=P.types.VolumePhase.BOUND))
    pvc = t.build_pvc("c1", request="1Gi")
    pvc.volume_name = "pv-a"
    pvc.phase = P.types.VolumePhase.BOUND
    store.create_persistent_volume_claim(pvc)
    task = P.api.TaskInfo(t.build_pod(name="p1", volumes=["c1"]))
    error = raises(P, lambda: binder.allocate_volumes(task, "nb"))
    binder.allocate_volumes(task, "na")
    assert task.volume_ready is True
    return {"error": error}


def unknown_storage_class_fails_assume(P, store):
    binder = P.cache_mod.StoreVolumeBinder(store)
    store.create_node(P.t.build_node("n1"))
    store.create_persistent_volume_claim(P.t.build_pvc("c1", storage_class="no-such-class"))
    task = P.api.TaskInfo(P.t.build_pod(name="p1", volumes=["c1"]))
    return {"error": raises(P, lambda: binder.allocate_volumes(task, "n1"))}


UNIT_CASES = [
    assume_picks_smallest_fitting_pv,
    assume_respects_pv_topology_and_reservation,
    unknown_claim_fails_assume,
    two_claims_one_pod_distinct_pvs,
    failed_bind_keeps_assumptions_for_retry,
    bound_claim_pins_pod_to_volume_topology,
    unknown_storage_class_fails_assume,
]


@pytest.mark.parametrize("case", UNIT_CASES, ids=lambda c: c.__name__)
def test_volume_binder_equals_the_jax_binder(case):
    def run(P):
        store = new_store(P)
        extra = case(P, store) or {}
        return {"store": store_contents(P, store), **extra}

    assert run(PORT) == run(JAX)


# -- through the live cache and an allocate action ------------------------------


def run_allocate(P, store, rung):
    cache = P.cache.SchedulerCache(store)
    tiers = P.conf.parse_scheduler_conf(TIERS).tiers
    ssn = P.framework.open_session(cache, tiers, ARGS)
    P.framework.get_action(ACTIONS[rung][P.name]).execute(ssn)
    state = {
        t.uid: (t.status.name, t.node_name)
        for j in ssn.jobs.values() for d in j.task_status_index.values() for t in d.values()
    }
    P.framework.close_session(ssn)
    cache.stop()
    return state


def gang_with_volumes_binds_atomically(P, store, rung):
    t = P.t
    rl = t.build_resource_list(cpu=4, memory="8Gi", pods=10)
    store.create_node(t.build_node("na", rl, labels={"zone": "a"}))
    store.create_node(t.build_node("nb", rl, labels={"zone": "b"}))
    store.create_persistent_volume(t.build_pv("pv-a", node_affinity=[term(P, "a")]))
    store.create_persistent_volume(t.build_pv("pv-b", node_affinity=[term(P, "b")]))
    store.create_persistent_volume_claim(t.build_pvc("ca", request="1Gi"))
    store.create_persistent_volume_claim(t.build_pvc("cb", request="1Gi"))
    store.create_pod_group(inqueue(P, t.build_pod_group("pg", min_member=2)))
    req = t.build_resource_list(cpu=1, memory="1Gi")
    store.create_pod(t.build_pod(name="pa", group_name="pg", req=req, node_selector={"zone": "a"}, volumes=["ca"]))
    store.create_pod(t.build_pod(name="pb", group_name="pg", req=req, node_selector={"zone": "b"}, volumes=["cb"]))
    state = run_allocate(P, store, rung)
    assert state["default-pa"] in (("BINDING", "na"), ("BOUND", "na")) and state["default-pb"][1] == "nb"
    assert store.get("persistentvolumeclaims", "default/ca").volume_name == "pv-a"
    assert store.get("persistentvolumeclaims", "default/cb").volume_name == "pv-b"
    assert store.get("persistentvolumes", "pv-a").phase.value == "Bound"
    assert store.get_pod("default", "pa").node_name == "na"
    return {"state": state}


def unsatisfiable_claim_leaves_task_pending(P, store, rung):
    t = P.t
    store.create_storage_class(t.build_storage_class("wffc", mode="WaitForFirstConsumer"))
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    store.create_persistent_volume_claim(t.build_pvc("c1", storage_class="wffc"))
    req = t.build_resource_list(cpu=1, memory="1Gi")
    store.create_pod_group(inqueue(P, t.build_pod_group("pg-vol", min_member=1)))
    store.create_pod(t.build_pod(name="vol-pod", group_name="pg-vol", req=req, volumes=["c1"]))
    store.create_pod_group(inqueue(P, t.build_pod_group("pg-plain", min_member=1)))
    store.create_pod(t.build_pod(name="plain-pod", group_name="pg-plain", req=req))
    state = run_allocate(P, store, rung)
    assert state["default-vol-pod"] == ("PENDING", "")
    assert state["default-plain-pod"][1] == "n1"
    assert store.get_pod("default", "vol-pod").node_name == ""
    assert store.get_pod("default", "plain-pod").node_name == "n1"
    return {"state": state}


@pytest.mark.parametrize("rung", ["serial", "device"])
@pytest.mark.parametrize("case", [gang_with_volumes_binds_atomically, unsatisfiable_claim_leaves_task_pending],
                         ids=lambda c: c.__name__)
def test_allocate_with_volumes_equals_the_jax_package(case, rung):
    def run(P):
        store = new_store(P)
        extra = case(P, store, rung)
        return {"store": store_contents(P, store), **extra}

    port = run(PORT)
    with x64_enabled(False):
        jax = run(JAX)
    assert port == jax


def failed_volume_bind_resyncs_task(P):
    """An assumed PV that vanishes before dispatch: bind_volumes raises,
    the task routes through errTasks, and the resync returns it to
    Pending (reference cache.go:512-534)."""
    t = P.t
    store = new_store(P)
    cache = P.cache.SchedulerCache(store)
    cache.run()
    try:
        store.create_node(t.build_node("n1", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
        store.create_persistent_volume(t.build_pv("pv1"))
        store.create_persistent_volume_claim(t.build_pvc("c1", request="1Gi"))
        store.create_pod_group(inqueue(P, t.build_pod_group("pg", min_member=2)))
        req = t.build_resource_list(cpu=1, memory="1Gi")
        store.create_pod(t.build_pod(name="p1", group_name="pg", req=req, volumes=["c1"]))
        store.create_pod(t.build_pod(name="p2", group_name="pg", req=req))
        ssn = P.framework.open_session(cache, P.conf.parse_scheduler_conf(TIERS).tiers)
        job = next(iter(ssn.jobs.values()))
        t1 = next(x for x in job.tasks.values() if x.name == "p1")
        t2 = next(x for x in job.tasks.values() if x.name == "p2")
        ssn.allocate(t1, "n1")
        store.delete_persistent_volume("pv1")
        error = raises(P, lambda: ssn.allocate(t2, "n1"))
        P.framework.close_session(ssn)

        def p1_status():
            return next(x.status for j in cache.jobs.values() for x in j.tasks.values() if x.name == "p1")

        wait_until(lambda: p1_status() == P.api.TaskStatus.PENDING, what="errTasks resync back to Pending")
        return {"error": error, "store": store_contents(P, store), "pods": sorted(
            (x.name, x.status.name, x.node_name) for j in cache.jobs.values() for x in j.tasks.values())}
    finally:
        cache.stop()


def test_failed_volume_bind_resyncs_task():
    assert failed_volume_bind_resyncs_task(PORT) == failed_volume_bind_resyncs_task(JAX)


def test_snapshot_resets_the_binders_assumptions():
    """A new session starts with no assumption left from a gang that never
    dispatched: snapshot() resets the volume binder, in both packages."""
    def run(P):
        t = P.t
        store = new_store(P)
        cache = P.cache.SchedulerCache(store)
        store.create_node(t.build_node("n1"))
        store.create_persistent_volume(t.build_pv("pv1"))
        store.create_persistent_volume_claim(t.build_pvc("c1", request="1Gi"))
        task = P.api.TaskInfo(t.build_pod(name="p1", volumes=["c1"]))
        cache.allocate_volumes(task, "n1")
        held = (assumed(cache.volume_binder), dict(cache.volume_binder._reserved))
        cache.snapshot()
        return held, assumed(cache.volume_binder), dict(cache.volume_binder._reserved), norm(task.volume_ready)

    port = run(PORT)
    assert port == run(JAX)
    assert port[0][0] and not port[1] and not port[2]
