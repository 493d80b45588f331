"""The port's cluster store (`kube_batch_tpu_torch.cache.store`) against
the JAX package's (`kube_batch_tpu.cache.store`): the same create, update,
delete, conditional-write and lease sequence gives the same store
contents, versions, placement versions, node allocations, handler events
and `StaleWrite` reasons.

Also the home of the process twin helpers the other `test_torch_*`
process tests import: ``JAX`` / ``PORT`` (each package's process modules)
and ``norm`` (a package-neutral value of any object of either package).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import re
import time
from types import SimpleNamespace

import pytest

_MODULES = {
    "t": "testing",
    "types": "apis.types",
    "api": "api",
    "store": "cache.store",
    "cache": "cache",
    "cache_mod": "cache.cache",
    "faults": "faults",
    "metrics": "metrics",
    "detector": "faults.mutation_detector",
    "sched": "scheduler",
    "server": "server",
    "framework": "framework",
    "conf": "conf",
    "workqueue": "utils.workqueue",
    "version": "version",
    "cli": "cli",
}


def _pkg(root: str) -> SimpleNamespace:
    if root == "kube_batch_tpu":
        importlib.import_module("kube_batch_tpu.actions")
        importlib.import_module("kube_batch_tpu.plugins")
    return SimpleNamespace(
        name=root, **{k: importlib.import_module(f"{root}.{m}") for k, m in _MODULES.items()}
    )


JAX = _pkg("kube_batch_tpu")
PORT = _pkg("kube_batch_tpu_torch")

_AUTO_UID = re.compile(r"-\d{8}$")
_VOLATILE = ("creation_timestamp", "transition_id", "last_transition_time")


def norm(x):
    """A package-neutral value: dataclasses as (class name, fields),
    enums as their values, dicts as sorted items. Drops what differs
    between two runs by construction: creation timestamps and the
    process-counter uids ``new_uid`` hands out, and a condition's
    transition id (a uuid) and time."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = []
        for f in dataclasses.fields(x):
            if f.name in _VOLATILE:
                continue
            v = getattr(x, f.name)
            if f.name == "uid" and isinstance(v, str) and _AUTO_UID.search(v):
                v = "<auto>"
            out.append((f.name, norm(v)))
        return (type(x).__name__, tuple(out))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return tuple(sorted((str(k), norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(norm(v) for v in x))
    return x


def resource(r) -> tuple:
    return (r.milli_cpu, r.memory, tuple(sorted(r.scalars.items())))


def wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def store_contents(P, store) -> dict:
    return {kind: sorted(norm(o) for o in store.list(kind)) for kind in P.store.KINDS}


class Recorder:
    """Every event a subscribed handler sees, in delivery order."""

    def __init__(self, P, store, kind, filter=None):
        self.events = []
        store.add_event_handler(
            kind,
            P.store.EventHandler(
                on_add=lambda o: self.events.append(("add", norm(o))),
                on_update=lambda a, b: self.events.append(("update", norm(a), norm(b))),
                on_delete=lambda o: self.events.append(("delete", norm(o))),
                filter=filter,
            ),
        )


# -- scenarios, each run once per package -------------------------------------


def _seed(P, store):
    t = P.t
    store.create_queue(t.build_queue("default"))
    store.create_node(t.build_node("n1", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    store.create_node(t.build_node("n2", t.build_resource_list(cpu=2, memory="4Gi", pods=10)))
    store.create_pod_group(t.build_pod_group("pg", min_member=2))
    for i in range(3):
        store.create_pod(t.build_pod(name=f"p{i}", group_name="pg", req=t.build_resource_list(cpu=1)))
    store.create_pod(
        t.build_pod(name="run", node_name="n2", phase=P.types.PodPhase.RUNNING, req=t.build_resource_list(cpu=1))
    )


def crud(P):
    """Create, update, delete and the errors of each verb."""
    store = P.store.ClusterStore()
    rec_pods = Recorder(P, store, P.store.PODS)
    _seed(P, store)
    rec_nodes = Recorder(P, store, P.store.NODES)  # replays the existing nodes
    t = P.t
    errors = []
    try:
        store.create_queue(t.build_queue("default"))
    except P.store.AlreadyExists as e:
        errors.append(("exists", str(e)))
    for verb in (lambda: store.delete_pod("default", "nope"), lambda: store.update_node(t.build_node("n9"))):
        try:
            verb()
        except KeyError as e:
            errors.append(("missing", str(e)))
    try:
        store.create("widgets", t.build_queue("w"))
    except KeyError as e:
        errors.append(("kind", str(e)))
    pod = store.get_pod("default", "p0")
    store.update_pod(dataclasses.replace(pod, node_name="n1"))
    store.update_node(t.build_node("n2", t.build_resource_list(cpu=8, memory="4Gi", pods=10)))
    store.delete_pod("default", "p2")
    store.delete_node("n1")
    return {
        "contents": store_contents(P, store),
        "version": store.version,
        "placement": {n: store.placement_version(n) for n in ("n1", "n2", "n3")},
        "alloc": {n: resource(store.node_allocated(n)) for n in ("n1", "n2", "n3")},
        "pod_events": rec_pods.events,
        "node_events": rec_nodes.events,
        "errors": errors,
    }


def filtered_handler(P):
    """A filtered subscription: an update whose old object is filtered
    out arrives as an add, one whose new object is filtered out as a
    delete (client-go FilteringResourceEventHandler)."""
    store = P.store.ClusterStore()
    rec = Recorder(P, store, P.store.PODS, filter=lambda p: not p.node_name)
    _seed(P, store)
    pod = store.get_pod("default", "p1")
    store.update_pod(dataclasses.replace(pod, node_name="n1"))  # -> delete
    store.update_pod(dataclasses.replace(pod, node_name=""))  # -> add
    run = store.get_pod("default", "run")
    store.update_pod(dataclasses.replace(run, node_name=""))  # -> add
    store.delete_pod("default", "p0")
    return {"events": rec.events, "version": store.version}


def conditional_writes(P):
    """conditional_bind_many / _unbind / _evict: every StaleWrite reason,
    the idempotent re-dispatch cases, and the all-or-nothing commit."""
    store = P.store.ClusterStore()
    _seed(P, store)
    out = []

    def attempt(name, fn):
        try:
            res = fn()
            out.append((name, "ok", norm(res), store.version))
        except P.store.StaleWrite as e:
            out.append((name, "stale", e.kind, e.key, e.reason, e.expected, e.actual, str(e)))

    v = store.version
    attempt("bind", lambda: store.conditional_bind_many([("default", "p0", "n1"), ("default", "p1", "n1")], v))
    attempt("again_same_host", lambda: store.conditional_bind_many([("default", "p0", "n1")], store.version))
    attempt("already_bound", lambda: store.conditional_bind_many([("default", "p0", "n2")], store.version))
    attempt("missing", lambda: store.conditional_bind_many([("default", "zz", "n1")], store.version))
    attempt("no_node", lambda: store.conditional_bind_many([("default", "p2", "n9")], store.version))
    attempt("stale_node", lambda: store.conditional_bind_many([("default", "p2", "n1")], v))
    # the second entry is missing: the first, which fits, does not land either
    attempt("all_or_nothing", lambda: store.conditional_bind_many(
        [("default", "p2", "n2"), ("default", "run2", "n2")], store.version))
    # n2 holds 1 of 2 cpu: two more pods of 1 cpu do not fit, nothing lands
    store.create_pod(P.t.build_pod(name="run2", req=P.t.build_resource_list(cpu=1)))
    attempt("capacity_batch", lambda: store.conditional_bind_many(
        [("default", "p2", "n2"), ("default", "run2", "n2")], store.version))
    attempt("unbind_stale", lambda: store.conditional_unbind("default", "p0", v))
    attempt("unbind", lambda: store.conditional_unbind("default", "p0", store.version))
    attempt("unbind_again", lambda: store.conditional_unbind("default", "p0", store.version))
    attempt("unbind_missing", lambda: store.conditional_unbind("default", "zz", store.version))
    attempt("evict_stale", lambda: store.conditional_evict("default", "p1", v))
    attempt("evict", lambda: store.conditional_evict("default", "p1", store.version))
    attempt("evict_again", lambda: store.conditional_evict("default", "p1", store.version))
    P.faults.registry.arm("store.conflict", count=3)
    try:
        attempt("injected_bind", lambda: store.conditional_bind_many([("default", "p2", "n1")], store.version))
        attempt("injected_unbind", lambda: store.conditional_unbind("default", "run", store.version))
        attempt("injected_evict", lambda: store.conditional_evict("default", "run", store.version))
    finally:
        P.faults.registry.disarm()
    return {
        "attempts": out,
        "contents": store_contents(P, store),
        "placement": {n: store.placement_version(n) for n in ("n1", "n2")},
        "alloc": {n: resource(store.node_allocated(n)) for n in ("n1", "n2")},
    }


def leases(P):
    """The lease verb under the arbiter's clock: acquire, renew, a fresh
    lease held against another candidate, takeover after expiry, release,
    and the refused identities and durations."""
    store = P.store.ClusterStore()
    rec = Recorder(P, store, P.store.LEASES)
    out = []
    for ident, dur, now in [
        ("a", 10.0, 100.0), ("a", 10.0, 105.0), ("b", 10.0, 110.0),
        ("b", 10.0, 115.1), ("a", 10.0, 116.0),
    ]:
        out.append(norm(store.try_acquire_lease("kube-batch", ident, dur, now=now)))
    out.append(norm(store.release_lease("kube-batch", "a")))
    out.append(norm(store.release_lease("kube-batch", "b")))
    out.append(norm(store.try_acquire_lease("kube-batch", "a", 10.0, now=117.0)))
    out.append(norm(store.release_lease("nope", "a")))
    for ident, dur in [("", 10.0), ("a", 0.0), ("a", float("nan")), ("a", 1e9)]:
        with pytest.raises(ValueError) as exc:
            store.try_acquire_lease("kube-batch", ident, dur, now=120.0)
        out.append(str(exc.value))
    with pytest.raises(ValueError) as exc:
        store.release_lease("kube-batch", "")
    out.append(str(exc.value))
    return {"leases": out, "events": rec.events, "version": store.version}


def replay_at_subscription(P):
    """A handler registered on a populated store sees every existing
    object once, as an add, and then the mutations' own events."""
    store = P.store.ClusterStore()
    _seed(P, store)
    recs = {kind: Recorder(P, store, kind) for kind in P.store.KINDS}
    store.create_pod(P.t.build_pod(name="late", req=P.t.build_resource_list(cpu=1)))
    store.delete_pod_group("default", "pg")
    return {kind: sorted(r.events) for kind, r in recs.items()}


def reentrant_handler(P):
    """A handler that mutates the store from inside its callback: the
    nested event is delivered inline, every handler sees every event
    exactly once, in mutation order."""
    store = P.store.ClusterStore()
    seen = []

    def on_add(pod):
        seen.append(("first", pod.name))
        if pod.name == "a":
            store.create_pod(P.t.build_pod(name="b"))

    store.add_event_handler(P.store.PODS, P.store.EventHandler(on_add=on_add))
    store.add_event_handler(
        P.store.PODS, P.store.EventHandler(on_add=lambda p: seen.append(("second", p.name)))
    )
    store.create_pod(P.t.build_pod(name="a"))
    return {"seen": seen, "version": store.version}


SCENARIOS = {
    "crud": crud,
    "filtered_handler": filtered_handler,
    "conditional_writes": conditional_writes,
    "leases": leases,
    "replay_at_subscription": replay_at_subscription,
    "reentrant_handler": reentrant_handler,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_store_equals_the_jax_store(name):
    jax, port = SCENARIOS[name](JAX), SCENARIOS[name](PORT)
    assert port == jax


def test_the_conditional_writes_reject_as_the_reference_says():
    """The reasons, checked outright on the port (the parity above holds
    them equal to the JAX package's)."""
    got = conditional_writes(PORT)["attempts"]
    reasons = {a[0]: (a[1], a[4] if a[1] == "stale" else None) for a in got}
    assert reasons == {
        "bind": ("ok", None), "again_same_host": ("ok", None),
        "already_bound": ("stale", "already_bound"), "missing": ("stale", "missing"),
        "no_node": ("stale", "no_node"), "stale_node": ("stale", "stale_node"),
        "all_or_nothing": ("stale", "missing"), "capacity_batch": ("stale", "capacity"),
        "unbind_stale": ("stale", "stale_node"), "unbind": ("ok", None),
        "unbind_again": ("ok", None), "unbind_missing": ("stale", "missing"),
        "evict_stale": ("stale", "stale_node"), "evict": ("ok", None), "evict_again": ("ok", None),
        "injected_bind": ("stale", "injected"), "injected_unbind": ("stale", "injected"),
        "injected_evict": ("stale", "injected"),
    }


def test_the_store_version_counts_every_committed_mutation():
    store = PORT.store.ClusterStore()
    _seed(PORT, store)
    assert store.version == 1 + 2 + 1 + 4
    with pytest.raises(PORT.store.AlreadyExists):
        store.create_node(PORT.t.build_node("n1"))
    assert store.version == 8  # a refused write bumps nothing
    assert resource(store.node_allocated("n2")) == (1000.0, 0.0, ())


def test_concurrent_writers_deliver_every_event_once_in_order():
    """Four writer threads: each handler sees each pod exactly once, and
    one pod's add precedes its update."""
    import threading

    store = PORT.store.ClusterStore()
    seen = []
    lock = threading.Lock()

    def note(verb, pod):
        with lock:
            seen.append((verb, pod.name))

    store.add_event_handler(
        PORT.store.PODS,
        PORT.store.EventHandler(on_add=lambda p: note("add", p), on_update=lambda a, b: note("update", b)),
    )

    def writer(w):
        for i in range(50):
            pod = store.create_pod(PORT.t.build_pod(name=f"w{w}-{i}"))
            store.update_pod(dataclasses.replace(pod, node_name="n"))

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(seen) == 400 and len(set(seen)) == 400
    for w in range(4):
        for i in range(50):
            assert seen.index(("add", f"w{w}-{i}")) < seen.index(("update", f"w{w}-{i}"))
    assert store.version == 400
