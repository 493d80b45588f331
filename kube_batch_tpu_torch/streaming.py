"""Streaming mode: event-driven micro-cycles on the resident world.

The classic loop (scheduler.py ``run``) sleeps out ``schedule_period``
between full cycles, so a pod that arrives right after a cycle closes
waits a whole period before anyone looks at it — the reference behaves
the same way (scheduler.go:63-86). Streaming mode replaces the sleep
with an event trigger fed by the cache's dirty feed (the same
``_notify_encode_cache`` hook that drives the incremental encoder):
when pods, podgroups, queues or nodes churn, the loop wakes immediately
and runs a **micro-cycle** — the ordinary action pipeline over a
restricted session whose

- jobs are only the dirty gangs (``cache.clone_jobs_for_stream``),
- nodes are the **resident table** harvested from the last full cycle
  (the same ``NodeInfo`` objects the session just allocated against,
  kept alive because ``close_session`` rebinds rather than clears), and
- queues are a fresh clone.

Binds dispatch through the existing statement/journal machinery, so
crash consistency (recovery/) and the cache-mutation detector hold
unchanged. Fairness plugins with cluster-wide ``on_session_open``
sweeps (drf, proportion) are filtered out of micro tiers — periodic
full cycles remain the fairness/preemption backstop, and the pinned
invariant is that micro-cycle drain + full cycles produce bind-for-bind
the same placements as full cycles alone (tests/test_streaming.py).

Failure is always degrade-never-drop: a stale resident table, an
injected ``stream.micro_cycle`` fault, or any micro error invalidates
the resident state and falls back to an immediate full cycle; the
backlog persists in the trigger until gangs actually bind.

Opt in per process with ``KBT_STREAMING=1`` or per conf file with the
``streaming: true`` key; default off.

On the card a micro-cycle is an ordinary ``torch_allocate`` solve over a
near-empty task set against the resident table: the encode (with the
``resident_interpod`` hint), the pack and upload of the node state, one
launch of kernel B1 on the fused rung, the replay and the dispatch. A
micro-cycle that raises degrades to a full cycle, which runs on the same
device: a card's error is never turned into a CPU cycle.

    python -m kube_batch_tpu_torch.streaming [--device cpu] [--json]

runs :func:`smoke` (on the card unless ``--device cpu``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from kube_batch_tpu_torch import metrics, obs
from kube_batch_tpu_torch.api.job_info import get_job_id, job_key
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.cache.store import NODES, POD_GROUPS, PODS, QUEUES
from kube_batch_tpu_torch.conf import Tier
from kube_batch_tpu_torch.framework import open_session

__all__ = [
    "ENV",
    "enabled",
    "MICRO_EXCLUDED_PLUGINS",
    "micro_tiers",
    "gang_key_of",
    "StreamWork",
    "StreamTrigger",
    "StreamState",
    "open_micro_session",
    "SMOKE_CONF",
    "smoke_conf",
    "smoke",
    "main",
]

ENV = "KBT_STREAMING"

# Plugins whose on_session_open does an O(cluster) sweep to build
# fairness state (drf totals, proportion queue deserving). A micro-cycle
# solves a handful of gangs against the resident slab; recomputing
# cluster-wide share state per arrival would erase the latency win, and
# fairness/preemption corrections belong to the periodic full cycle
# anyway. Parity tests therefore compare conf files without these two.
MICRO_EXCLUDED_PLUGINS = frozenset({"drf", "proportion"})


def enabled() -> bool:
    """Process-wide streaming switch (the conf ``streaming:`` key is the
    per-file equivalent; scheduler.py honors either)."""
    return os.environ.get(ENV, "") not in ("", "0")


def micro_tiers(tiers: list[Tier]) -> list[Tier]:
    """The conf tiers minus MICRO_EXCLUDED_PLUGINS, empty tiers dropped."""
    out: list[Tier] = []
    for tier in tiers:
        kept = [p for p in tier.plugins if p.name not in MICRO_EXCLUDED_PLUGINS]
        if kept:
            out.append(Tier(plugins=kept))
    return out


def gang_key_of(pod) -> str:
    """The JobInfo uid a pod's arrival dirties: the annotated gang id,
    or the shadow-job key the cache derives for podgroup-less pods
    (cache.py ``_resolve_shadow_job``)."""
    jid = get_job_id(pod)
    if jid:
        return jid
    return job_key(pod.namespace, pod.metadata.owner_job or pod.metadata.uid)


@dataclass
class StreamWork:
    """One drained batch of churn: the dirty gang backlog (a *copy* —
    the trigger keeps gangs until they bind), pending node patches
    (latest object wins, None = deleted), bound-pod occupancy patches
    (federated absorb mode: peer binds/releases arriving through the
    shard filter as adds/deletes), and whether churn arrived that the
    resident table cannot absorb (bound-pod add/delete from outside our
    own dispatch path, when absorb mode is off)."""

    gangs: set[str] = field(default_factory=set)
    node_patches: dict[str, Optional[object]] = field(default_factory=dict)
    bound_patches: list = field(default_factory=list)
    stale: bool = False
    stale_reason: str = ""


class StreamTrigger:
    """Store-event listener + wakeup condition for the streaming loop.

    Registered on the encode-cache dirty feed (ops/encode_cache.py
    ``add_store_listener``), which cache.py calls after releasing the
    mirror mutex — handlers here may take the trigger lock safely.
    Event rules:

    - pending-pod add: stamp arrival time, dirty the gang, wake;
    - pod bind echo (node_name "" -> set): our own dispatch coming back
      through the store — close the ``time_to_bind_seconds`` loop, no
      wake (nothing new to solve);
    - pod unbind echo (set -> ""): the pod is pending again (our evict,
      or an external controller) — it is a fresh arrival;
    - pending->pending / bound->bound updates: condition/status echoes;
      the gang is already in the backlog, and waking on them would loop
      micro-cycles against an unchanged world (the unschedulable
      condition write after every failed solve would self-trigger);
    - bound-pod add or delete: capacity changed outside any session —
      the resident table is stale, force a full cycle. In **absorb
      mode** (``absorb_external=True``, federated streaming) these are
      instead recorded as bound-pod occupancy patches: a peer shard's
      bind crosses the federated pod filter as an *add* of a bound pod
      (the pending pod was a peer's, filtered out; client-go filtering
      semantics turn the transition into an add) and a peer's release
      as a *delete* — both are plain occupancy changes the resident
      ``NodeInfo`` table absorbs via add_task/remove_task, and the
      store's conditional binds remain the correctness backstop if the
      absorbed view ever lags;
    - node events: recorded as patches the next micro-cycle applies to
      the resident table; wake (new capacity can admit the backlog);
    - podgroup add or spec change: dirty the gang (min_member/queue
      edits change admission); status-only podgroup writes — every
      close_session emits one per session job — are ignored, or each
      full cycle would re-dirty the entire resident world; queue
      events: wake for re-admission.
    """

    def __init__(self, absorb_external: bool = False) -> None:
        # Federated streaming: peer shards' binds arrive as bound-pod
        # adds/deletes — absorb them as occupancy patches instead of
        # degrading to a full cycle per peer bind (which would serialize
        # every shard on everyone else's dispatch rate).
        self.absorb_external = bool(absorb_external)
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._gangs: set[str] = set()  #: guarded_by _lock
        self._bound_patches: list = []  #: guarded_by _lock
        self._node_patches: dict[str, Optional[object]] = {}  #: guarded_by _lock
        self._arrivals: dict[str, float] = {}  #: guarded_by _lock  (pod uid -> arrival stamp)
        self._queues: dict[str, str] = {}  #: guarded_by _lock  (gang key -> queue name)
        self._stale = False  #: guarded_by _lock
        self._stale_reason = ""  #: guarded_by _lock
        # _attached is loop-thread-confined (attach/detach both run on
        # the streaming loop thread), so it stays unguarded on purpose
        self._attached = False

    # -- lifecycle -----------------------------------------------------------

    def attach(self) -> None:
        from kube_batch_tpu_torch.ops import encode_cache

        encode_cache.add_store_listener(self._on_event)
        self._attached = True

    def detach(self) -> None:
        if not self._attached:
            return
        from kube_batch_tpu_torch.ops import encode_cache

        encode_cache.remove_store_listener(self._on_event)
        self._attached = False

    # -- the loop's side -----------------------------------------------------

    def wait(self, timeout: float) -> bool:
        return self._event.wait(timeout)

    def wake(self) -> None:
        self._event.set()

    def backlog_pods(self) -> int:
        with self._lock:
            return len(self._arrivals)

    def drain(self) -> StreamWork:
        """Snapshot the pending churn and clear the wake flag. Gangs are
        copied, not removed — only ``prune`` (called with the gangs a
        micro-cycle finished or found gone) shrinks the backlog, so a
        failed micro-cycle never loses an arrival."""
        with self._lock:
            self._event.clear()
            work = StreamWork(
                gangs=set(self._gangs),
                node_patches=self._node_patches,
                bound_patches=self._bound_patches,
                stale=self._stale,
                stale_reason=self._stale_reason,
            )
            self._node_patches = {}
            self._bound_patches = []
            self._stale = False
            self._stale_reason = ""
        return work

    def prune(self, done) -> None:
        if not done:
            return
        with self._lock:
            self._gangs.difference_update(done)

    def seed(self, keys) -> None:
        """Dirty gang keys from OUTSIDE the event feed and wake the
        loop. Shard-slot adoption uses this: an adopted slot's backlog
        arrived while another scheduler owned it, so the arrival events
        either predate this trigger or were dropped by the old filter —
        seeding makes the next micro-cycle solve exactly the adopted
        keys against the still-valid resident node table (no full-table
        invalidate, no full cycle)."""
        if not keys:
            return
        with self._lock:
            self._gangs.update(keys)
        self._event.set()

    # -- the store's side ----------------------------------------------------

    def _mark_stale(self, reason: str) -> None:
        with self._lock:
            self._stale = True
            self._stale_reason = reason
        self._event.set()

    def _on_event(self, kind: str, key: str, obj, old) -> None:
        if kind == PODS:
            self._on_pod(key, obj, old)
        elif kind == NODES:
            with self._lock:
                self._node_patches[key] = obj  # None on delete
            self._event.set()
        elif kind == POD_GROUPS:
            if obj is None:
                with self._lock:
                    self._queues.pop(key, None)
                return  # deletes resolve via clone_jobs_for_stream's missing set
            # Remember the gang's queue (key is "ns/name" == job uid) so
            # the bind echo can attribute time-to-bind to the right
            # per-queue SLO window even before any recording below.
            queue = getattr(getattr(obj, "spec", None), "queue", "") or "default"
            with self._lock:
                self._queues[key] = queue
            if old is not None and getattr(obj, "spec", None) == getattr(
                old, "spec", None
            ):
                # status-only write (phase/conditions): every cycle's
                # close_session emits these for every session job — if
                # they dirtied gangs, each full cycle would re-dirty the
                # whole resident world and the first micro after it
                # would redo a near-full solve
                return
            with self._lock:
                self._gangs.add(key)  # key is "ns/name" == job uid
            self._event.set()
        elif kind == QUEUES:
            self._event.set()

    def _on_pod(self, key: str, obj, old) -> None:
        now = time.perf_counter()
        if obj is not None and old is None:  # add
            if obj.node_name:
                if self.absorb_external:
                    # a peer shard's bind crossing the federated filter:
                    # occupancy the next micro-cycle charges to the
                    # resident table — no wake (consumed capacity admits
                    # nothing new)
                    with self._lock:
                        self._bound_patches.append(("add", key, obj))
                    return
                self._mark_stale(f"bound pod {key} appeared outside a cycle")
                return
            with self._lock:
                self._gangs.add(gang_key_of(obj))
                self._arrivals.setdefault(key, now)
                backlog = len(self._arrivals)
            metrics.set_streaming_backlog(backlog)
            self._event.set()
        elif obj is not None and old is not None:  # update
            if not old.node_name and obj.node_name:
                with self._lock:
                    t0 = self._arrivals.pop(key, None)
                    backlog = len(self._arrivals)
                    queue = self._queues.get(gang_key_of(obj), "default")
                metrics.set_streaming_backlog(backlog)
                if t0 is not None:
                    # exemplar (KBT_METRICS_EXEMPLARS): the ambient trace
                    # id links this latency sample to the micro-cycle
                    # that bound the pod ("" when tracing is off — not
                    # stored)
                    metrics.observe_time_to_bind(
                        now - t0, exemplar=obs.current_trace_id()
                    )
                    obs.slo.observe("time_to_bind", queue, now - t0)
                    # Synthetic span: the arrival->bind interval was
                    # measured between two watch events, not inside a
                    # ``with`` — emit it post-hoc onto the ambient trace
                    # (the dispatching micro-cycle when the echo arrives
                    # on the loop thread, else its own root).
                    obs.emit(
                        "time_to_bind", t0, now, queue=queue, pod=key,
                    )
            elif old.node_name and not obj.node_name:
                with self._lock:
                    self._gangs.add(gang_key_of(obj))
                    self._arrivals[key] = now
                    backlog = len(self._arrivals)
                metrics.set_streaming_backlog(backlog)
                self._event.set()
        else:  # delete
            if old is not None and old.node_name:
                if self.absorb_external:
                    # a peer's release (or a finished pod leaving the
                    # store): freed capacity can admit the backlog — wake
                    with self._lock:
                        self._bound_patches.append(("remove", key, old))
                    self._event.set()
                    return
                self._mark_stale(f"bound pod {key} deleted outside a cycle")
                return
            with self._lock:
                self._arrivals.pop(key, None)
                backlog = len(self._arrivals)
            metrics.set_streaming_backlog(backlog)


class StreamState:
    """The resident world micro-cycles solve against: the node table of
    the last completed full cycle. ``adopt_full_cycle`` must run in
    run_once's finally *before* close_session (close rebinds
    ``ssn.nodes`` to a fresh dict; grabbing the reference first keeps
    the post-bind state). Any doubt about the table — an aborted cycle,
    a failed micro, external bound-pod churn — invalidates it, and the
    next full cycle rebuilds from a clean snapshot."""

    def __init__(self) -> None:
        self.nodes: Optional[dict[str, NodeInfo]] = None
        self.valid = False
        self.reason = "no full cycle adopted yet"

    def invalidate(self, reason: str = "invalidated") -> None:
        self.nodes = None
        self.valid = False
        self.reason = reason

    def adopt_full_cycle(self, ssn, aborted: bool = False) -> None:
        if aborted:
            self.invalidate("full cycle aborted")
            return
        self.nodes = ssn.nodes
        self.valid = True
        self.reason = ""

    def apply_node_patches(self, patches: dict[str, Optional[object]]) -> None:
        for name, node in patches.items():
            if node is None:
                self.nodes.pop(name, None)
                continue
            ni = self.nodes.get(name)
            if ni is None:
                self.nodes[name] = NodeInfo(node)
            else:
                ni.set_node(node)

    def apply_bound_patches(self, patches) -> bool:
        """Absorb peer-shard occupancy churn (federated streaming) into
        the resident table. Duplicates are benign no-ops — a patch
        recorded just before a backstop full cycle is already reflected
        in the adopted snapshot, and ``add_task``/``remove_task`` key by
        pod, so re-applying it raises KeyError and is skipped. Anything
        else (unknown node, resource underflow) means the resident view
        genuinely diverged: invalidate and let the full cycle rebuild.
        Returns False when invalidated."""
        from kube_batch_tpu_torch.api.job_info import TaskInfo

        for op, key, pod in patches:
            try:
                ni = self.nodes.get(pod.node_name)
                if ni is None:
                    raise ValueError(f"node {pod.node_name!r} not resident")
                if op == "add":
                    ni.add_task(TaskInfo(pod))
                else:
                    ni.remove_task(TaskInfo(pod))
            except KeyError:
                # already absorbed (add) / already gone (remove): the
                # adopted snapshot beat the patch to it
                continue
            except Exception as e:  # noqa: BLE001 - degrade, never guess
                self.invalidate(
                    f"bound-pod churn not absorbable for {key}: {e}"
                )
                return False
        return True


def open_micro_session(cache, tiers, action_arguments, jobs, nodes, queues):
    """A session over the restricted streaming world: dirty-gang jobs,
    the resident node table, cloned queues. Plugin registration, the
    JobValid gate and close_session's status write-back are byte-for-
    byte the full-cycle path — only the snapshot is skipped."""
    binder = getattr(cache, "volume_binder", None)
    reset = getattr(binder, "reset", None)
    if reset is not None:
        reset()  # per-session provisional PV state, same as snapshot()
    return open_session(
        cache, micro_tiers(tiers), action_arguments, world=(jobs, nodes, queues)
    )


# -- smoke -------------------------------------------------------------------


SMOKE_CONF = """
actions: "enqueue, torch_allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
actionArguments:
  torch_allocate:
    device: {device}
    min_device_pairs: 0
streaming: {streaming}
"""


def smoke_conf(streaming: bool, device: str = "cuda") -> str:
    """SMOKE_CONF filled in: ``torch_allocate`` on ``device``, the size
    floor off (so every cycle and micro-cycle of these small worlds
    solves on its rung), and the ``streaming:`` key."""
    return SMOKE_CONF.format(streaming=str(bool(streaming)).lower(), device=device)


def _check_device(device: str) -> None:
    """No card for a ``cuda`` device raises here, before any thread
    starts: the smokes never run on the CPU for want of a card."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is visible; pass device='cpu' "
            "(--device cpu) to run torch_allocate's plain versions"
        )


def _loop_device(device: str):
    """The device a scheduling thread makes current (``Scheduler.run``'s
    ``device``): a card with its index, so a conf's bare ``cuda`` names it;
    None on the CPU."""
    import torch

    d = torch.device(device)
    if d.type != "cuda":
        return None
    return torch.device("cuda", 0 if d.index is None else d.index)


def smoke(gangs: int = 4, members: int = 4, nodes: int = 6, device: str = "cuda") -> dict:
    """End-to-end proof on the in-process store, runnable standalone
    (``python -m kube_batch_tpu_torch.streaming``), ``torch_allocate``
    solving on ``device``:

    1. streaming run: seed nodes/queue, start a Scheduler whose conf
       says ``streaming: true`` with a long (5s) full-cycle period, feed
       gangs one at a time and wait for each to bind — with the period
       that long, everything after the initial full cycle binds through
       micro-cycles;
    2. full-cycle replay: identical arrivals against ``streaming:
       false`` with a short period;
    3. assert bind-for-bind placement parity and that the streaming run
       actually took the micro path.
    """
    import tempfile
    import threading as _threading

    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import (
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    _check_device(device)
    loop_device = _loop_device(device)

    def bound(store, gang: str) -> bool:
        pods = [p for p in store.list(PODS) if p.name.startswith(f"{gang}-")]
        return len(pods) == members and all(p.node_name for p in pods)

    def run_mode(streaming: bool) -> tuple[dict, dict]:
        store = ClusterStore()
        store.create_queue(build_queue("default"))
        for i in range(nodes):
            store.create_node(
                build_node(f"n{i}", build_resource_list(cpu=16, memory="16Gi", pods=64))
            )
        cache = SchedulerCache(store)
        with tempfile.NamedTemporaryFile(
            "w", suffix=".yaml", delete=False
        ) as fh:
            fh.write(smoke_conf(streaming, device))
            conf_path = fh.name
        period = 5.0 if streaming else 0.05
        sched = Scheduler(cache, scheduler_conf=conf_path, schedule_period=period)
        stop = _threading.Event()
        t = _threading.Thread(target=sched.run, args=(stop, loop_device), daemon=True)
        t.start()
        latencies: list[float] = []
        try:
            for g in range(gangs):
                name = f"sg{g}"
                store.create_pod_group(build_pod_group(name, min_member=members))
                for m in range(members):
                    store.create_pod(
                        build_pod(
                            name=f"{name}-p{m}", group_name=name,
                            req=build_resource_list(cpu=1, memory="512Mi"),
                        )
                    )
                t0 = time.perf_counter()
                deadline = time.monotonic() + 30.0
                while not bound(store, name):
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            f"gang {name} not bound within 30s "
                            f"(streaming={streaming})"
                        )
                    time.sleep(0.001)
                latencies.append(time.perf_counter() - t0)
        finally:
            stop.set()
            t.join(timeout=10.0)
            cache.stop()
            os.unlink(conf_path)
        placed = {f"{p.namespace}/{p.name}": p.node_name for p in store.list(PODS)}
        stats = {
            "latencies_ms": [round(x * 1e3, 3) for x in latencies],
            "micro_cycles": getattr(sched, "micro_cycles_run", 0),
        }
        return placed, stats

    stream_placed, stream_stats = run_mode(True)
    full_placed, full_stats = run_mode(False)
    lat = sorted(stream_stats["latencies_ms"])
    out = {
        "gangs": gangs,
        "pods": gangs * members,
        "bound": sum(1 for v in stream_placed.values() if v),
        "micro_cycles": stream_stats["micro_cycles"],
        "p50_bind_ms": lat[len(lat) // 2] if lat else None,
        "max_bind_ms": lat[-1] if lat else None,
        "parity": stream_placed == full_placed,
        "full_cycle_micro_cycles": full_stats["micro_cycles"],
    }
    out["ok"] = bool(
        out["parity"]
        and out["bound"] == out["pods"]
        and out["micro_cycles"] > 0
        and out["full_cycle_micro_cycles"] == 0
    )
    return out


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="streaming-mode smoke: micro-cycle binds + parity vs full cycles"
    )
    parser.add_argument("--gangs", type=int, default=4)
    parser.add_argument("--members", type=int, default=4)
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where torch_allocate solves (default: the card)",
    )
    parser.add_argument("--json", action="store_true", help="print the result dict as JSON")
    args = parser.parse_args(argv)
    result = smoke(gangs=args.gangs, members=args.members, device=args.device)
    if args.json:
        print(json.dumps(result, sort_keys=True))
    else:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"streaming smoke: {status} ({result['bound']}/{result['pods']} pods "
            f"bound, {result['micro_cycles']} micro-cycles, "
            f"p50 bind {result['p50_bind_ms']}ms, parity={result['parity']})"
        )
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` executes this
    # file as __main__, whose module-level state would otherwise be
    # distinct from the one scheduler.py imports
    from kube_batch_tpu_torch.streaming import main as _canonical_main

    raise SystemExit(_canonical_main())
