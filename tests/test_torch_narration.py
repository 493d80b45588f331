"""The port's glog narration against the JAX package's, site for site.

The JAX package narrates through ``log.V(3)`` and ``log.V(4).infof`` at
37 sites outside its log module: the cache's pod, PodGroup, job-GC and
snapshot paths (cache/cache.py), the store's writes (cache/store.py), the
scheduling cycle (scheduler.py), serial allocate and preempt, the scan
backfill's serial routes (actions/xla_backfill.py, the port's
actions/torch_backfill.py), the federation backend's pump
(cache/backend.py), the journal's compaction, the resilient watcher's
reconnects and the HTTP server's request lines. Each scenario below drives
the same operations through both packages at verbosity 0, 3 and 4
(``set_verbosity``, what ``KB_TPU_V`` sets at import) and collects what
each package's logger emitted from those files at INFO. At 3 and 4 the
port's messages equal the JAX package's (so each site runs at the JAX
line's level and text, with the same arguments); at 0 none of them is
emitted; and the JAX records, by file and line, cover all 37 sites.
"""

from __future__ import annotations

import collections
import functools
import importlib
import logging
import os
import random
import re
import tempfile
import time
from types import SimpleNamespace

import pytest

# the JAX sites, by file and line
JAX_SITES = {
    "cache.py": {171, 177, 678, 777, 794, 805, 815, 873, 1472, 1484, 1507, 1510, 1521},
    "store.py": {281, 296, 309, 390, 428, 464},
    "scheduler.py": {293, 409, 510, 544},
    "allocate.py": {101, 113, 133},
    "xla_backfill.py": {47, 90, 170},
    "backend.py": {473, 568, 606},
    "preempt.py": {85, 98},
    "journal.py": {217},
    "watch_client.py": {186},
    "server.py": {625},
}
PORT_FILES = {"torch_backfill.py": "xla_backfill.py"}  # the port's file of a JAX site file, where the names differ
assert sum(len(v) for v in JAX_SITES.values()) == 37

_MODULES = {
    "log": "log", "t": "testing", "types": "apis.types", "api": "api", "store": "cache.store", "cache": "cache",
    "cache_mod": "cache.cache", "sched": "scheduler", "server": "server", "streaming": "streaming",
    "pipeline": "pipeline", "faults": "faults", "journal": "recovery.journal", "recovery": "recovery",
}


def _pkg(root: str) -> SimpleNamespace:
    importlib.import_module(f"{root}.actions")
    importlib.import_module(f"{root}.plugins")
    return SimpleNamespace(root=root, jax=root == "kube_batch_tpu",
                           **{k: importlib.import_module(f"{root}.{m}") for k, m in _MODULES.items()})


JAX = _pkg("kube_batch_tpu")
PORT = _pkg("kube_batch_tpu_torch")
_AUTO_UID = re.compile(r"-\d{8}\b")


class _Collect(logging.Handler):
    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def _site_file(P, record) -> str:
    name = os.path.basename(record.pathname)
    return name if P.jax else PORT_FILES.get(name, name)


# -- the scenarios: each drives one package P, in a scratch directory ------------


TIERS = """
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


def cache_events(P, tmp: str) -> None:
    """Pod add, update, delete and evict, a PodGroup add, the job GC, a pod
    of another scheduler, and snapshots skipping a job without a
    scheduling spec or with a missing queue (tests/test_torch_cache.py's
    cases, on a store-backed cache)."""
    import test_torch_cache as tc
    from test_torch_store import JAX as STORE_JAX, PORT as STORE_PORT

    for case in (tc.evict_releases_then_deletes, tc.terminated_job_gc, tc.other_scheduler_running_pod_occupies_node,
                 tc.snapshot_skips_job_with_missing_queue, tc.group_annotation_requires_podgroup_to_snapshot,
                 tc.pod_update_resize_reaccounts):
        tc.run_case(case, STORE_JAX if P.jax else STORE_PORT)


def store_writes(P, tmp: str) -> None:
    """The store's conditional bind, unbind and evict (the evictor's
    versioned evict), and a task resynced after its pod left the store."""
    t, running = P.t, P.types.PodPhase.RUNNING
    store = P.store.ClusterStore()
    cache = P.cache.SchedulerCache(store)
    try:
        store.create_node(t.build_node("n1", t.build_resource_list(cpu=8)))
        store.create_pod(t.build_pod(name="p1", req=t.build_resource_list(cpu=1)))
        store.create_pod(t.build_pod(name="p2", node_name="n1", phase=running, req=t.build_resource_list(cpu=1)))
        store.conditional_bind_many([("default", "p1", "n1")], store.version)
        store.conditional_unbind("default", "p1", store.version)
        P.cache_mod.StoreEvictor(store).evict_versioned(store.get_pod("default", "p2"), store.version)
        store.create_pod(t.build_pod(name="p3", req=t.build_resource_list(cpu=1)))
        task = next(task for j in cache.jobs.values() for task in j.tasks.values() if task.name == "p3")
        real, cache.store = cache.store, P.store.ClusterStore()  # the pod is gone when the task resyncs
        try:
            cache._sync_task(task)
        finally:
            cache.store = real
    finally:
        cache.stop()


def _conf(tmp: str, actions: str, args: str = "") -> str:
    path = os.path.join(tmp, "conf.yaml")
    with open(path, "w") as f:
        f.write(f'actions: "{actions}"\n{args}{TIERS}')
    return path


def allocate_worlds(P):
    """One-task gangs, a world each: one binds on idle capacity, one
    pipelines onto the capacity a terminating resident releases, one fits
    no node."""
    t, rl = P.t, P.t.build_resource_list
    leaving = t.build_pod(name="leaving", node_name="n0", phase=P.types.PodPhase.RUNNING, req=rl(cpu=2))
    leaving.metadata.deletion_timestamp = 1.0
    for resident, cpu in (([], 1), ([leaving], 2), ([], 64)):
        pods = resident + [t.build_pod(name="g-0", group_name="g", req=rl(cpu=cpu))]
        yield t.build_cluster(pods, [t.build_node("n0", rl(cpu=2, pods=10))], [t.build_pod_group("g", min_member=1)],
                              [t.build_queue("default")])


def serial_cycle(P, tmp: str) -> None:
    """Scheduling cycles of serial allocate: a task binds, one pipelines
    onto releasing capacity, one finds no node."""
    for world in allocate_worlds(P):
        P.sched.Scheduler(P.t.FakeCache(world), _conf(tmp, "allocate")).run_once()


def pipelined_cycle(P, tmp: str) -> None:
    """A cycle under ``KBT_PIPELINE=1``: the device allocate defers its
    dispatch, and the cycle's tail ends it on the write pool."""
    os.environ["KBT_PIPELINE"] = "1"
    P.pipeline.reset()
    try:
        if P.jax:
            conf = _conf(tmp, "enqueue, xla_allocate")
        else:
            conf = _conf(tmp, "enqueue, torch_allocate",
                         "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n")
        sched = P.sched.Scheduler(P.t.FakeCache(P.models.synthetic(40, 8, seed=2)), conf)
        sched.run_once()
        assert P.pipeline.fence.wait()
    finally:
        os.environ.pop("KBT_PIPELINE", None)
        P.pipeline.reset()


def micro_cycle_before_a_full_cycle(P, tmp: str) -> None:
    """A streaming micro-cycle before any full cycle was adopted: the
    resident table is invalid and the cycle is skipped."""
    sched = P.sched.Scheduler(P.t.FakeCache(P.models.synthetic(20, 4, seed=1)), _conf(tmp, "allocate"))
    sched._stream_state = P.streaming.StreamState()
    sched._stream_trigger = P.streaming.StreamTrigger()
    assert sched.run_micro(None) is False


def backfill_routes(P, tmp: str) -> None:
    """The scan backfill placing BestEffort tasks, and its two routes to
    the serial action: more than 63 host ports, a conf outside the scan's
    envelope (tests/test_torch_backfill.py's scenes)."""
    import test_torch_backfill as tb

    ns = tb.JAX if P.jax else tb.TORCH
    action = "xla_backfill" if P.jax else "torch_backfill"
    tb.run(ns, action, tb.first_node(ns))
    tb.run(ns, action, tb.many_ports(ns))
    tb.run(ns, action, tb.first_node(ns), tb.NO_PREDICATES)


def serial_preempt(P, tmp: str) -> None:
    """Serial preempt evicting a low-priority resident for a preemptor
    (tests/test_torch_preempt.py's simple preemption)."""
    import test_torch_preempt as tp

    if P.jax:
        tp.jax_run(["preempt"], tp.simple_preemption(tp.JAX))
    else:
        tp.torch_run(["preempt"], tp.simple_preemption(tp.TORCH))


def journal_compaction(P, tmp: str) -> None:
    """The journal compacting at its threshold and by hand
    (tests/test_torch_recovery.py's scenes)."""
    import test_torch_recovery as tr

    ns = SimpleNamespace(journal=P.journal)
    tr.write_journal(ns, os.path.join(tmp, "threshold.wal"), tr.compaction_at_threshold)
    tr.write_journal(ns, os.path.join(tmp, "explicit.wal"), tr.explicit_compaction)


def backend_pumps(P, tmp: str) -> None:
    """A federation backend pumping from a store server over HTTP (the
    server's request lines), once with the pump fault armed, and once
    partitioned over each wire protocol."""
    servers = [P.server.SchedulerServer(scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
                                        schedule_period=60.0, wire_protocol=w) for w in (2, 1)]
    try:
        for srv in servers:
            srv.start()
            backend = P.cache.LoopbackBackend(f"http://127.0.0.1:{srv.listen_port}")
            backend.add_event_handler("pods", P.store.EventHandler())  # lists, then pumps watch the kind
            backend.pump()
            if srv.wire_protocol == 2:
                P.faults.registry.arm("stream.pump", count=1)
                assert backend.pump() == 0
            P.faults.registry.arm("federation.partition", count=1)
            assert backend.pump() == 0
    finally:
        P.faults.registry.reset()
        for srv in servers:
            srv.stop()


def watch_reconnects(P, tmp: str) -> None:
    """A resilient watcher with nothing listening: it backs off and
    reconnects (a seeded jitter, so the first delay is the same)."""
    w = P.recovery.ResilientWatcher("http://127.0.0.1:1", ("queues",), poll_timeout=0.1, min_backoff=0.01,
                                    max_backoff=0.05, rng=random.Random(0))
    w.start()
    try:
        time.sleep(0.15)
    finally:
        w.stop()


SCENARIOS = {f.__name__: f for f in (cache_events, store_writes, serial_cycle, pipelined_cycle,
                                     micro_cycle_before_a_full_cycle, backfill_routes, serial_preempt,
                                     journal_compaction, backend_pumps, watch_reconnects)}
# sites whose count follows the clock (retries, request lines of a loop): compared as distinct messages
BY_TEXT = {"backend_pumps", "watch_reconnects"}
_PORT_PATHS = ("cache/cache.py", "cache/store.py", "scheduler.py", "actions/allocate.py", "actions/torch_backfill.py",
               "cache/backend.py", "actions/preempt.py", "recovery/journal.py", "recovery/watch_client.py", "server.py")


@functools.lru_cache(maxsize=None)
def port_sites() -> dict:
    """The port's V(n) sites by (site) file: the lines that call
    ``pkg_log.V(``."""
    root = os.path.dirname(PORT.log.__file__)
    out = {}
    for rel in _PORT_PATHS:
        with open(os.path.join(root, rel)) as f:
            lines = {i for i, line in enumerate(f, 1) if "pkg_log.V(" in line}
        out[PORT_FILES.get(os.path.basename(rel), os.path.basename(rel))] = lines
    return out


def _sites(P) -> dict:
    return JAX_SITES if P.jax else port_sites()


@functools.lru_cache(maxsize=None)
def narrate(scenario: str, root: str, v: int) -> tuple:
    """The scenario on one package at verbosity ``v``: the records its V(n)
    sites emitted, as (site file, line, message), the scratch directory,
    listen ports and auto uids written as placeholders."""
    P = JAX if root == JAX.root else PORT
    P.models = importlib.import_module(f"{root}.models")
    logger = logging.getLogger(root)
    handler = _Collect()
    saved = P.log.get_verbosity(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    P.log.set_verbosity(v)
    sites = _sites(P)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            SCENARIOS[scenario](P, tmp)
            out = []
            for r in handler.records:
                f = _site_file(P, r)
                if r.lineno in sites.get(f, ()):
                    msg = _PORT.sub("127.0.0.1:<port>", r.getMessage().replace(tmp, "<tmp>"))
                    out.append((f, r.lineno, r.levelname, _AUTO_UID.sub("-<uid>", msg)))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(saved[1])
        P.log.set_verbosity(saved[0])
    return tuple(out)


_PORT = re.compile(r"127\.0\.0\.1:\d+")


def _messages(scenario: str, records) -> list:
    msgs = [(f, level, m) for f, _, level, m in records]
    if scenario in BY_TEXT:
        # one of each line: how many request lines and reconnects a run
        # makes depends on the clock
        return sorted(set(msgs))
    return sorted(msgs)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_the_port_narrates_as_the_jax_package(scenario):
    """At verbosity 4 and at 3 the port's V(n) sites emit the JAX package's
    messages, at the same severity; at 0 neither package's V(n) sites emit
    anything."""
    for v in (4, 3):
        jax, port = narrate(scenario, JAX.root, v), narrate(scenario, PORT.root, v)
        assert jax or v < 4, f"{scenario}: the JAX package narrated nothing at verbosity {v}"
        assert _messages(scenario, port) == _messages(scenario, jax), f"{scenario} at verbosity {v}"
    for root in (JAX.root, PORT.root):
        assert narrate(scenario, root, 0) == (), f"{scenario}: {root} narrated at verbosity 0"


@pytest.mark.parametrize("root", [JAX.root, PORT.root])
def test_the_scenarios_reach_all_37_sites(root):
    """Each package's records at verbosity 4, by file and line, cover
    every one of its 37 V(n) sites; the V(4) sites are silent at
    verbosity 3."""
    P = JAX if root == JAX.root else PORT
    sites = _sites(P)
    assert sum(len(v) for v in sites.values()) == 37
    reached = collections.defaultdict(set)
    at3 = collections.defaultdict(set)
    for scenario in SCENARIOS:
        for f, line, _, _ in narrate(scenario, root, 4):
            reached[f].add(line)
        for f, line, _, _ in narrate(scenario, root, 3):
            at3[f].add(line)
    missing = {f: sorted(lines - reached[f]) for f, lines in sites.items() if lines - reached[f]}
    assert not missing, f"sites no scenario reached: {missing}"
    if not P.jax:
        return
    v4 = {("cache.py", 678), ("cache.py", 873), ("cache.py", 1507), ("scheduler.py", 293), ("scheduler.py", 409),
          ("scheduler.py", 510), ("scheduler.py", 544), ("server.py", 625)} | {("store.py", n) for n in JAX_SITES["store.py"]}
    assert not {(f, n) for f, lines in at3.items() for n in lines} & v4
