"""The port's crash-consistent failover (`kube_batch_tpu_torch.recovery`:
the write-intent journal, `fsck`, takeover reconciliation and the watch
client, and the cache's journal hooks) against the JAX package's
(`kube_batch_tpu.recovery`), on the scenes of tests/test_recovery.py.

The same appends and confirms give byte-identical journal files, and
each package replays, checks and reconciles the other's file. On the
same store and journal, `reconcile_journal` gives the same
`ReconcileReport`, the same store and the same journal afterwards. A
leader killed mid-`bind_many` (a `BaseException` in its binder, standing
in for SIGKILL in the write pool) leaves the same in-flight suffix in
both packages, and the standby's reconciliation ends at the
uninterrupted run's placements. The tolerance is exact equality
everywhere: nothing here is floating point.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from test_torch_store import JAX, PORT, wait_until

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _P in (JAX, PORT):
    _P.recovery = importlib.import_module(f"{_P.name}.recovery")
    _P.journal = importlib.import_module(f"{_P.name}.recovery.journal")
    _P.fsck = importlib.import_module(f"{_P.name}.recovery.fsck")
    _P.reconcile = importlib.import_module(f"{_P.name}.recovery.reconcile")

BOTH = (JAX, PORT)

# the JAX scheduler's cycle (tests/test_recovery.py) and the port's twin:
# the same plugins, the port's torch_allocate on the kernel's plain version
TIERS = """tiers:
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
CONFS = {
    JAX.name: 'actions: "enqueue, xla_allocate"\n' + TIERS,
    PORT.name: 'actions: "enqueue, torch_allocate"\n' + TIERS
    + "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n",
}


@pytest.fixture(autouse=True)
def _clean_faults():
    for P in BOTH:
        P.faults.registry.reset()
    yield
    for P in BOTH:
        P.faults.registry.reset()


def conf_path(P, tmp_path) -> str:
    path = tmp_path / f"conf-{P.name}.yaml"
    path.write_text(CONFS[P.name])
    return str(path)


def seed_store(P, store, gangs: int = 2, members: int = 6) -> None:
    """gangs x members pending gang pods on 4 nodes."""
    t = P.t
    store.create_queue(t.build_queue("default"))
    for i in range(4):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=32)))
    for g in range(gangs):
        store.create_pod_group(t.build_pod_group(f"g{g}", min_member=members))
        for m in range(members):
            store.create_pod(t.build_pod(name=f"g{g}-p{m}", group_name=f"g{g}",
                                         req=t.build_resource_list(cpu=1, memory="512Mi")))


def make_scheduler(P, store, tmp_path, journal=None, binder=None):
    cache = P.cache.SchedulerCache(store, journal=journal, binder=binder)
    return cache, P.sched.Scheduler(cache, scheduler_conf=conf_path(P, tmp_path), schedule_period=0.05)


def placements(store) -> dict:
    return {f"{p.namespace}/{p.name}": p.node_name for p in store.list("pods")}


def land(store, key: str, node: str) -> None:
    """The dead leader's write pool completed this write."""
    ns, _, name = key.partition("/")
    store.update_pod(dataclasses.replace(store.get_pod(ns, name), node_name=node))


def replay_view(result) -> dict:
    return {
        "intents": {s: dataclasses.asdict(i) for s, i in result.intents.items()},
        "confirmed": sorted(result.confirmed),
        "corrupt": result.corrupt,
        "orphans": [dataclasses.asdict(i) for i in result.orphans],
    }


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- the journal: byte-identical files, each package replays the other's -----


def appends_and_confirms(j) -> None:
    seqs = j.append_intents("bind", [("g", "default/a", "n0"), ("g", "default/b", "n1")], cycle=7,
                            trace="0123456789abcdef")
    j.append_intents("evict", [("h", "default/c", "")], cycle=7)
    j.confirm(seqs[0])
    j.confirm(seqs[0])  # idempotent
    j.confirm(999)  # unknown: a no-op


def torn_tail_then_reopen(j) -> None:
    seqs = j.append_intents("bind", [("g", "default/a", "n0"), ("g", "default/b", "n0")])
    j.confirm(seqs[0])
    j.close()
    with open(j.path, "a") as fh:
        fh.write('{"rec":"intent","seq":99,"cyc')  # crash mid-append


def compaction_at_threshold(j) -> None:
    j.COMPACT_THRESHOLD = 4  # the class's 4096, cut for the test
    seqs = j.append_intents("bind", [("g", f"default/p{i}", f"n{i % 3}") for i in range(7)], cycle=3)
    for s in seqs[:5]:  # the fourth confirm compacts
        j.confirm(s)
    j.append_intents("evict", [("g", "default/p0", "")], cycle=4)


def explicit_compaction(j) -> None:
    seqs = j.append_intents("bind", [("g1", "default/x", "n0"), ("g2", "default/y", "n1")], cycle=1)
    j.confirm(seqs[1])
    j.compact()
    j.append_intents("bind", [("g3", "default/z", "n2")], cycle=2)


JOURNAL_SCENES = [appends_and_confirms, torn_tail_then_reopen, compaction_at_threshold, explicit_compaction]


def write_journal(P, path: str, scene) -> dict:
    j = P.journal.WriteIntentJournal(path)
    scene(j)
    j.close()
    if scene is torn_tail_then_reopen:
        # reopening resumes seq numbering past everything seen, and
        # compaction drops the confirmed history and the torn tail
        j2 = P.journal.WriteIntentJournal(path)
        before = read(path)
        j2.compact()
        new = j2.append_intents("bind", [("g", "default/c", "n1")])
        j2.close()
        return {"before_compact": before, "new_seq": new, "outstanding": [i.seq for i in j2.outstanding()]}
    return {"outstanding": [dataclasses.asdict(i) for i in j.outstanding()]}


@pytest.mark.parametrize("scene", JOURNAL_SCENES, ids=lambda s: s.__name__)
def test_the_same_appends_and_confirms_give_byte_identical_journals(tmp_path, scene):
    out = {}
    for P in BOTH:
        path = str(tmp_path / f"{P.name}.wal")
        out[P.name] = (write_journal(P, path, scene), read(path))
    assert out[PORT.name] == out[JAX.name]
    assert out[PORT.name][1]  # the file holds records


@pytest.mark.parametrize("scene", JOURNAL_SCENES, ids=lambda s: s.__name__)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_replays_the_others_journal(tmp_path, scene, writer):
    W = JAX if writer == "jax" else PORT
    path = str(tmp_path / "j.wal")
    if scene is torn_tail_then_reopen:
        j = W.journal.WriteIntentJournal(path)
        scene(j)  # leave the torn tail in place
    else:
        write_journal(W, path, scene)
    views = {P.name: replay_view(P.journal.WriteIntentJournal.replay(path)) for P in BOTH}
    assert views[PORT.name] == views[JAX.name]
    # a reader of the other package resumes its numbering past the file
    for P in BOTH:
        reopened = P.journal.WriteIntentJournal(path)
        seqs = [i.seq for i in reopened.outstanding()]
        assert seqs == [o["seq"] for o in views[P.name]["orphans"]]
        reopened.close()


def test_journal_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("KBT_JOURNAL", raising=False)
    assert PORT.journal.journal_from_env() is None
    monkeypatch.setenv("KBT_JOURNAL", str(tmp_path / "env.wal"))
    j = PORT.journal.journal_from_env()
    assert j.path == str(tmp_path / "env.wal") and not j.fsync
    j.close()


def test_fsync_journal_writes_the_same_bytes(tmp_path):
    paths = []
    for fsync in (False, True):
        path = str(tmp_path / f"f{fsync}.wal")
        j = PORT.journal.WriteIntentJournal(path, fsync=fsync)
        appends_and_confirms(j)
        j.close()
        paths.append(read(path))
    assert paths[0] == paths[1]


def test_the_journal_meters_intents_and_confirms(tmp_path):
    m = PORT.metrics.journal_records
    before = (m.value({"state": "intent"}), m.value({"state": "confirm"}))
    j = PORT.journal.WriteIntentJournal(str(tmp_path / "m.wal"))
    appends_and_confirms(j)
    j.close()
    assert (m.value({"state": "intent"}) - before[0], m.value({"state": "confirm"}) - before[1]) == (3, 1)


# -- fsck: same output and exit codes ----------------------------------------


def fsck_file(tmp_path, kind: str) -> str:
    path = str(tmp_path / f"{kind}.wal")
    if kind == "missing":
        return path
    if kind == "garbage":
        with open(path, "w") as f:
            f.write("not json\n{\"rec\":\"other\",\"seq\":1}\n")
        return path
    j = PORT.journal.WriteIntentJournal(path)
    seqs = j.append_intents("bind", [("default/g0", "default/p0", "n0"), ("default/g0", "default/p1", "n1")])
    j.append_intents("evict", [("", "default/v0", "")], cycle=2)
    if kind == "clean":
        for s in seqs + [seqs[-1] + 1]:
            j.confirm(s)
    else:
        j.confirm(seqs[0])
    j.close()
    if kind == "torn":
        with open(path, "a") as f:
            f.write('{"rec":"confirm","se')
    return path


def run_fsck(P, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = P.fsck.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("kind", ["clean", "orphans", "torn", "garbage", "missing"])
@pytest.mark.parametrize("flags", [[], ["--strict"], ["--json"], ["--strict", "--json"]], ids=" ".join)
def test_fsck_output_and_exit_codes_equal_the_jax_cli(tmp_path, kind, flags):
    path = fsck_file(tmp_path, kind)
    port, jax = run_fsck(PORT, flags + [path]), run_fsck(JAX, flags + [path])
    assert port == jax
    assert PORT.fsck.fsck(path) == JAX.fsck.fsck(path)
    orphans = kind in ("orphans", "torn")
    assert port[0] == (1 if orphans and "--strict" in flags else 0)


def test_fsck_replay_fault_is_unreadable_in_both(tmp_path):
    path = fsck_file(tmp_path, "orphans")
    out = []
    for P in BOTH:
        P.faults.registry.arm("journal.replay", count=1)
        out.append(run_fsck(P, [path]))
    assert out[0] == out[1] and out[0][0] == 1 and "unreadable" in out[0][2]


def test_fsck_runs_as_a_module(tmp_path):
    path = fsck_file(tmp_path, "orphans")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    res = {}
    for mod in ("kube_batch_tpu_torch.recovery.fsck", "kube_batch_tpu.recovery.fsck"):
        proc = subprocess.run([sys.executable, "-m", mod, "--strict", path], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        res[mod] = (proc.returncode, proc.stdout)
    assert res["kube_batch_tpu_torch.recovery.fsck"] == res["kube_batch_tpu.recovery.fsck"]
    assert res["kube_batch_tpu_torch.recovery.fsck"][0] == 1
    assert "2 orphaned" in res["kube_batch_tpu_torch.recovery.fsck"][1]


# -- reconciliation: same report, same store, same journal ------------------


def landed_and_orphaned(P, store, j):
    j.append_intents("bind", [
        ("default/g0", "default/g0-p0", "n0"),  # will land
        ("default/g0", "default/g0-p1", "n1"),  # orphaned
        ("default/g0", "default/g0-p2", "n2"),  # orphaned
    ], cycle=1)
    land(store, "default/g0-p0", "n0")


def half_bound_gang_rolls_back(P, store, j):
    j.append_intents("bind", [
        ("default/g0", "default/g0-p0", "n0"),  # landed before the crash
        ("default/g0", "default/g0-p1", "n1"),  # orphaned, fixable
        ("default/g0", "default/g0-p2", "n2"),  # orphaned, pod deleted
    ], cycle=1)
    land(store, "default/g0-p0", "n0")
    store.delete_pod("default", "g0-p2")


def node_vanished_rolls_back(P, store, j):
    """The target node of one member is deleted while the leader is down
    (chip_smoke.py's drill (f) at full size)."""
    j.append_intents("bind", [
        ("default/g0", "default/g0-p0", "n0"),
        ("default/g0", "default/g0-p1", "n3"),
        ("default/g0", "default/g0-p2", "n1"),
    ], cycle=4)
    land(store, "default/g0-p0", "n0")
    store.delete_node("n3")


def conflict_respects_store_truth(P, store, j):
    j.append_intents("bind", [
        ("default/g0", "default/g0-p0", "n0"),
        ("default/g0", "default/g0-p1", "n1"),
    ])
    land(store, "default/g0-p0", "n3")  # rival bound it


def evicts_landed_and_orphaned(P, store, j):
    t = P.t
    for i in range(2):
        store.create_pod(t.build_pod(name=f"v{i}", node_name="n0", phase=P.types.PodPhase.RUNNING,
                                     req=t.build_resource_list(cpu=1)))
    j.append_intents("evict", [("default/v", "default/v0", ""), ("default/v", "default/v1", "")], cycle=2)
    store.delete_pod("default", "v0")  # landed


def two_gangs_one_rolls_back(P, store, j):
    j.append_intents("bind", [("default/g0", f"default/g0-p{m}", f"n{m % 4}") for m in range(3)]
                     + [("default/g1", f"default/g1-p{m}", f"n{m % 4}") for m in range(3)], cycle=5)
    land(store, "default/g1-p0", "n0")
    store.delete_pod("default", "g0-p1")


def replay_fault_aborts(P, store, j):
    j.append_intents("bind", [("default/g0", "default/g0-p0", "n0")])
    return "journal.replay"


def scan_fault_aborts(P, store, j):
    j.append_intents("bind", [("default/g0", f"default/g0-p{m}", f"n{m % 4}") for m in range(3)])
    return "reconcile.scan"


RECONCILE_SCENES = [landed_and_orphaned, half_bound_gang_rolls_back, node_vanished_rolls_back,
                    conflict_respects_store_truth, evicts_landed_and_orphaned, two_gangs_one_rolls_back,
                    replay_fault_aborts, scan_fault_aborts]


def reconcile_scene(P, tmp_path, scene, writer=None, tag: str = "") -> dict:
    """The scene's store and journal in package P (the journal written by
    ``writer``'s package, P's by default), reconciled twice: the second
    pass, with the scene's fault point (armed once, if it names one)
    cleared, finishes what an aborted first left."""
    store = P.store.ClusterStore()
    seed_store(P, store, gangs=2, members=3)
    W = writer or P
    path = str(tmp_path / f"{tag}{P.name}-{W.name}.wal")
    j = W.journal.WriteIntentJournal(path)
    point = scene(P, store, j)
    j.close()
    j = P.journal.WriteIntentJournal(path)  # the standby's handle
    if point is not None:
        P.faults.registry.arm(point, count=1)
    det = P.detector.MutationDetector(store)
    det.snapshot()
    ops_before = dict(P.metrics.reconcile_ops.samples())
    first = P.reconcile.reconcile_journal(j, store)
    after_first = placements(store)
    P.faults.registry.reset()
    second = P.reconcile.reconcile_journal(j, store)
    ops = {dict(k)["op"]: v - ops_before.get(k, 0) for k, v in P.metrics.reconcile_ops.samples().items()
           if v != ops_before.get(k, 0)}
    out = {
        "first": first.as_dict(), "after_first": after_first, "second": second.as_dict(),
        "placements": placements(store), "outstanding": [dataclasses.asdict(i) for i in j.outstanding()],
        "journal": read(path), "violations": det.violations(), "ops": ops,
    }
    j.close()
    return out


@pytest.mark.parametrize("scene", RECONCILE_SCENES, ids=lambda s: s.__name__)
def test_reconcile_equals_the_jax_reconcile(tmp_path, scene):
    jax, port = reconcile_scene(JAX, tmp_path, scene), reconcile_scene(PORT, tmp_path, scene)
    assert port == jax
    assert port["violations"] == [] and port["outstanding"] == []


@pytest.mark.parametrize("scene", [landed_and_orphaned, half_bound_gang_rolls_back, evicts_landed_and_orphaned])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_standby_reconciles_the_other_packages_journal(tmp_path, scene, writer):
    W = JAX if writer == "jax" else PORT
    own = reconcile_scene(PORT, tmp_path, scene, tag="own-")
    cross = {P.name: reconcile_scene(P, tmp_path, scene, writer=W) for P in BOTH}
    assert cross[PORT.name] == cross[JAX.name] == own


def test_reconcile_scene_expectations(tmp_path):
    """What tests/test_recovery.py asserts of each scene, on the port."""
    for sub in "abc":
        (tmp_path / sub).mkdir()
    r = reconcile_scene(PORT, tmp_path / "a", landed_and_orphaned)
    assert (r["first"]["confirmed"], r["first"]["redispatched"], r["first"]["rolled_back"]) == (1, 2, 0)
    assert {k: v for k, v in r["placements"].items() if k.startswith("default/g0")} == {
        "default/g0-p0": "n0", "default/g0-p1": "n1", "default/g0-p2": "n2"}
    r = reconcile_scene(PORT, tmp_path / "b", half_bound_gang_rolls_back)
    assert r["first"]["gangs_rolled_back"] == ["default/g0"] and r["first"]["rolled_back"] >= 1
    assert {k: v for k, v in r["placements"].items() if k.startswith("default/g0")} == {
        "default/g0-p0": "", "default/g0-p1": ""}
    r = reconcile_scene(PORT, tmp_path / "c", conflict_respects_store_truth)
    assert (r["first"]["conflicts"], r["first"]["redispatched"]) == (1, 1)
    assert r["placements"]["default/g0-p0"] == "n3"
    for scene in (replay_fault_aborts, scan_fault_aborts):
        r = reconcile_scene(PORT, tmp_path, scene, tag=scene.__name__)
        assert r["first"]["aborted"] and not any(r["after_first"].values())
        assert not r["second"]["aborted"] and r["second"]["redispatched"] >= 1


# -- the cache's journal hooks ------------------------------------------------


def _gang_cache(P, path):
    t = P.t
    store = P.store.ClusterStore()
    store.create_queue(t.build_queue("default"))
    for i in range(3):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    store.create_pod_group(t.build_pod_group("pg", min_member=3))
    for i in range(4):
        store.create_pod(t.build_pod(name=f"p{i}", group_name="pg", req=t.build_resource_list(cpu=1, memory="1Gi")))
    store.create_pod(t.build_pod(name="r0", node_name="n2", phase=P.types.PodPhase.RUNNING,
                                 req=t.build_resource_list(cpu=1)))
    journal = P.journal.WriteIntentJournal(path)
    return store, journal, P.cache.SchedulerCache(store, journal=journal)


def hooks_bind_many_bind_evict(P, tmp_path, pooled: bool) -> dict:
    """bind_many (one append for the statement), bind and evict, with the
    write pool off (inline writes) or running; every write acks, so every
    intent is confirmed."""
    path = str(tmp_path / f"hooks-{P.name}-{pooled}.wal")
    store, journal, cache = _gang_cache(P, path)
    if pooled:
        cache.run()
    try:
        cache.cycle = 3
        tasks = sorted(cache.jobs["default/pg"].tasks.values(), key=lambda t: t.name)
        cache.bind_many([(t, f"n{i % 2}") for i, t in enumerate(tasks[:3])])
        cache.cycle = 4
        cache.bind(tasks[3], "n1")
        resident = next(t for j in cache.jobs.values() for t in j.tasks.values() if t.name == "r0")
        cache.evict(resident, "preempted")
        wait_until(lambda: not journal.outstanding() and store.get_pod("default", "r0") is None, what="acks")
    finally:
        cache.stop()
    journal.close()
    text = read(path)
    return {"journal": text if not pooled else sorted(text.splitlines()), "placements": placements(store)}


@pytest.mark.parametrize("pooled", [False, True], ids=["inline", "pool"])
def test_the_caches_journal_equals_the_jax_caches(tmp_path, pooled):
    port, jax = hooks_bind_many_bind_evict(PORT, tmp_path, pooled), hooks_bind_many_bind_evict(JAX, tmp_path, pooled)
    assert port == jax
    lines = [json.loads(x) for x in (port["journal"] if pooled else port["journal"].splitlines())]
    intents = [r for r in lines if r["rec"] == "intent"]
    assert [(r["cycle"], r["op"], r["pod"]) for r in intents] == [
        (3, "bind", "default/p0"), (3, "bind", "default/p1"), (3, "bind", "default/p2"),
        (4, "bind", "default/p3"), (4, "evict", "default/r0")]
    assert {r["gang"] for r in intents[:4]} == {"default/pg"}
    assert sum(r["rec"] == "confirm" for r in lines) == 5


def failed_write_stays_unconfirmed(P, tmp_path, monkeypatch) -> dict:
    """A write that falls to the errTasks resync keeps its intent
    outstanding, for the next takeover."""
    monkeypatch.setenv("KBT_WRITE_RETRIES", "0")
    path = str(tmp_path / f"fail-{P.name}.wal")
    store, journal, cache = _gang_cache(P, path)
    tasks = sorted(cache.jobs["default/pg"].tasks.values(), key=lambda t: t.name)
    P.faults.registry.arm("bind.write", count=1)
    try:
        cache.bind_many([(t, "n0") for t in tasks[:3]])
    finally:
        P.faults.registry.reset()
        cache.stop()
    out = {"outstanding": [dataclasses.asdict(i) for i in journal.outstanding()], "placements": placements(store),
           "resync": len(cache._err_tasks)}
    journal.close()
    return out


def test_a_write_that_falls_to_resync_stays_unconfirmed(tmp_path, monkeypatch):
    port = failed_write_stays_unconfirmed(PORT, tmp_path, monkeypatch)
    assert port == failed_write_stays_unconfirmed(JAX, tmp_path, monkeypatch)
    assert [o["pod"] for o in port["outstanding"]] == ["default/p0"] and port["resync"] == 1


def test_the_journal_append_span_and_confirm_event(tmp_path, monkeypatch):
    """Traced, bind_many's ``dispatch`` span holds a ``journal.append``
    span with op, n and first_seq, and each intent carries the cycle's
    trace id; the confirms are events of the span current where they run."""
    obs = PORT.sched.obs
    monkeypatch.setenv("KBT_FLIGHT_RECORDER", str(tmp_path / "fr"))
    obs.configure("on")
    try:
        obs.recorder.clear()
        path = str(tmp_path / "traced.wal")
        store, journal, cache = _gang_cache(PORT, path)
        tasks = sorted(cache.jobs["default/pg"].tasks.values(), key=lambda t: t.name)
        with obs.span("cycle") as root:
            cache.bind_many([(t, "n0") for t in tasks[:3]])
        journal.close()
        spans = obs.recorder.spans()
    finally:
        obs.configure()
    by_name = {s["name"]: s for s in spans}
    dispatch, append = by_name["dispatch"], by_name["journal.append"]
    assert append["parent_id"] == dispatch["span_id"] and dispatch["parent_id"] == root.span_id
    assert append["attrs"] == {"op": "bind", "n": 3, "first_seq": 1}
    confirms = [e for s in spans for e in s["events"] if e["name"] == "journal.confirm"]
    assert [e["attrs"]["seq"] for e in confirms] == [1, 2, 3]
    intents = [json.loads(x) for x in read(path).decode().splitlines() if '"intent"' in x]
    assert {r["trace"] for r in intents} == {root.trace_id}


# -- the chaos e2e: the leader dies mid-bulk-bind ----------------------------


class _LeaderKilled(BaseException):
    """SIGKILL stand-in: BaseException so neither the write-retry ladder
    nor the resync routing (both catch Exception) can survive it."""


def dying_binder(P, store, die_after: int):
    class DyingBinder(P.cache_mod.StoreBinder):
        """Store binder that dies after N successful writes (mid-batch)."""

        left = die_after

        def bind(self, pod, hostname: str) -> None:
            if self.left <= 0:
                raise _LeaderKilled()
            self.left -= 1
            super().bind(pod, hostname)

    return DyingBinder(store)


def count_bind_events(P, store) -> dict:
    """pod key -> unbound->bound transitions (the duplicate-bind detector)."""
    counts: dict[str, int] = {}

    def on_update(old, new):
        if not old.node_name and new.node_name:
            key = f"{new.namespace}/{new.name}"
            counts[key] = counts.get(key, 0) + 1

    store.add_event_handler("pods", P.store.EventHandler(on_update=on_update))
    return counts


def chaos(P, tmp_path) -> dict:
    twin = P.store.ClusterStore()
    seed_store(P, twin)
    _, sched_t = make_scheduler(P, twin, tmp_path)
    sched_t.run_once()
    expected = placements(twin)
    assert all(expected.values()) and len(expected) == 12

    store = P.store.ClusterStore()
    seed_store(P, store)
    bind_counts = count_bind_events(P, store)
    path = str(tmp_path / f"leader-{P.name}.wal")
    journal = P.journal.WriteIntentJournal(path)
    _, sched = make_scheduler(P, store, tmp_path, journal=journal, binder=dying_binder(P, store, 4))
    with pytest.raises(_LeaderKilled):
        sched.run_once()
    landed = {k: v for k, v in placements(store).items() if v}
    orphans = P.journal.WriteIntentJournal.replay(path).orphans

    standby = P.journal.WriteIntentJournal(path)
    det = P.detector.MutationDetector(store)
    det.snapshot()
    report = P.reconcile.reconcile_journal(standby, store)
    final = placements(store)
    # the standby's own loop finds a fully bound world: nothing moves
    _, sched_b = make_scheduler(P, store, tmp_path)
    sched_b.run_once()
    out = {
        "expected": expected, "landed": landed, "orphans": [(i.pod, i.node) for i in orphans],
        "report": report.as_dict(), "final": final, "after_loop": placements(store),
        "bind_counts": dict(bind_counts), "violations": det.violations(), "fsck": P.fsck.fsck(path),
    }
    standby.close()
    return out


def test_chaos_leader_killed_mid_bulk_bind_equals_the_jax_run(tmp_path):
    port = chaos(PORT, tmp_path)
    jax = chaos(JAX, tmp_path)
    assert port["final"] == port["expected"] == port["after_loop"], "lost or moved binds"
    assert 0 < len(port["landed"]) < 12 and len(port["orphans"]) == 12 - len(port["landed"])
    assert port["report"]["redispatched"] == 12 - len(port["landed"]) and port["report"]["rolled_back"] == 0
    assert set(port["bind_counts"]) == set(port["expected"]) and set(port["bind_counts"].values()) == {1}
    assert port["violations"] == [] and port["fsck"]["orphaned"] == 0
    view = {k: v for k, v in port.items() if k != "fsck"}
    assert view == {k: v for k, v in jax.items() if k != "fsck"}
    assert port["fsck"] == {**jax["fsck"], "path": port["fsck"]["path"]}


# -- the server: reconcile at start, the append fault ------------------------


def test_server_start_reconciles_seeded_journal_before_its_loop(tmp_path):
    """A SchedulerServer handed a journal with the dead leader's orphans
    re-drives them in start(), before its loop thread exists: the binds
    are in the store when start() returns, for both packages."""
    out = {}
    for P in BOTH:
        store = P.store.ClusterStore()
        seed_store(P, store, gangs=1, members=4)
        path = str(tmp_path / f"srv-{P.name}.wal")
        j = P.journal.WriteIntentJournal(path)
        j.append_intents("bind", [("default/g0", f"default/g0-p{m}", f"n{m % 4}") for m in range(4)], cycle=9)
        j.close()
        srv = P.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0, store=store,
                                       journal_path=path, scheduler_conf=conf_path(P, tmp_path))
        calls = []
        srv.scheduler.run_once = lambda: calls.append(placements(store))
        srv.start()
        try:
            at_start = placements(store)
            wait_until(lambda: calls, what="the loop's first cycle")
        finally:
            srv.stop()
        out[P.name] = (at_start, calls[0], P.fsck.fsck(path)["orphaned"], srv.journal._fh.closed)
    assert out[PORT.name] == out[JAX.name]
    assert out[PORT.name][0] == {f"default/g0-p{m}": f"n{m % 4}" for m in range(4)}
    assert out[PORT.name][2:] == (0, True)  # reconciled, and stop() closed the journal


def test_server_reads_the_journal_path_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("KBT_JOURNAL", str(tmp_path / "env.wal"))
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0,
                                      scheduler_conf=conf_path(PORT, tmp_path))
    try:
        assert srv.journal.path == str(tmp_path / "env.wal") and srv.cache.journal is srv.journal
    finally:
        srv.journal.close()
        srv.httpd.server_close()
    monkeypatch.delenv("KBT_JOURNAL")
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", scheduler_conf=conf_path(PORT, tmp_path))
    srv.httpd.server_close()
    assert srv.journal is None and srv.reconcile() is None


def append_fault(P, tmp_path) -> dict:
    store = P.store.ClusterStore()
    seed_store(P, store, gangs=1, members=4)
    journal = P.journal.WriteIntentJournal(str(tmp_path / f"af-{P.name}.wal"))
    _, sched = make_scheduler(P, store, tmp_path, journal=journal)
    before = P.metrics.journal_records.value({"state": "append_failed"})
    P.faults.registry.arm("journal.append")
    sched.run_once()
    out = {"placements": placements(store), "outstanding": journal.outstanding(),
           "append_failed": P.metrics.journal_records.value({"state": "append_failed"}) - before,
           "file": read(journal.path)}
    journal.close()
    return out


def test_journal_append_fault_dispatches_unjournaled(tmp_path):
    port, jax = append_fault(PORT, tmp_path), append_fault(JAX, tmp_path)
    assert port == jax
    assert all(port["placements"].values()) and port["append_failed"] == 4
    assert port["outstanding"] == [] and port["file"] == b""


# -- the watch client against the port's WatchHub ---------------------------


def test_resilient_watcher_converges_and_reports_age(tmp_path):
    """Both packages' watchers against the port's server: initial list and
    watch convergence, snapshot age ~0 while healthy, inf before the first
    sync, and the same mirrors."""
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0,
                                      scheduler_conf=conf_path(PORT, tmp_path))
    srv.start()
    url = f"http://127.0.0.1:{srv.listen_port}"
    watchers = [P.recovery.ResilientWatcher(url, ("queues", "nodes"), poll_timeout=0.5, min_backoff=0.01,
                                            relist_min_interval=0.05) for P in BOTH]
    try:
        assert all(w.snapshot_age() == float("inf") for w in watchers)
        for w in watchers:
            w.start()
        srv.store.create_queue(PORT.t.build_queue("tenant-a", weight=3))
        srv.store.create_node(PORT.t.build_node("n0", PORT.t.build_resource_list(cpu=2)))
        for w in watchers:
            wait_until(lambda: set(w.mirror["queues"]) == {"default", "tenant-a"} and w.mirror["nodes"],
                       what="watcher mirror convergence")
            assert w.snapshot_age() < 5.0 and not w.stale(5.0)
        srv.store.delete_queue("tenant-a")
        for w in watchers:
            wait_until(lambda: set(w.mirror["queues"]) == {"default"}, what="delete propagates")
        assert watchers[0].mirror == watchers[1].mirror
        assert 0 <= PORT.metrics.watch_snapshot_age.value() < 5.0
    finally:
        for w in watchers:
            w.stop()
        srv.stop()


def test_a_dropped_watch_relists_and_is_counted(tmp_path):
    """``watch.drop`` answers 410 Gone: the port's watcher re-lists
    (``watch_relists_total{kind}``) and resumes, and an event after the
    relist still reaches the mirror."""
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0,
                                      scheduler_conf=conf_path(PORT, tmp_path))
    srv.start()
    w = PORT.recovery.ResilientWatcher(f"http://127.0.0.1:{srv.listen_port}", ("queues",), poll_timeout=0.3,
                                       min_backoff=0.01, relist_min_interval=0.05)
    relists = lambda: PORT.metrics.watch_relists.value({"kind": "queues"})  # noqa: E731
    try:
        w.list_kind("queues")
        before = relists()
        PORT.faults.registry.arm("watch.drop", count=1)
        assert w.poll_once("queues") == "gone"
        w.start()
        wait_until(lambda: relists() > before, what="relist after Gone")
        srv.store.create_queue(PORT.t.build_queue("after-gone"))
        wait_until(lambda: "after-gone" in w.mirror["queues"], what="event after the relist")
    finally:
        w.stop()
        srv.stop()


def test_relist_coalescing_damps_a_gone_storm(tmp_path):
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0,
                                      scheduler_conf=conf_path(PORT, tmp_path))
    srv.start()
    w = PORT.recovery.ResilientWatcher(f"http://127.0.0.1:{srv.listen_port}", ("queues",), poll_timeout=0.5,
                                       relist_min_interval=0.25)
    try:
        t0 = time.monotonic()
        w.list_kind("queues")
        w.list_kind("queues")  # inside the window: waits it out
        assert time.monotonic() - t0 >= 0.25
    finally:
        w.stop()
        srv.stop()


def test_the_watcher_backs_off_while_the_server_is_down():
    """Nothing listens: the loop retries with jittered, doubling backoff
    and the mirror stays stale (inf), then stop() ends the thread."""
    import random

    w = PORT.recovery.ResilientWatcher("http://127.0.0.1:1", ("queues",), poll_timeout=0.1, min_backoff=0.01,
                                       max_backoff=0.05, rng=random.Random(0))
    w.start()
    w.start()  # idempotent
    try:
        time.sleep(0.3)
        assert len(w._threads) == 1 and w.stale(1.0)
    finally:
        w.stop()
    assert not w._threads


def test_recovery_exports_equal_the_jax_packages():
    assert PORT.recovery.__all__ == JAX.recovery.__all__
    assert all(hasattr(PORT.recovery, n) for n in JAX.recovery.__all__)
    assert [f.name for f in dataclasses.fields(PORT.reconcile.ReconcileReport)] == [
        f.name for f in dataclasses.fields(JAX.reconcile.ReconcileReport)]
    assert PORT.journal.WriteIntentJournal.COMPACT_THRESHOLD == JAX.journal.WriteIntentJournal.COMPACT_THRESHOLD == 4096
