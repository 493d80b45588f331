"""The port's wire protocol v2, case for case with tests/test_wire_v2.py:
the binary framing's loud failure modes, the pump's decode-outside-lock contract, delta list+watch mirror
parity (including the 410 re-list heal), and the coalesced conditional
write path — bind-for-bind parity with per-gang dispatch under a
mutation detector, zero journal orphans after a SIGKILL mid-batch, and
the ``store.txn_batch`` chaos drill degrading loudly to per-gang v1
writes. The port logs through stdlib ``logging``, so the chaos drill reads
the degradation line from ``caplog``."""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.error
import urllib.request

import pytest

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.api.job_info import job_key
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis import wire
from kube_batch_tpu_torch.cache import (
    EventHandler,
    LoopbackBackend,
    SchedulerCache,
)
from kube_batch_tpu_torch.cache.store import KINDS, PODS, QUEUES
from kube_batch_tpu_torch.faults.mutation_detector import MutationDetector
from kube_batch_tpu_torch.federation import fsck, write_conf
from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal
from kube_batch_tpu_torch.server import SchedulerServer
from kube_batch_tpu_torch.testing import (
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.registry.reset()
    faults.solver_ladder.reset()
    yield
    faults.registry.reset()
    faults.solver_ladder.reset()


@pytest.fixture
def make_arbiter(tmp_path):
    """Factory for store-arbiter servers (scheduling loop idled by a
    scheduler name no workload pod carries, its torch_allocate on the
    CPU); stops them all at teardown so a failing test never leaks a
    listener thread."""
    servers: list[SchedulerServer] = []
    conf = write_conf("cpu", directory=str(tmp_path))

    def _make(wire_protocol: int = 2) -> SchedulerServer:
        srv = SchedulerServer(
            scheduler_name="store-arbiter",
            listen_address="127.0.0.1:0",
            scheduler_conf=conf,
            schedule_period=60.0,
            wire_protocol=wire_protocol,
        )
        srv.start()
        servers.append(srv)
        return srv

    yield _make
    for srv in servers:
        srv.stop()
    os.unlink(conf)


def _base(arbiter) -> str:
    return f"http://127.0.0.1:{arbiter.listen_port}"


def seed_store(store, nodes=1, cpu=16, gangs=(), members=3):
    if store.get(QUEUES, "default") is None:  # the server pre-seeds one
        store.create_queue(build_queue("default"))
    for i in range(nodes):
        store.create_node(
            build_node(
                f"n{i}", build_resource_list(cpu=cpu, memory=f"{cpu}Gi", pods=64)
            )
        )
    for g in gangs:
        store.create_pod_group(build_pod_group(g, min_member=members))
        for m in range(members):
            store.create_pod(
                build_pod(
                    name=f"{g}-p{m}", group_name=g,
                    req=build_resource_list(cpu=1, memory="512Mi"),
                )
            )


def bind_gangs(cache, mapping: dict):
    """Dispatch every pending task of each gang in ONE bind_many call —
    the shape the coalescer batches: all gangs of one cycle, one txn
    round trip."""
    pairs = []
    with cache._mutex:
        for gang, node in mapping.items():
            job = cache.jobs.get(job_key("default", gang))
            pending = (
                list(job.task_status_index.get(TaskStatus.PENDING, {}).values())
                if job is not None
                else []
            )
            assert pending, f"gang {gang} has no pending tasks in this cache"
            pairs.extend((t, node) for t in pending)
    cache.bind_many(pairs)


def count_bind_events(store):
    counts: dict[str, int] = {}
    lock = threading.Lock()

    def on_update(old, new):
        if not old.node_name and new.node_name:
            with lock:
                key = f"{new.namespace}/{new.name}"
                counts[key] = counts.get(key, 0) + 1

    store.add_event_handler(PODS, EventHandler(on_update=on_update))
    return counts


def mirror_snap(backend) -> dict:
    """Canonical bytes of a backend mirror: kind -> key -> sorted wire
    JSON. Two mirrors fed through different transports (full-object v1
    vs delta v2, json vs binary) must be byte-identical here."""
    with backend._lock:
        return {
            kind: {
                key: json.dumps(wire.encode_kind(kind, obj), sort_keys=True)
                for key, obj in backend._mirror[kind].items()
            }
            for kind in backend.kinds
        }


# -- binary framing ----------------------------------------------------------


def test_binary_codec_self_check_and_size_win():
    s = wire.self_check(seed=1, cases=20)
    assert s["ok"], s["errors"]
    assert s["failures"] == 0
    # the headline property of the binary framing: strictly fewer bytes
    # than the same objects through the JSON codec
    assert s["binary_bytes"] < s["json_bytes"]


def test_binary_frame_rejects_garbage_loudly():
    # JSON bytes handed to the binary decoder: the codec-mismatch case —
    # the error must point at the triage ladder, not be a struct error
    with pytest.raises(ValueError, match="codec mismatch"):
        wire.loads_binary(b'{"storeVersion": 3}')
    blob = wire.dumps_binary({"a": 1, "b": [1, 2, 3]})
    assert wire.loads_binary(blob) == {"a": 1, "b": [1, 2, 3]}
    with pytest.raises(ValueError, match="length mismatch"):
        wire.loads_binary(blob[:-2])
    with pytest.raises(ValueError, match="codec mismatch"):
        wire.loads_binary(b"XXXX" + blob[4:])


def test_bad_codec_pref_falls_back_to_json():
    # an unknown KBT_WIRE_CODEC must degrade to json (loudly, in the
    # log), never crash the backend at construction
    b = LoopbackBackend("http://127.0.0.1:9", codec="gzip")
    assert b._codec_pref == "json"


def test_binary_body_to_v1_server_is_rejected_loudly(make_arbiter):
    # a v2 client that skipped renegotiation after a rolling downgrade
    # would POST binary at a v1 server: the reply must be a loud 400
    # JSON error naming the fix, not a silent mis-parse
    srv = make_arbiter(wire_protocol=1)
    req = urllib.request.Request(
        f"{_base(srv)}/backend/v1/bind",
        data=wire.dumps_binary({"bindings": []}),
        headers={"Content-Type": wire.BINARY_CONTENT_TYPE},
        method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=5)
    assert ei.value.code == 400
    payload = json.loads(ei.value.read())
    assert "binary request body on a v1 server" in payload["error"]
    assert "re-negotiate" in payload["error"]


# -- pump lock discipline (decode outside _lock) -----------------------------


def test_pump_decodes_wire_payloads_outside_mirror_lock(
    make_arbiter, monkeypatch
):
    """Regression for the pump stall: decoding a fat payload under
    ``_lock`` blocks every concurrent mirror read for the duration.
    Every ``decode_kind`` call (initial list, watch events, re-list
    heal) must run with the mirror lock acquirable from another thread
    — probed cross-thread because ``_lock`` is an RLock and a
    same-thread acquire would always succeed."""
    srv = make_arbiter()
    seed_store(srv.store, gangs=("g0",), members=2)
    backend = LoopbackBackend(_base(srv), kinds=(PODS,))

    real_decode = wire.decode_kind
    probes: list[bool] = []

    def spying_decode(kind, data):
        acquired = []

        def probe():
            ok = backend._lock.acquire(timeout=2.0)
            if ok:
                backend._lock.release()
            acquired.append(ok)

        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=5.0)
        probes.extend(acquired or [False])
        return real_decode(kind, data)

    monkeypatch.setattr(wire, "decode_kind", spying_decode)
    backend.add_event_handler(PODS, EventHandler())  # initial list decodes
    srv.store.create_pod(
        build_pod(name="late", req=build_resource_list(cpu=1))
    )
    assert backend.pump() >= 1  # watch event decodes
    faults.registry.arm("watch.drop", count=1)
    srv.store.create_pod(
        build_pod(name="later", req=build_resource_list(cpu=1))
    )
    assert backend.pump() >= 1  # 410 -> re-list heal decodes
    assert probes, "decode_kind never ran — the drill lost its subject"
    assert all(probes), "mirror lock was held during a wire decode"
    assert backend.get_pod("default", "later") is not None


# -- delta list+watch --------------------------------------------------------


def test_delta_mirror_matches_full_object_mirror_through_schedule(
    make_arbiter,
):
    """Acceptance drill: a delta-watch (v2, binary) mirror must be
    byte-identical to a full-object (v1, json) mirror after the same
    event schedule — adds, gang binds, deletes, and a forced 410 heal
    mid-run."""
    srv = make_arbiter()
    seed_store(srv.store, nodes=2, gangs=("g0", "g1"), members=2)
    b_full = LoopbackBackend(_base(srv), protocol=1)
    b_delta = LoopbackBackend(_base(srv))
    for b in (b_full, b_delta):
        for kind in KINDS:
            b.add_event_handler(kind, EventHandler())
    assert b_delta._protocol == 2 and "delta" in b_delta._features
    assert b_full._protocol == 1
    assert mirror_snap(b_delta) == mirror_snap(b_full)

    # adds + a gang bind (field-level MODIFIED deltas on pods/nodes)
    srv.store.create_pod(
        build_pod(name="late", req=build_resource_list(cpu=1))
    )
    v = srv.store.version
    srv.store.conditional_bind_many(
        [("default", "g0-p0", "n0"), ("default", "g0-p1", "n0")], v
    )
    srv.store.delete_pod("default", "late")
    assert b_delta.pump() >= 1
    assert b_full.pump() >= 1
    snap = mirror_snap(b_delta)
    assert snap == mirror_snap(b_full)
    assert json.loads(snap[PODS]["default/g0-p0"])["node_name"] == "n0"
    assert "default/late" not in snap[PODS]

    # 410 heal: the delta watcher's cursor is declared gone mid-run;
    # it must re-list and land on the exact same bytes as the v1 twin
    faults.registry.arm("watch.drop", count=1)
    v = srv.store.version
    srv.store.conditional_bind_many(
        [("default", "g1-p0", "n1"), ("default", "g1-p1", "n1")], v
    )
    assert b_delta.pump() >= 1  # consumes the fault: gone -> re-list
    assert b_full.pump() >= 1
    snap = mirror_snap(b_delta)
    assert snap == mirror_snap(b_full)
    assert json.loads(snap[PODS]["default/g1-p1"])["node_name"] == "n1"
    # and both match server truth
    for g, n in (("g0", "n0"), ("g1", "n1")):
        for m in range(2):
            assert b_delta.get_pod("default", f"{g}-p{m}").node_name == n


# -- coalesced conditional writes --------------------------------------------


def _cache_over(srv, **kwargs) -> SchedulerCache:
    cache = SchedulerCache(
        LoopbackBackend(_base(srv)), conditional_binds=True, **kwargs
    )
    cache.snapshot()  # stamp _snapshot_version for conditional dispatch
    return cache


GANG_NODES = {"ga": "n0", "gb": "n1", "gc": "n2"}


def test_coalesced_txn_parity_with_per_gang_dispatch(
    make_arbiter, monkeypatch
):
    """Acceptance drill: the same three-gang cycle through the coalesced
    /backend/v1/txn path and through per-gang conditional writes must
    land bind-for-bind identical placements — exactly once, mutation
    detector armed, fsck clean — with exactly one batch observed."""
    srv_txn = make_arbiter()
    srv_gang = make_arbiter()
    for srv in (srv_txn, srv_gang):
        seed_store(srv.store, nodes=3, gangs=tuple(GANG_NODES), members=2)
    counts_txn = count_bind_events(srv_txn.store)
    counts_gang = count_bind_events(srv_gang.store)
    det_txn = MutationDetector(srv_txn.store)
    det_gang = MutationDetector(srv_gang.store)
    det_txn.snapshot()
    det_gang.snapshot()

    cache_txn = _cache_over(srv_txn)  # KBT_TXN_COALESCE default: on
    assert cache_txn._txn_coalesce and cache_txn.store.supports_txn()
    monkeypatch.setenv("KBT_TXN_COALESCE", "0")
    cache_gang = _cache_over(srv_gang)
    assert not cache_gang._txn_coalesce

    txn0 = metrics.store_backend_txn_batch.snapshot()
    bind_gangs(cache_txn, GANG_NODES)
    bind_gangs(cache_gang, GANG_NODES)
    txn1 = metrics.store_backend_txn_batch.snapshot()

    # one batch carrying all three gangs, and only from the coalescing
    # cache — the per-gang twin never touched /backend/v1/txn
    assert txn1["count"] == txn0["count"] + 1
    assert txn1["sum"] == txn0["sum"] + len(GANG_NODES)

    for g, n in GANG_NODES.items():
        for m in range(2):
            p_txn = srv_txn.store.get_pod("default", f"{g}-p{m}")
            p_gang = srv_gang.store.get_pod("default", f"{g}-p{m}")
            assert p_txn.node_name == n == p_gang.node_name
    expected = sorted(f"default/{g}-p{m}" for g in GANG_NODES for m in range(2))
    for counts in (counts_txn, counts_gang):
        assert sorted(counts) == expected
        assert all(c == 1 for c in counts.values()), f"duplicates: {counts}"
    assert det_txn.violations() == [] and det_gang.violations() == []
    assert fsck(srv_txn.store) == [] and fsck(srv_gang.store) == []


class _Killed(BaseException):
    """SIGKILL stand-in (BaseException: no retry ladder survives it)."""


class _DyingBackend(LoopbackBackend):
    """Dies exactly at the coalesced submit — after the journal holds
    every gang's intents, before any write reaches the store."""

    def submit_txn(self, txns):
        raise _Killed()


def test_txn_sigkill_mid_batch_leaves_no_journal_orphans(
    make_arbiter, tmp_path
):
    """Acceptance drill: leader killed mid-coalesced-batch — nothing
    landed, the journal holds the whole cycle as orphans, and standby
    reconciliation re-drives every gang exactly once (fsck clean,
    mutation detector clean, zero orphans on re-replay)."""
    srv = make_arbiter()
    seed_store(srv.store, nodes=2, gangs=("ga", "gb"), members=2)
    counts = count_bind_events(srv.store)
    journal = WriteIntentJournal(str(tmp_path / "leader.wal"))
    cache = SchedulerCache(
        _DyingBackend(_base(srv)), conditional_binds=True, journal=journal
    )
    cache.snapshot()
    assert cache.store.supports_txn()
    with pytest.raises(_Killed):
        bind_gangs(cache, {"ga": "n0", "gb": "n1"})

    # died before anything reached the store: all four intents orphaned
    pods = [f"default/{g}-p{m}" for g in ("ga", "gb") for m in range(2)]
    for key in pods:
        ns, name = key.split("/")
        assert not srv.store.get_pod(ns, name).node_name
    orphans = WriteIntentJournal.replay(journal.path).orphans
    assert sorted((i.op, i.pod) for i in orphans) == sorted(
        ("bind", p) for p in pods
    )

    # standby takeover: reconcile the WAL against store truth
    standby = WriteIntentJournal(journal.path)
    det = MutationDetector(srv.store)
    det.snapshot()
    report = reconcile_journal(standby, srv.store)
    assert report.redispatched == len(pods) and report.rolled_back == 0
    for g, n in (("ga", "n0"), ("gb", "n1")):
        for m in range(2):
            assert srv.store.get_pod("default", f"{g}-p{m}").node_name == n
    assert sorted(counts) == sorted(pods)
    assert all(c == 1 for c in counts.values()), f"duplicates: {counts}"
    assert det.violations() == []
    assert fsck(srv.store) == []
    assert WriteIntentJournal.replay(journal.path).orphans == []
    journal.close()
    standby.close()


@pytest.mark.chaos
def test_chaos_txn_batch_fault_degrades_loudly_to_per_gang(
    make_arbiter, caplog
):
    """store.txn_batch armed mid-batch: the coalesced path must degrade
    LOUDLY to per-gang conditional writes — every pod still lands
    exactly once, no batch is observed, and the degradation is named in
    the error log."""
    srv = make_arbiter()
    seed_store(srv.store, nodes=2, gangs=("ga", "gb"), members=2)
    counts = count_bind_events(srv.store)
    cache = _cache_over(srv)
    assert cache.store.supports_txn()

    caplog.set_level(logging.ERROR, logger="kube_batch_tpu_torch.cache.cache")
    txn0 = metrics.store_backend_txn_batch.snapshot()
    faults.registry.arm("store.txn_batch", count=1)
    bind_gangs(cache, {"ga": "n0", "gb": "n1"})
    errors = [
        r.getMessage() for r in caplog.records if r.levelno >= logging.ERROR
    ]

    assert any(
        "degrading 2 gang(s) to per-gang conditional writes" in e
        for e in errors
    ), errors
    # no batch landed — the cycle went out as per-gang v1 writes
    assert metrics.store_backend_txn_batch.snapshot()["count"] == txn0["count"]
    for g, n in (("ga", "n0"), ("gb", "n1")):
        for m in range(2):
            assert srv.store.get_pod("default", f"{g}-p{m}").node_name == n
    expected = sorted(f"default/{g}-p{m}" for g in ("ga", "gb") for m in range(2))
    assert sorted(counts) == expected
    assert all(c == 1 for c in counts.values()), f"duplicates: {counts}"
    assert fsck(srv.store) == []


# -- trace propagation across the wire (obs.current_headers / from_headers) ----

from kube_batch_tpu_torch import obs  # noqa: E402


@pytest.fixture
def traced(monkeypatch, tmp_path):
    """KBT_TRACE on, an empty ring, dumps under tmp_path; off afterwards."""
    monkeypatch.setenv("KBT_TRACE", "1")
    monkeypatch.setenv("KBT_FLIGHT_RECORDER", str(tmp_path / "flight"))
    obs.configure()
    obs.recorder.clear()
    yield
    monkeypatch.delenv("KBT_TRACE")
    obs.recorder.clear()
    obs.configure()


def test_headers_are_empty_with_tracing_off():
    assert not obs.enabled()
    assert obs.current_headers() == {}
    assert obs.from_headers({obs.HDR_TRACE: "t", obs.HDR_SPAN: "s"}) is None


def test_header_roundtrip_joins_the_trace(traced):
    with obs.span("gang.bind") as parent:
        headers = obs.current_headers()
        assert headers == {obs.HDR_TRACE: parent.trace_id, obs.HDR_SPAN: parent.span_id}
    child = obs.span("store.bind", parent=obs.from_headers(headers))
    with child:
        pass
    assert (child.trace_id, child.parent_id) == (parent.trace_id, parent.span_id)
    assert obs.from_headers({}) is None and obs.from_headers(None) is None


def test_a_conflicted_coalesced_bind_is_one_trace_across_the_wire(make_arbiter, traced):
    """A cycle's coalesced batch over a live LoopbackBackend, with
    ``federation.stale_assign`` armed: the store's ``store.txn`` and
    ``store.bind`` spans parent on the client's ``txn.batch`` and
    ``gang.bind`` through the headers, and the tree is whole."""
    srv = make_arbiter()
    seed_store(srv.store, nodes=2, gangs=("ga", "gb"), members=2)
    # placement history on n0: the stale version 0 loses there
    srv.store.create_pod(build_pod(name="warm", req=build_resource_list(cpu=1)))
    srv.store.conditional_bind_many([("default", "warm", "n0")], srv.store.version)
    cache = _cache_over(srv)
    faults.registry.arm("federation.stale_assign", count=1)
    with obs.span("cycle") as root:
        bind_gangs(cache, {"ga": "n0", "gb": "n1"})
    spans = obs.recorder.spans()
    assert obs.check_tree(spans) == []
    by_name: dict[str, list] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    batch = by_name["txn.batch"][0]
    assert batch["trace_id"] == root.trace_id
    store_txn = by_name["store.txn"][0]
    assert (store_txn["trace_id"], store_txn["parent_id"]) == (root.trace_id, batch["span_id"])
    gang_binds = {s["span_id"] for s in by_name["gang.bind"]}
    assert gang_binds and all(s["trace_id"] == root.trace_id for s in by_name["gang.bind"])
    assert any(s["parent_id"] in gang_binds for s in by_name["store.bind"])
    for g, n in (("ga", "n0"), ("gb", "n1")):
        for m in range(2):
            assert srv.store.get_pod("default", f"{g}-p{m}").node_name == n
