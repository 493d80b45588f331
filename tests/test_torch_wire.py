"""The port's store-backend wire (kube_batch_tpu_torch/apis/wire.py and
cache/backend.py) held against the JAX package's.

- Bytes: on the same seeded objects of every wire kind, ``to_wire`` (as
  canonical JSON), ``dumps_binary`` and ``delta_of`` give the same bytes
  in both packages, and each package decodes the other's frames back to
  the same wire dict.
- Processes: a port ``LoopbackBackend`` against a JAX store server, and a
  JAX ``LoopbackBackend`` against the port's store server, in both codecs:
  list, watch, conditional bind, the coalesced txn, the typed 409 and the
  lease verbs.

The tolerance is exact: these are bytes and discrete placements.
"""

from __future__ import annotations

import itertools
import json
import random
import time

import pytest

from kube_batch_tpu.apis import types as jax_types
from kube_batch_tpu.apis import wire as jax_wire
from kube_batch_tpu.cache import EventHandler as JaxEventHandler
from kube_batch_tpu.cache import LoopbackBackend as JaxLoopbackBackend
from kube_batch_tpu.cache import StaleWrite as JaxStaleWrite
from kube_batch_tpu.server import SchedulerServer as JaxSchedulerServer
from kube_batch_tpu.testing import build_node as jax_build_node
from kube_batch_tpu.testing import build_pod as jax_build_pod
from kube_batch_tpu.testing import build_pod_group as jax_build_pod_group
from kube_batch_tpu.testing import build_queue as jax_build_queue
from kube_batch_tpu.testing import build_resource_list as jax_build_resource_list

from kube_batch_tpu_torch import faults
from kube_batch_tpu_torch.apis import types, wire
from kube_batch_tpu_torch.cache import EventHandler, LoopbackBackend, StaleWrite
from kube_batch_tpu_torch.cache.store import LEASES, NODES, PODS, QUEUES
from kube_batch_tpu_torch.federation import write_conf
from kube_batch_tpu_torch.server import SchedulerServer
from kube_batch_tpu_torch.testing import (
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)

KINDS = sorted(wire.KIND_TYPES)
CASES = 12


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.registry.reset()
    yield
    faults.registry.reset()


@pytest.fixture
def frozen_clock(monkeypatch):
    """ObjectMeta stamps a missing creation time from the wall clock; pin
    it so the two packages' seeded objects are the same."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


@pytest.fixture
def same_uids(monkeypatch):
    """ObjectMeta stamps a missing uid from its package's process-wide
    counter, which every object made earlier in the process advances;
    start both packages' counters afresh so the seeded objects agree
    whatever ran before in the same worker."""
    monkeypatch.setattr(jax_types, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(types, "_uid_counter", itertools.count(1))


def _seeded_objects(mod, kind: str, seed: int) -> list:
    """``CASES`` seeded objects of one kind, made by the package's own
    property-test generator (the same draw sequence in both packages)."""
    rng = random.Random(seed)
    cls = mod.KIND_TYPES[kind]
    return [mod._gen_value(cls, rng) for _ in range(CASES)]


def _canon(data) -> bytes:
    return json.dumps(data, sort_keys=True).encode()


# -- bytes -------------------------------------------------------------------


def test_kind_tables_and_content_types_match():
    assert sorted(wire.KIND_TYPES) == sorted(jax_wire.KIND_TYPES)
    assert wire.CODECS == jax_wire.CODECS
    assert wire.BINARY_CONTENT_TYPE == jax_wire.BINARY_CONTENT_TYPE
    assert wire.JSON_CONTENT_TYPE == jax_wire.JSON_CONTENT_TYPE


@pytest.mark.parametrize("kind", KINDS)
def test_to_wire_and_binary_frames_are_byte_identical(kind, frozen_clock, same_uids):
    for seed in (0, 7):
        ours = _seeded_objects(wire, kind, seed)
        theirs = _seeded_objects(jax_wire, kind, seed)
        for o, t in zip(ours, theirs):
            ow, tw = wire.encode_kind(kind, o), jax_wire.encode_kind(kind, t)
            assert _canon(ow) == _canon(tw)
            assert wire.dumps_binary(ow) == jax_wire.dumps_binary(tw)


@pytest.mark.parametrize("kind", KINDS)
def test_delta_of_is_byte_identical(kind, frozen_clock, same_uids):
    ours = _seeded_objects(wire, kind, 3)
    theirs = _seeded_objects(jax_wire, kind, 3)
    for i in range(CASES - 1):
        od = wire.delta_of(kind, ours[i], ours[i + 1])
        td = jax_wire.delta_of(kind, theirs[i], theirs[i + 1])
        assert _canon(od) == _canon(td)
        assert wire.dumps_binary(od) == jax_wire.dumps_binary(td)
        # each package applies the other's patch to the same object
        assert wire.apply_delta(kind, ours[i], td) == ours[i + 1]
        assert jax_wire.apply_delta(kind, theirs[i], od) == theirs[i + 1]


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_frames(kind, frozen_clock, same_uids):
    ours = _seeded_objects(wire, kind, 11)
    theirs = _seeded_objects(jax_wire, kind, 11)
    for o, t in zip(ours, theirs):
        jax_frame = jax_wire.dumps_binary(jax_wire.encode_kind(kind, t))
        port_frame = wire.dumps_binary(wire.encode_kind(kind, o))
        # port decodes the JAX frame into its own object, and back
        decoded = wire.decode_kind(kind, wire.loads_binary(jax_frame))
        assert decoded == o
        assert wire.dumps_binary(wire.encode_kind(kind, decoded)) == jax_frame
        # JAX decodes the port's frame
        decoded_j = jax_wire.decode_kind(kind, jax_wire.loads_binary(port_frame))
        assert decoded_j == t
        assert jax_wire.dumps_binary(jax_wire.encode_kind(kind, decoded_j)) == port_frame
        # and the JSON text form
        text = json.dumps(jax_wire.encode_kind(kind, t), sort_keys=True)
        assert wire.decode_kind(kind, json.loads(text)) == o


def test_self_check_summaries_agree(frozen_clock, same_uids):
    ours = wire.self_check(seed=5, cases=6)
    theirs = jax_wire.self_check(seed=5, cases=6)
    assert ours["ok"] and theirs["ok"], (ours["errors"], theirs["errors"])
    assert ours == theirs


def test_wire_cli_prints_one_json_line(capsys):
    assert wire.main(["--json", "--cases", "2", "--seed", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["ok"] and out["cases"] == 2 * len(KINDS)


# -- processes: each package's client against the other's server --------------


class _Pkg:
    """One package's side of a store-backend pairing."""

    def __init__(self, jax: bool) -> None:
        self.jax = jax
        self.backend = JaxLoopbackBackend if jax else LoopbackBackend
        self.handler = JaxEventHandler if jax else EventHandler
        self.stale = JaxStaleWrite if jax else StaleWrite
        self.node = jax_build_node if jax else build_node
        self.pod = jax_build_pod if jax else build_pod
        self.pod_group = jax_build_pod_group if jax else build_pod_group
        self.queue = jax_build_queue if jax else build_queue
        self.res = jax_build_resource_list if jax else build_resource_list


def _seed(srv, side: _Pkg, gangs=("ga", "gb"), members=2, nodes=2) -> None:
    store = srv.store
    if store.get(QUEUES, "default") is None:
        store.create_queue(side.queue("default"))
    for i in range(nodes):
        store.create_node(
            side.node(f"n{i}", side.res(cpu=16, memory="16Gi", pods=64), labels={"zone": f"z{i}"})
        )
    for g in gangs:
        store.create_pod_group(side.pod_group(g, min_member=members))
        for m in range(members):
            store.create_pod(
                side.pod(name=f"{g}-p{m}", group_name=g, req=side.res(cpu=1, memory="512Mi"))
            )


@pytest.fixture(params=["port-client-jax-server", "jax-client-port-server"])
def pairing(request, tmp_path):
    """(server, server side, client side): the server is the store process
    (an idle loop: no pod carries its scheduler name)."""
    jax_server = request.param == "port-client-jax-server"
    if jax_server:
        srv = JaxSchedulerServer(
            scheduler_name="store-arbiter", listen_address="127.0.0.1:0", schedule_period=60.0
        )
    else:
        srv = SchedulerServer(
            scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
            scheduler_conf=write_conf("cpu", directory=str(tmp_path)), schedule_period=60.0,
        )
    srv.start()
    try:
        yield srv, _Pkg(jax_server), _Pkg(not jax_server)
    finally:
        srv.stop()


@pytest.mark.parametrize("codec", ["json", "binary"])
def test_list_watch_and_conditional_writes_across_packages(pairing, codec):
    srv, server_side, client_side = pairing
    _seed(srv, server_side)
    base = f"http://127.0.0.1:{srv.listen_port}"
    backend = client_side.backend(base, codec=codec)
    events: list[tuple] = []
    backend.add_event_handler(
        PODS,
        client_side.handler(
            on_add=lambda o: events.append(("add", o.name)),
            on_update=lambda old, new: events.append(("update", new.name, new.node_name)),
            on_delete=lambda o: events.append(("delete", o.name)),
        ),
    )
    for kind in (NODES, QUEUES, LEASES):
        backend.add_event_handler(kind, client_side.handler())
    assert backend._protocol == 2 and backend._codec == codec
    assert backend.supports_txn()
    # list: the whole world, each object equal field for field
    assert sorted(e[1] for e in events) == ["ga-p0", "ga-p1", "gb-p0", "gb-p1"]
    for pod in srv.store.list(PODS):
        mirrored = backend.get_pod(pod.namespace, pod.name)
        assert _canon(wire.to_wire(mirrored)) == _canon(wire.to_wire(pod))
    assert {n.name for n in backend.list(NODES)} == {"n0", "n1"}

    # conditional bind, then the typed 409 on the stale version
    v = backend.version
    assert v == srv.store.version
    assert backend.conditional_bind_many([("default", "ga-p0", "n0")], v) == 1
    with pytest.raises(client_side.stale) as ei:
        backend.conditional_bind_many([("default", "ga-p1", "n0")], v)
    e = ei.value
    assert (e.kind, e.key, e.reason) == (NODES, "n0", "stale_node")
    assert e.expected == v and e.actual > v

    # the coalesced txn: one clean gang, one conflicted, results inline
    v = backend.version
    results = backend.submit_txn([
        {"op": "bind", "bindings": [["default", "gb-p0", "n1"], ["default", "gb-p1", "n1"]],
         "snapshotVersion": v},
        {"op": "bind", "bindings": [["default", "ga-p1", "n0"]], "snapshotVersion": 0},
    ])
    assert results[0] == {"applied": 2}
    assert results[1]["conflict"]["reason"] == "stale_node"
    assert srv.store.get_pod("default", "gb-p1").node_name == "n1"
    assert not srv.store.get_pod("default", "ga-p1").node_name

    # watch: the binds arrive as MODIFIED events (deltas under v2)
    assert backend.pump() >= 1
    assert ("update", "ga-p0", "n0") in events and ("update", "gb-p1", "n1") in events
    assert backend.get_pod("default", "gb-p0").node_name == "n1"
    # evict, idempotent re-dispatch, and the delete through the watch
    assert backend.conditional_evict("default", "gb-p0", backend.version) is True
    assert backend.conditional_evict("default", "gb-p0", backend.version) is False
    backend.pump()
    assert ("delete", "gb-p0") in events and backend.get_pod("default", "gb-p0") is None
    # CRUD through the generic route lands full-fidelity in the store
    backend.create_pod(client_side.pod(name="late", group_name="gc", req=client_side.res(cpu=2)))
    late = srv.store.get_pod("default", "late")
    assert late is not None and late.metadata.annotations
    backend.pump()
    assert backend.get_pod("default", "late") is not None
    assert backend.bytes_tx > 0 and backend.bytes_rx > 0


def test_lease_verbs_across_packages(pairing):
    srv, _server_side, client_side = pairing
    backend = client_side.backend(f"http://127.0.0.1:{srv.listen_port}")
    name = "shard-slot-0"
    lease = backend.try_acquire_lease(name, "remote-a", lease_duration=60.0)
    assert lease.holder_identity == "remote-a"
    assert backend.try_acquire_lease(name, "remote-a", 60.0).holder_identity == "remote-a"
    assert backend.try_acquire_lease(name, "remote-b", 60.0).holder_identity == "remote-a"
    assert srv.store.get(LEASES, name).holder_identity == "remote-a"
    assert not backend.release_lease(name, "remote-a").holder_identity
    assert backend.try_acquire_lease(name, "remote-b", 60.0).holder_identity == "remote-b"


def test_v1_pinned_server_of_either_package_serves_the_other_client(tmp_path):
    """A v2 client negotiates down against a v1-pinned server of the other
    package: the bare version reply is the downgrade signal, and the v1
    surface keeps working (list, per-kind watch, conditional bind)."""
    for jax_server in (True, False):
        if jax_server:
            srv = JaxSchedulerServer(
                scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
                schedule_period=60.0, wire_protocol=1,
            )
        else:
            srv = SchedulerServer(
                scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
                scheduler_conf=write_conf("cpu", directory=str(tmp_path)),
                schedule_period=60.0, wire_protocol=1,
            )
        srv.start()
        try:
            server_side, client_side = _Pkg(jax_server), _Pkg(not jax_server)
            _seed(srv, server_side, gangs=("g0",))
            backend = client_side.backend(f"http://127.0.0.1:{srv.listen_port}")
            backend.add_event_handler(PODS, client_side.handler())
            assert backend._protocol == 1 and backend._codec == "json"
            assert not backend.supports_txn()
            assert backend.conditional_bind_many([("default", "g0-p0", "n0")], backend.version) == 1
            assert backend.pump() >= 1
            assert backend.get_pod("default", "g0-p0").node_name == "n0"
        finally:
            srv.stop()
