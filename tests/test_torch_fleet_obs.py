"""The port's fleet observatory (obs/fleet.py) and the sketch's wire form
(obs/__init__.py), case for case with the sketch, accountant, fleet,
exemplar and pipeline-overlap cases of tests/test_fleet_obs.py: mergeable
QuantileSketch property checks against pooled raw samples, the SLO
accountant's LRU cardinality bound, the KBT_FLEET off switch, an
in-process scrape -> merge aggregator drill, OpenMetrics exemplar gating,
and the dispatch fence's measured overlap.

The KBT-R012 SLO-kind registry cases run through the port's own
analyzer (``kube_batch_tpu_torch.analysis.registry_consistency``).

``test_arena_accounts_hbm_bytes_and_watermark`` is mirrored at the end,
the JAX arena's gauges read beside the port's. Left out: the six
``test_bench_diff_*`` cases, which test the JAX package's
``hack/bench_diff.py`` script, a tool of its own bench that no queue item
ports.

Then held against the JAX package: the same samples at the same
timestamps give cell-for-cell equal wire forms, a port
``FleetAggregator`` rollup over the same raw payloads equals the JAX
rollup, and the live smoke (two loopback shards on the CPU) passes.
"""

from __future__ import annotations

import ast
import json
import math
import os
import random
import time

import pytest

from kube_batch_tpu_torch import metrics, obs
from kube_batch_tpu_torch import pipeline
from kube_batch_tpu_torch.analysis import SourceFile, registry_consistency
from kube_batch_tpu_torch.obs import QuantileSketch, SLOAccountant
from kube_batch_tpu_torch.obs import fleet

# the bound every sketch consumer (smoke, verify gate, these tests)
# holds quantiles to: declared alpha plus a 5% margin for the bucket
# midpoint sitting a hair past the ideal reconstruction
REL_BOUND = QuantileSketch.DEFAULT_ALPHA * 1.05


def _nearest_rank(sorted_values: list[float], q: float) -> float:
    n = len(sorted_values)
    return sorted_values[min(n - 1, max(0, math.ceil(q * n) - 1))]


def _fill(sk: QuantileSketch, values, t0: float) -> None:
    # deterministic timestamps well inside the window, spread over a
    # few slices so the ring (not just one slice) is exercised
    for i, v in enumerate(values):
        sk.add(v, t=t0 + (i % 7) * sk.slice_s * 0.9)


def _assert_wire_equal(a: dict, b: dict) -> None:
    """Cell-for-cell wire equality; the per-slice running sum ``s`` is
    compared approximately (float addition order differs between a
    pooled stream and a merge fold)."""
    assert a["alpha"] == b["alpha"] and a["slice_s"] == b["slice_s"]
    assert sorted(a["slices"]) == sorted(b["slices"])
    for epoch, sa in a["slices"].items():
        sb = b["slices"][epoch]
        assert sa["b"] == sb["b"] and sa["z"] == sb["z"] and sa["n"] == sb["n"]
        assert sa["s"] == pytest.approx(sb["s"])


# -- sketch properties -------------------------------------------------------


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "exponential"])
@pytest.mark.parametrize("seed", [1, 7])
def test_sketch_quantiles_within_declared_relative_error(dist, seed):
    rng = random.Random(seed)
    if dist == "uniform":
        values = [rng.uniform(0.001, 10.0) for _ in range(2000)]
    elif dist == "lognormal":
        values = [rng.lognormvariate(0.0, 1.5) for _ in range(2000)]
    else:
        values = [rng.expovariate(4.0) for _ in range(2000)]
    sk = QuantileSketch(window_s=300.0)
    _fill(sk, values, time.time())
    ordered = sorted(values)
    assert sk.count() == len(values)
    assert sk.total() == pytest.approx(sum(values))
    for q in (0.25, 0.5, 0.9, 0.99):
        exact = _nearest_rank(ordered, q)
        got = sk.quantile(q)
        assert got == pytest.approx(exact, rel=REL_BOUND), (dist, q)


def test_sketch_merge_equals_pooled_sketch_exactly():
    """The tentpole invariant: N shards' sketches merged cell-wise are
    identical (counts, totals, every quantile) to ONE sketch fed the
    pooled stream — not merely within tolerance."""
    rng = random.Random(42)
    values = [rng.lognormvariate(-1.0, 1.0) for _ in range(1500)]
    t0 = time.time()
    pooled = QuantileSketch(window_s=300.0)
    _fill(pooled, values, t0)
    shards = [QuantileSketch(window_s=300.0) for _ in range(3)]
    for i, v in enumerate(values):
        # same timestamp function of i as _fill, routed round-robin
        shards[i % 3].add(v, t=t0 + (i % 7) * pooled.slice_s * 0.9)
    merged = QuantileSketch(window_s=300.0)
    for sh in shards:
        merged.merge(sh)
    assert merged.count() == pooled.count() == len(values)
    assert merged.total() == pytest.approx(pooled.total())
    for q in (0.01, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert merged.quantile(q) == pooled.quantile(q)
    # and the wire forms agree cell-for-cell
    _assert_wire_equal(merged.to_wire(), pooled.to_wire())


def test_sketch_merge_order_independent():
    rng = random.Random(3)
    t0 = time.time()
    parts = []
    for _ in range(4):
        sk = QuantileSketch(window_s=300.0)
        _fill(sk, [rng.expovariate(2.0) for _ in range(200)], t0)
        parts.append(sk)
    fwd = QuantileSketch(window_s=300.0)
    rev = QuantileSketch(window_s=300.0)
    for sk in parts:
        fwd.merge(sk)
    for sk in reversed(parts):
        rev.merge(sk)
    _assert_wire_equal(fwd.to_wire(), rev.to_wire())


def test_sketch_empty_and_singleton_edges():
    sk = QuantileSketch(window_s=300.0)
    assert sk.count() == 0
    assert sk.quantile(0.5) == 0.0
    assert sk.quantile(0.99) == 0.0
    one = QuantileSketch(window_s=300.0)
    one.add(0.125, t=time.time())
    assert one.count() == 1
    for q in (0.0, 0.5, 1.0):
        assert one.quantile(q) == pytest.approx(0.125, rel=REL_BOUND)
    # merging an empty sketch is the identity
    before = one.to_wire()
    one.merge(sk)
    assert one.to_wire() == before


def test_sketch_zero_bucket_and_expiry():
    sk = QuantileSketch(window_s=0.06, slices=3)
    now = time.time()
    sk.add(0.0, t=now)  # below _SKETCH_MIN -> zero bucket
    sk.add(1.0, t=now)
    assert sk.count() == 2
    assert sk.quantile(0.25) == 0.0
    assert sk.quantile(1.0) == pytest.approx(1.0, rel=REL_BOUND)
    sk.trim(now + 1.0)  # whole window expired -> every slice dropped
    assert sk.count() == 0
    assert sk.quantile(0.5) == 0.0


def test_sketch_wire_round_trip_then_merge():
    rng = random.Random(11)
    t0 = time.time()
    a = QuantileSketch(window_s=300.0)
    b = QuantileSketch(window_s=300.0)
    _fill(a, [rng.uniform(0.01, 2.0) for _ in range(300)], t0)
    _fill(b, [rng.uniform(0.01, 2.0) for _ in range(300)], t0)
    # the exact /debug/slo?raw=1 path: serialize -> JSON -> deserialize
    a2 = QuantileSketch.from_wire(json.loads(json.dumps(a.to_wire())))
    b2 = QuantileSketch.from_wire(json.loads(json.dumps(b.to_wire())))
    assert a2.to_wire() == a.to_wire()
    direct = QuantileSketch(window_s=300.0).merge(a).merge(b)
    rehydrated = QuantileSketch(window_s=300.0).merge(a2).merge(b2)
    assert rehydrated.to_wire() == direct.to_wire()
    for q in (0.5, 0.9, 0.99):
        assert rehydrated.quantile(q) == direct.quantile(q)


def test_sketch_merge_rejects_mismatched_geometry():
    base = QuantileSketch(alpha=0.01, window_s=300.0)
    with pytest.raises(ValueError, match="alpha"):
        base.merge(QuantileSketch(alpha=0.02, window_s=300.0))
    with pytest.raises(ValueError, match="slice_s"):
        base.merge(QuantileSketch(alpha=0.01, window_s=60.0))


# -- LRU cardinality bound ---------------------------------------------------


def test_slo_accountant_lru_bounds_queue_cardinality():
    acct = SLOAccountant(window_s=300.0, max_queues=4)
    evicted_before = metrics.slo_evicted_queues.value()
    # seed a gauge series for the first queue so eviction can drop it
    metrics.set_slo_quantile("time_to_bind", "q0", "p50", 0.5)
    for i in range(10):
        acct.observe("time_to_bind", f"q{i}", 0.1)
    snap = acct.snapshot()
    assert sorted(snap["time_to_bind"]) == ["q6", "q7", "q8", "q9"]
    assert metrics.slo_evicted_queues.value() - evicted_before == 6
    # the evicted queue's label set left the gauge too
    assert (
        ("queue", "q0"),
        ("quantile", "p50"),
    ) not in metrics.slo_time_to_bind.samples()


def test_slo_accountant_lru_touch_protects_hot_queue():
    acct = SLOAccountant(window_s=300.0, max_queues=2)
    acct.observe("time_to_bind", "hot", 0.1)
    acct.observe("time_to_bind", "cold", 0.1)
    acct.observe("time_to_bind", "hot", 0.2)  # re-touch: hot moves newest
    acct.observe("time_to_bind", "new", 0.1)  # evicts cold, not hot
    assert sorted(acct.snapshot()["time_to_bind"]) == ["hot", "new"]


# -- KBT_FLEET off-switch discipline -----------------------------------------


def test_fleet_off_is_identity_noop(monkeypatch):
    monkeypatch.delenv(fleet.ENV, raising=False)
    fleet.configure()
    assert not fleet.enabled()
    assert fleet.refresh() is fleet.NOOP_PAYLOAD
    assert fleet.refresh(force=True) is fleet.NOOP_PAYLOAD


def test_fleet_off_overhead_is_one_branch(monkeypatch):
    """Same discipline (and budget) as obs' KBT_TRACE off-guard: the
    disabled refresh must be a bool check returning a shared dict."""
    monkeypatch.delenv(fleet.ENV, raising=False)
    fleet.configure()
    n = 20_000
    for _ in range(1000):  # warmup
        fleet.refresh()
    start = time.perf_counter()
    for _ in range(n):
        fleet.refresh()
    off_cost = (time.perf_counter() - start) / n
    assert off_cost < 5e-5, f"disabled fleet.refresh() costs {off_cost:.2e}s/call"


# -- in-process scrape -> merge drill ----------------------------------------


def test_fleet_aggregator_merges_loopback_shards():
    """Two loopback observatories (the smoke's stand-in for peer
    shards' /debug/slo?raw=1), scraped over real HTTP by a fresh
    FleetAggregator: merged quantiles match pooled raw samples, the
    conflict heatmap ranks delta'd nodes, and the fleet gauges land."""
    acct_a = SLOAccountant(window_s=300.0)
    acct_b = SLOAccountant(window_s=300.0)
    for v in (0.1, 0.2, 0.3):
        acct_a.observe("time_to_bind", "tenant0", v)
    for v in (0.4, 0.5):
        acct_b.observe("time_to_bind", "tenant0", v)
    acct_b.observe("time_to_bind", "tenant1", 1.0)

    def _counters_a():
        return {
            "federation_conflicts": {},
            "node_conflicts": {"node-a": 3.0},
            "streaming_backlog": 4,
            "binds_total": 10,
        }

    def _counters_b():
        return {
            "federation_conflicts": {},
            "node_conflicts": {"node-a": 1.0, "node-b": 2.0},
            "streaming_backlog": 6,
            "binds_total": 20,
        }

    srv_a, th_a = fleet._serve_observatory(acct_a, _counters_a)
    srv_b, th_b = fleet._serve_observatory(acct_b, _counters_b)
    urls = [
        f"http://127.0.0.1:{srv_a.server_address[1]}",
        f"http://127.0.0.1:{srv_b.server_address[1]}",
    ]
    prev = os.environ.get(fleet.ENV)
    os.environ[fleet.ENV] = ",".join(urls)
    try:
        fleet.configure()
        agg = fleet.FleetAggregator()
        payload = agg.refresh(force=True)
    finally:
        if prev is None:
            os.environ.pop(fleet.ENV, None)
        else:
            os.environ[fleet.ENV] = prev
        fleet.configure()
        for srv, th in ((srv_a, th_a), (srv_b, th_b)):
            srv.shutdown()
            srv.server_close()
            th.join(timeout=5.0)

    assert payload["enabled"] is True
    assert payload["shards_scraped"] == 2
    t0_stats = payload["slo"]["time_to_bind"]["tenant0"]
    assert t0_stats["n"] == 5
    assert t0_stats["p50"] == pytest.approx(0.3, rel=REL_BOUND)
    assert t0_stats["p99"] == pytest.approx(0.5, rel=REL_BOUND)
    t1_stats = payload["slo"]["time_to_bind"]["tenant1"]
    assert t1_stats["n"] == 1
    assert t1_stats["p50"] == pytest.approx(1.0, rel=REL_BOUND)
    # first scrape: deltas against an empty baseline are the totals
    assert payload["node_conflict_topk"] == {"node-a": 4.0, "node-b": 2.0}
    assert payload["backlog_pods"] == 10.0
    # the cluster-wide gauges carry the same numbers
    assert metrics.fleet_shards_scraped.value() == 2
    assert metrics.fleet_backlog.value() == 10.0
    assert metrics.fleet_node_conflicts.value({"node": "node-a"}) == 4.0
    assert metrics.fleet_slo_time_to_bind.value(
        {"queue": "tenant0", "quantile": "p50"}
    ) == pytest.approx(0.3, rel=REL_BOUND)


def test_fleet_aggregator_counts_dark_shards():
    prev = os.environ.get(fleet.ENV)
    # nothing listens on this port: the scrape fails, the aggregator
    # still publishes (shards_scraped=0), and nothing raises
    os.environ[fleet.ENV] = "http://127.0.0.1:9"
    try:
        fleet.configure()
        agg = fleet.FleetAggregator()
        payload = agg.refresh(force=True)
    finally:
        if prev is None:
            os.environ.pop(fleet.ENV, None)
        else:
            os.environ[fleet.ENV] = prev
        fleet.configure()
    assert payload["enabled"] is True
    assert payload["shards_scraped"] == 0
    assert payload["slo"] == {}


def test_fleet_refresh_bounded_by_hung_peer_not_stalled(monkeypatch):
    """A peer whose socket accepts but never answers (half-dead kernel,
    wedged shard) must cost one scrape timeout, not hang the refresh:
    the live shard's data still merges, the hung peer reads shard_up
    False, and the whole refresh returns within timeout + join slack.
    The admission BackpressureController reads this payload on its
    control loop — an unbounded refresh would freeze overload response
    exactly when a shard is sickest."""
    import socket

    # kernel completes the TCP handshake for a listening socket even
    # without accept(): urlopen connects fine, then waits forever for
    # the response — the exact half-dead shape a crashed-but-not-reaped
    # shard presents
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(1)

    acct = SLOAccountant(window_s=300.0)
    acct.observe("time_to_bind", "tenant0", 0.25)
    srv, th = fleet._serve_observatory(
        acct, lambda: {"federation_conflicts": {}, "node_conflicts": {},
                       "streaming_backlog": 0, "binds_total": 1},
    )
    live_url = f"http://127.0.0.1:{srv.server_address[1]}"
    hung_url = f"http://127.0.0.1:{hung.getsockname()[1]}"
    monkeypatch.setenv(fleet.ENV, f"{live_url},{hung_url}")
    monkeypatch.setenv(fleet.TIMEOUT_ENV, "0.2")
    try:
        fleet.configure()
        agg = fleet.FleetAggregator()
        t0 = time.monotonic()
        payload = agg.refresh(force=True)
        elapsed = time.monotonic() - t0
    finally:
        monkeypatch.delenv(fleet.ENV, raising=False)
        monkeypatch.delenv(fleet.TIMEOUT_ENV, raising=False)
        fleet.configure()
        srv.shutdown()
        srv.server_close()
        th.join(timeout=5.0)
        hung.close()
    # bound: per-peer timeout (scrapes run concurrently) + 1s join slack
    assert elapsed < 2.5, f"refresh stalled {elapsed:.2f}s behind a hung peer"
    assert payload["shards_scraped"] == 1
    assert payload["shard_up"][live_url] is True
    assert payload["shard_up"][hung_url] is False
    assert payload["slo"]["time_to_bind"]["tenant0"]["n"] == 1
    assert metrics.fleet_shard_up.value({"shard": hung_url}) == 0.0


# -- OpenMetrics exemplars ---------------------------------------------------


def test_exemplars_off_by_default(monkeypatch):
    monkeypatch.delenv(metrics.EXEMPLARS_ENV, raising=False)
    c = metrics.Counter("t_exemplar_off_total", "test counter")
    c.inc({"outcome": "won"}, exemplar="deadbeef")
    text = "\n".join(metrics._render_family(c))
    assert "deadbeef" not in text
    assert " # {" not in text


def test_exemplar_rides_counter_sample_line(monkeypatch):
    monkeypatch.setenv(metrics.EXEMPLARS_ENV, "1")
    c = metrics.Counter("t_exemplar_counter_total", "test counter")
    c.inc({"outcome": "won"}, exemplar="abc123")
    lines = metrics._render_family(c)
    sample = [l for l in lines if l.startswith("t_exemplar_counter_total{")]
    assert len(sample) == 1
    assert sample[0].endswith('# {trace_id="abc123"} 1.0')


def test_exemplar_rides_lowest_containing_histogram_bucket(monkeypatch):
    monkeypatch.setenv(metrics.EXEMPLARS_ENV, "1")
    h = metrics.Histogram("t_exemplar_hist", "test histogram", (0.1, 1.0))
    h.observe(0.5, exemplar="feedface")
    lines = metrics._render_family(h)
    marked = [l for l in lines if "feedface" in l]
    assert len(marked) == 1  # exactly one bucket carries it
    assert 'le="1.0"' in marked[0]  # the lowest bucket containing 0.5
    assert '# {trace_id="feedface"} 0.5' in marked[0]


def test_exemplar_storage_gated_like_rendering(monkeypatch):
    # observed while off, then rendered while on: nothing stale leaks
    monkeypatch.delenv(metrics.EXEMPLARS_ENV, raising=False)
    c = metrics.Counter("t_exemplar_gate_total", "test counter")
    c.inc(exemplar="ghost")
    monkeypatch.setenv(metrics.EXEMPLARS_ENV, "1")
    assert "ghost" not in "\n".join(metrics._render_family(c))


# -- KBT-R012: SLO kind registry ---------------------------------------------


def sf(path: str, source: str) -> SourceFile:
    return SourceFile(path, source, ast.parse(source, path))


R012_OBS = """
class SLOAccountant:
    KINDS = ("time_to_bind", "queue_wait", "ghost")
"""

R012_METRICS = """
_SLO_GAUGES = {
    "time_to_bind": slo_time_to_bind,
    "queue_wait": slo_queue_wait,
    "orphan": slo_orphan,
}
_FLEET_SLO_GAUGES = {
    "time_to_bind": fleet_slo_time_to_bind,
    "queue_wait": fleet_slo_queue_wait,
}
"""


def test_registry_slo_kinds_both_directions():
    files = [
        sf(registry_consistency.OBS_MODULE, R012_OBS),
        sf(registry_consistency.METRICS_MODULE, R012_METRICS),
    ]
    findings = []
    registry_consistency._check_slo_kind_registry(files, findings)
    assert all(f.code == "KBT-R012" for f in findings)
    syms = sorted((f.symbol, f.path) for f in findings)
    # "ghost" is a kind with no gauge entry in EITHER map (two findings,
    # anchored on obs); "orphan" is a gauge key that is not a kind
    # (anchored on metrics)
    assert syms == [
        ("slo_kind:ghost", registry_consistency.OBS_MODULE),
        ("slo_kind:ghost", registry_consistency.OBS_MODULE),
        ("slo_kind:orphan", registry_consistency.METRICS_MODULE),
    ]


def test_registry_slo_kinds_compliant_is_clean():
    files = [
        sf(registry_consistency.OBS_MODULE, 'class SLOAccountant:\n    KINDS = ("time_to_bind", "queue_wait")\n'),
        sf(
            registry_consistency.METRICS_MODULE,
            '_SLO_GAUGES = {"time_to_bind": a, "queue_wait": b}\n'
            '_FLEET_SLO_GAUGES = {"time_to_bind": c, "queue_wait": d}\n',
        ),
    ]
    findings = []
    registry_consistency._check_slo_kind_registry(files, findings)
    assert findings == []


def test_live_tree_slo_kind_registry_is_consistent():
    kinds = tuple(obs.SLOAccountant.KINDS)
    assert tuple(metrics._SLO_GAUGES) == kinds
    assert tuple(metrics._FLEET_SLO_GAUGES) == kinds


# -- measured pipeline overlap -----------------------------------------------


def test_fence_overlap_fraction_is_measured_from_windows():
    fence = pipeline.DispatchFence()
    # dispatch spans [10, 12]; the join blocks over [11, 13]: second
    # half of the dispatch was hidden behind the consumer's wait -> 0.5
    fence.record_dispatch_window(10.0, 12.0)
    fence.record_join(11.0, 13.0)
    assert fence.last_overlap_fraction == pytest.approx(0.5)
    # one sample per dispatch window: a second join does not overwrite
    fence.record_join(10.0, 14.0)
    assert fence.last_overlap_fraction == pytest.approx(0.5)
    # a join that never touched the window: full overlap
    fence.record_dispatch_window(20.0, 22.0)
    fence.record_join(23.0, 24.0)
    assert fence.last_overlap_fraction == pytest.approx(1.0)
    # a join covering the whole window: fully serialized
    fence.record_dispatch_window(30.0, 32.0)
    fence.record_join(29.0, 33.0)
    assert fence.last_overlap_fraction == pytest.approx(0.0)
    fence.reset()
    assert fence.last_overlap_fraction is None


# -- held against the JAX package ---------------------------------------------


def _payload_pair(seed: int):
    """The same samples at the same timestamps into both packages'
    sketches: two shards' raw payloads per package."""
    from kube_batch_tpu.obs import QuantileSketch as JaxSketch

    rng = random.Random(seed)
    t0 = time.time()
    out = {"port": [], "jax": []}
    for shard in range(2):
        per = {"port": {}, "jax": {}}
        for kind in ("time_to_bind", "queue_wait"):
            for queue in ("tenant0", "tenant1"):
                values = [rng.lognormvariate(-1.5, 1.0) for _ in range(200)]
                for name, cls in (("port", QuantileSketch), ("jax", JaxSketch)):
                    sk = cls(window_s=300.0)
                    _fill(sk, values, t0)
                    per[name].setdefault(kind, {})[queue] = sk.to_wire()
        counters = {
            "federation_conflicts": {},
            "node_conflicts": {f"n{shard}": 2.0 + shard, "n9": 1.0},
            "streaming_backlog": 3 + shard,
            "binds_total": 40 * (shard + 1),
        }
        for name in ("port", "jax"):
            out[name].append({"alpha": 0.01, "window_s": 300.0, "kinds": per[name],
                              "counters": dict(counters), "pid": 1})
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_wire_form_equals_the_jax_sketch(seed):
    pair = _payload_pair(seed)
    assert json.dumps(pair["port"], sort_keys=True) == json.dumps(pair["jax"], sort_keys=True)


@pytest.mark.parametrize("seed", [1, 2])
def test_rollup_equals_the_jax_aggregator_over_the_same_payloads(seed, monkeypatch):
    """Both packages' aggregators merge the same raw payloads: the merged
    quantiles, the conflict heatmap, the backlog and the reachability are
    equal (the scrape ages are wall-clock and only checked for sign)."""
    from kube_batch_tpu.obs import fleet as jax_fleet

    pair = _payload_pair(seed)
    peers = ["http://a:1", "http://b:2"]
    out = {}
    for name, mod in (("port", fleet), ("jax", jax_fleet)):
        monkeypatch.setenv(mod.ENV, ",".join(peers))
        mod.configure()
        try:
            agg = mod.FleetAggregator()
            out[name] = agg._merge(peers, peers[:1], pair[name])
        finally:
            monkeypatch.delenv(mod.ENV, raising=False)
            mod.configure()
    for p in (out["port"], out["jax"]):
        ages = p.pop("shard_scrape_age_s")
        assert ages["http://b:2"] == -1.0 and ages["http://a:1"] >= 0.0
    assert json.dumps(out["port"], sort_keys=True) == json.dumps(out["jax"], sort_keys=True)
    assert out["port"]["shard_up"] == {"http://a:1": True, "http://b:2": False}


def test_fleet_smoke_passes_on_the_cpu():
    """Two loopback shards on the CPU: merged p50/p90/p99 within the
    sketch's declared error of the pooled samples, exact counts, every pod
    bound once, fsck clean, and the killed observatory reads dark."""
    result = fleet.smoke(shards=2, device="cpu")
    assert result["ok"], result


# -- arena HBM accounting ----------------------------------------------------


def test_arena_accounts_hbm_bytes_and_watermark():
    """The tensor arena's per-slab bytes and watermark, in its own
    accounting and in the ``arena_hbm_bytes{slab}`` /
    ``arena_hbm_watermark_bytes`` gauges, equal the JAX arena's over the
    same views."""
    import numpy as np

    from kube_batch_tpu import metrics as jax_metrics
    from kube_batch_tpu.ops.encode_cache import TensorArena as JaxArena

    from kube_batch_tpu_torch.ops.encode_cache import TensorArena

    arena, ref = TensorArena("cpu"), JaxArena()
    arrays = {
        "node_idle": np.ones((8, 4), dtype=np.float32),
        "task_req": np.ones((3, 4), dtype=np.float32),
    }
    for a in (arena, ref):
        a.device_view(arrays)
    by_slab = arena.hbm_bytes_by_slab()
    assert by_slab == ref.hbm_bytes_by_slab()
    assert by_slab["node_idle"] == 8 * 4 * 4
    assert by_slab["task_req"] == 3 * 4 * 4
    total = sum(by_slab.values())
    assert arena.hbm_watermark_bytes == total
    assert metrics.arena_hbm_watermark.value() == total == jax_metrics.arena_hbm_watermark.value()
    assert metrics.arena_hbm_bytes.value({"slab": "node_idle"}) == 8 * 4 * 4
    assert "kube_batch_tpu_arena_hbm_watermark_bytes " in metrics.render_prometheus_text()
    # a second identical view reuses the buffers: the watermark is stable
    arena.device_view(arrays)
    assert arena.hbm_watermark_bytes == total
    arena.clear()
    assert arena.hbm_bytes_by_slab() == {}
    assert arena.hbm_watermark_bytes == 0
