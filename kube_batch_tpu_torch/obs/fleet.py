"""Fleet observatory: cross-shard SLO aggregation (``KBT_FLEET``).

Every other metric surface is per process, while the number a federation
is judged by is an *aggregate* p99 across N shards, and percentiles do
not average. This module is the composable path: each shard's
``SLOAccountant`` keeps mergeable :class:`~kube_batch_tpu_torch.obs.QuantileSketch`
rings and serves them serialized on ``/debug/slo?raw=1``; a
:class:`FleetAggregator` (running inside any scheduler, or standalone
via ``server.py --fleet``) scrapes its peers, merges the sketches —
cell-for-cell equivalent to sketching the pooled samples — and
publishes cluster-wide gauges:

- ``kube_batch_tpu_fleet_slo_{time_to_bind,queue_wait}_seconds``
  (labels: queue, quantile) — the merged sliding-window percentiles;
- ``kube_batch_tpu_fleet_node_conflicts`` — a top-K heatmap of
  contended nodes from ``federation_node_conflicts_total`` deltas
  between scrapes;
- ``kube_batch_tpu_fleet_backlog_pods`` / ``..._pods_per_second`` /
  ``..._shards_scraped`` — aggregate backlog, bind throughput from
  bind-count deltas, and scrape reachability;
- ``kube_batch_tpu_fleet_shard_up{shard}`` /
  ``..._fleet_shard_last_scrape_age_seconds{shard}`` — per-peer
  reachability and staleness (the dead-shard signal).

Off by default, same single-branch discipline as ``KBT_TRACE``: when
``KBT_FLEET`` is empty/off, :func:`refresh` is one bool check returning
the shared :data:`NOOP_PAYLOAD`. Arm it with ``KBT_FLEET`` set to a
comma-separated list of peer base URLs (``http://host:port``), or the
hot-reloadable conf ``fleet:`` key.

The rollup is host work (HTTP scrapes and dict merges); the shards it
scrapes solve on the card. Self-check: ``python -m
kube_batch_tpu_torch.obs.fleet [--device cpu] --json`` runs N live
loopback shards (the real ``LoopbackBackend`` wire path against a store
arbiter, ``torch_allocate`` solving on ``device``), feeds per-shard
accountants from store bind events, scrapes them over real HTTP, and
checks the merged p50/p90/p99 agree with the pooled raw samples within
the sketch's declared relative error, plus exactly-once binds and a clean
fsck.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.obs import _OFF_WORDS, _QUANTILES, QuantileSketch, SLOAccountant

__all__ = [
    "ENV",
    "NOOP_PAYLOAD",
    "enabled",
    "peers",
    "configure",
    "raw_slo_payload",
    "FleetAggregator",
    "aggregator",
    "refresh",
    "smoke",
    "main",
]

log = logging.getLogger(__name__)

ENV = "KBT_FLEET"
TIMEOUT_ENV = "KBT_FLEET_SCRAPE_TIMEOUT_S"
STALE_ENV = "KBT_FLEET_STALE_S"

_enabled = False
_peers: tuple[str, ...] = ()


def scrape_timeout_s() -> float:
    """Per-peer scrape timeout. Scrapes run concurrently, so one hung
    peer delays a refresh by at most this bound — not N x this bound."""
    try:
        return max(0.05, float(os.environ.get(TIMEOUT_ENV, "") or 3.0))
    except ValueError:
        return 3.0


def stale_cap_s() -> float:
    """Age cap on reusing a dark peer's last good payload in the merge.
    Within the cap a transient scrape miss does not yank that shard's
    samples out of the merged gauges; past it the shard's contribution
    ages out entirely (the conservative read for a dead shard)."""
    try:
        return max(0.0, float(os.environ.get(STALE_ENV, "") or 30.0))
    except ValueError:
        return 30.0

# The shared disabled result: refresh() returns this singleton when
# KBT_FLEET is off — identity-testable, same contract as obs.NOOP_SPAN.
NOOP_PAYLOAD: dict = {"enabled": False}


def enabled() -> bool:
    return _enabled


def peers() -> tuple[str, ...]:
    return _peers


def configure(spec=None) -> bool:
    """(Re)resolve the fleet switch. ``spec`` is the conf ``fleet:``
    value — empty/None defers to ``KBT_FLEET``. The value is a
    comma-separated list of peer base URLs; any off-word disables.
    Hot-reloadable: the scheduler calls this from its conf-reload path
    every cycle, same as obs.configure/explain.configure."""
    global _enabled, _peers
    if spec is None or str(spec).strip() == "":
        raw = os.environ.get(ENV, "").strip()
    else:
        raw = str(spec).strip()
    if raw.lower() in _OFF_WORDS:
        on, peer_list = False, ()
    else:
        peer_list = tuple(p.strip() for p in raw.split(",") if p.strip())
        on = bool(peer_list)
    if on != _enabled:
        log.info(
            "fleet aggregation %s (%d peers)",
            "enabled" if on else "disabled", len(peer_list),
        )
    _enabled = on
    _peers = peer_list
    return on


# -- the wire form ------------------------------------------------------------


def _counters_snapshot() -> dict:
    """The key counters a fleet aggregator needs alongside the
    sketches, from this process's metric registry."""
    return {
        "federation_conflicts": {
            dict(key).get("outcome", ""): value
            for key, value in metrics.federation_conflicts.samples().items()
        },
        "node_conflicts": {
            dict(key).get("node", ""): value
            for key, value in metrics.federation_node_conflicts.samples().items()
        },
        "streaming_backlog": metrics.streaming_backlog.value(),
        "binds_total": metrics.task_scheduling_latency.snapshot()["count"],
    }


def raw_slo_payload(accountant: SLOAccountant | None = None,
                    counters: dict | None = None) -> dict:
    """The ``/debug/slo?raw=1`` body: this process's serialized SLO
    sketches plus the counters the fleet aggregator rolls up. The
    smoke's loopback observatories serve per-shard accountants through
    the same function, so the wire form is literally shared code."""
    from kube_batch_tpu_torch import obs as _obs

    acct = accountant if accountant is not None else _obs.slo
    payload = acct.raw()
    payload["counters"] = counters if counters is not None else _counters_snapshot()
    payload["pid"] = os.getpid()
    return payload


# -- the aggregator -----------------------------------------------------------


class FleetAggregator:
    """Scrapes peer shards' ``/debug/slo?raw=1``, merges their sketches
    and counters, and publishes the cluster-wide ``fleet_*`` gauges.
    Scrape-on-demand (no thread): the server's /metrics handler calls
    :func:`refresh`, internally rate-limited to ``min_interval_s``."""

    TOPK = 8
    MIN_INTERVAL_S = 1.0

    def __init__(self, topk: int | None = None,
                 min_interval_s: float | None = None) -> None:
        self.topk = int(topk if topk is not None else self.TOPK)
        self.min_interval_s = float(
            min_interval_s if min_interval_s is not None else self.MIN_INTERVAL_S
        )
        self._lock = threading.Lock()
        self._last_mono = 0.0  #: guarded_by _lock
        self._prev_nodes: dict[str, float] = {}  #: guarded_by _lock
        self._prev_binds: float | None = None  #: guarded_by _lock
        self._prev_binds_mono = 0.0  #: guarded_by _lock
        self._last_seen: dict[str, float] = {}  #: guarded_by _lock (peer url -> last good scrape)
        self._payload_cache: dict[str, tuple[float, dict]] = {}  #: guarded_by _lock
        self.last: dict = {}  #: guarded_by _lock

    def scrape(self, base_url: str, timeout: float | None = None) -> dict | None:
        url = base_url.rstrip("/") + "/debug/slo?raw=1"
        if timeout is None:
            timeout = scrape_timeout_s()
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except (OSError, ValueError) as e:
            log.error("fleet: scrape of %s failed: %s", url, e)
            return None

    def reset(self) -> None:
        with self._lock:
            self._last_mono = 0.0
            self._prev_nodes = {}
            self._prev_binds = None
            self._prev_binds_mono = 0.0
            self._last_seen = {}
            self._payload_cache = {}
            self.last = {}
        metrics.fleet_shard_up.clear()
        metrics.fleet_shard_scrape_age.clear()

    def refresh(self, force: bool = False) -> dict:
        if not _enabled:
            return NOOP_PAYLOAD
        with self._lock:
            now = time.monotonic()
            if not force and self.last and now - self._last_mono < self.min_interval_s:
                return self.last
            self._last_mono = now
        peer_list = _peers
        # Scrape OUTSIDE the lock (blocking I/O) and CONCURRENTLY: one
        # hung peer bounds the refresh by the per-peer timeout, not by
        # peers x timeout — the publish loop and the admission
        # controller's input snapshot must not stall on a dark shard.
        timeout = scrape_timeout_s()
        results: dict[str, dict | None] = {}
        workers = [
            threading.Thread(
                target=lambda p=peer: results.__setitem__(p, self.scrape(p, timeout)),
                name="kb-fleet-scrape", daemon=True,
            )
            for peer in peer_list
        ]
        for worker in workers:
            worker.start()
        deadline = time.monotonic() + timeout + 1.0
        for worker in workers:
            worker.join(timeout=max(0.0, deadline - time.monotonic()))
        reached: list[str] = []
        payloads: list[dict] = []
        now = time.monotonic()
        cap = stale_cap_s()
        with self._lock:
            for peer in peer_list:
                data = results.get(peer)
                if data is not None:
                    reached.append(peer)
                    payloads.append(data)
                    self._payload_cache[peer] = (now, data)
                    continue
                cached = self._payload_cache.get(peer)
                if cached is not None and now - cached[0] <= cap:
                    # transient miss: keep the last good payload in the
                    # merge (reachability gauges still flip to dark) so
                    # merged quantiles don't lurch on one missed scrape
                    payloads.append(cached[1])
        return self._merge(peer_list, reached, payloads)

    def _merge(self, peer_list, reached, payloads) -> dict:
        # 1. sketches: cell-wise merge per kind x queue — the result is
        # identical to one sketch fed every shard's samples.
        merged: dict[str, dict[str, QuantileSketch]] = {}
        for data in payloads:
            for kind, per_queue in (data.get("kinds") or {}).items():
                target = merged.setdefault(kind, {})
                for queue, wire in per_queue.items():
                    sk = QuantileSketch.from_wire(wire)
                    if queue in target:
                        target[queue].merge(sk)
                    else:
                        target[queue] = sk
        slo_out: dict[str, dict] = {}
        for kind, per_queue in merged.items():
            slo_out[kind] = {}
            for queue, sk in per_queue.items():
                sk.trim()
                n = sk.count()
                if n == 0:
                    continue
                stats: dict = {"n": n}
                for label, q in _QUANTILES:
                    stats[label] = sk.quantile(q)
                    metrics.set_fleet_slo_quantile(kind, queue, label, stats[label])
                slo_out[kind][queue] = stats
        # 2. counters: node-conflict deltas since the previous scrape
        # (top-K heatmap), backlog sum, bind-throughput from deltas.
        node_totals: dict[str, float] = {}
        backlog = 0.0
        binds = 0.0
        for data in payloads:
            counters = data.get("counters") or {}
            for node, value in (counters.get("node_conflicts") or {}).items():
                node_totals[node] = node_totals.get(node, 0.0) + float(value)
            backlog += float(counters.get("streaming_backlog") or 0.0)
            binds += float(counters.get("binds_total") or 0.0)
        now = time.monotonic()
        with self._lock:
            # per-shard reachability: up 0/1 plus seconds since the last
            # good scrape (-1 = never reached) — the fleet-level "is that
            # shard dead" signal the resharding runbook's triage starts
            # from (a shard can be down while its slot lease is still
            # ticking out)
            reached_set = set(reached)
            shard_up: dict[str, bool] = {}
            scrape_age: dict[str, float] = {}
            for peer in peer_list:
                up = peer in reached_set
                shard_up[peer] = up
                if up:
                    self._last_seen[peer] = now
                seen = self._last_seen.get(peer)
                scrape_age[peer] = (now - seen) if seen is not None else -1.0
            deltas = {
                node: value - self._prev_nodes.get(node, 0.0)
                for node, value in node_totals.items()
            }
            top = dict(sorted(
                ((node, d) for node, d in deltas.items() if d > 0),
                key=lambda kv: (-kv[1], kv[0]),
            )[: self.topk])
            pods_per_s = 0.0
            if self._prev_binds is not None and now > self._prev_binds_mono:
                pods_per_s = max(
                    0.0, (binds - self._prev_binds) / (now - self._prev_binds_mono)
                )
            self._prev_nodes = node_totals
            self._prev_binds = binds
            self._prev_binds_mono = now
            payload = {
                "enabled": True,
                "peers": list(peer_list),
                "shards_scraped": len(reached),
                "shard_up": shard_up,
                "shard_scrape_age_s": scrape_age,
                "slo": slo_out,
                "node_conflict_topk": top,
                "backlog_pods": backlog,
                "pods_per_second": pods_per_s,
            }
            self.last = payload
        metrics.set_fleet_node_heatmap(top)
        metrics.set_fleet_backlog(backlog)
        metrics.set_fleet_pods_per_second(pods_per_s)
        metrics.set_fleet_shards_scraped(len(reached))
        for peer in peer_list:
            metrics.set_fleet_shard_up(peer, shard_up[peer])
            metrics.set_fleet_shard_scrape_age(peer, scrape_age[peer])
        return payload


aggregator = FleetAggregator()


def refresh(force: bool = False) -> dict:
    """The one fleet entry point hot paths call (server /metrics and
    /debug/fleet). One branch when off."""
    if not _enabled:
        return NOOP_PAYLOAD
    return aggregator.refresh(force=force)


# -- smoke --------------------------------------------------------------------


def _serve_observatory(accountant: SLOAccountant, counters_fn):
    """A loopback HTTP server exposing one accountant through the SAME
    raw_slo_payload function server.py uses — the smoke's stand-in for a
    peer shard's /debug/slo?raw=1 (in-process shards share the module
    global obs.slo, so each needs its own accountant to be a distinct
    scrape target)."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            if self.path.startswith("/debug/slo"):
                body = json.dumps(
                    raw_slo_payload(accountant=accountant, counters=counters_fn()),
                    sort_keys=True,
                ).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def smoke(shards: int = 2, gangs: int = 8, members: int = 3,
          nodes: int = 10, device: str = "cuda") -> dict:
    """Fleet aggregation end to end (``python -m
    kube_batch_tpu_torch.obs.fleet``), the shards' ``torch_allocate``
    solving on ``device``:

    1. run a seeded ``shards``-way federated world over live
       LoopbackBackends against a real SchedulerServer store arbiter;
    2. feed one SLOAccountant PER SHARD from store bind events (routed
       by the same crc32 gang-shard rule the schedulers use), keeping
       every raw sample as pooled ground truth;
    3. serve each accountant on its own loopback observatory, arm
       ``KBT_FLEET`` with those URLs, and drive the real scrape→
       deserialize→merge path twice (baseline + final);
    4. assert merged cluster-wide p50/p90/p99 agree with pooled-raw
       nearest-rank ground truth within the sketch's declared relative
       error, exact sample counts match, every pod bound exactly once,
       fsck is clean, and the throughput gauge moved;
    5. kill one observatory and re-scrape: ``fleet_shard_up`` must flip
       to 0 for exactly the killed peer (survivors stay up) and its
       last-scrape age must start growing.
    """
    import threading as _threading

    from kube_batch_tpu_torch.cache import EventHandler, LoopbackBackend
    from kube_batch_tpu_torch.cache.store import PODS
    from kube_batch_tpu_torch.federation import (
        FederatedCache,
        _seed_world,
        _wait_all_bound,
        fsck,
        shard_index,
        shard_key_of,
        write_conf,
    )
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.server import SchedulerServer
    from kube_batch_tpu_torch.streaming import _check_device

    _check_device(device)
    total = gangs * members
    alpha = QuantileSketch.DEFAULT_ALPHA
    # the scheduler's default pipeline with torch_allocate on `device`; the
    # arbiter's own loop is idle (unmatched scheduler name)
    conf_path = write_conf(device)
    server = SchedulerServer(
        scheduler_name="fleet-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=conf_path, schedule_period=60.0,
    )
    server.start()

    accountants = [SLOAccountant(window_s=300.0) for _ in range(shards)]
    pooled: dict[str, list[float]] = {}
    shard_binds = [0] * shards
    bind_counts: dict[str, int] = {}
    t0: dict[str, float] = {}
    state_lock = _threading.Lock()

    def _queue_of(pod_name: str) -> str:
        # fg{g}-p{m} -> two synthetic tenants, so the merge is checked
        # across queues, not just on one label set
        try:
            g = int(pod_name.split("-")[0][2:])
        except ValueError:
            g = 0
        return f"tenant{g % 2}"

    def _on_bind(old, new) -> None:
        if old.node_name or not new.node_name:
            return
        key = f"{new.namespace}/{new.name}"
        now = time.perf_counter()
        with state_lock:
            bind_counts[key] = bind_counts.get(key, 0) + 1
            seconds = now - t0.get(key, now)
            queue = _queue_of(new.name)
            # mode "gang" never touches the store — safe inside a store
            # event callback
            sh = shard_index(shard_key_of(new, None, "gang"), shards)
            accountants[sh].observe("time_to_bind", queue, seconds)
            accountants[sh].observe("queue_wait", queue, seconds)
            pooled.setdefault(queue, []).append(seconds)
            shard_binds[sh] += 1

    server.store.add_event_handler(PODS, EventHandler(on_update=_on_bind))

    observatories = []
    urls = []
    for i in range(shards):
        def _counters(i=i) -> dict:
            with state_lock:
                mine = shard_binds[i]
            # the process-global conflict counters are served once (from
            # shard 0) — every in-process scheduler shares one registry,
            # and double-counting them would corrupt the rollup
            node_conflicts = {
                dict(key).get("node", ""): value
                for key, value in
                metrics.federation_node_conflicts.samples().items()
            } if i == 0 else {}
            return {
                "federation_conflicts": {},
                "node_conflicts": node_conflicts,
                "streaming_backlog": 0,
                "binds_total": mine,
            }

        srv, thread = _serve_observatory(accountants[i], _counters)
        observatories.append((srv, thread))
        urls.append(f"http://127.0.0.1:{srv.server_address[1]}")

    prev_env = os.environ.get(ENV)
    os.environ[ENV] = ",".join(urls)
    configure()
    aggregator.reset()

    backends: list = []
    scheds: list = []
    stop = _threading.Event()
    try:
        _seed_world(server.store, gangs, members, nodes)
        arrival = time.perf_counter()
        with state_lock:
            for pod in server.store.list(PODS):
                t0[f"{pod.namespace}/{pod.name}"] = arrival
        # baseline scrape before any bind, so the final refresh's
        # pods-per-second delta covers the whole run
        aggregator.refresh(force=True)
        base = f"http://127.0.0.1:{server.listen_port}"
        for i in range(shards):
            backend = LoopbackBackend(base)
            cache = FederatedCache(
                backend, shard=i, shards=shards, shard_key="gang",
                staleness_fn=backend.snapshot_age,
            )
            cache.run()
            backend.start(period=0.02)
            backends.append(backend)
            sched = Scheduler(cache, scheduler_conf=conf_path, schedule_period=0.05)
            thread = _threading.Thread(
                target=sched.run, args=(stop,), name=f"kb-fleet-{i}", daemon=True
            )
            thread.start()
            scheds.append((sched, thread))
        all_bound = _wait_all_bound(server.store, total, deadline_s=60.0)
        payload = aggregator.refresh(force=True)
        # kill one shard's observatory and re-scrape: the per-shard
        # reachability gauges must flip (up -> 0, scrape age starts
        # growing) while the survivors stay up
        killed_url = urls[-1]
        srv_k, thread_k = observatories.pop()
        srv_k.shutdown()
        srv_k.server_close()
        thread_k.join(timeout=5.0)
        down_payload = aggregator.refresh(force=True)
    finally:
        stop.set()
        for _, thread in scheds:
            thread.join(timeout=10.0)
        for backend in backends:
            backend.stop()
        for sched, _ in scheds:
            sched.cache.stop()
        server.stop()
        for srv, thread in observatories:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=5.0)
        if prev_env is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = prev_env
        configure()
        os.unlink(conf_path)

    # merged vs pooled-raw ground truth, per queue, nearest-rank rule
    import math as _math

    compare: dict[str, dict] = {}
    max_rel_err = 0.0
    counts_match = True
    merged_slo = payload.get("slo", {}).get("time_to_bind", {})
    with state_lock:
        pooled_now = {q: sorted(vals) for q, vals in pooled.items()}
    for queue, values in pooled_now.items():
        n = len(values)
        got = merged_slo.get(queue)
        if got is None or got.get("n") != n:
            counts_match = False
            continue
        compare[queue] = {}
        for label, q in _QUANTILES:
            exact = values[min(n - 1, max(0, _math.ceil(q * n) - 1))]
            merged_v = got[label]
            rel = abs(merged_v - exact) / exact if exact > 0 else 0.0
            compare[queue][label] = {
                "merged": merged_v, "pooled": exact, "rel_err": rel,
            }
            max_rel_err = max(max_rel_err, rel)

    exactly_once = all_bound and sorted(bind_counts.values()) == [1] * total
    violations = fsck(server.store)
    within_bound = bool(compare) and max_rel_err <= alpha * 1.05 + 1e-9

    # killed-shard detection: every shard up before the kill; after it,
    # exactly the killed one reports down — in the payload AND in the
    # published fleet_shard_up gauge — with its scrape age now growing
    up_before = payload.get("shard_up", {})
    up_after = down_payload.get("shard_up", {})
    age_after = down_payload.get("shard_scrape_age_s", {})
    gauge_up = {
        dict(key).get("shard", ""): value
        for key, value in metrics.fleet_shard_up.samples().items()
    }
    killed_shard_detected = bool(
        all(up_before.get(u) for u in urls)
        and up_after.get(killed_url) is False
        and all(up_after.get(u) for u in urls if u != killed_url)
        and gauge_up.get(killed_url) == 0.0
        and age_after.get(killed_url, -1.0) >= 0.0
    )

    out = {
        "device": device,
        "shards": shards,
        "pods": total,
        "bound": sum(bind_counts.values()),
        "exactly_once": exactly_once,
        "fsck_violations": violations,
        "shards_scraped": payload.get("shards_scraped", 0),
        "queues": sorted(pooled_now),
        "alpha": alpha,
        "max_rel_err": max_rel_err,
        "rel_err_bound": alpha * 1.05,
        "within_bound": within_bound,
        "counts_match": counts_match,
        "slo_compare": compare,
        "pods_per_second": payload.get("pods_per_second", 0.0),
        "backlog_pods": payload.get("backlog_pods", 0.0),
        "node_conflict_topk": payload.get("node_conflict_topk", {}),
        "scraped_after_kill": down_payload.get("shards_scraped", 0),
        "killed_shard_detected": killed_shard_detected,
    }
    out["ok"] = bool(
        all_bound
        and exactly_once
        and not violations
        and out["shards_scraped"] == shards
        and out["scraped_after_kill"] == shards - 1
        and killed_shard_detected
        and counts_match
        and within_bound
        and out["pods_per_second"] > 0.0
    )
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="fleet observability smoke: N loopback shards scraped "
        "and merged, cluster-wide quantiles checked against pooled raw "
        "samples within the sketch's relative-error bound"
    )
    parser.add_argument("--shards", type=int, default=2)
    parser.add_argument("--gangs", type=int, default=8)
    parser.add_argument("--members", type=int, default=3)
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the shards' torch_allocate solves (default: the card)",
    )
    parser.add_argument(
        "--json", action="store_true", help="print the result dict as JSON"
    )
    args = parser.parse_args(argv)
    result = smoke(shards=args.shards, gangs=args.gangs, members=args.members, device=args.device)
    if args.json:
        print(json.dumps(result, sort_keys=True, default=str))
    else:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"fleet smoke: {status} ({result['bound']}/{result['pods']} pods "
            f"across {result['shards']} shards, scraped="
            f"{result['shards_scraped']}, max_rel_err="
            f"{result['max_rel_err']:.4f} (alpha={result['alpha']}), "
            f"pods_per_second={result['pods_per_second']:.1f}, "
            f"fsck={'clean' if not result['fsck_violations'] else result['fsck_violations']})"
        )
    return 0 if result["ok"] else 1


configure()


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` runs this file as
    # __main__, whose module state would otherwise differ from the one
    # other modules import
    from kube_batch_tpu_torch.obs.fleet import main as _canonical_main

    raise SystemExit(_canonical_main())
