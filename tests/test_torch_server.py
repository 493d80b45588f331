"""The port as a process — `kube_batch_tpu_torch.server.SchedulerServer`
(store, cache, the `Scheduler.run` loop and the HTTP surface) and
`kube_batch_tpu_torch.cli` — against the JAX package's, on the cases of
tests/test_scheduler.py this slice covers.

Both servers get the same requests and the same store events. Their
binds, HTTP status codes, list payloads (``/apis/v1alpha1/<kind>``), watch
events, CLI output and the values of the series both expose must be
equal. The JAX server runs its default pipeline (``enqueue, allocate,
backfill``; the serial allocate), the port's its own default with
``device: cpu`` (``enqueue, torch_allocate, backfill``, the kernel's
plain version); the example confs run against their JAX twins.
``/metrics`` as a whole is not compared: the JAX server exposes series of
layers the port does not have yet.
"""

from __future__ import annotations

import io
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kube_batch_tpu.testing import x64_enabled

from test_torch_store import JAX, PORT, store_contents, wait_until

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ARGS = "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n"


def port_default_conf(tmp_path) -> str:
    path = tmp_path / "port-default.yaml"
    path.write_text(PORT.sched.DEFAULT_SCHEDULER_CONF + CPU_ARGS)
    return str(path)


def example(name: str, tmp_path=None, cpu: bool = False) -> str:
    path = os.path.join(ROOT, "examples", name)
    if not cpu:
        return path
    copy = tmp_path / f"cpu-{name}"
    with open(path) as f:
        copy.write_text(f.read() + CPU_ARGS)
    return str(copy)


class Client:
    """HTTP against one server: every call returns (status, payload)."""

    def __init__(self, srv):
        self.srv = srv
        self.base = f"http://127.0.0.1:{srv.listen_port}"

    def call(self, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base + path, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, raw = resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read().decode()
        try:
            return status, json.loads(raw)
        except ValueError:
            return status, raw

    def get(self, path):
        return self.call("GET", path)

    def post(self, path, body):
        return self.call("POST", path, body)

    def delete(self, path):
        return self.call("DELETE", path)

    def items(self, kind):
        status, payload = self.get(f"/apis/v1alpha1/{kind}")
        assert status == 200
        return sorted(payload["items"], key=lambda i: json.dumps(i, sort_keys=True))


class Twin:
    """One JAX server and one port server, started on ephemeral ports;
    ``each(fn)`` runs fn(client) on both and returns (jax, port)."""

    def __init__(self, tmp_path, jax_conf=None, port_conf=None, period=0.05, seed=None):
        self.servers = {}
        for P, conf in ((JAX, jax_conf), (PORT, port_conf or port_default_conf(tmp_path))):
            store = P.store.ClusterStore()
            if seed is not None:
                seed(P, store)
            self.servers[P.name] = P.server.SchedulerServer(
                listen_address="127.0.0.1:0", schedule_period=period, scheduler_conf=conf, store=store
            )
        self.jax = Client(self.servers[JAX.name])
        self.port = Client(self.servers[PORT.name])

    def __enter__(self):
        # the production float32 policy for the JAX loop's device rungs
        # too: the flag is process-wide, so it holds on the loop thread
        self._x64 = x64_enabled(False)
        self._x64.__enter__()
        for srv in self.servers.values():
            srv.start()
        return self

    def __exit__(self, *exc):
        for srv in self.servers.values():
            srv.stop()
        self._x64.__exit__(*exc)

    def each(self, fn):
        return fn(self.jax, JAX), fn(self.port, PORT)

    def same(self, fn):
        jax, port = self.each(fn)
        assert port == jax
        return port

    def settle(self, pred, what, timeout=30.0):
        for c in (self.jax, self.port):
            wait_until(lambda: pred(c.srv.store), timeout=timeout, what=f"{what} ({type(c.srv).__module__})")

    def cycles(self, n: int) -> None:
        """Wait for ``n`` more cycles on each server: status write-backs
        then stand where a settled loop leaves them."""
        for c in (self.jax, self.port):
            start = c.srv.cache.cycle
            wait_until(lambda: c.srv.cache.cycle >= start + n, what=f"{n} more cycles")


def series(text: str, family: str) -> dict:
    """One family's samples of an exposition: ``{labels}`` -> value."""
    name = f"kube_batch_tpu_{family}"
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, value = line[len(name):].rsplit(" ", 1)
            out[key] = float(value)
    return out


def all_bound(store):
    return all(p.node_name for p in store.list("pods"))


def pods_state(store):
    return sorted((p.metadata.name, p.node_name) for p in store.list("pods"))


# -- the loop against a live, mutating cluster --------------------------------


def test_loop_schedules_live_mutating_cluster(tmp_path):
    with Twin(tmp_path) as tw:
        def first(c, P):
            t, s = P.t, c.srv.store
            for i in range(2):
                s.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
            s.create_pod_group(t.build_pod_group("job-a", min_member=2))
            for i in range(2):
                s.create_pod(t.build_pod(name=f"a{i}", group_name="job-a",
                                         req=t.build_resource_list(cpu=1, memory="1Gi")))

        tw.each(first)
        tw.settle(all_bound, "first gang bound")
        tw.same(lambda c, P: pods_state(c.srv.store))

        def second(c, P):
            t, s = P.t, c.srv.store
            s.create_pod_group(t.build_pod_group("job-b", min_member=3))
            for i in range(3):
                s.create_pod(t.build_pod(name=f"b{i}", group_name="job-b",
                                         req=t.build_resource_list(cpu=1, memory="1Gi")))

        tw.each(second)
        tw.settle(all_bound, "second gang bound")
        assert len(tw.same(lambda c, P: pods_state(c.srv.store))) == 5
        tw.same(lambda c, P: c.items("pods"))


def test_gang_larger_than_cluster_stays_pending(tmp_path):
    with Twin(tmp_path) as tw:
        def seed(c, P):
            t, s = P.t, c.srv.store
            s.create_node(t.build_node("n0", t.build_resource_list(cpu=2, pods=10)))
            s.create_pod_group(t.build_pod_group("big", min_member=3))
            for i in range(3):
                s.create_pod(t.build_pod(name=f"g{i}", group_name="big", req=t.build_resource_list(cpu=2)))

        tw.each(seed)
        tw.cycles(3)
        assert all(not node for _, node in tw.same(lambda c, P: pods_state(c.srv.store)))
        tw.same(lambda c, P: c.items("podgroups"))
        # a series both servers expose, written by the gang plugin each cycle
        key = '{job_id="big"}'
        assert tw.same(lambda c, P: series(c.get("/metrics")[1], "unschedule_task_count").get(key)) == 2.0


def test_metrics_endpoint_scrapes_live_latencies(tmp_path):
    with Twin(tmp_path) as tw:
        wait_until(lambda: PORT.metrics.schedule_attempts.value() > 0, what="first cycle")
        status, body = tw.port.get("/metrics")
        assert status == 200
        assert "kube_batch_tpu_e2e_scheduling_latency_count" in body
        line = next(ln for ln in body.splitlines() if ln.startswith("kube_batch_tpu_e2e_scheduling_latency_count"))
        assert float(line.split()[-1]) > 0
        assert 'action="torch_allocate"' in body and 'action="enqueue"' in body
        _, jax_body = tw.jax.get("/metrics")
        families = {ln.split()[2] for ln in body.splitlines() if ln.startswith("# HELP ")}
        jax_families = {ln.split()[2] for ln in jax_body.splitlines() if ln.startswith("# HELP ")}
        assert families <= jax_families, families - jax_families
        # each family the port exposes carries the JAX package's help and type
        meta = {ln for ln in body.splitlines() if ln.startswith(("# HELP ", "# TYPE "))}
        jax_meta = {ln for ln in jax_body.splitlines() if ln.startswith(("# HELP ", "# TYPE "))}
        assert meta <= jax_meta, meta - jax_meta
        for name in ("write_retries_total", "cache_mutation_violations_total", "resync_dropped_total",
                     "stale_cycles_skipped_total", "watch_longpoll_wakeups_total"):
            assert f"kube_batch_tpu_{name}" in families


def test_healthz_version_and_debug_endpoints(tmp_path):
    with Twin(tmp_path) as tw:
        assert tw.same(lambda c, P: c.get("/healthz")) == (200, "ok")
        status, body = tw.same(lambda c, P: c.get("/version"))
        assert status == 200 and "API Version: v1alpha1" in body
        assert tw.same(lambda c, P: sorted(c.get("/debug/trace")[1])) == ["enabled", "spans", "traces"]
        tw.same(lambda c, P: c.get("/debug/slo")[0])
        tw.same(lambda c, P: c.get("/no/such/path"))


def test_queue_api_crud(tmp_path):
    with Twin(tmp_path) as tw:
        assert tw.same(lambda c, P: c.post("/apis/v1alpha1/queues", {"name": "research", "weight": 4}))[0] == 201
        items = tw.same(lambda c, P: c.items("queues"))
        assert {q["name"]: q["weight"] for q in items} == {"default": 1, "research": 4}
        for c in (tw.jax, tw.port):
            wait_until(lambda: "research" in c.srv.cache.queues, what="queue in cache")
        tw.same(lambda c, P: c.post("/apis/v1alpha1/queues", {"name": "research"}))  # 409
        tw.same(lambda c, P: c.post("/apis/v1alpha1/queues", {"name": "w0", "weight": 0}))  # 400
        assert tw.same(lambda c, P: c.delete("/apis/v1alpha1/queues/research"))[0] == 200
        tw.same(lambda c, P: c.delete("/apis/v1alpha1/queues/research"))  # 404
        assert "research" not in json.dumps(tw.same(lambda c, P: c.items("queues")))


def test_loop_with_the_device_allocate_pipeline(tmp_path):
    """The conf-selected device allocator in the live loop: the JAX
    server's ``enqueue, xla_allocate`` against the port's ``enqueue,
    torch_allocate`` (``device: cpu``)."""
    tiers = ("tiers:\n- plugins:\n  - name: priority\n  - name: gang\n  - name: conformance\n"
             "- plugins:\n  - name: drf\n  - name: predicates\n  - name: proportion\n  - name: nodeorder\n")
    jax_conf, port_conf = tmp_path / "jax.conf", tmp_path / "port.conf"
    jax_conf.write_text('actions: "enqueue, xla_allocate"\n' + tiers)
    port_conf.write_text('actions: "enqueue, torch_allocate"\n' + tiers + CPU_ARGS)
    with Twin(tmp_path, str(jax_conf), str(port_conf)) as tw:
        def seed(c, P):
            t, s = P.t, c.srv.store
            for i in range(2):
                s.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
            s.create_pod_group(t.build_pod_group("xj", min_member=3))
            for i in range(3):
                s.create_pod(t.build_pod(name=f"x{i}", group_name="xj", req=t.build_resource_list(cpu=1, memory="1Gi")))

        tw.each(seed)
        tw.settle(all_bound, "device pipeline bound the gang", timeout=60)
        tw.same(lambda c, P: pods_state(c.srv.store))
        assert [a.name for a in tw.port.srv.scheduler.actions] == ["enqueue", "torch_allocate"]


def test_conf_hot_reload(tmp_path):
    def run(P, conf):
        conf.write_text('actions: "enqueue, allocate"\ntiers:\n- plugins:\n  - name: gang\n  - name: priority\n')
        cache = P.cache.SchedulerCache(P.store.ClusterStore())
        sched = P.sched.Scheduler(cache, scheduler_conf=str(conf), schedule_period=0.05)
        seen = [[a.name for a in sched.actions]]
        conf.write_text('actions: "enqueue, allocate, backfill"\ntiers:\n- plugins:\n  - name: gang\n  - name: priority\n')
        sched.run_once()
        seen.append([a.name for a in sched.actions])
        conf.write_text('actions: "no-such-action"\n')
        sched.run_once()
        seen.append([a.name for a in sched.actions])
        cache.stop()
        return seen

    port = run(PORT, tmp_path / "port.conf")
    assert port == run(JAX, tmp_path / "jax.conf")
    assert port[-1] == ["enqueue", "allocate", "backfill"]


def cli(P, srv, *args) -> tuple:
    out = io.StringIO()
    base = [] if srv is None else ["--server", f"http://127.0.0.1:{srv.listen_port}"]
    return P.cli.main(base + list(args), out=out), out.getvalue()


def test_cli_queue_create_list_delete(tmp_path):
    with Twin(tmp_path) as tw:
        def run(c, P):
            steps = [cli(P, c.srv, "queue", "create", "--name", "gold", "--weight", "5"),
                     cli(P, c.srv, "queue", "list"),
                     cli(P, c.srv, "queue", "create", "--name", "gold"),
                     cli(P, c.srv, "queue", "delete", "--name", "gold"),
                     cli(P, c.srv, "queue", "list")]
            return steps

        steps = tw.same(run)
        assert [s[0] for s in steps] == [0, 0, 1, 0, 0]
        assert any(ln.startswith("gold") and "5" in ln for ln in steps[1][1].splitlines())
        assert not any(ln.startswith("gold") for ln in steps[4][1].splitlines())


def test_cli_version():
    port = cli(PORT, None, "version")
    assert port == cli(JAX, None, "version") and port[0] == 0 and "API Version" in port[1]


def test_cli_unreachable_server():
    def run(P):
        out = io.StringIO()
        return P.cli.main(["--server", "http://127.0.0.1:1", "queue", "list"], out=out)

    assert run(PORT) == run(JAX) == 1


def test_workload_ingestion_over_http(tmp_path):
    with Twin(tmp_path) as tw:
        def feed(c, P):
            codes = []
            for i in range(2):
                codes.append(c.post("/apis/v1alpha1/nodes",
                                    {"name": f"hn{i}", "allocatable": {"cpu": 4, "memory": "8Gi", "pods": 10}}))
            codes.append(c.post("/apis/v1alpha1/podgroups", {"name": "web", "min_member": 2}))
            for i in range(2):
                codes.append(c.post("/apis/v1alpha1/pods",
                                    {"name": f"web-{i}", "group": "web", "requests": {"cpu": 1, "memory": "1Gi"}}))
            return codes

        assert all(code == 201 for code, _ in tw.same(feed))
        tw.settle(all_bound, "pods bound via HTTP-fed cluster")
        tw.cycles(2)
        tw.same(lambda c, P: c.items("pods"))
        tw.same(lambda c, P: c.items("nodes"))
        tw.same(lambda c, P: c.items("podgroups"))
        assert tw.same(lambda c, P: c.delete("/apis/v1alpha1/pods/default/web-0")) == (200, {"deleted": "default/web-0"})
        assert len(tw.same(lambda c, P: c.items("pods"))) == 1


@pytest.mark.parametrize("conf", ["scheduler-conf-torch.yaml", "scheduler-conf-torch-pipeline.yaml"])
def test_example_confs_load_and_schedule(tmp_path, conf):
    """The port's example confs (``device: cpu`` appended) against their
    JAX twins: each parses, resolves every action and plugin, and binds a
    pod through the loop. The torch conf has no enqueue action, so its
    PodGroup is created Inqueue."""
    twins = {"scheduler-conf-torch.yaml": ("scheduler-conf.yaml", ["torch_allocate", "backfill"]),
             "scheduler-conf-torch-pipeline.yaml": ("scheduler-conf-tpu.yaml", [
                 "enqueue", "torch_reclaim", "torch_allocate", "torch_backfill", "torch_preempt"])}
    jax_conf, actions = twins[conf]
    with Twin(tmp_path, example(jax_conf), example(conf, tmp_path, cpu=True)) as tw:
        def seed(c, P):
            t, s = P.t, c.srv.store
            s.create_node(t.build_node("n0", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
            pg = t.build_pod_group("pg", min_member=1)
            pg.status.phase = P.types.PodGroupPhase.INQUEUE
            s.create_pod_group(pg)
            s.create_pod(t.build_pod(name="p0", group_name="pg", req=t.build_resource_list(cpu=1, memory="1Gi")))

        tw.each(seed)
        tw.settle(all_bound, f"bind under {conf}", timeout=60)
        assert tw.same(lambda c, P: pods_state(c.srv.store)) == [("p0", "n0")]
        assert [a.name for a in tw.port.srv.scheduler.actions] == actions


def test_ingestion_rejects_type_poisoned_pods(tmp_path):
    bodies = [
        ("/apis/v1alpha1/pods", {"name": "p", "priority": "high"}),
        ("/apis/v1alpha1/pods", {"name": "p", "priority": True}),
        ("/apis/v1alpha1/pods", {"name": "p", "labels": "x"}),
        ("/apis/v1alpha1/pods", {"name": "p", "requests": "2cpu"}),
        ("/apis/v1alpha1/pods", {"priority": 5}),
        ("/apis/v1alpha1/pods", {"name": "p", "phase": "Sleeping"}),
        ("/apis/v1alpha1/pods", {"name": "p", "priority_class_name": "nope"}),
        ("/apis/v1alpha1/nodes", {"name": "n", "allocatable": "big"}),
        ("/apis/v1alpha1/persistentvolumes", {"name": "v", "node_affinity": ["x"]}),
        ("/apis/v1alpha1/storageclasses", {"name": "s", "volume_binding_mode": "Never"}),
        ("/apis/v1alpha1/widgets", {"name": "w"}),
        ("/apis/v1alpha1/pods", {"name": "ok", "priority": "5"}),
        ("/apis/v1alpha1/pods", {"name": "ok", "priority": 5}),
    ]
    with Twin(tmp_path) as tw:
        codes = tw.same(lambda c, P: [c.post(path, body) for path, body in bodies])
        assert [code for code, _ in codes] == [400] * 10 + [404, 201, 409]
        tw.same(lambda c, P: c.call("POST", "/apis/v1alpha1/pods", None))  # empty body: no name
        tw.same(lambda c, P: c.items("pods"))


def test_pdb_priorityclass_and_volume_ingestion(tmp_path):
    with Twin(tmp_path) as tw:
        def feed(c, P):
            return [
                c.post("/apis/v1alpha1/priorityclasses", {"name": "gold", "value": 9}),
                c.post("/apis/v1alpha1/poddisruptionbudgets",
                       {"name": "web-pdb", "min_available": 2, "selector": {"app": "web"}}),
                c.post("/apis/v1alpha1/storageclasses", {"name": "fast", "provisioner": "x"}),
                c.post("/apis/v1alpha1/persistentvolumes", {"name": "pv1", "capacity": "10Gi", "storage_class": "fast",
                       "node_affinity": [{"key": "zone", "values": ["a"]}]}),
                c.post("/apis/v1alpha1/persistentvolumeclaims", {"name": "c1", "storage_class": "fast", "request": "1Gi"}),
            ]

        assert all(code == 201 for code, _ in tw.same(feed))
        for kind in ("priorityclasses", "poddisruptionbudgets", "storageclasses", "persistentvolumes",
                     "persistentvolumeclaims"):
            tw.same(lambda c, P: c.items(kind))
        assert tw.port.items("priorityclasses") == [{"name": "gold", "value": 9, "global_default": False}]
        for path in ("poddisruptionbudgets/default/web-pdb", "persistentvolumeclaims/default/c1",
                     "persistentvolumes/pv1", "storageclasses/fast", "priorityclasses/gold", "nodes/none"):
            tw.same(lambda c, P: c.delete(f"/apis/v1alpha1/{path}"))
        tw.same(lambda c, P: c.post("/apis/v1alpha1/priorityclasses", {"name": "gold", "value": 9}))

        def gold_pod(c, P):
            c.post("/apis/v1alpha1/nodes", {"name": "pn0", "allocatable": {"cpu": 2, "memory": "4Gi", "pods": 10}})
            return c.post("/apis/v1alpha1/pods", {"name": "gold-pod", "requests": {"cpu": 1, "memory": "1Gi"},
                                                  "priority_class_name": "gold"})

        tw.same(gold_pod)
        tw.settle(all_bound, "gold pod bound")

        def priority(c, P):
            snap = c.srv.cache.snapshot()
            return next(t.priority for j in snap.jobs.values() for t in j.tasks.values() if t.name == "gold-pod")

        assert tw.same(priority) == 9
        tw.same(lambda c, P: store_contents(P, c.srv.store)["pods"])


# -- the watch ------------------------------------------------------------------


def collapse(events):
    """Watch events without their seqs, consecutive repeats folded (a
    status write-back the cycle repeats is an event per cycle, and the
    two loops need not run as many cycles)."""
    out = []
    for ev in events:
        item = (ev["type"], json.dumps(ev["object"], sort_keys=True))
        if not out or out[-1] != item:
            out.append(item)
    return out


def test_watch_observes_bind_events_without_polling(tmp_path):
    with Twin(tmp_path) as tw:
        since = {c: c.get("/apis/v1alpha1/pods")[1]["resourceVersion"] for c in (tw.jax, tw.port)}

        def seed(c, P):
            t, s = P.t, c.srv.store
            s.create_node(t.build_node("n1", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
            s.create_pod_group(t.build_pod_group("pg-w", min_member=2))
            for i in range(2):
                s.create_pod(t.build_pod(name=f"watched-{i}", group_name="pg-w",
                                         req=t.build_resource_list(cpu=1, memory="1Gi")))

        tw.each(seed)

        def watch(c, P):
            rv, events = since[c], []
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and sum(1 for e in events if e["object"]["node"]) < 2:
                status, payload = c.get(f"/apis/v1alpha1/watch/pods?since={rv}&timeout=5")
                assert status == 200
                events += payload["events"]
                assert all(e["seq"] > rv for e in payload["events"])
                rv = payload["resourceVersion"]
            return collapse(events)

        events = tw.same(watch)
        assert [e[0] for e in events] == ["ADDED", "ADDED", "MODIFIED", "MODIFIED"]


def test_watch_gone_when_client_falls_behind():
    def run(P):
        store = P.store.ClusterStore()
        hub = P.server.WatchHub(store, max_events=64)
        for i in range(64 + 10):
            store.create_queue(P.t.build_queue(f"q{i}"))
            store.delete_queue(f"q{i}")
        first = hub.poll("queues", since=0, timeout=0, stop=threading.Event())
        again = hub.poll("queues", since=first[2], timeout=0, stop=threading.Event())
        store.create_queue(P.t.build_queue("late"))
        late = hub.poll("queues", since=again[2], timeout=0, stop=threading.Event())
        quiet = hub.poll("nodes", since=again[2], timeout=0, stop=threading.Event())
        return first, again, late, quiet

    port = run(PORT)
    assert port == run(JAX)
    assert port[0][0] == "gone" and port[1][:2] == ("ok", []) and port[2][1][0]["object"]["name"] == "late"


def test_watch_drop_fault_answers_gone(tmp_path):
    with Twin(tmp_path) as tw:
        def drop(c, P):
            rv = c.get("/apis/v1alpha1/queues")[1]["resourceVersion"]
            before = P.metrics.fault_injections.value({"point": "watch.drop"})
            P.faults.registry.arm("watch.drop", count=1)
            try:
                gone = c.get(f"/apis/v1alpha1/watch/queues?since={rv}&timeout=0")
            finally:
                P.faults.registry.disarm()
            fired = P.metrics.fault_injections.value({"point": "watch.drop"}) - before
            ok = c.get(f"/apis/v1alpha1/watch/queues?since={rv}&timeout=0")
            return gone[0], sorted(gone[1]), fired, ok[0], ok[1]["events"]

        assert tw.same(drop)[:4] == (410, ["error", "resourceVersion"], 1.0, 200)


def test_watch_bad_requests(tmp_path):
    with Twin(tmp_path) as tw:
        for path in ("/apis/v1alpha1/watch/gizmos", "/apis/v1alpha1/watch/pods?since=x",
                     "/apis/v1alpha1/watch/pods?timeout=nan", "/apis/v1alpha1/gizmos"):
            tw.same(lambda c, P: c.get(path))


def test_cli_queue_list_watch(tmp_path):
    with Twin(tmp_path) as tw:
        def run(c, P):
            out = io.StringIO()
            done = threading.Event()

            def go():
                P.cli.main(["--server", c.base, "queue", "list", "--watch", "--watch-once",
                            "--watch-timeout", "10"], out=out)
                done.set()

            threading.Thread(target=go, daemon=True).start()
            wait_until(lambda: "Name" in out.getvalue(), what="CLI initial list")
            c.srv.store.create_queue(P.t.build_queue("streamed", weight=3))
            assert done.wait(timeout=15), "CLI watch never returned"
            return out.getvalue()

        text = tw.same(run)
        assert "ADDED" in text and "streamed" in text


# -- flags, the card, the default conf ------------------------------------------


def test_add_flags_snapshot():
    opt = PORT.server.build_parser().parse_args(["--schedule-period", "300"])
    jopt = JAX.server.build_parser().parse_args(["--schedule-period", "300"])
    assert opt.schedule_period == jopt.schedule_period == 300.0
    for key in ("scheduler_name", "default_queue", "listen_address", "scheduler_conf", "v", "version",
                "leader_elect", "lock_file", "lease_url", "lease_name", "journal", "store_backend", "fleet"):
        assert getattr(opt, key) == getattr(jopt, key), key
    assert sorted(vars(opt)) == ["default_queue", "fleet", "journal", "leader_elect", "lease_name", "lease_url",
                                 "listen_address", "lock_file", "schedule_period", "scheduler_conf",
                                 "scheduler_name", "store_backend", "v", "version"]


@pytest.mark.parametrize("argv", [["--help"], ["--version"]])
def test_help_and_version_need_no_card(argv):
    """``--help`` and ``--version`` exit 0 and leave CUDA uninitialised,
    as does importing the server."""
    code = (
        "import sys, runpy, torch\n"
        "import kube_batch_tpu_torch.server\n"
        "assert not torch.cuda.is_initialized()\n"
        f"sys.argv = ['kube_batch_tpu_torch.server'] + {argv!r}\n"
        "try:\n"
        "    runpy.run_module('kube_batch_tpu_torch.server', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('NO-CARD-OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "NO-CARD-OK" in out.stdout, out.stdout + out.stderr
    assert ("usage:" in out.stdout) if argv == ["--help"] else ("Version: 0.1.0" in out.stdout)


def test_a_card_conf_without_a_card_binds_nothing_and_logs_each_cycle(tmp_path, monkeypatch, caplog):
    """The default conf (``device: cuda``) on a host without a card: every
    cycle raises, the loop logs it and goes on, and nothing is bound — no
    cycle moves to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    caplog.set_level(logging.ERROR, logger="kube_batch_tpu_torch.scheduler")
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=0.02)
    t = PORT.t
    srv.store.create_node(t.build_node("n0", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    srv.store.create_pod_group(t.build_pod_group("pg", min_member=1))
    srv.store.create_pod(t.build_pod(name="p0", group_name="pg", req=t.build_resource_list(cpu=1)))
    srv.start()
    try:
        wait_until(lambda: sum("scheduling cycle failed" in r.getMessage() for r in caplog.records) >= 3,
                   what="three failed cycles logged")
        assert srv.store.get_pod("default", "p0").node_name == ""
        assert srv.scheduler.actions[1].last_solver_tier in (None, "none")
        assert all("no CUDA device is visible" in r.getMessage() for r in caplog.records
                   if "scheduling cycle failed" in r.getMessage())
    finally:
        srv.stop()


def pending_gang_store(P):
    t = P.t
    store = P.store.ClusterStore()
    store.create_queue(t.build_queue("default"))
    for i in range(2):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=2, memory="4Gi", pods=10)))
    store.create_pod_group(t.build_pod_group("gang", min_member=3))  # created Pending
    for i in range(3):
        store.create_pod(t.build_pod(name=f"m{i}", group_name="gang", req=t.build_resource_list(cpu=1, memory="1Gi")))
    return store


@pytest.mark.parametrize("conf", ["default", "before_repair"])
def test_the_default_conf_binds_a_pending_gang_from_a_store(tmp_path, conf):
    """A PodGroup reaches a store Pending and allocate skips a Pending job:
    only a conf that leads with enqueue binds it. The port's default conf
    does, as the JAX package's does; the port's default before this
    repair (``torch_allocate, backfill``) bound nothing."""
    text = PORT.sched.DEFAULT_SCHEDULER_CONF
    if conf == "before_repair":
        text = text.replace('"enqueue, torch_allocate, backfill"', '"torch_allocate, backfill"')
    path = tmp_path / "conf.yaml"
    path.write_text(text + CPU_ARGS)

    store = pending_gang_store(PORT)
    cache = PORT.cache.SchedulerCache(store)
    PORT.sched.Scheduler(cache, str(path)).run_once()
    port = pods_state(store)

    jstore = pending_gang_store(JAX)
    jcache = JAX.cache.SchedulerCache(jstore)
    with x64_enabled(False):
        JAX.sched.Scheduler(jcache).run_once()
    jax = pods_state(jstore)
    for c in (cache, jcache):
        c.stop()
    assert all(node for _, node in jax)
    if conf == "default":
        assert port == jax
    else:
        assert all(not node for _, node in port)


# -- the loop's guards ----------------------------------------------------------


def test_the_staleness_guard_refuses_a_stale_snapshot(tmp_path, monkeypatch):
    """A cache whose snapshot_age exceeds KBT_MAX_SNAPSHOT_AGE_S: the
    cycle is refused before its session (nothing binds, the cycle counter
    stays), stale_cycles_skipped_total counts it and the cycle span says
    skipped; once fresh, the next cycle binds."""
    monkeypatch.setenv("KBT_MAX_SNAPSHOT_AGE_S", "5")
    conf = port_default_conf(tmp_path)

    def run(P, conf):
        age = [60.0]
        store = pending_gang_store(P)
        cache = P.cache.SchedulerCache(store, staleness_fn=lambda: age[0])
        sched = P.sched.Scheduler(cache, conf)
        before = P.metrics.stale_cycles_skipped.value()
        sched.run_once()
        stale = (pods_state(store), cache.cycle, P.metrics.stale_cycles_skipped.value() - before)
        age[0] = 0.0
        sched.run_once()
        cache.stop()
        return stale, (pods_state(store), cache.cycle)

    port = run(PORT, conf)
    with x64_enabled(False):
        assert port == run(JAX, None)
    assert port[0][1:] == (0, 1.0) and all(not n for _, n in port[0][0]) and all(n for _, n in port[1][0])


def test_the_skipped_cycle_span(tmp_path, monkeypatch):
    from kube_batch_tpu_torch import obs

    monkeypatch.setenv("KBT_MAX_SNAPSHOT_AGE_S", "5")
    monkeypatch.setenv("KBT_FLIGHT_RECORDER", str(tmp_path))
    monkeypatch.setenv("KBT_TRACE", "1")  # the conf has no trace: key, so the environment decides
    store = pending_gang_store(PORT)
    cache = PORT.cache.SchedulerCache(store, staleness_fn=lambda: 60.0)
    obs.recorder.clear()
    try:
        sched = PORT.sched.Scheduler(cache, port_default_conf(tmp_path))
        sched.run_once()
        spans = obs.recorder.spans()
        assert [s["name"] for s in spans] == ["cycle"]
        assert spans[0]["attrs"] == {"skipped": "stale_snapshot"}
        assert sched.last_timings["skipped"] == "stale_snapshot"
    finally:
        monkeypatch.delenv("KBT_TRACE")
        obs.configure()
        obs.recorder.clear()
        cache.stop()


def test_the_mutation_detector_catches_an_in_place_write(tmp_path, monkeypatch):
    """KBT_CACHE_MUTATION_DETECTOR on: a store object mutated in place
    during the cycle raises CacheMutationError out of run_once and counts
    cache_mutation_violations_total{kind}; a clean cycle passes."""
    monkeypatch.setenv("KBT_CACHE_MUTATION_DETECTOR", "1")

    def run(P, conf):
        store = pending_gang_store(P)
        cache = P.cache.SchedulerCache(store)
        sched = P.sched.Scheduler(cache, conf)
        sched.run_once()  # clean
        real = cache.snapshot

        def mutating_snapshot():
            store.get_pod("default", "m0").metadata.labels["mutated"] = "yes"
            return real()

        cache.snapshot = mutating_snapshot
        before = P.metrics.cache_mutation_violations.value({"kind": "pods"})
        with pytest.raises(P.detector.CacheMutationError) as exc:
            sched.run_once()
        cache.stop()
        return str(exc.value), P.metrics.cache_mutation_violations.value({"kind": "pods"}) - before, cache.cycle

    port = run(PORT, port_default_conf(tmp_path))
    with x64_enabled(False):
        assert port == run(JAX, None)
    assert port[1:] == (1.0, 2)


def test_the_loop_advances_the_cache_cycle_and_survives_a_failed_cycle(tmp_path, caplog):
    """run(stop): cycles every schedule_period; a cycle that raises is
    logged and the next one runs."""
    caplog.set_level(logging.ERROR, logger="kube_batch_tpu_torch.scheduler")
    store = pending_gang_store(PORT)
    cache = PORT.cache.SchedulerCache(store)
    sched = PORT.sched.Scheduler(cache, port_default_conf(tmp_path), schedule_period=0.01)
    real = sched.run_once
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected cycle failure")
        real()

    sched.run_once = flaky
    stop = threading.Event()
    th = threading.Thread(target=sched.run, args=(stop,))
    th.start()
    try:
        wait_until(lambda: len(calls) >= 4, what="four cycles")
    finally:
        stop.set()
        th.join(timeout=10)
        cache.stop()
    assert not th.is_alive()
    assert sum("injected cycle failure" in r.getMessage() for r in caplog.records) == 1
    assert cache.cycle >= 3 and all(n for _, n in pods_state(store))


def test_stop_joins_the_servers_threads(tmp_path):
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=0.02,
                                      scheduler_conf=port_default_conf(tmp_path))
    srv.start()
    threads = list(srv._threads)
    wait_until(lambda: srv.cache.cycle >= 2, what="two cycles")
    srv.stop()
    assert all(not th.is_alive() for th in threads)
    assert srv.cache._writer is None and not srv.cache._workers
    # an idle cycle (nothing pending) solves nothing: no serial pass either
    alloc = srv.scheduler.actions[1]
    assert (alloc.last_solver_tier, alloc.last_timings) == ("none", {"pending": 0})


def test_a_rejected_bind_resyncs_and_binds_on_a_later_cycle(tmp_path, monkeypatch):
    """``bind.write`` once with ``KBT_WRITE_RETRIES=0``: the first bind of
    the cycle is not retried in place; its task goes back through the
    errTasks resync to Pending and binds on the next cycle, in both
    packages, to the same node."""
    monkeypatch.setenv("KBT_WRITE_RETRIES", "0")
    conf = port_default_conf(tmp_path)

    def run(P, conf):
        store = pending_gang_store(P)
        t = P.t
        store.create_pod_group(t.build_pod_group("solo", min_member=1))
        store.create_pod(t.build_pod(name="s0", group_name="solo", req=t.build_resource_list(cpu=1, memory="1Gi")))
        cache = P.cache.SchedulerCache(store)
        cache.run()
        sched = P.sched.Scheduler(cache, conf)
        retries = P.metrics.write_retries.value({"op": "bind"})
        states = []
        P.faults.registry.arm("bind.write", count=1)
        try:
            for _ in range(2):
                sched.run_once()

                def settled():
                    with cache._mutex:
                        binding = any(x.status == P.api.TaskStatus.BINDING
                                      for j in cache.jobs.values() for x in j.tasks.values())
                    return not binding and len(cache._err_tasks) == 0

                wait_until(settled, what="writes and resyncs settled")
                states.append(pods_state(store))
        finally:
            P.faults.registry.disarm()
            cache.stop()
        return states, P.metrics.write_retries.value({"op": "bind"}) - retries

    port = run(PORT, conf)
    with x64_enabled(False):
        assert port == run(JAX, None)
    (first, second), retries = port
    assert retries == 0
    assert [name for name, node in first if not node] == ["m0"]  # the rejected write
    assert all(node for _, node in second)
