"""The port's leader election (`kube_batch_tpu_torch.server`:
`LeaderElector` over a lock file, `StoreLeaseElector` over a store-backed
lease, the lease routes and `run()`'s flags) against the JAX package's, on
the cases of tests/test_leader.py.

Arbitration runs in the store under the arbiter's clock, injected here
(``now=``), so the store-level cases need no sleeps and compare both
packages' leases field by field. The electors run against the port's
server as the arbiter, and a JAX elector and a port elector contend on
one lease over either package's server. Reference semantics:
cmd/kube-batch/app/server.go:115-139 (leaderelection.RunOrDie over a
ConfigMap resource lock, 15 s / 10 s / 5 s). Exact equality throughout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kube_batch_tpu_torch.recovery import WriteIntentJournal
from kube_batch_tpu_torch.recovery.fsck import fsck

from test_torch_store import JAX, PORT, norm, wait_until

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CONF = ('actions: "enqueue, torch_allocate"\ntiers:\n- plugins:\n  - name: priority\n  - name: gang\n'
            "- plugins:\n  - name: predicates\n  - name: nodeorder\n"
            "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n")


@pytest.fixture(autouse=True)
def _clean_faults():
    PORT.faults.registry.reset()
    yield
    PORT.faults.registry.reset()


def cpu_conf(tmp_path) -> str:
    path = tmp_path / "cpu-conf.yaml"
    path.write_text(CPU_CONF)
    return str(path)


# -- store-level arbitration (clock injected, no sleeps) --------------------


def fresh_acquire_and_renew(store):
    return [store.try_acquire_lease("kb", "a", 15.0, now=100.0), store.try_acquire_lease("kb", "a", 15.0, now=105.0)]


def fresh_lease_is_not_stolen(store):
    store.try_acquire_lease("kb", "a", 15.0, now=100.0)
    return [store.try_acquire_lease("kb", "b", 15.0, now=110.0)]


def expired_lease_is_taken_over(store):
    store.try_acquire_lease("kb", "a", 15.0, now=100.0)
    return [store.try_acquire_lease("kb", "b", 15.0, now=100.0 + 15.01)]


def release_allows_instant_takeover(store):
    store.try_acquire_lease("kb", "a", 15.0, now=100.0)
    released = store.release_lease("kb", "a")
    return [released, store.try_acquire_lease("kb", "b", 15.0, now=100.1)]


def release_by_non_holder_is_noop(store):
    store.try_acquire_lease("kb", "a", 15.0, now=100.0)
    return [store.release_lease("kb", "b"), store.release_lease("nothing", "a")]


def empty_identity_rejected(store):
    with pytest.raises(ValueError, match="identity") as e:
        store.try_acquire_lease("kb", "", 15.0, now=100.0)
    return [str(e.value)]


def pathological_durations_rejected(store):
    out = []
    for bad in (float("nan"), float("inf"), 0.0, -5.0, 1e9):
        with pytest.raises(ValueError, match="lease_duration") as e:
            store.try_acquire_lease("kb", "a", bad, now=100.0)
        out.append(str(e.value))
    return out


def separate_lease_names_are_independent_scopes(store):
    return [store.try_acquire_lease("scope-1", "a", 15.0, now=100.0),
            store.try_acquire_lease("scope-2", "b", 15.0, now=100.0)]


def transitions_count_each_change_of_holder(store):
    out = []
    for i, who in enumerate(("a", "b", "a", "a", "c")):
        out.append(store.try_acquire_lease("kb", who, 1.0, now=100.0 + 2.0 * i))
    return out + [store.list("leases")]


ARBITRATION = [fresh_acquire_and_renew, fresh_lease_is_not_stolen, expired_lease_is_taken_over,
               release_allows_instant_takeover, release_by_non_holder_is_noop, empty_identity_rejected,
               pathological_durations_rejected, separate_lease_names_are_independent_scopes,
               transitions_count_each_change_of_holder]


@pytest.mark.parametrize("case", ARBITRATION, ids=lambda c: c.__name__)
def test_lease_arbitration_equals_the_jax_store(case):
    port = norm(case(PORT.store.ClusterStore()))
    assert port == norm(case(JAX.store.ClusterStore()))


def test_arbitration_semantics():
    """What tests/test_leader.py asserts of each case, on the port."""
    l1, l2 = fresh_acquire_and_renew(PORT.store.ClusterStore())
    assert l1.holder_identity == "a" and l1.acquire_time == l1.renew_time == 100.0 and l1.lease_transitions == 0
    assert (l2.acquire_time, l2.renew_time, l2.lease_transitions) == (100.0, 105.0, 0)
    (l,) = fresh_lease_is_not_stolen(PORT.store.ClusterStore())
    assert l.holder_identity == "a" and l.renew_time == 100.0
    (l,) = expired_lease_is_taken_over(PORT.store.ClusterStore())
    assert (l.holder_identity, l.lease_transitions, l.acquire_time) == ("b", 1, 115.01)
    _, l = release_allows_instant_takeover(PORT.store.ClusterStore())
    assert (l.holder_identity, l.lease_transitions) == ("b", 1)
    l, missing = release_by_non_holder_is_noop(PORT.store.ClusterStore())
    assert l.holder_identity == "a" and missing is None


def test_transient_renewal_blip_is_survived():
    """One failed renewal mid-window must not consume the whole deadline:
    the loop retries fast and a recovered arbiter keeps the leader."""
    el = PORT.server.StoreLeaseElector(PORT.store.ClusterStore(), "kb", "a", lease_duration=2.0,
                                       renew_deadline=1.0, retry_period=0.4)
    assert el.acquire(blocking=False)
    real_try = el._try_acquire
    fails = {"n": 0}

    def flaky(timeout=5.0):
        if fails["n"] == 0:
            fails["n"] += 1
            raise OSError("transient arbiter blip")
        return real_try(timeout)

    el._try_acquire = flaky
    lost = threading.Event()
    el.start_renewing(lost.set)
    assert not lost.wait(2.0), "single blip killed the leader"
    assert el.is_leader and fails["n"] == 1
    el._try_acquire = real_try
    el.release()


def test_elector_defaults_are_the_references():
    for P in (PORT, JAX):
        el = P.server.StoreLeaseElector("http://127.0.0.1:1", "kb", "a")
        assert (el.lease_duration, el.renew_deadline, el.retry_period, el.is_leader) == (15.0, 10.0, 5.0, False)


# -- the HTTP surface and the elector ---------------------------------------


@pytest.fixture
def arbiter(tmp_path):
    srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0,
                                      scheduler_conf=cpu_conf(tmp_path))
    srv.start()
    yield srv
    srv.stop()


def _url(server) -> str:
    return f"http://127.0.0.1:{server.listen_port}"


def post(base: str, path: str, body) -> tuple[int, dict]:
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


LEASE_REQUESTS = [
    ("/apis/v1alpha1/leases/kb/acquire", {"identity": "x", "lease_duration": 15}),
    ("/apis/v1alpha1/leases/kb/acquire", {"identity": "y"}),  # refused, lease unchanged
    ("/apis/v1alpha1/leases/kb/release", {"identity": "y"}),  # not the holder: no-op
    ("/apis/v1alpha1/leases/team-a%2Fkb%20one/acquire", {"identity": "z", "lease_duration": 5}),
    ("/apis/v1alpha1/leases/kb/acquire", {"identity": "x", "lease_duration": "15"}),  # 400
    ("/apis/v1alpha1/leases/kb/acquire", {"identity": "x", "lease_duration": 0}),  # 400
    ("/apis/v1alpha1/leases/kb/acquire", {"lease_duration": 15}),  # 400: no identity
    ("/apis/v1alpha1/leases/a/b/acquire", {"identity": "x"}),  # 400: a raw '/'
    ("/apis/v1alpha1/leases/missing/release", {"identity": "x"}),  # 404
    ("/apis/v1alpha1/leases/kb/release", {"identity": "x"}),
    ("/apis/v1alpha1/leases/kb/acquire", {"identity": "y", "lease_duration": 15}),  # instant takeover
]


def test_lease_routes_answer_as_the_jax_servers(tmp_path):
    out = {}
    for P in (JAX, PORT):
        kwargs = {"scheduler_conf": cpu_conf(tmp_path)} if P is PORT else {}
        srv = P.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0, **kwargs)
        srv.start()
        try:
            replies = []
            for path, body in LEASE_REQUESTS:
                code, payload = post(_url(srv), path, body)
                payload.pop("renew_time", None)  # the arbiter's clock
                replies.append((code, payload))
            with urllib.request.urlopen(f"{_url(srv)}/apis/v1alpha1/leases", timeout=5) as r:
                items = json.loads(r.read())["items"]
            listed = sorted((i["name"], i["holder"], i["transitions"], i["lease_duration"]) for i in items)
        finally:
            srv.stop()
        out[P.name] = (replies, listed)
    assert out[PORT.name] == out[JAX.name]
    replies, listed = out[PORT.name]
    assert [c for c, _ in replies] == [200, 200, 200, 200, 400, 400, 400, 400, 404, 200, 200]
    assert replies[0][1]["acquired"] and not replies[1][1]["acquired"] and replies[1][1]["holder"] == "x"
    assert listed == [("kb", "y", 1, 15.0), ("team-a/kb one", "z", 0, 5.0)]


def elector(P, arbiter, identity, name="kb", lease_duration=1.0, renew_deadline=0.7, retry_period=0.1):
    return P.server.StoreLeaseElector(arbiter, name, identity, lease_duration=lease_duration,
                                      renew_deadline=renew_deadline, retry_period=retry_period)


def test_elector_pair_graceful_handoff(arbiter):
    a, b = elector(PORT, _url(arbiter), "a"), elector(PORT, _url(arbiter), "b")
    assert a.acquire(blocking=False)
    assert not b.acquire(blocking=False)
    a.release()  # graceful: clears the holder, the standby takes over at once
    assert b.acquire(blocking=False)
    b.release()


@pytest.mark.parametrize("arbiter_pkg", ["jax", "port"])
def test_a_jax_and_a_port_elector_contend_on_one_lease(tmp_path, arbiter_pkg):
    """Either package's server arbitrates between a JAX and a port elector:
    one leads, the other waits, and a graceful release hands over."""
    A = JAX if arbiter_pkg == "jax" else PORT
    kwargs = {"scheduler_conf": cpu_conf(tmp_path)} if A is PORT else {}
    srv = A.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0, **kwargs)
    srv.start()
    try:
        jax_el, port_el = elector(JAX, _url(srv), "jax"), elector(PORT, _url(srv), "port")
        assert port_el.acquire(blocking=False)
        assert not jax_el.acquire(blocking=False)
        port_el.release()
        assert jax_el.acquire(blocking=False) and not port_el.acquire(blocking=False)
        jax_el.release()
        assert srv.store.get("leases", "kb").lease_transitions == 1
    finally:
        srv.stop()


def test_elector_crash_failover_within_lease_window(arbiter):
    """Kill the leader WITHOUT release: the standby takes over once the
    lease expires — and not before."""
    lease_duration = 1.0
    a, b = elector(PORT, _url(arbiter), "a"), elector(PORT, _url(arbiter), "b")
    assert a.acquire(blocking=False)
    t_death = time.monotonic()  # a crash: renewals just stop
    assert not b.acquire(blocking=False), "fresh lease must not be stolen"
    assert b.acquire(blocking=True)
    waited = time.monotonic() - t_death
    assert lease_duration * 0.5 <= waited < lease_duration + 1.0, f"failover took {waited:.2f}s"
    b.release()


def test_lost_leadership_fires_on_lost(arbiter):
    """A leader fenced out after expiry by a rival learns it within
    renew_deadline and fires on_lost (OnStoppedLeading)."""
    a = elector(PORT, _url(arbiter), "a", lease_duration=0.5, renew_deadline=0.4)
    assert a.acquire(blocking=False)
    lost = threading.Event()
    a._stop.set()  # halt renewals before they start (a pause)
    time.sleep(0.6)  # the lease expires
    b = elector(PORT, _url(arbiter), "b", lease_duration=5.0, renew_deadline=4.0)
    assert b.acquire(blocking=False)
    a._stop.clear()  # the pause ends; the renewal loop hits the fence
    a.start_renewing(lost.set)
    assert lost.wait(2.0), "fenced-out leader never learned it lost"
    assert not a.is_leader
    b.release()


def test_lease_name_scope_symmetric_across_transports(arbiter):
    """A name with '/' and ' ' arbitrates the SAME scope over HTTP
    (percent-encoded) and in-process."""
    name = "team-a/kb one"
    via_http = elector(PORT, _url(arbiter), "h", name=name, lease_duration=5.0, renew_deadline=4.0)
    in_proc = elector(PORT, arbiter.store, "p", name=name, lease_duration=5.0, renew_deadline=4.0)
    assert via_http.acquire(blocking=False)
    assert not in_proc.acquire(blocking=False), "transports split the scope"
    via_http.release()
    assert in_proc.acquire(blocking=False)
    in_proc.release()


def test_renew_deadline_fires_before_lease_can_expire(arbiter):
    """Partitioned leader: on_lost fires within the renew deadline,
    strictly before the lease could expire under a standby."""
    a = elector(PORT, _url(arbiter), "a", lease_duration=2.0, renew_deadline=0.5)
    assert a.acquire(blocking=False)
    a.arbiter = "http://127.0.0.1:1"  # partition: nothing listens there
    lost = threading.Event()
    t0 = time.monotonic()
    a.start_renewing(lost.set)
    assert lost.wait(1.8), "partitioned leader never noticed"
    assert time.monotonic() - t0 < 2.0, "loss detected after possible expiry"
    assert not a.is_leader


def test_lost_leader_releases_lease_before_on_lost(arbiter):
    """_lose releases the lease BEFORE on_lost, so the standby takes over
    at once instead of waiting out a (here 30 s) lease; at the moment
    on_lost runs the lease is already free."""
    a = elector(PORT, _url(arbiter), "a", name="kb-race", lease_duration=30.0, renew_deadline=0.3)
    assert a.acquire(blocking=False)
    holder_at_lost = []

    def on_lost():
        holder_at_lost.append(arbiter.store.get("leases", "kb-race").holder_identity)

    def broken(timeout=5.0):
        raise OSError("injected renewal failure")

    a._try_acquire = broken  # renewals fail; the release POST still works
    a.start_renewing(on_lost)
    wait_until(lambda: holder_at_lost, timeout=2.0, what="on_lost")
    assert holder_at_lost == [""] and not a.is_leader
    b = elector(PORT, _url(arbiter), "b", name="kb-race", lease_duration=5.0, renew_deadline=4.0)
    assert b.acquire(blocking=False), "lease was not released on loss"
    b.release()


def test_lease_renew_fault_point_fires_on_lost_and_frees_the_lease(arbiter):
    """``lease.renew`` armed: every renewal fails, on_lost fires past the
    renew deadline with the lease already released, the injections are
    counted, and the standby takes over at once."""
    a = elector(PORT, _url(arbiter), "a", name="kb-fault", lease_duration=30.0, renew_deadline=0.4)
    assert a.acquire(blocking=False)
    before = PORT.metrics.fault_injections.value({"point": "lease.renew"})
    PORT.faults.registry.arm("lease.renew")
    lost = threading.Event()
    t0 = time.monotonic()
    a.start_renewing(lost.set)
    assert lost.wait(10.0)
    took = time.monotonic() - t0
    PORT.faults.registry.reset()
    # after the renew deadline, long before the 30 s lease could run out
    assert 0.4 <= took < 10.0 and not a.is_leader
    assert PORT.metrics.fault_injections.value({"point": "lease.renew"}) - before >= 1
    assert arbiter.store.get("leases", "kb-fault").holder_identity == ""
    b = elector(PORT, _url(arbiter), "b", name="kb-fault")
    assert b.acquire(blocking=False)
    b.release()


def test_release_waits_for_the_renewal_thread(arbiter):
    """release() joins the renewal thread before its POST: after it the
    lease is free and no thread of the elector is alive."""
    a = elector(PORT, _url(arbiter), "a", lease_duration=5.0, renew_deadline=3.0)
    assert a.acquire(blocking=False)
    a.start_renewing(lambda: None)
    time.sleep(0.25)  # a few renewals
    threads = [a._thread, a._watchdog]
    a.release()
    assert not any(t.is_alive() for t in threads) and a._thread is None and not a.is_leader
    assert arbiter.store.get("leases", "kb").holder_identity == ""


# -- the flock tier ----------------------------------------------------------


def test_flock_pair_second_blocks_until_first_releases(tmp_path):
    lock = str(tmp_path / "kb.lock")
    a = PORT.server.LeaderElector(lock, "a")
    b = PORT.server.LeaderElector(lock, "b")
    assert a.acquire(blocking=True)
    assert not b.acquire(blocking=False)
    with open(lock) as f:
        assert f.read() == "a"
    got = threading.Event()
    t = threading.Thread(target=lambda: b.acquire(blocking=True) and got.set(), daemon=True)
    t.start()
    assert not got.wait(0.3), "the standby took a held lock"
    a.release()
    assert got.wait(5.0), "the standby never took the released lock"
    t.join(5.0)
    with open(lock) as f:
        assert f.read() == "b"
    b.release()
    # the JAX package's elector contends on the same lock file
    j = JAX.server.LeaderElector(lock, "jax")
    assert j.acquire(blocking=False)
    assert not PORT.server.LeaderElector(lock, "c").acquire(blocking=False)
    j.release()


# -- the HA pair end to end ---------------------------------------------------


def test_ha_pair_failover_end_to_end(arbiter, tmp_path):
    """Two port servers contend on one arbiter; the leader schedules; kill
    it (no graceful release); the standby leads within the lease window
    and ITS loop binds."""
    lease_duration = 1.0
    conf = cpu_conf(tmp_path)

    def make_server():
        srv = PORT.server.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=0.05, scheduler_conf=conf)
        t = PORT.t
        srv.store.create_node(t.build_node("n0", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
        srv.store.create_pod(t.build_pod(name="p0", req=t.build_resource_list(cpu=1, memory="1Gi")))
        return srv

    el_a = elector(PORT, _url(arbiter), "a", name="kb-ha")
    assert el_a.acquire(blocking=False)
    srv_a = make_server()
    srv_a.start()
    el_a.start_renewing(lambda: None)
    wait_until(lambda: all(p.node_name for p in srv_a.store.list("pods")), what="leader schedules")

    el_b = elector(PORT, _url(arbiter), "b", name="kb-ha")
    srv_b = make_server()
    became_leader = threading.Event()

    def standby():
        if el_b.acquire(blocking=True):
            srv_b.start()  # OnStartedLeading
            became_leader.set()

    t = threading.Thread(target=standby, daemon=True)
    t.start()
    time.sleep(0.3)
    assert not became_leader.is_set(), "standby must wait while the leader renews"

    t_death = time.monotonic()
    el_a._stop.set()  # the loop and the renewals stop dead, no release
    srv_a.stop()
    try:
        assert became_leader.wait(lease_duration + 1.5), "standby never took over"
        waited = time.monotonic() - t_death
        wait_until(lambda: all(p.node_name for p in srv_b.store.list("pods")), what="standby schedules")
        assert waited < lease_duration + 1.0, f"failover took {waited:.2f}s"
    finally:
        el_b.release()
        t.join(5.0)
        srv_b.stop()


# -- run(): the flags and the fatal exit, in subprocesses ----------------------


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP", "KBT_JOURNAL")}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.mark.parametrize("flags", [["--leader-elect"], ["--leader-elect", "--lease-name", "x"]], ids=" ".join)
def test_leader_elect_without_a_lock_or_lease_exits_with_the_jax_message(flags):
    out = {}
    for mod in ("kube_batch_tpu_torch.server", "kube_batch_tpu.server"):
        proc = subprocess.run([sys.executable, "-m", mod, *flags], cwd=ROOT, env=_env(), capture_output=True,
                              text=True, timeout=120)
        out[mod] = (proc.returncode, proc.stderr.strip().splitlines()[-1:])
    assert out["kube_batch_tpu_torch.server"] == out["kube_batch_tpu.server"] == (
        1, ["--lock-file or --lease-url must be set when --leader-elect is enabled"])


def test_ha_flags_parse_as_the_jax_servers():
    argv = ["--leader-elect", "--lock-file", "/tmp/kb.lock", "--lease-url", "http://store:8080",
            "--lease-name", "kb-ha", "--journal", "/tmp/kb.wal"]
    opt, jopt = PORT.server.build_parser().parse_args(argv), JAX.server.build_parser().parse_args(argv)
    for key in ("leader_elect", "lock_file", "lease_url", "lease_name", "journal"):
        assert getattr(opt, key) == getattr(jopt, key), key
    defaults = PORT.server.build_parser().parse_args([])
    assert (defaults.leader_elect, defaults.lock_file, defaults.lease_url, defaults.lease_name, defaults.journal) == (
        False, "", "", "kube-batch", "")


def test_help_lists_the_ha_flags_and_touches_no_card():
    code = (
        "import sys, runpy, torch\n"
        "sys.argv = ['kube_batch_tpu_torch.server', '--help']\n"
        "try:\n"
        "    runpy.run_module('kube_batch_tpu_torch.server', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--leader-elect", "--lock-file", "--lease-url", "--lease-name", "--journal"):
        assert flag in proc.stdout, flag


def test_run_leads_under_a_lease_and_exits_fatally_when_fenced_out(arbiter, tmp_path):
    """``python -m kube_batch_tpu_torch.server --leader-elect --lease-url``
    on the CPU: the process takes the lease under a ``host_pid_uuid``
    identity, reconciles its journal in ``start()``, and when a rival
    takes the lease it exits 1 (OnStoppedLeading glog.Fatalf parity) at
    its next renewal."""
    t = PORT.t
    store = arbiter.store
    store.create_node(t.build_node("n0", t.build_resource_list(cpu=4, memory="8Gi", pods=10)))
    store.create_pod(t.build_pod(name="p0", req=t.build_resource_list(cpu=1, memory="1Gi")))
    journal = str(tmp_path / "run.wal")
    j = WriteIntentJournal(journal)
    j.append_intents("bind", [("default/g", "default/p0", "n0")], cycle=1)
    j.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kube_batch_tpu_torch.server", "--leader-elect", "--lease-url", _url(arbiter),
         "--lease-name", "kb-run", "--journal", journal, "--listen-address", "127.0.0.1:0",
         "--schedule-period", "5", "--scheduler-conf", cpu_conf(tmp_path)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_until(lambda: store.get("leases", "kb-run") is not None
                   and store.get("leases", "kb-run").holder_identity, timeout=60, what="the child leads")
        holder = store.get("leases", "kb-run").holder_identity
        host, pid, tag = holder.rsplit("_", 2)
        assert host and int(pid) == proc.pid and len(tag) == 8
        # the child's start() reconciled the journal: its own store lacks
        # the orphan's pod, so the statement is resolved (rolled back)
        wait_until(lambda: fsck(journal)["orphaned"] == 0, timeout=60, what="the child's reconciliation")
        # fence it out: clear its hold and take the lease for a rival
        store.release_lease("kb-run", holder)
        store.try_acquire_lease("kb-run", "rival", 60.0)
        rc = proc.wait(timeout=30)  # the renewal (every 5 s) finds the rival
        output = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 1, output
    assert "leaderelection lost" in output and "lost to another holder" in output
