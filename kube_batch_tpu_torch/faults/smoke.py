"""Fast chaos smoke: one injected fault per subsystem, each driven through
a real path, asserting the binds still land and the degraded path engaged.

    python -m kube_batch_tpu_torch.faults.smoke [--device cuda|cpu]

Each drill runs torch_allocate over a 12-pod, 3-gang cluster on 4 nodes
(``cuda``, the default, launches the kernels and raises when no card is
visible; ``cpu`` runs their plain versions) under a fresh solver ladder,
and every drill must bind all 12 pods. The cache, watch, lease and
mutation-detector drills run over a ``ClusterStore``: a store write that
fails once and is retried (through a scheduling cycle whose torch_allocate
solves on the device), a dropped long-poll watch, a partitioned lease
renewal, and a seeded mutation of the store's objects. Exit 0 iff every
drill passes.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

CONF = """
actions: "torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def _cluster():
    from kube_batch_tpu_torch.testing import (
        build_cluster,
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    pods = [
        build_pod(name=f"p{i}", group_name=f"g{i % 3}", req=build_resource_list(cpu=1, memory="512Mi"))
        for i in range(12)
    ]
    nodes = [build_node(f"n{i}", build_resource_list(cpu=8, memory="8Gi", pods=16)) for i in range(4)]
    return build_cluster(
        pods, nodes, [build_pod_group(f"g{j}", min_member=4) for j in range(3)], [build_queue("default")]
    )


def _session_binds(device: str, mesh: str = "off"):
    """One torch_allocate session; asserts all 12 binds land. Returns the
    action."""
    from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.testing import FakeCache

    cache = FakeCache(_cluster())
    args = {"torch_allocate": {"device": device, "min_device_pairs": "0", "mesh": mesh}}
    ssn = open_session(cache, parse_scheduler_conf(CONF).tiers, args)
    action = TorchAllocateAction()
    action.execute(ssn)
    close_session(ssn)
    assert len(cache.binder.binds) == 12, f"only {len(cache.binder.binds)}/12 binds"
    return action


def _expect(action, tier: str, reason: str | None = None) -> None:
    assert action.last_solver_tier == tier, f"solved on {action.last_solver_tier!r}, expected {tier!r}"
    if reason is not None:
        assert action.last_timings.get("serial_reason") == reason, action.last_timings


def drill_fused(device: str) -> None:
    from kube_batch_tpu_torch import faults

    faults.registry.arm("solve.fused", count=1)
    _expect(_session_binds(device), "serial", "solve_failed")
    assert faults.solver_ladder.breakers["fused"].failures == 1


def drill_sharded(device: str) -> None:
    from kube_batch_tpu_torch import faults

    faults.registry.arm("solve.sharded", count=1)
    _expect(_session_binds(device, mesh=f"{device}:4"), "fused")
    assert faults.solver_ladder.breakers["sharded"].failures == 1


def drill_nan(device: str) -> None:
    from kube_batch_tpu_torch import faults

    faults.registry.arm("solve.nan", count=1)
    _expect(_session_binds(device), "serial", "nonfinite: w_least")


def drill_overrun(device: str) -> None:
    """cycle.overrun at the dispatch barrier: the cycle aborts with no bind
    and the next cycle binds everything."""
    import os
    import tempfile

    from kube_batch_tpu_torch import faults
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    conf = CONF + f"actionArguments:\n  torch_allocate:\n    device: {device}\n    min_device_pairs: 0\n"
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(conf)
    try:
        cache = FakeCache(_cluster())
        sched = Scheduler(cache, f.name)
        faults.registry.arm("cycle.overrun", count=1)
        sched.run_once()
        assert "aborted" in sched.last_timings and not cache.binder.binds, "the overrun did not abort"
        sched.run_once()
        assert len(cache.binder.binds) == 12, f"only {len(cache.binder.binds)}/12 binds after the abort"
    finally:
        os.unlink(f.name)


def drill_native(device: str) -> None:
    from kube_batch_tpu_torch import faults

    faults.registry.arm("native.load")
    _expect(_session_binds(device), "fused")


def drill_bind(device: str) -> None:
    """bind.write fails once: the cache retries the write with jitter and
    the pod lands."""
    import os
    import tempfile

    from kube_batch_tpu_torch import faults
    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import build_node, build_pod, build_queue, build_resource_list

    store = ClusterStore()
    store.create_node(build_node("n0", build_resource_list(cpu=8, memory="8Gi", pods=16)))
    store.create_queue(build_queue("default"))
    store.create_pod(build_pod(name="p0", req=build_resource_list(cpu=1, memory="1Gi")))
    conf = CONF + f"actionArguments:\n  torch_allocate:\n    device: {device}\n    min_device_pairs: 0\n"
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(conf)
    try:
        faults.registry.arm("bind.write", count=1)
        Scheduler(SchedulerCache(store), f.name, schedule_period=0.05).run_once()
    finally:
        os.unlink(f.name)
    assert faults.registry.active()["bind.write"][2] == 1, "bind.write never fired"
    pod = store.get_pod("default", "p0")
    assert pod is not None and pod.node_name, "bind did not land after retry"


def drill_watch(device: str) -> None:
    """watch.drop: the long poll answers 410 Gone once, then recovers."""
    from kube_batch_tpu_torch import faults
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.server import WatchHub

    store = ClusterStore()
    hub = WatchHub(store)
    faults.registry.arm("watch.drop", count=1)
    status, _events, _rv = hub.poll("queues", 0, 0.1, threading.Event())
    assert status == "gone", "injected drop did not surface as 410-Gone"
    status, _, _ = hub.poll("queues", 0, 0.05, threading.Event())
    assert status == "ok", "poll did not recover after the drop"


def drill_lease(device: str) -> None:
    """lease.renew: a partitioned leader fires on_lost within 2 s and
    releases its lease, so a standby takes it at once."""
    from kube_batch_tpu_torch import faults
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.server import StoreLeaseElector

    store = ClusterStore()
    elector = StoreLeaseElector(
        store, "smoke", "a", lease_duration=30.0,
        renew_deadline=0.3, retry_period=0.1,
    )
    assert elector.acquire(blocking=False)
    faults.registry.arm("lease.renew")
    lost = threading.Event()
    elector.start_renewing(lost.set)
    assert lost.wait(2.0), "partitioned leader never fired on_lost"
    faults.registry.reset()
    # the loss path released: a standby gets the 30s lease immediately
    lease = store.try_acquire_lease("smoke", "b", 15.0)
    assert lease.holder_identity == "b", "lease not released on loss"


def drill_mutation_detector(device: str) -> None:
    """A seeded in-place mutation of a store object is detected."""
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.faults.mutation_detector import CacheMutationError, MutationDetector
    from kube_batch_tpu_torch.testing import build_node, build_resource_list

    store = ClusterStore()
    store.create_node(build_node("n0", build_resource_list(cpu=1, memory="1Gi")))
    det = MutationDetector(store)
    det.snapshot()
    store.list("nodes")[0].metadata.labels["mutated"] = "1"
    try:
        det.verify()
    except CacheMutationError:
        return
    raise AssertionError("seeded cache mutation was not detected")


DRILLS = (
    ("fused rung (solve.fused -> serial degradation)", drill_fused),
    ("sharded rung (solve.sharded -> fused resumes)", drill_sharded),
    ("poisoned weights (solve.nan -> finite guard -> serial)", drill_nan),
    ("cycle budget (cycle.overrun -> abort pre-dispatch)", drill_overrun),
    ("native boundary (native.load -> Python twins)", drill_native),
    ("cache write (bind.write -> retry w/ jitter)", drill_bind),
    ("watch hub (watch.drop -> 410-Gone)", drill_watch),
    ("lease elector (lease.renew -> on_lost + release)", drill_lease),
    ("cache-mutation detector (seeded violation fires)", drill_mutation_detector),
)


def main(argv=None) -> int:
    from kube_batch_tpu_torch import faults

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass --device cpu to drill the kernels' plain versions")
    process_ladder = faults.solver_ladder
    failed = 0
    try:
        for name, drill in DRILLS:
            faults.registry.reset()
            faults.set_solver_ladder(faults.DegradationLadder(("sharded", "fused", "serial")))
            t0 = time.perf_counter()
            try:
                drill(args.device)
            except Exception as e:  # noqa: BLE001 - report every drill
                failed += 1
                print(f"chaos smoke: {name}: FAILED ({type(e).__name__}: {e})")
            else:
                print(f"chaos smoke: {name}: ok ({time.perf_counter() - t0:.2f}s)")
    finally:
        faults.registry.reset()
        faults.set_solver_ladder(process_ladder)
    print("chaos smoke:", "FAILED" if failed else "ok", f"({len(DRILLS)} drills)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
