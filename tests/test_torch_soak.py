"""Churn through the port's live server loop with no leaks, case for case
with tests/test_soak.py.

The JAX cases (both marked ``slow``, so outside the tier-1 run) churn 5,000
pods over 100 generations through the default serial pipeline and 30
generations through the TPU conf. Their twins here keep the churn driver,
its leak assertions, its RSS budgets and its schedules, uncut (on the
CPU each runs in seconds), and add what the port keeps across cycles: the tensor arena
of the server's cache must hold exactly B1's two static slabs however
many generations (and node buckets) went through it, and the encode
cache's store listeners must return to their count before the server.

- ``test_soak_churn_no_leaks``: the same name; the scheduler's default
  conf (``DEFAULT_SCHEDULER_CONF``: ``enqueue, torch_allocate, backfill``
  with ``device: cpu``), 100 generations of 5 gangs x 10 pods on 20 nodes.
- ``test_soak_churn_tpu_pipeline``: ``test_soak_churn_twin_pipeline``; the
  twin pipeline conf (examples/scheduler-conf-torch-pipeline.yaml, the
  fused rung's plain version), the JAX case's 30 generations of its
  period-6 (gangs, size) schedule on 16 nodes.
"""

from __future__ import annotations

import os
import resource
import time

from kube_batch_tpu_torch.ops import encode_cache
from kube_batch_tpu_torch.server import SchedulerServer
from kube_batch_tpu_torch.testing import build_node, build_pod, build_pod_group, build_resource_list

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ARGS = "actionArguments:\n  torch_allocate:\n    device: cpu\n"


def wait_until(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def cpu_conf(tmp_path, name: str | None) -> str:
    """examples/<name>, or with no name the scheduler's default conf, with
    torch_allocate on the CPU."""
    if name is None:
        from kube_batch_tpu_torch.scheduler import DEFAULT_SCHEDULER_CONF

        text, name = DEFAULT_SCHEDULER_CONF, "default.yaml"
    else:
        with open(os.path.join(ROOT, "examples", name)) as f:
            text = f.read()
    path = tmp_path / f"cpu-{name}"
    path.write_text(text + CPU_ARGS)
    return str(path)


def churn(scheduler_conf, generations, schedule, n_nodes, warmup_gen, rss_budget_mb, bind_timeout, prefix):
    """One soak run: per generation create the scheduled gangs, wait for
    every pod to bind, tear everything down; afterwards the store and the
    cache drain completely, peak RSS growth past ``warmup_gen`` stays
    under budget, and the allocate action's arena for this cache holds
    B1's two statics and nothing else. ``schedule(gen) -> (gangs,
    gang_size)``."""
    listeners = encode_cache.listener_count()
    srv = SchedulerServer(listen_address="127.0.0.1:0", schedule_period=0.02, scheduler_conf=scheduler_conf)
    srv.start()
    store, cache = srv.store, srv.cache
    try:
        for i in range(n_nodes):
            store.create_node(build_node(f"n{i:02d}", build_resource_list(cpu=16, memory="32Gi", pods=110)))
        warmup_rss = None
        for gen in range(generations):
            gangs, size = schedule(gen)
            names = []
            for g in range(gangs):
                pg_name = f"{prefix}{gen}-g{g}"
                store.create_pod_group(build_pod_group(pg_name, min_member=size))
                for t in range(size):
                    store.create_pod(build_pod(name=f"{pg_name}-t{t}", group_name=pg_name,
                                               req=build_resource_list(cpu=1, memory="1Gi")))
                names.append(pg_name)
            expected = gangs * size
            wait_until(
                lambda: sum(1 for p in store.list("pods")
                            if p.node_name and p.metadata.name.startswith(f"{prefix}{gen}-")) == expected,
                timeout=bind_timeout, what=f"generation {gen} fully bound",
            )
            for pg_name in names:
                for t in range(size):
                    store.delete_pod("default", f"{pg_name}-t{t}")
                store.delete_pod_group("default", pg_name)
            if gen == warmup_gen:
                warmup_rss = rss_mb()

        # -- leak assertions (identical for every pipeline) ---------------
        assert store.list("pods") == []
        assert store.list("podgroups") == []
        wait_until(lambda: len(cache.jobs) == 0, what=f"cache job GC (left: {list(cache.jobs)[:5]})")
        for node in cache.nodes.values():
            assert node.tasks == {}, f"task residue on {node.name}"
            assert node.used.milli_cpu == 0, f"used residue on {node.name}"
        assert len(cache._err_tasks) == 0
        growth = rss_mb() - warmup_rss
        assert growth < rss_budget_mb, f"peak RSS grew {growth:.0f}MB over the churn"
        action = next(a for a in srv.scheduler.actions if a.name == "torch_allocate")
        arena = action.arena_for(cache, "cpu")
        assert set(arena.hbm_bytes_by_slab()) == {"fused_istatic", "fused_fstatic"}
        assert arena.failures == 0 and arena.full_uploads >= 2 and arena.reuses + arena.row_updates >= 1
    finally:
        srv.stop()
    assert encode_cache.listener_count() == listeners


def test_soak_churn_no_leaks(tmp_path):
    """5 gangs of 10 pods a generation on 20 nodes through the scheduler's
    default conf, at a period of 20 ms."""
    churn(scheduler_conf=cpu_conf(tmp_path, None), generations=100,
          schedule=lambda gen: (5, 10), n_nodes=20, warmup_gen=4, rss_budget_mb=200, bind_timeout=30,
          prefix="gen")


def test_soak_churn_twin_pipeline(tmp_path):
    """The same churn through the twin pipeline (torch_reclaim,
    torch_allocate, torch_backfill, torch_preempt + tensorscore): every
    generation's gangs bind through the encode, the fused rung and the
    bulk replay; the period-6 schedule moves the task and job buckets."""
    churn(scheduler_conf=cpu_conf(tmp_path, "scheduler-conf-torch-pipeline.yaml"), generations=30,
          schedule=lambda gen: (3 + (gen % 3) * 2, 6 + (gen % 2) * 6), n_nodes=16, warmup_gen=5,
          rss_budget_mb=300, bind_timeout=60, prefix="tgen")
