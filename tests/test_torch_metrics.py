"""The port's main-path metrics against the JAX package's.

The same cycles run in each package (the JAX scheduler over
examples/scheduler-conf-tpu.yaml, the port's over its twin,
examples/scheduler-conf-torch-pipeline.yaml with ``device: cpu``) on the
seeded ``gen_contended_cluster`` and ``gen_contended_reclaim_cluster``
worlds: the increments of ``schedule_attempts``, ``job_retry_counts`` and
the preemption counters, the gauges ``unschedule_task_count`` per job and
``unschedule_job_count``, and the observation counts of the latency
histograms (per action, per plugin and hook, e2e and per task) must be
equal. The port's ``render_prometheus_text()`` holds every ported series
under the JAX name, help text, type and label set."""

import re

import pytest

from kube_batch_tpu import metrics as jax_metrics
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import FakeCache as JaxFakeCache
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import metrics as torch_metrics
from kube_batch_tpu_torch.scheduler import Scheduler

from test_torch_pipeline import JAX_GENERATORS, TPU, twin_conf

COUNTERS = ("schedule_attempts", "preemption_victims", "preemption_attempts")
HISTOGRAMS = ("e2e_scheduling_latency", "action_scheduling_latency", "plugin_scheduling_latency",
              "task_scheduling_latency")


def _reading(m) -> dict:
    """The values the comparison reads: counters, gauges by label set, and
    each histogram's observation count by label set (the actions' package
    prefixes, ``xla_`` and ``torch_``, read as one)."""
    out = {name: getattr(m, name).value() for name in COUNTERS}
    out["job_retry_counts"] = getattr(m, "job_retry_counts").samples()
    out["unschedule_task_count"] = getattr(m, "unschedule_task_count").samples()
    out["unschedule_job_count"] = m.unschedule_job_count.value()
    for name in HISTOGRAMS:
        h = getattr(m, name)
        counts = out[name] = {}
        for key in h.label_sets() or [()]:
            # keep the package prefix apart from the serial action's name
            short = tuple((k, re.sub(r"^(xla|torch)_", "vector_", v)) for k, v in key)
            counts[short] = h.snapshot(dict(key) if key else None)["count"]
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict) and k != "unschedule_task_count":
            out[k] = {lk: lv - before[k].get(lk, 0) for lk, lv in v.items() if lv != before[k].get(lk, 0)}
        elif k in ("unschedule_task_count", "unschedule_job_count"):
            out[k] = v  # gauges: the value the last cycle set
        else:
            out[k] = v - before[k]
    return out


def _run_both(tmp_path, gen: str, seed: int, cycles: int = 2):
    """The same cycles in each package; returns each package's deltas."""
    deltas = []
    for m, run in ((jax_metrics, "jax"), (torch_metrics, "torch")):
        m.unschedule_task_count._values.clear()  # this world's jobs only
        before = _reading(m)
        if run == "jax":
            with x64_enabled(False):
                sched = JaxScheduler(JaxFakeCache(getattr(JAX_GENERATORS[gen], gen)(seed)), TPU)
                for _ in range(cycles):
                    sched.run_once()
        else:
            sched = Scheduler(torch_testing.FakeCache(getattr(torch_testing, gen)(seed)), twin_conf(tmp_path, "off"))
            for _ in range(cycles):
                sched.run_once()
        deltas.append(_delta(before, _reading(m)))
    return deltas


@pytest.mark.parametrize("gen", sorted(JAX_GENERATORS))
@pytest.mark.parametrize("seed", range(4))
def test_main_path_series_equal_after_the_same_cycles(tmp_path, gen, seed):
    jax_delta, torch_delta = _run_both(tmp_path, gen, seed)
    assert torch_delta == jax_delta
    assert torch_delta["schedule_attempts"] == 2
    # five actions per cycle, each metered once
    assert sum(torch_delta["action_scheduling_latency"].values()) == 10


def test_the_sweep_meters_preemption_and_unschedulable_jobs(tmp_path):
    """The seeds above are not tame: over them the port meters preemption
    victims and attempts and leaves unschedulable jobs (the JAX side's
    equality is the test above)."""
    total = {"preemption_victims": 0, "preemption_attempts": 0, "retries": 0}
    for seed in range(4):
        _, d = _run_both(tmp_path, "gen_contended_cluster", seed, cycles=1)
        total["preemption_victims"] += d["preemption_victims"]
        total["preemption_attempts"] += d["preemption_attempts"]
        total["retries"] += sum(d["job_retry_counts"].values())
    assert all(v > 0 for v in total.values()), total


def _families(text: str) -> dict:
    """name -> (help, type, label key sets) of an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, help_text = line[7:].split(" ", 1)
            out[name] = [help_text, None, set()]
        elif line.startswith("# TYPE "):
            name, kind = line[7:].split(" ", 1)
            out[name][1] = kind
        else:
            name = re.split(r"[{ ]", line, maxsplit=1)[0]
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            name = base if base in out else name
            inner = line[line.index("{") + 1: line.rindex("}")] if "{" in line.split(" ")[0] else ""
            labels = frozenset(k for k in re.findall(r'(?:^|,)(\w+)="', inner) if k != "le")
            out[name][2].add(labels)
    return out


def test_the_exposition_holds_every_series_under_the_jax_name(tmp_path):
    _run_both(tmp_path, "gen_contended_cluster", 0, cycles=1)
    torch_metrics.register_degraded_cycle("serial", "solve_failed")
    jax_metrics.register_degraded_cycle("serial", "solve_failed")
    # every labelled series written on both sides, so the label sets
    # compared do not hang on what earlier tests in the process wrote
    for m in (torch_metrics, jax_metrics):
        m.register_cycle_overrun("soft")
        m.register_fault_injection("exposition-parity")
        m.register_breaker_transition("exposition-parity", "closed", "open")
        m.set_breaker_state("exposition-parity", 2.0)
        m.register_encode_cache_invalidation("exposition-parity")
        m.set_slo_quantile("queue_wait", "default", "p50", 0.25)
        m.set_slo_quantile("time_to_bind", "default", "p50", 0.25)
        m.register_write_retry("bind")
        m.register_cache_mutation("pods")
        m.register_longpoll_wakeup("timeout")
        m.register_journal_records("intent", 2)
        m.register_reconcile_op("redispatched")
        m.set_watch_snapshot_age(0.5)
        m.register_watch_relist("queues")
        m.register_federation_conflict("clean")
        m.register_federation_node_conflict("n0")
        m.observe_store_backend_rtt("list", 0.001)
        m.register_store_backend_bytes("tx", "binary", 10)
        m.set_shard_slot_owned(0, True)
        m.register_shard_adoption("adopted")
        m.register_shard_handoff("completed")
        m.register_micro_cycle("ok")
        m.register_unschedulable("resources")
        m.register_would_fit_if("resources")
        m.set_fleet_slo_quantile("time_to_bind", "default", "p99", 0.5)
        m.set_fleet_slo_quantile("queue_wait", "default", "p99", 0.5)
        m.set_fleet_node_heatmap({"n0": 1.0})
        m.set_fleet_shard_up("http://peer:1", True)
        m.set_fleet_shard_scrape_age("http://peer:1", 0.5)
        m.register_admission_decision("high", "admitted")
        m.set_admission_lane_backlog("high", 1)
        m.set_admission_lane_rate("high", 10.0)
        m.register_admission_controller_tick("steady")
        m.set_arena_hbm_bytes("fused_istatic", 1024)
        m.set_arena_hbm_watermark(2048)
    port, jax = _families(torch_metrics.render_prometheus_text()), _families(jax_metrics.render_prometheus_text())
    assert len(port) == len(torch_metrics.FAMILIES) == len(jax) == 69
    for name in ("journal_records_total", "reconcile_ops_total", "watch_snapshot_age_seconds", "watch_relists_total"):
        assert f"kube_batch_tpu_{name}" in port, name
    for name, (help_text, kind, label_sets) in port.items():
        assert name in jax, name
        assert (help_text, kind) == tuple(jax[name][:2]), name
        non_empty = {s for s in label_sets if s}
        assert non_empty <= jax[name][2] or not non_empty, (name, non_empty, jax[name][2])
    assert "kube_batch_tpu_breaker_state{tier=\"exposition-parity\"} 2.0" in torch_metrics.render_prometheus_text()


def test_label_values_are_escaped():
    c = torch_metrics.Counter("kube_batch_tpu_escape_total", "escape")
    c.inc({"point": 'bad"point\\with\nnewline'})
    lines = torch_metrics._render_family(c)
    assert lines[-1] == 'kube_batch_tpu_escape_total{point="bad\\"point\\\\with\\nnewline"} 1.0'
    assert lines[:2] == ["# HELP kube_batch_tpu_escape_total escape", "# TYPE kube_batch_tpu_escape_total counter"]


def test_batched_exchange_iterations_are_metered():
    """The sharded rung's K-deep exchange: every gang iteration committed
    from a batch counts in exchange_batched_iters_total, as the JAX
    action counts its mesh exchange's."""
    from test_torch_actions import MESH_K4, torch_run

    before = torch_metrics.exchange_batched_iters_total.value()
    _, binds, act, _ = torch_run("preempt_mix_2000_40_seed1", "default", MESH_K4)
    assert act.last_solver_tier == "sharded" and act.last_batched_iters > 0 and binds
    assert torch_metrics.exchange_batched_iters_total.value() - before == act.last_batched_iters
