"""The port's scheduling cycle, `Scheduler(cache, conf).run_once()`,
against the JAX package's `Scheduler` on the same world.

The port runs `examples/scheduler-conf-torch.yaml` with
``device: cpu`` (the kernels' plain versions); the JAX scheduler runs the
same tiers with ``actions: "xla_allocate, backfill"`` under jax x64 off.
Binds and the PodGroup statuses the cycle writes back must be equal.

The cases of tests/test_scheduler.py and their twins (the process, its
HTTP surface and `kbt-ctl` live in tests/test_torch_server.py, the
electors in tests/test_torch_leader.py):

- test_loop_schedules_live_mutating_cluster, test_gang_larger_than_cluster_stays_pending,
  test_metrics_endpoint_scrapes_live_latencies, test_queue_api_crud,
  test_conf_hot_reload, test_workload_ingestion_over_http,
  test_example_confs_load_and_schedule, test_ingestion_rejects_type_poisoned_pods,
  test_watch_gone_when_client_falls_behind, test_cli_queue_list_watch,
  test_add_flags_snapshot: test_torch_server.py, each under the same name;
- test_healthz_and_version: test_torch_server.py::test_healthz_version_and_debug_endpoints;
- test_loop_with_xla_allocate_pipeline:
  test_torch_server.py::test_loop_with_the_device_allocate_pipeline;
- test_leader_election_mutual_exclusion:
  test_torch_leader.py::test_flock_pair_second_blocks_until_first_releases;
- TestCLI::test_queue_create_list_delete and TestCLI::test_create_duplicate_errors:
  test_torch_server.py::test_cli_queue_create_list_delete (its third step
  creates the queue again and exits 1);
- TestCLI::test_version_command: test_torch_server.py::test_cli_version;
- test_pdb_and_priorityclass_ingestion:
  test_torch_server.py::test_pdb_priorityclass_and_volume_ingestion;
- test_watch_observes_bind_event_without_polling:
  test_torch_server.py::test_watch_observes_bind_events_without_polling;
- test_watch_unknown_kind_404: test_torch_server.py::test_watch_bad_requests;
- test_select_best_node: here, under the same name.
"""

import os

import pytest
import torch

from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.scheduler import DEFAULT_SCHEDULER_CONF, Scheduler

from test_torch_actions import JAX, TORCH, make
from test_torch_session import _statuses, gate_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "examples", "scheduler-conf-torch.yaml")) as f:
    TORCH_CONF = f.read()


def port_conf(**args) -> str:
    """The example conf with torch_allocate's arguments set."""
    lines = "".join(f"    {k}: {v}\n" for k, v in args.items())
    return TORCH_CONF + f"actionArguments:\n  torch_allocate:\n{lines}"


def best_effort(P):
    """Zero-request pods are backfill's: the allocate actions skip them."""
    rl = P.t.build_resource_list(cpu=1, memory="512Mi")
    pods = [P.t.build_pod(name=f"be{i}", group_name="be") for i in range(2)]
    pods += [P.t.build_pod(name=f"g{i}", group_name="g", req=rl) for i in range(2)]
    pgs = [P.t.build_pod_group("be", min_member=1), P.t.build_pod_group("g", min_member=2)]
    nodes = [P.t.build_node(f"n{i}", P.t.build_resource_list(cpu=2, memory="2Gi", pods=10)) for i in range(2)]
    return P.t.build_cluster(pods, nodes, pgs, [P.t.build_queue("default")])


def build(key, P):
    return {"gate_world": gate_world, "best_effort": best_effort}.get(key, lambda P: make(key, P))(P)


def jax_cycle(key, tmp_path):
    path = tmp_path / "jax-conf.yaml"
    path.write_text(TORCH_CONF.replace('"torch_allocate, backfill"', '"xla_allocate, backfill"'))
    with x64_enabled(False):
        cache = JAX.t.FakeCache(build(key, JAX))
        JaxScheduler(cache, str(path)).run_once()
    return dict(cache.binder.binds), _statuses(cache.cluster)


def port_cycle(key, tmp_path, **args):
    path = tmp_path / "torch-conf.yaml"
    path.write_text(port_conf(**args))
    cache = torch_testing.FakeCache(build(key, TORCH))
    sched = Scheduler(cache, str(path))
    sched.run_once()
    return dict(cache.binder.binds), _statuses(cache.cluster), sched


@pytest.mark.parametrize("mesh", ["off", "cpu:4"])
@pytest.mark.parametrize("key", [
    "preempt_mix_2000_40_seed1", "multi_tenant_ml_8_8_3", "pod_affinity_many", "gate_world", "best_effort",
    "proportion_overused",
])
def test_run_once_equals_the_jax_scheduler(key, mesh, tmp_path):
    want = jax_cycle(key, tmp_path)
    binds, statuses, sched = port_cycle(key, tmp_path, device="cpu", min_device_pairs=0, mesh=mesh)
    assert (binds, statuses) == want
    assert [a.name for a in sched.actions] == ["torch_allocate", "backfill"]
    assert sched.actions[0].last_solver_tier == ("fused" if mesh == "off" else "sharded")
    assert {"conf_s", "snapshot_s", "plugins_s", "job_valid_s", "torch_allocate_s", "backfill_s", "close_s",
            "run_once_s"} <= set(sched.last_timings)
    if key == "best_effort":
        assert {"default/be0", "default/be1"} <= set(binds)


def test_the_example_conf_runs_on_the_card_by_default():
    sched = Scheduler(torch_testing.FakeCache(build("gang_atomic", TORCH)),
                      os.path.join(ROOT, "examples", "scheduler-conf-torch.yaml"))
    assert sched.action_arguments == {}
    assert sched.actions[0].name == "torch_allocate"


def test_a_broken_conf_keeps_the_last_good_one(tmp_path):
    path = tmp_path / "conf.yaml"
    path.write_text(port_conf(device="cpu", min_device_pairs=0))
    cache = torch_testing.FakeCache(build("gang_atomic", TORCH))
    sched = Scheduler(cache, str(path))
    good = list(sched.actions)
    for broken in ("actions: [torch_allocate]\n", 'actions: "no_such_action"\n', "tiers:\n\t- plugins:\n"):
        path.write_text(broken)
        sched.run_once()
        assert sched.actions == good
    assert len(cache.binder.binds) == 3
    os.remove(path)  # unreadable: the previous conf too
    sched.run_once()
    assert sched.actions == good


def test_a_broken_first_conf_raises(tmp_path):
    path = tmp_path / "conf.yaml"
    path.write_text("actions: [allocate]\n")
    with pytest.raises(ValueError, match="line 1"):
        Scheduler(torch_testing.FakeCache(build("gang_atomic", TORCH)), str(path))


def test_no_conf_is_the_default_conf(tmp_path):
    """With no conf the cycle runs the example conf's pipeline led by the
    enqueue action, as the JAX package's default is: the solve on the
    card. A ``device: cpu`` copy of it runs the kernels' plain versions."""
    assert parse_scheduler_conf(DEFAULT_SCHEDULER_CONF) == parse_scheduler_conf(
        TORCH_CONF.replace('"torch_allocate, backfill"', '"enqueue, torch_allocate, backfill"'))
    sched = Scheduler(torch_testing.FakeCache(build("gang_atomic", TORCH)))
    assert [a.name for a in sched.actions] == ["enqueue", "torch_allocate", "backfill"]
    assert sched.action_arguments == {}
    path = tmp_path / "conf.yaml"
    path.write_text(DEFAULT_SCHEDULER_CONF + "actionArguments:\n  torch_allocate:\n    device: cpu\n"
                    "    min_device_pairs: 0\n")
    cache = torch_testing.FakeCache(build("gang_atomic", TORCH))
    sched = Scheduler(cache, str(path))
    sched.run_once()
    assert sched.actions[1].last_solver_tier == "fused"
    assert len(cache.binder.binds) == 3


def test_no_conf_without_a_card_raises(monkeypatch):
    """The default conf never falls back to the CPU or to serial: with no
    card visible the cycle raises and binds nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = torch_testing.FakeCache(build("gang_atomic", TORCH))
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        Scheduler(cache).run_once()
    assert cache.binder.binds == {}


def test_a_spent_hard_budget_discards_the_cycle(tmp_path):
    """The budget is gone before the solver entry: the cycle aborts before
    any bind, and close_session skips the status write-back."""
    path = tmp_path / "conf.yaml"
    path.write_text(port_conf(device="cpu", min_device_pairs=0))
    cache = torch_testing.FakeCache(build("pod_affinity_one", TORCH))
    before = _statuses(cache.cluster)
    sched = Scheduler(cache, str(path), hard_deadline_s=1e-9)
    sched.run_once()
    assert "solver entry" in sched.last_timings["aborted"]
    assert cache.binder.binds == {}
    phases = {uid: s[:4] for uid, s in _statuses(cache.cluster).items()}
    assert phases == {uid: s[:4] for uid, s in before.items()}


def test_select_best_node():
    """scheduler_helper_test.go:26 TestSelectBestNode, on both packages:
    the highest score bucket wins, its first entry picked."""
    from kube_batch_tpu.api.node_info import NodeInfo as JaxNodeInfo
    from kube_batch_tpu.utils import select_best_node as jax_select

    from kube_batch_tpu_torch.api.node_info import NodeInfo
    from kube_batch_tpu_torch.utils import select_best_node

    def picks(node_info, select):
        def node(name):
            n = node_info()
            n.name = name
            return n

        n1, n2, n3, n4, n5 = (node(f"node{i}") for i in range(1, 6))
        first = select({1.0: [n1, n2], 2.0: [n3, n4]})
        assert first in (n3, n4)
        assert select({1.0: [n1, n2], 3.0: [n3], 2.0: [n4, n5]}) is n3
        assert select({}) is None
        return first.name

    assert picks(NodeInfo, select_best_node) == picks(JaxNodeInfo, jax_select)
