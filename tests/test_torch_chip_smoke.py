"""chip_smoke.py's cycle log on the CPU: the server phases read every
cycle's pending tasks and rung from it, and a cycle with pending tasks
must solve on the fused rung. A gang whose pods are still being posted
(fewer than its min_member) is dropped by the session's JobValid gate, so
the allocator has nothing to solve and the cycle's rung is ``none``; the
log must count only the pending tasks of the jobs the gate keeps."""

import os

import chip_smoke
from kube_batch_tpu_torch import models
from kube_batch_tpu_torch import testing as tt
from kube_batch_tpu_torch.cache import ClusterStore
from kube_batch_tpu_torch.server import SchedulerServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(tmp_path) -> str:
    with open(os.path.join(ROOT, "examples", chip_smoke.PIPELINE_CONF)) as f:
        text = f.read()
    text += 'actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: "0"\n'
    path = tmp_path / "conf.yaml"
    path.write_text(text)
    return str(path)


def test_cycle_log_counts_only_the_pending_tasks_of_jobs_the_gate_keeps(tmp_path):
    store = ClusterStore()
    tt.seed_store(store, *models.preempt_mix_objects(200, 20))
    srv = SchedulerServer(listen_address="127.0.0.1:0", schedule_period=1.0, scheduler_conf=_conf(tmp_path),
                          store=store)
    log = chip_smoke.CycleLog(srv.scheduler, "cpu")
    srv.scheduler.run_once()
    store.create("podgroups", tt.build_pod_group("probe", min_member=8))
    srv.scheduler.run_once()  # enqueue moves the empty probe gang Inqueue
    req = tt.build_resource_list("1", "2Gi")
    for i in range(6):
        store.create("pods", tt.build_pod(name=f"probe-{i}", group_name="probe", req=req))
    srv.scheduler.run_once()  # 6 of 8 pods: the gate drops the job
    for i in range(6, 8):
        store.create("pods", tt.build_pod(name=f"probe-{i}", group_name="probe", req=req))
    srv.scheduler.run_once()  # the whole gang: solved on the fused rung
    assert [(c["pending"], c["last_solver_tier"]) for c in log.cycles] == [
        (200, "fused"), (0, "none"), (0, "none"), (8, "fused")]
    log.check("probe")
    assert not log.errors


def test_chip_smoke_defines_each_top_level_name_once():
    """A second top-level ``def`` or assignment of a name in chip_smoke.py
    silently replaces the first for every caller in the module (a helper
    for ClassSolveState once shadowed the SolveState comparison of the
    sharded phases, and the card run failed there)."""
    import ast
    import collections

    tree = ast.parse(open(chip_smoke.__file__).read())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    assert [name for name, n in names.items() if n > 1] == []
