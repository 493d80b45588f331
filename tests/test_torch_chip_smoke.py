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


def test_warm_cycles_and_trace_audit_print_the_arena_per_cycle():
    """``warm_cycles_50k_5k`` (cut) records the tensor arena's counters and
    bytes per slab each cycle: cycle 1 uploads B1's two statics whole,
    cycle 2 (nothing changed) reuses both, cycle 3 (a node relabelled, a
    new gang) uploads them again; ``trace_audit_50k_5k``'s cycle runs under
    the arena's audit, quiet, and records its summary."""
    keep = {}
    rec, _ = chip_smoke.warm_cycles_phase("cpu", cut=100, keep=keep)
    arena = [c["arena"] for c in rec["fast"]]
    assert [(a["reuses"], a["row_updates"], a["full_uploads"]) for a in arena[:2]] == [(0, 0, 2), (2, 0, 0)]
    assert sum(arena[2][k] for k in ("reuses", "row_updates", "full_uploads")) == 2
    assert all(a["failures"] == 0 for a in arena)
    assert set(rec["fast"][0]["arena_bytes_by_slab"]) == {"fused_istatic", "fused_fstatic"}
    assert all("arena" not in c for c in rec["off"])
    audit, _ = chip_smoke.trace_audit_phase(keep["sched"], "cpu")
    assert audit["arena"]["uploads"] == 2 and audit["arena"]["failures"] == 0


def test_exchange_phase_runs_k1_through_the_surface_and_reuses_its_blocks():
    """The exchange phase on the CPU (the kernels' plain versions): K = 1
    through ShardedSolver and K = 4 through ShardedBlockSolver (both B4's
    plain version), the host loop at K = 4, and B4 at every K over one card
    and over four cards each equal the fused rung field for field, and
    ``sharded_surface`` (sharded_solve_allocate on the same arena) reuses
    B4's three static slabs and gives the fused rung's result."""
    from kube_batch_tpu_torch.ops.fused_solve import FusedSolver

    arrays = chip_smoke.encoded_arrays(models.preempt_mix(300, 16, seed=1))
    want = FusedSolver(arrays, True, True, device="cpu").solve()
    recs, launches, b2 = chip_smoke.exchange_phase(arrays, want, device="cpu")
    assert [r["phase"] for r in recs] == [
        "exchange_preempt_mix_2k_40_seed1_m4_k1", "exchange_preempt_mix_2k_40_seed1_m4_k4", "host_loop_k4",
        "b4_by_k", "sharded_surface",
    ]
    assert all(r["equal_to_fused"] for r in recs) and launches == b2 == 0  # no kernel on the CPU
    assert recs[0]["surface"] == "ShardedSolver" and recs[1]["batched_iters"] >= 1
    assert recs[1]["equal_to_plain"] and recs[2]["batched_iters"] == recs[1]["batched_iters"]
    assert (recs[0]["impl"], recs[1]["impl"], recs[2]["impl"]) == ("mesh_kernel", "mesh_kernel", "host_loop")
    by_k = recs[3]["four_cards_on_one_device"]
    assert sorted(by_k) == list(chip_smoke.EXCHANGE_KS) and by_k[1]["exchange_rounds"] == by_k[1]["placing_iterations"]
    assert all(0 < by_k[k]["exchange_rounds"] <= by_k[k]["batched_iters"] for k in chip_smoke.EXCHANGE_KS[1:])
    assert all(r["exchange_rounds"] == 0 for r in recs[3]["one_card_m4"].values())
    assert recs[4]["arena"]["reuses"] == 3 and recs[4]["arena"]["full_uploads"] == 0
    assert set(recs[4]["arena_bytes_by_slab"]) == {f"mesh_{n}" for n in ("istatic", "fstatic", "gidx")}


def test_class_sessions_record_their_arena_uploads():
    """A compressed session of ``classes_400k_40k``'s shape (cut) records
    the class tables' arena uploads by kind and the host time they took:
    one ``class_<key>`` upload a table and solve, none a segment (the
    member list goes up as a plain copy)."""
    from kube_batch_tpu_torch.ops.class_solve import _CA_KEYS

    rec, binds, _ = chip_smoke.class_session(models.uniform_pool(2000, 200, churn=0.01), "cpu", True)
    assert rec["tier"] == "class_fused" and binds and rec["class"]["segments"] >= 1
    tables = sum(1 for k in _CA_KEYS if not k.startswith("w_"))
    assert sum(rec["arena_uploads"].values()) % tables == 0 and rec["arena_uploads"]["full"] >= tables
    assert rec["arena"]["failures"] == 0 and rec["arena_upload_s"] > 0


MULTICHIP_PHASES = ["multichip_cycle_50k_5k", "multichip_warm_cycles_50k_5k", "multichip_pipelined_50k_5k",
                    "multichip_explain_50k_1k", "multichip_classes_50k_5k", "multichip_ladder",
                    "multichip_trace_audit"]


def test_cards_phases_rehearse_on_a_cpu_mesh(capsys):
    """``chip_smoke.py --rehearse CUT --cards``: the multi-card phases of
    ``--cards`` on ``mesh: cpu:4`` (the kernels' plain versions), each
    equal to its reference on the fused rung and every mesh arm on four
    shards of the sharded rung (the class phase's on its class layer): B4's
    plain version, and in the cycle phase the host loop too."""
    import json

    assert chip_smoke.main(["--rehearse", "100", "--cards"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    by_phase = {r["phase"]: r for r in recs}
    assert [r["phase"] for r in recs] == MULTICHIP_PHASES + ["total"]
    cycle = by_phase["multichip_cycle_50k_5k"]
    assert cycle["m"] == 4 and cycle["equal_to_reference"] and cycle["reduced"]["pods"] == [50_000, 500]
    for arm in ("cards", "one_card"):
        assert cycle[arm]["tier"] == "sharded" and cycle[arm]["mesh_size"] == 4
        assert cycle[arm]["placing_iterations"] > 0 and cycle[arm]["record_reads"] == 0  # no card: no read
        assert by_phase["multichip_classes_50k_5k"][arm]["tier"] == "class_sharded"
        assert by_phase["multichip_ladder"][arm]["tier"] == "fused"
        assert by_phase["multichip_ladder"][arm]["sharded_failures"] == 1
        assert cycle[arm]["sharded_impl"] == "mesh_kernel"
        assert [c["arena"]["reuses"] for c in by_phase["multichip_warm_cycles_50k_5k"][arm]][1] >= 3
        assert by_phase["multichip_trace_audit"][arm]["p001"].startswith("not run")
    assert cycle["reference"]["tier"] == "fused"
    assert cycle["host_loop"]["sharded_impl"] == "host_loop" and cycle["host_loop"]["placing_iterations"] > 0
    assert by_phase["multichip_explain_50k_1k"]["records_equal"]
    assert by_phase["multichip_pipelined_50k_5k"]["binds_equal"]
