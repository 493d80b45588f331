"""The port's twin conf, examples/scheduler-conf-torch-pipeline.yaml
(``enqueue, torch_reclaim, torch_allocate, torch_backfill,
torch_preempt`` with tensorscore), through the port's `Scheduler` on the
CPU rungs (the fused rung and ``mesh: cpu:4``, the kernels' plain
versions) against the JAX package's examples/scheduler-conf-tpu.yaml
and the serial pipeline, on the 12 x 2 seeded worlds of
tests/test_pipeline_parity.py: the same task statuses and nodes, binds
and evict list."""

import os

import pytest

from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.conf import read_scheduler_conf as jax_read

import kube_batch_tpu_torch.scheduler as torch_scheduler
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse

import test_xla_preempt
import test_xla_reclaim
from test_pipeline_parity import SERIAL_CONF
from test_torch_preempt import jax_run, session_state, torch_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(ROOT, "examples", "scheduler-conf-torch-pipeline.yaml")
TPU = os.path.join(ROOT, "examples", "scheduler-conf-tpu.yaml")
GENERATORS = ["gen_contended_cluster", "gen_contended_reclaim_cluster"]
JAX_GENERATORS = {"gen_contended_cluster": test_xla_preempt, "gen_contended_reclaim_cluster": test_xla_reclaim}
# the serial-action conf of the card's pipeline_parity phase: the serial
# scans around a device allocate
SERIAL_SCANS_ACTIONS = ["enqueue", "reclaim", "torch_allocate", "backfill", "preempt"]


def pipeline_actions(conf_text: str, parse) -> list[str]:
    return [a.strip() for a in parse(conf_text).actions.split(",") if a.strip()]


def twin_conf(tmp_path, mesh: str) -> str:
    """The twin conf as it is, with torch_allocate on the CPU (plain
    versions) and never routed by size."""
    with open(TWIN) as f:
        text = f.read()
    text += f"actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n    mesh: {mesh}\n"
    path = tmp_path / f"twin-{mesh.replace(':', '')}.yaml"
    path.write_text(text)
    return str(path)


def scheduler_run(conf_path, cluster, monkeypatch):
    """One ``Scheduler.run_once``; the session's task states are read just
    before the scheduler closes it."""
    seen = {}
    close = torch_scheduler.close_session

    def capture(ssn, discard=False):
        seen.update(session_state(ssn))
        close(ssn, discard=discard)

    monkeypatch.setattr(torch_scheduler, "close_session", capture)
    cache = torch_testing.FakeCache(cluster)
    sched = torch_scheduler.Scheduler(cache, conf_path)
    sched.run_once()
    monkeypatch.undo()
    return (seen, dict(cache.binder.binds), list(cache.evictor.evicts)), sched


def test_twin_conf_mirrors_the_tpu_conf():
    with open(TWIN) as f:
        twin = torch_parse(f.read())
    tpu = jax_parse(jax_read(TPU))
    assert twin.actions.replace("torch_", "xla_") == tpu.actions
    assert [[o.name for o in t.plugins] for t in twin.tiers] == [[o.name for o in t.plugins] for t in tpu.tiers]


@pytest.mark.parametrize("gen", GENERATORS)
@pytest.mark.parametrize("seed", range(12))
def test_twin_pipeline_parity(tmp_path, monkeypatch, gen, seed):
    jax_gen = getattr(JAX_GENERATORS[gen], gen)
    torch_gen = getattr(torch_testing, gen)
    with open(TPU) as f:
        tpu_text = f.read()
    want = jax_run(pipeline_actions(SERIAL_CONF, jax_parse), jax_gen(seed), SERIAL_CONF)
    assert jax_run(pipeline_actions(tpu_text, jax_parse), jax_gen(seed), tpu_text) == want
    serial_args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}
    assert torch_run(SERIAL_SCANS_ACTIONS, torch_gen(seed), SERIAL_CONF, serial_args) == want
    for mesh, tier in (("off", "fused"), ("cpu:4", "sharded")):
        got, sched = scheduler_run(twin_conf(tmp_path, mesh), torch_gen(seed), monkeypatch)
        assert got == want, f"{gen} seed {seed} mesh {mesh}"
        act = next(a for a in sched.actions if a.name == "torch_allocate")
        if act.last_solver_tier != "none":
            assert act.last_solver_tier == tier
        assert {f"{a.name}_s" for a in sched.actions} <= set(sched.last_timings)


def test_twin_sweep_binds_and_evicts(tmp_path, monkeypatch):
    """The sweep is not tame (test_pipeline_parity.py's bar): more than
    10 binds and more than 10 evicts over the 24 worlds of the twin."""
    binds = evicts = 0
    path = twin_conf(tmp_path, "off")
    for seed in range(12):
        for gen in GENERATORS:
            (_, b, e), _ = scheduler_run(path, getattr(torch_testing, gen)(seed), monkeypatch)
            binds += len(b)
            evicts += len(e)
    assert binds > 10 and evicts > 10, (binds, evicts)
