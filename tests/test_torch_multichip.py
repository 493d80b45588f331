"""The port's twin of the multi-chip conf,
examples/scheduler-conf-torch-multichip.yaml (``mesh: auto``), against
the JAX package's examples/scheduler-conf-tpu-multichip.yaml on the CPU.

- The two files parse to the same tiers, the same action list modulo the
  ``xla_`` -> ``torch_`` renames, and the same ``mesh`` value.
- Each conf's pipeline (``enqueue, *_reclaim, *_allocate, *_backfill,
  *_preempt``) over one session of the same world, at ``mesh: cpu:2``,
  ``cpu:4`` and ``cpu:8``: the JAX package's on its virtual CPU mesh (jax
  x64 off), the port's sharded rung on the kernels' plain versions
  (``device: cpu``). Task states, binds and evictions are equal, and both
  actions resolved the mesh size asked for; seeded ``preempt_mix`` worlds
  (capacity short, so preempt evicts) and the pod-affinity world of
  tests/test_torch_parallel.py (host steps between sharded segments).

The card's run of this conf is ``python3 chip_smoke.py --cards``; its
CPU rehearsal is in tests/test_torch_chip_smoke.py.
"""

import os
from types import SimpleNamespace

import pytest

import kube_batch_tpu.conf as jax_conf
import kube_batch_tpu.framework as jax_framework
import kube_batch_tpu.models as jax_models
import kube_batch_tpu.testing as jax_testing
from kube_batch_tpu import actions as _jax_actions  # noqa: F401  (registers the JAX actions)
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401  (registers the JAX plugins)
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.conf as torch_conf
import kube_batch_tpu_torch.framework as torch_framework
import kube_batch_tpu_torch.models as torch_models
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import actions as _torch_actions  # noqa: F401  (registers the port's actions)
from kube_batch_tpu_torch import plugins as _torch_plugins  # noqa: F401  (registers the port's plugins)

from test_torch_parallel import _affinity_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(ROOT, "examples", "scheduler-conf-torch-multichip.yaml")
TPU = os.path.join(ROOT, "examples", "scheduler-conf-tpu-multichip.yaml")

# (name, world builder over a package's models and testing modules)
WORLDS = {
    "preempt_mix_600_12_seed1": lambda models, t: models.preempt_mix(600, 12, seed=1),
    "preempt_mix_900_20_seed2": lambda models, t: models.preempt_mix(900, 20, seed=2),
    "affinity": lambda models, t: _affinity_world(t),
}


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def at_mesh(text: str, mesh: str, device: str | None = None) -> str:
    """The conf text with its ``mesh: auto`` set to ``mesh`` (and the
    allocate action's ``device`` when given)."""
    assert text.count("    mesh: auto\n") == 1
    return text.replace("    mesh: auto\n", f"    mesh: {mesh}\n" + (f"    device: {device}\n" if device else ""))


def run_pipeline(pkg, conf, cluster):
    """The conf's actions in order over one session of ``cluster`` with
    the conf's action arguments; returns ({uid: (status, node)}, binds,
    evicts) and the allocate action."""
    cache = pkg.testing.FakeCache(cluster)
    ssn = pkg.framework.open_session(cache, conf.tiers, conf.action_arguments)
    alloc = None
    for name in (a.strip() for a in conf.actions.split(",") if a.strip()):
        action = pkg.framework.get_action(name)
        action.execute(ssn)
        if name.endswith("_allocate"):
            alloc = action
    state = {t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values()
             for d in j.task_status_index.values() for t in d.values()}
    pkg.framework.close_session(ssn)
    return (state, dict(cache.binder.binds), list(cache.evictor.evicts)), alloc


JAX = SimpleNamespace(framework=jax_framework, testing=jax_testing)
PORT = SimpleNamespace(framework=torch_framework, testing=torch_testing)


def test_twin_conf_mirrors_the_multichip_conf():
    twin = torch_conf.parse_scheduler_conf(read(TWIN))
    tpu = jax_conf.parse_scheduler_conf(jax_conf.read_scheduler_conf(TPU))
    assert twin.actions.replace("torch_", "xla_") == tpu.actions
    assert [a.strip() for a in twin.actions.split(",")] == [
        "enqueue", "torch_reclaim", "torch_allocate", "torch_backfill", "torch_preempt"]
    assert [[o.name for o in t.plugins] for t in twin.tiers] == [[o.name for o in t.plugins] for t in tpu.tiers]
    assert twin.action_arguments == {"torch_allocate": {"mesh": "auto"}}
    assert tpu.action_arguments == {"xla_allocate": {"mesh": "auto"}}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("mesh", ["cpu:2", "cpu:4", "cpu:8"])
def test_twin_conf_equals_the_multichip_conf(world, mesh):
    m = int(mesh.split(":")[1])
    make = WORLDS[world]
    with x64_enabled(False):
        tpu = jax_conf.parse_scheduler_conf(at_mesh(jax_conf.read_scheduler_conf(TPU), mesh))
        want, jax_alloc = run_pipeline(JAX, tpu, make(jax_models, jax_testing))
    twin = torch_conf.parse_scheduler_conf(at_mesh(read(TWIN), mesh, "cpu"))
    got, alloc = run_pipeline(PORT, twin, make(torch_models, torch_testing))
    assert jax_alloc.last_mesh_size == alloc.last_mesh_size == m
    assert alloc.last_solver_tier == "sharded"
    assert got[1:] == want[1:], f"{world} at {mesh}: binds or evictions differ"
    assert got == want, f"{world} at {mesh}: task states differ"
    assert want[1]


def test_the_parity_worlds_evict_and_pause():
    """The sweep is not tame: the preempt_mix worlds evict under the
    multi-chip pipeline, and the affinity world's sharded solve pauses for
    host steps."""
    twin = torch_conf.parse_scheduler_conf(at_mesh(read(TWIN), "cpu:4", "cpu"))
    evicts = 0
    for name in ("preempt_mix_600_12_seed1", "preempt_mix_900_20_seed2"):
        (_, _, ev), _ = run_pipeline(PORT, twin, WORLDS[name](torch_models, torch_testing))
        evicts += len(ev)
    assert evicts > 0
    _, alloc = run_pipeline(PORT, twin, WORLDS["affinity"](torch_models, torch_testing))
    assert alloc.last_timings["host_steps"] >= 2
