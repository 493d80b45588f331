"""The port's solver ladder under injected faults, against the JAX
package's.

The JAX side runs ``xla_allocate`` as its own chaos tests run it on the CPU
(the XLA twin, its device floor; x64 off) with ``solve.xla`` armed; the
port runs ``torch_allocate`` (``device: cpu``, the kernels' plain
versions) with ``solve.fused`` armed, its device floor. On the same worlds
(the JAX chaos suite's 12-pod, 3-gang cluster and ``preempt_mix(2000, 40,
seed=1)``) both must give the clean binds, the same ``degraded_cycles``
increments and the same breaker histories through sessions (open, serial
``breaker_open``, probe, closed). Also held: ``solve.nan`` on both sides,
``solve.sharded`` on ``mesh: cpu:4`` (the fused rung resumes with the
clean binds; the JAX ``mesh_pallas`` rung fails under the installed JAX,
so that case is held against the clean binds), a deadline abort at solver
entry that leaves every breaker closed, and a kernel build error that
re-raises. On a card (``device: cuda``, pretended here with the kernels'
plain versions) only an injected fused failure degrades to serial: an
organic one raises. And ``python -m kube_batch_tpu_torch.faults.smoke``
passes its drills on the CPU."""

import pytest
import torch

import kube_batch_tpu.actions.xla_allocate as XA
import kube_batch_tpu.testing as jax_testing
from kube_batch_tpu import faults as jax_faults
from kube_batch_tpu import metrics as jax_metrics
from kube_batch_tpu import models as jax_models
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.actions.torch_allocate as TA
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import faults as torch_faults
from kube_batch_tpu_torch import metrics as torch_metrics
from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import open_session as torch_open
from kube_batch_tpu_torch.ops.nvcc import KernelBuildError
from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded

from test_xla_allocate import DEFAULT_TIERS_YAML

CPU = {"device": "cpu", "min_device_pairs": "0"}
MESH = {**CPU, "mesh": "cpu:4"}


def faults_cluster(t):
    """The JAX chaos suite's world: 3 gangs x 4 pods on 4 nodes."""
    pods = [
        t.build_pod(name=f"p{i}", group_name=f"g{i % 3}", req=t.build_resource_list(cpu=1, memory="512Mi"))
        for i in range(12)
    ]
    nodes = [t.build_node(f"n{i}", t.build_resource_list(cpu=8, memory="8Gi", pods=16)) for i in range(4)]
    pgs = [t.build_pod_group(f"g{j}", min_member=4) for j in range(3)]
    return t.build_cluster(pods, nodes, pgs, [t.build_queue("default")])


WORLDS = {
    "faults_12pod": (lambda: faults_cluster(jax_testing), lambda: faults_cluster(torch_testing)),
    "preempt_mix_2000_40_seed1": (
        lambda: jax_models.preempt_mix(2000, 40, seed=1),
        lambda: torch_models.preempt_mix(2000, 40, seed=1),
    ),
}


class Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _recording(ladder):
    for b in ladder.breakers.values():
        b.history = []
        real = b._transition

        def transition(to, b=b, real=real):
            b.history.append((b.state, to))
            real(to)

        b._transition = transition
    return ladder


@pytest.fixture
def ladders(monkeypatch):
    """Fresh ladders on both sides, on one fake clock (threshold 1, a 10 s
    backoff, as the JAX chaos suite's session test), and clean registries."""
    clock = Clock()
    jl = _recording(jax_faults.DegradationLadder(
        ("mesh_pallas", "pallas", "xla", "serial"), failure_threshold=1, reset_timeout=10.0, clock=clock))
    tl = _recording(torch_faults.DegradationLadder(
        ("sharded", "fused", "serial"), failure_threshold=1, reset_timeout=10.0, clock=clock))
    monkeypatch.setattr(jax_faults, "solver_ladder", jl)
    monkeypatch.setattr(torch_faults, "solver_ladder", tl)
    jax_faults.registry.reset()
    torch_faults.registry.reset()
    yield clock, jl, tl
    jax_faults.registry.reset()
    torch_faults.registry.reset()


def jax_session(world: str):
    with x64_enabled(False):
        cache = jax_testing.FakeCache(WORLDS[world][0]())
        ssn = jax_open(cache, jax_parse(DEFAULT_TIERS_YAML).tiers)
        action = XA.XlaAllocateAction()
        action.execute(ssn)
        jax_close(ssn)
    return dict(cache.binder.binds), action


def torch_session(world: str, args=CPU, budget=None):
    cache = torch_testing.FakeCache(WORLDS[world][1]())
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers, {"torch_allocate": dict(args)})
    ssn.cycle_budget = budget
    action = TA.TorchAllocateAction()
    try:
        action.execute(ssn)
    finally:
        torch_close(ssn)
    return dict(cache.binder.binds), action


def _degraded(m, reason: str) -> float:
    return m.degraded_cycles.value({"tier": "serial", "reason": reason})


@pytest.fixture(scope="module")
def clean():
    """The undisturbed binds of each world, equal on both sides."""
    out = {}
    for world in WORLDS:
        jb, ja = jax_session(world)
        tb, ta = torch_session(world)
        assert "solve_s" in ja.last_timings and ta.last_solver_tier == "fused"
        assert jb == tb and jb
        out[world] = jb
    return out


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_device_floor_fault_degrades_to_serial_like_the_jax_action(ladders, clean, world):
    before = (_degraded(jax_metrics, "solve_failed"), _degraded(torch_metrics, "solve_failed"))
    jax_faults.registry.arm("solve.xla", count=1)
    torch_faults.registry.arm("solve.fused", count=1)
    jb, ja = jax_session(world)
    tb, ta = torch_session(world)
    assert jb == tb == clean[world]
    assert "serial_degraded_s" in ja.last_timings and "serial_degraded_s" in ta.last_timings
    assert ta.last_solver_tier == "serial" and ta.last_timings["serial_reason"] == "solve_failed"
    after = (_degraded(jax_metrics, "solve_failed"), _degraded(torch_metrics, "solve_failed"))
    assert after[0] - before[0] == after[1] - before[1] == 1


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_breaker_open_probe_close_through_sessions(ladders, clean, world):
    """Cycle 1 fails the device floor and opens its breaker; cycle 2 runs
    serially before the encode (``breaker_open``); after the backoff, cycle
    3 is the probe and closes the breaker. Binds equal throughout, and the
    JAX ``xla`` breaker and the port's ``fused`` breaker keep the same
    history."""
    clock, jl, tl = ladders
    reasons = ("solve_failed", "breaker_open")
    before = {r: (_degraded(jax_metrics, r), _degraded(torch_metrics, r)) for r in reasons}

    jax_faults.registry.arm("solve.xla", count=1)
    torch_faults.registry.arm("solve.fused", count=1)
    assert jax_session(world)[0] == torch_session(world)[0] == clean[world]
    assert jl.state("xla") == tl.state("fused") == "open"

    jb, ja = jax_session(world)
    tb, ta = torch_session(world)
    assert jb == tb == clean[world]
    assert "serial_degraded_s" in ja.last_timings
    assert ta.last_timings["serial_reason"] == "breaker_open" and "encode_s" not in ta.last_timings

    clock.t += 10.0
    jb, ja = jax_session(world)
    tb, ta = torch_session(world)
    assert jb == tb == clean[world]
    assert "solve_s" in ja.last_timings and ta.last_solver_tier == "fused"
    assert jl.state("xla") == tl.state("fused") == "closed"

    history = [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
    assert jl.breakers["xla"].history == tl.breakers["fused"].history == history
    for r in reasons:
        after = (_degraded(jax_metrics, r), _degraded(torch_metrics, r))
        assert after[0] - before[r][0] == after[1] - before[r][1] == 1, r


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_nan_weights_route_serial_on_both_sides(ladders, clean, world):
    before = (_degraded(jax_metrics, "nonfinite"), _degraded(torch_metrics, "nonfinite"))
    jax_faults.registry.arm("solve.nan", count=1)
    torch_faults.registry.arm("solve.nan", count=1)
    jb, ja = jax_session(world)
    tb, ta = torch_session(world)
    assert jb == tb == clean[world]
    assert ta.last_timings["serial_reason"] == "nonfinite: w_least" and ta.last_state is None
    after = (_degraded(jax_metrics, "nonfinite"), _degraded(torch_metrics, "nonfinite"))
    assert after[0] - before[0] == after[1] - before[1] == 1
    assert all(b.failures == 0 for b in ladders[2].breakers.values())


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_fault_resumes_on_the_fused_rung(ladders, clean, world):
    _, _, tl = ladders
    degraded = _degraded(torch_metrics, "solve_failed")
    torch_faults.registry.arm("solve.sharded", count=1)
    tb, ta = torch_session(world, MESH)
    assert tb == clean[world]
    assert ta.last_solver_tier == "fused" and ta.last_mesh_size == 4
    assert tl.breakers["sharded"].history == [("closed", "open")] and tl.state("fused") == "closed"
    assert _degraded(torch_metrics, "solve_failed") == degraded
    # with the sharded breaker open, the mesh conf solves on the fused rung
    tb, ta = torch_session(world, MESH)
    assert tb == clean[world] and ta.last_solver_tier == "fused"
    assert tl.breakers["sharded"].history == [("closed", "open")]


@pytest.mark.parametrize("args", [CPU, MESH], ids=["fused", "sharded"])
def test_a_deadline_abort_at_solver_entry_feeds_no_breaker(ladders, args):
    ticks = iter([0.0] + [100.0] * 100)
    budget = CycleBudget(hard_s=1.0, clock=lambda: next(ticks))
    with pytest.raises(CycleDeadlineExceeded, match="solver entry"):
        torch_session("faults_12pod", args, budget=budget)
    for b in ladders[2].breakers.values():
        assert b.state == "closed" and b.failures == 0 and b.history == []


@pytest.mark.parametrize("target, args", [
    ("FusedSolver.solve", CPU), ("ShardedBlockSolver.solve", MESH), ("ShardedBlockSolver", MESH),
    ("FusedSolver", CPU),
])
def test_a_kernel_build_error_reraises(monkeypatch, ladders, target, args):
    """A kernel that cannot be built or loaded would fail every cycle: it
    raises out of the action and feeds no breaker."""
    def broken(*a, **k):
        raise KernelBuildError("nvcc failed on fused_solve.cu: injected")

    cls, _, attr = target.partition(".")
    if attr:
        monkeypatch.setattr(getattr(TA, cls), attr, broken)
    else:
        monkeypatch.setattr(TA, cls, broken)
    with pytest.raises(KernelBuildError, match="injected"):
        torch_session("faults_12pod", args)
    for b in ladders[2].breakers.values():
        assert b.failures == 0 and b.history == []


def pretend_card(monkeypatch) -> None:
    """torch_allocate resolving ``device: cuda`` while its rungs run the
    kernels' plain versions on the CPU: the ladder's card-side rules,
    held without a card."""
    resolve = TA.TorchAllocateAction._resolve

    def on_card(self, args):
        _, mesh = resolve(self, {**args, "device": "cpu"})
        return torch.device("cuda"), mesh

    class PlainFused(TA.FusedSolver):
        def __init__(self, a, enable_drf, enable_proportion, device=None, arena=None):
            super().__init__(a, enable_drf, enable_proportion, device="cpu", arena=arena)

    monkeypatch.setattr(TA.TorchAllocateAction, "_resolve", on_card)
    monkeypatch.setattr(TA, "FusedSolver", PlainFused)


def _refused_launch(self, state=None):
    raise RuntimeError("fused_solve launch failed: too many resources requested for launch")


@pytest.mark.parametrize("failure", ["organic", "injected"])
def test_on_a_card_only_an_injected_fused_failure_degrades(monkeypatch, ladders, clean, failure):
    """Below the fused rung is the CPU. On a card an organic failure of the
    rung (a refused launch, an asynchronous CUDA error at the state fetch)
    would repeat every cycle, so it raises ``DeviceSolveError`` and feeds
    no breaker; ``solve.fused`` degrades the cycle to serial as on
    ``device: cpu``."""
    _, _, tl = ladders
    pretend_card(monkeypatch)
    degraded = _degraded(torch_metrics, "solve_failed")
    if failure == "organic":
        monkeypatch.setattr(TA.FusedSolver, "solve", _refused_launch)
        with pytest.raises(TA.DeviceSolveError, match="failed on cuda: RuntimeError: fused_solve launch failed"):
            torch_session("faults_12pod")
        assert all(b.failures == 0 and b.history == [] for b in tl.breakers.values())
        assert _degraded(torch_metrics, "solve_failed") == degraded
    else:
        torch_faults.registry.arm("solve.fused", count=1)
        tb, ta = torch_session("faults_12pod")
        assert tb == clean["faults_12pod"] and ta.last_device == torch.device("cuda")
        assert ta.last_solver_tier == "serial" and ta.last_timings["serial_reason"] == "solve_failed"
        assert tl.breakers["fused"].history == [("closed", "open")]
        assert _degraded(torch_metrics, "solve_failed") == degraded + 1


def test_on_a_card_an_organic_sharded_failure_resumes_on_the_fused_rung(monkeypatch, ladders, clean):
    """The sharded rung's next rung down, the fused rung, is on the same
    card: an organic sharded failure feeds its breaker and the fused rung
    resumes the segment, as an injected one does."""
    _, _, tl = ladders
    pretend_card(monkeypatch)

    def failed(self, state=None):
        raise RuntimeError("block_step launch failed: injected")

    monkeypatch.setattr(TA.ShardedBlockSolver, "solve", failed)
    tb, ta = torch_session("faults_12pod", MESH)
    assert tb == clean["faults_12pod"] and ta.last_solver_tier == "fused"
    assert tl.breakers["sharded"].history == [("closed", "open")] and tl.breakers["fused"].failures == 0


def test_the_fault_smoke_passes_every_drill_on_the_cpu(capsys):
    from kube_batch_tpu_torch.faults import smoke

    process_ladder = torch_faults.solver_ladder
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("): ok (") == len(smoke.DRILLS) == 9
    assert out.rstrip().endswith("chaos smoke: ok (9 drills)")
    assert torch_faults.solver_ladder is process_ladder


def test_the_fault_smoke_runs_on_the_card_by_default(monkeypatch):
    from kube_batch_tpu_torch.faults import smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        smoke.main([])
