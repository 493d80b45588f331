"""The port's cycle budget (soft and hard deadlines, ``remaining``, the
``cycle.overrun`` fault point) beside the JAX package's, and through
``Scheduler.run_once``: an injected overrun discards the session with the
cache unchanged, and the soft-overrun streak trips the same tier at the
same cycle as the JAX scheduler's ``_arm_tier_downgrade``; on a card the
streak trips the sharded tier but never moves a fused cycle to the CPU."""

import numpy as np
import pytest

from kube_batch_tpu import faults as jax_faults
from kube_batch_tpu import metrics as jax_metrics
from kube_batch_tpu.recovery.budget import CycleBudget as JaxBudget
from kube_batch_tpu.recovery.budget import CycleDeadlineExceeded as JaxExceeded
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import faults as torch_faults
from kube_batch_tpu_torch import metrics as torch_metrics
from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded
from kube_batch_tpu_torch.scheduler import Scheduler

from test_torch_actions import JAX, TORCH, make
from test_torch_scheduler import TORCH_CONF, port_conf
from test_torch_session import _statuses
from test_torch_solver_faults import pretend_card


class Clock:
    def __init__(self) -> None:
        self.t = 50.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clean_faults(monkeypatch):
    """Fresh ladders (threshold 3, a backoff no test outlasts) and clean
    registries on both sides."""
    jl = jax_faults.DegradationLadder(("mesh_pallas", "pallas", "xla", "serial"), reset_timeout=3600.0)
    tl = torch_faults.DegradationLadder(("sharded", "fused", "serial"), reset_timeout=3600.0)
    monkeypatch.setattr(jax_faults, "solver_ladder", jl)
    monkeypatch.setattr(torch_faults, "solver_ladder", tl)
    jax_faults.registry.reset()
    torch_faults.registry.reset()
    yield jl, tl
    jax_faults.registry.reset()
    torch_faults.registry.reset()


@pytest.mark.parametrize("seed", range(6))
def test_budget_readings_equal_the_jax_budget(seed):
    """Both budgets on one clock: elapsed, remaining, the soft and hard
    verdicts and the check's raise agree at every step."""
    rng = np.random.default_rng(seed)
    soft, hard = (None if rng.random() < 0.2 else float(rng.uniform(0.1, 2.0)) for _ in range(2))
    clock = Clock()
    jb, tb = JaxBudget(soft, hard, clock=clock), CycleBudget(soft, hard, clock=clock)
    assert (jb.soft_s, jb.hard_s) == (tb.soft_s, tb.hard_s)
    for step in rng.uniform(0.0, 0.5, size=12):
        clock.t += float(step)
        assert jb.elapsed() == tb.elapsed()
        assert jb.remaining() == tb.remaining()
        assert jb.soft_exceeded() == tb.soft_exceeded()
        assert jb.hard_exceeded() == tb.hard_exceeded()
        raised = []
        for budget, exc in ((jb, JaxExceeded), (tb, CycleDeadlineExceeded)):
            try:
                budget.check("here")
                raised.append(None)
            except exc as e:
                raised.append(str(e))
        assert raised[0] == raised[1]


def test_zero_or_negative_deadlines_are_none():
    for v in (None, 0, 0.0, -1.0):
        b = CycleBudget(v, v)
        assert b.soft_s is None and b.hard_s is None and b.remaining() == float("inf")
        assert not b.soft_exceeded() and not b.hard_exceeded()


def test_cycle_overrun_fires_only_at_the_injecting_check(clean_faults):
    """cycle.overrun is consulted only by check(inject=True), on both
    sides, and says 'injected' for its budget."""
    jax_faults.registry.arm("cycle.overrun", count=1)
    torch_faults.registry.arm("cycle.overrun", count=1)
    msgs = []
    for budget, exc in ((JaxBudget(), JaxExceeded), (CycleBudget(), CycleDeadlineExceeded)):
        budget.check("solver entry")  # not an injecting gate
        with pytest.raises(exc) as e:
            budget.check("dispatch barrier", inject=True)
        budget.check("dispatch barrier", inject=True)  # count=1: spent
        msgs.append(str(e.value).split(" (")[0] + ("injected" in str(e.value)) * " injected")
    assert msgs[0] == msgs[1] == "cycle hard deadline exceeded at dispatch barrier injected"


def _jax_conf(tmp_path):
    path = tmp_path / "jax-conf.yaml"
    path.write_text(TORCH_CONF.replace('"torch_allocate, backfill"', '"xla_allocate, backfill"'))
    return str(path)


def _port_conf(tmp_path, **args):
    path = tmp_path / "torch-conf.yaml"
    path.write_text(port_conf(device="cpu", min_device_pairs=0, **args))
    return str(path)


@pytest.mark.parametrize("key", ["gang_atomic", "preempt_mix_2000_40_seed1"])
def test_an_injected_overrun_discards_the_cycle(clean_faults, tmp_path, key):
    """cycle.overrun at the dispatch barrier: no bind, PodGroup phases and
    counts as before, ``cycle_overruns{kind="hard"}`` up by one on both sides; the
    next cycle binds what an undisturbed cycle binds."""
    with x64_enabled(False):
        clean = JAX.t.FakeCache(make(key, JAX))
        JaxScheduler(clean, _jax_conf(tmp_path)).run_once()
    hard = {"kind": "hard"}
    before = (jax_metrics.cycle_overruns.value(hard), torch_metrics.cycle_overruns.value(hard))

    with x64_enabled(False):
        jcache = JAX.t.FakeCache(make(key, JAX))
        jsched = JaxScheduler(jcache, _jax_conf(tmp_path))
        jstat = _statuses(jcache.cluster)
        jax_faults.registry.arm("cycle.overrun", count=1)
        jsched.run_once()
    tcache = torch_testing.FakeCache(make(key, TORCH))
    tsched = Scheduler(tcache, _port_conf(tmp_path))
    tstat = _statuses(tcache.cluster)
    torch_faults.registry.arm("cycle.overrun", count=1)
    tsched.run_once()

    assert jcache.binder.binds == tcache.binder.binds == {}
    # phases and counts stand; the JobValid gate's Unschedulable condition,
    # written at session open onto the PodGroup the snapshot shares, is the
    # same on both sides (as test_torch_scheduler's spent-budget case)
    for cache, before_abort in ((jcache, jstat), (tcache, tstat)):
        assert {uid: s[:4] for uid, s in _statuses(cache.cluster).items()} == {
            uid: s[:4] for uid, s in before_abort.items()}
    assert _statuses(jcache.cluster) == _statuses(tcache.cluster)
    assert "dispatch barrier" in tsched.last_timings["aborted"]
    after = (jax_metrics.cycle_overruns.value(hard), torch_metrics.cycle_overruns.value(hard))
    assert after[0] - before[0] == after[1] - before[1] == 1

    with x64_enabled(False):
        jsched.run_once()
    tsched.run_once()
    assert jcache.binder.binds == tcache.binder.binds == clean.binder.binds and clean.binder.binds


@pytest.mark.parametrize("via_env", [False, True], ids=["argument", "environment"])
def test_the_soft_overrun_streak_trips_the_same_tier_at_the_same_cycle(clean_faults, tmp_path, monkeypatch,
                                                                          via_env):
    """A soft deadline every cycle misses: both schedulers count
    ``cycle_overruns{kind="soft"}`` each cycle and trip the breaker of the
    tier the cycle ran on (JAX: ``xla``, its device floor on the CPU; the
    port: ``fused``) at the third cycle; the fourth runs serially."""
    jl, tl = clean_faults
    monkeypatch.setenv("KBT_CYCLE_SOFT_DEADLINE_S", "1e-9")
    with x64_enabled(False):
        jcache = JAX.t.FakeCache(make("preempt_mix_2000_40_seed1", JAX))
        jsched = JaxScheduler(jcache, _jax_conf(tmp_path))
    if not via_env:
        monkeypatch.delenv("KBT_CYCLE_SOFT_DEADLINE_S")
    tcache = torch_testing.FakeCache(make("preempt_mix_2000_40_seed1", TORCH))
    tsched = Scheduler(tcache, _port_conf(tmp_path), soft_deadline_s=None if via_env else 1e-9)
    soft = {"kind": "soft"}
    opened = []
    for cycle in range(4):
        before = (jax_metrics.cycle_overruns.value(soft), torch_metrics.cycle_overruns.value(soft))
        with x64_enabled(False):
            jsched.run_once()
        tsched.run_once()
        after = (jax_metrics.cycle_overruns.value(soft), torch_metrics.cycle_overruns.value(soft))
        assert after[0] - before[0] == after[1] - before[1] == 1
        opened.append((jl.state("xla"), tl.state("fused")))
    assert opened == [("closed", "closed")] * 2 + [("open", "open")] * 2
    assert jsched.actions[0].last_solver_tier == "serial" or "serial_degraded_s" in jsched.actions[0].last_timings
    assert tsched.actions[0].last_solver_tier == "serial"
    assert tsched.actions[0].last_timings["serial_reason"] == "breaker_open"
    assert jcache.binder.binds == tcache.binder.binds


def test_a_cycle_within_budget_clears_the_streak(clean_faults, tmp_path):
    _, tl = clean_faults
    tsched = Scheduler(torch_testing.FakeCache(make("gang_atomic", TORCH)), _port_conf(tmp_path),
                       soft_deadline_s=1e-9)
    tsched.run_once()
    tsched.run_once()
    assert tsched._soft_overruns == 2
    tsched._soft_deadline = 3600.0
    tsched.run_once()
    assert tsched._soft_overruns == 0 and tl.state("fused") == "closed"


def _soft_cycles(tmp_path, n: int, **args):
    """``n`` cycles of a scheduler whose soft deadline every cycle misses;
    each cycle's (tier, fused state, sharded state) and the soft overruns
    counted."""
    sched = Scheduler(torch_testing.FakeCache(make("preempt_mix_2000_40_seed1", TORCH)), _port_conf(tmp_path, **args),
                      soft_deadline_s=1e-9)
    soft = {"kind": "soft"}
    before = torch_metrics.cycle_overruns.value(soft)
    seen = []
    for _ in range(n):
        sched.run_once()
        ladder = torch_faults.solver_ladder
        seen.append((sched.actions[0].last_solver_tier, ladder.state("fused"), ladder.state("sharded")))
    return seen, torch_metrics.cycle_overruns.value(soft) - before


def test_a_slow_fused_cycle_on_a_card_stays_on_the_card(clean_faults, tmp_path, monkeypatch):
    """Below the fused rung is the CPU: on a card (pretended here, the
    kernels' plain versions) every soft overrun is counted and logged, and
    no streak trips the fused breaker."""
    pretend_card(monkeypatch)
    seen, overruns = _soft_cycles(tmp_path, 4)
    assert seen == [("fused", "closed", "closed")] * 4 and overruns == 4


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_the_soft_overrun_streak_trips_the_sharded_tier(clean_faults, tmp_path, monkeypatch, card):
    """On a mesh the streak trips the sharded tier at the third cycle, on a
    card as on the CPU (its rung below, the fused rung, is on the same
    device); the fourth cycle solves on the fused rung."""
    if card:
        pretend_card(monkeypatch)
    seen, overruns = _soft_cycles(tmp_path, 4, mesh="cpu:4")
    assert seen == [("sharded", "closed", "closed")] * 2 + [("sharded", "closed", "open"), ("fused", "closed", "open")]
    assert overruns == 4
