"""The port's circuit breaker and degradation ladder (kube_batch_tpu_torch.
faults.ladder) against the JAX package's (kube_batch_tpu.faults.ladder).

Both automata are driven by the same fake clock and the same script of
``allow``, ``record_success``, ``record_failure``, ``trip`` and ``reset``
calls (and clock advances), drawn from numpy seeds and from hypothesis.
After every call their states, failure counts, backoffs, return values
and transition histories must be equal."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kube_batch_tpu import metrics as jax_metrics
from kube_batch_tpu.faults import ladder as jax_ladder

from kube_batch_tpu_torch import faults as torch_faults
from kube_batch_tpu_torch import metrics as torch_metrics
from kube_batch_tpu_torch.faults import ladder as torch_ladder

OPS = ("allow", "record_success", "record_failure", "trip", "reset", "advance")


class Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _recording(breaker):
    """Wrap a breaker's transition so its history is kept on it."""
    breaker.history = []
    real = breaker._transition

    def transition(to):
        breaker.history.append((breaker.state, to))
        real(to)

    breaker._transition = transition
    return breaker


def _pair(name: str, **kw):
    clock = Clock()
    jb = _recording(jax_ladder.CircuitBreaker(name, clock=clock, **kw))
    tb = _recording(torch_ladder.CircuitBreaker(name, clock=clock, **kw))
    return clock, jb, tb


def _view(b):
    return b.state, b.failures, b._backoff, list(b.history)


def _drive(script, threshold: int, reset_timeout: float, name: str) -> list:
    clock, jb, tb = _pair(name, failure_threshold=threshold, reset_timeout=reset_timeout,
                          backoff_factor=2.0, max_backoff=4 * reset_timeout)
    for op, arg in script:
        if op == "advance":
            clock.t += arg
            continue
        got = (getattr(jb, op)(), getattr(tb, op)())
        assert got[0] == got[1], (op, got)
        assert _view(jb) == _view(tb), op
    return tb.history


def _script(rng: np.random.Generator, n: int, reset_timeout: float) -> list:
    ops = rng.choice(len(OPS), size=n, p=[0.3, 0.15, 0.3, 0.05, 0.05, 0.15])
    return [(OPS[k], float(rng.uniform(0, 2.5 * reset_timeout)) if OPS[k] == "advance" else None) for k in ops]


@pytest.mark.parametrize("seed", range(12))
def test_breaker_histories_equal_on_seeded_scripts(seed):
    rng = np.random.default_rng(seed)
    threshold = int(rng.integers(1, 5))
    reset_timeout = float(rng.choice([0.5, 1.0, 30.0]))
    history = _drive(_script(rng, 200, reset_timeout), threshold, reset_timeout, f"parity-{seed}")
    assert history  # every seed's script moves the automaton


@settings(max_examples=60, deadline=None)
@given(
    st.lists(st.tuples(st.sampled_from(OPS), st.floats(0.0, 100.0)), max_size=60),
    st.integers(1, 4),
    st.sampled_from([1.0, 30.0]),
)
def test_breaker_histories_equal_under_hypothesis(script, threshold, reset_timeout):
    _drive(script, threshold, reset_timeout, "parity-hypothesis")


def test_open_probe_close_history_and_backoff_doubling():
    """The drill's history: three failures open, the backoff elapses, a
    failed probe re-opens with the backoff doubled (capped), a good probe
    closes and resets it; the same on both sides."""
    clock, jb, tb = _pair("parity-drill", failure_threshold=3, reset_timeout=1.0, max_backoff=1.5)
    for b in (jb, tb):
        for _ in range(3):
            b.record_failure()
        assert b.state == "open" and not b.allow()
    clock.t += 1.0
    for b in (jb, tb):
        assert b.allow() and b.state == "half_open"
        b.record_failure()
        assert b.state == "open" and b._backoff == 1.5  # doubled, capped
    clock.t += 1.5
    for b in (jb, tb):
        assert b.allow()
        b.record_success()
        assert b.state == "closed" and b._backoff == 1.0
    assert jb.history == tb.history == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "open"), ("open", "half_open"),
        ("half_open", "closed"),
    ]


@pytest.mark.parametrize("op", ["record_success", "record_failure", "trip", "state"])
def test_ladder_floor_has_no_breaker(op):
    """The bottom rung (serial) has no breaker on either side: it always
    allows and its state is closed, whatever is recorded against it."""
    jl = jax_ladder.DegradationLadder(("a", "b", "serial"), failure_threshold=1)
    tl = torch_ladder.DegradationLadder(("a", "b", "serial"), failure_threshold=1)
    for ladder in (jl, tl):
        assert set(ladder.breakers) == {"a", "b"}
        getattr(ladder, op)("serial")
        assert ladder.allow("serial") and ladder.state("serial") == "closed"


def test_transitions_are_metered_under_the_jax_names():
    """Each transition increments breaker_transitions{tier,from,to} and sets
    breaker_state{tier} on both sides, by the same amounts."""
    labels = {"tier": "parity-metered", "from": "closed", "to": "open"}
    before = (jax_metrics.breaker_transitions.value(labels), torch_metrics.breaker_transitions.value(labels))
    _, jb, tb = _pair("parity-metered", failure_threshold=1)
    for b in (jb, tb):
        b.record_failure()
    after = (jax_metrics.breaker_transitions.value(labels), torch_metrics.breaker_transitions.value(labels))
    assert after[0] - before[0] == after[1] - before[1] == 1
    assert jax_metrics.breaker_state.value({"tier": "parity-metered"}) == 2.0
    assert torch_metrics.breaker_state.value({"tier": "parity-metered"}) == 2.0
    assert torch_metrics.breaker_transitions.name == jax_metrics.breaker_transitions.name


def test_process_ladder_tiers_and_environment(monkeypatch):
    """The process ladder runs sharded -> fused -> serial, sized by
    KBT_BREAKER_THRESHOLD and KBT_BREAKER_RESET_S as the JAX package's."""
    assert torch_faults.solver_ladder.tiers == ("sharded", "fused", "serial")
    monkeypatch.setenv("KBT_BREAKER_THRESHOLD", "5")
    monkeypatch.setenv("KBT_BREAKER_RESET_S", "oops")
    assert torch_faults._env_int("KBT_BREAKER_THRESHOLD", 3) == 5
    assert torch_faults._env_float("KBT_BREAKER_RESET_S", 30.0) == 30.0
    for point in ("solve.sharded", "solve.fused", "solve.nan", "cycle.overrun"):
        assert point in torch_faults.POINTS
