"""The port's interleaving model checker
(kube_batch_tpu_torch.analysis.interleave), case for case with
tests/test_interleave.py, on the CPU (``device="cpu"``: the
dispatch_vs_next_solve scenario's torch_allocate runs kernel B1's plain
version), then held against the JAX explorer at tolerance 0 (c): each
default scenario gives the same schedule count, trace ids, verdicts and
per-schedule binds in both packages.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from kube_batch_tpu.analysis import interleave as interleave_ref
from kube_batch_tpu_torch.analysis import interleave
from kube_batch_tpu_torch.analysis.interleave import (
    FIXTURES,
    SCENARIOS,
    Step,
    _schedules,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# -- enumerator unit ----------------------------------------------------------


def _step(name, fp):
    return Step(name, lambda: None, frozenset(fp))


def test_enumeration_keeps_one_order_per_commuting_pair():
    orders, pruned = _schedules([[_step("a", {"x"})], [_step("b", {"y"})]])
    assert orders == [(0, 1)]
    assert pruned == 1


def test_enumeration_keeps_both_orders_of_a_conflicting_pair():
    orders, pruned = _schedules([[_step("a", {"x"})], [_step("b", {"x"})]])
    assert orders == [(0, 1), (1, 0)]
    assert pruned == 0


def test_enumeration_counts_interleavings_of_conflicting_threads():
    t0 = [_step("a0", {"x"}), _step("a1", {"x"})]
    t1 = [_step("b0", {"x"}), _step("b1", {"x"})]
    orders, _ = _schedules([t0, t1])
    assert len(orders) == 6
    assert len(set(orders)) == 6


# -- the default scenarios ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_default_scenarios_explore_clean(name):
    report = interleave.explore(name, device=CPU)
    assert report.schedules >= 3
    assert report.counterexamples == [], [r.violations for r in report.counterexamples]


def test_explorer_is_deterministic_across_runs():
    a = interleave.explore("broken_drain", device=CPU)
    b = interleave.explore("broken_drain", device=CPU)
    assert [r.trace for r in a.results] == [r.trace for r in b.results]
    assert [r.violations for r in a.results] == [r.violations for r in b.results]


# -- the counterexample loop --------------------------------------------------


def test_broken_fixture_fails_at_exactly_one_trace():
    report = interleave.explore("broken_drain", device=CPU)
    assert report.schedules == 3
    assert [r.trace for r in report.counterexamples] == ["broken_drain:011"]
    (bad,) = report.counterexamples
    assert any("lost" in v for v in bad.violations)
    findings = report.findings()
    assert findings and all(f.code == "KBT-I001" for f in findings)
    assert "--replay broken_drain:011" in findings[0].message


def test_counterexample_replays_by_trace_id():
    bad = interleave.replay("broken_drain:011", device=CPU)
    assert any("lost" in v for v in bad.violations)
    ok = interleave.replay("broken_drain:101", device=CPU)
    assert ok.violations == []


def test_undeclared_lock_acquisition_is_a_model_error(tmp_path):
    class Mini(interleave.Scenario):
        name = "mini"
        parity = False

        def build(self):
            self._wire(nodes=1)
            self.threads = [[Step("peek_store", lambda: self.store.list("pods"), frozenset())]]

        def invariants(self):
            return []

    result = interleave._run_schedule(Mini, str(tmp_path), (0,), "mini:0", device=CPU)
    assert any("footprint under-declared" in v for v in result.violations)


def test_fixture_is_excluded_from_the_default_set():
    assert "broken_drain" in FIXTURES
    assert "broken_drain" not in SCENARIOS


# -- CLI ----------------------------------------------------------------------


def test_cli_json_reports_counterexample_and_fails():
    res = subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch.analysis.interleave",
         "--scenario", "broken_drain", "--json", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True,
    )
    assert res.returncode == 1, res.stdout + res.stderr
    payload = json.loads(res.stdout)
    (scenario,) = payload["scenarios"]
    assert scenario["name"] == "broken_drain"
    assert [c["trace"] for c in scenario["counterexamples"]] == ["broken_drain:011"]
    assert any("broken_drain:011" in f for f in payload["findings"])


def test_the_explorer_needs_a_card_unless_told_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interleave.explore("micro_vs_full")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interleave.replay("broken_drain:011")


# -- (c) parity with the JAX explorer ----------------------------------------


def _summary(report) -> list:
    return [(r.trace, r.violations, r.fingerprint) for r in report.results]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_jax_explorer(name):
    assert set(SCENARIOS) == set(interleave_ref.SCENARIOS)
    ref = interleave_ref.explore(name)
    got = interleave.explore(name, device=CPU)
    assert (got.schedules, got.pruned_branches) == (ref.schedules, ref.pruned_branches)
    assert _summary(got) == _summary(ref)
