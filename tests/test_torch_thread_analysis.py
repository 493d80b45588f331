"""The port's concurrency sanitizer (kube_batch_tpu_torch.analysis.threads)
and its runtime half, the happens-before RaceWitness
(kube_batch_tpu_torch.utils.race), case for case with
tests/test_thread_analysis.py on the port's tree, then held against the
JAX package at tolerance 0: (d) the same event sequences give the same
RaceWitness reports, and (e) ``threads.witness_drive`` with the same
arguments gives the same verdicts (its access and backlog counts follow
the drain thread's timing, in either package).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import threading

import pytest

from kube_batch_tpu.analysis import threads as threads_ref
from kube_batch_tpu.utils.race import RaceWitness as RaceWitnessRef
from kube_batch_tpu_torch.analysis import (
    SourceFile,
    apply_baseline,
    baseline_path,
    load_baseline,
    load_tree,
)
from kube_batch_tpu_torch.analysis import threads
from kube_batch_tpu_torch.utils.race import RaceWitness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sf(path: str, source: str) -> SourceFile:
    return SourceFile(path, source, ast.parse(source, path))


# -- seeded fixtures: every code fires, every negative twin stays silent ------


@pytest.mark.parametrize("name", sorted(threads.FIXTURES))
def test_fixture_matches_seeded_expectations(name):
    source = threads.FIXTURES[name]
    got = {(f.code, f.line) for f in threads.analyze([sf(f"fixture:{name}", source)])}
    want = threads._expected(source)
    assert got == want, f"{name}: expected {sorted(want)} got {sorted(got)}"
    if name.endswith("_pos"):
        assert want, f"{name} seeds no # VIOLATION: markers"
        code = "KBT-" + name.split("_")[0].upper()
        assert {c for c, _ in want} == {code}
    else:
        assert not want
    # the fixtures are the JAX package's, and so are the findings
    assert source == threads_ref.FIXTURES[name]
    ref = threads_ref.analyze([threads_ref.SourceFile(f"fixture:{name}", source, ast.parse(source))])
    assert {(f.code, f.line, f.symbol) for f in ref} == {
        (f.code, f.line, f.symbol) for f in threads.analyze([sf(f"fixture:{name}", source)])
    }


def test_selfcheck_is_clean():
    assert threads.selfcheck() == []


def test_t001_noqa_suppresses():
    source = "\n".join(
        line + "  # noqa: KBT-T001" if "# VIOLATION:" in line else line
        for line in threads.FIXTURES["t001_pos"].splitlines()
    )
    assert threads.analyze([sf("fixture:t001_noqa", source)]) == []


# -- RaceWitness: the vector-clock edges, exercised directly ------------------


class Box:
    def __init__(self) -> None:
        self.field = 0


def _lock_ordered(witness_cls) -> list:
    w = witness_cls()
    box = w.watch(Box(), ["field"])
    mu = w.wrap("box.mu", threading.Lock())
    first = threading.Event()

    def a() -> None:
        with mu:
            box.field = 1
        first.set()

    def b() -> None:
        first.wait(5.0)
        with mu:
            box.field = 2

    ta, tb = w.spawn(a, name="lock-a"), w.spawn(b, name="lock-b")
    ta.start(), tb.start()
    ta.join(5.0), tb.join(5.0)
    return list(w.reports)


def _join_ordered(witness_cls) -> list:
    w = witness_cls()
    box = w.watch(Box(), ["field"])

    def child() -> None:
        box.field = 1

    t = w.spawn(child, name="join-child")
    t.start()
    t.join(5.0)
    box.field = 2  # ordered by the join edge, no lock needed
    return list(w.reports)


def _race_once(witness_cls) -> list:
    w = witness_cls()
    box = w.watch(Box(), ["field"])
    first = threading.Event()

    def a() -> None:
        box.field = 1
        first.set()

    def b() -> None:
        first.wait(5.0)  # an Event is NOT a happens-before edge
        box.field = 2

    ta, tb = w.spawn(a, name="race-a"), w.spawn(b, name="race-b")
    ta.start(), tb.start()
    ta.join(5.0), tb.join(5.0)
    return list(w.reports)


def test_witness_lock_ordered_accesses_are_clean():
    assert _lock_ordered(RaceWitness) == []


def test_witness_join_ordered_accesses_are_clean():
    assert _join_ordered(RaceWitness) == []


def test_witness_catches_true_race_with_deterministic_trace_id():
    r1 = _race_once(RaceWitness)
    assert r1, "unordered cross-thread writes must be reported"
    assert "[trace Box.field:0-1]" in r1[0]
    # same drive, same seq numbers, same report text: replayable
    assert _race_once(RaceWitness) == r1


def test_witness_selfcheck_is_clean():
    assert threads.witness_selfcheck() == []


# -- live smokes --------------------------------------------------------------


def test_witness_drive_over_streaming_bind_path_is_clean():
    res = threads.witness_drive(writers=2, events_per_writer=20)
    assert res["ok"], res["reports"] or res["leaked"]
    assert res["accesses"] > 0, "the drive must actually touch watched fields"
    assert res["leaked"] == []


def test_live_tree_is_clean_under_committed_baseline():
    findings = threads.analyze(load_tree(REPO))
    bl = load_baseline(baseline_path(REPO), REPO)
    assert bl.errors == [], [e.message for e in bl.errors]
    kept, _suppressed, _stale = apply_baseline(findings, bl)
    kept = [f for f in kept if f.code.startswith("KBT-T")]
    assert kept == [], "unsuppressed findings:\n" + "\n".join(f.render() for f in kept)


def test_cli_json_clean_exit():
    proc = subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch.analysis.threads", "--json", "--strict"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["selfcheck"]["static"] == []
    assert summary["selfcheck"]["witness"] == []


# -- (d) and (e): parity with the JAX package ---------------------------------


@pytest.mark.parametrize("drill", [_lock_ordered, _join_ordered, _race_once], ids=lambda d: d.__name__)
def test_race_witness_reports_equal_the_jax_witness(drill):
    assert drill(RaceWitness) == drill(RaceWitnessRef)


def test_witness_drive_equals_the_jax_drive():
    # "accesses" and "backlog" count the drain thread's polls and prunes,
    # which follow the host's thread timing in both packages alike (two
    # runs of one package differ); the verdicts must not
    kwargs = {"writers": 2, "events_per_writer": 20}
    got, want = threads.witness_drive(**kwargs), threads_ref.witness_drive(**kwargs)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("ok", "reports", "leaked")} == {k: want[k] for k in ("ok", "reports", "leaked")}
    assert got["ok"] and got["accesses"] > 0 and want["accesses"] > 0


def test_live_tree_thread_findings_equal_the_jax_analyzer():
    files = load_tree(REPO)
    ref_files = [threads_ref.SourceFile(f.path.replace("kube_batch_tpu_torch/", "kube_batch_tpu/", 1),
                                        f.source, f.tree) for f in files]
    got = {(f.code, f.path, f.line, f.symbol) for f in threads.analyze(files)}
    want = {(f.code, f.path.replace("kube_batch_tpu/", "kube_batch_tpu_torch/", 1), f.line, f.symbol)
            for f in threads_ref.analyze(ref_files)}
    assert got == want
