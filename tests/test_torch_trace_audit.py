"""The port's warm-cycle audit (kube_batch_tpu_torch.analysis.trace) and
its build sentinel, case for case with tests/test_trace_audit.py.

The JAX file's jaxpr cases become their torch counterparts: a recorded
sync at a site the trace baseline does not name fires KBT-P001 (the
attribution and baseline logic run here on recorded warnings; the sync
audit itself needs a card, and chip_smoke.py runs it there), a sync
seeded in a loop of a card solve path fires KBT-J001 through the call
closure, a seeded float64 field fires KBT-P002, a seeded drift fires
KBT-P005, and a seeded source-hash change forces a kernel rebuild that
the sentinel counts (a stand-in compiler, since this host has no nvcc).
P003 and P004 audit the tensor arena: each fires on a deliberately bad
arena (one that uploads unchanged slabs whole, one whose row update moves
the buffer) and stays quiet on the real one, over a warm cycle and over
seeded uploads; the JAX cases' large-constant, small-constant,
threshold (here: any size fires), unhonorable-donation and honored-scatter shapes map onto them.
The rungs run their plain versions here.
"""

from __future__ import annotations

import ast
import os
import stat
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.analysis import CODES, SourceFile, apply_baseline, baseline_path, load_baseline
from kube_batch_tpu_torch.analysis import torch_hazards, trace
from kube_batch_tpu_torch.analysis.trace import (
    SYNC_WARNING,
    attribute_syncs,
    build_snapshot,
    check_f64,
    check_signature_drift,
    check_syncs,
    state_signature,
)
from kube_batch_tpu_torch.analysis.trace.sentinel import CompileBudgetExceeded, CompileSentinel
from kube_batch_tpu_torch.ops import encode_cache, nvcc
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.kernels import init_state, solve_allocate_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "kube_batch_tpu_torch")
TRACE_BASELINE = baseline_path(REPO, "trace")


def codes(findings) -> list[str]:
    return [f.code for f in findings]


@pytest.fixture(scope="module")
def snapshot():
    return build_snapshot()


@pytest.fixture(scope="module")
def live_audit():
    return trace.run_trace_audit("cpu")


def _record(filename: str, lineno: int, message: str = SYNC_WARNING + " at some site"):
    return warnings.WarningMessage(UserWarning(message), UserWarning, filename, lineno)


# -- KBT-P001: host syncs in a warm cycle ------------------------------------


def test_p001_unbaselined_sync_site_fires():
    path = os.path.join(PORT_DIR, "ops", "fused_solve.py")
    line = next(i for i, text in enumerate(open(path).read().splitlines(), 1) if "def pack_state" in text) + 2
    sites = attribute_syncs([_record(path, line)] * 3)
    assert sites == {("kube_batch_tpu_torch/ops/fused_solve.py", line, "pack_state"): 3}
    findings = check_syncs(sites, "a warm cycle")
    assert codes(findings) == ["KBT-P001"]
    assert findings[0].symbol == "pack_state" and "3 host sync(s)" in findings[0].message
    bl = load_baseline(TRACE_BASELINE, REPO)
    kept, _, _ = apply_baseline(findings, bl)
    assert kept == findings  # pack_state makes no sync on purpose: a new site is a finding


def test_p001_cycle_without_syncs_clean():
    records = [_record(os.path.join(PORT_DIR, "ops", "fused_solve.py"), 10, "some other warning")]
    assert attribute_syncs(records) == {}
    assert check_syncs({}, "a warm cycle") == []


def _def_line(path: str, qualname: str) -> int:
    """The line of ``def`` of the function ``qualname`` in the port file
    ``path`` (repo-relative)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                q = prefix + child.name
                if q == qualname and isinstance(child, ast.FunctionDef):
                    return child.lineno
                found = walk(child, q + ".")
                if found:
                    return found
        return 0

    return walk(tree, "")


def _sites_at_the_bounds(bl) -> dict:
    """Recorded syncs inside each KBT-P001 entry's function, as many as
    its max_count allows."""
    records = []
    for s in bl.suppressions:
        if s.code == "KBT-P001":
            records += [_record(os.path.join(REPO, s.path), _def_line(s.path, s.symbol) + 1)] * s.max_count
    return attribute_syncs(records)


def test_p001_baselined_sites_within_their_max_count_pass():
    bl = load_baseline(TRACE_BASELINE, REPO)
    sites = _sites_at_the_bounds(bl)
    assert {q for _, _, q in sites} == {s.symbol for s in bl.suppressions if s.code == "KBT-P001"}
    kept, suppressed, _ = trace.apply_trace_baseline(check_syncs(sites, "a warm cycle"), bl, sites)
    assert kept == [] and len(suppressed) == len(sites)


def test_p001_an_extra_repeat_past_max_count_fires():
    bl = load_baseline(TRACE_BASELINE, REPO)
    sites = _sites_at_the_bounds(bl)
    key = next(k for k in sites if k[2] == "FusedSolver.solve")
    sites[key] += 1  # a per-solve sync made once more
    kept, _, _ = trace.apply_trace_baseline(check_syncs(sites, "a warm cycle"), bl, sites)
    assert [(f.code, f.symbol) for f in kept] == [("KBT-P001", "FusedSolver.solve>max_count")]
    assert "past the trace baseline's max_count" in kept[0].message


def test_p001_a_new_line_in_a_baselined_function_fires():
    bl = load_baseline(TRACE_BASELINE, REPO)
    sites = _sites_at_the_bounds(bl)
    path = "kube_batch_tpu_torch/ops/fused_solve.py"
    new = attribute_syncs([_record(os.path.join(REPO, path), _def_line(path, "FusedSolver.solve") + 2)])
    assert list(new) == [(path, _def_line(path, "FusedSolver.solve") + 2, "FusedSolver.solve")]
    sites.update(new)
    kept, _, _ = trace.apply_trace_baseline(check_syncs(sites, "a warm cycle"), bl, sites)
    assert [(f.code, f.symbol) for f in kept] == [("KBT-P001", "FusedSolver.solve>max_count")]
    assert "at 2 site(s)" in kept[0].message


def test_p001_entry_without_a_count_bound_is_a_baseline_error(tmp_path):
    path = tmp_path / "trace-baseline.toml"
    path.write_text(
        '[[suppress]]\ncode = "KBT-P001"\npath = "kube_batch_tpu_torch/ops/fused_solve.py"\n'
        'symbol = "Packed.to"\nreason = "statics upload"\n\n'
        '[[suppress]]\ncode = "KBT-P001"\npath = "kube_batch_tpu_torch/ops/fused_solve.py"\n'
        'symbol = "FusedSolver.solve"\nmax_count = "a few"\nreason = "the solve\'s own"\n'
    )
    bl = load_baseline(str(path), str(tmp_path))
    assert [(e.code, e.symbol) for e in bl.errors] == [("KBT-B001", "parse:11")]
    kept, _, _ = trace.apply_trace_baseline([], bl, {})
    assert [(f.code, f.symbol) for f in kept] == [
        ("KBT-B001", "max_count:kube_batch_tpu_torch/ops/fused_solve.py:Packed.to"),
        ("KBT-B001", "max_count:kube_batch_tpu_torch/ops/fused_solve.py:FusedSolver.solve"),
    ]


def test_trace_entry_points_default_to_the_card(monkeypatch, snapshot):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.run_trace_audit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.rung_states(snapshot)


SEEDED_LOOP_SYNC = '''
import torch

class Solver:
    def solve(self, x: torch.Tensor):  #: card_entry
        return self._loop(x)

    def _loop(self, x: torch.Tensor):
        while x.numel() > 0:               # numel() is a host value: no sync
            x = self._step(x)
            done = bool(x.sum() == 0)      # VIOLATION J001: a read per iteration
            if done:
                break
        return x

    def _step(self, x: torch.Tensor):
        return x - 1
'''


def test_p001_seeded_sync_in_a_loop_found_through_the_call_closure():
    # the static half (KBT-J001): a per-iteration read one call below the entry
    sf = SourceFile("kube_batch_tpu_torch/ops/fix.py", SEEDED_LOOP_SYNC, ast.parse(SEEDED_LOOP_SYNC))
    findings = torch_hazards.analyze([sf])
    assert [(f.code, f.symbol) for f in findings] == [("KBT-J001", "Solver._loop.bool")]
    # without a card entry point nothing reaches the loop
    plain = SEEDED_LOOP_SYNC.replace("  #: card_entry", "")
    assert torch_hazards.analyze([SourceFile(sf.path, plain, ast.parse(plain))]) == []


# -- KBT-P002: float64 leaks -------------------------------------------------


def test_p002_seeded_f64_field_fires(snapshot):
    state = init_state(arrays_from_numpy(snapshot), True, True)
    leak = state._replace(job_alloc=state.job_alloc.to(torch.float64))
    findings = check_f64(leak, "fix", "kube_batch_tpu_torch/ops/fix.py")
    assert codes(findings) == ["KBT-P002"]
    assert findings[0].symbol == "fix.f64" and "job_alloc" in findings[0].message


def test_p002_float32_state_clean(snapshot):
    state = solve_allocate_state(arrays_from_numpy(snapshot), None, True, True)
    assert check_f64(state, "fix", "p") == []


def test_p002_deliberate_f64_inputs_exempt():
    state = solve_allocate_state(arrays_from_numpy(build_snapshot(dtype=np.float64)), None, True, True)
    assert "float64" in {d for _, d in state_signature(state).values()}
    assert codes(check_f64(state, "fix", "p")) == ["KBT-P002"]
    assert check_f64(state, "fix", "p", inputs_f64=True) == []


# -- KBT-P003 / P004: the tensor arena ----------------------------------------


class _AlwaysWhole(encode_cache.TensorArena):
    """P003's bad arena: it forgets its memo, so every upload goes up whole."""

    def upload(self, name, host, mesh=None, device=None):
        self._slots.pop((name, self._bank), None)
        return super().upload(name, host, mesh=mesh, device=device)


class _CopyingRows(encode_cache.TensorArena):
    """P004's bad arena: a row update that lands in a new buffer."""

    def upload(self, name, host, mesh=None, device=None):
        before = self.row_updates
        out = super().upload(name, host, mesh=mesh, device=device)
        if self.row_updates != before:
            slot = self._slots[(name, self._bank)]
            slot.device = out = slot.device.clone()
        return out


def _audited(arena, steps) -> list:
    with trace.ArenaAudit(arena) as audit:
        for name, host in steps:
            arena.upload(name, host)
    return audit.records


def _warm_steps() -> list:
    host = np.arange(4096, dtype=np.float32)
    churn = host.copy()
    churn[7] = -1.0
    return [("fused_fstatic", host), ("fused_fstatic", host.copy()), ("fused_fstatic", churn)]


def test_p003_keeps_its_code_and_explain_text():
    title, body = CODES["KBT-P003"]
    assert "re-uploaded" in title and "arena" in body


def test_p003_unchanged_slab_uploaded_whole_fires():
    # the equal copy goes up whole (the first upload has no memo, the churn
    # changed content)
    findings = trace.check_arena(_audited(_AlwaysWhole("cpu"), _warm_steps()), "fix")
    assert codes(findings) == ["KBT-P003"]
    assert findings[0].symbol == "arena.fused_fstatic.full_upload"
    assert "16384 B" in findings[0].message


def test_p003_changed_slab_uploaded_whole_clean():
    # a full upload of content that did change (most rows) is not a re-upload
    host = np.arange(64, dtype=np.float32)
    records = _audited(encode_cache.TensorArena("cpu"), [("fused_fstatic", host), ("fused_fstatic", host * 3)])
    assert [r["kind"] for r in records] == ["full", "full"]
    assert trace.check_arena(records, "fix") == []


def test_p003_fires_whatever_the_slab_size():
    # the JAX audit's threshold is for captured constants; an arena
    # re-upload of equal content is waste at any size
    tiny = np.arange(4, dtype=np.float32)
    records = _audited(_AlwaysWhole("cpu"), [("fused_fstatic", tiny), ("fused_fstatic", tiny.copy())])
    findings = trace.check_arena(records, "fix")
    assert codes(findings) == ["KBT-P003"] and "16 B" in findings[0].message


def test_p003_nothing_fires_it_yet(live_audit):
    """The real arena over the live audit's warm cycle: quiet, and the
    cycle did reuse the fused rung's statics."""
    findings, info = live_audit
    assert "KBT-P003" not in codes(findings)
    assert info["arena"]["by_name"] == {"fused_istatic": "reuse", "fused_fstatic": "reuse"}


def test_p003_threshold_explained_on_the_cli():
    res = subprocess.run([sys.executable, "-m", "kube_batch_tpu_torch.analysis.trace", "--explain", "KBT-P003"],
                         cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0 and "KBT-P003" in res.stdout


def test_p004_names_the_arena_row_update():
    title, body = CODES["KBT-P004"]
    assert "in place" in title and "index_copy_" in body


def test_p004_row_update_into_a_new_buffer_fires():
    findings = trace.check_arena(_audited(_CopyingRows("cpu"), _warm_steps()), "fix")
    assert codes(findings) == ["KBT-P004"]
    assert findings[0].symbol == "arena.fused_fstatic.row_update"


def test_p004_row_update_in_place_clean():
    records = _audited(encode_cache.TensorArena("cpu"), _warm_steps())
    assert [r["kind"] for r in records] == ["full", "reuse", "row"]
    assert records[2]["ptr_before"] == records[2]["ptr_after"]
    assert trace.check_arena(records, "fix") == []


def test_p004_nothing_fires_it_yet(live_audit):
    findings, _ = live_audit
    assert "KBT-P004" not in codes(findings)


# -- KBT-P005: cross-rung signature drift ------------------------------------


def test_p005_signature_drift_fires_per_field():
    ref = {"it": ((), "int32"), "idle": ((128, 2), "float32")}
    other = {"it": ((), "int64"), "idle": ((128, 2), "float32")}
    findings = check_signature_drift(ref, other, "twin", "sharded@2", "p")
    assert codes(findings) == ["KBT-P005"]
    assert findings[0].symbol == "sharded@2.drift.it"


def test_p005_missing_field_counts_as_drift_both_ways():
    ref = {"it": ((), "int32")}
    assert codes(check_signature_drift(ref, {}, "a", "b", "p")) == ["KBT-P005"]
    assert codes(check_signature_drift({}, ref, "a", "b", "p")) == ["KBT-P005"]


def test_p005_seeded_drift_in_a_rung_state_fires(snapshot):
    state = solve_allocate_state(arrays_from_numpy(snapshot), None, True, True)
    drifted = state._replace(ntasks=state.ntasks.to(torch.int64))
    assert check_signature_drift(state_signature(state), state_signature(state), "twin", "fused", "p") == []
    findings = check_signature_drift(state_signature(state), state_signature(drifted), "twin", "fused", "p")
    assert [f.symbol for f in findings] == ["fused.drift.ntasks"]


# -- build sentinel ----------------------------------------------------------


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A csrc/ with one kernel source and a stand-in nvcc that writes its
    -o target, so a build runs end to end without a CUDA toolkit."""
    csrc, build, cuda = tmp_path / "csrc", tmp_path / "build", tmp_path / "cuda"
    csrc.mkdir()
    (cuda / "bin").mkdir(parents=True)
    (csrc / "k.cu").write_text("// v0\n")
    fake = cuda / "bin" / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(nvcc, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(build))
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    return csrc


def test_sentinel_counts_a_seeded_rebuild_storm(fake_toolchain):
    with CompileSentinel("storm") as cs:
        for i in range(1, 4):
            (fake_toolchain / "k.cu").write_text(f"// v{i}: a source-hash change\n")
            nvcc.build(["k"])
    # every distinct source hash is a fresh nvcc run
    assert cs.builds == 3 and cs.compiles >= 3


def test_sentinel_budget_zero_raises_on_churn(fake_toolchain):
    with pytest.raises(CompileBudgetExceeded, match="rebuilding"):
        with CompileSentinel("storm", budget=0):
            (fake_toolchain / "k.cu").write_text("// changed\n")
            nvcc.build(["k"])


def test_sentinel_warm_loop_is_free(fake_toolchain):
    nvcc.build(["k"])  # built outside the region
    with CompileSentinel("warm", budget=0) as cs:
        for _ in range(3):
            nvcc.build(["k"])
    assert cs.compiles == 0


def test_sentinel_never_masks_an_exception_in_flight(fake_toolchain):
    with pytest.raises(ValueError, match="boom"):
        with CompileSentinel("mask", budget=0):
            (fake_toolchain / "k.cu").write_text("// blows the budget\n")
            nvcc.build(["k"])
            raise ValueError("boom")  # ...but the real error wins


# -- acceptance: zero builds across 3 warm cycles ----------------------------


def test_fused_rung_three_warm_cycles_zero_builds(snapshot):
    from kube_batch_tpu_torch.ops.fused_solve import FusedSolver

    solver = FusedSolver(arrays_from_numpy(snapshot), True, True, device="cpu")
    want = solver.solve()
    with CompileSentinel("fused warm cycles", budget=0) as cs:
        for _ in range(3):
            got = solver.solve()
    assert cs.compiles == 0
    assert state_signature(got) == state_signature(want)


def test_sharded_rung_three_warm_cycles_zero_builds(snapshot):
    from kube_batch_tpu_torch.parallel.sharded_block import ShardedBlockSolver

    solver = ShardedBlockSolver(arrays_from_numpy(snapshot), ["cpu"] * 2, True, True)
    solver.solve()
    with CompileSentinel("sharded@2 warm cycles", budget=0) as cs:
        for _ in range(3):
            solver.solve()
    assert cs.compiles == 0


# -- live tree ---------------------------------------------------------------


def test_snapshot_speaks_the_action_layer_contract(snapshot):
    assert "task_created" not in snapshot
    for k in ("w_least", "w_balanced", "w_aff", "w_podaff"):
        assert snapshot[k].dtype == np.float32
    n_nodes = snapshot["node_idle"].shape[0]
    assert all(n_nodes % m == 0 for m in trace.MESH_SIZES_DEFAULT)


def test_live_tree_trace_audit_clean_under_committed_baseline(live_audit):
    findings, info = live_audit
    bl = load_baseline(TRACE_BASELINE, REPO)
    assert bl.errors == [], [e.message for e in bl.errors]
    kept, _suppressed, _stale = trace.apply_trace_baseline(findings, bl, info["sync_sites"])
    assert kept == [], "unsuppressed trace findings:\n" + "\n".join(f.render() for f in kept)
    # every rung actually ran
    assert {"twin", "fused", "class"} <= set(info["entries"])
    assert any(e.startswith("sharded@") for e in info["entries"])
    assert info["p001"].startswith("not run")


# -- the sync audit's bookkeeping (on recorded warnings and a stand-in mode) --


def test_sync_attribution_counts_every_repeat_and_names_the_function():
    path = os.path.join(PORT_DIR, "parallel", "sharded_block.py")
    src = open(path).read().splitlines()
    line = next(i for i, text in enumerate(src, 1) if "host.copy_(buf)" in text)
    outside = _record("/usr/lib/python3/site-packages/torch/_tensor.py", 7)
    sites = attribute_syncs([_record(path, line)] * 1614 + [outside, outside])
    assert sites[("kube_batch_tpu_torch/parallel/sharded_block.py", line, "ShardedBlockSolver._exchange")] == 1614
    assert sites[("<outside>/torch/_tensor.py", 7, "<outside>")] == 2


class _FakeMode:
    def __init__(self):
        self.mode, self.calls = 0, []

    def get(self):
        return self.mode

    def set(self, mode):
        self.calls.append(mode)
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)


def test_sync_audit_resets_the_mode_and_counts_even_when_the_region_raises(monkeypatch):
    fake = _FakeMode()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    path = os.path.join(PORT_DIR, "ops", "fused_solve.py")
    audit = trace.SyncAudit()
    with pytest.raises(RuntimeError, match="mid-cycle"):
        with audit:
            for _ in range(4):
                warnings.warn_explicit(SYNC_WARNING, UserWarning, path, 600)
            raise RuntimeError("mid-cycle")
    assert fake.calls == ["warn", 0] and fake.mode == 0
    assert audit.total == 4  # the "always" filter: no repeat is hidden


def test_no_sync_and_guard_calls_restore_on_error(monkeypatch):
    fake = _FakeMode()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)

    class Launcher:
        def __call__(self, x):
            assert fake.mode == 2
            raise ValueError(x)

    original = Launcher.__call__
    with pytest.raises(ValueError, match="launch"):
        with trace.guard_calls(Launcher, "__call__") as guard:
            Launcher()("launch")
    assert guard["calls"] == 1 and Launcher.__call__ is original
    assert fake.mode == 0 and fake.calls == ["error", 0]


def test_rung_signatures_equal_the_jax_twin(snapshot):
    jax = pytest.importorskip("jax")
    from kube_batch_tpu.analysis.trace import build_snapshot as ref_snapshot
    from kube_batch_tpu.ops.kernels import _solve_fresh

    ref = jax.eval_shape(lambda a: _solve_fresh(a, True, True), ref_snapshot())
    ref_sig = {f: (tuple(getattr(ref, f).shape), str(getattr(ref, f).dtype)) for f in ref._fields}
    states = trace.rung_states(snapshot, "cpu", (1, 4))
    for entry, st in states.items():
        assert state_signature(st) == ref_sig, entry
