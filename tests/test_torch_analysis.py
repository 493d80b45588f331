"""The port's static analysis suite (kube_batch_tpu_torch.analysis), case
for case with tests/test_analysis.py, on the port's tree and fixtures,
then held against the JAX package's analyzers.

Each analyzer (A1 lock discipline, A2 torch hazards, A3 registry
consistency, A4 snapshot escape, A5 lock order, A6 protocol lifecycles)
is proven on a seeded-violation fixture plus its compliant twin; the
live port tree must be clean under the port's committed baseline; the
CLI keeps the JAX package's exit codes and --prune contract (on copies
of the baseline under tmp_path, never the committed file).

Parity, tolerance 0 (sets of (code, path, line, symbol)):
(a) every fixture source goes through the JAX analyzer (at its JAX path)
    and the port's (at the port path): equal findings, except the A2
    fixture, whose J001-J003 follow the torch scope here;
(b) the JAX analyzers over the port's tree (paths aliased back to
    kube_batch_tpu/, so the JAX seed maps match) against the port's
    analyzers over the same tree: equal but for the written difference
    list. A seed map that keys on no file would pass vacuously, so every
    path and class they name must exist, and a guarded access seeded into
    a copy of the port's cache must fire.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from kube_batch_tpu.analysis import (
    jax_hazards as jax_hazards_ref,
    lock_discipline as lock_discipline_ref,
    lock_order as lock_order_ref,
    protocol as protocol_ref,
    registry_consistency as registry_ref,
    run_suite as run_suite_ref,
    snapshot_escape as snapshot_escape_ref,
)
from kube_batch_tpu.analysis import SourceFile as RefSourceFile
from kube_batch_tpu_torch.analysis import (
    SourceFile,
    apply_baseline,
    baseline_path,
    load_baseline,
    load_tree,
    run_suite,
)
from kube_batch_tpu_torch.analysis import (
    lock_discipline,
    lock_order,
    protocol,
    registry_consistency,
    snapshot_escape,
    threads,
    torch_hazards,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "kube_batch_tpu_torch"
COMMITTED_BASELINE = baseline_path(REPO)
CLI = [sys.executable, "-m", "kube_batch_tpu_torch.analysis"]


def sf(path: str, source: str) -> SourceFile:
    return SourceFile(path, source, ast.parse(source, path))


def codes(findings) -> list[str]:
    return [f.code for f in findings]


# -- A1: lock discipline -----------------------------------------------------

A1_FIXTURE = '''
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0        #: guarded_by _lock
        self._items = {}     #: guarded_by _lock

    def bad(self):
        self._seq += 1       # VIOLATION: no lock held

    def good(self):
        with self._lock:
            self._seq += 1
            return self._items.get(1)

    def _bump_locked(self):
        self._seq += 1       # exempt: _locked suffix

    @assume_locked
    def _peek(self):
        return self._items   # exempt: assume_locked marker

    def nested_ok(self):
        with self._lock:
            def inner():
                return self._seq   # lexically under the with: ok
            return inner()
'''


def test_lock_discipline_fires_on_unlocked_access():
    findings = lock_discipline.analyze([sf("kube_batch_tpu_torch/x/hub.py", A1_FIXTURE)])
    assert codes(findings) == ["KBT-L001"]
    f = findings[0]
    assert f.symbol == "Hub.bad._seq"
    assert "_lock" in f.message


WORKQUEUE_FIXTURE = (
    "import threading\n"
    "class RateLimitingQueue:\n"
    "    def __init__(self):\n"
    "        self._cond = threading.Condition()\n"
    "        self._heap = []\n"
    "    def peek(self):\n"
    "        return self._heap[0]\n"
)


def test_lock_discipline_seed_map_applies_to_real_paths():
    findings = lock_discipline.analyze([sf("kube_batch_tpu_torch/utils/workqueue.py", WORKQUEUE_FIXTURE)])
    assert codes(findings) == ["KBT-L001"]
    assert findings[0].symbol == "RateLimitingQueue.peek._heap"


UNKNOWN_LOCK_FIXTURE = (
    "class C:\n"
    "    def __init__(self):\n"
    "        self._x = 1  #: guarded_by _mutex\n"
)


def test_lock_discipline_unknown_lock_annotation():
    findings = lock_discipline.analyze([sf("kube_batch_tpu_torch/x/c.py", UNKNOWN_LOCK_FIXTURE)])
    assert codes(findings) == ["KBT-L002"]


# -- A2: torch hazards -------------------------------------------------------

A2_FIXTURE = '''
import numpy as np
import torch

def solve(x: torch.Tensor, n):  #: card_entry
    for _ in range(n):
        v = x.item()                   # VIOLATION J001 host sync in a loop
        y = x.cpu()                    # VIOLATION J001
        if torch.any(x > 0):           # VIOLATION J002 truth test of a tensor
            x = x + 1
    print("solved", v, y)              # VIOLATION J003 bare print
    total = int(x.sum())               # once, after the loop: a fetch
    helper_plain(x)
    return helper(x, n), total

def helper(x: torch.Tensor, n):
    while n > 0:
        n -= float(x.max())            # VIOLATION J001 via the call closure

def helper_plain(x: torch.Tensor):
    for _ in range(3):
        x.item()                       # a plain version: out of scope

def host_pack(a):
    for r in a:
        np.asarray(r).item()           # not reached from the entry: silent
'''


def test_torch_hazards_fire_in_card_scope_only():
    findings = torch_hazards.analyze([sf("kube_batch_tpu_torch/ops/fix.py", A2_FIXTURE)])
    got = sorted(codes(findings))
    assert got == ["KBT-J001", "KBT-J001", "KBT-J001", "KBT-J002", "KBT-J003"]
    # the host-side function and the plain version stayed silent
    assert not any("host_pack" in f.symbol or "_plain" in f.symbol for f in findings)
    # the call closure reached helper()
    assert any(f.symbol.startswith("helper.") for f in findings)


def test_torch_hazards_scope_is_ops_and_parallel():
    findings = torch_hazards.analyze([sf("kube_batch_tpu_torch/cache/fix.py", A2_FIXTURE)])
    assert findings == []


J004_FIXTURE = '''
import numpy as np
from kube_batch_tpu_torch.api.numerics import comparison_dtype

def share_bad(a, b):
    return float(np.float64(a) / np.float64(b))   # VIOLATION x2

def share_ok(a, b):
    dt = comparison_dtype()
    if dt is np.float64:                          # identity consult: ok
        return a / b
    return float(dt(a) / dt(b))
'''


def test_dtype_policy_fires_in_plugins_not_kernels():
    findings = torch_hazards.analyze([sf("kube_batch_tpu_torch/plugins/fix.py", J004_FIXTURE)])
    # two literals on one line share (path, line, code, symbol): one finding
    assert codes(findings) == ["KBT-J004"]
    assert all(f.symbol.startswith("share_bad") for f in findings)
    # kernels pin f32 by contract; out of J004 scope
    assert torch_hazards.analyze([sf("kube_batch_tpu_torch/ops/fix2.py", J004_FIXTURE)]) == []


# -- A3: registry consistency ------------------------------------------------

FAULTS_FIXTURE = (
    "POINTS = (\n"
    '    "solve.fused",\n'
    '    "bind.write",\n'
    '    "evict.write",\n'
    '    "lease.renew",\n'
    ")\n"
)

FIRER_FIXTURE = '''
from kube_batch_tpu_torch import faults, metrics

def go(op):
    if faults.should_fire("solve.fused"):
        raise RuntimeError
    if faults.should_fire(f"{op}.write"):      # wildcard: bind./evict.write
        raise RuntimeError
    if faults.should_fire("solve.typo"):       # VIOLATION R001
        raise RuntimeError
    metrics.register_fault_injection("x")
    metrics.register_nonexistent("x")          # VIOLATION R003
'''

METRICS_FIXTURE = (
    "def register_fault_injection(point):\n"
    "    pass\n"
)


def _a3_files(root: str = PORT):
    return [
        (f"{root}/faults/__init__.py", FAULTS_FIXTURE),
        (f"{root}/metrics/__init__.py", METRICS_FIXTURE),
        (f"{root}/worker.py", FIRER_FIXTURE.replace("kube_batch_tpu_torch", root)),
    ]


def test_registry_fault_points_both_directions(tmp_path):
    findings = registry_consistency.analyze(
        [sf(p, s) for p, s in _a3_files()], repo=str(tmp_path), runbook="RUNBOOK.md"
    )
    by_code = {}
    for f in findings:
        by_code.setdefault(f.code, []).append(f)
    # the typo fires R001; lease.renew is registered but never fired (R002)
    assert [f.symbol for f in by_code["KBT-R001"]] == ["point:solve.typo"]
    assert [f.symbol for f in by_code["KBT-R002"]] == ["point:lease.renew"]
    # the f-string wildcard credited bind.write AND evict.write
    fired_r002 = {f.symbol for f in by_code["KBT-R002"]}
    assert "point:bind.write" not in fired_r002
    assert "point:evict.write" not in fired_r002
    assert [f.symbol for f in by_code["KBT-R003"]] == ["metric:register_nonexistent"]


ENV_READER_FIXTURE = (
    "import os\n"
    'A = os.environ.get("KBT_ALPHA", "")\n'
    'B = os.environ["KBT_BETA"]\n'
    'ENV = "KBT_GAMMA"\n'
)

RUNBOOK_FIXTURE = (
    "# runbook\n\n"
    "| variable | default | meaning |\n"
    "|---|---|---|\n"
    "| `KBT_ALPHA` | off | alpha |\n"
    "| `KBT_GAMMA` | off | gamma |\n"
    "| `KBT_DEAD` | off | nobody reads me |\n"
    "\nKBT_PALLAS is taken as an argument here (prose, not a table row).\n"
)


def test_registry_env_table_both_directions(tmp_path):
    (tmp_path / PORT).mkdir()
    (tmp_path / PORT / "RUNBOOK.md").write_text(RUNBOOK_FIXTURE)
    files = [sf("kube_batch_tpu_torch/knobs.py", ENV_READER_FIXTURE)]
    findings = registry_consistency.analyze(files, repo=str(tmp_path))
    syms = {f.code: f.symbol for f in findings}
    assert syms.get("KBT-R004") == "env:KBT_BETA"  # read, undocumented
    assert syms.get("KBT-R005") == "env:KBT_DEAD"  # documented, dead
    assert len(findings) == 2  # ALPHA direct + GAMMA via ALL-CAPS const are fine; prose is no row


FAULT_KEYWORD_FIXTURE = '''
from kube_batch_tpu_torch import faults, native

def replay(rows):
    native.call("bulk_assign", rows, fault="native.dispatch")   # keyword form
    if faults.should_fire("lease.renew"):                       # positional form
        raise RuntimeError
    native.call("prepass", rows, fault="native.typo")           # VIOLATION R001
'''

FAULT_KEYWORD_POINTS = 'POINTS = ("native.dispatch", "lease.renew", "native.prepass")\n'


def test_registry_fault_keyword_form_counts_as_fired(tmp_path):
    files = [sf(f"{PORT}/faults/__init__.py", FAULT_KEYWORD_POINTS), sf(f"{PORT}/x.py", FAULT_KEYWORD_FIXTURE)]
    findings = registry_consistency.analyze(files, repo=str(tmp_path))
    assert sorted((f.code, f.symbol) for f in findings) == [
        ("KBT-R001", "point:native.typo"),
        ("KBT-R002", "point:native.prepass"),
    ]
    call = ast.parse('native.call(rows, fault="native.dispatch")').body[0].value
    assert registry_consistency._point_arg(call) == ("native.dispatch", False)


def test_registry_fault_positional_form_counts_as_fired(tmp_path):
    call = ast.parse('faults.should_fire("lease.renew")').body[0].value
    assert registry_consistency._point_arg(call) == ("lease.renew", False)
    call = ast.parse('faults.should_fire(f"{op}.write")').body[0].value
    assert registry_consistency._point_arg(call) == ("*.write", True)
    src = 'from kube_batch_tpu_torch import faults\nif faults.should_fire("lease.renew"):\n    raise RuntimeError\n'
    files = [sf(f"{PORT}/faults/__init__.py", 'POINTS = ("lease.renew",)\n'), sf(f"{PORT}/x.py", src)]
    assert registry_consistency.analyze(files, repo=str(tmp_path)) == []


# -- A4: snapshot escape -----------------------------------------------------

A4_FIXTURE = '''
class BadAction:
    def execute(self, ssn):
        for job in ssn.jobs.values():
            for task in job.tasks.values():
                task.node_name = "n0"          # VIOLATION S001
        node = ssn.nodes.get("n0")
        node.add_task(task)                    # VIOLATION S002

class GoodAction:
    def execute(self, ssn):
        stmt = ssn.statement()
        for job in ssn.jobs.values():
            for task in job.tasks.values():
                ssn.allocate(task, "n0")       # sanctioned API
        stmt.commit()
'''


def test_snapshot_escape_fires_on_direct_mutation():
    findings = snapshot_escape.analyze([sf("kube_batch_tpu_torch/actions/fix.py", A4_FIXTURE)])
    assert sorted(codes(findings)) == ["KBT-S001", "KBT-S002"]
    assert {f.symbol for f in findings} == {
        "BadAction.execute.node_name",
        "BadAction.execute.add_task",
    }


def test_snapshot_escape_scope_is_plugins_and_actions():
    findings = snapshot_escape.analyze([sf("kube_batch_tpu_torch/framework/fix.py", A4_FIXTURE)])
    assert findings == []


# -- baseline ----------------------------------------------------------------


def test_baseline_requires_reasons_and_flags_stale(tmp_path):
    bl_file = tmp_path / "lint-baseline.toml"
    bl_file.write_text(
        "[[suppress]]\n"
        'code = "KBT-L001"\n'
        'path = "kube_batch_tpu_torch/x/hub.py"\n'
        'symbol = "Hub.bad._seq"\n'
        'reason = "seeded fixture, intentionally kept"\n'
        "\n"
        "[[suppress]]\n"
        'code = "KBT-J003"\n'
        'path = "kube_batch_tpu_torch/x/hub.py"\n'
        'reason = ""\n'          # reason-less -> KBT-B001
    )
    bl = load_baseline(str(bl_file), str(tmp_path))
    assert [e.code for e in bl.errors] == ["KBT-B001"]

    findings = lock_discipline.analyze([sf("kube_batch_tpu_torch/x/hub.py", A1_FIXTURE)])
    kept, suppressed, stale = apply_baseline(findings, bl)
    assert kept == []
    assert len(suppressed) == 1
    # the J003 entry matched nothing -> stale (KBT-B002)
    assert [s.code for s in stale] == ["KBT-B002"]


def test_baseline_unparseable_line_is_loud(tmp_path):
    bl_file = tmp_path / "bl.toml"
    bl_file.write_text("[[suppress]]\ncode = unquoted\n")
    bl = load_baseline(str(bl_file), str(tmp_path))
    assert any("unparseable" in e.message for e in bl.errors)


# -- the repo's stdlib lint (hack/verify.py) over the port's analyzers ------
#
# The JAX file tests the lint itself; here the same fixtures must still
# fire, and the port's analysis package and utils/race.py must carry none
# of the problems the lint exists to catch.


def _verify_mod():
    spec = importlib.util.spec_from_file_location(
        "kbt_hack_verify", os.path.join(REPO, "hack", "verify.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_analysis_sources():
    root = os.path.join(REPO, PORT, "analysis")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, PORT, "utils", "race.py")


def _port_lint_problems(verify) -> list[str]:
    out = []
    for path in _port_analysis_sources():
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        lint = verify._Lint(path, ast.parse(source), source)
        out += [f"{os.path.relpath(path, REPO)}:{line}: {m}" for line, m in lint.problems]
    return out


@pytest.mark.parametrize(
    "source,expect",
    [
        ("import os\n", "F401"),
        ("try:\n    pass\nexcept:\n    pass\n", "E722"),
        ("x = 1\nif x == None:\n    pass\n", "E711"),
        ("x = 1\nif None == x:\n    pass\n", "E711"),  # the left-side gap
        ("x = 1\nif None != x:\n    pass\n", "E711"),
        ("def f(a=[]):\n    return a\n", "B006"),
        ("s = f'no placeholder'\n", "F541"),
    ],
)
def test_stdlib_lint_checks_fire(source, expect, tmp_path):
    verify = _verify_mod()
    lint = verify._Lint("x.py", ast.parse(source), source)
    msgs = [m for _, m in lint.problems]
    assert any(m.startswith(expect) for m in msgs), (source, msgs)
    bad = [p for p in _port_lint_problems(verify) if f": {expect}" in p]
    assert bad == [], bad


def test_stdlib_lint_none_equality_not_double_counted():
    verify = _verify_mod()
    source = "x = 1\nif None == x == None:\n    pass\n"
    lint = verify._Lint("x.py", ast.parse(source), source)
    # two comparison ops, two problems — not four
    assert len([m for _, m in lint.problems if m.startswith("E711")]) == 2


def test_stdlib_lint_is_none_clean():
    verify = _verify_mod()
    source = "x = 1\nif x is None:\n    pass\n"
    lint = verify._Lint("x.py", ast.parse(source), source)
    assert lint.problems == []
    assert _port_lint_problems(verify) == []


# -- live tree smoke ---------------------------------------------------------


@pytest.fixture(scope="module")
def live_findings():
    return run_suite(REPO)


def test_live_tree_is_clean_under_committed_baseline(live_findings):
    bl = load_baseline(COMMITTED_BASELINE, REPO)
    assert bl.errors == [], [e.message for e in bl.errors]
    kept, suppressed, stale = apply_baseline(live_findings, bl)
    assert kept == [], "unsuppressed findings:\n" + "\n".join(f.render() for f in kept)
    assert stale == [], "stale baseline entries:\n" + "\n".join(f.render() for f in stale)
    # the baseline is doing real work, not vacuously empty
    assert suppressed, "expected the committed baseline to cover known findings"


def test_live_tree_fault_and_env_registries_fully_covered():
    files = load_tree(REPO)
    findings = registry_consistency.analyze(files, repo=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


# -- D codes: lock order / blocking-under-lock -------------------------------

ABBA_FIXTURE = """
import threading

class A:
    def __init__(self):
        self._la = threading.Lock()
        self._lb = threading.Lock()

    def ab(self):
        with self._la:
            with self._lb:
                pass

    def ba(self):
        with self._lb:
            with self._la:
                pass
"""


def test_lock_order_abba_cycle_fires():
    findings = lock_order.analyze([sf("kube_batch_tpu_torch/x/abba.py", ABBA_FIXTURE)])
    assert codes(findings) == ["KBT-D001"]
    assert findings[0].symbol == "cycle:A._la<->A._lb"
    assert "re-nest" in findings[0].message


CONSISTENT_FIXTURE = ABBA_FIXTURE.replace(
    "self._lb:\n            with self._la", "self._la:\n            with self._lb"
)


def test_lock_order_consistent_nesting_is_clean():
    assert lock_order.analyze([sf("kube_batch_tpu_torch/x/ok.py", CONSISTENT_FIXTURE)]) == []


D002_FIXTURE = """
import os
import threading

class J:
    def __init__(self):
        self._lock = threading.Lock()
        self._fd = 3

    def bad(self):
        with self._lock:
            os.fsync(self._fd)

    def good(self):
        with self._lock:
            fd = self._fd
        os.fsync(fd)
"""


def test_lock_order_blocking_under_lock_fires_held_side_only():
    findings = lock_order.analyze([sf("kube_batch_tpu_torch/x/j.py", D002_FIXTURE)])
    assert codes(findings) == ["KBT-D002"]
    assert findings[0].symbol == "J.bad.os.fsync"


COND_WAIT_FIXTURE = (
    "import threading\n"
    "class H:\n"
    "    def __init__(self):\n"
    "        self._cond = threading.Condition()\n"
    "    def waiter(self):\n"
    "        with self._cond:\n"
    "            self._cond.wait()\n"
)


def test_lock_order_condition_wait_on_held_lock_exempt():
    assert lock_order.analyze([sf("kube_batch_tpu_torch/x/h.py", COND_WAIT_FIXTURE)]) == []


INTERPROC_FIXTURE = (
    "import threading, time\n"
    "class K:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def outer(self):\n"
    "        with self._lock:\n"
    "            self._flush()\n"
    "    def _flush(self):\n"
    "        time.sleep(0.1)\n"
)


def test_lock_order_interprocedural_charges_locked_caller():
    findings = lock_order.analyze([sf("kube_batch_tpu_torch/x/k.py", INTERPROC_FIXTURE)])
    assert codes(findings) == ["KBT-D002"]
    assert findings[0].symbol == "K.outer.time.sleep"


COLLAB_FIXTURE = (
    "import os, threading\n"
    "class Journal:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def write(self):\n"
    "        os.fsync(1)\n"
    "class Cache:\n"
    "    def __init__(self):\n"
    "        self._mutex = threading.Lock()\n"
    "        self._j = Journal()\n"
    "    def bind(self):\n"
    "        with self._mutex:\n"
    "            self._j.write()\n"
)


def test_lock_order_crosses_collaborator_classes():
    findings = lock_order.analyze([sf("kube_batch_tpu_torch/x/c2.py", COLLAB_FIXTURE)])
    assert codes(findings) == ["KBT-D002"]
    assert findings[0].symbol == "Cache.bind.os.fsync"
    assert "Journal.write" in findings[0].message


def test_lock_order_card_sync_under_lock_fires():
    # the port's blocking table names the card's sync in place of jax's
    src = (
        "import threading, torch\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def solve(self):\n"
        "        with self._lock:\n"
        "            torch.cuda.synchronize()\n"
    )
    findings = lock_order.analyze([sf("kube_batch_tpu_torch/x/s.py", src)])
    assert codes(findings) == ["KBT-D002"]
    assert "card sync" in findings[0].message


# -- runtime lock-order witness (dynamic half of KBT-D001) -------------------


def test_lock_order_witness_flags_abba_reversal():
    import threading

    from kube_batch_tpu_torch.utils.locking import LockOrderWitness

    w = LockOrderWitness()
    la = w.wrap("A", threading.Lock())
    lb = w.wrap("B", threading.Lock())

    def a_then_b():
        with la:
            with lb:
                pass

    def b_then_a():
        with lb:
            with la:
                pass

    for fn, name in ((a_then_b, "t-ab"), (b_then_a, "t-ba")):
        t = threading.Thread(target=fn, name=name)
        t.start()
        t.join()
    assert len(w.violations) == 1
    assert "t-ab" in w.violations[0] and "t-ba" in w.violations[0]
    with pytest.raises(AssertionError, match="reversal"):
        w.assert_clean()


def test_lock_order_witness_consistent_order_and_nonlifo_release_clean():
    import threading

    from kube_batch_tpu_torch.utils.locking import LockOrderWitness

    w = LockOrderWitness()
    la = w.wrap("A", threading.Lock())
    lb = w.wrap("B", threading.Lock())
    for _ in range(3):
        with la:
            with lb:
                pass
    la.acquire()
    lb.acquire()
    la.release()
    lb.release()
    with la:
        with lb:
            pass
    assert w.violations == []
    w.assert_clean()


def test_lock_order_witness_reentrant_rlock_is_not_a_self_edge():
    import threading

    from kube_batch_tpu_torch.utils.locking import LockOrderWitness

    w = LockOrderWitness()
    mu = w.wrap("M", threading.RLock())
    with mu:
        with mu:
            pass
    assert w.violations == []


@pytest.mark.chaos
def test_lock_order_witness_clean_on_live_bind_path(tmp_path):
    """The port's real cache/journal/store locks, wrapped, under a
    concurrent bind workload through the write pool: the dynamic
    acquisition graph stays reversal-free."""
    import threading
    import time

    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.recovery import WriteIntentJournal
    from kube_batch_tpu_torch.testing import (
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )
    from kube_batch_tpu_torch.utils.locking import LockOrderWitness

    store = ClusterStore()
    store.create_queue(build_queue("default"))
    for i in range(4):
        store.create_node(build_node(f"n{i}", build_resource_list(cpu=16, memory="16Gi", pods=32)))
    for g in range(2):
        store.create_pod_group(build_pod_group(f"g{g}", min_member=8))
        for m in range(8):
            store.create_pod(
                build_pod(name=f"g{g}-p{m}", group_name=f"g{g}", req=build_resource_list(cpu=1, memory="256Mi"))
            )
    journal = WriteIntentJournal(str(tmp_path / "j.wal"))
    cache = SchedulerCache(store, journal=journal)

    w = LockOrderWitness()
    cache._mutex = w.wrap("SchedulerCache._mutex", cache._mutex)
    journal._lock = w.wrap("WriteIntentJournal._lock", journal._lock)
    store._lock = w.wrap("ClusterStore._lock", store._lock)
    store._dispatch_lock = w.wrap("ClusterStore._dispatch_lock", store._dispatch_lock)

    cache.run()
    try:
        jobs = sorted(cache.jobs.values(), key=lambda j: j.name)
        assert len(jobs) == 2

        def bind_job(job, salt):
            for i, task in enumerate(sorted(job.tasks.values(), key=lambda t: t.uid)):
                cache.bind(task, f"n{(i + salt) % 4}")

        def read_side():
            for _ in range(20):
                store.list("pods")
                journal.outstanding()
                with cache._mutex:
                    len(cache.nodes)
                time.sleep(0.001)

        workers = [
            threading.Thread(target=bind_job, args=(jobs[0], 0), name="bind-0"),
            threading.Thread(target=bind_job, args=(jobs[1], 1), name="bind-1"),
            threading.Thread(target=read_side, name="reader"),
        ]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(p.node_name for p in store.list("pods")):
                break
            time.sleep(0.02)
        assert all(p.node_name for p in store.list("pods"))
    finally:
        cache.stop()
        journal.close()
    assert w._edges, "expected the bind workload to nest lock acquisitions"
    w.assert_clean()


# -- CLI ---------------------------------------------------------------------


def test_cli_json_and_exit_codes():
    res = subprocess.run(CLI + ["--json", "--strict"], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(res.stdout.strip().splitlines()[-1])
    assert payload["ok"] is True
    assert payload["findings"] == []
    assert payload["suppressed"] > 0


def test_cli_explain():
    res = subprocess.run(CLI + ["--explain", "KBT-L001"], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0
    assert "guarded" in res.stdout
    res = subprocess.run(CLI + ["--explain", "KBT-J001"], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0
    assert "card" in res.stdout and "jit" not in res.stdout


def test_cli_reasonless_baseline_entry_fails_the_gate(tmp_path):
    bad = tmp_path / "bl.toml"
    bad.write_text(
        "[[suppress]]\n"
        'code = "KBT-L001"\n'
        'path = "kube_batch_tpu_torch/server.py"\n'
        'reason = ""\n'
    )
    res = subprocess.run(CLI + ["--strict", "--baseline", str(bad)], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 1
    assert "KBT-B001" in res.stdout


def test_cli_no_baseline_reports_known_intentional_findings():
    res = subprocess.run(CLI + ["--no-baseline"], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 1
    assert "KBT-" in res.stdout


# -- --prune (on copies under tmp_path) -------------------------------------


def _run_prune(bl_path, *extra):
    return subprocess.run(CLI + ["--prune", "--baseline", str(bl_path), *extra], cwd=REPO,
                          capture_output=True, text=True)


def test_cli_prune_drops_stale_entries_preserving_the_rest(tmp_path):
    committed = open(COMMITTED_BASELINE, encoding="utf-8").read()
    bl = tmp_path / "bl.toml"
    bl.write_text(
        committed.rstrip("\n")
        + "\n\n[[suppress]]\n"
        + 'code = "KBT-L001"\n'
        + 'path = "kube_batch_tpu_torch/does/not/exist.py"\n'
        + 'reason = "stale on purpose: the file is gone"\n'
    )
    res = _run_prune(bl)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "pruned: KBT-L001 at kube_batch_tpu_torch/does/not/exist.py" in res.stdout
    assert "1 stale entry dropped" in res.stdout
    assert bl.read_text() == committed


def test_cli_prune_noop_leaves_baseline_byte_identical(tmp_path):
    committed = open(COMMITTED_BASELINE, encoding="utf-8").read()
    bl = tmp_path / "bl.toml"
    bl.write_text(committed)
    res = _run_prune(bl)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 stale entries dropped" in res.stdout
    assert bl.read_text() == committed


def test_cli_prune_requires_a_baseline():
    res = subprocess.run(CLI + ["--prune", "--no-baseline"], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 2


# -- A6: protocol lifecycles ---------------------------------------------------

C001_LEAKY = '''
from kube_batch_tpu_torch.framework.session import close_session, open_session

def leaky(cache, tiers, args):
    ssn = open_session(cache, tiers, args)
    if not ssn.jobs:
        return None          # VIOLATION: ssn open on this exit path
    close_session(ssn)
    return True
'''

C001_CLEAN = '''
from kube_batch_tpu_torch.framework.session import close_session, open_session

def clean(cache, tiers, args):
    ssn = open_session(cache, tiers, args)
    try:
        return len(ssn.jobs)
    finally:
        close_session(ssn)
'''

C001_STMT_LEAKY = '''
def bail_without_discard(ssn, tasks):
    stmt = ssn.statement()
    for t in tasks:
        if not t.ok:
            return False     # VIOLATION: neither commit nor discard
    stmt.commit()
    return True
'''

C001_STMT_CLEAN = '''
def settled_everywhere(ssn, tasks, helper):
    stmt = ssn.statement()
    for t in tasks:
        helper(ssn, stmt, t)  # borrow: passing by argument is not escape
        if not t.ok:
            stmt.discard()
            return False
    stmt.commit()
    return True
'''


def test_protocol_c001_session_leak_fires_and_clean_twin_does_not():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/x/leak.py", C001_LEAKY)])
    assert codes(findings) == ["KBT-C001"]
    assert "ssn" in findings[0].message
    assert protocol.analyze([sf("kube_batch_tpu_torch/x/ok.py", C001_CLEAN)]) == []


def test_protocol_c001_statement_leak_fires_and_borrow_is_not_escape():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/x/stmt.py", C001_STMT_LEAKY)])
    assert codes(findings) == ["KBT-C001"]
    assert protocol.analyze([sf("kube_batch_tpu_torch/x/ok.py", C001_STMT_CLEAN)]) == []


C002_DISPATCH = '''
def rogue(cache, task):
    cache.bind(task, "n1")
'''


def test_protocol_c002_dispatch_scope_is_the_statement_layer():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/plugins/rogue.py", C002_DISPATCH)])
    assert codes(findings) == ["KBT-C002"]
    assert protocol.analyze([sf("kube_batch_tpu_torch/framework/statement.py", C002_DISPATCH)]) == []


C002_BREAKER = '''
class Probe:
    def poke(self, breaker):
        breaker._transition("OPEN")
'''

C002_BREAKER_BAD_STATE = '''
class CircuitBreaker:
    def _step(self):
        self._transition("melted")
'''

C002_BREAKER_OK = C002_BREAKER.replace("class Probe", "class CircuitBreaker").replace('"OPEN"', '"open"')


def test_protocol_c002_breaker_transitions_stay_in_the_ladder():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/plugins/probe.py", C002_BREAKER)])
    assert codes(findings) == ["KBT-C002"]
    assert protocol.analyze([sf("kube_batch_tpu_torch/faults/ladder.py", C002_BREAKER_OK)]) == []
    findings = protocol.analyze([sf("kube_batch_tpu_torch/faults/ladder.py", C002_BREAKER_BAD_STATE)])
    assert codes(findings) == ["KBT-C002"]


C003_ORPHAN = '''
def orphan(journal, intents):
    journal.append_intents(intents)
    return None
'''

C003_PAIRED = '''
def paired(journal, cache, intents):
    seqs = journal.append_intents(intents)
    cache._submit_write(seqs)
    for s in seqs:
        journal.confirm(s)
'''

C003_CONFIRM_ONLY = '''
def confirm_strangers(journal, seqs):
    for s in seqs:
        journal.confirm(s)
'''


def test_protocol_c003_append_without_dispatch_or_confirm():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/x/j.py", C003_ORPHAN)])
    assert set(codes(findings)) == {"KBT-C003"}
    assert protocol.analyze([sf("kube_batch_tpu_torch/x/ok.py", C003_PAIRED)]) == []


def test_protocol_c003_confirm_without_append_exempts_recovery():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/x/c.py", C003_CONFIRM_ONLY)])
    assert codes(findings) == ["KBT-C003"]
    assert protocol.analyze([sf("kube_batch_tpu_torch/recovery/takeover_x.py", C003_CONFIRM_ONLY)]) == []


C004_STALE_READ = '''
def stale(state, patches):
    state.invalidate("bound churn")
    state.apply_node_patches(patches)
'''

C004_REHARVESTED = '''
def reharvested(state, ssn, patches):
    state.invalidate("bound churn")
    state.adopt_full_cycle(ssn)
    state.apply_node_patches(patches)
'''


def test_protocol_c004_read_after_invalidate_needs_reharvest():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/x/s.py", C004_STALE_READ)])
    assert codes(findings) == ["KBT-C004"]
    assert protocol.analyze([sf("kube_batch_tpu_torch/x/ok.py", C004_REHARVESTED)]) == []


C005_GAP = '''
def leaky_loop(trigger, stop, prepare, run):
    trigger.attach()
    prepare()
    try:
        run(stop)
    finally:
        trigger.detach()
'''

C005_TIGHT = '''
def tight_loop(trigger, stop, prepare, run):
    prepare()
    trigger.attach()
    try:
        run(stop)
    finally:
        trigger.detach()
'''

C005_CLASS_TEARDOWN = '''
class Consumer:
    def start(self):
        self.trigger.attach()

    def stop(self):
        self.trigger.detach()
'''


def test_protocol_c005_registration_gap_before_try_fires():
    findings = protocol.analyze([sf("kube_batch_tpu_torch/x/loop.py", C005_GAP)])
    assert codes(findings) == ["KBT-C005"]
    assert protocol.analyze([sf("kube_batch_tpu_torch/x/ok.py", C005_TIGHT)]) == []


def test_protocol_c005_class_teardown_pairing_is_clean():
    assert protocol.analyze([sf("kube_batch_tpu_torch/x/consumer.py", C005_CLASS_TEARDOWN)]) == []


# -- the port-only guarded state ----------------------------------------------


def test_class_table_fields_are_guarded():
    path = f"{PORT}/ops/class_solve.py"
    src = open(os.path.join(REPO, path), encoding="utf-8").read()
    seeded = src.replace(
        "    def add_splits(self, n: int) -> None:",
        "    def peek_splits(self) -> int:\n        return self.splits_total\n\n"
        "    def add_splits(self, n: int) -> None:",
    )
    assert seeded != src
    findings = lock_discipline.analyze([sf(path, seeded)])
    assert [(f.code, f.symbol) for f in findings] == [("KBT-L001", "ClassTable.peek_splits.splits_total")]
    assert lock_discipline.analyze([sf(path, src)]) == []


NVCC_SEEDED = '''
import threading

_LOCK = threading.RLock()
builds = 0  #: guarded_by _LOCK

def build_locked():
    global builds
    builds += 1              # exempt: _locked suffix

def build():
    with _LOCK:
        return build_locked()

def rebuild():
    global builds
    builds += 1              # VIOLATION: the module lock is not held

def report(builds=0):
    return builds            # a local of the same name: not module state
'''


def test_module_state_guard_fires_outside_the_module_lock():
    findings = lock_discipline.analyze([sf(f"{PORT}/ops/fix_nvcc.py", NVCC_SEEDED)])
    assert [(f.code, f.symbol) for f in findings] == [("KBT-L001", "rebuild.builds")]
    # the seed map covers the real kernel build, with no annotation needed
    src = NVCC_SEEDED.replace("  #: guarded_by _LOCK", "")
    findings = lock_discipline.analyze([sf(f"{PORT}/ops/nvcc.py", src)])
    assert [(f.code, f.symbol) for f in findings] == [("KBT-L001", "rebuild.builds")]
    bad_lock = NVCC_SEEDED.replace("guarded_by _LOCK", "guarded_by _MISSING")
    assert "KBT-L002" in codes(lock_discipline.analyze([sf(f"{PORT}/ops/fix_nvcc.py", bad_lock)]))


def test_seeded_guarded_access_in_a_copy_of_the_cache_fires(tmp_path):
    src_path = os.path.join(REPO, PORT, "cache", "cache.py")
    dst = tmp_path / PORT / "cache"
    dst.mkdir(parents=True)
    src = open(src_path, encoding="utf-8").read()
    anchor = "class SchedulerCache"
    head, tail = src.split(anchor, 1)
    body_start = tail.index("\n    def ")
    seeded = head + anchor + tail[:body_start] + (
        "\n    def peek_jobs(self):\n        return len(self.jobs)\n"
    ) + tail[body_start:]
    (dst / "cache.py").write_text(seeded)
    findings = lock_discipline.analyze(load_tree(str(tmp_path)))
    assert [(f.code, f.path, f.symbol) for f in findings] == [
        ("KBT-L001", f"{PORT}/cache/cache.py", "SchedulerCache.peek_jobs.jobs")
    ]


# -- the seed maps name real files: no vacuous pass ---------------------------


def _classes(path: str) -> dict[str, ast.ClassDef]:
    tree = ast.parse(open(os.path.join(REPO, path), encoding="utf-8").read())
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}


def _module_names(path: str) -> set[str]:
    tree = ast.parse(open(os.path.join(REPO, path), encoding="utf-8").read())
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return out


def _methods(cls: ast.ClassDef) -> set[str]:
    return {n.name for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _exists(path: str) -> bool:
    return path.startswith(PORT + "/") and os.path.isfile(os.path.join(REPO, path))


def test_every_seed_map_key_names_an_existing_port_file_and_class():
    problems = []
    for path, classes in lock_discipline.SEED_GUARDED.items():
        if not _exists(path):
            problems.append(f"SEED_GUARDED: {path}")
            continue
        have = _classes(path)
        problems += [f"SEED_GUARDED: {path}::{c}" for c in classes if c not in have]
    for path, names in lock_discipline.SEED_MODULE_GUARDED.items():
        have = _module_names(path) if _exists(path) else set()
        problems += [f"SEED_MODULE_GUARDED: {path}::{n}" for n in [*names, *set(names.values())] if n not in have]
    all_classes = set()
    for dirpath, _, files in os.walk(os.path.join(REPO, PORT)):
        for f in files:
            if f.endswith(".py"):
                all_classes |= set(_classes(os.path.relpath(os.path.join(dirpath, f), REPO)))
    for (path, cls, _attr), collab in lock_order.SEED_COLLABORATORS.items():
        if not _exists(path) or cls not in _classes(path) or collab not in all_classes:
            problems.append(f"SEED_COLLABORATORS: {path}::{cls} -> {collab}")
    for (path, cls), roots in threads.SEED_ROOTS.items():
        if not _exists(path) or cls not in _classes(path):
            problems.append(f"SEED_ROOTS: {path}::{cls}")
            continue
        methods = _methods(_classes(path)[cls])
        problems += [f"SEED_ROOTS: {cls}.{m}" for entries, _ in roots.values() for m in entries if m not in methods]
    for name, m in protocol.MACHINES.items():
        if "owner" in m and not _exists(m["owner"]):
            problems.append(f"MACHINES[{name}]: {m['owner']}")
    problems += [f"_DISPATCH_OWNERS: {p}" for p in protocol._DISPATCH_OWNERS if not _exists(p)]
    if not os.path.isdir(os.path.join(REPO, protocol._CONFIRM_EXEMPT_PREFIX)):
        problems.append(f"_CONFIRM_EXEMPT_PREFIX: {protocol._CONFIRM_EXEMPT_PREFIX}")
    problems += [f"SCOPES: {p}" for p in snapshot_escape.SCOPES
                 if not (p.startswith(PORT + "/") and os.path.isdir(os.path.join(REPO, p)))]
    for path, entries in torch_hazards.ENTRY_POINTS.items():
        if not _exists(path):
            problems.append(f"ENTRY_POINTS: {path}")
            continue
        top, have = _module_names(path), _classes(path)
        for e in entries:
            cls, _, meth = e.partition(".")
            ok = (cls in have and meth in _methods(have[cls])) if meth else e in top
            if not ok:
                problems.append(f"ENTRY_POINTS: {path}::{e}")
    for const in ("FAULTS_MODULE", "METRICS_MODULE", "OBS_MODULE", "SERVER_MODULE", "SESSION_MODULE", "RUNBOOK"):
        if not _exists(getattr(registry_consistency, const)):
            problems.append(f"registry_consistency.{const}")
    assert problems == []


# -- the port's runbook and baseline ------------------------------------------


def test_runbook_env_table_is_exactly_what_the_port_reads():
    files = load_tree(REPO)
    reads = set(registry_consistency._env_reads(files))
    documented = set(registry_consistency._documented_env(REPO, registry_consistency.RUNBOOK))
    assert reads == documented
    # the JAX knobs the port takes as arguments are named in prose, not rows
    text = open(os.path.join(REPO, registry_consistency.RUNBOOK), encoding="utf-8").read()
    for knob in ("KBT_PALLAS", "KBT_MESH", "KBT_NATIVE", "KBT_ENCODE_CACHE", "KBT_EXCHANGE_BATCH",
                 "KBT_MIN_DEVICE_PAIRS", "KBT_VMEM_BUDGET", "KBT_JAX_CACHE"):
        assert knob in text and knob not in documented


def test_committed_baseline_mirrors_the_jax_shapes_and_names_each_sync():
    bl = load_baseline(COMMITTED_BASELINE, REPO)
    ref = load_baseline(os.path.join(REPO, "hack", "lint-baseline.toml"), REPO)
    assert bl.errors == []
    assert not [s for s in bl.suppressions if s.code in ("KBT-R002", "KBT-R005")]
    ref_keys = {(s.code, s.path.replace("kube_batch_tpu/", f"{PORT}/", 1)) for s in ref.suppressions}
    ref_keys = {(c, p.replace("xla_allocate", "torch_allocate")) for c, p in ref_keys}
    for s in bl.suppressions:
        assert s.reason.strip()
        if s.code in ("KBT-J001", "KBT-J002", "KBT-J003"):
            continue  # the card path's deliberate syncs, each with its role
        assert (s.code, s.path) in ref_keys, (s.code, s.path)
        assert s.reason.startswith("mirrors the JAX entry for kube_batch_tpu/"), s.reason[:60]
    assert len([s for s in bl.suppressions if s.code not in ("KBT-J001", "KBT-J002", "KBT-J003")]) == len(
        ref.suppressions)


# -- (a) parity on the fixtures -------------------------------------------------


def _key(findings, alias: bool = False) -> set:
    out = set()
    for f in findings:
        path = f.path.replace("kube_batch_tpu/", f"{PORT}/", 1) if alias else f.path
        out.add((f.code, path, f.line, f.symbol))
    return out


def _ref_sf(path: str, source: str) -> RefSourceFile:
    return RefSourceFile(path, source, ast.parse(source, path))


JAX_A2_FIXTURE = '''
import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

@partial(jax.jit, static_argnames=("flag",))
def solve(x, flag):
    if flag:
        x = x + 1
    v = x.item()
    print("trace", v)
    y = np.asarray(x)
    if jnp.any(x > 0):
        y = y + 1
    return helper(y)

def helper(y):
    return float(y)
'''

# (name, analyzer pair, relative path, source)
FIXTURES = [
    ("a1_hub", "lock_discipline", "x/hub.py", A1_FIXTURE),
    ("a1_workqueue", "lock_discipline", "utils/workqueue.py", WORKQUEUE_FIXTURE),
    ("a1_unknown_lock", "lock_discipline", "x/c.py", UNKNOWN_LOCK_FIXTURE),
    ("j004_plugins", "hazards", "plugins/fix.py", J004_FIXTURE.replace("kube_batch_tpu_torch", "kube_batch_tpu")),
    ("j004_kernels", "hazards", "ops/fix2.py", J004_FIXTURE),
    ("a4_actions", "snapshot_escape", "actions/fix.py", A4_FIXTURE),
    ("a4_framework", "snapshot_escape", "framework/fix.py", A4_FIXTURE),
    ("d_abba", "lock_order", "x/abba.py", ABBA_FIXTURE),
    ("d_consistent", "lock_order", "x/ok.py", CONSISTENT_FIXTURE),
    ("d_fsync", "lock_order", "x/j.py", D002_FIXTURE),
    ("d_cond_wait", "lock_order", "x/h.py", COND_WAIT_FIXTURE),
    ("d_interproc", "lock_order", "x/k.py", INTERPROC_FIXTURE),
    ("d_collab", "lock_order", "x/c2.py", COLLAB_FIXTURE),
    ("c001_leaky", "protocol", "x/leak.py", C001_LEAKY),
    ("c001_clean", "protocol", "x/ok.py", C001_CLEAN),
    ("c001_stmt_leaky", "protocol", "x/stmt.py", C001_STMT_LEAKY),
    ("c001_stmt_clean", "protocol", "x/ok.py", C001_STMT_CLEAN),
    ("c002_rogue", "protocol", "plugins/rogue.py", C002_DISPATCH),
    ("c002_owner", "protocol", "framework/statement.py", C002_DISPATCH),
    ("c002_breaker", "protocol", "plugins/probe.py", C002_BREAKER),
    ("c002_breaker_ok", "protocol", "faults/ladder.py", C002_BREAKER_OK),
    ("c002_breaker_bad", "protocol", "faults/ladder.py", C002_BREAKER_BAD_STATE),
    ("c003_orphan", "protocol", "x/j.py", C003_ORPHAN),
    ("c003_paired", "protocol", "x/ok.py", C003_PAIRED),
    ("c003_confirm", "protocol", "x/c.py", C003_CONFIRM_ONLY),
    ("c003_recovery", "protocol", "recovery/takeover_x.py", C003_CONFIRM_ONLY),
    ("c004_stale", "protocol", "x/s.py", C004_STALE_READ),
    ("c004_ok", "protocol", "x/ok.py", C004_REHARVESTED),
    ("c005_gap", "protocol", "x/loop.py", C005_GAP),
    ("c005_tight", "protocol", "x/ok.py", C005_TIGHT),
    ("c005_class", "protocol", "x/consumer.py", C005_CLASS_TEARDOWN),
]

ANALYZERS = {
    "lock_discipline": (lock_discipline_ref.analyze, lock_discipline.analyze),
    "lock_order": (lock_order_ref.analyze, lock_order.analyze),
    "protocol": (protocol_ref.analyze, protocol.analyze),
    "snapshot_escape": (snapshot_escape_ref.analyze, snapshot_escape.analyze),
    "hazards": (jax_hazards_ref.analyze, torch_hazards.analyze),
}


@pytest.mark.parametrize("name,analyzer,rel,source", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_fixture_findings_equal_the_jax_analyzers(name, analyzer, rel, source):
    ref, port = ANALYZERS[analyzer]
    ref_src = source.replace("kube_batch_tpu_torch", "kube_batch_tpu")
    want = _key(ref([_ref_sf(f"kube_batch_tpu/{rel}", ref_src)]), alias=True)
    got = _key(port([sf(f"{PORT}/{rel}", source)]))
    assert got == want


def test_registry_fixtures_equal_the_jax_analyzer(tmp_path):
    (tmp_path / "deployment").mkdir()
    (tmp_path / "deployment" / "README.md").write_text(RUNBOOK_FIXTURE)
    (tmp_path / PORT).mkdir()
    (tmp_path / PORT / "RUNBOOK.md").write_text(RUNBOOK_FIXTURE)
    env = [("knobs.py", ENV_READER_FIXTURE)]
    a3 = [(p.split("/", 1)[1], s) for p, s in _a3_files()]
    for rel_sources in (a3, env):
        want = registry_ref.analyze(
            [_ref_sf(f"kube_batch_tpu/{r}", s.replace("kube_batch_tpu_torch", "kube_batch_tpu"))
             for r, s in rel_sources], repo=str(tmp_path))
        got = registry_consistency.analyze([sf(f"{PORT}/{r}", s) for r, s in rel_sources], repo=str(tmp_path))
        runbook = {"deployment/README.md": registry_consistency.RUNBOOK}
        assert _key(got) == {(c, runbook.get(p, p), ln, s) for c, p, ln, s in _key(want, alias=True)}


def test_a2_fixture_differs_only_where_the_torch_scope_says():
    """The JAX A2 fixture is jit-scoped: the JAX analyzer finds its five
    hazards, the port's finds none (no card entry point, and a jit
    decorator is no scope here). The torch twin of the fixture, with its
    card entry declared, gives the same five codes."""
    ref = jax_hazards_ref.analyze([_ref_sf("kube_batch_tpu/ops/fix.py", JAX_A2_FIXTURE)])
    assert sorted(codes(ref)) == ["KBT-J001", "KBT-J001", "KBT-J001", "KBT-J002", "KBT-J003"]
    assert torch_hazards.analyze([sf(f"{PORT}/ops/fix.py", JAX_A2_FIXTURE)]) == []
    port = torch_hazards.analyze([sf(f"{PORT}/ops/fix.py", A2_FIXTURE)])
    assert sorted(codes(port)) == sorted(codes(ref))


# -- (b) parity on the live port tree ------------------------------------------

# The JAX runbook's knobs the port takes as arguments (R005 there), and the
# two fault points the port fires through a `fault=` keyword (R002 there).
JAX_ONLY = {
    ("KBT-R005", f"env:{k}") for k in (
        "KBT_PALLAS", "KBT_PALLAS_DEBUG", "KBT_MESH", "KBT_MESH_PALLAS", "KBT_NATIVE", "KBT_ENCODE_CACHE",
        "KBT_MIN_DEVICE_PAIRS", "KBT_VMEM_BUDGET", "KBT_JAX_CACHE", "KBT_EXCHANGE_BATCH",
    )
} | {("KBT-R002", "point:native.prepass"), ("KBT-R002", "point:native.dispatch")}
PORT_ONLY_CODES = {"KBT-J001", "KBT-J002", "KBT-J003"}  # the torch scope's findings


def test_live_port_tree_findings_equal_the_jax_analyzers_but_the_written_differences(live_findings):
    files = [
        RefSourceFile(f.path.replace(f"{PORT}/", "kube_batch_tpu/", 1), f.source, f.tree)
        for f in load_tree(REPO)
    ]
    ref = _key(run_suite_ref(REPO, files=files), alias=True)
    got = _key(live_findings)
    jax_only = {(c, s) for c, _p, _ln, s in ref - got}
    assert jax_only == JAX_ONLY
    port_only = got - ref
    assert port_only and {c for c, *_ in port_only} <= PORT_ONLY_CODES
    assert not [f for f in ref if f[0] in PORT_ONLY_CODES]
    # everything else, including the 22 shapes the JAX baseline holds,
    # is equal finding for finding
    assert len(ref & got) == 22
