"""Deterministic interleaving model checker for the streaming/store
concurrency layer (KBT-I0xx, its own CLI:
``python -m kube_batch_tpu_torch.analysis.interleave``).

The static suite proves lifecycle and lock invariants *per path*; this
module proves them *per schedule*. The production concurrency units —
store event fan-out, micro-cycle drains, full cycles, takeover
reconciliation, late in-flight dispatches — are modeled as **logical
threads**: lists of named atomic steps executed from one real thread
against the real objects (``ClusterStore``, ``SchedulerCache``
without its writer pool so every dispatch is inline, ``StreamTrigger``
/ ``StreamState`` wired exactly as the crash-consistency e2e wires
them). The explorer then drives each scenario through **every
distinguishable interleaving** of those steps and checks, per
schedule:

- the scenario's invariants (all arrivals bound, no arrival lost from
  the backlog, journal left with zero orphans, placements equal to the
  uninterrupted twin, ...);
- zero lost and zero duplicate binds, counted as store-level
  ``"" -> node`` transitions by an event handler — the same detector
  tests/test_torch_streaming.py pins the crash e2e with;
- bind-for-bind parity across schedules: every clean schedule of a
  parity scenario must produce the identical placement map;
- no lock-order reversal, via a :class:`LockOrderWitness` wrapped
  around the real locks (store/cache/trigger/journal);
- footprint honesty: each step declares the shared state it may touch,
  and the witness's ``on_acquire`` hook records what it *actually*
  locked — an undeclared acquisition is itself a finding, because the
  pruning below would then be unsound.

**DPOR-lite**: two adjacent steps from different threads with disjoint
declared footprints commute, so their two orders are the same trace.
The explorer enumerates only the canonical representative of each
commutation class (the lexicographic normal form: no adjacent pair may
have ``tid(a) > tid(b)`` with independent footprints) — classic
partial-order reduction, sized down for fixed finite scenarios.

**Determinism / replay**: scenarios use a :class:`VirtualClock`
(injected into the degradation-ladder breakers, advanced once per
step), fresh worlds per schedule, and no randomness — a schedule is
fully identified by its trace id ``<scenario>:<tid digits>``. A
counterexample's trace id is its replay seed:
``python -m kube_batch_tpu_torch.analysis.interleave --replay broken_drain:011``
re-runs exactly that schedule step by step, verbosely.

The seven default scenarios: ``micro_vs_full``, ``event_vs_invalidate``,
``takeover_vs_dispatch``, ``watch410_vs_drain``,
``two_scheduler_conflict`` (two federated schedulers racing
optimistic gang dispatches onto one node),
``dispatch_vs_next_solve`` (cycle N's deferred dispatch
racing cycle N+1's snapshot through the KBT_PIPELINE dispatch
fence), and ``adopt_vs_dispatch`` (slot adoption racing a
straggler conditional dispatch from the killed owner). The
intentionally broken fixture
``broken_drain`` (a trigger whose ``drain()`` empties the backlog
instead of copy-until-prune) is excluded from the default set; it
exists so the seeded-counterexample loop stays demonstrably alive —
``tests/test_torch_interleave.py`` replays its counterexample by trace id.

Baseline: ``kube_batch_tpu_torch/analysis/interleave-baseline.toml``
(same grammar/loader as
the lint baseline; absent file = empty baseline). Zero live entries:
every default scenario explores clean.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kube_batch_tpu_torch.analysis import (
    Finding,
    apply_baseline,
    load_baseline,
    repo_root,
)

__all__ = [
    "VirtualClock",
    "Step",
    "Scenario",
    "ScheduleResult",
    "ScenarioReport",
    "SCENARIOS",
    "FIXTURES",
    "explore",
    "main",
]

_SELF_PATH = "kube_batch_tpu_torch/analysis/interleave.py"
BASELINE = os.path.join("kube_batch_tpu_torch", "analysis", "interleave-baseline.toml")


class VirtualClock:
    """Deterministic monotonic clock: schedule position, not wall time.
    Injected into the degradation ladder's breakers for the duration of
    a drive so any backoff/half-open decision depends on the schedule
    alone, and advanced one tick per executed step."""

    def __init__(self, start: float = 0.0) -> None:
        self._t = start

    def now(self) -> float:
        return self._t

    def advance(self, dt: float = 1.0) -> float:
        self._t += dt
        return self._t


@dataclass(frozen=True)
class Step:
    """One atomic unit of a logical thread. ``footprint`` declares the
    shared state the step may touch — lock names as wrapped by the
    scenario witness, plus virtual tokens (``stream_state``) for shared
    objects that have no lock. Disjoint footprints ⇒ the steps commute
    (checked at runtime against the locks actually acquired)."""

    name: str
    fn: Callable[[], None]
    footprint: frozenset


@dataclass
class ScheduleResult:
    trace: str  # "<scenario>:<tid digits>"
    steps: list  # [(virtual time, tid, step name)]
    violations: list  # [str]
    fingerprint: object = None  # placement map for parity comparison


@dataclass
class ScenarioReport:
    name: str
    describe: str
    schedules: int = 0
    pruned_branches: int = 0
    results: list = field(default_factory=list)  # [ScheduleResult]

    @property
    def counterexamples(self) -> list:
        return [r for r in self.results if r.violations]

    def findings(self) -> list:
        out = []
        for r in self.counterexamples:
            for v in r.violations:
                code = "KBT-I002" if "footprint" in v or "model error" in v else "KBT-I001"
                out.append(
                    Finding(
                        _SELF_PATH, 1, code,
                        f"[{r.trace}] {v} (replay: python -m "
                        f"kube_batch_tpu_torch.analysis.interleave --replay {r.trace})",
                        symbol=r.trace,
                    )
                )
        return out


# -- schedule enumeration (lexicographic normal forms) ------------------------


def _schedules(plan: list) -> tuple[list, int]:
    """All canonical interleavings of ``plan`` (a list of per-thread
    Step lists). A sequence is canonical iff no adjacent pair has
    ``tid(a) > tid(b)`` with disjoint footprints — exactly one
    representative per commutation class survives. Returns
    (orders, pruned branch count)."""
    counts = [len(t) for t in plan]
    total = sum(counts)
    out: list = []
    pruned = 0

    def rec(prefix: list, pos: list, last) -> None:
        nonlocal pruned
        if len(prefix) == total:
            out.append(tuple(prefix))
            return
        for tid in range(len(plan)):
            if pos[tid] >= counts[tid]:
                continue
            step = plan[tid][pos[tid]]
            if last is not None:
                ltid, lstep = last
                if ltid > tid and not (lstep.footprint & step.footprint):
                    pruned += 1  # swap-equivalent canonical form exists
                    continue
            prefix.append(tid)
            pos[tid] += 1
            rec(prefix, pos, (tid, step))
            prefix.pop()
            pos[tid] -= 1

    rec([], [0] * len(plan), None)
    return out, pruned


# -- scenario scaffolding -----------------------------------------------------

# Serial pipeline without drf/proportion, the conf the streaming parity
# suite states its bind-for-bind invariant over (tests/test_torch_streaming.py).
_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
streaming: true
"""

# Footprint tokens. Lock names match the witness wrapping in
# Scenario._wire; STATE is the virtual token for the (lockless,
# loop-thread-confined) StreamState resident table.
L_STORE = "store._lock"
L_CACHE = "cache._mutex"
L_TRIG = "trigger._lock"
L_JOURNAL = "journal._lock"
STATE = "stream_state"
F_ALL = frozenset({L_STORE, L_CACHE, L_TRIG, L_JOURNAL, STATE})
F_EVENT = frozenset({L_STORE, L_CACHE, L_TRIG})
F_STATE = frozenset({STATE})
F_TRIG = frozenset({L_TRIG})


class Scenario:
    """One fixed concurrency drama. ``build()`` constructs a fresh
    world and sets ``self.threads``; the explorer executes one schedule
    and then calls ``invariants()`` / ``fingerprint()``."""

    name = ""
    describe = ""
    parity = True  # clean schedules must agree on fingerprint()

    def __init__(self, workdir: str, device: str = "cuda") -> None:
        self.workdir = workdir
        self.device = device  # where a torch_allocate step solves
        self.clock = VirtualClock()
        self.threads: list = []
        self._orig_breaker_clocks: dict = {}
        self.journal = None
        self.standby_journal = None

    # -- world building (mirrors tests/test_torch_streaming.py's harness) ----------

    def _wire(
        self,
        nodes: int = 4,
        die_after: Optional[int] = None,
        conf_text: str = _CONF,
    ):
        from kube_batch_tpu_torch import faults
        from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
        from kube_batch_tpu_torch.cache.store import PODS, EventHandler
        from kube_batch_tpu_torch.recovery import WriteIntentJournal
        from kube_batch_tpu_torch.scheduler import Scheduler
        from kube_batch_tpu_torch.streaming import StreamState, StreamTrigger
        from kube_batch_tpu_torch.utils.locking import LockOrderWitness

        conf = os.path.join(self.workdir, "conf.yaml")
        with open(conf, "w", encoding="utf-8") as fh:
            fh.write(conf_text)
        self.store = ClusterStore()
        self._seed(self.store, nodes)
        self.bind_counts: dict = {}

        def on_update(old, new):
            if not old.node_name and new.node_name:
                key = f"{new.namespace}/{new.name}"
                self.bind_counts[key] = self.bind_counts.get(key, 0) + 1

        self.store.add_event_handler(PODS, EventHandler(on_update=on_update))
        self.journal = WriteIntentJournal(os.path.join(self.workdir, "leader.wal"))
        binder = None
        if die_after is not None:
            binder = _DyingBinder(self.store, die_after)
        self.cache = SchedulerCache(self.store, journal=self.journal, binder=binder)
        # no cache.run(): the writer pool stays off, every dispatch is
        # inline — the step IS the dispatch, which is what makes the
        # schedule the only source of nondeterminism
        self.sched = Scheduler(
            self.cache, scheduler_conf=conf, schedule_period=1000.0
        )
        self.trigger = self._make_trigger()
        self.state = StreamState()
        self.sched._stream_trigger = self.trigger
        self.sched._stream_state = self.state
        self.trigger.attach()

        self.witness = LockOrderWitness()
        self.store._lock = self.witness.wrap(L_STORE, self.store._lock)
        self.cache._mutex = self.witness.wrap(L_CACHE, self.cache._mutex)
        self.trigger._lock = self.witness.wrap(L_TRIG, self.trigger._lock)
        self.journal._lock = self.witness.wrap(L_JOURNAL, self.journal._lock)
        # Field-level witness over the lockless resident table: every
        # actual StreamState access reports as the STATE token, so a
        # step that touches it without declaring STATE in its footprint
        # is caught the same way an undeclared lock acquire is (the
        # explorer's on_access hook feeds the same observed set).
        from kube_batch_tpu_torch.utils.race import RaceWitness

        self.race = RaceWitness(clock=self.clock.now)
        self.race.watch(
            self.state,
            {"nodes": "touch", "valid": "rw", "reason": "rw"},
            token=STATE,
        )
        for b in faults.solver_ladder.breakers.values():
            self._orig_breaker_clocks[b] = b._clock
            b._clock = self.clock.now

    @staticmethod
    def _make_trigger():
        from kube_batch_tpu_torch.streaming import StreamTrigger

        return StreamTrigger()

    @staticmethod
    def _seed(store, nodes: int) -> None:
        from kube_batch_tpu_torch.testing import build_node, build_queue, build_resource_list

        store.create_queue(build_queue("default"))
        for i in range(nodes):
            store.create_node(
                build_node(
                    f"n{i}", build_resource_list(cpu=16, memory="16Gi", pods=64)
                )
            )

    @staticmethod
    def _arrive(store, name: str, members: int) -> None:
        from kube_batch_tpu_torch.testing import build_pod, build_pod_group, build_resource_list

        store.create_pod_group(build_pod_group(name, min_member=members))
        for m in range(members):
            store.create_pod(
                build_pod(
                    name=f"{name}-p{m}", group_name=name,
                    req=build_resource_list(cpu=1, memory="512Mi"),
                )
            )

    # -- step factories -------------------------------------------------------

    def s_full(self, label: str = "full_cycle") -> Step:
        return Step(label, self.sched.run_once, F_ALL)

    def s_micro(self, label: str = "micro_drain") -> Step:
        def fn():
            self.sched.run_micro(self.trigger.drain())

        return Step(label, fn, F_ALL)

    def s_arrive(self, gang: str, members: int) -> Step:
        return Step(
            f"arrive_{gang}",
            lambda: self._arrive(self.store, gang, members),
            F_EVENT,
        )

    # -- harness surface ------------------------------------------------------

    def build(self) -> None:
        raise NotImplementedError

    def placements(self) -> dict:
        from kube_batch_tpu_torch.cache.store import PODS

        return {
            f"{p.namespace}/{p.name}": p.node_name for p in self.store.list(PODS)
        }

    def fingerprint(self):
        return self.placements()

    def invariants(self) -> list:
        out = []
        placed = self.placements()
        unbound = sorted(k for k, v in placed.items() if not v)
        if unbound:
            out.append(f"arrivals never bound: {unbound}")
        dupes = {k: n for k, n in self.bind_counts.items() if n != 1}
        if dupes:
            out.append(f"non-exactly-once bind transitions: {dupes}")
        out.extend(self._journal_invariant())
        return out

    def _journal_invariant(self) -> list:
        from kube_batch_tpu_torch.recovery import WriteIntentJournal

        if self.journal is None:
            return []
        orphans = WriteIntentJournal.replay(self.journal.path).orphans
        if orphans:
            return [
                "journal left with unconfirmed intents: "
                + ", ".join(f"{i.op} {i.pod} seq={i.seq}" for i in orphans)
            ]
        return []

    def cleanup(self) -> None:
        try:
            self.trigger.detach()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        for j in (self.journal, self.standby_journal):
            if j is not None:
                try:
                    j.close()
                except Exception:  # noqa: BLE001
                    pass
        for b, clk in self._orig_breaker_clocks.items():
            b._clock = clk


class _DyingBinder:
    """SIGKILL stand-in (the crash e2e's device): the Nth store bind
    raises a BaseException no retry ladder survives."""

    class LeaderKilled(BaseException):
        pass

    def __init__(self, store, die_after: int) -> None:
        from kube_batch_tpu_torch.cache.cache import StoreBinder

        self._inner = StoreBinder(store)
        self.left = die_after

    def bind(self, pod, hostname: str) -> None:
        if self.left <= 0:
            raise _DyingBinder.LeaderKilled()
        self.left -= 1
        self._inner.bind(pod, hostname)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


# -- the four scenarios -------------------------------------------------------


class MicroVsFull(Scenario):
    name = "micro_vs_full"
    describe = (
        "a gang arrival + micro-cycle drain racing the periodic full "
        "cycle and its backstop: every schedule must bind the gang "
        "exactly once, identically"
    )

    def build(self) -> None:
        self._wire(nodes=4)
        self.sched.run_once()  # adopt the resident table
        self.threads = [
            [self.s_full("full_cycle"), self.s_full("full_backstop")],
            [self.s_arrive("g1", 3), self.s_micro()],
        ]


class EventVsInvalidate(Scenario):
    name = "event_vs_invalidate"
    describe = (
        "a node-patch event + arrival + micro racing an external "
        "resident-table invalidation and the full cycle that re-adopts "
        "it: the invalid window may skip the micro but never lose the "
        "arrival or resurrect the dead table"
    )

    def build(self) -> None:
        self._wire(nodes=4)
        self.sched.run_once()

        def patch_node():
            # same-capacity relabel of an existing node: the patch
            # flows through trigger -> apply_node_patches without
            # changing any placement decision (parity stays exact)
            from kube_batch_tpu_torch.testing import build_node, build_resource_list

            self.store.update_node(
                build_node(
                    "n0",
                    build_resource_list(cpu=16, memory="16Gi", pods=64),
                    labels={"interleave/patched": "1"},
                )
            )

        self.threads = [
            [
                Step(
                    "invalidate_resident",
                    lambda: self.state.invalidate("external bound churn"),
                    F_STATE,
                ),
                self.s_full("full_readopt"),
            ],
            [
                Step("node_patch_event", patch_node, F_EVENT),
                self.s_arrive("g1", 3),
                self.s_micro(),
            ],
        ]


class TakeoverVsDispatch(Scenario):
    name = "takeover_vs_dispatch"
    describe = (
        "a leader killed mid-micro-dispatch left the journal holding an "
        "in-flight intent; the standby's reconciliation + full cycle "
        "race the dead leader's late-landing store write: idempotent "
        "re-dispatch must converge to the uninterrupted twin with zero "
        "lost and zero duplicate binds in every order"
    )

    def build(self) -> None:
        from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
        from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal
        from kube_batch_tpu_torch.scheduler import Scheduler

        # the uninterrupted twin: one full cycle over the complete world
        twin = ClusterStore()
        self._seed(twin, 4)
        self._arrive(twin, "g0", 6)
        conf = os.path.join(self.workdir, "twin.yaml")
        with open(conf, "w", encoding="utf-8") as fh:
            fh.write(_CONF)
        Scheduler(SchedulerCache(twin), scheduler_conf=conf).run_once()
        from kube_batch_tpu_torch.cache.store import PODS

        self.expected = {
            f"{p.namespace}/{p.name}": p.node_name for p in twin.list(PODS)
        }
        if not all(self.expected.values()):
            raise RuntimeError("model error: twin full cycle left pods unbound")

        # the real run: leader dies on its third inline dispatch
        self._wire(nodes=4, die_after=2)
        self.sched.run_once()
        self._arrive(self.store, "g0", 6)
        try:
            self.sched.run_micro(self.trigger.drain())
        except _DyingBinder.LeaderKilled:
            pass
        else:
            raise RuntimeError("model error: DyingBinder never fired")
        replay = WriteIntentJournal.replay(self.journal.path)
        if not replay.orphans:
            raise RuntimeError("model error: kill left no in-flight intent")
        orphan = min(replay.orphans, key=lambda i: i.seq)
        self.standby_journal = WriteIntentJournal(self.journal.path)

        def straggler():
            # the dead leader's write was already in flight: it lands
            # late, bound for exactly the journaled node
            from kube_batch_tpu_torch.cache.cache import StoreBinder

            ns, _, pname = orphan.pod.partition("/")
            pod = self.store.get_pod(ns, pname)
            if pod is not None:
                StoreBinder(self.store).bind(pod, orphan.node)

        def reconcile():
            reconcile_journal(self.standby_journal, self.store)

        def standby_full():
            conf2 = os.path.join(self.workdir, "standby.yaml")
            with open(conf2, "w", encoding="utf-8") as fh:
                fh.write(_CONF)
            Scheduler(
                SchedulerCache(self.store), scheduler_conf=conf2
            ).run_once()

        self.threads = [
            [Step("late_dispatch_lands", straggler, F_EVENT)],
            [
                Step("takeover_reconcile", reconcile, F_ALL),
                Step("standby_full_cycle", standby_full, F_EVENT | {L_JOURNAL}),
            ],
        ]

    def invariants(self) -> list:
        out = super().invariants()
        placed = self.placements()
        if placed != self.expected:
            diff = {
                k: (placed.get(k), self.expected.get(k))
                for k in set(placed) | set(self.expected)
                if placed.get(k) != self.expected.get(k)
            }
            out.append(f"diverged from the uninterrupted twin: {diff}")
        return out


class Watch410VsDrain(Scenario):
    name = "watch410_vs_drain"
    describe = (
        "a watch client re-listing after 410 Gone re-delivers the "
        "gang's add events into the dirty feed while the micro drain "
        "and backstop run: duplicate deliveries must never double-bind "
        "or lose an arrival"
    )

    def build(self) -> None:
        from kube_batch_tpu_torch.cache.store import PODS

        self._wire(nodes=4)
        self.sched.run_once()
        self._arrive(self.store, "g0", 3)
        relisted = [p for p in self.store.list(PODS)]

        def relist_dup():
            # the re-list window re-emits adds for objects already
            # delivered — straight into the module dirty feed, exactly
            # where cache.py publishes store events
            from kube_batch_tpu_torch.ops import encode_cache

            for p in relisted:
                encode_cache.note_store_event(PODS, p.metadata.uid, p, None)

        self.threads = [
            [Step("relist_duplicates", relist_dup, F_TRIG)],
            [self.s_micro(), self.s_full("full_backstop")],
        ]


class TwoSchedulerConflict(Scenario):
    name = "two_scheduler_conflict"
    describe = (
        "two federated schedulers snapshot the same store version and "
        "race gang dispatches onto ONE node: whichever dispatch lands "
        "second must lose its optimistic check (stale_node), refresh "
        "its snapshot version and win the retry — every schedule ends "
        "with both gangs bound exactly once, zero journal orphans on "
        "either journal, identical placements, no in-place mutations"
    )

    # every step contends on the store lock, so nothing prunes: all six
    # interleavings of {snap,bind} x {A,B} run
    L_CACHE_A = "cache_a._mutex"
    L_CACHE_B = "cache_b._mutex"
    L_JOURNAL_A = "journal_a._lock"
    L_JOURNAL_B = "journal_b._lock"

    def build(self) -> None:
        from kube_batch_tpu_torch.cache import ClusterStore
        from kube_batch_tpu_torch.cache.store import PODS, EventHandler
        from kube_batch_tpu_torch.faults.mutation_detector import MutationDetector
        from kube_batch_tpu_torch.federation import FederatedCache
        from kube_batch_tpu_torch.recovery import WriteIntentJournal
        from kube_batch_tpu_torch.utils.locking import LockOrderWitness

        self.store = ClusterStore()
        self._seed(self.store, nodes=1)  # one node: every dispatch collides
        self.bind_counts: dict = {}

        def on_update(old, new):
            if not old.node_name and new.node_name:
                key = f"{new.namespace}/{new.name}"
                self.bind_counts[key] = self.bind_counts.get(key, 0) + 1

        self.store.add_event_handler(PODS, EventHandler(on_update=on_update))
        self._arrive(self.store, "ga", 3)
        self._arrive(self.store, "gb", 3)
        self.journal = WriteIntentJournal(os.path.join(self.workdir, "a.wal"))
        self.standby_journal = WriteIntentJournal(
            os.path.join(self.workdir, "b.wal")
        )
        # gang-keyed shards chosen so ga -> A, gb -> B deterministically
        # (crc32 is stable); no writer pools: each bind step IS its
        # conditional store transaction, retries included
        self.cache_a = self._shard_cache_for("ga", self.journal)
        self.cache_b = self._shard_cache_for("gb", self.standby_journal)
        self.detector = MutationDetector(self.store)
        self.detector.snapshot()

        self.witness = LockOrderWitness()
        self.store._lock = self.witness.wrap(L_STORE, self.store._lock)
        self.cache_a._mutex = self.witness.wrap(self.L_CACHE_A, self.cache_a._mutex)
        self.cache_b._mutex = self.witness.wrap(self.L_CACHE_B, self.cache_b._mutex)
        self.journal._lock = self.witness.wrap(self.L_JOURNAL_A, self.journal._lock)
        self.standby_journal._lock = self.witness.wrap(
            self.L_JOURNAL_B, self.standby_journal._lock
        )

        f_snap_a = frozenset({L_STORE, self.L_CACHE_A})
        f_snap_b = frozenset({L_STORE, self.L_CACHE_B})
        # a dispatch touches everything: its own mutex + journal, the
        # store, AND the peer cache (the commit's update events fan out
        # to the peer's informer handlers synchronously)
        f_bind_a = frozenset(
            {L_STORE, self.L_CACHE_A, self.L_CACHE_B, self.L_JOURNAL_A}
        )
        f_bind_b = frozenset(
            {L_STORE, self.L_CACHE_A, self.L_CACHE_B, self.L_JOURNAL_B}
        )
        self.threads = [
            [
                Step("snapshot_a", lambda: self.cache_a.snapshot(), f_snap_a),
                Step("dispatch_a", lambda: self._bind_gang(self.cache_a, "ga"), f_bind_a),
            ],
            [
                Step("snapshot_b", lambda: self.cache_b.snapshot(), f_snap_b),
                Step("dispatch_b", lambda: self._bind_gang(self.cache_b, "gb"), f_bind_b),
            ],
        ]

    def _shard_cache_for(self, gang: str, journal):
        """A FederatedCache whose shard is whichever bucket ``gang``
        hashes into (2 shards, gang key) — the scenario stays valid if
        crc32's bucket assignment ever changes."""
        from kube_batch_tpu_torch.federation import FederatedCache, shard_index
        from kube_batch_tpu_torch.api.job_info import job_key

        shard = shard_index(job_key("default", gang), 2)
        return FederatedCache(
            self.store, shard=shard, shards=2, shard_key="gang", journal=journal
        )

    @staticmethod
    def _bind_gang(cache, gang: str) -> None:
        from kube_batch_tpu_torch.api.job_info import job_key
        from kube_batch_tpu_torch.api.types import TaskStatus

        uid = job_key("default", gang)
        with cache._mutex:
            job = cache.jobs.get(uid)
            pending = (
                list(job.task_status_index.get(TaskStatus.PENDING, {}).values())
                if job is not None
                else []
            )
        if not pending:
            raise RuntimeError(f"model error: gang {gang} has no pending tasks")
        cache.bind_many([(t, "n0") for t in pending])

    def invariants(self) -> list:
        out = super().invariants()
        from kube_batch_tpu_torch.recovery import WriteIntentJournal

        orphans = WriteIntentJournal.replay(self.standby_journal.path).orphans
        if orphans:
            out.append(
                "scheduler B's journal left with unconfirmed intents: "
                + ", ".join(f"{i.op} {i.pod} seq={i.seq}" for i in orphans)
            )
        mutated = self.detector.violations()
        if mutated:
            out.append(f"in-place mutation of store objects: {mutated}")
        from kube_batch_tpu_torch.federation import fsck

        out.extend(fsck(self.store))
        return out


class AdoptVsDispatch(Scenario):
    name = "adopt_vs_dispatch"
    describe = (
        "slot adoption racing a straggler dispatch from the "
        "killed owner: the dead shard's in-flight conditional gang "
        "transaction lands late — against the survivor's takeover "
        "reconciliation and its post-adoption full cycle. Whichever "
        "lands first, the optimistic check arbitrates: the straggler "
        "either wins (reconciliation confirms the landed binds) or "
        "loses StaleWrite (reconciliation already re-dispatched). Every "
        "schedule must end with both gangs bound exactly once on the "
        "journaled placements, both journals orphan-free, the slot "
        "owned by the survivor, and fsck clean"
    )

    L_CACHE_V = "cache_victim._mutex"
    L_CACHE_S = "cache_survivor._mutex"
    L_JOURNAL_V = "journal_victim._lock"
    L_JOURNAL_S = "journal_survivor._lock"

    def build(self) -> None:
        from kube_batch_tpu_torch.api.job_info import job_key
        from kube_batch_tpu_torch.cache import ClusterStore
        from kube_batch_tpu_torch.cache.store import PODS, EventHandler
        from kube_batch_tpu_torch.federation import (
            FederatedCache,
            ShardSlotManager,
            shard_index,
            shard_journal_path,
            slot_lease_name,
        )
        from kube_batch_tpu_torch.recovery import WriteIntentJournal
        from kube_batch_tpu_torch.utils.locking import LockOrderWitness

        self.store = ClusterStore()
        self._seed(self.store, nodes=1)  # one node: parity is trivial
        self.bind_counts: dict = {}

        def on_update(old, new):
            if not old.node_name and new.node_name:
                key = f"{new.namespace}/{new.name}"
                self.bind_counts[key] = self.bind_counts.get(key, 0) + 1

        self.store.add_event_handler(PODS, EventHandler(on_update=on_update))

        # gang "ga" belongs to the victim's slot; pick the survivor's
        # own gang so it provably hashes into the OTHER slot (the
        # scenario stays valid if crc32's bucket assignment changes)
        self.victim_slot = shard_index(job_key("default", "ga"), 2)
        self.survivor_slot = 1 - self.victim_slot
        survivor_gang = next(
            g for g in ("gb", "gc", "gd", "ge", "gf")
            if shard_index(job_key("default", g), 2) == self.survivor_slot
        )
        self._arrive(self.store, "ga", 3)
        self._arrive(self.store, survivor_gang, 3)
        self.survivor_gang = survivor_gang

        # journals live where adoption's takeover reconciliation looks:
        # shard-{slot}.wal under the shared journal dir
        self.journal = WriteIntentJournal(
            shard_journal_path(self.workdir, self.victim_slot)
        )
        self.standby_journal = WriteIntentJournal(
            shard_journal_path(self.workdir, self.survivor_slot)
        )
        victim = FederatedCache(
            self.store, shard=self.victim_slot, shards=2, shard_key="gang",
            journal=self.journal, binder=_CondDyingBinder(self.store),
        )
        self.cache_survivor = FederatedCache(
            self.store, shard=self.survivor_slot, shards=2, shard_key="gang",
            journal=self.standby_journal,
        )
        self.cache_victim = victim

        # the kill, pre-schedule and deterministic: the victim journals
        # its gang's intents, then its conditional transaction dies
        # mid-flight (BaseException through the optimistic-bind path)
        victim.snapshot()
        self.stale_version = victim._snapshot_version
        try:
            _bind_gang_pending(victim, "ga")
        except _DyingBinder.LeaderKilled:
            pass
        else:
            raise RuntimeError("model error: conditional DyingBinder never fired")
        replay = WriteIntentJournal.replay(self.journal.path)
        if len(replay.orphans) != 3:
            raise RuntimeError(
                "model error: kill left "
                f"{len(replay.orphans)} in-flight intent(s), wanted 3"
            )
        self.bindings = [
            (*intent.pod.partition("/")[::2], intent.node)
            for intent in sorted(replay.orphans, key=lambda i: i.seq)
        ]

        # the survivor: owns its slot (lease + manager state); the
        # victim's slot lease is NOT created — an expired/never-renewed
        # lease and a missing one take the same adoption path
        self.mgr = ShardSlotManager(
            self.store, self.cache_survivor, identity="survivor",
            lease_s=1000.0, renew_s=100.0, adopt=True,
            journal_dir=self.workdir, grace_s=0.0, rebalance=0,
        )
        self.store.try_acquire_lease(
            slot_lease_name(self.survivor_slot), "survivor", 1000.0
        )
        self.mgr._set_owned({self.survivor_slot})

        self.witness = LockOrderWitness()
        self.store._lock = self.witness.wrap(L_STORE, self.store._lock)
        self.cache_victim._mutex = self.witness.wrap(
            self.L_CACHE_V, self.cache_victim._mutex
        )
        self.cache_survivor._mutex = self.witness.wrap(
            self.L_CACHE_S, self.cache_survivor._mutex
        )
        self.journal._lock = self.witness.wrap(self.L_JOURNAL_V, self.journal._lock)
        self.standby_journal._lock = self.witness.wrap(
            self.L_JOURNAL_S, self.standby_journal._lock
        )

        def straggler():
            # the dead owner's write was already on the wire: the SAME
            # conditional transaction, carrying the snapshot version it
            # captured before dying — the optimistic check decides
            from kube_batch_tpu_torch.cache.cache import StoreBinder
            from kube_batch_tpu_torch.cache.store import StaleWrite

            try:
                StoreBinder(self.store).bind_many_versioned(
                    self.bindings, self.stale_version
                )
            except StaleWrite:
                pass  # reconciliation landed first; the dead owner lost

        def adopt():
            # the probe's winning half: take the orphaned slot's lease,
            # then the full takeover (reconcile the dead owner's journal,
            # widen the owned set, re-ingest the backlog)
            self.store.try_acquire_lease(
                slot_lease_name(self.victim_slot), "survivor", 1000.0
            )
            self.mgr._adopt(self.victim_slot, t0=self.clock.now())

        def survivor_full():
            from kube_batch_tpu_torch.cache import SchedulerCache  # noqa: F401
            from kube_batch_tpu_torch.scheduler import Scheduler

            conf = os.path.join(self.workdir, "survivor.yaml")
            with open(conf, "w", encoding="utf-8") as fh:
                fh.write(_CONF)
            Scheduler(self.cache_survivor, scheduler_conf=conf).run_once()

        # every step can reach the store, both caches (commit events fan
        # out to both mirrors synchronously) and both journals — nothing
        # prunes, all three interleavings run
        f_all = frozenset({
            L_STORE, self.L_CACHE_V, self.L_CACHE_S,
            self.L_JOURNAL_V, self.L_JOURNAL_S,
        })
        self.threads = [
            [Step("straggler_dispatch_lands", straggler, f_all)],
            [
                Step("adopt_slot_takeover", adopt, f_all),
                Step("survivor_full_cycle", survivor_full, f_all),
            ],
        ]

    def invariants(self) -> list:
        out = super().invariants()
        from kube_batch_tpu_torch.federation import fsck
        from kube_batch_tpu_torch.recovery import WriteIntentJournal

        orphans = WriteIntentJournal.replay(self.standby_journal.path).orphans
        if orphans:
            out.append(
                "survivor's journal left with unconfirmed intents: "
                + ", ".join(f"{i.op} {i.pod} seq={i.seq}" for i in orphans)
            )
        if self.victim_slot not in self.cache_survivor.owned_slots:
            out.append(
                f"survivor never adopted slot {self.victim_slot} "
                f"(owned: {sorted(self.cache_survivor.owned_slots)})"
            )
        placed = self.placements()
        moved = {
            f"{ns}/{name}": (placed.get(f"{ns}/{name}"), node)
            for ns, name, node in self.bindings
            if placed.get(f"{ns}/{name}") != node
        }
        if moved:
            out.append(
                "killed owner's gang diverged from its journaled "
                f"placement (got, want): {moved}"
            )
        out.extend(fsck(self.store, shard_key="gang"))
        return out


class _CondDyingBinder:
    """Conditional-path SIGKILL stand-in: the first optimistic gang
    transaction dies mid-flight (after the intents are journaled,
    before anything lands) — the adopt_vs_dispatch premise."""

    def __init__(self, store) -> None:
        from kube_batch_tpu_torch.cache.cache import StoreBinder

        self._inner = StoreBinder(store)

    def bind_many_versioned(self, bindings, snapshot_version):
        raise _DyingBinder.LeaderKilled()

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def _bind_gang_pending(cache, gang: str) -> None:
    """Dispatch every pending task of ``gang`` through the cache's bulk
    (conditional) bind path — shared by the two federated scenarios."""
    from kube_batch_tpu_torch.api.job_info import job_key
    from kube_batch_tpu_torch.api.types import TaskStatus

    uid = job_key("default", gang)
    with cache._mutex:
        job = cache.jobs.get(uid)
        pending = (
            list(job.task_status_index.get(TaskStatus.PENDING, {}).values())
            if job is not None
            else []
        )
    if not pending:
        raise RuntimeError(f"model error: gang {gang} has no pending tasks")
    cache.bind_many([(t, "n0") for t in pending])


# -- the intentionally broken fixture ----------------------------------------


def _lossy_trigger():
    """``drain()`` empties the backlog instead of copy-until-prune —
    the bug class StreamTrigger.drain's docstring warns about. Exists
    only so the explorer demonstrably finds and replays a
    counterexample (trace ``broken_drain:011``)."""
    from kube_batch_tpu_torch.streaming import StreamTrigger

    class Lossy(StreamTrigger):
        def drain(self):
            work = super().drain()
            with self._lock:
                self._gangs.clear()  # the bug
            return work

    return Lossy()


class BrokenDrain(Scenario):
    name = "broken_drain"
    describe = (
        "FIXTURE (intentionally broken): a lossy drain() races a "
        "staleness mark; the schedule where the stale drain precedes "
        "the serving drain loses the gang from the backlog with no "
        "full cycle left to save it"
    )
    parity = False  # schedules legitimately differ (no backstop)

    @staticmethod
    def _make_trigger():
        return _lossy_trigger()

    def build(self) -> None:
        self._wire(nodes=4)
        self.sched.run_once()
        self._arrive(self.store, "g1", 3)
        self.threads = [
            [
                Step(
                    "mark_stale",
                    lambda: self.trigger._mark_stale("watch ring overflow"),
                    F_TRIG,
                )
            ],
            [self.s_micro("drain_micro_1"), self.s_micro("drain_micro_2")],
        ]

    def invariants(self) -> list:
        # binding everything is NOT required here (no backstop full
        # cycle by construction); what is required is that nothing
        # pending vanished from the backlog
        from kube_batch_tpu_torch.streaming import gang_key_of
        from kube_batch_tpu_torch.cache.store import PODS

        out = []
        pending_gangs = {
            gang_key_of(p) for p in self.store.list(PODS) if not p.node_name
        }
        with self.trigger._lock:
            backlog = set(self.trigger._gangs)
        lost = sorted(pending_gangs - backlog)
        if lost:
            out.append(
                f"arrival lost: gang(s) {lost} are pending in the store "
                "but gone from the trigger backlog — no micro-cycle will "
                "ever serve them"
            )
        dupes = {k: n for k, n in self.bind_counts.items() if n > 1}
        if dupes:
            out.append(f"duplicate bind transitions: {dupes}")
        return out


# The pipelined-cycles scenario routes allocation through torch_allocate
# — the only action with a deferrable post-solve phase — on the
# explorer's device (kernel B1 on a card, its plain version on the CPU),
# with min_device_pairs 0 so the tiny model cluster cannot be rerouted
# to serial by the size floor (the same pin the parity suites use).
# With the writer pool off (the harness never calls cache.run()),
# submit_dispatch runs the deferred closure inline at submission, so
# the fence/deferred-tail protocol executes in full while the schedule
# stays the only source of nondeterminism.
def _conf_pipeline(device: str) -> str:
    return _CONF.replace(
        'actions: "enqueue, allocate, backfill"',
        'actions: "enqueue, torch_allocate, backfill"\n'
        "actionArguments:\n"
        "  torch_allocate:\n"
        f"    device: {device}\n"
        '    min_device_pairs: "0"',
    )


class DispatchVsNextSolve(Scenario):
    name = "dispatch_vs_next_solve"
    describe = (
        "pipelined cycles (KBT_PIPELINE): cycle N's deferred dispatch "
        "racing cycle N+1's snapshot through the dispatch fence, with "
        "a gang arrival + micro drain in flight — every schedule must "
        "bind both gangs exactly once, identically, and leave the "
        "fence clean"
    )

    def build(self) -> None:
        from kube_batch_tpu_torch import pipeline

        self._saved_pipeline_env = os.environ.get(pipeline.ENV)
        os.environ[pipeline.ENV] = "1"
        pipeline.reset()
        # One node (it fits both gangs): whichever cycle binds first,
        # every pod lands on n0, so bind-for-bind parity holds across
        # schedules even though g1/g2 bind order varies.
        self._wire(nodes=1, conf_text=_conf_pipeline(self.device))
        self.sched.run_once()  # adopt the resident table
        self._arrive(self.store, "g1", 3)  # cycle N has binds to defer
        # Prune g1 from the trigger backlog (drain() alone copies
        # without removing): the racing micro-cycle can then only ever
        # serve g2, so every schedule has at least one full cycle with
        # work to defer — without this, a micro-first schedule drains
        # everything and the fence protocol never runs.
        self.trigger.prune({"default/g1"})
        self.threads = [
            [self.s_full("full_cycle_n"), self.s_full("full_cycle_n1")],
            [self.s_arrive("g2", 3), self.s_micro()],
        ]

    def invariants(self) -> list:
        from kube_batch_tpu_torch import pipeline

        out = super().invariants()
        if pipeline.fence.degraded_reason is not None:
            out.append(
                "pipeline degraded to synchronous during a clean "
                f"schedule: {pipeline.fence.degraded_reason}"
            )
        if pipeline.fence.pending():
            out.append(
                "dispatch fence left armed after every cycle completed "
                "— a deferred dispatch was never joined"
            )
        if pipeline.fence._dispatch_s <= 0.0:
            out.append(
                "model error: no cycle recorded a deferred dispatch — "
                "the pipelined path never engaged (serial reroute?) and "
                "the scenario checked nothing"
            )
        return out

    def cleanup(self) -> None:
        from kube_batch_tpu_torch import pipeline

        pipeline.reset()
        if self._saved_pipeline_env is None:
            os.environ.pop(pipeline.ENV, None)
        else:
            os.environ[pipeline.ENV] = self._saved_pipeline_env
        super().cleanup()


# The admission gate has its own RLock the witness does not wrap; the
# virtual token serializes gate-touching steps in the commutation check
# the same way STATE does for the lockless resident table.
GATE = "admission_gate"
F_GATE = frozenset({GATE})


class AdmissionStorm(Scenario):
    name = "admission_storm"
    describe = (
        "front-door admission (decide + lane charge) racing brownout "
        "escalation ticks, a closed-lane shed, and the micro/full "
        "dispatch whose bind echoes credit the lanes back: every "
        "schedule must bind each admitted pod exactly once, never "
        "admit through the closed lane, land on the same brownout "
        "level, and leave zero inflight once all echoes are in"
    )

    def build(self) -> None:
        from kube_batch_tpu_torch import admission
        from kube_batch_tpu_torch.cache.store import PODS, EventHandler

        self._wire(nodes=4)
        self.sched.run_once()  # adopt the resident table
        # Two sustained over-SLO ticks (UP_TICKS) escalate the ladder
        # regardless of where they land in the schedule; the high lane
        # is brownout-protected and the low lane is rate-closed, so
        # every decide outcome is schedule-independent by construction.
        hot = {
            "enabled": True,
            "slo": {"time_to_bind": {"high": {"n": 50, "p99": 5.0}}},
            "backlog_pods": 0.0,
            "shard_up": {"http://s0": True},
            "node_conflict_topk": {},
        }
        self.gate = admission.AdmissionGate(
            [admission.LaneSpec("high", 100, rate=50.0, burst=50.0, backlog=120),
             admission.LaneSpec("low", 0, rate=1e-4, burst=1.0, backlog=120)],
            fleet_fn=lambda: hot, age_fn=lambda: 0.0,
            slo_s=1.0, interval_s=1000.0,
        )
        # the storm pre-state: the low lane burned its burst before this
        # window opens, and at 1e-4 tokens/s it cannot accrue a whole
        # token during the run — every schedule sheds it identically
        # (shed_rate before a tick lands, shed_brownout after)
        self.gate.lanes["low"].bucket._tokens = 0.0
        self.shed_decisions: list = []

        def on_update(old, new):
            # the server's wiring: a bind echo credits the lane backlog
            if not old.node_name and new.node_name:
                self.gate.note_done(f"{new.namespace}/{new.name}")

        self.store.add_event_handler(PODS, EventHandler(on_update=on_update))

        def admit_and_arrive():
            for m in range(2):
                d = self.gate.decide("high", f"default/g1-p{m}")
                if not d.admitted:
                    raise AssertionError(
                        f"protected high lane shed an arrival: {d.reason}"
                    )
            self._arrive(self.store, "g1", 2)

        def force_tick():
            # the step IS the tick: rewind the interval clock so
            # maybe_tick fires exactly here and nowhere else (decide's
            # own maybe_tick stays blocked by the 1000s interval)
            self.gate._last_tick = -1e9
            self.gate.maybe_tick()

        def shed_low():
            self.shed_decisions.append(self.gate.decide("low", "default/shed-0"))

        self.threads = [
            [
                Step("admit_arrive_high", admit_and_arrive, F_EVENT | F_GATE),
                Step("micro_drain",
                     lambda: self.sched.run_micro(self.trigger.drain()),
                     F_ALL | F_GATE),
            ],
            [
                Step("pressure_tick_1", force_tick, F_GATE),
                Step("pressure_tick_2", force_tick, F_GATE),
            ],
            [
                Step("shed_low", shed_low, F_GATE),
                Step("full_backstop", self.sched.run_once, F_ALL | F_GATE),
            ],
        ]

    def fingerprint(self):
        # placements + the settled controller level: schedules must
        # agree on both (two hot ticks always escalate exactly once)
        return (tuple(sorted(self.placements().items())),
                self.gate.controller.level)

    def invariants(self) -> list:
        out = super().invariants()
        lanes = self.gate.lanes
        if lanes["low"].admitted != 0:
            out.append(
                f"closed low lane admitted {lanes['low'].admitted} pods"
            )
        if lanes["high"].admitted != 2:
            out.append(
                f"high lane admitted {lanes['high'].admitted} pods, want 2"
            )
        for d in self.shed_decisions:
            if d.admitted or not d.reason.startswith("shed_"):
                out.append(f"closed-lane decide leaked through: {d}")
            if d.retry_after_s <= 0:
                out.append(f"shed without Retry-After guidance: {d}")
        inflight = sum(l.inflight for l in lanes.values())
        if inflight != 0:
            out.append(
                f"{inflight} admitted pods never credited back — a bind "
                "echo was lost or double-charged"
            )
        if self.gate.controller.level < 1:
            out.append(
                "two sustained over-SLO ticks never escalated the "
                "brownout ladder — the overload response is inert"
            )
        return out


class UnderdeclaredState(Scenario):
    name = "underdeclared_state"
    describe = (
        "FIXTURE (intentionally broken): a step reads the lockless "
        "resident table (StreamState.valid) without declaring the "
        "STATE token in its footprint — the field-level RaceWitness "
        "upgrades the under-declaration into a KBT-I002 model error "
        "that pure lock-acquire observation could never see"
    )
    parity = False  # the seeded violation aborts fingerprinting

    def build(self) -> None:
        self._wire(nodes=2)
        self.threads = [
            # footprint claims trigger-lock only; the body touches the
            # watched resident table -> observed {STATE} ⊄ F_TRIG
            [Step("peek_state", lambda: self.state.valid, F_TRIG)],
        ]


SCENARIOS = {
    c.name: c
    for c in (
        MicroVsFull,
        EventVsInvalidate,
        TakeoverVsDispatch,
        Watch410VsDrain,
        TwoSchedulerConflict,
        DispatchVsNextSolve,
        AdoptVsDispatch,
        AdmissionStorm,
    )
}
FIXTURES = {
    BrokenDrain.name: BrokenDrain,
    UnderdeclaredState.name: UnderdeclaredState,
}


# -- explorer -----------------------------------------------------------------


def _run_schedule(
    scn_cls, root: str, order, trace: str, verbose: bool = False, device: str = "cuda",
) -> ScheduleResult:
    from kube_batch_tpu_torch import faults

    faults.registry.reset()
    faults.solver_ladder.reset()
    scn = scn_cls(tempfile.mkdtemp(prefix="run-", dir=root), device)
    result = ScheduleResult(trace=trace, steps=[], violations=[])
    try:
        try:
            scn.build()
        except Exception as e:  # noqa: BLE001 - a broken scenario build is a finding
            result.violations.append(
                f"model error: scenario build raised {type(e).__name__}: {e}"
            )
            return result
        observed: dict = {}
        cursor = {"i": -1}

        def on_acquire(name: str) -> None:
            if cursor["i"] >= 0:
                observed.setdefault(cursor["i"], set()).add(name)

        scn.witness.on_acquire = on_acquire
        race = getattr(scn, "race", None)
        if race is not None:
            # field-level: actual watched-state accesses (STATE et al.)
            # feed the same observed-vs-footprint check as lock acquires
            race.on_access = on_acquire
        pos = [0] * len(scn.threads)
        for i, tid in enumerate(order):
            step = scn.threads[tid][pos[tid]]
            pos[tid] += 1
            cursor["i"] = i
            t = scn.clock.advance(1.0)
            try:
                step.fn()
            except Exception as e:  # noqa: BLE001 - a raising step is a finding
                result.violations.append(
                    f"step {step.name} raised {type(e).__name__}: {e}"
                )
                break
            finally:
                cursor["i"] = -1
            result.steps.append((t, tid, step.name))
            if verbose:
                print(f"  t={t:>4.0f}  T{tid}  {step.name}")
            extra = sorted(observed.get(i, set()) - step.footprint)
            if extra:
                result.violations.append(
                    f"model error: step {step.name} acquired undeclared "
                    f"lock(s)/state token(s) {extra} — footprint "
                    "under-declared, DPOR pruning would be unsound"
                )
        result.violations.extend(scn.witness.violations)
        result.violations.extend(scn.invariants())
        if not result.violations:
            result.fingerprint = scn.fingerprint()
    finally:
        scn.cleanup()
    return result


def _check_device(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"interleave on {device!r}: no CUDA device (pass device='cpu' / --device cpu)")


def explore(
    name: str, root: Optional[str] = None, verbose: bool = False, device: str = "cuda",
) -> ScenarioReport:
    """Drive one scenario through every canonical schedule; a
    torch_allocate step solves on ``device`` (the card by default; with
    none it raises unless ``device="cpu"``)."""
    _check_device(device)
    scn_cls = SCENARIOS.get(name) or FIXTURES.get(name)
    if scn_cls is None:
        raise SystemExit(
            f"unknown scenario {name!r} (have: "
            f"{', '.join([*SCENARIOS, *FIXTURES])})"
        )
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="kbt-interleave-")
    try:
        plan_scn = scn_cls(tempfile.mkdtemp(prefix="plan-", dir=root), device)
        try:
            try:
                plan_scn.build()
            except Exception as e:  # noqa: BLE001 - a broken scenario build is a finding
                return ScenarioReport(
                    name=scn_cls.name, describe=scn_cls.describe,
                    results=[
                        ScheduleResult(
                            trace=f"{scn_cls.name}:build", steps=[],
                            violations=[
                                "model error: scenario build raised "
                                f"{type(e).__name__}: {e}"
                            ],
                        )
                    ],
                )
            plan = plan_scn.threads
            orders, pruned = _schedules(plan)
        finally:
            plan_scn.cleanup()
        report = ScenarioReport(
            name=scn_cls.name, describe=scn_cls.describe,
            schedules=len(orders), pruned_branches=pruned,
        )
        for order in orders:
            trace = f"{scn_cls.name}:{''.join(str(t) for t in order)}"
            report.results.append(
                _run_schedule(scn_cls, root, order, trace, verbose=verbose, device=device)
            )
        if scn_cls.parity:
            clean = [r for r in report.results if not r.violations]
            fps = {json.dumps(r.fingerprint, sort_keys=True) for r in clean}
            if len(fps) > 1:
                samples = sorted(
                    (json.dumps(r.fingerprint, sort_keys=True), r.trace) for r in clean
                )
                report.results.append(
                    ScheduleResult(
                        trace=f"{scn_cls.name}:parity",
                        steps=[],
                        violations=[
                            "bind-for-bind parity broken across schedules: "
                            f"{samples[0][1]} and {samples[-1][1]} disagree "
                            f"on placements"
                        ],
                    )
                )
        return report
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def replay(trace: str, device: str = "cuda") -> ScheduleResult:
    """Re-run one schedule by its trace id, verbosely."""
    _check_device(device)
    name, _, digits = trace.partition(":")
    scn_cls = SCENARIOS.get(name) or FIXTURES.get(name)
    if scn_cls is None or not digits or not digits.isdigit():
        raise SystemExit(f"unknown trace {trace!r} (want <scenario>:<tid digits>)")
    order = tuple(int(d) for d in digits)
    root = tempfile.mkdtemp(prefix="kbt-replay-")
    try:
        print(f"replaying {trace}:")
        return _run_schedule(scn_cls, root, order, trace, verbose=True, device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- CLI ----------------------------------------------------------------------


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    strict = "--strict" in argv
    as_json = "--json" in argv
    do_list = "--list" in argv
    only = None
    trace = None
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    if "--scenario" in argv:
        only = argv[argv.index("--scenario") + 1]
    if "--replay" in argv:
        trace = argv[argv.index("--replay") + 1]
    known = {"--strict", "--json", "--list", "--scenario", "--replay", "--device"}
    unknown = [
        a for a in argv
        if a.startswith("--") and a not in known
    ]
    if unknown:
        print(f"unknown option(s): {unknown}", file=sys.stderr)
        print(__doc__.split("\n\n")[0], file=sys.stderr)
        return 2

    if do_list:
        for pool, tag in ((SCENARIOS, ""), (FIXTURES, "  [fixture]")):
            for name, cls in pool.items():
                print(f"{name}{tag}: {cls.describe}")
        return 0

    if trace is not None:
        r = replay(trace, device)
        for v in r.violations:
            print(f"  VIOLATION: {v}")
        print(f"replay {trace}: {'FAIL' if r.violations else 'clean'}")
        return 1 if r.violations else 0

    t0 = time.perf_counter()
    names = [only] if only else list(SCENARIOS)
    reports = [explore(n, device=device) for n in names]
    findings = [f for rep in reports for f in rep.findings()]

    repo = repo_root()
    bl = load_baseline(os.path.join(repo, BASELINE), repo)
    kept, suppressed, stale = apply_baseline(findings, bl)
    kept.extend(bl.errors)
    if strict:
        kept.extend(stale)

    if as_json:
        print(
            json.dumps(
                {
                    "scenarios": [
                        {
                            "name": rep.name,
                            "schedules": rep.schedules,
                            "pruned_branches": rep.pruned_branches,
                            "counterexamples": [
                                {"trace": r.trace, "violations": r.violations}
                                for r in rep.counterexamples
                            ],
                        }
                        for rep in reports
                    ],
                    "findings": [f.render() for f in kept],
                    "suppressed": len(suppressed),
                    "elapsed_s": round(time.perf_counter() - t0, 2),
                },
                indent=2,
            )
        )
    else:
        for rep in reports:
            status = (
                "clean" if not rep.counterexamples
                else f"{len(rep.counterexamples)} counterexample(s)"
            )
            print(
                f"interleave: {rep.name}: {rep.schedules} schedule(s), "
                f"{rep.pruned_branches} branch(es) pruned, {status}"
            )
        for f in kept:
            print(f.render())
        print(
            f"interleave: {sum(r.schedules for r in reports)} schedule(s) "
            f"across {len(reports)} scenario(s), {len(kept)} finding(s), "
            f"{len(suppressed)} suppressed, "
            f"{time.perf_counter() - t0:.1f}s"
        )
    return 1 if kept else 0


if __name__ == "__main__":
    sys.exit(main())
