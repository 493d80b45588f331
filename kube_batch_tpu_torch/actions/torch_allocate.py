"""torch_allocate action: the allocate loop as one device solve on the card.

Drop-in replacement for the serial allocate action (conf
``actions: "torch_allocate, backfill"``): encodes the session snapshot to
SoA arrays (ops/encode.py), runs the gang-aware solve on one of the two
device rungs —

- **fused**: the whole solve in one launch of kernel B1
  (``ops/fused_solve.FusedSolver``, ``csrc/fused_solve.cu``);
- **sharded**: with a mesh, the node-sharded solve
  (``parallel/sharded_block.ShardedBlockSolver``) on kernel B4, the whole
  gang loop in one launch a card with the winner exchanged between cards
  inside the kernel (``ops/mesh_solve.py``, ``csrc/mesh_solve.cu``; its
  plain version on a CPU mesh): once a placing iteration at K = 1, once a
  round of K speculated placing iterations at K > 1 (the K-deep batched
  exchange) —

then **bulk-replays** the assignments into the session: the same state
mutations `ssn.allocate`/`ssn.pipeline` would make (status index moves,
node accounting, drf/proportion event bookkeeping, the gang dispatch
barrier with cache binds), applied in solve order.

Action arguments (``actionArguments: {torch_allocate: {...}}``):

- ``device``: ``cuda`` (the default; ``cuda:<i>`` names a card) or
  ``cpu``, which runs the kernels' plain versions (how the tests drive the
  action). With no CUDA device visible, ``cuda`` raises: the action never
  falls back to the CPU or to serial for want of a card;
- ``mesh``: ``off``/``0``/``1`` (the default) select the fused rung;
  ``auto`` or an integer take that many visible devices of the device's
  type; ``<backend>:<count>`` (``cpu:4``, ``cuda:4``) gives ``count``
  shards round-robin over that backend's visible devices, repeats allowed
  (four shards on one card). Every form is clamped to a power of two, as
  in the JAX package; a mesh of one is the fused rung. A value the JAX
  package reads as single-chip (``many``, ``-2``, ``tpu:4``) logs a
  warning and solves on the fused rung, as there;
- ``exchange_batch``: K of the sharded rung's K-deep batched exchange,
  1 to 64 (1: no batching). When the conf names none, K follows the JAX
  package's rule: 1 unless ``KBT_PIPELINE`` is on, then
  ``KBT_EXCHANGE_BATCH`` (4 when unset, clamped to 1..64, 4 with an error
  logged when it is not an integer; ``parallel/sharded_block.
  default_exchange_batch``);
- ``min_device_pairs``: the size floor (pending tasks x nodes) below
  which the cycle runs serially (256; a mesh request skips it).

Routing to serial, each recorded as ``last_solver_tier = "serial"`` with
the reason in ``last_timings`` (``serial_reason``): a conf outside the
solve's envelope (actions/envelope.py) and a snapshot below the size floor
(``serial_routed_s``); and the degradations of the solver ladder
(``serial_degraded_s``), each also counted as
``degraded_cycles{tier="serial",reason=...}``:

- ``breaker_open``: the fused rung's circuit breaker
  (``faults.solver_ladder``) is open; the cycle runs serially before the
  encode;
- ``nonfinite: <inputs>``: non-finite solver inputs (the ``solve.nan``
  fault point poisons ``w_least``);
- ``solve_failed``: the fused rung failed a segment (the ``solve.fused``
  fault point, or organically on ``device: cpu``) and fed its breaker; serial finishes the
  cycle, and host-step segments already replayed stand.

The ladder runs sharded -> fused -> serial (the JAX package's runs
mesh_pallas -> pallas -> xla -> serial; the port has no XLA twin and no
GSPMD rung on the card). A sharded failure (organic or ``solve.sharded``)
feeds the ``sharded`` breaker and the fused rung resumes from the same
``SolveState`` in the same cycle; with the ``sharded`` breaker open, a
mesh conf solves on the fused rung. Some failures are not faults and
raise out of ``execute``, since each would fail every cycle and a breaker
would then route every cycle to the CPU for good: no visible card for
``device: cuda`` (``RuntimeError``), a kernel that cannot be built or
loaded (``KernelBuildError``), a snapshot the fused rung cannot take,
past kernel B1's shared-memory limit or with a cluster the card cannot
hold (``DeviceSolveError``, before any bind), and an organic failure of
the fused rung on a card (``DeviceSolveError``). So on a card the cycle
reaches the serial rung through ``solve.fused`` alone; an organic fused
failure degrades only on ``device: cpu``. A deadline abort
(``CycleDeadlineExceeded``) never feeds a breaker.

Pod (anti-)affinity is pairwise-dynamic over resident pods
(predicates.go:187-199) and volume claims need the volume binder: such a
task is stepped on the host. The solve pauses when one reaches the head
of its job (``SolveState.paused_at``); the action replays the segment,
runs the serial inner loop for that one task against the live session
(allocate.go:139-180), patches a copy of the solver state, refreshes the
InterPodAffinity scores in the solver's own arrays, and resumes.

The encode shares the cross-cycle encode cache (``session=ssn``,
ops/encode_cache.py), and the replay runs the native hot loops
(native/_hotloops.cpp: ``bulk_res_axpy``, ``bulk_assign``,
``bulk_dispatch``, ``bulk_set_slot``, ``finish_columns``), each beside its
Python twin, behind the fault points ``native.load``, ``native.prepass``
and ``native.dispatch``.

Under tracing (obs) the action opens the ``encode`` span (``micro``,
``tasks``, ``nodes``, ``warm_fraction``), the ``solve`` span (``mesh``,
``tier``, a ``host_step`` event per pause;
``torch.profiler.record_function("kbt.solve")`` around it) and the
``gang.assign`` span (the replay and the dispatch, ``assigned``), the JAX
action's tree.

Streaming and pipelined cycles, as in the JAX action:

- a streaming micro-cycle's session (``ssn.micro_cycle``, scheduler.py
  ``run_micro``) encodes with the ``resident_interpod`` hint, the last
  full cycle's verdict on resident pod-affinity terms
  (``last_interpod_active``, kept from full cycles only; one that skips
  the encode, with nothing pending or routed to serial, sweeps the
  resident pods for it), so the encode skips the sweep over every
  resident pod; it solves on the same rungs;
- with ``KBT_PIPELINE`` on (pipeline.py) and outside micro-cycles, the
  post-solve phase (the replay, the gang barrier and the dispatch) is
  deferred onto the cache's kb-write pool (``pipeline.submit``) and its
  Future left on ``ssn.deferred_dispatch`` and armed on the dispatch
  fence. The dispatch barrier's budget check then runs on the scheduling
  thread before the submission, so an abort (``cycle.overrun``) still
  leaves the cache untouched. The closure reads only host arrays taken
  from the fetched ``SolveState`` on the scheduling thread and makes no
  CUDA call (the card is made current on the scheduling thread alone).

Forensics (obs/explain.py, ``KBT_EXPLAIN``): after the last segment the
action runs the batched explain pass (ops/explain.py) on the solve's
device, on the scheduling thread and before any deferred dispatch is
submitted: on the fused rung over kernel B1's packed statics and final
state buffers where they lie, on the sharded rung over an upload of the
explain subset and the five state fields. The records are built and
published in the post-solve phase after the dispatch barrier's check and
before the dispatch, under an ``explain`` span (``pass_s`` the pass,
with its fetch), so the journal's intents carry them and an aborted cycle
leaves none; ``last_timings["explain_s"]`` is the pass and the publish,
``explain_pass_s`` the pass with its fetch alone. A
micro-cycle's session holds only its dirty gangs, so it explains those.

Node-class compression (ops/class_solve.py, ``KBT_CLASS_COMPRESS``, off by
default): the class layer sits over the rungs, inside the solver-entry
budget gate, and solves each segment at class granularity with kernel B3
(``csrc/class_step.cu``), one launch a segment, the class table kept on
the action across cycles (``_class_table``) and the segment's stats in
``last_class_stats``; ``last_solver_tier`` reads ``class_fused`` or, with
a mesh, ``class_sharded``. The rungs' packs are built only when a
segment degrades to them: the ``solve.class_table`` fault point or a
host-side failure of the table, the re-pack or the expansion, each logged
and counted as ``degraded_cycles{tier="class_solve",reason="class_table"}``.
A kernel B3 that cannot be built raises ``KernelBuildError``, and B3
failing on a card raises ``DeviceSolveError``: neither is degraded.

The tensor arena (ops/encode_cache ``TensorArena``, on while the encode
cache is): the statics the device rungs read stay resident on the card
across cycles. The action keeps one arena per scheduler cache
(``arena_for``), since a cache's cycles run one at a time while
in-process shards share the action; the bank flips once per cycle
(``KBT_PIPELINE``). Through it go kernel B1's two static buffers
(``fused_istatic``; ``fused_fstatic``, row updated element by element
after a pod-affinity host step),
the sharded rung's static blocks (``sharded_*``, mesh placement) and the
class rung's task, job and queue tables (``class_*``);
``kube_batch_tpu_torch/RUNBOOK.md`` maps these names to the JAX
package's. ``last_timings`` carries the cycle's ``arena_reuses``,
``arena_row_updates``, ``arena_full_uploads``, ``arena_rows_uploaded``
and ``arena_failures``. A failed upload is logged, counted, clears the
arena and goes up as a fresh copy to the same device.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref

import numpy as np
import torch

from kube_batch_tpu_torch import faults, metrics, native, obs, pipeline
from kube_batch_tpu_torch import log as pkg_log
from kube_batch_tpu_torch.actions.envelope import kernel_supported
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.obs import explain as _explain
from kube_batch_tpu_torch.ops import class_solve, encode_cache
from kube_batch_tpu_torch.ops import explain as ops_explain
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.encode import compute_pod_sc, encode_session
from kube_batch_tpu_torch.ops.fused_solve import FusedSolver
from kube_batch_tpu_torch.ops.kernels import KIND_ALLOCATED, KIND_PIPELINED, SolveState
from kube_batch_tpu_torch.ops.nvcc import KernelBuildError
from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh
from kube_batch_tpu_torch.parallel.sharded_block import default_exchange_batch
from kube_batch_tpu_torch.plugins.nodeorder import (
    BALANCED_RESOURCE_WEIGHT,
    LEAST_REQUESTED_WEIGHT,
    NODE_AFFINITY_WEIGHT,
    POD_AFFINITY_WEIGHT,
)
from kube_batch_tpu_torch.plugins.predicates import PredicateError
from kube_batch_tpu_torch.solve import solver_inputs
from kube_batch_tpu_torch.utils import get_node_list, predicate_nodes, prioritize_nodes, select_best_node

log = logging.getLogger(__name__)

# Pending tasks x nodes below which the serial action is the faster
# allocator. On an NVIDIA H100 (chip_smoke.py's size_floor phase) a cycle
# on the fused rung takes about 4 ms at any small size, the serial one
# about as long at 100 pairs and twice as long at 400.
DEFAULT_MIN_DEVICE_PAIRS = 256
# a conf's plain `off` / `no` / `false` reaches the action as "False" (a
# YAML 1.1 boolean turned to text)
_MESH_OFF = ("", "off", "none", "0", "1", "false", "no")


class DeviceSolveError(RuntimeError):
    """The fused rung, the device floor, cannot take the cycle's snapshot
    (its solver cannot be built: past kernel B1's shared-memory limit, or
    a cluster the card cannot hold), or failed on a card. Raised out of
    ``execute``; never fed to a breaker."""


def _nonfinite_inputs(arrays: dict) -> list[str]:
    """Names of float solver inputs carrying NaN/Inf. One reduction per
    array (any non-finite value propagates through sum; a finite array
    overflowing the sum is an overflow worth flagging too) — cheap next
    to the solve, and the guard that turns a poisoned score tensor into
    a logged serial cycle instead of silently wrong placements."""
    bad = []
    for name, v in arrays.items():
        a = np.asarray(v)
        if a.dtype.kind == "f" and not np.isfinite(a.sum()):
            bad.append(name)
    return bad


def _nodeorder_weights(ssn: Session) -> tuple[float, float, float, float]:
    """(w_least, w_balanced, w_aff, w_podaff) from the tiers, matching the
    serial plugin's defaults (nodeorder.go:139-153); tensorscore takes the
    same arguments."""
    for tier in ssn.tiers:
        for option in tier.plugins:
            if option.name in ("nodeorder", "tensorscore") and option.enabled_node_order:
                args = Arguments(option.arguments)
                return (
                    args.get_int(LEAST_REQUESTED_WEIGHT, 1),
                    args.get_int(BALANCED_RESOURCE_WEIGHT, 1),
                    args.get_int(NODE_AFFINITY_WEIGHT, 1),
                    args.get_int(POD_AFFINITY_WEIGHT, 1),
                )
    return 0.0, 0.0, 0.0, 0.0


def _i32(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


class _FusedRungFailed(RuntimeError):
    """The fused rung, the device floor, failed to solve a segment: the
    cycle finishes on the serial allocate."""


class _Rungs:
    """The cycle's device rungs under the solver ladder: the sharded rung
    (kernel B4 at the cycle's K; its implementation in ``impl``) when a
    mesh is resolved and its breaker allows, else or
    after its failure the fused rung (kernel B1). Both speak ``SolveState``,
    so the fused rung resumes a failed sharded segment from the segment's
    own input state.

    - A sharded failure (organic or ``solve.sharded``) feeds the
      ``sharded`` breaker and drops the rung for the rest of the cycle.
      Both solver fault points fire after their rung ran the segment and
      discard its result, as an asynchronous CUDA error surfaces at the
      state fetch (the JAX action's fire before the call).
    - A fused failure (``solve.fused``, or organic on a ``device: cpu``
      rung) feeds the ``fused`` breaker and raises ``_FusedRungFailed``:
      execute() degrades the cycle to serial.
    - Not rung failures, and so never fed to a breaker, each of which would
      fail every cycle and route every cycle to the CPU for good: a
      kernel that cannot be built or loaded (``KernelBuildError``,
      re-raised), a snapshot the fused rung cannot take (the
      ``FusedSolver`` constructor: B1's shared-memory limit and the
      card's room for its cluster, ``DeviceSolveError``), and an organic
      failure of the fused rung on a card (``DeviceSolveError``): a
      refused launch repeats with the snapshot's geometry, and an
      asynchronous CUDA error leaves the card's context unusable, so
      the serial rung below would take the card's work for good.
    - The solver-entry budget gate runs outside the rungs' ``try``
      blocks, so a deadline abort never feeds a breaker either.

    The solver's own timings are summed over segments into ``split`` and,
    on the sharded rung, its counts into the action's ``last_counts``.

    With ``KBT_CLASS_COMPRESS`` on, ``solve`` runs the class-compressed
    layer (ops/class_solve ``wrap_solver``) over these rungs, which it
    degrades to (built then, their pack added to ``pack_s``) on the
    ``solve.class_table`` fault point or a host-side table failure only.
    Kernel B3 refusing its inputs or failing, and any other error of the
    layer on a card, raise ``DeviceSolveError`` as a fused failure on a
    card does."""

    def __init__(self, action, arrays, enable_drf, enable_proportion, device, mesh, args, arena=None) -> None:
        self.action = action
        self.arena = arena
        self.a = arrays_from_numpy(arrays)  # CPU tensors sharing the arrays' memory
        self.flags = (enable_drf, enable_proportion)
        self.device = device
        self.tier = "none"
        self.split: dict[str, float] = {}
        self.pack_s = 0.0  # a rung's pack when it is built after the rungs' own construction
        self.sharded = None
        self.impl = None  # the sharded rung's implementation, once it has solved a segment
        self.fused = None
        self.mesh = mesh
        self.exchange_batch = 1
        if mesh is not None:
            spec = args.get("exchange_batch", "").strip()
            if not spec:
                self.exchange_batch = default_exchange_batch()  # KBT_PIPELINE / KBT_EXCHANGE_BATCH
            else:
                try:
                    self.exchange_batch = int(spec)
                except ValueError:
                    raise ValueError(f"torch_allocate: exchange_batch={spec!r} is not an integer") from None
                if not 1 <= self.exchange_batch <= 64:
                    raise ValueError(f"torch_allocate: exchange_batch={spec!r} is outside 1..64")
        self.class_fn = None
        if class_solve.enabled():
            # the class-compressed layer over the rungs (ops/class_solve):
            # the rungs' packs are needed only as its degrade target, so
            # they are built at its first degrade
            self.class_fn = class_solve.wrap_solver(
                action, self._solve_rungs, arrays, enable_drf, enable_proportion, mesh=mesh, device=device,
                arena=arena,
            )
            self._built = False
        else:
            self._build()

    def _build(self) -> None:
        """The sharded rung when a mesh is resolved and its breaker allows,
        else the fused rung."""
        self._built = True
        mesh = self.mesh
        if mesh is not None and faults.solver_ladder.allow("sharded"):
            try:
                self.sharded = ShardedBlockSolver(
                    self.a, mesh, *self.flags, exchange_batch=self.exchange_batch, arena=self.arena,
                )
            except KernelBuildError:
                raise
            except Exception:
                log.exception(
                    "the sharded rung (kernel B4, K = %d) cannot take this snapshot on %d shards; using the fused rung",
                    self.exchange_batch, len(mesh),
                )
                faults.solver_ladder.record_failure("sharded")
        if self.sharded is None:
            self._make_fused()

    def _make_fused(self) -> None:
        try:
            self.fused = FusedSolver(self.a, *self.flags, device=self.device, arena=self.arena)
        except KernelBuildError:
            raise
        except Exception as e:
            raise DeviceSolveError(
                f"torch_allocate: the fused rung (kernel B1) cannot take this snapshot on {self.device}: "
                f"{type(e).__name__}: {e}"
            ) from e

    def _ran(self, solver, tier: str) -> None:
        self.tier = tier
        for key, v in solver.timings.items():
            self.split[key] = self.split.get(key, 0.0) + v
        counts = self.action.last_counts
        for key, v in getattr(solver, "counts", {}).items():
            counts[key] = counts.get(key, 0) + v

    def solve(self, state, budget) -> SolveState:
        """One solve segment behind the solver-entry budget gate, through
        the class-compressed layer when it is on."""
        if budget is not None:
            budget.check("solver entry")
        if self.class_fn is None:
            return self._solve_rungs(state)
        try:
            out = self.class_fn(state)
        except (KernelBuildError, DeviceSolveError, _FusedRungFailed):
            raise  # a build failure, or the rungs' own verdict after a degrade
        except Exception as e:
            if isinstance(e, class_solve.ClassKernelError) or self.device.type == "cuda":
                raise DeviceSolveError(
                    f"torch_allocate: the class-compressed solve (kernel B3) failed on {self.device}: "
                    f"{type(e).__name__}: {e}"
                ) from e
            raise
        stats = self.action.last_class_stats
        if stats is not None:  # None: this segment degraded to the rungs
            self.tier = self.action.last_solver_tier
            self.split["class_group_s"] = stats["group_s"]
            self.split["class_kernel_s"] = stats["kernel_s"]
            self.split["class_segments"] = stats["segments"]
        return out

    def _solve_rungs(self, state) -> SolveState:
        """One segment on the rungs: sharded, then fused."""
        if not self._built:
            t0 = time.perf_counter()
            self._build()
            self.pack_s += time.perf_counter() - t0
        ladder = faults.solver_ladder
        if self.sharded is not None:
            try:
                before = self.sharded.batched_iters
                out = self.sharded.solve(state)
                if faults.should_fire("solve.sharded"):
                    raise faults.FaultInjected("solve.sharded")
            except KernelBuildError:
                raise
            except Exception:
                log.exception("the sharded rung (%s) failed; the fused rung resumes the segment", self.sharded.impl)
                ladder.record_failure("sharded")
                self.sharded = None
                t0 = time.perf_counter()
                self._make_fused()
                self.pack_s += time.perf_counter() - t0
            else:
                ladder.record_success("sharded")
                self.impl = self.sharded.impl
                gained = self.sharded.batched_iters - before
                if gained:
                    self.action.last_batched_iters += gained
                    metrics.register_exchange_batched_iters(gained)
                self._ran(self.sharded, "sharded")
                return out
        try:
            # the state fetch, where an asynchronous CUDA error surfaces,
            # is inside solve()
            out = self.fused.solve(state)
            if faults.should_fire("solve.fused"):
                raise faults.FaultInjected("solve.fused")
        except KernelBuildError:
            raise
        except Exception as e:
            if self.device.type == "cuda" and not isinstance(e, faults.FaultInjected):
                # below the fused rung is the CPU: a card's error is not
                # degraded there (see the class docstring)
                raise DeviceSolveError(
                    f"torch_allocate: the fused rung (kernel B1) failed on {self.device}: {type(e).__name__}: {e}"
                ) from e
            log.exception("the fused rung (kernel B1) failed")
            ladder.record_failure("fused")
            raise _FusedRungFailed(f"{type(e).__name__}: {e}") from e
        ladder.record_success("fused")
        self._ran(self.fused, "fused")
        return out


class TorchAllocateAction(Action):
    """The card's allocate. Routes to serial out of envelope or below the
    size floor, and degrades to serial only through the solver ladder."""

    def __init__(self) -> None:
        # Wall-clock split of the last execute(): encode_s, warm_fraction
        # (the encode's share of cache units served warm), pack_s, solve_s
        # (every segment and host step) with the solver's own split summed
        # over segments, host_step_s, host_steps, replay_s; or, when the
        # cycle was routed to serial, serial_routed_s / serial_degraded_s
        # and serial_reason.
        self.last_timings: dict[str, float | int | str] = {}
        # Shards of the mesh the last execute() resolved (1: fused rung),
        # and the fused rung's device (None: the cycle did not resolve one).
        self.last_mesh_size = 1
        self.last_device: torch.device | None = None
        # Which rung solved the last execute(): "fused", "sharded",
        # "serial", or "none" (nothing to solve).
        self.last_solver_tier = "none"
        # The final SolveState (CPU tensors) of the last device solve, and
        # the encoded snapshot it solved (rows, node order, capacities).
        self.last_state: SolveState | None = None
        self.last_encoded = None
        # Gang iterations committed from K-deep batched exchanges.
        self.last_batched_iters = 0
        # The sharded rung's counts summed over the last execute()'s solve
        # segments: iterations, placing_iterations, launches (kernel B2).
        self.last_counts: dict[str, int] = {}
        # Whether the last FULL-cycle encode saw any pod-affinity terms
        # (pending or resident). Streaming micro-cycles pass this as the
        # resident_interpod hint so the encode skips the sweep over every
        # node's resident pods (see encode_session).
        self.last_interpod_active = False
        # Stats of the last class-compressed solve segment (ops/class_solve,
        # KBT_CLASS_COMPRESS): class_count, compression_ratio, splits,
        # remerges, rekeys, segments, c_pad, group_s / kernel_s, rung, and
        # kernel B3's launches and device time (kernel_ms). None when the
        # compression was off or the segment degraded to the rungs. The
        # class table itself persists across cycles as ``_class_table``.
        self.last_class_stats = None
        # The tensor arenas, one per scheduler cache (weakly keyed: a
        # cache's arena goes with it), and the last execute()'s arena.
        self._arenas: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  #: guarded_by _arenas_lock
        self._arenas_lock = threading.Lock()
        self._arena: encode_cache.TensorArena | None = None

    @property
    def name(self) -> str:
        return "torch_allocate"

    # -- main ----------------------------------------------------------------

    def execute(self, ssn: Session) -> None:
        self.last_timings = {}
        self.last_solver_tier = "none"
        self.last_state = None
        self.last_encoded = None
        self.last_mesh_size = 1
        self.last_device = None
        self.last_batched_iters = 0
        self.last_counts = {}
        self.last_class_stats = None
        if not kernel_supported(ssn):
            log.info("conf outside the solve's envelope; running serial allocate")
            self._route_serial(ssn, "serial_routed_s", "envelope")
            return

        args = ssn.action_arguments.get(self.name, {})
        device, mesh = self._resolve(args)
        self.last_device = device

        # Size floor: a device solve costs a fixed round trip regardless of
        # payload, while the serial loop clears tiny snapshots in
        # microseconds per pair. A mesh request is a statement of device
        # intent and skips the floor.
        if mesh is None and not self._mesh_requested(args):
            pend = sum(
                len(j.task_status_index.get(TaskStatus.PENDING, {}))
                for j in ssn.jobs.values()
            )
            if not pend:
                # Nothing to allocate, the steady state of a server's loop:
                # the serial action would only pop every job (its queue
                # order costs jobs² comparisons, about 15 s over 4,500 jobs)
                # and bind nothing.
                self.last_timings = {"pending": 0}
                self._note_resident_interpod(ssn)
                return
            if pend * max(len(ssn.nodes), 1) < self._min_device_pairs(args):
                log.debug(
                    "snapshot below the device size floor (%d pending x %d nodes); "
                    "running serial allocate", pend, len(ssn.nodes),
                )
                self._route_serial(ssn, "serial_routed_s", "size_floor")
                return

        # Degradation ladder (faults.solver_ladder): the fused rung is the
        # device floor, the rung every other falls back onto, so with its
        # breaker open the whole device path sits the cycle out and serial,
        # the correctness oracle, runs. The breaker recovers through
        # half-open probes.
        ladder = faults.solver_ladder
        if not ladder.allow("fused"):
            log.warning("fused-rung breaker open; running serial allocate for this cycle")
            metrics.register_degraded_cycle("serial", "breaker_open")
            self._route_serial(ssn, "serial_degraded_s", "breaker_open")
            return

        order = [o.name for t in ssn.tiers for o in t.plugins]
        enable_drf = "drf" in order
        enable_proportion = "proportion" in order

        micro = bool(getattr(ssn, "micro_cycle", False))
        t0 = time.perf_counter()
        with obs.span("encode", micro=micro) as espan:
            enc = encode_session(
                ssn.jobs,
                ssn.nodes,
                ssn.queues,
                drf=ssn.plugins.get("drf") if enable_drf else None,
                proportion=ssn.plugins.get("proportion") if enable_proportion else None,
                session=ssn,
                resident_interpod=self.last_interpod_active if micro else None,
            )
            if not micro:
                self.last_interpod_active = bool(enc.interpod_active)
            espan.set_attr("tasks", len(enc.tasks))
            espan.set_attr("nodes", len(ssn.nodes))
            espan.set_attr("warm_fraction", enc.warm_fraction)
        t_encode = time.perf_counter() - t0
        if not enc.tasks:
            self.last_timings = {"encode_s": t_encode, "warm_fraction": enc.warm_fraction}
            return

        arrays = solver_inputs(enc, _nodeorder_weights(ssn))
        # Fault point solve.nan: a poisoned score weight, the failure the
        # finite guard below exists to catch.
        if faults.should_fire("solve.nan"):
            arrays["w_least"] = np.float32(np.nan)
        bad = _nonfinite_inputs(arrays)
        if bad:
            log.error(
                "non-finite solver inputs (%s); running serial allocate for this cycle",
                ", ".join(bad),
            )
            metrics.register_degraded_cycle("serial", "nonfinite")
            self._route_serial(ssn, "serial_degraded_s", "nonfinite: " + ", ".join(bad))
            return

        replay = _Replayer(ssn, enc, arrays, enable_drf, enable_proportion)
        budget = ssn.cycle_budget
        timings: dict = {"encode_s": t_encode, "warm_fraction": enc.warm_fraction}
        arena = self._arena = self.arena_for(ssn.cache, device) if encode_cache.enabled() else None
        if arena is not None:
            arena._flip_bank()  # once a cycle (pipelined mode: the other bank)
            arena_before = arena.counters()
        t0 = time.perf_counter()
        rungs = _Rungs(self, arrays, enable_drf, enable_proportion, device, mesh, args, arena)
        timings["pack_s"] = time.perf_counter() - t0

        host_steps, t_host = 0, 0.0
        t0 = time.perf_counter()
        try:
            with obs.span("solve", mesh=self.last_mesh_size) as sspan, obs.annotate("kbt.solve"):
                state = rungs.solve(None, budget)
                while int(state.paused_at) >= 0:
                    if budget is not None:
                        budget.check("between solve segments")
                    th = time.perf_counter()
                    sspan.event("host_step", step=int(state.step))
                    # Segmented hybrid: sync the session up to the pause
                    # point, step the host-only task serially, resume.
                    s = SolveState(*(x.clone() for x in state))  # writable host copy
                    replay.apply_upto(
                        s.assign_pos.numpy(), s.assigned_node.numpy(), s.assigned_kind.numpy(), int(s.step)
                    )
                    s = self._host_step(ssn, enc, arrays, replay, s)
                    host_steps += 1
                    if enc.interpod_active:
                        # the stepped pod carries pod-affinity terms; once
                        # resident it shifts every group's InterPodAffinity
                        # score. The solvers re-fold their affinity static
                        # when the dict they hold gets a new pod_sc object.
                        pod_sc = compute_pod_sc(
                            enc.task_reps, ssn.nodes, enc.node_names, arrays["pod_sc"].shape[1], np.float32,
                        )
                        arrays["pod_sc"] = pod_sc
                        rungs.a["pod_sc"] = torch.from_numpy(pod_sc)
                    t_host += time.perf_counter() - th
                    state = rungs.solve(s, budget)
                sspan.set_attr("tier", rungs.tier)
        except _FusedRungFailed as e:
            # Bottom of the device ladder: serial finishes the cycle. Host-
            # step segments already replayed stand; serial allocate goes on
            # over the remaining pending tasks.
            log.error("device solve failed (%s); degrading to serial allocate", e)
            metrics.register_degraded_cycle("serial", "solve_failed")
            self._route_serial(ssn, "serial_degraded_s", "solve_failed")
            return
        timings["pack_s"] += rungs.pack_s
        if rungs.impl is not None:
            timings["sharded_impl"] = rungs.impl  # mesh_kernel (B4) or host_loop (B2)
            timings["exchange_batch"] = rungs.exchange_batch  # K of the batched exchange
        timings.update(solve_s=time.perf_counter() - t0, **rungs.split, host_step_s=t_host, host_steps=host_steps)
        if arena is not None:
            arena._account_hbm()
            timings.update({f"arena_{k}": v - arena_before[k] for k, v in arena.counters().items()})
        self.last_solver_tier = rungs.tier
        self.last_state = state
        self.last_encoded = enc
        self.last_timings = timings

        # Pipelined cycles (pipeline.py, KBT_PIPELINE): the post-solve
        # phase (replay, gang barrier, dispatch) is host and cache work
        # that needs nothing more from the card, so it can ride the
        # cache's kb-write pool while the next cycle encodes and solves.
        # The fence keeps the ordering the synchronous path gets for free
        # (dispatch N < snapshot N+1), close_session joins before the
        # commit write-back, and micro-cycles never defer (their outcome
        # accounting reads the session synchronously).
        defer = pipeline.enabled() and not micro
        if defer and budget is not None:
            # The last pre-dispatch gate stays on the scheduling thread, so
            # a deadline abort (and the cycle.overrun drill's inject=True)
            # still unwinds through run_once's discard path with no cache
            # mutation.
            budget.check("dispatch barrier", inject=True)
        # Host arrays, taken here on the scheduling thread: the fetched
        # SolveState lies on the CPU, so the closure below makes no CUDA
        # call.
        assign_pos = state.assign_pos.numpy()
        assigned_node = state.assigned_node.numpy()
        assigned_kind = state.assigned_kind.numpy()
        n_assigned = int(state.step)
        ready_cnt = state.ready_cnt.numpy()

        # Post-solve forensics (obs/explain): the batched pass and its
        # fetch run here, on the scheduling thread and the solve's device;
        # the records are published in _post_solve after the dispatch
        # barrier, before the dispatch, so the journal's intents carry them
        # and an aborted cycle leaves none.
        fx = None
        t_pass = 0.0
        if _explain.enabled():
            te = time.perf_counter()
            if rungs.tier == "fused":
                inputs = ops_explain.fused_inputs(rungs.fused, arrays)
            else:
                inputs = ops_explain.uploaded_inputs(arrays, state, device)
            fx = _explain.forensics(enc, arrays, state, inputs)
            t_pass = time.perf_counter() - te

        def _post_solve(parent=None) -> None:
            t0 = time.perf_counter()
            t_publish = 0.0
            with obs.span("gang.assign", parent=parent, assigned=n_assigned):
                replay.apply_upto(assign_pos, assigned_node, assigned_kind, n_assigned)
                if not defer and budget is not None:
                    # The last pre-dispatch gate: past this point binds
                    # reach the cache and the cycle can no longer abort
                    # cleanly. The cycle.overrun drill injects here
                    # (inject=True): the most discardable work, no cache
                    # mutation.
                    budget.check("dispatch barrier", inject=True)
                if fx is not None:
                    tp = time.perf_counter()
                    with obs.span("explain", micro=micro, pass_s=t_pass) as xsp:
                        recs = _explain.post_solve_records(ssn, enc, arrays, ready_cnt, fx)
                        _explain.publish(ssn, recs)
                        for k, v in _explain.summary(recs).items():
                            xsp.set_attr(k, v)
                    t_publish = time.perf_counter() - tp
                replay.finish(ready_cnt)
            timings["replay_s"] = time.perf_counter() - t0 - t_publish
            if fx is not None:
                timings["explain_s"] = t_pass + t_publish
                timings["explain_pass_s"] = t_pass

        if defer:
            ctx = obs.current()  # pool threads do not inherit the contextvar

            def _deferred() -> None:
                # stamp the dispatch window for the measured overlap
                # fraction: [d0, d1] against the consumer's join window
                d0 = time.perf_counter()
                _post_solve(parent=ctx)
                pipeline.fence.record_dispatch_window(d0, time.perf_counter())

            fut = pipeline.submit(ssn.cache, _deferred)
            ssn.deferred_dispatch = fut
            pipeline.fence.arm(fut)
        else:
            _post_solve()

    # -- routing and resolution ---------------------------------------------

    def arena_for(self, cache, device) -> encode_cache.TensorArena:
        """The tensor arena of ``cache``'s cycles (made at its first
        cycle, on ``device``). One per cache: in-process shards share this
        action, and a shard's uploads must never write a buffer another
        shard's solve reads. A cache whose cycles move to another device
        gets a new arena."""
        with self._arenas_lock:
            arena = self._arenas.get(cache)
            if arena is None or arena.device != encode_cache._indexed(device):
                arena = self._arenas[cache] = encode_cache.TensorArena(device)
            return arena

    def _note_resident_interpod(self, ssn: Session) -> None:
        """A full cycle that does not encode still renews the
        resident-interpod hint the next micro-cycles read (a sweep of the
        resident pods; the encode's own sweep otherwise), so the hint
        never outlives the resident world it describes."""
        if not getattr(ssn, "micro_cycle", False):
            self.last_interpod_active = any(
                rt.pod.affinity is not None and rt.pod.affinity.has_pod_affinity_terms()
                for n in ssn.nodes.values()
                for rt in n.tasks.values()
            )

    def _route_serial(self, ssn: Session, key: str, reason: str) -> None:
        from kube_batch_tpu_torch.actions.allocate import AllocateAction

        self._note_resident_interpod(ssn)
        self.last_solver_tier = "serial"
        t0 = time.perf_counter()
        AllocateAction().execute(ssn)
        self.last_timings = {key: time.perf_counter() - t0, "serial_reason": reason}

    def _mesh_requested(self, args: dict) -> bool:
        """True when the conf names a mesh at all: the operator asked for
        the sharded device path, so the size floor must not reroute it."""
        return args.get("mesh", "").strip().lower() not in _MESH_OFF

    def _min_device_pairs(self, args: dict) -> int:
        """(pending tasks x nodes) below which the serial action is the
        faster allocator; 0 forces the device path (how the parity tests
        pin the kernels under test)."""
        spec = args.get("min_device_pairs", "").strip()
        if not spec:
            return DEFAULT_MIN_DEVICE_PAIRS
        try:
            return int(spec)
        except ValueError:
            raise ValueError(f"torch_allocate: min_device_pairs={spec!r} is not an integer") from None

    def _resolve(self, args: dict) -> tuple[torch.device, tuple | None]:
        """The solve's device and mesh (None: the fused rung). A ``mesh``
        value the JAX package reads as single-chip (a backend other than
        cpu and cuda, a count that is not an integer or is below 1) logs
        a warning and resolves no mesh: a bad conf value must not kill the
        scheduling loop. Raises ValueError on a bad ``device`` or a device
        of another type than the mesh's backend, and RuntimeError when
        the device or the mesh is a card and none is visible: no fallback
        may hide the card."""
        mesh_spec = args.get("mesh", "").strip().lower()
        dev_spec = args.get("device", "").strip().lower()
        backend = None
        count_spec = mesh_spec
        if mesh_spec not in _MESH_OFF and ":" in mesh_spec:
            backend, count_spec = mesh_spec.split(":", 1)
        try:
            device = torch.device(dev_spec or (backend if backend in ("cpu", "cuda") else None) or "cuda")
        except RuntimeError as e:
            raise ValueError(f"torch_allocate: device={dev_spec!r}: {e}") from None
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"torch_allocate: device {device} is not cpu or cuda")
        if backend in ("cpu", "cuda") and device.type != backend:
            raise ValueError(f"torch_allocate: device {device} but mesh backend {backend}")
        if device.type == "cuda":
            if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
                raise RuntimeError(
                    f"torch_allocate: device {device} requested but no CUDA device is visible; "
                    "set actionArguments.torch_allocate.device: cpu to run the kernels' plain versions"
                )
            if device.index is not None and device.index >= torch.cuda.device_count():
                raise RuntimeError(f"torch_allocate: {device} is not a visible CUDA device")
        if mesh_spec in _MESH_OFF:
            return device, None
        if backend is not None and backend not in ("cpu", "cuda"):
            log.warning("mesh backend %r is not cpu or cuda; running single-chip on %s", backend, device)
            return device, None

        visible = (
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if device.type == "cuda" else [torch.device("cpu")]
        )
        if count_spec == "auto":
            want = len(visible)
        else:
            try:
                want = int(count_spec)
            except ValueError:
                log.warning("unrecognized mesh spec %r; running single-chip on %s", mesh_spec, device)
                return device, None
        if want < 1:
            log.warning("mesh=%s is not a device count; running single-chip on %s", mesh_spec, device)
            return device, None
        # auto / an integer take that many visible devices; backend:count
        # takes count shards round-robin over them
        n = want if backend is not None else min(want, len(visible))
        n = min(1 << (n.bit_length() - 1), 128)  # largest pow2 <= n, as in the JAX package
        if n != want:
            log.warning("mesh=%s clamped to %d shards (a power of two, available)", mesh_spec, n)
        if n <= 1:
            return device, None
        self.last_mesh_size = n
        return device, make_mesh(devices=[visible[k % len(visible)] for k in range(n)])

    # -- host-side serial step for one host-only task -------------------------

    def _host_step(self, ssn: Session, enc, arrays, replay: "_Replayer", s: SolveState) -> SolveState:
        """Exactly the serial inner-loop body (actions/allocate.py /
        reference allocate.go:139-185) for the paused task, then patch the
        solver state (CPU tensors, patched in place, every field keeping
        its dtype and shape): pointer, node vectors, job lifecycle."""
        row = int(s.paused_at)
        task = enc.tasks[row]
        job = ssn.jobs[task.job]
        jrow = int(s.cur)
        all_nodes = get_node_list(ssn.nodes)

        def predicate_fn(t, node):
            if not t.init_resreq.less_equal(node.idle) and not t.init_resreq.less_equal(
                node.releasing
            ):
                raise PredicateError(
                    f"task <{t.namespace}/{t.name}> ResourceFit failed "
                    f"on node <{node.name}>"
                )
            ssn.predicate_fn(t, node)

        if job.nodes_fit_delta:
            job.nodes_fit_delta = {}

        s.ptr[jrow] += 1
        candidates = predicate_nodes(task, all_nodes, predicate_fn)
        if not candidates:
            # serial `break`: the job leaves the heap unassigned.
            log.debug("host step: no candidates for %s; abandoning job", task.uid)
            s.job_active[jrow] = False
            return s._replace(cur=_i32(-1), it=_i32(int(s.it) + 1))

        node_scores = prioritize_nodes(
            task, candidates, ssn.node_order_map_fn, ssn.node_order_reduce_fn
        )
        node = select_best_node(node_scores)
        nrow = replay.node_idx[node.name]

        if task.init_resreq.less_equal(node.idle):
            kind = KIND_ALLOCATED
        else:
            delta = node.idle.clone()
            delta.fit_delta(task.init_resreq)
            job.nodes_fit_delta[node.name] = delta
            kind = KIND_PIPELINED if task.init_resreq.less_equal(node.releasing) else 0

        cur = jrow
        if kind:
            try:
                replay.apply_immediate(row, nrow, kind, int(s.step))
            except Exception as e:  # noqa: BLE001
                # Volume assume failed (the first mutation apply_one makes,
                # so session state is untouched): serial semantics — the
                # task is consumed unassigned and the loop moves on
                # (allocate.go:158-161 logs and continues).
                log.error("host step: failed to allocate task %s on %s: %s", task.uid, node.name, e)
                return s._replace(cur=_i32(cur), it=_i32(int(s.it) + 1))
            res = torch.from_numpy(np.asarray(arrays["task_res"][row], np.float32))
            s.used[nrow] += res
            if kind == KIND_ALLOCATED:
                s.idle[nrow] -= res
                s.ready_cnt[jrow] += 1
            else:
                s.rel[nrow] -= res
            s.ntasks[nrow] += 1
            s.nports[nrow] |= torch.from_numpy(np.asarray(arrays["task_ports"][row], bool))
            s.assigned_node[row] = nrow
            s.assigned_kind[row] = kind
            s.assign_pos[row] = int(s.step)
            if replay.drf is not None:
                s.job_alloc[jrow] += res
            qrow = int(arrays["job_queue"][jrow])
            if replay.prop is not None:
                s.q_alloc[qrow] += res
                if arrays["task_res_has_sc"][row]:
                    s.q_alloc_has_sc[qrow] = True
            s = s._replace(step=_i32(int(s.step) + 1))
            if int(s.ready_cnt[jrow]) >= int(arrays["job_min"][jrow]):
                cur = -1
        return s._replace(cur=_i32(cur), it=_i32(int(s.it) + 1))


class _Replayer:
    """Applies solve assignments to the session in bulk — the exact net
    state mutations of `ssn.allocate`/`ssn.pipeline` (session.go:198-296)
    without per-task Python session machinery:

    - task status index surgery + `job.allocated` growth (job_info.go:233-259);
    - node task map + idle/releasing/used accounting aggregated per node
      (node_info.go:108-136) — exact because milli-CPU/byte quantities are
      integers, so float addition order cannot change the sums; scalar-map
      key presence follows the same add/sub rules as the sequential path;
    - drf/proportion allocated vectors advanced per event in solve order
      with one final share recompute (the intermediate shares the serial
      event handlers maintain are never read between events);
    - the gang dispatch barrier at `finish`: jobs whose final ready count
      clears min_available get every Allocated task dispatched —
      BindVolumes + cache.Bind + Binding status, exactly the set the
      serial flip-time dispatches produce (session.go:285-322).
    """

    def __init__(self, ssn: Session, enc, arrays, enable_drf: bool, enable_prop: bool) -> None:
        self.ssn = ssn
        self.enc = enc
        self.arrays = arrays
        self.task_res64 = np.asarray(arrays["task_res"], np.float64)
        self.task_job = np.asarray(arrays["task_job"])
        self.task_res_has_sc = np.asarray(arrays["task_res_has_sc"])
        self.job_queue = np.asarray(arrays["job_queue"])
        self.drf = ssn.plugins.get("drf") if enable_drf else None
        self.prop = ssn.plugins.get("proportion") if enable_prop else None
        # Native extension boundary: the 'native.load' fault point
        # simulates the extension failing to load for this replay — every
        # native fast path below runs its Python twin at once.
        self._native = native.get()
        if self._native is not None and faults.should_fire("native.load"):
            native.note_fallback("load", faults.FaultInjected("native.load"))
            self._native = None
        self.node_idx = {name: i for i, name in enumerate(enc.node_names)}
        # Row-indexed hot lookups for the bulk loop. row_of is lazy: the
        # numeric dispatch-column path never needs it.
        self.task_keys = [f"{t.namespace}/{t.name}" for t in enc.tasks]
        self._row_of: dict | None = None
        self.node_by_row = [ssn.nodes[name] for name in enc.node_names]
        self.node_tasks_by_row = [n.tasks for n in self.node_by_row]
        self.replayed = 0  # assignment events already applied
        self.alloc_jobs: set[str] = set()  # jobs with >=1 Allocated event
        # vectorized twin of alloc_jobs (job-row indexed) + the bulk
        # replay's per-segment Allocated event log — what the dispatch
        # barrier's mask and numeric bind columns are built from
        self._alloc_flags = np.zeros(len(enc.jobs), bool)
        self._bulk_alloc_log: list[tuple] = []  # (rows, nrows, jrows) per segment
        # jobs that took a host-stepped (apply_immediate) event: their
        # allocated tasks may carry volume claims, so finish() keeps the
        # per-task volume checks for them
        self.stepped_jobs: set[str] = set()
        # per-node aggregation buffers (flushed once per host step)
        self._node_buf: dict[int, _NodeDelta] = {}
        self._touched_drf: set[str] = set()
        self._touched_prop: set[str] = set()
        # wall time each task's assignment came off the device (its solve
        # segment's completion): the per-task schedule timestamp of the
        # bulk path (reference metrics.go:66-72 stamps at dispatch)
        self.decided_at = np.zeros(len(enc.tasks))

    @property
    def row_of(self) -> dict:
        if self._row_of is None:
            self._row_of = {t.uid: r for r, t in enumerate(self.enc.tasks)}
        return self._row_of

    def _native_try(self, fn: str, *args, fault: str | None = None):
        """``self._native.<fn>(*args)`` behind the fault point ``fault``;
        None when it raised the pre-mutation errors (ValueError, TypeError,
        AttributeError) every native entry point raises before touching
        anything — counted, and the caller runs its Python twin."""
        try:
            if fault is not None and faults.should_fire(fault):
                raise faults.FaultInjected(fault)
            out = getattr(self._native, fn)(*args)
        except (faults.FaultInjected, ValueError, TypeError, AttributeError) as e:
            native.note_fallback(fn, e)
            return None
        native.note_call(fn)
        return True if out is None else out

    # -- one event -----------------------------------------------------------

    def apply_one(self, row: int, nrow: int, kind: int) -> None:
        ssn = self.ssn
        task = self.enc.tasks[row]
        job = ssn.jobs[task.job]
        hostname = self.enc.node_names[nrow]
        status = TaskStatus.ALLOCATED if kind == KIND_ALLOCATED else TaskStatus.PIPELINED

        if kind == KIND_ALLOCATED:
            ssn.cache.allocate_volumes(task, hostname)
            self.alloc_jobs.add(job.uid)
            self._alloc_flags[self.task_job[row]] = True
        self.stepped_jobs.add(job.uid)

        # status index surgery == update_task_status's net effect
        pend = job.task_status_index.get(TaskStatus.PENDING)
        if pend is not None:
            pend.pop(task.uid, None)
            if not pend:
                del job.task_status_index[TaskStatus.PENDING]
        task.status = status
        task.node_name = hostname
        job.task_status_index.setdefault(status, {})[task.uid] = task
        if kind == KIND_ALLOCATED:
            job.allocated.add(task.resreq)

        # node: task map entry (a clone, node_info.go:117) + deferred sums
        node = ssn.nodes[hostname]
        node.tasks[self.task_keys[row]] = task.clone_for_residency()
        buf = self._node_buf.get(nrow)
        if buf is None:
            buf = self._node_buf[nrow] = _NodeDelta()
        res64 = self.task_res64[row]
        if kind == KIND_ALLOCATED:
            buf.alloc += res64
        else:
            buf.pipe += res64
        if task.resreq.scalars:
            buf.scalar_keys.update(task.resreq.scalars)

        # drf / proportion event handlers (drf.go:135-154, proportion.go:202-223)
        if self.drf is not None:
            self.drf.job_attrs[job.uid].allocated.add(task.resreq)
            self._touched_drf.add(job.uid)
        if self.prop is not None:
            self.prop.queue_attrs[job.queue].allocated.add(task.resreq)
            self._touched_prop.add(job.queue)

    # -- a segment -----------------------------------------------------------

    def apply_immediate(self, row: int, nrow: int, kind: int, pos: int) -> None:
        """One host-stepped event, applied and flushed right away (the next
        host step's predicates need the node state current)."""
        self.apply_one(row, nrow, kind)
        self.decided_at[row] = time.time()
        self.replayed = pos + 1
        self._flush_nodes()
        # Invalidate state_seq-keyed score memos (nodeorder): the replay
        # mutates node accounting without going through ssn.allocate /
        # pipeline, which are what normally bump the seq.
        self.ssn.bump_state()

    def apply_upto(self, assign_pos, assigned_node, assigned_kind, step: int) -> None:
        """Apply all events with replayed <= pos < step — the same net
        state mutations as per-event `apply_one`, but with every
        order-independent aggregate (node idle/releasing/used, job
        allocated, drf/proportion vectors) computed as a vectorized
        segment sum. Exact: all quantities are integer-grid float64, so
        addition order cannot change the sums, and scalar-map key
        creation follows the same per-event add/sub rules via the
        tracked key sets."""
        if step <= self.replayed:
            return
        sel = (assign_pos >= self.replayed) & (assign_pos < step)
        rows = np.nonzero(sel)[0]
        self.replayed = step
        if rows.size == 0:
            return
        self.decided_at[rows] = time.time()  # this segment's solve completion
        # Same memo invalidation as apply_immediate: bulk replay mutates
        # node.used/tasks behind the session's back.
        self.ssn.bump_state()
        rows = rows[np.argsort(assign_pos[rows], kind="stable")]
        nrows = assigned_node[rows]
        kinds = assigned_kind[rows]
        alloc = kinds == KIND_ALLOCATED
        res = self.task_res64[rows]
        tjob = self.task_job[rows]
        scalar_names = self.enc.scalar_names
        R = res.shape[1]
        empty: frozenset = frozenset()

        # -- scalar-key bookkeeping (only rows whose resreq has scalars) --
        nkeys_alloc: dict[int, set] = {}
        nkeys_pipe: dict[int, set] = {}
        jkeys_alloc: dict[int, set] = {}
        jkeys_all: dict[int, set] = {}
        qkeys: dict[int, set] = {}
        for i in np.nonzero(self.task_res_has_sc[rows])[0].tolist():
            keys = self.enc.tasks[int(rows[i])].resreq.scalars.keys()
            n_i, j_i = int(nrows[i]), int(tjob[i])
            (nkeys_alloc if alloc[i] else nkeys_pipe).setdefault(n_i, set()).update(keys)
            if alloc[i]:
                jkeys_alloc.setdefault(j_i, set()).update(keys)
            jkeys_all.setdefault(j_i, set()).update(keys)
            qkeys.setdefault(int(self.job_queue[j_i]), set()).update(keys)

        # -- node accounting (node_info.go:108-136 net effect) ------------
        touched_n = np.unique(nrows)
        compn = np.searchsorted(touched_n, nrows)
        n_alloc_vec = _segment_sum(compn[alloc], res[alloc], touched_n.size, R)
        n_pipe_vec = _segment_sum(compn[~alloc], res[~alloc], touched_n.size, R)
        # The dense cpu/mem columns update natively in one pass per pool
        # (identical float64 adds, without the interpreter round trips);
        # scalar dimensions keep the Go nil-map semantics on the Python
        # side and only run for the pools whose key sets are non-empty.

        def axpy(objs, mat, sign) -> None:
            # Per-pool fallback: the native prepass guarantees failures
            # are pre-mutation, so a variant Resource pool runs the Python
            # twin without double-applying sibling pools.
            if self._native is None or not self._native_try("bulk_res_axpy", objs, mat, sign):
                _axpy(objs, mat, sign)

        nodes_t = [self.node_by_row[nrow] for nrow in touched_n.tolist()]
        axpy([n.idle for n in nodes_t], n_alloc_vec, -1)
        axpy([n.releasing for n in nodes_t], n_pipe_vec, -1)
        axpy([n.used for n in nodes_t], n_alloc_vec + n_pipe_vec, 1)
        for nrow in set(nkeys_alloc) | set(nkeys_pipe):
            k = int(np.searchsorted(touched_n, nrow))
            node = self.node_by_row[nrow]
            ka = nkeys_alloc.get(nrow, empty)
            kp = nkeys_pipe.get(nrow, empty)
            _res_scalars(node.idle, n_alloc_vec[k], scalar_names, ka, -1, nil_map=True)
            _res_scalars(node.releasing, n_pipe_vec[k], scalar_names, kp, -1, nil_map=True)
            _res_scalars(
                node.used, n_alloc_vec[k] + n_pipe_vec[k], scalar_names, ka | kp, 1
            )

        # -- job.allocated + drf/proportion event bookkeeping -------------
        touched_j = np.unique(tjob)
        compj = np.searchsorted(touched_j, tjob)
        j_tot = _segment_sum(compj, res, touched_j.size, R)
        j_alloc = _segment_sum(compj[alloc], res[alloc], touched_j.size, R)
        wa = np.unique(tjob[alloc])
        self._alloc_flags[wa] = True
        drf = self.drf
        jobs_t = [self.enc.jobs[jrow] for jrow in touched_j.tolist()]
        wa_pos = np.searchsorted(touched_j, wa)
        jobs_wa = [jobs_t[p] for p in wa_pos.tolist()]
        axpy([j.allocated for j in jobs_wa], j_alloc[wa_pos], 1)
        self.alloc_jobs.update(j.uid for j in jobs_wa)
        if drf is not None:
            axpy([drf.job_attrs[j.uid].allocated for j in jobs_t], j_tot, 1)
            self._touched_drf.update(j.uid for j in jobs_t)
        for jrow in jkeys_alloc:
            k = int(np.searchsorted(touched_j, jrow))
            _res_scalars(
                jobs_t[k].allocated, j_alloc[k], scalar_names,
                jkeys_alloc[jrow], 1,
            )
        if drf is not None:
            for jrow in jkeys_all:
                k = int(np.searchsorted(touched_j, jrow))
                _res_scalars(
                    drf.job_attrs[jobs_t[k].uid].allocated, j_tot[k],
                    scalar_names, jkeys_all[jrow], 1,
                )
        prop = self.prop
        if prop is not None:
            qrow_arr = self.job_queue[tjob]
            touched_q = np.unique(qrow_arr)
            compq = np.searchsorted(touched_q, qrow_arr)
            q_tot = _segment_sum(compq, res, touched_q.size, R)
            attrs_q = [
                prop.queue_attrs[self.enc.queues[qrow].name]
                for qrow in touched_q.tolist()
            ]
            axpy([a.allocated for a in attrs_q], q_tot, 1)
            self._touched_prop.update(a.name for a in attrs_q)
            for qrow in qkeys:
                k = int(np.searchsorted(touched_q, qrow))
                _res_scalars(
                    attrs_q[k].allocated, q_tot[k], scalar_names, qkeys[qrow], 1
                )

        # -- per-task surgery (status index, node task map, volumes) ------
        # Rows grouped per job (stable sort preserves assign order within
        # a job, which is what fixes the status index's insertion order
        # and therefore dispatch/bind order); the status-index moves then
        # land as one dict.update per (job, status). The per-event body —
        # status flip, node_name set, residency clone, node task-map
        # insert — runs in the native bulk_assign, with the Python loop as
        # its twin.
        jobs_l = self.enc.jobs
        order = np.argsort(compj, kind="stable")
        counts = np.bincount(compj, minlength=touched_j.size).tolist()
        rows_a = np.ascontiguousarray(rows[order], np.int64)
        nrows_a = np.ascontiguousarray(nrows[order], np.int64)
        alloc_a = alloc[order]
        # this segment's Allocated events (job-major, assign order within
        # a job: the status-index insertion order), for the dispatch
        # barrier's numeric bind columns
        self._bulk_alloc_log.append((rows_a[alloc_a], nrows_a[alloc_a], tjob[order][alloc_a]))
        segments = None
        if self._native is not None:
            # index vectors go down as int64 buffers; trusted: the port's
            # encoder routes volume-carrying tasks host_only, so bulk rows
            # are volume-free by construction and the prepass skips its
            # per-event pod.volumes read ("task_created" marks that
            # encoder; any other EncodedSnapshot keeps the guard)
            segments = self._native_try(
                "bulk_assign", self.enc.tasks, self.task_keys, self.node_tasks_by_row,
                self.enc.node_names, rows_a, nrows_a, alloc_a.astype(np.uint8).tobytes(),
                counts, TaskStatus.ALLOCATED, TaskStatus.PIPELINED,
                "task_created" in self.enc.arrays, fault="native.prepass",
            )
        if segments is None:
            segments = self._assign_segments_py(rows_a.tolist(), nrows_a.tolist(), alloc_a.tolist(), counts)
        for k, jrow in enumerate(touched_j.tolist()):
            alloc_d, pipe_d = segments[k]
            sidx = jobs_l[jrow].task_status_index
            pend = sidx.get(TaskStatus.PENDING)
            if pend is not None:
                if len(alloc_d) + len(pipe_d) == len(pend):
                    # this segment consumed the job's every remaining
                    # pending task (uids are distinct and all drawn from
                    # pend) — drop the bucket whole
                    del sidx[TaskStatus.PENDING]
                else:
                    for uid in alloc_d:
                        pend.pop(uid, None)
                    for uid in pipe_d:
                        pend.pop(uid, None)
                    if not pend:
                        del sidx[TaskStatus.PENDING]
            if alloc_d:
                d = sidx.get(TaskStatus.ALLOCATED)
                if d is None:
                    sidx[TaskStatus.ALLOCATED] = alloc_d
                else:
                    d.update(alloc_d)
            if pipe_d:
                d = sidx.get(TaskStatus.PIPELINED)
                if d is None:
                    sidx[TaskStatus.PIPELINED] = pipe_d
                else:
                    d.update(pipe_d)

    def _assign_segments_py(self, rows_o, nrows_o, alloc_o, counts):
        """Python twin of native bulk_assign: per-event status flip,
        node_name set, residency clone, node task-map insert; returns one
        (alloc_d, pipe_d) pair per job segment."""
        tasks = self.enc.tasks
        tkeys = self.task_keys
        node_by_row = self.node_by_row
        alloc_volumes = self.ssn.cache.allocate_volumes
        ALLOCATED, PIPELINED = TaskStatus.ALLOCATED, TaskStatus.PIPELINED
        segments = []
        pos = 0
        for cnt in counts:
            end = pos + cnt
            alloc_d: dict = {}
            pipe_d: dict = {}
            for row, nrow_i, is_alloc in zip(
                rows_o[pos:end], nrows_o[pos:end], alloc_o[pos:end]
            ):
                task = tasks[row]
                node = node_by_row[nrow_i]
                if is_alloc:
                    if task.pod.volumes:
                        # bulk rows cannot carry claims (encode routes
                        # volume pods host_only) — guard kept for custom
                        # encoders/binders; the job keeps finish()'s
                        # per-task volume checks
                        alloc_volumes(task, node.name)
                        self.stepped_jobs.add(task.job)
                    else:
                        task.volume_ready = True
                    task.status = ALLOCATED
                    alloc_d[task.uid] = task
                else:
                    task.status = PIPELINED
                    pipe_d[task.uid] = task
                task.node_name = node.name
                node.tasks[tkeys[row]] = task.clone_for_residency()
            pos = end
            segments.append((alloc_d, pipe_d))
        return segments

    def _flush_nodes(self) -> None:
        """Fold the per-node resource deltas into NodeInfo, following
        Resource.add/sub scalar-map key rules (resource_info.go:146-166)."""
        scalar_names = self.enc.scalar_names
        for nrow, buf in self._node_buf.items():
            node = self.ssn.nodes[self.enc.node_names[nrow]]
            total = buf.alloc + buf.pipe
            _res_sub(node.idle, buf.alloc, scalar_names, buf.scalar_keys)
            _res_sub(node.releasing, buf.pipe, scalar_names, buf.scalar_keys)
            _res_add(node.used, total, scalar_names, buf.scalar_keys)
        self._node_buf = {}

    # -- end of action -------------------------------------------------------

    def _numeric_columns(self, mask_arr, to_bind):
        """(rows, keys, hostnames, created) for the pure-bulk dispatch
        list, rebuilt from the replay's Allocated event log by array
        gathers alone. Valid only when the log covers the whole dispatch
        list (a prior action in the actions string can leave Allocated
        tasks this encode never saw; the count check detects that and the
        caller takes the per-task column pass). Order matches
        bulk_dispatch's list: both are job-major with status-index
        insertion order within a job."""
        if not self._bulk_alloc_log or "task_created" not in self.enc.arrays:
            return None
        if len(self._bulk_alloc_log) == 1:
            rows_all, nrows_all, jrows_all = self._bulk_alloc_log[0]
        else:
            rows_all = np.concatenate([seg[0] for seg in self._bulk_alloc_log])
            nrows_all = np.concatenate([seg[1] for seg in self._bulk_alloc_log])
            jrows_all = np.concatenate([seg[2] for seg in self._bulk_alloc_log])
        sel = mask_arr[jrows_all]
        if int(sel.sum()) != len(to_bind):
            return None
        rows_b = rows_all[sel]
        nrows_b = nrows_all[sel]
        if len(self._bulk_alloc_log) > 1:
            # job-major across segments, keeping each segment's (= bucket
            # insertion) order within a job
            order = np.argsort(jrows_all[sel], kind="stable")
            rows_b = rows_b[order]
            nrows_b = nrows_b[order]
        tasks = self.enc.tasks
        if to_bind and (to_bind[0] is not tasks[int(rows_b[0])] or to_bind[-1] is not tasks[int(rows_b[-1])]):
            return None  # order drift: take the per-task pass
        keys = np.asarray(self.task_keys, dtype=object)[rows_b].tolist()
        hostnames = np.asarray(self.enc.node_names, dtype=object)[nrows_b].tolist()
        created = np.asarray(self.enc.arrays["task_created"], np.float64)[rows_b]
        return rows_b, keys, hostnames, created

    def _finish_dispatch_py(self, ready_cnt_l, job_min_l, to_bind, pure_bulk, debug_on) -> None:
        """The per-job dispatch barrier loop (Python twin of the native
        bulk_dispatch; also the only path for host-stepped jobs, whose
        tasks may carry volumes)."""
        ssn = self.ssn
        BINDING = TaskStatus.BINDING
        for i, job in enumerate(self.enc.jobs):
            if job.uid not in self.alloc_jobs:
                continue
            if ready_cnt_l[i] < job_min_l[i]:
                continue
            allocated = job.task_status_index.get(TaskStatus.ALLOCATED)
            if not allocated:
                continue
            if job.uid not in self.stepped_jobs:
                # Pure-bulk gang: every task came through the bulk replay,
                # so it is volume-less with volume_ready=True — no per-task
                # checks, one bulk index move; the status flip for all
                # pure-bulk gangs happens once after the loop (nothing
                # observes status between here and there).
                dispatched = list(allocated.values())
                pure_bulk.extend(dispatched)
                to_bind.extend(dispatched)
                binding = job.task_status_index.setdefault(BINDING, {})
                binding.update(allocated)
                job.task_status_index.pop(TaskStatus.ALLOCATED, None)
                if debug_on:
                    log.debug("dispatched gang job %s (%d tasks)", job.uid, ready_cnt_l[i])
                continue
            dispatched = []
            failed = False
            for task in allocated.values():
                if task.pod.volumes or not task.volume_ready:
                    try:
                        ssn.cache.bind_volumes(task)
                    except Exception as e:  # noqa: BLE001
                        # Same routing as session._dispatch: errTasks
                        # resync + stop dispatching this gang (the serial
                        # path's early return, session.go:285-295).
                        log.error("failed to bind volumes of %s: %s", task.uid, e)
                        resync = getattr(ssn.cache, "resync_task", None)
                        if resync is not None:
                            resync(task)
                        failed = True
                        break
                task.status = BINDING
                dispatched.append(task)
                to_bind.append(task)
            # status-index move as one bulk update; on a volume failure only
            # the dispatched prefix moves (the rest stay Allocated, exactly
            # like the serial early return).
            binding = job.task_status_index.setdefault(BINDING, {})
            if not failed:
                binding.update(allocated)
                job.task_status_index.pop(TaskStatus.ALLOCATED, None)
            else:
                for task in dispatched:
                    allocated.pop(task.uid, None)
                    binding[task.uid] = task
            if debug_on:
                log.debug("dispatched gang job %s (%d tasks)", job.uid, ready_cnt_l[i])

    def _flip_binding(self, tasks: list) -> None:
        """status = Binding for every task: one native bulk_set_slot, or
        its Python twin."""
        if not tasks:
            return
        if self._native is None or not self._native_try("bulk_set_slot", tasks, "status", TaskStatus.BINDING):
            for task in tasks:
                task.status = TaskStatus.BINDING

    def finish(self, ready_cnt) -> None:
        """Final share sync + the gang dispatch barrier + one bulk bind."""
        ssn = self.ssn
        if self.drf is not None:
            drf = self.drf
            tot = drf.total_resource
            attrs = [drf.job_attrs[uid] for uid in self._touched_drf]
            if attrs and not tot.scalars:
                # vectorized final share sync: the same comparison-dtype
                # division as helpers.share, one array op per touched job set
                from kube_batch_tpu_torch.api.numerics import comparison_dtype

                dt = comparison_dtype()
                a = np.array(
                    [(at.allocated.milli_cpu, at.allocated.memory) for at in attrs],
                    dtype=dt,
                )
                t = np.array([tot.milli_cpu, tot.memory], dtype=dt)
                s = np.where(
                    t == 0,
                    np.where(a == 0, dt(0.0), dt(1.0)),
                    a / np.where(t == 0, dt(1.0), t),
                )
                shares = np.maximum(np.maximum(s[:, 0], s[:, 1]), 0.0)
                for at, sv in zip(attrs, shares.tolist()):
                    at.share = sv
            else:
                for attr in attrs:
                    drf._update_share(attr)
        if self.prop is not None:
            for qname in self._touched_prop:
                self.prop._update_share(self.prop.queue_attrs[qname])

        job_min = np.asarray(self.arrays["job_min"])
        ready_cnt = np.asarray(ready_cnt)
        BINDING = TaskStatus.BINDING
        to_bind: list = []  # dispatched tasks, in dispatch order
        pure_bulk: list = []  # pure-bulk gangs' tasks: one status flip below
        # Per-gang narration is gated on the package verbosity, never on
        # whether some logger is enabled for DEBUG: a host application's
        # logging setup must not turn the native dispatch off.
        debug_on = pkg_log.get_verbosity() >= 4
        mask_arr = None
        native_dispatched = False
        if not self.stepped_jobs and not debug_on and self._native is not None:
            # Every gang is pure-bulk (no volumes, no host steps): the
            # whole dispatch barrier is one native pass — per gang the
            # ALLOCATED bucket moves wholesale under BINDING (a dict move
            # when no bucket exists), tasks returned in dispatch order.
            jn = len(self.enc.jobs)
            mask_arr = self._alloc_flags[:jn] & (ready_cnt[:jn] >= job_min[:jn])
            out = self._native_try(
                "bulk_dispatch", self.enc.jobs, mask_arr.astype(np.uint8).tobytes(),
                TaskStatus.ALLOCATED, BINDING, fault="native.dispatch",
            )
            if out is not None:
                to_bind = pure_bulk = out
                native_dispatched = True
        if not native_dispatched:
            self._finish_dispatch_py(ready_cnt.tolist(), job_min.tolist(), to_bind, pure_bulk, debug_on)
        # Status flip + bind columns (rows / created / keys / hostnames).
        # Preferred: the numeric rebuild from the bulk replay's own
        # Allocated event log (array gathers, no per-task lookups) with
        # one native bulk_set_slot flip; then the native finish_columns
        # single pass; then the Python per-task loop. The flip covers
        # every dispatched task: stepped-path tasks are already Binding,
        # and setting the same value again changes nothing.
        rows_b = created = keys = hostnames = None
        if to_bind and native_dispatched:
            cols = self._numeric_columns(mask_arr, to_bind)
            if cols is not None:
                rows_b, keys, hostnames, created = cols
                self._flip_binding(to_bind)
        if to_bind and rows_b is None and self._native is not None:
            cols = self._native_try("finish_columns", to_bind, self.row_of, self.task_keys, BINDING)
            if cols is not None:
                rb, cb, keys, hostnames = cols
                rows_b = np.frombuffer(rb, np.int64)
                created = np.frombuffer(cb, np.float64)
        if to_bind and rows_b is None:
            self._flip_binding(pure_bulk)
            row_of = self.row_of
            tk = self.task_keys
            rows_b = np.fromiter((row_of.get(t.uid, -1) for t in to_bind), np.int64, count=len(to_bind))
            created = np.fromiter(
                (t.pod.metadata.creation_timestamp for t in to_bind), np.float64, count=len(to_bind)
            )
            keys = [tk[r] if r >= 0 else f"{t.namespace}/{t.name}" for t, r in zip(to_bind, rows_b.tolist())]
            hostnames = [t.node_name for t in to_bind]
        if not to_bind:
            return
        # Bulk bind: one cache call for the whole action's dispatches.
        keyed_bind = getattr(ssn.cache, "bind_many_keyed", None)
        bind_many = getattr(ssn.cache, "bind_many", None)
        if keyed_bind is not None:
            keyed_bind(to_bind, hostnames, keys)
        elif bind_many is not None:
            pairs = list(zip(to_bind, hostnames))
            if _accepts_keys(bind_many):
                bind_many(pairs, keys=keys)
            else:
                bind_many(pairs)
        else:
            for t, h in zip(to_bind, hostnames):
                ssn.cache.bind(t, h)
        # Scheduling latency per dispatched pod, one vector op: each task's
        # latency ends at its own solve segment's completion (decided_at).
        # A gang can carry tasks a prior action allocated that this encode
        # never saw: those stamp at dispatch, as the serial path would.
        decided = np.where(rows_b >= 0, self.decided_at[np.maximum(rows_b, 0)], time.time())
        metrics.update_task_schedule_durations(np.maximum(0.0, decided - created))


def _accepts_keys(bind_many) -> bool:
    """Signature-probe for the keys= extension — catching TypeError
    around the CALL would misread an internal TypeError raised after
    partial submission as 'no keys support' and double-submit the
    batch."""
    import inspect

    try:
        params = inspect.signature(bind_many).parameters
    except (TypeError, ValueError):
        return False
    return "keys" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


def _segment_sum(seg_ids, vecs, n_segments: int, R: int) -> np.ndarray:
    """[n_segments, R] column-wise weighted bincount — the net effect of
    `np.add.at(out, seg_ids, vecs)` but one C pass per column. Exact:
    integer-grid float64 sums are order-independent."""
    out = np.zeros((n_segments, R))
    if seg_ids.size == 0 or n_segments == 0:
        return out
    for r in range(R):
        out[:, r] = np.bincount(seg_ids, weights=vecs[:, r], minlength=n_segments)
    return out


def _axpy(objs, mat, sign) -> None:
    """Dense cpu/memory columns of each Resource += sign * its row of
    ``mat`` (scalar dimensions go through _res_scalars)."""
    for k, res in enumerate(objs):
        res.milli_cpu += sign * float(mat[k, 0])
        res.memory += sign * float(mat[k, 1])


class _NodeDelta:
    __slots__ = ("alloc", "pipe", "scalar_keys")

    def __init__(self) -> None:
        self.alloc = 0.0  # np broadcasts to [R] on first +=
        self.pipe = 0.0
        self.scalar_keys: set[str] = set()


def _res_sub(res, vec, scalar_names, keys) -> None:
    """Resource -= vec with the Go nil-map branch: scalar entries change
    only when the receiver already tracks scalars (resource_info.go:151-153)."""
    if np.ndim(vec) == 0:  # this pool saw no assignments
        return
    res.milli_cpu -= float(vec[0])
    res.memory -= float(vec[1])
    if res.scalars and keys:
        for k in keys:
            res.scalars[k] = res.scalars.get(k, 0.0) - float(vec[2 + scalar_names.index(k)])


def _res_add(res, vec, scalar_names, keys) -> None:
    if np.ndim(vec) == 0:
        return
    res.milli_cpu += float(vec[0])
    res.memory += float(vec[1])
    for k in keys:
        res.scalars[k] = res.scalars.get(k, 0.0) + float(vec[2 + scalar_names.index(k)])


def _res_scalars(res, vec, scalar_names, keys, sign, nil_map: bool = False) -> None:
    """Scalar-dimension half of _res_add/_res_sub, for when the dense
    cpu/mem columns already went through _axpy. With ``nil_map`` the
    receiver's empty scalar map stays empty (resource_info.go:151-153 sub
    semantics); adds create entries."""
    if not keys or np.ndim(vec) == 0:
        return
    if nil_map and not res.scalars:
        return
    for k in keys:
        res.scalars[k] = res.scalars.get(k, 0.0) + sign * float(
            vec[2 + scalar_names.index(k)]
        )


def new() -> Action:
    return TorchAllocateAction()
