"""torch_allocate action: the allocate loop as one device solve on the card.

Drop-in replacement for the serial allocate action (conf
``actions: "torch_allocate, backfill"``): encodes the session snapshot to
SoA arrays (ops/encode.py), runs the gang-aware solve on one of the two
device rungs —

- **fused**: the whole solve in one launch of kernel B1
  (``ops/fused_solve.FusedSolver``, ``csrc/fused_solve.cu``);
- **sharded**: with a mesh, the node-sharded blocked solve, kernel B2 once
  per shard per placing iteration (``parallel/sharded_block.py``,
  ``csrc/block_step.cu``) —

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
  in the JAX package; a mesh of one is the fused rung;
- ``exchange_batch``: the sharded rung's K-deep batched exchange (1);
- ``min_device_pairs``: the size floor (pending tasks x nodes) below
  which the cycle runs serially (256; a mesh request skips it).

Routing to serial happens for exactly three reasons, each recorded as
``last_solver_tier = "serial"`` with the reason in ``last_timings``: a conf
outside the solve's envelope (actions/envelope.py), a snapshot below the
size floor, and non-finite solver inputs. Nothing else reroutes a cycle:
a rung that fails to build, pack, launch or solve, or a snapshot past
kernel B1's shared-memory limit, raises ``DeviceSolveError`` out of
``execute`` before any bind.

Pod (anti-)affinity is pairwise-dynamic over resident pods
(predicates.go:187-199) and volume claims need the volume binder: such a
task is stepped on the host. The solve pauses when one reaches the head
of its job (``SolveState.paused_at``); the action replays the segment,
runs the serial inner loop for that one task against the live session
(allocate.go:139-180), patches a copy of the solver state, refreshes the
InterPodAffinity scores in the solver's own arrays, and resumes.

The JAX package's action also keeps a device-resident arena, a ladder of
solver tiers with circuit breakers and fault points, node-class
compression, native replay fast paths, pipelined dispatch, forensics and
metrics; those belong to later slices of this port.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from kube_batch_tpu_torch.actions.envelope import kernel_supported
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.encode import compute_pod_sc, encode_session
from kube_batch_tpu_torch.ops.fused_solve import FusedSolver
from kube_batch_tpu_torch.ops.kernels import KIND_ALLOCATED, KIND_PIPELINED, SolveState
from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh
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
    """A device rung failed to build, pack, launch or solve the cycle's
    snapshot. Raised out of ``execute``; the cycle is never rerouted."""


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
    serial plugin's defaults (nodeorder.go:139-153)."""
    for tier in ssn.tiers:
        for option in tier.plugins:
            if option.name == "nodeorder" and option.enabled_node_order:
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


class TorchAllocateAction(Action):
    """The card's allocate. Routes to serial only out of envelope, below
    the size floor, or on non-finite inputs."""

    def __init__(self) -> None:
        # Wall-clock split of the last execute(): encode_s, pack_s, solve_s
        # (every segment and host step) with the solver's own split summed
        # over segments, host_step_s, host_steps, replay_s; or, when the
        # cycle was routed to serial, serial_routed_s / serial_degraded_s
        # and serial_reason.
        self.last_timings: dict[str, float | int | str] = {}
        # Shards of the mesh the last execute() resolved (1: fused rung).
        self.last_mesh_size = 1
        # Which rung solved the last execute(): "fused", "sharded",
        # "serial", or "none" (nothing to solve).
        self.last_solver_tier = "none"
        # The final SolveState (CPU tensors) of the last device solve.
        self.last_state: SolveState | None = None
        # Gang iterations committed from K-deep batched exchanges.
        self.last_batched_iters = 0
        # The sharded rung's counts summed over the last execute()'s solve
        # segments: iterations, placing_iterations, launches (kernel B2).
        self.last_counts: dict[str, int] = {}

    @property
    def name(self) -> str:
        return "torch_allocate"

    # -- main ----------------------------------------------------------------

    def execute(self, ssn: Session) -> None:
        self.last_timings = {}
        self.last_solver_tier = "none"
        self.last_state = None
        self.last_mesh_size = 1
        self.last_batched_iters = 0
        self.last_counts = {}
        if not kernel_supported(ssn):
            log.info("conf outside the solve's envelope; running serial allocate")
            self._route_serial(ssn, "serial_routed_s", "envelope")
            return

        args = ssn.action_arguments.get(self.name, {})
        device, mesh = self._resolve(args)

        # Size floor: a device solve costs a fixed round trip regardless of
        # payload, while the serial loop clears tiny snapshots in
        # microseconds per pair. A mesh request is a statement of device
        # intent and skips the floor.
        if mesh is None and not self._mesh_requested(args):
            pend = sum(
                len(j.task_status_index.get(TaskStatus.PENDING, {}))
                for j in ssn.jobs.values()
            )
            if pend * max(len(ssn.nodes), 1) < self._min_device_pairs(args):
                log.debug(
                    "snapshot below the device size floor (%d pending x %d nodes); "
                    "running serial allocate", pend, len(ssn.nodes),
                )
                self._route_serial(ssn, "serial_routed_s", "size_floor")
                return

        order = [o.name for t in ssn.tiers for o in t.plugins]
        enable_drf = "drf" in order
        enable_proportion = "proportion" in order

        t0 = time.perf_counter()
        enc = encode_session(
            ssn.jobs,
            ssn.nodes,
            ssn.queues,
            drf=ssn.plugins.get("drf") if enable_drf else None,
            proportion=ssn.plugins.get("proportion") if enable_proportion else None,
        )
        t_encode = time.perf_counter() - t0
        if not enc.tasks:
            self.last_timings = {"encode_s": t_encode}
            return

        arrays = solver_inputs(enc, _nodeorder_weights(ssn))
        bad = _nonfinite_inputs(arrays)
        if bad:
            log.error(
                "non-finite solver inputs (%s); running serial allocate for this cycle",
                ", ".join(bad),
            )
            self._route_serial(ssn, "serial_degraded_s", "nonfinite: " + ", ".join(bad))
            return

        replay = _Replayer(ssn, enc, arrays, enable_drf, enable_proportion)
        budget = ssn.cycle_budget
        timings: dict = {"encode_s": t_encode}
        t0 = time.perf_counter()
        solver, tier = self._make_solver(arrays, enable_drf, enable_proportion, device, mesh, args)
        timings["pack_s"] = time.perf_counter() - t0

        split: dict[str, float] = {}
        host_steps, t_host = 0, 0.0
        t0 = time.perf_counter()
        state = self._solve(solver, tier, None, budget, split, self.last_counts)
        while int(state.paused_at) >= 0:
            if budget is not None:
                budget.check("between solve segments")
            th = time.perf_counter()
            # Segmented hybrid: sync the session up to the pause point,
            # step the host-only task serially, resume the solve.
            s = SolveState(*(x.clone() for x in state))  # writable host copy
            replay.apply_upto(s.assign_pos.numpy(), s.assigned_node.numpy(), s.assigned_kind.numpy(), int(s.step))
            s = self._host_step(ssn, enc, arrays, replay, s)
            host_steps += 1
            if enc.interpod_active:
                # the stepped pod carries pod-affinity terms; once resident
                # it shifts every group's InterPodAffinity score. The
                # solver re-folds its affinity static when the dict IT
                # holds gets a new pod_sc object.
                pod_sc = compute_pod_sc(
                    enc.task_reps, ssn.nodes, enc.node_names, arrays["pod_sc"].shape[1], np.float32,
                )
                arrays["pod_sc"] = pod_sc
                solver.a["pod_sc"] = torch.from_numpy(pod_sc)
            t_host += time.perf_counter() - th
            state = self._solve(solver, tier, s, budget, split, self.last_counts)
        timings.update(solve_s=time.perf_counter() - t0, **split, host_step_s=t_host, host_steps=host_steps)
        self.last_solver_tier = tier
        self.last_state = state
        if isinstance(solver, ShardedBlockSolver):
            self.last_batched_iters = solver.batched_iters
        self.last_timings = timings

        t0 = time.perf_counter()
        replay.apply_upto(
            state.assign_pos.numpy(), state.assigned_node.numpy(), state.assigned_kind.numpy(), int(state.step)
        )
        if budget is not None:
            # The last pre-dispatch gate: past this point binds reach the
            # cache and the cycle can no longer abort cleanly.
            budget.check("dispatch barrier")
        replay.finish(state.ready_cnt.numpy())
        timings["replay_s"] = time.perf_counter() - t0

    # -- routing and resolution ---------------------------------------------

    def _route_serial(self, ssn: Session, key: str, reason: str) -> None:
        from kube_batch_tpu_torch.actions.allocate import AllocateAction

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
        """The solve's device and mesh (None: the fused rung). Raises
        ValueError on a bad value and RuntimeError when the device is a
        card and none is visible."""
        mesh_spec = args.get("mesh", "").strip().lower()
        dev_spec = args.get("device", "").strip().lower()
        backend = None
        count_spec = mesh_spec
        if mesh_spec not in _MESH_OFF and ":" in mesh_spec:
            backend, count_spec = mesh_spec.split(":", 1)
            if backend not in ("cpu", "cuda"):
                raise ValueError(f"torch_allocate: mesh backend {backend!r} is not cpu or cuda")
        try:
            device = torch.device(dev_spec or backend or "cuda")
        except RuntimeError as e:
            raise ValueError(f"torch_allocate: device={dev_spec!r}: {e}") from None
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"torch_allocate: device {device} is not cpu or cuda")
        if backend is not None and device.type != backend:
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
                raise ValueError(f"torch_allocate: mesh={mesh_spec!r} is not a device count") from None
        if want < 1:
            raise ValueError(f"torch_allocate: mesh={mesh_spec!r} is not a device count")
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

    # -- the rungs -------------------------------------------------------------

    def _make_solver(self, arrays, enable_drf, enable_proportion, device, mesh, args):
        """Kernel B1's ``FusedSolver`` without a mesh, kernel B2's
        ``ShardedBlockSolver`` with one. No ladder: a solver that cannot be
        made raises."""
        a = arrays_from_numpy(arrays)  # CPU tensors sharing the arrays' memory
        if mesh is None:
            try:
                return FusedSolver(a, enable_drf, enable_proportion, device=device), "fused"
            except Exception as e:
                raise DeviceSolveError(
                    f"torch_allocate: the fused rung (kernel B1) cannot take this snapshot on {device}: "
                    f"{type(e).__name__}: {e}"
                ) from e
        spec = args.get("exchange_batch", "").strip() or "1"
        try:
            k = int(spec)
        except ValueError:
            raise ValueError(f"torch_allocate: exchange_batch={spec!r} is not an integer") from None
        try:
            return ShardedBlockSolver(a, mesh, enable_drf, enable_proportion, exchange_batch=k), "sharded"
        except Exception as e:
            raise DeviceSolveError(
                f"torch_allocate: the sharded rung (kernel B2) cannot take this snapshot on "
                f"{len(mesh)} shards of {sorted({str(d) for d in mesh})}: {type(e).__name__}: {e}"
            ) from e

    @staticmethod
    def _solve(solver, tier: str, state, budget, split: dict, counts: dict) -> SolveState:
        """One solve segment behind the solver-entry budget gate; the
        solver's own timings are summed into ``split`` and, on the sharded
        rung, its counts into ``counts``."""
        if budget is not None:
            budget.check("solver entry")
        try:
            out = solver.solve(state)
        except Exception as e:
            kernel = "kernel B1" if tier == "fused" else "kernel B2"
            raise DeviceSolveError(
                f"torch_allocate: the {tier} rung ({kernel}) failed: {type(e).__name__}: {e}"
            ) from e
        for key, v in solver.timings.items():
            split[key] = split.get(key, 0.0) + v
        for key, v in getattr(solver, "counts", {}).items():
            counts[key] = counts.get(key, 0) + v
        return out

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
        self.node_idx = {name: i for i, name in enumerate(enc.node_names)}
        self.task_keys = [f"{t.namespace}/{t.name}" for t in enc.tasks]
        self.node_by_row = [ssn.nodes[name] for name in enc.node_names]
        self.replayed = 0  # assignment events already applied
        self.alloc_jobs: set[str] = set()  # jobs with >=1 Allocated event
        # jobs that took a host-stepped (apply_immediate) event: their
        # allocated tasks may carry volume claims, so finish() keeps the
        # per-task volume checks for them
        self.stepped_jobs: set[str] = set()
        # per-node aggregation buffers (flushed once per host step)
        self._node_buf: dict[int, _NodeDelta] = {}
        self._touched_drf: set[str] = set()
        self._touched_prop: set[str] = set()

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
        nodes_t = [self.node_by_row[nrow] for nrow in touched_n.tolist()]
        _axpy([n.idle for n in nodes_t], n_alloc_vec, -1)
        _axpy([n.releasing for n in nodes_t], n_pipe_vec, -1)
        _axpy([n.used for n in nodes_t], n_alloc_vec + n_pipe_vec, 1)
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
        drf = self.drf
        jobs_t = [self.enc.jobs[jrow] for jrow in touched_j.tolist()]
        wa_pos = np.searchsorted(touched_j, wa)
        jobs_wa = [jobs_t[p] for p in wa_pos.tolist()]
        _axpy([j.allocated for j in jobs_wa], j_alloc[wa_pos], 1)
        self.alloc_jobs.update(j.uid for j in jobs_wa)
        if drf is not None:
            _axpy([drf.job_attrs[j.uid].allocated for j in jobs_t], j_tot, 1)
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
            _axpy([a.allocated for a in attrs_q], q_tot, 1)
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
        # land as one dict.update per (job, status).
        jobs_l = self.enc.jobs
        order = np.argsort(compj, kind="stable")
        counts = np.bincount(compj, minlength=touched_j.size).tolist()
        segments = self._assign_segments_py(
            rows[order].tolist(), nrows[order].tolist(), alloc[order].tolist(), counts
        )
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
        """Per-event status flip, node_name set, residency clone, node
        task-map insert; returns one (alloc_d, pipe_d) pair per job
        segment."""
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

    def _finish_dispatch_py(self, ready_cnt_l, job_min_l, to_bind, pure_bulk) -> None:
        """The per-job dispatch barrier loop."""
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
            log.debug("dispatched gang job %s (%d tasks)", job.uid, ready_cnt_l[i])

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

        to_bind: list = []  # dispatched tasks, in dispatch order
        pure_bulk: list = []  # pure-bulk gangs' tasks: one status flip below
        self._finish_dispatch_py(
            np.asarray(ready_cnt).tolist(), np.asarray(self.arrays["job_min"]).tolist(), to_bind, pure_bulk
        )
        if not to_bind:
            return
        BINDING = TaskStatus.BINDING
        for task in pure_bulk:
            task.status = BINDING
        row_of = {t.uid: r for r, t in enumerate(self.enc.tasks)}
        keys = []
        for t in to_bind:
            r = row_of.get(t.uid, -1)
            keys.append(self.task_keys[r] if r >= 0 else f"{t.namespace}/{t.name}")
        hostnames = [t.node_name for t in to_bind]
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
