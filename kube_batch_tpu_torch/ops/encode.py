"""Snapshot -> struct-of-arrays encoder (the solve's front end).

Encodes the session view (jobs/nodes/queues, reference
pkg/scheduler/api/cluster_info.go:22-26) into dense, padded, fixed-width
numpy arrays that the solve (ops/kernels.py, ops/fused_solve.py)
consumes:

- resource rows follow the `Resource.to_vector` contract
  ``[milli_cpu, memory, *scalar_slots]`` with the per-slot epsilon vector
  (api/resource_info.py);
- tasks are laid out **contiguously per job** in serial pop order
  (priority desc -> creation -> uid within the job;
  session_plugins.go:329-341), jobs in serial fallback order
  (creation -> uid), so the kernel pops a job's next task with one
  pointer increment instead of an O(T) masked argmin (`job_start` /
  `job_end` delimit each job's rows);
- the label-world predicates (node selector, required node affinity,
  taints/tolerations, cordon) and the preferred-node-affinity score are
  **deduplicated into (task-group x node-group) matrices**: tasks sharing
  a pod spec signature and nodes sharing a label/taint signature hit the
  same pure check functions (plugins/predicates.py, plugins/nodeorder.py)
  exactly once per group pair, then broadcast by integer gather.
  A 10k-task job is one group, so encoding is O(T + N + GT*GN), not
  O(T*N). Node signatures keep only the label keys actually referenced by
  pending tasks' selectors/affinity terms — a cluster whose nodes all
  carry unique labels (kubernetes.io/hostname) still collapses to a
  handful of groups (round-2 advisor finding);
- host ports become a small boolean incidence over the distinct ports
  pending tasks actually use, so conflicts with both residents and
  newly-assigned tasks are dynamic bitmask tests in the kernel;
- drf / proportion session state is lifted from the plugins' open-session
  state (plugins/drf.py, plugins/proportion.py: per-job allocated vectors
  + cluster totals, per-queue allocated / water-filled deserved + the Go
  nil-scalar-map parity bits) so the solve's in-loop share updates start
  bit-identical to the serial plugins' event-handler state (drf.go:60-83,
  proportion.go:58-144);
- everything is padded to the same buckets as the reference encoder —
  power-of-two for tasks/jobs/queues, multiples of 128 for the node axis —
  with validity masks, so both encoders give byte-identical arrays.

Tasks using required pod (anti-)affinity are flagged ``host_only``: that
predicate is pairwise-dynamic over resident pods (reference
predicates.go:187-199). The solve pauses when such a task reaches the
head of its job.

Dtype: the solve runs in float32, which is exact for milli-CPU-granular
cpu and MiB-granular memory (values stay on a 2^20-multiple grid well
inside the 24-bit mantissa).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.plugins.predicates import (
    check_node_condition,
    check_node_selector,
    check_node_unschedulable,
    check_pressure,
    check_taints,
)




def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket >= max(n, 1) (the reference encoder's
    task/job/queue padding, kept so both encoders agree byte for byte)."""
    size = max(n, 1, minimum)
    return 1 << (size - 1).bit_length()


def _node_bucket(n: int) -> int:
    """Node-axis bucket: next multiple of 128 (the reference encoder's
    node padding)."""
    return max((n + 127) // 128 * 128, 128)


_PLAIN_SIG = ((), "None", (), ())


def group_by_signature(items, sig_fn):
    """Dedup `items` by signature: returns (gids int32[len(items)],
    reps) with group ids in first-occurrence order."""
    groups: dict = {}
    gids = np.zeros(len(items), np.int32)
    reps: list = []
    for i, item in enumerate(items):
        sig = sig_fn(item)
        gid = groups.get(sig)
        if gid is None:
            gid = groups[sig] = len(reps)
            reps.append(item)
        gids[i] = gid
    return gids, reps


def build_static_compat(t_reps, n_reps, aff_sc):
    """[GT, GN] static predicate verdicts per (task-group, node-group)
    pair — `static_pod_node_compat` over the reps; a node group without
    a Node object rejects everything (predicates.py). The
    preferred-node-affinity score fills `aff_sc` in the same sweep."""
    from kube_batch_tpu_torch.plugins.nodeorder import node_affinity_score

    compat = np.zeros((max(len(t_reps), 1), max(len(n_reps), 1)), bool)
    for gi, trep in enumerate(t_reps):
        for gj, nrep in enumerate(n_reps):
            if nrep.node is None:
                continue
            compat[gi, gj] = static_pod_node_compat(trep.pod, nrep.node)
            aff_sc[gi, gj] = node_affinity_score(trep, nrep)
    return compat


def static_pod_node_compat(pod, node) -> bool:
    """The task-static × node-static predicate subset — cordon, node
    selector/required node affinity, taints (predicates.py). The
    node-dynamic checks (condition/pressure/pod count/ports) and the
    pairwise pod-affinity check stay with their callers."""
    return (
        check_node_unschedulable(pod, node)
        and check_node_selector(pod, node)
        and check_taints(pod, node)
    )


def _task_signature(task: TaskInfo, with_labels: bool = False) -> tuple:
    """Dedup key for the (task-group x node-group) predicate matrices.
    ``with_labels`` extends the key with the pod's own labels — needed
    when any pod in the snapshot carries pod-affinity terms, because the
    symmetric InterPodAffinity score reads the *incoming* pod's labels
    (plugins/nodeorder.py interpod_affinity_scores)."""
    pod = task.pod
    if (
        not pod.node_selector
        and pod.affinity is None
        and not pod.tolerations
        and not (with_labels and pod.metadata.labels)
    ):
        return _PLAIN_SIG  # fast path: the overwhelmingly common pod shape
    return (
        tuple(sorted(pod.node_selector.items())),
        repr(pod.affinity),
        tuple(sorted(repr(t) for t in pod.tolerations)),
        tuple(sorted(pod.metadata.labels.items())) if with_labels else (),
    )


def _node_signature(node: NodeInfo, label_keys: frozenset[str]) -> tuple:
    n = node.node
    if n is None:
        return (None,)
    return (
        tuple(sorted((k, v) for k, v in n.labels.items() if k in label_keys)),
        tuple(sorted(repr(t) for t in n.taints)),
        bool(n.unschedulable),
    )


_EMPTY_PORTS: frozenset[int] = frozenset()


def _task_ports(task: TaskInfo) -> frozenset[int]:
    cs = task.pod.containers
    if len(cs) == 1 and not cs[0].ports:
        return _EMPTY_PORTS  # fast path: single portless container
    return frozenset(p for c in cs for p in c.ports)


@dataclass
class EncodedSnapshot:
    """The dense snapshot + the host-side metadata needed to decode the
    solve's assignment back into binds."""

    scalar_names: tuple[str, ...]
    tasks: list[TaskInfo]  # row order (contiguous per job)
    jobs: list[JobInfo]  # row order
    queues: list[QueueInfo]  # row order
    node_names: list[str]  # row order (sorted)
    n_tasks: int
    n_nodes: int
    n_jobs: int
    n_queues: int
    host_only: list[TaskInfo] = field(default_factory=list)
    arrays: dict = field(default_factory=dict)
    # pod-affinity terms present somewhere in the snapshot: interpod
    # scores are live (arrays["pod_sc"] nonzero-able)
    interpod_active: bool = False
    task_reps: list[TaskInfo] = field(default_factory=list)  # group reps

    @property
    def has_host_only(self) -> bool:
        return bool(self.host_only)


def compute_pod_sc(
    task_reps: Sequence[TaskInfo],
    nodes: dict[str, NodeInfo],
    node_names: Sequence[str],
    n_pad: int,
    dtype,
) -> np.ndarray:
    """[GT, N] InterPodAffinity score matrix — one normalized 0..10 row
    per task group against the *current* residents. Exact for every task
    whose group rep shares its labels + affinity spec (the group
    signature guarantees that when interpod is active)."""
    from kube_batch_tpu_torch.plugins.nodeorder import interpod_affinity_scores

    out = np.zeros((max(len(task_reps), 1), n_pad), dtype)
    for gi, rep in enumerate(task_reps):
        scores = interpod_affinity_scores(rep, nodes)
        out[gi, : len(node_names)] = [scores[name] for name in node_names]
    return out


def _collect_scalar_names(
    tasks: Sequence[TaskInfo], nodes: Sequence[NodeInfo]
) -> tuple[str, ...]:
    names: set[str] = set()
    for t in tasks:
        if t.resreq.scalars:
            names.update(t.resreq.scalars)
        if t.init_resreq.scalars:
            names.update(t.init_resreq.scalars)
    for n in nodes:
        for res in (n.idle, n.releasing, n.allocatable, n.used):
            if res.scalars:
                names.update(res.scalars)
    return tuple(sorted(names))


def _node_ok(n: NodeInfo) -> bool:
    """Schedulable verdict of the node-static checks (condition, pressure)."""
    return (
        n.node is not None
        and check_node_condition(n.node)
        and check_pressure(n.node)
    )


def _dims_mask(res: Resource, scalar_names: Sequence[str]) -> list[bool]:
    """Which vector slots `res.resource_names()` would iterate: cpu and
    memory always, scalar slots only when the key is present in the
    scalar map (share()/LessEqual walk map keys — Go nil/absent-key
    semantics, resource_info.go:255-278, helpers.go:43-60)."""
    return [True, True, *(n in res.scalars for n in scalar_names)]


def _build_task_side(shortlist: list[JobInfo]):
    """The encode's task side: per-job pending extraction + pop-order
    sort, row layout, host-only routing, and referenced-label-key
    collection."""
    job_list: list[JobInfo] = []
    job_pending: dict[str, list[TaskInfo]] = {}
    for job in shortlist:
        pending = [
            t
            for t in job.task_status_index.get(TaskStatus.PENDING, {}).values()
            if not t.resreq.is_empty()
        ]
        if pending:
            # Within-job pop order = priority desc, creation, uid
            # (priority plugin task_order_fn + session fallback,
            # session_plugins.go:329-341).
            pending.sort(
                key=lambda t: (-t.priority, t.pod.metadata.creation_timestamp, t.uid)
            )
            job_list.append(job)
            job_pending[job.uid] = pending
    # Stable row order = the serial job heap's fallback order (creation,
    # uid). Dynamic ordering (priority/ready/drf share) is decided by the
    # solve's selection keys, with this row order as the final key.
    job_list.sort(key=lambda j: (j.creation_timestamp, j.uid))
    job_idx = {j.uid: i for i, j in enumerate(job_list)}

    task_list: list[TaskInfo] = []
    host_only: list[TaskInfo] = []
    job_ranges: list[tuple[int, int]] = []
    host_only_rows: list[int] = []
    # Label keys the pending tasks' selectors / node-affinity terms can
    # read. Node signatures project labels onto this set so per-node
    # unique labels (hostname et al) do not defeat node-group dedup.
    ref_label_keys: set[str] = set()
    for job in job_list:
        start = len(task_list)
        for t in job_pending[job.uid]:
            pod = t.pod
            if pod.node_selector:
                ref_label_keys.update(pod.node_selector)
            aff = pod.affinity
            if aff is not None:
                for term in aff.node_affinity_required:
                    ref_label_keys.add(term.key)
                for _, term in aff.node_affinity_preferred:
                    ref_label_keys.add(term.key)
            if (aff is not None and aff.has_pod_affinity_terms()) or pod.volumes:
                # pod-affinity terms gate feasibility pairwise or change
                # other tasks' scores once this pod lands; claims need the
                # volume binder: both are stepped host-side
                host_only.append(t)
                host_only_rows.append(len(task_list))
            task_list.append(t)
        job_ranges.append((start, len(task_list)))
    return job_list, job_idx, task_list, host_only, job_ranges, host_only_rows, ref_label_keys


def encode_session(
    jobs: dict[str, JobInfo],
    nodes: dict[str, NodeInfo],
    queues: dict[str, QueueInfo],
    drf=None,
    proportion=None,
) -> EncodedSnapshot:
    """Build the SoA snapshot for one allocate solve.

    Job/task eligibility mirrors the serial allocate action exactly
    (reference allocate.go:48-70,120-125): Pending-phase PodGroups wait
    for enqueue, jobs of unknown queues are skipped, BestEffort
    (empty-resreq) tasks are backfill's business.

    ``drf`` / ``proportion`` are the plugins' open-session states
    (plugins/drf.drf_state, plugins/proportion.proportion_state), or None
    when the conf does not enable them. Float arrays are float32, the
    solve's type.
    """
    dtype = np.float32
    node_list = [nodes[name] for name in sorted(nodes)]
    queue_list = sorted(
        queues.values(), key=lambda q: (q.queue.metadata.creation_timestamp, q.uid)
    )
    queue_idx = {q.name: i for i, q in enumerate(queue_list)}

    shortlist: list[JobInfo] = []
    for job in jobs.values():
        if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        if job.queue not in queues:
            continue
        shortlist.append(job)

    (
        job_list, job_idx, task_list, host_only,
        job_ranges, host_only_rows, ref_label_keys,
    ) = _build_task_side(shortlist)

    # InterPodAffinity activation: any pod-affinity terms anywhere (pending
    # or resident) make nodeorder's interpod score nonzero-able; the score
    # is per *node* (it reads each node's residents), so it rides its own
    # [GT, N] matrix. Volume-only host_only tasks do NOT activate it.
    interpod_active = any(
        t.pod.affinity is not None and t.pod.affinity.has_pod_affinity_terms()
        for t in host_only
    ) or any(
        rt.pod.affinity is not None and rt.pod.affinity.has_pod_affinity_terms()
        for n in node_list
        for rt in n.tasks.values()
    )

    scalar_names = _collect_scalar_names(task_list, node_list)
    R = 2 + len(scalar_names)
    t_n, n_n, j_n, q_n = len(task_list), len(node_list), len(job_list), len(queue_list)
    T = _bucket(t_n)
    N = _node_bucket(n_n)
    J = _bucket(j_n, 4)
    Q = _bucket(q_n, 2)

    # -- ports ---------------------------------------------------------------
    interesting_ports = sorted({p for t in task_list for p in _task_ports(t)})
    port_idx = {p: i for i, p in enumerate(interesting_ports)}
    P = max(len(interesting_ports), 1)

    # -- predicate / affinity groups ----------------------------------------
    label_keys = frozenset(ref_label_keys)
    t_groups: dict[tuple, int] = {}
    task_gid = np.zeros(T, np.int32)
    t_reps: list[TaskInfo] = []
    for i, t in enumerate(task_list):
        # under InterPodAffinity the signature reads pod labels
        sig = _task_signature(t, with_labels=interpod_active)
        if sig not in t_groups:
            t_groups[sig] = len(t_reps)
            t_reps.append(t)
        task_gid[i] = t_groups[sig]
    node_gids, n_reps = group_by_signature(
        node_list, lambda n: _node_signature(n, label_keys)
    )
    node_gid = np.zeros(N, np.int32)
    node_gid[: len(node_gids)] = node_gids
    GT, GN = max(len(t_reps), 1), max(len(n_reps), 1)
    aff_sc = np.zeros((GT, GN), dtype)
    compat = build_static_compat(t_reps, n_reps, aff_sc)

    # -- task arrays (column-wise fromiter: one C loop per column) ----------
    task_req = np.zeros((T, R), dtype)
    task_res = np.zeros((T, R), dtype)
    task_job = np.zeros(T, np.int32)
    task_has_sc = np.zeros(T, bool)
    task_res_has_sc = np.zeros(T, bool)
    task_host_only = np.zeros(T, bool)
    task_ports = np.zeros((T, P), bool)
    task_created = np.zeros(T)
    if t_n:
        if scalar_names:
            task_req[:t_n] = np.asarray(
                [t.init_resreq.to_vector(scalar_names) for t in task_list], dtype
            )
            task_res[:t_n] = np.asarray(
                [t.resreq.to_vector(scalar_names) for t in task_list], dtype
            )
        else:
            task_req[:t_n, 0] = np.fromiter(
                (t.init_resreq.milli_cpu for t in task_list), dtype, count=t_n
            )
            task_req[:t_n, 1] = np.fromiter(
                (t.init_resreq.memory for t in task_list), dtype, count=t_n
            )
            task_res[:t_n, 0] = np.fromiter(
                (t.resreq.milli_cpu for t in task_list), dtype, count=t_n
            )
            task_res[:t_n, 1] = np.fromiter(
                (t.resreq.memory for t in task_list), dtype, count=t_n
            )
        task_job[:t_n] = np.fromiter(
            (job_idx[t.job] for t in task_list), np.int32, count=t_n
        )
        task_has_sc[:t_n] = np.fromiter(
            (bool(t.init_resreq.scalars) for t in task_list), bool, count=t_n
        )
        task_res_has_sc[:t_n] = np.fromiter(
            (bool(t.resreq.scalars) for t in task_list), bool, count=t_n
        )
        if interesting_ports:
            for i, t in enumerate(task_list):
                for p in _task_ports(t):
                    task_ports[i, port_idx[p]] = True
        # per-row pod creation timestamp (host metadata, not a solve input)
        task_created[:t_n] = np.fromiter(
            (t.pod.metadata.creation_timestamp for t in task_list),
            np.float64, count=t_n,
        )
    task_host_only[host_only_rows] = True

    # -- job arrays ----------------------------------------------------------
    job_start = np.zeros(J, np.int32)
    job_end = np.zeros(J, np.int32)
    job_min = np.zeros(J, np.int32)
    job_ready0 = np.zeros(J, np.int32)
    job_prio = np.zeros(J, np.int32)
    job_rank = np.zeros(J, np.int32)
    job_queue = np.zeros(J, np.int32)
    job_valid = np.zeros(J, bool)
    for i, j in enumerate(job_list):
        job_start[i], job_end[i] = job_ranges[i]
        job_min[i] = j.min_available
        job_ready0[i] = j.ready_task_num()
        job_prio[i] = j.priority
        job_rank[i] = i  # job_list pre-sorted by (creation, uid)
        job_queue[i] = queue_idx[j.queue]
        job_valid[i] = True

    # -- node arrays ---------------------------------------------------------
    node_idle = np.zeros((N, R), dtype)
    node_rel = np.zeros((N, R), dtype)
    node_used = np.zeros((N, R), dtype)
    node_alloc = np.zeros((N, R), dtype)
    node_ok = np.zeros(N, bool)
    node_valid = np.zeros(N, bool)
    node_max_tasks = np.zeros(N, np.int32)
    node_ntasks = np.zeros(N, np.int32)
    node_idle_has_sc = np.zeros(N, bool)
    node_rel_has_sc = np.zeros(N, bool)
    node_ports = np.zeros((N, P), bool)
    for i, n in enumerate(node_list):
        node_idle[i] = n.idle.to_vector(scalar_names)
        node_rel[i] = n.releasing.to_vector(scalar_names)
        node_used[i] = n.used.to_vector(scalar_names)
        node_alloc[i] = n.allocatable.to_vector(scalar_names)
    if n_n:
        node_ok[:n_n] = np.fromiter((_node_ok(n) for n in node_list), bool, count=n_n)
        node_max_tasks[:n_n] = np.fromiter(
            (n.allocatable.max_task_num for n in node_list), np.int32, count=n_n
        )
        node_valid[:n_n] = True
        node_ntasks[:n_n] = np.fromiter(
            (len(n.tasks) for n in node_list), np.int32, count=n_n
        )
        node_idle_has_sc[:n_n] = np.fromiter(
            (bool(n.idle.scalars) for n in node_list), bool, count=n_n
        )
        node_rel_has_sc[:n_n] = np.fromiter(
            (bool(n.releasing.scalars) for n in node_list), bool, count=n_n
        )
    if interesting_ports:
        for i, n in enumerate(node_list):
            for task in n.tasks.values():
                for p in _task_ports(task):
                    if p in port_idx:
                        node_ports[i, port_idx[p]] = True

    queue_rank = np.arange(Q, dtype=np.int32)  # queue_list pre-sorted

    # -- drf / proportion session state (plugin-exact floats) ---------------
    job_alloc0 = np.zeros((J, R), dtype)
    drf_total = np.zeros(R, dtype)
    drf_dims = np.zeros(R, bool)
    if drf is not None:
        drf_total[:] = drf.total_resource.to_vector(scalar_names)
        drf_dims[:] = _dims_mask(drf.total_resource, scalar_names)
        for i, j in enumerate(job_list):
            attr = drf.job_attrs.get(j.uid)
            if attr is not None:
                job_alloc0[i] = attr.allocated.to_vector(scalar_names)

    q_alloc0 = np.zeros((Q, R), dtype)
    q_deserved = np.zeros((Q, R), dtype)
    q_dims = np.zeros((Q, R), bool)
    q_alloc_has_sc0 = np.zeros(Q, bool)
    if proportion is not None:
        for i, q in enumerate(queue_list):
            attr = proportion.queue_attrs.get(q.name)
            if attr is None:
                continue  # queue with no jobs: never selected by the solve
            q_alloc0[i] = attr.allocated.to_vector(scalar_names)
            q_deserved[i] = attr.deserved.to_vector(scalar_names)
            q_dims[i] = _dims_mask(attr.deserved, scalar_names)
            q_alloc_has_sc0[i] = bool(attr.allocated.scalars)

    eps = np.asarray(Resource.vector_epsilons(scalar_names), dtype)

    if interpod_active:
        pod_sc = compute_pod_sc(t_reps, nodes, [n.name for n in node_list], N, dtype)
    else:
        pod_sc = np.zeros((GT, N), dtype)

    return EncodedSnapshot(
        scalar_names=scalar_names,
        tasks=task_list,
        jobs=job_list,
        queues=queue_list,
        node_names=[n.name for n in node_list],
        n_tasks=t_n,
        n_nodes=n_n,
        n_jobs=j_n,
        n_queues=q_n,
        host_only=host_only,
        interpod_active=interpod_active,
        task_reps=t_reps,
        arrays=dict(
            task_req=task_req,
            task_res=task_res,
            task_created=task_created,
            task_job=task_job,
            task_gid=task_gid,
            task_has_sc=task_has_sc,
            task_res_has_sc=task_res_has_sc,
            task_host_only=task_host_only,
            task_ports=task_ports,
            node_idle=node_idle,
            node_rel=node_rel,
            node_used=node_used,
            node_alloc=node_alloc,
            node_ok=node_ok,
            node_valid=node_valid,
            node_max_tasks=node_max_tasks,
            node_ntasks=node_ntasks,
            node_idle_has_sc=node_idle_has_sc,
            node_rel_has_sc=node_rel_has_sc,
            node_gid=node_gid,
            node_ports=node_ports,
            compat=compat,
            aff_sc=aff_sc,
            pod_sc=pod_sc,
            job_start=job_start,
            job_end=job_end,
            job_min=job_min,
            job_ready0=job_ready0,
            job_prio=job_prio,
            job_rank=job_rank,
            job_queue=job_queue,
            job_valid=job_valid,
            queue_rank=queue_rank,
            job_alloc0=job_alloc0,
            drf_total=drf_total,
            drf_dims=drf_dims,
            q_alloc0=q_alloc0,
            q_deserved=q_deserved,
            q_dims=q_dims,
            q_alloc_has_sc0=q_alloc_has_sc0,
            eps=eps,
        ),
    )
