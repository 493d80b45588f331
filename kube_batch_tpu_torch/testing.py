"""Cluster builders used by the workload generators and the tests, and a
session-facing fake cache (reference pkg/scheduler/api/test_utils.go and
pkg/scheduler/util/test_utils.go).
"""

from __future__ import annotations

import queue
import random
import re
import threading
from collections import deque
from typing import Optional, Union

from kube_batch_tpu_torch.apis.types import (
    GROUP_NAME_ANNOTATION_KEY,
    Container,
    Node,
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupSpec,
    PodPhase,
    Queue,
    QueueSpec,
)

_QUANTITY_RE = re.compile(r"^([0-9.]+)([a-zA-Z]*)$")


_SUFFIX = {
    "": 1.0,
    "m": 1e-3,  # milli (cpu)
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
}


def parse_quantity(q: Union[str, int, float]) -> float:
    """Parse a Kubernetes-style quantity string ("100m", "1G", "2Gi") into a
    float in base units (cores for cpu, bytes for memory)."""
    if isinstance(q, (int, float)):
        return float(q)
    m = _QUANTITY_RE.match(q.strip())
    if not m:
        raise ValueError(f"cannot parse quantity {q!r}")
    value, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {q!r}")
    return float(value) * _SUFFIX[suffix]


def build_resource_list(
    cpu: Union[str, float] = 0,
    memory: Union[str, float] = 0,
    pods: int = 0,
    **scalars: Union[str, float],
) -> dict[str, float]:
    """Resource list dict from k8s-style quantity strings. Scalar kwargs
    translate double-underscores: ``nvidia__com__gpu=2`` becomes
    ``nvidia.com/gpu: 2`` (first ``__`` -> ``.``, second -> ``/``); or pass
    a pre-built dict via build_resource_list(**{"nvidia.com/gpu": 2})."""
    rl: dict[str, float] = {}
    if cpu:
        rl["cpu"] = parse_quantity(cpu)
    if memory:
        rl["memory"] = parse_quantity(memory)
    if pods:
        rl["pods"] = float(pods)
    for name, q in scalars.items():
        if "__" in name:
            # domain__suffix__resource -> domain.suffix/resource
            parts = name.split("__")
            name = ".".join(parts[:-1]) + "/" + parts[-1]
        rl[name] = parse_quantity(q)
    return rl


def build_pod(
    namespace: str = "default",
    name: str = "pod",
    node_name: str = "",
    phase: PodPhase = PodPhase.PENDING,
    req: Optional[dict[str, float]] = None,
    group_name: str = "",
    labels: Optional[dict[str, str]] = None,
    priority: Optional[int] = None,
    node_selector: Optional[dict[str, str]] = None,
    scheduler_name: str = "kube-batch-tpu",
    volumes: Optional[list[str]] = None,
) -> Pod:
    """reference api/test_utils.go buildPod."""
    annotations = {}
    if group_name:
        annotations[GROUP_NAME_ANNOTATION_KEY] = group_name
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            uid=f"{namespace}-{name}",
            labels=labels or {},
            annotations=annotations,
        ),
        phase=phase,
        containers=[Container(requests=dict(req or {}))],
        node_name=node_name,
        node_selector=node_selector or {},
        priority=priority,
        scheduler_name=scheduler_name,
        volumes=list(volumes or []),
    )


def build_task(
    namespace: str = "default",
    name: str = "task",
    req: Optional[dict[str, float]] = None,
    node_name: str = "",
    phase: PodPhase = PodPhase.PENDING,
    group_name: str = "",
    priority: Optional[int] = None,
):
    """One TaskInfo over a `build_pod` pod."""
    from kube_batch_tpu_torch.api.job_info import TaskInfo

    return TaskInfo(
        build_pod(
            namespace=namespace, name=name, node_name=node_name, phase=phase,
            req=req, group_name=group_name, priority=priority,
        )
    )


def build_node(
    name: str,
    alloc: Optional[dict[str, float]] = None,
    labels: Optional[dict[str, str]] = None,
    capacity: Optional[dict[str, float]] = None,
) -> Node:
    """reference api/test_utils.go buildNode."""
    alloc = dict(alloc or {})
    return Node(
        metadata=ObjectMeta(name=name, uid=name, labels=labels or {}),
        allocatable=alloc,
        capacity=dict(capacity) if capacity is not None else dict(alloc),
    )


def build_pod_group(
    name: str,
    namespace: str = "default",
    queue: str = "default",
    min_member: int = 1,
    min_resources: Optional[dict[str, float]] = None,
) -> PodGroup:
    return PodGroup(
        metadata=ObjectMeta(name=name, namespace=namespace, uid=f"pg-{namespace}-{name}"),
        spec=PodGroupSpec(min_member=min_member, queue=queue, min_resources=min_resources),
    )


def build_queue(name: str, weight: int = 1) -> Queue:
    return Queue(metadata=ObjectMeta(name=name, uid=f"q-{name}"), spec=QueueSpec(weight=weight))


def build_pv(
    name: str,
    capacity: Union[str, int, float] = "10Gi",
    storage_class: str = "",
    node_affinity: Optional[list] = None,
):
    from kube_batch_tpu_torch.apis.types import PersistentVolume

    return PersistentVolume(
        metadata=ObjectMeta(name=name, uid=f"pv-{name}"),
        capacity_storage=parse_quantity(capacity),
        storage_class_name=storage_class,
        node_affinity=list(node_affinity or []),
    )


def build_pvc(
    name: str,
    namespace: str = "default",
    storage_class: str = "",
    request: Union[str, int, float] = "1Gi",
):
    from kube_batch_tpu_torch.apis.types import PersistentVolumeClaim

    return PersistentVolumeClaim(
        metadata=ObjectMeta(name=name, namespace=namespace, uid=f"pvc-{namespace}-{name}"),
        storage_class_name=storage_class,
        request_storage=parse_quantity(request),
    )


def build_storage_class(name: str, mode: str = "Immediate"):
    from kube_batch_tpu_torch.apis.types import StorageClass, VolumeBindingMode

    return StorageClass(
        metadata=ObjectMeta(name=name, uid=f"sc-{name}"),
        volume_binding_mode=VolumeBindingMode(mode),
    )


def build_cluster(
    pods: list[Pod],
    nodes: list[Node],
    pod_groups: Optional[list[PodGroup]] = None,
    queues: Optional[list[Queue]] = None,
):
    """Wire pods/nodes/podgroups/queues into a ClusterInfo the way the
    cache does (reference cache/event_handlers.go:43-88): tasks join jobs
    via the group-name annotation (pods without one get a synthetic
    single-member shadow job), bound/running tasks also land on their
    node. Jobs whose PodGroup is Pending-phase get phase Inqueue so the
    allocate action considers them (the enqueue action owns that gate in
    a full pipeline)."""
    from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
    from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo, get_job_id, job_key
    from kube_batch_tpu_torch.api.node_info import NodeInfo
    from kube_batch_tpu_torch.api.queue_info import QueueInfo
    from kube_batch_tpu_torch.apis.types import PodGroupPhase

    cluster = ClusterInfo()
    for node in nodes:
        cluster.nodes[node.name] = NodeInfo(node)
    for queue in queues or []:
        cluster.queues[queue.name] = QueueInfo(queue)

    for pg in pod_groups or []:
        if pg.status.phase == PodGroupPhase.PENDING:
            pg.status.phase = PodGroupPhase.INQUEUE
        jid = job_key(pg.metadata.namespace, pg.name)
        job = JobInfo(jid)
        job.set_pod_group(pg)
        cluster.jobs[jid] = job

    for pod in pods:
        task = TaskInfo(pod)
        jid = get_job_id(pod) or f"{pod.namespace}/{pod.name}-shadow"
        if jid not in cluster.jobs:
            shadow = build_pod_group(
                name=f"{pod.name}-shadow", namespace=pod.namespace, min_member=1
            )
            shadow.status.phase = PodGroupPhase.INQUEUE
            job = JobInfo(jid)
            job.set_pod_group(shadow)
            cluster.jobs[jid] = job
        task.job = jid
        cluster.jobs[jid].add_task_info(task)
        if task.node_name and task.node_name in cluster.nodes:
            cluster.nodes[task.node_name].add_task(task)
    return cluster


def seed_store(store, pods, nodes, pod_groups=(), queues=()) -> None:
    """Create a world's objects in a ``cache.ClusterStore`` through its
    API, as a client would: queues, nodes, PodGroups, then pods."""
    for q in queues:
        store.create_queue(q)
    for node in nodes:
        store.create_node(node)
    for pg in pod_groups:
        store.create_pod_group(pg)
    for pod in pods:
        store.create_pod(pod)


class _Channel:
    """One-signal-per-bind channel (the reference's Go test channel,
    util/test_utils.go:95-117): SimpleQueue's get/get_nowait/empty
    surface plus a bulk `extend` — one lock round for a 200k-bind batch
    instead of 200k `put` calls."""

    __slots__ = ("_items", "_cond")

    def __init__(self) -> None:
        self._items: deque = deque()
        self._cond = threading.Condition()

    def put(self, item) -> None:
        with self._cond:
            self._items.append(item)
            self._cond.notify()

    def extend(self, items) -> None:
        with self._cond:
            self._items.extend(items)
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        with self._cond:
            if not self._cond.wait_for(lambda: self._items, timeout):
                raise queue.Empty
            return self._items.popleft()

    def get_nowait(self):
        with self._cond:
            if not self._items:
                raise queue.Empty
            return self._items.popleft()

    def empty(self) -> bool:
        with self._cond:
            return not self._items


class FakeBinder:
    """Records binds instead of calling an API server; delivers one signal
    per bind, like the reference's Go channel (util/test_utils.go:95-117) —
    a latching Event would let a test waiting for N binds pass after one."""

    def __init__(self) -> None:
        self.binds: dict[str, str] = {}  # "ns/name" -> node
        self.channel = _Channel()
        self._lock = threading.Lock()

    def bind(self, pod: Pod, hostname: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        with self._lock:
            self.binds[key] = hostname
        self.channel.put(key)

    def bind_many(self, pairs: list, keys: "Optional[list[str]]" = None) -> None:
        """Bulk form: one lock acquisition, same one-signal-per-bind
        channel contract. ``keys`` (parallel "ns/name" strings) skips
        200k per-pod f-string constructions when the caller already
        holds them (the replay path does)."""
        if keys is not None:
            keyed = list(zip(keys, (hostname for _, hostname in pairs)))
        else:
            keyed = [
                (f"{pod.namespace}/{pod.name}", hostname) for pod, hostname in pairs
            ]
        with self._lock:
            self.binds.update(keyed)
        self.channel.extend(k for k, _ in keyed)

    def bind_many_keyed(self, keys: list, hostnames: list) -> None:
        """Column form of bind_many: binds.update from an iterator, one
        channel extend — no intermediate pair list at all."""
        with self._lock:
            self.binds.update(zip(keys, hostnames))
        self.channel.extend(keys)


class FakeEvictor:
    """reference util/test_utils.go:120-140; one signal per evict."""

    def __init__(self) -> None:
        self.evicts: list[str] = []
        self.channel: "queue.SimpleQueue[str]" = queue.SimpleQueue()
        self._lock = threading.Lock()

    def evict(self, pod: Pod) -> None:
        key = f"{pod.namespace}/{pod.name}"
        with self._lock:
            self.evicts.append(key)
        self.channel.put(key)


class FakeStatusUpdater:
    """no-op (reference util/test_utils.go:143-153)."""

    def update_pod_condition(self, pod: Pod, condition) -> None:
        return None

    def update_pod_group(self, pg: PodGroup) -> None:
        return None


class FakeVolumeBinder:
    """no-op (reference util/test_utils.go:156-166)."""

    def allocate_volumes(self, task, hostname: str) -> None:
        return None

    def bind_volumes(self, task) -> None:
        return None


class FakeCache:
    """Session-facing cache with fake write-side, for action-level tests
    (the pattern of reference actions/allocate/allocate_test.go:38-212:
    real model, fake Binder/Evictor)."""

    def __init__(
        self,
        cluster,
        binder: Optional[FakeBinder] = None,
        evictor: Optional[FakeEvictor] = None,
        status_updater: Optional[FakeStatusUpdater] = None,
        volume_binder: Optional[FakeVolumeBinder] = None,
    ) -> None:
        self.cluster = cluster
        self.binder = binder or FakeBinder()
        self.evictor = evictor or FakeEvictor()
        self.status_updater = status_updater or FakeStatusUpdater()
        self.volume_binder = volume_binder or FakeVolumeBinder()

    def snapshot(self):
        from kube_batch_tpu_torch.api.cluster_info import ClusterInfo

        return ClusterInfo(
            jobs={uid: job.clone() for uid, job in self.cluster.jobs.items()},
            nodes={name: node.clone() for name, node in self.cluster.nodes.items()},
            queues={name: q.clone() for name, q in self.cluster.queues.items()},
        )

    def bind(self, task, hostname: str) -> None:
        self.binder.bind(task.pod, hostname)

    def bind_many(self, pairs: list, keys=None) -> None:
        if keys is not None:
            # keyed fast path: the binder never touches the pods
            self.binder.bind_many(pairs, keys=keys)
            return
        self.binder.bind_many([(task.pod, hostname) for task, hostname in pairs])

    def bind_many_keyed(self, tasks: list, hostnames: list, keys: list) -> None:
        """Parallel-list bulk bind (replay fast path): tasks/hostnames/
        keys are same-length columns; no per-bind tuple objects."""
        self.binder.bind_many_keyed(keys, hostnames)

    def evict(self, task, reason: str) -> None:
        self.evictor.evict(task.pod)

    def update_job_status(self, job):
        self.status_updater.update_pod_group(job.pod_group)
        return job

    def record_job_status_event(self, job) -> None:
        return None

    def allocate_volumes(self, task, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task) -> None:
        self.volume_binder.bind_volumes(task)


# -- randomized preempt / reclaim scenes ---------------------------------------
# The JAX package's tests draw these worlds (tests/test_xla_preempt.py,
# tests/test_xla_reclaim.py); the same seed gives the same world from
# either package's builders.


def gen_contended_cluster(seed: int):
    """Random preemption scene: low-priority gang jobs running on full
    nodes, starved higher-priority jobs pending in the same queues."""
    rng = random.Random(seed)
    n_queues = rng.randint(1, 2)
    queues = [build_queue(f"q{i}", weight=rng.randint(1, 3)) for i in range(n_queues)]
    for i, q in enumerate(queues):
        q.metadata.creation_timestamp = float(i)

    nodes, pods, pgs = [], [], []
    n_nodes = rng.randint(2, 8)
    for i in range(n_nodes):
        labels = {"zone": rng.choice(["a", "b"])} if rng.random() < 0.3 else {}
        nodes.append(
            build_node(
                f"n{i:02d}",
                build_resource_list(cpu=2, memory="2Gi", pods=rng.randint(3, 8)),
                labels=labels,
            )
        )

    # running low-priority victims (grouped => preemptable via job filter);
    # each node fits two 1cpu/1Gi runners
    free = [2] * n_nodes
    slot = 0
    for j in range(rng.randint(1, 3)):
        name = f"low{j}"
        n_tasks = rng.randint(1, 4)
        pgs.append(
            build_pod_group(
                name, queue=rng.choice(queues).name, min_member=rng.randint(0, 1)
            )
        )
        for t in range(n_tasks):
            while slot < 2 * n_nodes and free[slot % n_nodes] == 0:
                slot += 1
            if slot >= 2 * n_nodes:
                break
            node = nodes[slot % n_nodes]
            free[slot % n_nodes] -= 1
            slot += 1
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    node_name=node.name,
                    phase=PodPhase.RUNNING,
                    req=build_resource_list(cpu=1, memory="1Gi"),
                    priority=1,
                )
            )

    # pending high-priority preemptors
    for j in range(rng.randint(1, 3)):
        name = f"high{j}"
        n_tasks = rng.randint(1, 3)
        pgs.append(
            build_pod_group(
                name, queue=rng.choice(queues).name, min_member=rng.randint(1, n_tasks)
            )
        )
        for t in range(n_tasks):
            pod = build_pod(
                name=f"{name}-t{t}",
                group_name=name,
                req=build_resource_list(
                    cpu=rng.choice([1, 2]), memory=rng.choice(["512Mi", "1Gi"])
                ),
                priority=rng.choice([5, 9]),
            )
            if rng.random() < 0.2:
                pod.node_selector = {"zone": rng.choice(["a", "b"])}
            pods.append(pod)

    return build_cluster(pods, nodes, pgs, queues)


def gen_reclaim_cluster(seed: int):
    """One queue hogging nodes past its deserved share, another starved —
    the proportion plugin's Reclaimable working set."""
    rng = random.Random(seed)
    n_nodes = rng.randint(2, 6)
    nodes = [
        build_node(f"n{i:02d}", build_resource_list(cpu=2, memory="2Gi", pods=8))
        for i in range(n_nodes)
    ]
    qa = build_queue("qa", weight=1)
    qb = build_queue("qb", weight=rng.randint(2, 5))
    qa.metadata.creation_timestamp = 0.0
    qb.metadata.creation_timestamp = 1.0

    pods, pgs = [], []
    # qa holds every slot
    slot = 0
    for j in range((2 * n_nodes + 3) // 4):
        name = f"hog{j}"
        pgs.append(build_pod_group(name, queue="qa", min_member=0))
        for t in range(4):
            if slot >= 2 * n_nodes:
                break
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    node_name=f"n{slot // 2:02d}",
                    phase=PodPhase.RUNNING,
                    req=build_resource_list(cpu=1, memory="1Gi"),
                )
            )
            slot += 1
    # qb starves
    for j in range(rng.randint(1, 3)):
        name = f"starved{j}"
        n_tasks = rng.randint(1, 3)
        pgs.append(build_pod_group(name, queue="qb", min_member=1))
        for t in range(n_tasks):
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(cpu=1, memory="1Gi"),
                    priority=rng.choice([1, 5]),
                )
            )
    return build_cluster(pods, nodes, pgs, [qa, qb])


def gen_contended_reclaim_cluster(seed: int):
    """Richer randomized multi-queue scene (the reclaim twin of
    gen_contended_cluster's sweep): 2-4 queues with random weights,
    randomly distributed running hogs of varied sizes, node selectors on
    some starved pods, mixed priorities and gang minimums."""
    rng = random.Random(10_000 + seed)
    n_queues = rng.randint(2, 4)
    queues = [build_queue(f"q{i}", weight=rng.randint(1, 5)) for i in range(n_queues)]
    for i, q in enumerate(queues):
        q.metadata.creation_timestamp = float(i)

    nodes = []
    n_nodes = rng.randint(3, 8)
    for i in range(n_nodes):
        labels = {"zone": rng.choice(["a", "b"])} if rng.random() < 0.3 else {}
        nodes.append(
            build_node(
                f"n{i:02d}",
                build_resource_list(cpu=4, memory="4Gi", pods=rng.randint(4, 10)),
                labels=labels,
            )
        )

    pods, pgs = [], []
    # over-served queues: the first 1-2 queues hog most slots with
    # variously sized running pods
    hog_queues = queues[: rng.randint(1, 2)]
    free = {n.name: 4 for n in nodes}
    for j in range(rng.randint(2, 4)):
        name = f"hog{j}"
        pgs.append(
            build_pod_group(
                name,
                queue=rng.choice(hog_queues).name,
                min_member=rng.randint(0, 1),
            )
        )
        for t in range(rng.randint(2, 5)):
            hosts = [n for n, f in free.items() if f >= 1]
            if not hosts:
                break
            host = rng.choice(hosts)
            cpu = rng.choice([1, 2])
            if free[host] < cpu:
                cpu = 1
            free[host] -= cpu
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    node_name=host,
                    phase=PodPhase.RUNNING,
                    req=build_resource_list(cpu=cpu, memory=f"{cpu}Gi"),
                    priority=rng.choice([0, 1]),
                )
            )

    # under-served queues starve with pending work
    for j, q in enumerate(queues[len(hog_queues):]):
        for k in range(rng.randint(1, 2)):
            name = f"starved{j}-{k}"
            n_tasks = rng.randint(1, 3)
            pgs.append(
                build_pod_group(name, queue=q.name, min_member=rng.randint(1, n_tasks))
            )
            for t in range(n_tasks):
                pod = build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(
                        cpu=rng.choice([1, 2]), memory=rng.choice(["512Mi", "1Gi", "2Gi"])
                    ),
                    priority=rng.choice([1, 5, 9]),
                )
                if rng.random() < 0.2:
                    pod.node_selector = {"zone": rng.choice(["a", "b"])}
                pods.append(pod)

    return build_cluster(pods, nodes, pgs, queues)
