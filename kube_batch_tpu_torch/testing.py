"""Cluster builders used by the workload generators and the tests
(reference pkg/scheduler/api/test_utils.go and pkg/scheduler/util/test_utils.go).
"""

from __future__ import annotations

import re
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
