"""Synthetic workload generators — the five BASELINE.md bench configs.

A copy of the reference package's generators: every ``random.Random(seed)``
draw happens in the same order, so one seed gives the same cluster in
both packages.

The reference measures itself only against live kubemark clusters
(test/e2e/benchmark.go:49-281); this package generates equivalent hollow
cluster states in-process (no API server) so the scheduling paths can be
benchmarked and property-tested at any scale. Config shapes follow
BASELINE.md "Benchmark configs to reproduce":

1. `gang_example`      — example/job.yaml: minMember=3 gang on 3 nodes
2. `synthetic`         — 1k pods x 100 nodes, uniform small jobs
3. `multi_queue`       — 10k x 1k, multi-queue, gang jobs
4. `preempt_mix`       — 50k x 5k, priority spread + running victims
5. `multi_tenant_ml`   — TFJob/MPIJob-style PS+worker gangs, 100 queues,
                         GPU/TPU scalar resources
7. `uniform_pool`      — 400k x 40k interchangeable fleet, 250-task gangs
                         (the node-class compression world)

and the worlds of the preempt and backfill actions: `preempt_contended`
(every node slot held by low-priority gang members) and `besteffort_mix`
(zero-request pods over a labeled, tainted fleet).

All quantities are milli-CPU / MiB granular so float32 device arithmetic
is exact (see ops/encode.py).
"""

from __future__ import annotations

import random

from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.apis.types import PodPhase, Taint, Toleration
from kube_batch_tpu_torch.testing import (
    build_cluster,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)

GPU = "nvidia.com/gpu"
TPU = "google.com/tpu"


def gang_example() -> ClusterInfo:
    """Config 1: the reference's example/job.yaml — one PodGroup,
    minMember=3, on a 3-node cluster."""
    pods = [
        build_pod(name=f"qj-{i}", group_name="qj-1", req=build_resource_list(cpu=1, memory="512Mi"))
        for i in range(3)
    ]
    nodes = [
        build_node(f"n{i}", build_resource_list(cpu=2, memory="2Gi", pods=110))
        for i in range(3)
    ]
    return build_cluster(pods, nodes, [build_pod_group("qj-1", min_member=3)], [build_queue("default")])


def _uniform_nodes(n_nodes: int, cpu: int = 16, mem_mi: int = 32768, pods: int = 110) -> list:
    return [
        build_node(
            f"node-{i:05d}",
            build_resource_list(cpu=cpu, memory=f"{mem_mi}Mi", pods=pods),
        )
        for i in range(n_nodes)
    ]


def synthetic(n_pods: int = 1000, n_nodes: int = 100, tasks_per_job: int = 10, seed: int = 0) -> ClusterInfo:
    """Config 2: kubemark-style hollow density state — small gang jobs,
    one queue."""
    rng = random.Random(seed)
    pods, pgs = [], []
    n_jobs = max(n_pods // tasks_per_job, 1)
    for j in range(n_jobs):
        name = f"job-{j:05d}"
        pgs.append(build_pod_group(name, min_member=max(tasks_per_job // 2, 1)))
        for t in range(tasks_per_job):
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(
                        cpu=f"{rng.choice([100, 250, 500])}m",
                        memory=f"{rng.choice([128, 256, 512])}Mi",
                    ),
                )
            )
    return build_cluster(pods, _uniform_nodes(n_nodes), pgs, [build_queue("default")])


def multi_queue(
    n_pods: int = 10_000, n_nodes: int = 1000, n_queues: int = 8, tasks_per_job: int = 20, seed: int = 0
) -> ClusterInfo:
    """Config 3: multi-queue gang mix (proportion-weighted queues)."""
    rng = random.Random(seed)
    queues = [build_queue(f"q{i}", weight=rng.randint(1, 4)) for i in range(n_queues)]
    for i, q in enumerate(queues):
        q.metadata.creation_timestamp = float(i)
    pods, pgs = [], []
    n_jobs = max(n_pods // tasks_per_job, 1)
    for j in range(n_jobs):
        name = f"job-{j:05d}"
        queue = queues[j % n_queues].name
        pgs.append(build_pod_group(name, queue=queue, min_member=tasks_per_job))
        for t in range(tasks_per_job):
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(
                        cpu=f"{rng.choice([250, 500, 1000])}m",
                        memory=f"{rng.choice([256, 512, 1024])}Mi",
                    ),
                )
            )
    return build_cluster(pods, _uniform_nodes(n_nodes), pgs, queues)


def preempt_mix(
    n_pods: int = 50_000, n_nodes: int = 5000, tasks_per_job: int = 25, seed: int = 0
) -> ClusterInfo:
    """Config 4: the north-star scale — 50k pending across priority bands
    on 5k nodes partially occupied by running (and some terminating)
    victims."""
    return build_cluster(*preempt_mix_objects(n_pods, n_nodes, tasks_per_job, seed))


def preempt_mix_objects(
    n_pods: int = 50_000, n_nodes: int = 5000, tasks_per_job: int = 25, seed: int = 0
) -> tuple[list, list, list, list]:
    """``preempt_mix``'s world as the objects a store takes: (pods, nodes,
    PodGroups, queues), the PodGroups ``Pending`` as a client creates
    them (``build_cluster`` flips them to Inqueue in place)."""
    rng = random.Random(seed)
    nodes = _uniform_nodes(n_nodes)
    pods, pgs = [], []
    # ~25% of each node pre-occupied by low-priority residents.
    for i in range(0, n_nodes, 2):
        pod = build_pod(
            name=f"victim-{i:05d}",
            node_name=f"node-{i:05d}",
            phase=PodPhase.RUNNING,
            req=build_resource_list(cpu=4, memory="8192Mi"),
            priority=1,
        )
        if rng.random() < 0.1:
            pod.metadata.deletion_timestamp = 1.0
        pods.append(pod)
    n_jobs = max(n_pods // tasks_per_job, 1)
    for j in range(n_jobs):
        name = f"job-{j:05d}"
        pgs.append(build_pod_group(name, min_member=max(tasks_per_job // 2, 1)))
        prio = rng.choice([1, 5, 9])
        for t in range(tasks_per_job):
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(
                        cpu=f"{rng.choice([250, 500])}m", memory=f"{rng.choice([512, 1024])}Mi"
                    ),
                    priority=prio,
                )
            )
    return pods, nodes, pgs, [build_queue("default")]


def multi_tenant_ml(
    n_jobs: int = 200, n_nodes: int = 500, n_queues: int = 100, seed: int = 0
) -> ClusterInfo:
    """Config 5: Kubeflow TFJob/MPIJob-shaped gangs — a small PS/launcher
    plus GPU or TPU workers — across many tenant queues."""
    rng = random.Random(seed)
    queues = [build_queue(f"tenant-{i:03d}", weight=rng.randint(1, 8)) for i in range(n_queues)]
    for i, q in enumerate(queues):
        q.metadata.creation_timestamp = float(i)
    nodes = []
    for i in range(n_nodes):
        rl = build_resource_list(cpu=32, memory="131072Mi", pods=110)
        if i % 2 == 0:
            rl[GPU] = 8.0
        else:
            rl[TPU] = 4.0
        nodes.append(build_node(f"node-{i:05d}", rl))
    pods, pgs = [], []
    for j in range(n_jobs):
        name = f"tfjob-{j:04d}"
        queue = queues[j % n_queues].name
        n_workers = rng.choice([2, 4, 8])
        accel = GPU if rng.random() < 0.5 else TPU
        pgs.append(build_pod_group(name, queue=queue, min_member=1 + n_workers))
        pods.append(
            build_pod(
                name=f"{name}-ps",
                group_name=name,
                req=build_resource_list(cpu=2, memory="4096Mi"),
            )
        )
        for w in range(n_workers):
            rl = build_resource_list(cpu=4, memory="16384Mi")
            rl[accel] = float(rng.choice([1, 2, 4]))
            pods.append(build_pod(name=f"{name}-worker-{w}", group_name=name, req=rl))
    return build_cluster(pods, nodes, pgs, queues)


def preempt_contended(
    n_nodes: int = 200, victim_tasks: int = 4, n_preemptor_jobs: int = 150,
    tasks_per_job: int = 4, seed: int = 0
) -> ClusterInfo:
    """A preemption-heavy scene for the preempt actions: every node slot
    held by low-priority gang members, higher-priority gangs starved
    behind them (the preempt.go:81-170 working set)."""
    rng = random.Random(seed)
    nodes = [
        build_node(f"node-{i:05d}", build_resource_list(cpu=2, memory="4096Mi", pods=10))
        for i in range(n_nodes)
    ]
    pods, pgs = [], []
    slots = [(i, s) for i in range(n_nodes) for s in range(2)]
    si = 0
    j = 0
    while si < len(slots):
        name = f"low-{j:04d}"
        pgs.append(build_pod_group(name, min_member=0))
        for t in range(victim_tasks):
            if si >= len(slots):
                break
            node_i, _ = slots[si]
            si += 1
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    node_name=f"node-{node_i:05d}",
                    phase=PodPhase.RUNNING,
                    req=build_resource_list(cpu=1, memory="2048Mi"),
                    priority=1,
                )
            )
        j += 1
    for j in range(n_preemptor_jobs):
        name = f"high-{j:04d}"
        pgs.append(build_pod_group(name, min_member=max(tasks_per_job // 2, 1)))
        for t in range(tasks_per_job):
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(
                        cpu=1, memory=f"{rng.choice([1024, 2048])}Mi"
                    ),
                    priority=9,
                )
            )
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


def uniform_pool(
    n_pods: int = 400_000, n_nodes: int = 40_000, tasks_per_job: int = 250,
    churn: float = 0.0, churn_salt: int = 0,
) -> ClusterInfo:
    """Config 7: the node-class compression world. An interchangeable
    fleet with pod-slice-sized gangs (250 tasks): every node is
    byte-identical to the encoder (same shape, no labels, no residents)
    and the gangs cycle through two request shapes, so the solver's node
    axis folds to a handful of equivalence classes.

    ``churn > 0`` plants a RUNNING resident on every ``1/churn``-th node
    with one of 64 request shapes picked from ``churn_salt``: the ~1% of a
    real fleet that differs from the pool at any moment. Varying the salt
    session to session moves which nodes differ (and the exact class
    count) without moving the class axis' power-of-two bucket."""
    nodes = _uniform_nodes(n_nodes)
    pods, pgs = [], []
    if churn > 0.0:
        step = max(int(1.0 / churn), 1)
        for i in range(0, n_nodes, step):
            v = (i * 31 + churn_salt * 7919) % 64
            pods.append(
                build_pod(
                    name=f"churn-{churn_salt:03d}-{i:05d}",
                    node_name=f"node-{i:05d}",
                    phase=PodPhase.RUNNING,
                    req=build_resource_list(
                        cpu=f"{100 + 25 * (v % 8)}m",
                        memory=f"{256 + 64 * (v // 8)}Mi",
                    ),
                )
            )
    n_jobs = max(n_pods // tasks_per_job, 1)
    for j in range(n_jobs):
        name = f"job-{j:05d}"
        pgs.append(build_pod_group(name, min_member=max(tasks_per_job // 2, 1)))
        small = j % 2 == 0
        for t in range(tasks_per_job):
            pods.append(
                build_pod(
                    name=f"{name}-t{t}",
                    group_name=name,
                    req=build_resource_list(
                        cpu="250m" if small else "500m",
                        memory="512Mi" if small else "1024Mi",
                    ),
                )
            )
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


def besteffort_mix(
    n_pods: int = 2000, n_nodes: int = 1000, seed: int = 0
) -> ClusterInfo:
    """A backfill-heavy scene: zero-request (BestEffort) pods with mixed
    selector/toleration shapes over a labeled fleet whose nodes hold few
    pods (the backfill.go:41-76 working set). Early nodes fill to their
    pod capacity, so the serial first-fit walk re-scans the full prefix
    for every later task, and zone-selector pods whose zone sits late in
    node-name order walk most of the cluster per task."""
    rng = random.Random(seed)
    zones = ["a", "b", "c", "d"]
    nodes = []
    block = max(n_nodes // len(zones), 1)
    for i in range(n_nodes):
        # contiguous zone blocks: zone "d" occupies the name-order tail
        node = build_node(
            f"node-{i:05d}",
            build_resource_list(cpu=4, memory="8192Mi", pods=8),
            labels={"zone": zones[min(i // block, len(zones) - 1)]},
        )
        if i % 17 == 0:
            node.taints.append(Taint(key="dedicated", effect="NoSchedule"))
        nodes.append(node)
    pods, pgs = [], []
    n_jobs = max(n_pods // 20, 1)
    for j in range(n_jobs):
        name = f"be-{j:04d}"
        pgs.append(build_pod_group(name, min_member=1))
        for t in range(20):
            pod = build_pod(name=f"{name}-t{t}", group_name=name)
            shape = rng.random()
            if shape < 0.3:
                # selector pods biased to the tail zones: the serial walk
                # rejects the whole name-order prefix every time
                pod.node_selector["zone"] = rng.choice(["c", "d", "d", "d"])
            elif shape < 0.4:
                pod.tolerations.append(
                    Toleration(key="dedicated", operator="Exists")
                )
            pods.append(pod)
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


CONFIGS = {
    "gang_example": gang_example,
    "synthetic_1k_100": lambda: synthetic(1000, 100),
    "multi_queue_10k_1k": lambda: multi_queue(10_000, 1000),
    "preempt_50k_5k": lambda: preempt_mix(50_000, 5000),
    "multi_tenant_ml": lambda: multi_tenant_ml(),
    "besteffort_2k_1k": lambda: besteffort_mix(2000, 1000),
    "uniform_pool_50k_5k": lambda: uniform_pool(50_000, 5000),
}
