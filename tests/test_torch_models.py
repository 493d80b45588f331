"""The port's workload generators (kube_batch_tpu_torch/models/), case for
case with tests/test_models.py.

Every JAX case keeps its name and its assertions and runs on both
packages: each case checks the generator's shape and returns what it read
(counts, queues, accelerator names, per-task requests by uid), and the two
packages' readings must be equal, so the port's generators build the same
seeded worlds as the JAX package's. No JAX case is left out.
"""

from __future__ import annotations

import types
from importlib import import_module


def _ns(root: str) -> types.SimpleNamespace:
    m = import_module(f"{root}.models")
    return types.SimpleNamespace(
        TaskStatus=import_module(f"{root}.api.types").TaskStatus, GPU=m.GPU, TPU=m.TPU, gang_example=m.gang_example,
        multi_queue=m.multi_queue, multi_tenant_ml=m.multi_tenant_ml, preempt_mix=m.preempt_mix,
        synthetic=m.synthetic,
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")


def both(case):
    assert (JAX.GPU, JAX.TPU) == (PORT.GPU, PORT.TPU)
    ref, got = case(JAX), case(PORT)
    assert got == ref


def count(P, cluster, status) -> int:
    return sum(len(j.task_status_index.get(status, {})) for j in cluster.jobs.values())


def requests(cluster) -> dict:
    return {t.uid: (t.resreq.milli_cpu, t.resreq.memory, dict(t.resreq.scalars or {}))
            for j in cluster.jobs.values() for t in j.tasks.values()}


def test_gang_example_shape():
    def case(P):
        c = P.gang_example()
        assert len(c.nodes) == 3
        assert count(P, c, P.TaskStatus.PENDING) == 3
        (job,) = c.jobs.values()
        assert job.min_available == 3
        return sorted(c.nodes), requests(c)

    both(case)


def test_synthetic_shape():
    def case(P):
        c = P.synthetic(200, 20)
        assert len(c.nodes) == 20
        assert count(P, c, P.TaskStatus.PENDING) == 200
        assert len(c.queues) == 1
        return sorted(c.nodes), requests(c)

    both(case)


def test_multi_queue_shape():
    def case(P):
        c = P.multi_queue(400, 40, n_queues=4, tasks_per_job=8)
        assert len(c.queues) == 4
        assert count(P, c, P.TaskStatus.PENDING) == 400
        queues_used = {j.queue for j in c.jobs.values()}
        assert queues_used == {f"q{i}" for i in range(4)}
        return sorted(queues_used), requests(c)

    both(case)


def test_preempt_mix_has_residents():
    def case(P):
        c = P.preempt_mix(500, 50, tasks_per_job=10)
        assert count(P, c, P.TaskStatus.PENDING) == 500
        residents = count(P, c, P.TaskStatus.RUNNING) + count(P, c, P.TaskStatus.RELEASING)
        assert residents == 25  # one victim per 2 nodes
        used = {n.name: n.used.milli_cpu for n in c.nodes.values()}
        assert any(v > 0 for v in used.values())
        return residents, used, requests(c)

    both(case)


def test_multi_tenant_ml_scalars():
    def case(P):
        c = P.multi_tenant_ml(n_jobs=10, n_nodes=20, n_queues=5)
        assert len(c.queues) == 5
        accels = set()
        for j in c.jobs.values():
            for t in j.task_status_index.get(P.TaskStatus.PENDING, {}).values():
                accels.update(t.resreq.scalars)
        assert accels <= {P.GPU, P.TPU} and accels
        gpu_nodes = sorted(n.name for n in c.nodes.values() if P.GPU in n.allocatable.scalars)
        tpu_nodes = sorted(n.name for n in c.nodes.values() if P.TPU in n.allocatable.scalars)
        assert gpu_nodes and tpu_nodes
        return sorted(accels), gpu_nodes, tpu_nodes, requests(c)

    both(case)


def test_generators_deterministic():
    def case(P):
        a, b = P.synthetic(100, 10, seed=5), P.synthetic(100, 10, seed=5)
        assert sorted(a.jobs) == sorted(b.jobs)
        ta = {t.uid: t.resreq.milli_cpu for j in a.jobs.values() for t in j.tasks.values()}
        tb = {t.uid: t.resreq.milli_cpu for j in b.jobs.values() for t in j.tasks.values()}
        assert ta == tb
        return ta

    both(case)
