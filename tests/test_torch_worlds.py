"""The worlds of the preempt and backfill actions: the port's
``models.preempt_contended`` and ``models.besteffort_mix`` against the JAX
package's generators, and the port's ``torch_preempt`` and
``torch_backfill`` on them against the JAX package's ``xla_preempt`` and
``xla_backfill`` and both packages' serial actions.

The generators are compared object for object (names, requests, phases,
nodes, labels, taints, tolerations, selectors, priorities, gangs' minimum
members) at their defaults and at two other seeds and sizes; the actions'
outcomes (every task's state, the binds, the evicts in order) exactly.
"""

from __future__ import annotations

import pytest

from kube_batch_tpu import models as jax_models
from kube_batch_tpu_torch import models as torch_models

from test_torch_backfill import JAX as BF_JAX
from test_torch_backfill import assert_backfill_parity
from test_torch_preempt import assert_preempt_parity


def _value(v):
    return getattr(v, "value", v)


def reading(cluster) -> dict:
    """Every object of a generated world, as plain values."""
    tasks = {}
    for job in cluster.jobs.values():
        for t in job.tasks.values():
            pod = t.pod
            tasks[t.uid] = (
                pod.metadata.namespace, pod.metadata.name, _value(pod.phase), pod.node_name, pod.priority,
                [dict(c.requests) for c in pod.containers], dict(pod.node_selector),
                [(x.key, x.operator, x.value, x.effect) for x in pod.tolerations], dict(pod.metadata.labels),
                pod.metadata.deletion_timestamp, dict(pod.metadata.annotations), job.name,
            )
    nodes = {
        name: (
            dict(n.node.allocatable), dict(n.node.capacity), dict(n.node.metadata.labels),
            [(x.key, x.value, x.effect) for x in n.node.taints],
        )
        for name, n in cluster.nodes.items()
    }
    jobs = {
        uid: (j.name, j.namespace, j.queue, j.min_available, _value(j.pod_group.status.phase))
        for uid, j in cluster.jobs.items()
    }
    queues = {name: q.weight for name, q in cluster.queues.items()}
    return {"tasks": tasks, "nodes": nodes, "jobs": jobs, "queues": queues}


CONTENDED = [
    {},
    {"n_nodes": 40, "n_preemptor_jobs": 30, "seed": 3},
    {"n_nodes": 17, "victim_tasks": 3, "n_preemptor_jobs": 11, "tasks_per_job": 5, "seed": 7},
]
BESTEFFORT = [
    {},
    {"n_pods": 400, "n_nodes": 200, "seed": 1},
    {"n_pods": 130, "n_nodes": 37, "seed": 5},
]


@pytest.mark.parametrize("kwargs", CONTENDED, ids=["defaults", "40n_30j_seed3", "17n_seed7"])
def test_preempt_contended_equals_jax(kwargs):
    want = reading(jax_models.preempt_contended(**kwargs))
    got = reading(torch_models.preempt_contended(**kwargs))
    assert got == want
    n_nodes = kwargs.get("n_nodes", 200)
    running = [t for t in got["tasks"].values() if t[2] == "Running"]
    assert len(running) == 2 * n_nodes
    assert {t[4] for t in running} == {1}
    pending = [t for t in got["tasks"].values() if t[2] == "Pending"]
    assert len(pending) == kwargs.get("n_preemptor_jobs", 150) * kwargs.get("tasks_per_job", 4)
    assert {t[4] for t in pending} == {9}


@pytest.mark.parametrize("kwargs", BESTEFFORT, ids=["defaults", "400_200_seed1", "130_37_seed5"])
def test_besteffort_mix_equals_jax(kwargs):
    want = reading(jax_models.besteffort_mix(**kwargs))
    got = reading(torch_models.besteffort_mix(**kwargs))
    assert got == want
    tasks = got["tasks"].values()
    assert not any(any(t[5]) for t in tasks)  # BestEffort: every container's requests empty
    assert any(t[6] for t in tasks) and any(t[7] for t in tasks)
    assert any(n[3] for n in got["nodes"].values())


def test_configs_name_the_jax_worlds():
    assert set(torch_models.CONFIGS) == set(jax_models.CONFIGS)


def test_torch_preempt_on_preempt_contended_evicts_what_jax_evicts():
    kwargs = {"n_nodes": 40, "n_preemptor_jobs": 30}
    _state, _binds, evicts = assert_preempt_parity(
        lambda: jax_models.preempt_contended(**kwargs), lambda: torch_models.preempt_contended(**kwargs)
    )
    assert evicts


def test_torch_backfill_on_besteffort_mix_binds_what_jax_binds():
    def scene(P):
        return (jax_models if P is BF_JAX else torch_models).besteffort_mix(400, 200)

    _state, _nodes, binds = assert_backfill_parity(scene)
    assert len(binds) == 400
