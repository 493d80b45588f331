"""The PyTorch port's generators, plugin open-session state and encoder
against the JAX package's.

Both packages build the same world from the same seed; the JAX side goes
through `open_session` + `encode_session` (as tests/test_pallas_solve.py
does), the port through `drf_state` / `proportion_state` / `valid_jobs` /
`encode_session`. Every solver input array must be byte-identical at
float32; `task_created` (pod creation wall-clock stamps, host metadata the
solve never reads) is the one array left out.

Also holds the helpers the other test_torch_* files share.
"""

import numpy as np
import pytest

from kube_batch_tpu import actions  # noqa: F401  (registers actions)
from kube_batch_tpu import plugins  # noqa: F401  (registers plugins)
from kube_batch_tpu import models as jax_models
from kube_batch_tpu.conf import parse_scheduler_conf
from kube_batch_tpu.framework import close_session, open_session
from kube_batch_tpu.ops.encode import encode_session as jax_encode_session
from kube_batch_tpu.testing import FakeCache, x64_enabled

from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch.ops.encode import encode_session as torch_encode_session
from kube_batch_tpu_torch.plugins.drf import drf_state
from kube_batch_tpu_torch.plugins.proportion import proportion_state
from kube_batch_tpu_torch.solve import valid_jobs

from test_xla_allocate import DEFAULT_TIERS_YAML

# name -> (generator, args, kwargs); the same call builds the world in
# either package
WORLDS = {
    "gang_example": ("gang_example", (), {}),
    "synthetic_200_20": ("synthetic", (200, 20), {}),
    "multi_queue_400_40": ("multi_queue", (400, 40, 4, 10), {}),
    "multi_tenant_ml_8_8_3": ("multi_tenant_ml", (8, 8, 3), {}),
    "preempt_mix_2000_200": ("preempt_mix", (2000, 200), {}),
    # capacity runs short: part of the work pipelines onto releasing nodes
    "preempt_mix_2000_40_seed1": ("preempt_mix", (2000, 40), {"seed": 1}),
}

HOST_ONLY_KEYS = ("task_created",)


def build_world(pkg_models, name):
    fn, args, kwargs = WORLDS[name]
    return getattr(pkg_models, fn)(*args, **kwargs)


def jax_encode(cluster, drf=True, proportion=True):
    """The JAX package's encode of `cluster` under the default conf, with
    jax x64 off (the production float32 policy)."""
    with x64_enabled(False):
        cache = FakeCache(cluster)
        ssn = open_session(cache, parse_scheduler_conf(DEFAULT_TIERS_YAML).tiers)
        enc = jax_encode_session(
            ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float32,
            drf=ssn.plugins.get("drf") if drf else None,
            proportion=ssn.plugins.get("proportion") if proportion else None,
        )
        close_session(ssn)
    return enc


def torch_encode(cluster, drf=True, proportion=True):
    return torch_encode_session(
        valid_jobs(cluster), cluster.nodes, cluster.queues,
        drf=drf_state(cluster.jobs, cluster.nodes) if drf else None,
        proportion=(
            proportion_state(cluster.jobs, cluster.nodes, cluster.queues)
            if proportion else None
        ),
    )


def solver_arrays(enc) -> dict:
    """Encoder arrays as the solvers take them: host metadata dropped, the
    default nodeorder weights added."""
    a = {k: v for k, v in enc.arrays.items() if k not in HOST_ONLY_KEYS}
    one = np.float32(1)
    a.update(w_least=one, w_balanced=one, w_aff=one, w_podaff=one)
    return a


def assert_encodings_identical(j, t):
    assert set(j.arrays) == set(t.arrays)
    for key in sorted(j.arrays):
        if key in HOST_ONLY_KEYS:
            continue
        ja, ta = np.asarray(j.arrays[key]), np.asarray(t.arrays[key])
        assert ja.dtype == ta.dtype, key
        assert ja.shape == ta.shape, key
        assert ja.tobytes() == ta.tobytes(), key
    assert j.scalar_names == t.scalar_names
    assert [x.uid for x in j.tasks] == [x.uid for x in t.tasks]
    assert [x.uid for x in j.jobs] == [x.uid for x in t.jobs]
    assert [x.name for x in j.queues] == [x.name for x in t.queues]
    assert j.node_names == t.node_names
    assert (j.n_tasks, j.n_nodes, j.n_jobs, j.n_queues) == (
        t.n_tasks, t.n_nodes, t.n_jobs, t.n_queues
    )
    assert [x.uid for x in j.host_only] == [x.uid for x in t.host_only]
    assert j.interpod_active == t.interpod_active


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_encode_byte_identical(world):
    j = jax_encode(build_world(jax_models, world))
    t = torch_encode(build_world(torch_models, world))
    assert t.n_tasks > 0
    assert_encodings_identical(j, t)


@pytest.mark.parametrize("drf,proportion", [(False, True), (True, False)])
def test_encode_plugins_off(drf, proportion):
    j = jax_encode(jax_models.multi_queue(200, 20, 3, 5), drf, proportion)
    t = torch_encode(torch_models.multi_queue(200, 20, 3, 5), drf, proportion)
    assert_encodings_identical(j, t)


def test_generators_draw_the_same_cluster():
    """One seed, one cluster: pods, requests, priorities, queues and
    terminating residents agree between the two packages' generators."""

    def digest(cluster):
        pods = sorted(
            (t.namespace, t.name, t.job, t.node_name, t.priority, t.status.name,
             t.resreq.milli_cpu, t.resreq.memory, tuple(sorted(t.resreq.scalars.items())))
            for job in cluster.jobs.values()
            for t in job.tasks.values()
        )
        queues = sorted((q.name, q.weight) for q in cluster.queues.values())
        nodes = sorted(
            (n.name, n.allocatable.milli_cpu, n.idle.milli_cpu, n.releasing.milli_cpu)
            for n in cluster.nodes.values()
        )
        return pods, queues, nodes

    for name in ("multi_tenant_ml_8_8_3", "preempt_mix_2000_40_seed1"):
        assert digest(build_world(jax_models, name)) == digest(build_world(torch_models, name))
