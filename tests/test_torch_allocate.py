"""The slice's entry point, `kube_batch_tpu_torch.solve.allocate`, on the
CPU against the JAX package's actions under the default conf: its binds
equal the `xla_allocate` action's and the serial `allocate` action's, bind
for bind, and its pipelined tasks equal the tasks the actions leave
Pipelined. Both JAX actions run with jax x64 off (float32, the production
policy the port follows)."""

import pytest

from kube_batch_tpu import models as jax_models
from kube_batch_tpu.api.types import TaskStatus
from kube_batch_tpu.testing import x64_enabled

from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch.solve import allocate

from test_torch_encode import WORLDS, build_world
from test_xla_allocate import DEFAULT_TIERS_YAML, run_and_capture

NO_FAIR_SHARE_YAML = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
"""


def jax_outcome(action, cluster, tiers_yaml=DEFAULT_TIERS_YAML):
    """(binds, pipelined) of one JAX action; pipelined keyed like binds."""
    with x64_enabled(False):
        state, binds = run_and_capture(action, cluster, tiers_yaml)
    keys = {
        t.uid: f"{t.namespace}/{t.name}"
        for job in cluster.jobs.values()
        for t in job.tasks.values()
    }
    pipelined = {
        keys[uid]: node for uid, (status, node) in state.items() if status == TaskStatus.PIPELINED
    }
    return binds, pipelined


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_binds_match_xla_and_serial_allocate(world):
    serial = jax_outcome("allocate", build_world(jax_models, world))
    xla = jax_outcome("xla_allocate", build_world(jax_models, world))
    res = allocate(build_world(torch_models, world), device="cpu")
    assert xla == serial
    assert (res.binds, res.pipelined) == serial
    assert res.binds  # every world binds something
    if world == "preempt_mix_2000_40_seed1":
        assert res.pipelined  # the releasing-capacity path ran


def test_binds_match_without_drf_and_proportion():
    make = ("multi_queue", (400, 40, 4, 10))
    serial = jax_outcome("allocate", getattr(jax_models, make[0])(*make[1]), NO_FAIR_SHARE_YAML)
    res = allocate(
        getattr(torch_models, make[0])(*make[1]),
        enable_drf=False, enable_proportion=False, device="cpu",
    )
    assert (res.binds, res.pipelined) == serial


def test_allocate_leaves_the_cluster_unchanged():
    cluster = torch_models.synthetic(100, 10)
    before = {t.uid: (t.status, t.node_name) for j in cluster.jobs.values() for t in j.tasks.values()}
    idle = {n.name: n.idle.milli_cpu for n in cluster.nodes.values()}
    allocate(cluster, device="cpu")
    assert before == {t.uid: (t.status, t.node_name) for j in cluster.jobs.values() for t in j.tasks.values()}
    assert idle == {n.name: n.idle.milli_cpu for n in cluster.nodes.values()}


def test_allocate_raises_on_a_host_only_world():
    """A required pod-affinity term routes its task to the host step,
    which belongs to the session layer: the entry point refuses."""
    from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm

    cluster = torch_models.gang_example()
    task = next(iter(next(iter(cluster.jobs.values())).tasks.values()))
    task.pod.affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": "x"})])
    with pytest.raises(NotImplementedError, match="host step"):
        allocate(cluster, device="cpu")


def test_nothing_pending_is_an_empty_result():
    cluster = torch_models.gang_example()
    cluster.jobs.clear()
    res = allocate(cluster, device="cpu")
    assert res.state is None and res.binds == {} and res.pipelined == {}


def test_result_state_is_post_solve():
    """AllocateResult.state carries the solve's float state too: idle
    drops by what was allocated and releasing by what was pipelined."""
    import numpy as np

    from kube_batch_tpu_torch.ops.kernels import KIND_ALLOCATED, KIND_PIPELINED

    res = allocate(torch_models.preempt_mix(2000, 40, seed=1), device="cpu")
    a, st, n = res.encoded.arrays, res.state, res.encoded.n_tasks
    node, kind = st.assigned_node[:n].numpy(), st.assigned_kind[:n].numpy()
    for k, pool, got in ((KIND_ALLOCATED, "node_idle", st.idle), (KIND_PIPELINED, "node_rel", st.rel)):
        rows = kind == k
        assert rows.any()
        want = a[pool].astype(np.float64)
        np.subtract.at(want, node[rows], a["task_res"][:n][rows].astype(np.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1.0)
