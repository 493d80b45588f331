"""The port's `torch_preempt` against the JAX package's `xla_preempt` and
both packages' serial `preempt`.

Every world is built twice from the same seed, once with each package's
builders (the JAX test generators of tests/test_xla_preempt.py and their
copies in `kube_batch_tpu_torch.testing`), and goes through each
package's `FakeCache`, session and action. The outcome is compared
exactly: ``{task uid: (status, node)}`` over every task of the session,
the binds, and the evict list in order. The scan is float64 numpy on both
sides, so nothing is compared with a tolerance. The JAX actions run with
jax x64 off (the production float32 policy the port follows).

Also holds the runner the other scan-action and pipeline tests share.
"""

from types import SimpleNamespace

import pytest

import kube_batch_tpu.apis.types as jax_apis
import kube_batch_tpu.testing as jax_testing
from kube_batch_tpu import actions as _jax_actions  # noqa: F401  (registers the JAX actions)
from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401  (registers the JAX plugins)
from kube_batch_tpu import models as jax_models
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import get_action as jax_get_action
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.testing import FakeCache as JaxFakeCache
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.apis.types as torch_apis
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import actions as _torch_actions  # noqa: F401  (registers the port's actions)
from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch import plugins as _torch_plugins  # noqa: F401  (registers the port's plugins)
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import get_action as torch_get_action
from kube_batch_tpu_torch.framework import open_session as torch_open

import test_xla_preempt as jax_preempt_tests
from test_xla_preempt import PREEMPT_TIERS

JAX = SimpleNamespace(t=jax_testing, apis=jax_apis)
TORCH = SimpleNamespace(t=torch_testing, apis=torch_apis)

# torch_allocate on the kernels' plain versions, never routed by size
CPU_ARGS = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}

NO_PREDICATES = """
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: nodeorder
"""


def session_state(ssn) -> dict:
    """{task uid: (status name, node)} over every task of the session."""
    return {
        t.uid: (t.status.name, t.node_name)
        for j in ssn.jobs.values()
        for d in j.task_status_index.values()
        for t in d.values()
    }


def jax_run(actions, cluster, tiers_yaml=PREEMPT_TIERS):
    """The named JAX actions, in order, over one session of `cluster`;
    returns (state, binds, evicts)."""
    with x64_enabled(False):
        cache = JaxFakeCache(cluster)
        ssn = jax_open(cache, jax_parse(tiers_yaml).tiers)
        for name in actions:
            jax_get_action(name).execute(ssn)
        state = session_state(ssn)
        jax_close(ssn)
    return state, dict(cache.binder.binds), list(cache.evictor.evicts)


def torch_run(actions, cluster, tiers_yaml=PREEMPT_TIERS, action_arguments=CPU_ARGS):
    """The named port actions, in order, over one session of `cluster`;
    returns (state, binds, evicts)."""
    cache = torch_testing.FakeCache(cluster)
    ssn = torch_open(cache, torch_parse(tiers_yaml).tiers, action_arguments)
    for name in actions:
        torch_get_action(name).execute(ssn)
    state = session_state(ssn)
    torch_close(ssn)
    return state, dict(cache.binder.binds), list(cache.evictor.evicts)


def assert_four_way(make_jax, make_torch, vector, serial, tiers_yaml):
    """The port's vector action ≡ the JAX vector action ≡ both serial
    actions; returns the common outcome."""
    want = jax_run([serial], make_jax(), tiers_yaml)
    assert jax_run(["xla_" + vector], make_jax(), tiers_yaml) == want
    assert torch_run([serial], make_torch(), tiers_yaml) == want
    assert torch_run(["torch_" + vector], make_torch(), tiers_yaml) == want
    return want


def assert_preempt_parity(make_jax, make_torch):
    return assert_four_way(make_jax, make_torch, "preempt", "preempt", PREEMPT_TIERS)


def simple_preemption(P):
    """Two low-priority residents on two full nodes, one preemptor."""
    rl = P.t.build_resource_list
    victims = [
        P.t.build_pod(
            name=f"low-p{i}", group_name="low", req=rl(cpu=1, memory="512Mi"),
            node_name=f"n{i}", phase=P.apis.PodPhase.RUNNING, priority=1,
        )
        for i in range(2)
    ]
    preemptor = P.t.build_pod(name="high-p0", group_name="high", req=rl(cpu=1, memory="512Mi"), priority=9)
    nodes = [P.t.build_node(f"n{i}", rl(cpu=1, memory="1Gi", pods=5)) for i in range(2)]
    return P.t.build_cluster(
        victims + [preemptor], nodes,
        [P.t.build_pod_group("low", min_member=1), P.t.build_pod_group("high", min_member=1)],
        [P.t.build_queue("default")],
    )


def test_simple_preemption_parity():
    state, binds, evicts = assert_preempt_parity(lambda: simple_preemption(JAX), lambda: simple_preemption(TORCH))
    assert evicts == ["default/low-p0"]


@pytest.mark.parametrize("seed", range(24))
def test_contended_parity(seed):
    assert_preempt_parity(
        lambda: jax_preempt_tests.gen_contended_cluster(seed), lambda: torch_testing.gen_contended_cluster(seed)
    )


def test_contended_sweep_evicts():
    """The 24-seed sweep is not tame: the serial port evicts, and
    torch_preempt with it."""
    evicts = sum(len(torch_run(["torch_preempt"], torch_testing.gen_contended_cluster(s))[2]) for s in range(24))
    assert evicts >= 10


def test_preempt_mix_residents_parity():
    """The north-star config's shape at test scale: priority bands over
    nodes partially occupied by (some terminating) residents."""
    assert_preempt_parity(
        lambda: jax_models.preempt_mix(400, 40, tasks_per_job=10),
        lambda: torch_models.preempt_mix(400, 40, tasks_per_job=10),
    )


def _with_pod_affinity_preemptor(cluster, affinity):
    for job in cluster.jobs.values():
        for task in job.tasks.values():
            if task.pod.node_name == "" and task.pod.affinity is None:
                task.pod.affinity = affinity
                return cluster
    return cluster


def test_pod_affinity_preemptor_takes_serial_path():
    """A preemptor with required pod affinity is host-only: the scan walks
    it serially, with the serial action's outcome."""

    def make(P, gen):
        term = P.apis.PodAffinityTerm(label_selector={"app": "web"}, topology_key="kubernetes.io/hostname")
        return _with_pod_affinity_preemptor(gen(3), P.apis.Affinity(pod_affinity_required=[term]))

    def jax_make():
        return make(JAX, jax_preempt_tests.gen_contended_cluster)

    def torch_make():
        return make(TORCH, torch_testing.gen_contended_cluster)

    assert_preempt_parity(jax_make, torch_make)
    cache = torch_testing.FakeCache(torch_make())
    ssn = torch_open(cache, torch_parse(PREEMPT_TIERS).tiers, CPU_ARGS)
    act = torch_get_action("torch_preempt")
    act.execute(ssn)
    torch_close(ssn)
    assert act.last_timings["serial_scans"] >= 1


@pytest.mark.parametrize("seed", [5, 7])
def test_out_of_envelope_conf_runs_serial_preempt(seed):
    """A conf without the predicates plugin is outside the scan's
    envelope: torch_preempt runs the serial action and records why."""
    want = jax_run(["preempt"], jax_preempt_tests.gen_contended_cluster(seed), NO_PREDICATES)
    assert jax_run(["xla_preempt"], jax_preempt_tests.gen_contended_cluster(seed), NO_PREDICATES) == want
    got = torch_run(["torch_preempt"], torch_testing.gen_contended_cluster(seed), NO_PREDICATES)
    assert got == want
    assert torch_get_action("torch_preempt").last_timings["serial_reason"] == "envelope"
