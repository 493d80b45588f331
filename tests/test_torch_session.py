"""The port's session, plugins and close against the JAX package's.

Each world is built with each package's builders; each package's
`open_session` runs over its own `FakeCache` with the default conf. The
sessions must agree on the jobs left after the JobValid gate, the
Unschedulable conditions it writes, the drf and proportion open-session
state (floats exactly), the order functions' verdicts, and the PodGroup
statuses `close_session` writes after an allocate cycle. The encoder must
give the same bytes from the plugin instances as from `drf_state` /
`proportion_state`.
"""

import functools
import random

import numpy as np
import pytest

from kube_batch_tpu import plugins as _jax_plugins  # noqa: F401  (registers the JAX plugins)
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import get_action as jax_get_action
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import actions as _torch_actions  # noqa: F401  (registers the port's actions)
from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import get_action as torch_get_action
from kube_batch_tpu_torch.framework import open_session as torch_open
from kube_batch_tpu_torch.ops.encode import encode_session
from kube_batch_tpu_torch.plugins.drf import DrfPlugin, drf_state
from kube_batch_tpu_torch.plugins.proportion import ProportionPlugin, proportion_state

from test_torch_actions import CPU, JAX, TORCH, make
from test_torch_encode import WORLDS, assert_encodings_identical
from test_xla_allocate import DEFAULT_TIERS_YAML


def gate_world(P):
    """Gangs the JobValid gate must reject (fewer valid tasks than their
    minimum), one it must keep, and a Pending-phase PodGroup it exempts."""
    rl = P.t.build_resource_list(cpu=1, memory="256Mi")
    pods = [P.t.build_pod(name=f"short{i}", group_name="short", req=rl) for i in range(2)]
    pods += [P.t.build_pod(name=f"ok{i}", group_name="ok", req=rl) for i in range(3)]
    pods += [P.t.build_pod(name=f"late{i}", group_name="late", req=rl) for i in range(1)]
    pods += [
        P.t.build_pod(name=f"failed{i}", group_name="half-failed", req=rl,
                      phase=P.apis.PodPhase.FAILED if i else P.apis.PodPhase.PENDING)
        for i in range(3)
    ]
    pgs = [
        P.t.build_pod_group("short", min_member=3),
        P.t.build_pod_group("ok", min_member=3),
        P.t.build_pod_group("late", min_member=4),
        P.t.build_pod_group("half-failed", min_member=2),
    ]
    nodes = [P.t.build_node(f"n{i}", P.t.build_resource_list(cpu=4, memory="4Gi", pods=10)) for i in range(2)]
    cluster = P.t.build_cluster(pods, nodes, pgs, [P.t.build_queue("default")])
    cluster.jobs["default/late"].pod_group.status.phase = P.apis.PodGroupPhase.PENDING
    return cluster


KEYS = sorted(WORLDS) + ["gate_world", "multi_queue", "scalar_resources", "drf_order"]


def build(key, P):
    return gate_world(P) if key == "gate_world" else make(key, P)


def _conditions(job):
    pg = job.pod_group
    return [(c.type, c.status, c.reason, c.message) for c in pg.status.conditions] if pg else []


def _resource(r):
    return (r.milli_cpu, r.memory, tuple(sorted(r.scalars.items())))


def session_digest(ssn):
    """Everything the session holds after open that both packages share."""
    drf, prop = ssn.plugins["drf"], ssn.plugins["proportion"]
    return {
        "jobs": sorted(ssn.jobs),
        "conditions": {uid: _conditions(j) for uid, j in sorted(ssn.jobs.items())},
        "drf_total": _resource(drf.total_resource),
        "drf": {uid: (_resource(a.allocated), a.share) for uid, a in sorted(drf.job_attrs.items())},
        "prop_total": _resource(prop.total_resource),
        "prop": {
            name: (a.name, a.weight, a.share, _resource(a.deserved), _resource(a.allocated), _resource(a.request))
            for name, a in sorted(prop.queue_attrs.items())
        },
        "plugins": sorted(ssn.plugins),
    }


@functools.lru_cache(maxsize=None)
def jax_open_digest(key):
    with x64_enabled(False):
        cache = JAX.t.FakeCache(build(key, JAX))
        ssn = jax_open(cache, jax_parse(DEFAULT_TIERS_YAML).tiers)
        out = session_digest(ssn)
        gated = {uid: _conditions(j) for uid, j in cache.cluster.jobs.items()}
        jax_close(ssn)
    return out, gated


@pytest.mark.parametrize("key", KEYS)
def test_open_session_matches(key):
    cache = torch_testing.FakeCache(build(key, TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers)
    want, want_gated = jax_open_digest(key)
    assert session_digest(ssn) == want
    # the gate's conditions land on the PodGroups the cache holds too
    assert {uid: _conditions(j) for uid, j in cache.cluster.jobs.items()} == want_gated
    assert set(ssn.open_timings) == {"snapshot_s", "plugins_s", "job_valid_s"}
    torch_close(ssn)


def test_the_gate_rejects_short_gangs_and_exempts_pending():
    cache = torch_testing.FakeCache(gate_world(TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers)
    assert sorted(ssn.jobs) == ["default/late", "default/ok"]
    for uid in ("default/short", "default/half-failed"):  # failed tasks are not valid
        cond = cache.cluster.jobs[uid].pod_group.status.conditions
        assert [(c.type, c.reason) for c in cond] == [("Unschedulable", "NotEnoughTasks")]
        assert cond[0].transition_id == ssn.uid
    torch_close(ssn)


def _order(ssn, items, less):
    def cmp(a, b):
        return -1 if less(a, b) else (1 if less(b, a) else 0)

    return [x.uid for x in sorted(items, key=functools.cmp_to_key(cmp))]


def order_digest(ssn, seed):
    """The order functions' verdicts on shuffled jobs, queues and tasks."""
    rng = random.Random(seed)
    jobs = sorted(ssn.jobs.values(), key=lambda j: j.uid)
    rng.shuffle(jobs)
    queues = sorted(ssn.queues.values(), key=lambda q: q.uid)
    rng.shuffle(queues)
    tasks = sorted((t for j in ssn.jobs.values() for t in j.tasks.values()), key=lambda t: t.uid)
    rng.shuffle(tasks)
    return (
        _order(ssn, jobs, ssn.job_order_fn),
        _order(ssn, queues, ssn.queue_order_fn),
        _order(ssn, tasks[:400], ssn.task_order_fn),
    )


@pytest.mark.parametrize("key", ["multi_queue_400_40", "preempt_mix_2000_40_seed1", "drf_order", "priority_spread"])
def test_order_functions_sort_alike(key):
    with x64_enabled(False):
        cache = JAX.t.FakeCache(build(key, JAX))
        ssn = jax_open(cache, jax_parse(DEFAULT_TIERS_YAML).tiers)
        # move some shares off zero so drf and proportion order too
        jax_get_action("allocate").execute(ssn)
        want = order_digest(ssn, 7)
        jax_close(ssn)
    cache = torch_testing.FakeCache(build(key, TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers)
    torch_get_action("allocate").execute(ssn)
    assert order_digest(ssn, 7) == want
    torch_close(ssn)


def _statuses(cluster):
    out = {}
    for uid, job in sorted(cluster.jobs.items()):
        st = job.pod_group.status
        out[uid] = (st.phase.value, st.running, st.failed, st.succeeded, _conditions(job))
    return out


@pytest.mark.parametrize("key", ["gate_world", "gang_starved", "preempt_mix_2000_40_seed1", "pod_affinity_one"])
def test_close_session_writes_the_same_podgroup_statuses(key):
    """After an allocate cycle, close_session's write-back (phases,
    counts, the gang plugin's Unschedulable conditions) equals the JAX
    session's; the port's device action and its serial action agree."""
    with x64_enabled(False):
        cache = JAX.t.FakeCache(build(key, JAX))
        ssn = jax_open(cache, jax_parse(DEFAULT_TIERS_YAML).tiers)
        jax_get_action("xla_allocate").execute(ssn)
        jax_close(ssn)
        want = _statuses(cache.cluster)
    for action in (TorchAllocateAction(), torch_get_action("allocate")):
        cache = torch_testing.FakeCache(build(key, TORCH))
        ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers, {"torch_allocate": CPU})
        action.execute(ssn)
        torch_close(ssn)
        assert _statuses(cache.cluster) == want, action.name


@pytest.mark.parametrize("key", ["preempt_mix_2000_40_seed1", "multi_tenant_ml_8_8_3", "scalar_resources", "gate_world"])
def test_encoder_reads_plugins_and_states_alike(key):
    """encode_session over the session's plugin instances and over
    drf_state / proportion_state of the same snapshot: the same bytes."""
    cache = torch_testing.FakeCache(build(key, TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers)
    assert isinstance(ssn.plugins["drf"], DrfPlugin) and isinstance(ssn.plugins["proportion"], ProportionPlugin)
    from_plugins = encode_session(
        ssn.jobs, ssn.nodes, ssn.queues, drf=ssn.plugins["drf"], proportion=ssn.plugins["proportion"],
    )
    snap = cache.snapshot()
    from_states = encode_session(
        ssn.jobs, ssn.nodes, ssn.queues,
        drf=drf_state(snap.jobs, snap.nodes),
        proportion=proportion_state(snap.jobs, snap.nodes, snap.queues),
    )
    assert_encodings_identical(from_plugins, from_states)
    assert np.asarray(from_plugins.arrays["task_created"]).tobytes() == np.asarray(
        from_states.arrays["task_created"]
    ).tobytes()
    torch_close(ssn)
