"""The port's InterPodAffinity scores (kube_batch_tpu_torch/plugins/nodeorder.py)
and their live use by the device rung, case for case with
tests/test_interpod_affinity.py.

- The five score cases (incoming preferred affinity by zone, incoming
  preferred anti-affinity, the symmetric preferred term of a resident,
  the hard symmetric weight of a resident's required terms, no terms
  anywhere) keep their names and assertions and run on both packages;
  the scores must agree.
- ``test_serial_equals_xla_resident_terms_shift_plain_tasks`` and
  ``test_serial_equals_xla_pending_preferred_terms_refresh`` become
  ``test_serial_equals_torch_allocate_*``: the port's serial ``allocate``
  against its ``torch_allocate`` on the CPU (the fused rung's plain
  version, the size floor off), resident and pending terms, with the
  pending terms' host steps and score refreshes; task states and binds
  must equal each other and the JAX serial action's.
- ``test_preempt_parity_with_interpod_active``: the same name; the port's
  ``preempt`` against ``torch_preempt`` with interpod active, evictions
  equal to each other and the JAX ``preempt``'s.

The JAX package runs with jax x64 off (the production float32 policy).
"""

from __future__ import annotations

import types
from importlib import import_module

from kube_batch_tpu.testing import x64_enabled

TIERS_YAML = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

PREEMPT_TIERS = TIERS_YAML.replace('actions: "allocate"', 'actions: "preempt"')


def _ns(root: str) -> types.SimpleNamespace:
    import_module(f"{root}.actions")
    import_module(f"{root}.plugins")
    apis = import_module(f"{root}.apis.types")
    t = import_module(f"{root}.testing")
    fw = import_module(f"{root}.framework")
    return types.SimpleNamespace(
        root=root, NodeInfo=import_module(f"{root}.api.node_info").NodeInfo,
        TaskInfo=import_module(f"{root}.api.job_info").TaskInfo, Affinity=apis.Affinity,
        PodAffinityTerm=apis.PodAffinityTerm, PodPhase=apis.PodPhase,
        parse=import_module(f"{root}.conf").parse_scheduler_conf, close_session=fw.close_session,
        get_action=fw.get_action, open_session=fw.open_session,
        scores=import_module(f"{root}.plugins.nodeorder").interpod_affinity_scores,
        FakeCache=t.FakeCache, build_cluster=t.build_cluster, build_node=t.build_node, build_pod=t.build_pod,
        build_pod_group=t.build_pod_group, build_queue=t.build_queue, build_resource_list=t.build_resource_list,
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")


def both(case):
    with x64_enabled(False):
        ref = case(JAX)
    got = case(PORT)
    assert got == ref


def node_info(P, name, labels=None, residents=()):
    ni = P.NodeInfo(P.build_node(name, P.build_resource_list(cpu=16, memory="32Gi", pods=20), labels=labels))
    for pod in residents:
        ni.add_task(P.TaskInfo(pod))
    return ni


def running(P, name, labels=None, affinity=None, node_name="n0"):
    pod = P.build_pod(name=name, node_name=node_name, phase=P.PodPhase.RUNNING,
                      req=P.build_resource_list(cpu=1, memory="1Gi"), labels=labels)
    pod.affinity = affinity
    return pod


def incoming(P, name="in", labels=None):
    return P.TaskInfo(P.build_pod(name=name, req=P.build_resource_list(cpu=1, memory="1Gi"), labels=labels))


# -- the scores ------------------------------------------------------------------


def test_incoming_preferred_affinity_scores_domain():
    def case(P):
        web = running(P, "web", labels={"app": "web"}, node_name="n0")
        nodes = {
            "n0": node_info(P, "n0", {"zone": "a"}, [web]),
            "n1": node_info(P, "n1", {"zone": "a"}),
            "n2": node_info(P, "n2", {"zone": "b"}),
        }
        task = incoming(P)
        task.pod.affinity = P.Affinity(pod_affinity_preferred=[(3, P.PodAffinityTerm({"app": "web"}, "zone"))])
        scores = P.scores(task, nodes)
        # zone a (n0, n1) gets weight 3, zone b 0: normalized 10 against 0
        assert scores == {"n0": 10, "n1": 10, "n2": 0}
        return scores

    both(case)


def test_incoming_preferred_anti_affinity_penalizes_domain():
    def case(P):
        web = running(P, "web", labels={"app": "web"}, node_name="n0")
        nodes = {"n0": node_info(P, "n0", {"zone": "a"}, [web]), "n1": node_info(P, "n1", {"zone": "b"})}
        task = incoming(P)
        task.pod.affinity = P.Affinity(pod_anti_affinity_preferred=[(5, P.PodAffinityTerm({"app": "web"}, "zone"))])
        scores = P.scores(task, nodes)
        assert scores == {"n0": 0, "n1": 10}  # -5 against 0, min-max normalized
        return scores

    both(case)


def test_symmetric_preferred_from_resident():
    def case(P):
        lover = running(P, "lover", labels={}, affinity=P.Affinity(
            pod_affinity_preferred=[(7, P.PodAffinityTerm({"role": "friend"}, "kubernetes.io/hostname"))]),
            node_name="n0")
        nodes = {"n0": node_info(P, "n0", residents=[lover]), "n1": node_info(P, "n1")}
        scores = P.scores(incoming(P, labels={"role": "friend"}), nodes)
        assert scores == {"n0": 10, "n1": 0}
        # a pod NOT matching the resident's selector gets nothing
        other = P.scores(incoming(P, "other"), nodes)
        assert other == {"n0": 0, "n1": 0}
        return scores, other

    both(case)


def test_hard_symmetric_weight_from_required_terms():
    def case(P):
        needy = running(P, "needy", affinity=P.Affinity(
            pod_affinity_required=[P.PodAffinityTerm({"app": "db"}, "kubernetes.io/hostname")]), node_name="n1")
        nodes = {"n0": node_info(P, "n0"), "n1": node_info(P, "n1", residents=[needy])}
        scores = P.scores(incoming(P, labels={"app": "db"}), nodes)
        assert scores == {"n0": 0, "n1": 10}
        return scores

    both(case)


def test_no_terms_anywhere_all_zero():
    def case(P):
        nodes = {"n0": node_info(P, "n0", residents=[running(P, "r")]), "n1": node_info(P, "n1")}
        scores = P.scores(incoming(P), nodes)
        assert scores == {"n0": 0, "n1": 0}
        return scores

    both(case)


# -- serial against the device rung with live interpod scores --------------------


def run_and_capture(P, action_name, cluster, tiers=TIERS_YAML):
    args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}} if action_name == "torch_allocate" else {}
    cache = P.FakeCache(cluster)
    ssn = P.open_session(cache, P.parse(tiers).tiers, args)
    action = P.get_action(action_name)
    action.execute(ssn)
    state = {t.uid: (t.status.name, t.node_name)
             for job in ssn.jobs.values() for tasks in job.task_status_index.values() for t in tasks.values()}
    P.close_session(ssn)
    return state, dict(cache.binder.binds), action


def assert_equivalent(make_cluster, host_steps: int):
    with x64_enabled(False):
        ref = run_and_capture(JAX, "allocate", make_cluster(JAX))[:2]
    serial = run_and_capture(PORT, "allocate", make_cluster(PORT))[:2]
    state, binds, action = run_and_capture(PORT, "torch_allocate", make_cluster(PORT))
    assert action.last_solver_tier == "fused"
    assert action.last_timings["host_steps"] == host_steps
    assert (state, binds) == serial == ref
    return binds


def test_serial_equals_torch_allocate_resident_terms_shift_plain_tasks():
    """Residents with preferred terms give pending tasks without terms
    nonzero interpod scores; the fused rung's folded affinity static must
    reproduce the serial plugin's placements."""

    def mk(P):
        magnet = P.build_pod(name="magnet", node_name="n2", phase=P.PodPhase.RUNNING,
                             req=P.build_resource_list(cpu=1, memory="1Gi"))
        magnet.affinity = P.Affinity(
            pod_affinity_preferred=[(9, P.PodAffinityTerm({"tier": "app"}, "kubernetes.io/hostname"))])
        pods = [magnet] + [P.build_pod(name=f"p{i}", group_name="pg", req=P.build_resource_list(cpu=1, memory="1Gi"),
                                       labels={"tier": "app"}) for i in range(3)]
        nodes = [P.build_node(f"n{i}", P.build_resource_list(cpu=4, memory="8Gi", pods=10)) for i in range(4)]
        return P.build_cluster(pods, nodes, [P.build_pod_group("pg", min_member=1)], [P.build_queue("default")])

    binds = assert_equivalent(mk, host_steps=0)
    assert "n2" in binds.values()  # the serial path pulls tasks toward the magnet node


def test_serial_equals_torch_allocate_pending_preferred_terms_refresh():
    """Pending tasks with preferred terms step on the host and refresh the
    scores between resumes: once the first lands, the second's preference
    for it acts, identically on both paths."""

    def mk(P):
        pods = []
        for i in range(2):
            pod = P.build_pod(name=f"pair{i}", group_name=f"pg{i}", req=P.build_resource_list(cpu=1, memory="1Gi"),
                              labels={"pack": "yes"})
            pod.affinity = P.Affinity(
                pod_affinity_preferred=[(8, P.PodAffinityTerm({"pack": "yes"}, "kubernetes.io/hostname"))])
            pods.append(pod)
        pods.append(P.build_pod(name="plain", group_name="pg2", req=P.build_resource_list(cpu=1, memory="1Gi")))
        nodes = [P.build_node(f"n{i}", P.build_resource_list(cpu=4, memory="8Gi", pods=10)) for i in range(3)]
        pgs = [P.build_pod_group(f"pg{i}", min_member=1) for i in range(3)]
        return P.build_cluster(pods, nodes, pgs, [P.build_queue("default")])

    assert_equivalent(mk, host_steps=2)


def test_preempt_parity_with_interpod_active():
    """torch_preempt with interpod live must match the serial preempt
    exactly, and the JAX preempt."""

    def mk(P):
        victims = [P.build_pod(name=f"low{i}", group_name="low", req=P.build_resource_list(cpu=1, memory="512Mi"),
                               node_name=f"n{i}", phase=P.PodPhase.RUNNING, priority=1, labels={"kind": "victim"})
                   for i in range(2)]
        hi = P.build_pod(name="hi", group_name="hi", req=P.build_resource_list(cpu=1, memory="512Mi"), priority=9)
        hi.affinity = P.Affinity(
            pod_affinity_preferred=[(2, P.PodAffinityTerm({"kind": "victim"}, "kubernetes.io/hostname"))])
        nodes = [P.build_node(f"n{i}", P.build_resource_list(cpu=1, memory="1Gi", pods=5)) for i in range(2)]
        return P.build_cluster(victims + [hi], nodes, [P.build_pod_group("low", min_member=1),
                                                       P.build_pod_group("hi", min_member=1)],
                               [P.build_queue("default")])

    def evicts(P, action):
        cache = P.FakeCache(mk(P))
        ssn = P.open_session(cache, P.parse(PREEMPT_TIERS).tiers)
        P.get_action(action).execute(ssn)
        out = list(cache.evictor.evicts)
        P.close_session(ssn)
        return out

    with x64_enabled(False):
        ref = evicts(JAX, "preempt")
    got = evicts(PORT, "torch_preempt")
    assert got == evicts(PORT, "preempt") == ref
    assert got
