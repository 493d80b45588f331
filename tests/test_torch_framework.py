"""The port's tiered plugin dispatch and ``Statement`` transactions
(kube_batch_tpu_torch/framework/), case for case with tests/test_framework.py.

Every JAX case keeps its name and its assertions and runs on both
packages: each case is a function of the package's namespace (its conf
types, framework, testing builders and a recording plugin registered in
that package's registry) that checks the reference's expectation and
returns what it read as plain values, and the test asserts the two
packages read the same. The sixteen cases: the four order-dispatch cases,
predicate and score dispatch, the four victim-intersection cases, the
three validate-dispatch cases, and ``Statement`` discard, commit and its
event handlers. No JAX case is left out.
"""

from __future__ import annotations

import types
from importlib import import_module

import pytest


def _ns(root: str) -> types.SimpleNamespace:
    api_types = import_module(f"{root}.api.types")
    conf = import_module(f"{root}.conf")
    fw = import_module(f"{root}.framework")
    t = import_module(f"{root}.testing")
    apis = import_module(f"{root}.apis.types")
    return types.SimpleNamespace(
        root=root, TaskStatus=api_types.TaskStatus, ValidateResult=api_types.ValidateResult,
        PluginOption=conf.PluginOption, Tier=conf.Tier, apply_plugin_conf_defaults=conf.apply_plugin_conf_defaults,
        EventHandler=fw.EventHandler, Plugin=fw.Plugin, cleanup_plugin_builders=fw.cleanup_plugin_builders,
        open_session=fw.open_session, register_plugin_builder=fw.register_plugin_builder, PodPhase=apis.PodPhase,
        FakeCache=t.FakeCache, build_cluster=t.build_cluster, build_node=t.build_node, build_pod=t.build_pod,
        build_pod_group=t.build_pod_group, build_queue=t.build_queue, build_resource_list=t.build_resource_list,
        build_task=t.build_task,
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")


def both(case):
    ref, got = case(JAX), case(PORT)
    assert got == ref


@pytest.fixture(autouse=True)
def _clean_registry():
    yield
    for P in (JAX, PORT):
        P.cleanup_plugin_builders()
        # the built-ins again, for other test modules
        import_module(f"{P.root}.plugins.factory").register_all_plugins()


def make_tier(P, *names):
    options = []
    for name in names:
        opt = P.PluginOption(name=name)
        P.apply_plugin_conf_defaults(opt)
        options.append(opt)
    return P.Tier(plugins=options)


def recording_plugin(P, name, fns):
    """A plugin of ``P``'s framework that registers the fns a test hands it."""

    class RecordingPlugin(P.Plugin):
        @property
        def name(self):
            return name

        def on_session_open(self, ssn):
            for kind, fn in fns.items():
                getattr(ssn, f"add_{kind}")(name, fn)

    return RecordingPlugin()


def open_with(P, plugins, tiers, cluster=None):
    for name, fns in plugins.items():
        P.register_plugin_builder(name, lambda args, name=name, fns=fns: recording_plugin(P, name, fns))
    cache = P.FakeCache(cluster or P.build_cluster([], []))
    return P.open_session(cache, tiers)


def two_job_cluster(P):
    pods = [
        P.build_pod(name="p1", group_name="j1", req=P.build_resource_list(cpu=1)),
        P.build_pod(name="p2", group_name="j2", req=P.build_resource_list(cpu=1)),
    ]
    groups = [P.build_pod_group("j1"), P.build_pod_group("j2")]
    nodes = [P.build_node("n1", P.build_resource_list(cpu=4, memory="4Gi", pods=10))]
    return P.build_cluster(pods, nodes, groups, [P.build_queue("default")])


def job(ssn, name):
    return next(j for j in ssn.jobs.values() if j.name == name)


# -- order dispatch --------------------------------------------------------------


def test_first_nonzero_across_tiers_wins():
    def case(P):
        ssn = open_with(P, {
            "a": {"job_order_fn": lambda l, r: 0},
            "b": {"job_order_fn": lambda l, r: -1 if l.name == "j2" else 1},
        }, [make_tier(P, "a"), make_tier(P, "b")], two_job_cluster(P))
        j1, j2 = job(ssn, "j1"), job(ssn, "j2")
        got = (ssn.job_order_fn(j2, j1), ssn.job_order_fn(j1, j2))
        assert got == (True, False)
        return got

    both(case)


def test_earlier_tier_shadow_later():
    def case(P):
        ssn = open_with(P, {
            "a": {"job_order_fn": lambda l, r: -1 if l.name == "j1" else 1},
            "b": {"job_order_fn": lambda l, r: -1 if l.name == "j2" else 1},
        }, [make_tier(P, "a"), make_tier(P, "b")], two_job_cluster(P))
        got = ssn.job_order_fn(job(ssn, "j1"), job(ssn, "j2"))
        assert got is True
        return got

    both(case)


def test_fallback_creation_time_then_uid():
    def case(P):
        cluster = two_job_cluster(P)
        jobs = list(cluster.jobs.values())
        jobs[0].creation_timestamp = 100.0
        jobs[1].creation_timestamp = 50.0
        ssn = open_with(P, {}, [], cluster)
        younger = next(j for j in ssn.jobs.values() if j.creation_timestamp == 50.0)
        older = next(j for j in ssn.jobs.values() if j.creation_timestamp == 100.0)
        assert ssn.job_order_fn(younger, older) is True
        # equal timestamps: the UID decides
        older.creation_timestamp = 50.0
        lo, hi = sorted([younger, older], key=lambda j: j.uid)
        got = (ssn.job_order_fn(lo, hi), ssn.job_order_fn(hi, lo))
        assert got == (True, False)
        return younger.name, lo.name, got

    both(case)


def test_disabled_flag_skips_plugin():
    def case(P):
        tier = P.Tier(plugins=[P.PluginOption(name="a", enabled_job_order=False)])
        P.apply_plugin_conf_defaults(tier.plugins[0])
        ssn = open_with(P, {"a": {"job_order_fn": lambda l, r: -1 if l.name == "j2" else 1}}, [tier],
                        two_job_cluster(P))
        j1, j2 = job(ssn, "j1"), job(ssn, "j2")
        j1.creation_timestamp = 1.0
        j2.creation_timestamp = 2.0
        # the plugin would favour j2, but it is disabled: creation time wins
        got = ssn.job_order_fn(j1, j2)
        assert got is True
        return got

    both(case)


# -- predicate and score dispatch -------------------------------------------------


def test_predicates_and_semantics():
    def case(P):
        calls = []

        def ok(task, node):
            calls.append("ok")

        def fail(task, node):
            raise RuntimeError("nope")

        ssn = open_with(P, {"a": {"predicate_fn": ok}, "b": {"predicate_fn": fail}}, [make_tier(P, "a", "b")],
                        two_job_cluster(P))
        task = next(iter(next(iter(ssn.jobs.values())).tasks.values()))
        node = next(iter(ssn.nodes.values()))
        with pytest.raises(RuntimeError):
            ssn.predicate_fn(task, node)
        assert calls == ["ok"]  # AND short-circuits at the first failure
        return calls

    both(case)


def test_node_order_sums_across_plugins():
    def case(P):
        ssn = open_with(P, {
            "a": {"node_order_fn": lambda t, n: 3.0},
            "b": {"node_order_fn": lambda t, n: 4.0},
        }, [make_tier(P, "a"), make_tier(P, "b")], two_job_cluster(P))
        task = next(iter(next(iter(ssn.jobs.values())).tasks.values()))
        got = ssn.node_order_fn(task, next(iter(ssn.nodes.values())))
        assert got == 7.0
        return got

    both(case)


# -- victim dispatch -------------------------------------------------------------


def victims_of(P, plugin_victims, tiers, cand_names):
    ssn = open_with(P, {name: {"preemptable_fn": picker} for name, picker in plugin_victims.items()}, tiers,
                    two_job_cluster(P))
    cands = [P.build_task(name=n) for n in cand_names]
    return [v.name for v in ssn.preemptable(P.build_task(name="p"), cands)]


def test_intersection_within_tier():
    def case(P):
        got = victims_of(P, {
            "a": lambda p, cands: [c for c in cands if c.name in ("v1", "v2")],
            "b": lambda p, cands: [c for c in cands if c.name in ("v2", "v3")],
        }, [make_tier(P, "a", "b")], ("v1", "v2", "v3"))
        assert got == ["v2"]
        return got

    both(case)


def test_empty_tier_result_falls_through():
    def case(P):
        got = victims_of(P, {"a": lambda p, cands: [], "b": lambda p, cands: list(cands)},
                         [make_tier(P, "a"), make_tier(P, "b")], ("v1",))
        assert got == ["v1"]
        return got

    both(case)


def test_empty_intersection_falls_through():
    def case(P):
        got = victims_of(P, {
            "a": lambda p, cands: [c for c in cands if c.name == "v1"],
            "b": lambda p, cands: [c for c in cands if c.name == "v2"],
            "c": lambda p, cands: list(cands),
        }, [make_tier(P, "a", "b"), make_tier(P, "c")], ("v1", "v2"))
        assert sorted(got) == ["v1", "v2"]
        return sorted(got)

    both(case)


def test_tier_without_fns_defers():
    def case(P):
        got = victims_of(P, {"b": lambda p, cands: list(cands)}, [make_tier(P, "a"), make_tier(P, "b")], ("v1",))
        assert got == ["v1"]
        return got

    both(case)


# -- validate dispatch -----------------------------------------------------------


def test_job_valid_first_failure():
    def case(P):
        ssn = open_with(P, {
            "a": {"job_valid_fn": lambda job: None},
            "b": {"job_valid_fn": lambda job: P.ValidateResult(False, "r", "m") if job.name == "j2" else None},
        }, [make_tier(P, "a", "b")], two_job_cluster(P))
        # j2 was rejected at session open and removed (the gate)
        got = sorted(j.name for j in ssn.jobs.values())
        assert got == ["j1"]
        return got

    both(case)


def test_overused_or():
    def case(P):
        ssn = open_with(P, {"a": {"overused_fn": lambda q: False}, "b": {"overused_fn": lambda q: True}},
                        [make_tier(P, "a", "b")], two_job_cluster(P))
        got = ssn.overused(next(iter(ssn.queues.values())))
        assert got is True
        return got

    both(case)


def test_job_ready_and():
    def case(P):
        ssn = open_with(P, {"a": {"job_ready_fn": lambda j: True}, "b": {"job_ready_fn": lambda j: False}},
                        [make_tier(P, "a", "b")], two_job_cluster(P))
        got = ssn.job_ready(next(iter(ssn.jobs.values())))
        assert got is False
        return got

    both(case)


# -- Statement -------------------------------------------------------------------


def running_cluster(P):
    pods = [
        P.build_pod(name="victim", group_name="jv", req=P.build_resource_list(cpu=1), node_name="n1"),
        P.build_pod(name="starved", group_name="js", req=P.build_resource_list(cpu=1)),
    ]
    pods[0].phase = P.PodPhase.RUNNING
    groups = [P.build_pod_group("jv"), P.build_pod_group("js")]
    nodes = [P.build_node("n1", P.build_resource_list(cpu=1, memory="1Gi", pods=10))]
    return P.build_cluster(pods, nodes, groups, [P.build_queue("default")])


def test_discard_restores_session_state():
    def case(P):
        ssn = open_with(P, {}, [], running_cluster(P))
        victim = next(iter(job(ssn, "jv").tasks.values()))
        starved = next(iter(job(ssn, "js").tasks.values()))
        node = ssn.nodes["n1"]
        idle_before = node.idle.clone()
        stmt = ssn.statement()
        stmt.evict(victim, "test")
        assert victim.status == P.TaskStatus.RELEASING
        stmt.pipeline(starved, "n1")
        assert starved.status == P.TaskStatus.PIPELINED
        stmt.discard()
        assert victim.status == P.TaskStatus.RUNNING
        assert starved.status == P.TaskStatus.PENDING
        assert starved.node_name == ""
        assert node.idle == idle_before
        assert ssn.cache.evictor.evicts == []
        return victim.status.name, starved.status.name, (node.idle.milli_cpu, node.idle.memory)

    both(case)


def test_commit_replays_evictions_to_cache():
    def case(P):
        ssn = open_with(P, {}, [], running_cluster(P))
        stmt = ssn.statement()
        stmt.evict(next(iter(job(ssn, "jv").tasks.values())), "test")
        stmt.commit()
        assert ssn.cache.evictor.evicts == ["default/victim"]
        return list(ssn.cache.evictor.evicts)

    both(case)


def test_event_handlers_fire_and_unwind():
    def case(P):
        events = []
        ssn = open_with(P, {}, [], running_cluster(P))
        ssn.add_event_handler(P.EventHandler(
            allocate_func=lambda e: events.append(("alloc", e.task.name)),
            deallocate_func=lambda e: events.append(("dealloc", e.task.name)),
        ))
        stmt = ssn.statement()
        stmt.evict(next(iter(job(ssn, "jv").tasks.values())), "test")
        stmt.discard()
        assert events == [("dealloc", "victim"), ("alloc", "victim")]
        return events

    both(case)
