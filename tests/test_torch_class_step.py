"""Kernel B3 (csrc/class_step.cu) and its plain version, the port's side
alone: this file imports no jax, so it runs on a card's machine too
(``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_class_step.py``; chip_smoke.py's card tests).

It holds the seeded segment inputs (``SEGMENT_CASES``: entry and
mid-solve states, ``blocks`` 1, 2 and 4, an overflow, pauses, drf and
proportion) that tests/test_torch_class_solve.py holds against the JAX
package's ``_class_step``; the kernel's argument block against its CUDA
struct; the kernel's launch geometry and packed task rows; the solver's
in-place segments against the functional path; and, on a card, kernel B3
against ``class_step_plain`` on every case, field for field (integers
exactly, floats bit for bit), the in-place launch against the functional
one, and warm churn sessions that build B3 once.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401
import kube_batch_tpu_torch.plugins  # noqa: F401
from kube_batch_tpu_torch import models
from kube_batch_tpu_torch.actions import torch_allocate as TA
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.ops import class_solve as cs
from kube_batch_tpu_torch.ops import nvcc
from kube_batch_tpu_torch.solve import solver_arrays
from kube_batch_tpu_torch.testing import FakeCache

ENV = cs.ENV

# The reference's default conf: drf + proportion fold into the loop
# state, so the class key carries the fairness planes too.
TIERS_YAML = """
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


class _Env:
    """KBT_CLASS_COMPRESS set for the block, restored after (``on`` None:
    left as it is). The environment is the process's: threads that run
    sessions at once set it once around all of them, not each their own."""

    def __init__(self, on: bool | None) -> None:
        self.on = on

    def __enter__(self):
        self.saved = os.environ.get(ENV)
        if self.on is not None:
            os.environ[ENV] = "1" if self.on else "0"

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = self.saved


def run_port(cluster, compress, mesh=None, action=None, tiers=TIERS_YAML):
    """One torch_allocate session on the CPU; ``compress`` None leaves
    KBT_CLASS_COMPRESS as the caller set it."""
    with _Env(compress):
        action = action or TA.TorchAllocateAction()
        args = {"device": "cpu", "min_device_pairs": "0"}
        if mesh:
            args["mesh"] = mesh
        cache = FakeCache(cluster)
        ssn = open_session(cache, parse_scheduler_conf(tiers).tiers, {"torch_allocate": args})
        try:
            action.execute(ssn)
        finally:
            close_session(ssn)
        return dict(cache.binder.binds), action

def _affinity_world(P):
    """test_class_solve's pause/resume world with a duplicated node pool:
    4 byte-identical nodes (one diverges by carrying the anchor), two
    pod-affinity host-only tasks forcing two pause/resume trips."""
    T = P.testing
    types = P.types
    anchor = T.build_pod(
        name="anchor", node_name="n0", phase=types.PodPhase.RUNNING,
        req=T.build_resource_list(cpu=1, memory="128Mi"), labels={"app": "db"},
    )
    pods, groups = [anchor], []
    for i in range(12):
        p = T.build_pod(name=f"p{i}", group_name=f"g{i}", req=T.build_resource_list(cpu=1, memory="256Mi"))
        p.metadata.creation_timestamp = float(i)
        if i in (4, 9):
            p.affinity = types.Affinity(
                pod_affinity_required=[types.PodAffinityTerm(label_selector={"app": "db"})]
            )
        pg = T.build_pod_group(f"g{i}", min_member=1)
        pg.metadata.creation_timestamp = float(i)
        pods.append(p)
        groups.append(pg)
    nodes = [T.build_node(f"n{i}", T.build_resource_list(cpu=8, memory="8Gi", pods=20)) for i in range(4)]
    return T.build_cluster(pods, nodes, groups, [T.build_queue("default")])


class _Pkg:
    def __init__(self, testing, types):
        self.testing, self.types = testing, types


def _port_pkg():
    import kube_batch_tpu_torch.apis.types as types
    import kube_batch_tpu_torch.testing as testing

    return _Pkg(testing, types)

def _churn_world(salt):
    return models.uniform_pool(800, 100, churn=0.02, churn_salt=salt)

# -- seeded segment inputs ---------------------------------------------------

def _contended_world():
    from kube_batch_tpu_torch.testing import gen_contended_cluster

    return gen_contended_cluster(3)


# name -> (world, drf, proportion, seed, advance, blocks, budget, cpad cut)
SEGMENT_CASES = {
    "smoke_entry_b1": (lambda: cs._smoke_world(), True, True, 0, 0, 1, 64, False),
    "smoke_mid_b1": (lambda: cs._smoke_world(arrivals=12), True, True, 1, 9, 1, 64, False),
    "smoke_mid_b2": (lambda: cs._smoke_world(arrivals=12), True, True, 2, 17, 2, 64, False),
    "smoke_mid_b4": (lambda: cs._smoke_world(arrivals=12), True, True, 3, 5, 4, 64, False),
    "smoke_no_fair_share": (lambda: cs._smoke_world(seed=11), False, False, 4, 3, 1, 64, False),
    "smoke_overflow": (lambda: cs._smoke_world(), True, True, 5, 0, 1, 64, True),
    "affinity_pause_b1": (lambda: _affinity_world(_port_pkg()), True, True, 6, 0, 1, 64, False),
    "affinity_pause_b2": (lambda: _affinity_world(_port_pkg()), True, True, 7, 0, 2, 64, False),
    "contended_drf_proportion": (_contended_world, True, True, 8, 2, 1, 32, False),
    "uniform_pool_churn_b4": (lambda: _churn_world(1), True, True, 9, 40, 4, 96, False),
}


def _segment_inputs(world, drf, prop, seed, advance, cpad_cut):
    """A segment's inputs from a seeded state: the world's entry state with
    a random fifth of its jobs retired, packed, advanced ``advance``
    iterations (plain), and with ``cpad_cut`` the slot axis cut to its live
    slots, so the first split overflows."""
    return _segment_solver(world, drf, prop, seed, advance, cpad_cut)[1:]


def _segment_solver(world, drf, prop, seed, advance, cpad_cut):
    """``_segment_inputs`` with the solver that packed them first (its
    member list and table, which a re-bucket reads)."""
    _, arrays = solver_arrays(world(), drf, prop)
    solver = cs.ClassCompressedSolver(cs.ClassTable(), arrays, drf, prop)
    st = solver._init_node_state()
    rng = np.random.default_rng(seed)
    active = st.job_active.numpy().copy()
    live = np.flatnonzero(active)
    if live.size > 4:
        active[rng.choice(live, size=live.size // 5, replace=False)] = False
    st = st._replace(job_active=torch.from_numpy(active))
    state = solver._pack(st)
    ca = solver._ca()
    if advance:
        state = cs.class_step_plain(ca, state, drf, prop, advance)
    if cpad_cut:
        fp = int(state.free_ptr)
        cut = {f: getattr(state, f)[:fp].clone() for f in (
            "cidle", "crel", "cused", "cntasks", "cnports", "calloc", "cok", "cmax_tasks",
            "cidle_has_sc", "crel_has_sc", "cgid", "cmult", "ctie", "cpos")}
        cut["cpod_sc"] = state.cpod_sc[:, :fp].clone()
        state = state._replace(**cut)
    return solver, ca, state

def assert_state_equal(want, got, where=""):
    """Every ClassSolveState field equal: integers and booleans exactly,
    floats bit for bit."""
    for f in cs.ClassSolveState._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, (where, f, w.shape, g.shape, w.dtype, g.dtype)
        if w.dtype.kind == "f":
            assert np.array_equal(w.view(np.uint32), g.view(np.uint32)), (where, f)
        else:
            assert np.array_equal(w, g), (where, f)

# -- the kernel's argument block ---------------------------------------------


def test_class_args_mirror_the_kernel_struct():
    """ops/class_solve._Args lists struct ClassArgs' fields in
    csrc/class_step.cu's order, with the same kinds (int, float, pointer)."""
    src = open(os.path.join(nvcc.CSRC_DIR, "class_step.cu")).read()
    body = re.search(r"struct ClassArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.match(r"(const\s+)?(int|float|u8)\s*(.*);", line)
        assert m, line
        for name in m.group(3).split(","):
            name = name.strip()
            kind = "ptr" if name.startswith("*") else m.group(2)
            fields.append((name.lstrip("* "), kind))
    kinds = {cs.ctypes.c_int: "int", cs.ctypes.c_float: "float", cs.ctypes.c_void_p: "ptr"}
    assert fields == [(n, kinds[t]) for n, t in cs._Args._fields_]


def test_geometry_takes_shared_memory_up_to_its_budget():
    assert cs.geometry(8, 1, 2) == (128, 4 * (20 * 8 + 12), True)
    threads, nbytes, smem = cs.geometry(1024, 1, 4)
    assert (threads, smem) == (256, True) and nbytes == 4 * (26 * 1024 + 18)
    assert cs.geometry(4096, 1, 4)[2] is False  # past the budget: global scratch
    assert cs.geometry(5000, 2, 2)[0] == cs.MAX_THREADS  # more slots a thread past 1,024


@pytest.mark.parametrize("GT", [1, 2])
def test_geometry_counts_the_staged_group_tables(GT):
    """The working state holds, per slot, the resource rows, 11 words of
    cursors and statics, and three staged words per task group (compat,
    affinity, pod affinity); per job 9 words and its drf row; per queue 6
    words and three rows. Config 7's segment (1,024 slots, R = 2, 1,600
    jobs, two queues) sits in shared memory on 256 threads, four slots a
    thread; its 4,096-slot padding falls to the global form, as do a group
    table and a job table too wide for the budget."""
    assert cs.slot_words(2, GT) == 3 * 2 + 11 + 3 * GT
    assert (cs.job_words(2), cs.queue_words(2)) == (11, 12)
    threads, nbytes, smem = cs.geometry(1024, 2, 2, GT, 1600)
    assert (threads, smem) == (256, True)
    assert nbytes == 4 * (cs.slot_words(2, GT) * 1024 + 11 * 1600 + 12 * 2) <= cs.SMEM_BUDGET
    assert -(-1024 // threads) == cs.SLOTS_PER_THREAD
    threads, nbytes, smem = cs.geometry(4096, 2, 2, GT, 1600)
    assert (threads, smem) == (cs.MAX_THREADS, False)
    wide = cs.SMEM_BUDGET // (4 * 3 * 1024) + 1  # groups whose tables alone pass the budget at 1,024 slots
    assert cs.geometry(1024, 2, 2, wide)[2] is False
    many = cs.SMEM_BUDGET // (4 * cs.job_words(2)) + 1  # jobs whose table alone passes the budget
    assert cs.geometry(128, 2, 2, GT, many)[2] is False
    assert cs.geometry(128, 1, 2, GT) == (128, 4 * (cs.slot_words(2, GT) * 128 + 12), True)


@pytest.mark.parametrize("case", ["smoke_mid_b1", "affinity_pause_b1", "uniform_pool_churn_b4"])
def test_pack_tasks_holds_every_task_row_the_kernel_reads(case):
    """Kernel B3's packed task rows: each row's request and resource rows
    bit for bit, its group, its three flags and its host-port bitmask,
    padded to 16 bytes."""
    world, drf, prop, seed, advance, blocks, budget, cpad_cut = SEGMENT_CASES[case]
    ca, _ = _segment_inputs(world, drf, prop, seed, advance, cpad_cut)
    pack = cs.pack_tasks(ca)
    T, R = ca["task_req"].shape
    P = ca["task_ports"].shape[1]
    assert pack.dtype == torch.int32 and pack.shape == (T, cs.task_words(R)) and cs.task_words(R) % 4 == 0
    assert torch.equal(pack[:, :R], ca["task_req"].view(torch.int32))
    assert torch.equal(pack[:, R : 2 * R], ca["task_res"].view(torch.int32))
    assert torch.equal(pack[:, 2 * R], ca["task_gid"].to(torch.int32))
    flags = pack[:, 2 * R + 1]
    assert torch.equal((flags & 1) != 0, ca["task_has_sc"])
    assert torch.equal((flags & 2) != 0, ca["task_res_has_sc"])
    assert torch.equal((flags & 4) != 0, ca["task_host_only"]) and not bool((flags & ~7).any())
    ports = pack[:, 2 * R + 2]
    for p in range(P):
        assert torch.equal(((ports >> p) & 1) != 0, ca["task_ports"][:, p])
    assert not bool((pack[:, 2 * R + 3 :] != 0).any())
    if case.startswith("affinity"):
        assert bool((flags & 4).any())  # the host-only tasks the pause reads


def _segment_loop(solver, ca, state, budget, drf, prop, functional):
    """The solver's segment loop on one segment's inputs, re-bucketing on
    overflow: through ``solver._segment`` (the in-place path: a
    ``ClassLaunch`` a state, the state updated where it lies), or with
    ``functional`` through ``class_step`` (a new state a launch). Returns
    the final state and the re-buckets."""
    solver._max_iter = cs.max_iterations(ca)
    rebuckets = 0
    while True:
        if functional:
            out = cs.class_step(ca, state, drf, prop, budget, solver._max_iter)
        else:
            out = solver._segment(ca, state, budget)
            assert out is state
        if bool(out.overflow):
            state = solver._rebucket(out)
            rebuckets += 1
            continue
        return out, rebuckets


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_in_place_segments_equal_the_functional_path(case):
    """The solver's in-place segment path equals the functional
    ``class_step`` path on every ClassSolveState field (on the CPU through
    the plain version), across a re-bucket where the cut slot axis
    overflows; the functional path leaves its input as it was."""
    world, drf, prop, seed, advance, blocks, budget, cpad_cut = SEGMENT_CASES[case]
    solver, ca, state = _segment_solver(world, drf, prop, seed, advance, cpad_cut)
    entry = cs.ClassSolveState(*(x.clone() for x in state))
    want, rebuckets_f = _segment_loop(solver, ca, state, budget, drf, prop, functional=True)
    assert_state_equal(entry, state, f"{case} input")
    solver2, ca2, state2 = _segment_solver(world, drf, prop, seed, advance, cpad_cut)
    got, rebuckets = _segment_loop(solver2, ca2, state2, budget, drf, prop, functional=False)
    assert rebuckets == rebuckets_f
    assert_state_equal(want, got, case)
    if cpad_cut:
        assert rebuckets >= 1 and int(got.free_ptr) > int(entry.free_ptr)

def test_class_step_refuses_inputs_as_a_kernel_error():
    """class_step's own refusals (a device it cannot run on, here the meta
    device) raise ClassKernelError, which the action raises as its
    DeviceSolveError instead of degrading."""
    ca, state = _segment_inputs(lambda: cs._smoke_world(), True, True, 0, 0, False)
    meta = cs.ClassSolveState(*(x.to("meta") for x in state))
    with pytest.raises(cs.ClassKernelError, match="meta"):
        cs.class_step(ca, meta, True, True, 64, cs.max_iterations(ca))


def test_grow_slots_pads_with_dead_slots_and_keeps_the_segment():
    """A segment on a slot axis padded past its bucket (the re-bucket's
    layout, as the card's global-memory form sees it) equals the unpadded
    one on every live slot, and its pad stays dead."""
    ca, state = _segment_inputs(lambda: cs._smoke_world(arrivals=12), True, True, 1, 9, False)
    C = int(state.cmult.shape[0])
    want = cs.class_step_plain(ca, state, True, True, 64)
    got = cs.class_step_plain(ca, cs.grow_slots(state, 4 * C), True, True, 64)
    assert not bool(want.overflow) and int(want.it) > int(state.it)
    pad = cs.grow_slots(want, 4 * C)
    for f in cs.ClassSolveState._fields:
        g = getattr(got, f)
        if f in cs.SLOT_FIELDS:
            assert torch.equal(g[..., C:] if f == "cpod_sc" else g[C:], (
                pad.cpod_sc[:, C:] if f == "cpod_sc" else getattr(pad, f)[C:])), f
            g = g[:, :C] if f == "cpod_sc" else g[:C]
        assert torch.equal(getattr(want, f), g), f


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_warm_churn_sessions_on_the_card_build_b3_once():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel B3 has no CPU mode")
    action = TA.TorchAllocateAction()
    cuda_args = {"torch_allocate": {"device": "cuda:0", "min_device_pairs": "0"}}
    builds = nvcc.builds
    pads = []
    for salt in range(4):
        with _Env(True):
            cache = FakeCache(_churn_world(salt))
            ssn = open_session(cache, parse_scheduler_conf(TIERS_YAML).tiers, cuda_args)
            action.execute(ssn)
            close_session(ssn)
        plain, _ = run_port(_churn_world(salt), compress=False)
        assert dict(cache.binder.binds) == plain
        assert action.last_solver_tier == "class_fused"
        pads.append(action.last_class_stats["c_pad"])
        if salt == 0:
            builds = nvcc.builds  # the first session may build B3 (and B1 is not packed)
    assert nvcc.builds == builds and len(set(pads)) == 1

# -- kernel B3 on the card ---------------------------------------------------


def _b3_against_plain(case, cpad=None):
    """Kernel B3 against class_step_plain on one segment case (its slot
    axis padded to ``cpad`` dead slots when given), every field equal;
    returns the inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel B3 has no CPU mode")
    world, drf, prop, seed, advance, blocks, budget, cpad_cut = SEGMENT_CASES[case]
    ca, state = _segment_inputs(world, drf, prop, seed, advance, cpad_cut)
    if cpad is not None:
        state = cs.grow_slots(state, cpad)
    want = cs.class_step_plain(ca, state, drf, prop, budget)
    dev = torch.device("cuda", 0)
    dca = {k: (v if isinstance(v, float) else v.to(dev)) for k, v in ca.items()}
    dstate = cs.ClassSolveState(*(x.to(dev) for x in state))
    launches = cs.class_step.launches
    got = cs.class_step(dca, dstate, drf, prop, budget, cs.max_iterations(ca))
    torch.cuda.synchronize()
    assert cs.class_step.launches == launches + 1
    assert_state_equal(want, cs.ClassSolveState(*(x.cpu() for x in got)), f"{case} c_pad {state.cmult.shape[0]}")
    return ca, state


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_class_step_on_the_card_equals_plain(case):
    _b3_against_plain(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_in_place_launch_on_the_card_equals_the_functional_launch(case):
    """Kernel B3 launched in place (``class_step_inplace``, twice over one
    prepared ``ClassLaunch`` on two budgets) equals the functional launch
    bit for bit, and the solver's segment loop on the card equals the
    functional one across a re-bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel B3 has no CPU mode")
    world, drf, prop, seed, advance, blocks, budget, cpad_cut = SEGMENT_CASES[case]
    solver, ca, state = _segment_solver(world, drf, prop, seed, advance, cpad_cut)
    dev = torch.device("cuda", 0)
    dca = {k: (v if isinstance(v, float) else v.to(dev)) for k, v in ca.items()}
    dstate = cs.ClassSolveState(*(x.to(dev) for x in state))
    max_iter = cs.max_iterations(ca)
    want = cs.class_step(dca, dstate, drf, prop, budget, max_iter)
    mine = cs.ClassSolveState(*(x.clone() for x in dstate))
    assert cs.class_step_inplace(dca, mine, drf, prop, budget, max_iter) is mine
    torch.cuda.synchronize()
    assert_state_equal(cs.ClassSolveState(*(x.cpu() for x in want)), cs.ClassSolveState(*(x.cpu() for x in mine)),
                       case)
    # one launch prepared once, two budgets: a short segment, then the rest
    two = cs.ClassSolveState(*(x.clone() for x in dstate))
    launch = cs.ClassLaunch(dca, two, drf, prop, 3, max_iter)
    launch.launch()
    first = cs.class_step(dca, dstate, drf, prop, 3, max_iter)
    torch.cuda.synchronize()
    assert_state_equal(cs.ClassSolveState(*(x.cpu() for x in first)), cs.ClassSolveState(*(x.cpu() for x in two)),
                       f"{case} budget 3")
    if not bool(two.overflow):
        launch.set_budget(budget)
        launch.launch()
        rest = cs.class_step(dca, first._replace(seg_it=torch.zeros_like(first.seg_it)), drf, prop, budget, max_iter)
        torch.cuda.synchronize()
        assert_state_equal(cs.ClassSolveState(*(x.cpu() for x in rest)), cs.ClassSolveState(*(x.cpu() for x in two)),
                           f"{case} budget 3 then {budget}")
    # the solver's loop on the card, in place and across a re-bucket
    solver.device = dev
    got, rebuckets = _segment_loop(solver, dca, cs.ClassSolveState(*(x.clone() for x in dstate)), budget, drf, prop,
                                   functional=False)
    ref, _ = _segment_loop(solver, ca, state, budget, drf, prop, functional=True)
    assert_state_equal(ref, cs.ClassSolveState(*(x.cpu() for x in got)), f"{case} solver loop")


# Slot axes past 1,024 (a thread owns several slots; at 4,096 and R = 2 past
# the shared-memory budget too), and every case with that budget at 0: the
# working state in global memory.
WIDE_CASES = ("smoke_mid_b1", "affinity_pause_b1", "contended_drf_proportion", "uniform_pool_churn_b4")


@pytest.mark.cuda
@pytest.mark.parametrize("case,form", [(c, "global") for c in sorted(SEGMENT_CASES)] + [
    (c, cpad) for c in WIDE_CASES for cpad in (2048, 4096)])
def test_class_step_past_1024_slots_or_shared_memory_equals_plain(monkeypatch, case, form):
    if form == "global":
        monkeypatch.setattr(cs, "SMEM_BUDGET", 0)
    ca, state = _b3_against_plain(case, None if form == "global" else form)
    C, Q, R = int(state.cmult.shape[0]), int(ca["queue_rank"].shape[0]), int(ca["task_req"].shape[1])
    threads, _, in_smem = cs.geometry(C, Q, R, int(ca["compat"].shape[0]), int(ca["job_min"].shape[0]))
    if form == "global" or (form == 4096 and R == 2):
        assert not in_smem
    if form != "global":
        assert threads == cs.MAX_THREADS < C
