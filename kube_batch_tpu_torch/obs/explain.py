"""Decision observability: unschedulability forensics and placement
provenance.

Tracing (obs/__init__) answers "where did the cycle's time go"; this
module answers the operator's first question: "why didn't gang X bind,
and which single constraint relaxation would fix it?"

After every solve, each gang that still has a pending task gets a
forensics record computed from the final solver state by the batched pass
in ops/explain.py (plane elimination counts, leave-one-plane-out
would-fit-if verdicts, top-k near-miss nodes), on the device the solve ran
on; gangs that bound with no pending remainder get a light provenance
record derived from the session. The serial allocate action computes the
same records task by task through a post-action re-encode
(``explain_session``), so explain parity is pinned serial = fused =
sharded, as placement parity is. Records flow out through:

- ``/debug/explain?gang=...`` on server.py (registry snapshot and
  aggregate);
- an ``explain`` span on the cycle or micro-cycle trace carrying the
  summary, so forensics ride the flight recorder;
- the ``unschedulable_total{reason}`` and ``would_fit_if_total{plane}``
  counters;
- PodGroup Unschedulable conditions (the gang plugin swaps its generic
  reason and message for the record's at session close), which is also
  the federation's cross-shard channel: shards' commits push conditions
  through ``/backend/v1/`` into the store, and :func:`aggregate_conditions`
  folds them back together;
- an ``explain`` field on journal intent records (replay ignores unknown
  keys).

``torch_allocate`` splits the device path in two (``forensics`` and
``post_solve_records``): the batched pass and its one fetch run on the
scheduling thread before a pipelined cycle's deferred dispatch is
submitted, so the deferred closure makes no CUDA call; the records are
built and published inside the post-solve phase, after the dispatch
barrier's budget check, so an aborted cycle leaves no record.
``explain_post_solve`` runs both halves at once.

Off by default. Armed with ``KBT_EXPLAIN=1`` or the conf's ``explain:``
key, which the scheduler re-reads every cycle; when off, every entry point
is one module-bool check. ``python -m kube_batch_tpu_torch.obs.explain
[--device cpu] --json`` runs the seeded self-check: one forced-
unschedulable gang per plane, the serial, fused and sharded records equal,
reason-per-plane verdicts, and flight-recorder presence.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from typing import NamedTuple, Optional

__all__ = [
    "ENV",
    "TOP_K",
    "PLANES",
    "REASON_STARVED",
    "REASON_BOUND",
    "enabled",
    "configure",
    "records",
    "Forensics",
    "forensics",
    "post_solve_records",
    "explain_post_solve",
    "explain_session",
    "publish",
    "summary",
    "condition_message",
    "intent_payload",
    "aggregate",
    "aggregate_conditions",
    "debug_payload",
    "smoke",
    "main",
]

log = logging.getLogger(__name__)

ENV = "KBT_EXPLAIN"
TOP_K = 3

# ops.explain.PLANES, repeated so that obs consumers do not import torch
PLANES = ("static", "room", "ports", "resources")

# A gang with feasible nodes that still did not reach min_available was
# starved (queue overused, gang barrier, or another gang took the room
# first): no single plane eliminated it.
REASON_STARVED = "starved"
REASON_BOUND = "bound"

_OFF_WORDS = ("", "0", "false", "off", "no")
_enabled = False


def enabled() -> bool:
    return _enabled


def configure(spec=None) -> bool:
    """(Re)resolve the explain switch. ``spec`` is the conf's ``explain:``
    value; empty or None defers to ``KBT_EXPLAIN``."""
    global _enabled
    if spec is None or str(spec).strip() == "":
        on = os.environ.get(ENV, "").strip().lower() not in _OFF_WORDS
    else:
        on = str(spec).strip().lower() not in _OFF_WORDS
    if on != _enabled:
        log.info("explain %s", "enabled" if on else "disabled")
    _enabled = on
    return on


class _Registry:
    """Bounded per-process record store keyed by gang uid (insertion
    order is recency; re-publishing a gang moves it to the back). Serves
    /debug/explain and the journal intent payload lookup."""

    def __init__(self, max_records: int = 4096) -> None:
        self._lock = threading.Lock()
        self._records: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self.max_records = max_records

    def update(self, recs: dict) -> None:
        with self._lock:
            for uid, rec in recs.items():
                self._records.pop(uid, None)
                self._records[uid] = rec
            while len(self._records) > self.max_records:
                self._records.popitem(last=False)

    def get(self, uid: str) -> dict | None:
        with self._lock:
            return self._records.get(uid)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._records.values())

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


records = _Registry()


# -- record construction ------------------------------------------------------


def _eligible(job, queues) -> bool:
    """The encoder's job eligibility (ops/encode): Pending-phase
    PodGroups wait for enqueue and unknown queues are skipped; gangs the
    allocate actions never considered get no record."""
    from kube_batch_tpu_torch.apis.types import PodGroupPhase

    if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
        return False
    return job.queue in queues


def _forensics_record(
    job, ready, minm, task, node_names, valid_cnt, elim, feasible, would,
    nm_idx, nm_score, nm_planes, topk,
) -> dict:
    """One gang's full forensics record from the pass's outputs, shared by
    the batched and serial paths so the records are equal by construction
    (only the numbers differ per path, and those are parity-pinned in
    ops/explain)."""
    verdict = REASON_BOUND if ready >= minm else "unschedulable"
    feasible = int(feasible)
    if verdict == REASON_BOUND:
        reason = REASON_BOUND
    elif feasible > 0:
        reason = REASON_STARVED
    else:
        # Dominant reason = the cheapest single fix: among planes whose
        # solo relaxation makes some node feasible, the one eliminating the
        # fewest nodes (a selector-confined gang blocked on a port reads
        # "ports", not "static"). No single-plane fix: the largest
        # eliminator. Ties break on plane order.
        fixes = [p for p in range(len(PLANES)) if would[p]]
        if fixes:
            reason = PLANES[min(fixes, key=lambda p: (int(elim[p]), p))]
        else:
            reason = PLANES[max(range(len(PLANES)), key=lambda p: int(elim[p]))]
    near = []
    for j in range(min(int(topk), int(valid_cnt))):
        near.append(
            {
                "node": node_names[int(nm_idx[j])],
                "score": float(nm_score[j]),
                "planes": {p: bool(nm_planes[j][i]) for i, p in enumerate(PLANES)},
            }
        )
    return {
        "gang": job.uid,
        "name": f"{job.namespace}/{job.name}",
        "verdict": verdict,
        "ready": int(ready),
        "min": int(minm),
        "reason": reason,
        "task": f"{task.namespace}/{task.name}",
        "nodes": int(valid_cnt),
        "feasible": feasible,
        "eliminated": {p: int(elim[i]) for i, p in enumerate(PLANES)},
        "would_fit_if": {p: bool(would[i]) for i, p in enumerate(PLANES)},
        "near_miss": near,
    }


def _bound_record(job) -> dict:
    return {
        "gang": job.uid,
        "name": f"{job.namespace}/{job.name}",
        "verdict": REASON_BOUND,
        "ready": int(job.ready_task_num()),
        "min": int(job.min_available),
        "reason": REASON_BOUND,
    }


def _light_bound_records(ssn, skip) -> dict:
    """Provenance records for gangs with no pending remainder, from the
    session's end state (equal on every path by construction). Gangs
    below min_available with no pending task left get no record: no
    path's encode can see them."""
    out: dict = {}
    for job in ssn.jobs.values():
        if job.uid in skip or not _eligible(job, ssn.queues):
            continue
        if job.ready_task_num() >= job.min_available:
            out[job.uid] = _bound_record(job)
    return out


class Forensics(NamedTuple):
    """The device half of the post-solve forensics: the (job row,
    representative task row) pairs and the pass's outputs, fetched to
    host numpy (None when no job has a pending row)."""

    job_rows: list
    out: Optional[tuple]


def forensics(enc, arrays: dict, state, inputs=None, topk: int = TOP_K) -> Forensics:
    """The batched pass over every gang with a pending representative row
    (a row the solve left unassigned), against the final SolveState.
    ``inputs`` is ``(arrays, state fields)`` on the pass's device
    (ops/explain ``fused_inputs`` or ``uploaded_inputs``); None runs on
    the CPU over the host arrays and ``state``. Any failure raises: the
    pass is never redone elsewhere."""
    import numpy as np

    from kube_batch_tpu_torch.ops import class_solve
    from kube_batch_tpu_torch.ops import explain as ops_explain

    kinds = state.assigned_kind.numpy()
    job_rows: list[tuple[int, int]] = []
    for j in range(len(enc.jobs)):
        if not arrays["job_valid"][j]:
            continue
        js, je = int(arrays["job_start"][j]), int(arrays["job_end"][j])
        pend = np.flatnonzero(kinds[js:je] == 0)
        if pend.size:
            job_rows.append((j, js + int(pend[0])))
    if not job_rows:
        return Forensics(job_rows, None)
    if inputs is None:
        inputs = ops_explain.uploaded_inputs(arrays, state, "cpu")
    a, st = inputs
    rep_rows = ops_explain.pad_rows([r for _, r in job_rows])
    # Under KBT_CLASS_COMPRESS the pass folds the node axis the way the
    # solver does: one evaluated row per equivalence class, expanded back
    # by membership. Its outputs equal explain_batch's, so records never
    # change shape when the flag flips.
    explain_fn = ops_explain.explain_batch_classes if class_solve.enabled() else ops_explain.explain_batch
    out = explain_fn(a, *st, rep_rows, topk=topk)
    return Forensics(job_rows, tuple(x.cpu().numpy() for x in out))


def post_solve_records(ssn, enc, arrays: dict, ready_cnt, fx: Forensics, topk: int = TOP_K) -> dict:
    """The host half: records from a ``forensics`` result (``ready_cnt``
    is the final SolveState's, host numpy), plus the provenance records of
    the session's bound gangs. Runs after the replay, before the dispatch."""
    import numpy as np

    out: dict = {}
    if fx.out is not None:
        elim, feasible, would, nm_idx, nm_score, nm_planes = fx.out
        valid_cnt = int(np.asarray(arrays["node_valid"]).sum())
        for g, (j, rep) in enumerate(fx.job_rows):
            job = enc.jobs[j]
            out[job.uid] = _forensics_record(
                job, int(ready_cnt[j]), int(arrays["job_min"][j]), enc.tasks[rep],
                enc.node_names, valid_cnt, elim[g], feasible[g], would[g],
                nm_idx[g], nm_score[g], nm_planes[g], topk,
            )
    out.update(_light_bound_records(ssn, out))
    return out


def explain_post_solve(ssn, enc, arrays: dict, state, inputs=None, topk: int = TOP_K) -> dict:
    """The device path in one call: ``forensics`` then
    ``post_solve_records``."""
    fx = forensics(enc, arrays, state, inputs, topk)
    return post_solve_records(ssn, enc, arrays, state.ready_cnt.numpy(), fx, topk)


def explain_session(ssn, topk: int = TOP_K) -> dict:
    """The serial twin: re-encode the post-action session (float32, the
    device path's dtype) and compute the same records task by task with
    host numpy. Called by the serial allocate action at the end of its
    execute, covering direct serial confs and every degradation."""
    import numpy as np

    from kube_batch_tpu_torch.actions.torch_allocate import _nodeorder_weights
    from kube_batch_tpu_torch.ops import explain as ops_explain
    from kube_batch_tpu_torch.ops.encode import encode_session

    # session=None: the post-action encode must not replace the encode
    # cache's task block, which is keyed to the pre-action session
    enc = encode_session(ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float32, session=None)
    out: dict = {}
    if enc.tasks:
        a = dict(enc.arrays)
        w_least, w_balanced, w_aff, _w_podaff = _nodeorder_weights(ssn)
        a["w_least"] = np.float32(w_least)
        a["w_balanced"] = np.float32(w_balanced)
        a["w_aff"] = np.float32(w_aff)
        job_rows = [(j, int(a["job_start"][j])) for j in range(len(enc.jobs)) if a["job_valid"][j]]
        elim, feasible, would, nm_idx, nm_score, nm_planes = ops_explain.explain_rows_np(
            a, a["node_idle"], a["node_rel"], a["node_used"], a["node_ntasks"], a["node_ports"],
            [r for _, r in job_rows], topk=topk,
        )
        valid_cnt = int(np.asarray(a["node_valid"]).sum())
        for g, (j, rep) in enumerate(job_rows):
            job = enc.jobs[j]
            out[job.uid] = _forensics_record(
                job, int(a["job_ready0"][j]), int(a["job_min"][j]), enc.tasks[rep],
                enc.node_names, valid_cnt, elim[g], feasible[g], would[g],
                nm_idx[g], nm_score[g], nm_planes[g], topk,
            )
    out.update(_light_bound_records(ssn, out))
    return out


# -- publication --------------------------------------------------------------


def condition_message(rec: dict) -> str:
    """The PodGroup condition message: kube-scheduler's one-line idiom
    over the dense counts ("0/40 nodes feasible: 12 static, 28 resources;
    would fit if: resources")."""
    parts = [f"{rec['eliminated'][p]} {p}" for p in PLANES if rec["eliminated"].get(p)]
    fixes = [p for p in PLANES if rec["would_fit_if"].get(p)]
    msg = (
        f"{rec['feasible']}/{rec['nodes']} nodes feasible for task "
        f"{rec['task']} ({rec['ready']}/{rec['min']} ready)"
    )
    if parts:
        msg += ": " + ", ".join(parts)
    if rec["reason"] == REASON_STARVED:
        msg += "; feasible nodes existed but the gang was starved"
    elif fixes:
        msg += "; would fit if: " + ", ".join(fixes)
    return msg


def summary(recs: dict) -> dict:
    """Flat span-attribute summary of one cycle's records (lands on the
    ``explain`` span, hence the flight recorder)."""
    reasons = collections.Counter(r["reason"] for r in recs.values() if r["verdict"] == "unschedulable")
    return {
        "gangs": len(recs),
        "bound": sum(1 for r in recs.values() if r["verdict"] == REASON_BOUND),
        "unschedulable": sum(reasons.values()),
        "reasons": ",".join(f"{k}:{v}" for k, v in sorted(reasons.items())),
    }


def publish(ssn, recs: dict) -> None:
    """Fan one cycle's records out: the session attribute (the gang plugin
    reads it), the process registry (/debug/explain, the journal) and the
    reason counters. Condition writes stay with the gang plugin at
    session close."""
    from kube_batch_tpu_torch import metrics

    ssn.explain_records = recs
    records.update(recs)
    for rec in recs.values():
        if rec["verdict"] != "unschedulable":
            continue
        metrics.register_unschedulable(rec["reason"])
        if rec.get("feasible") == 0:
            for plane, flip in rec.get("would_fit_if", {}).items():
                if flip:
                    metrics.register_would_fit_if(plane)


def intent_payload(gang: str) -> dict | None:
    """The journal intent's ``explain`` payload for one gang: the compact
    decision label (the full record joins by gang uid from the registry)."""
    rec = records.get(gang)
    if rec is None:
        return None
    return {
        "verdict": rec["verdict"],
        "reason": rec["reason"],
        "ready": rec["ready"],
        "min": rec["min"],
    }


# -- aggregation (shard-local and cross-shard) --------------------------------


def aggregate(recs) -> dict:
    """Reason and plane histogram over an iterable of records."""
    out = {
        "gangs": 0,
        "bound": 0,
        "unschedulable": 0,
        "reasons": collections.Counter(),
        "would_fit_if": collections.Counter(),
    }
    for rec in recs:
        out["gangs"] += 1
        if rec["verdict"] == REASON_BOUND:
            out["bound"] += 1
            continue
        out["unschedulable"] += 1
        out["reasons"][rec["reason"]] += 1
        if rec.get("feasible") == 0:
            for plane, flip in rec.get("would_fit_if", {}).items():
                if flip:
                    out["would_fit_if"][plane] += 1
    out["reasons"] = dict(sorted(out["reasons"].items()))
    out["would_fit_if"] = dict(sorted(out["would_fit_if"].items()))
    return out


def aggregate_conditions(pod_groups) -> dict:
    """Cross-shard aggregate over PodGroup Unschedulable conditions, the
    surface every shard already pushes into the store: counts the latest
    Unschedulable condition per group whose reason is an explain reason."""
    from kube_batch_tpu_torch.apis.types import POD_GROUP_UNSCHEDULABLE_TYPE

    known = set(PLANES) | {REASON_STARVED}
    reasons: collections.Counter = collections.Counter()
    for pg in pod_groups:
        conds = [
            c
            for c in getattr(pg.status, "conditions", [])
            if c.type == POD_GROUP_UNSCHEDULABLE_TYPE and c.status == "True"
        ]
        if conds and conds[-1].reason in known:
            reasons[conds[-1].reason] += 1
    return {"unschedulable": sum(reasons.values()), "reasons": dict(sorted(reasons.items()))}


def debug_payload(gang: str | None = None) -> dict:
    """The /debug/explain response body. ``gang`` filters by uid,
    PodGroup name, or namespace/name."""
    recs = records.snapshot()
    if gang:
        recs = [r for r in recs if gang in (r["gang"], r["name"], r["name"].split("/", 1)[-1])]
    return {
        "enabled": _enabled,
        "records": recs,
        "aggregate": aggregate(recs),
    }


# -- seeded self-check --------------------------------------------------------


def _smoke_world():
    """One forced-unschedulable gang per feasibility plane, plus a
    bindable gang, on zone-partitioned nodes (node_selector confines each
    gang to its zone, so the designed plane is the only obstacle):

    - ``g-static``: selector matches no zone -> static;
    - ``g-resources``: wants 64 CPU on 16-CPU nodes -> resources;
    - ``g-ports``: wants host port 8080, zone-c residents hold it -> ports;
    - ``g-room``: zone-d nodes have no pod headroom left -> room;
    - ``g-bound``: fits zone-e -> a bound provenance record.
    """
    from kube_batch_tpu_torch.apis.types import PodPhase
    from kube_batch_tpu_torch.testing import (
        build_cluster,
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    nodes, pods, groups = [], [], []
    for zone in ("a", "b", "c", "d", "e"):
        for i in range(2):
            alloc = build_resource_list(cpu="16", memory="32Gi", pods="8")
            if zone == "d":
                alloc = build_resource_list(cpu="16", memory="32Gi", pods="1")
            nodes.append(build_node(f"n-{zone}-{i}", alloc, labels={"zone": zone}))

    def gang(name, zone, cpu="1", members=2, ports=None):
        groups.append(build_pod_group(name, min_member=members))
        for m in range(members):
            p = build_pod(
                name=f"{name}-{m}",
                req=build_resource_list(cpu=cpu, memory="1Gi"),
                group_name=name,
                node_selector={"zone": zone},
            )
            if ports:
                p.containers[0].ports = list(ports)
            pods.append(p)

    gang("g-static", "nowhere")
    gang("g-resources", "b", cpu="64")
    gang("g-ports", "c", ports=[8080])
    gang("g-room", "d")
    gang("g-bound", "e")
    # residents: port-8080 daemons on zone-c nodes, headroom-eaters on
    # zone-d (pods capacity 1, one resident -> no room)
    for i in range(2):
        for zone, port in (("c", 8080), ("d", None)):
            p = build_pod(
                name=f"daemon-{zone}-{i}",
                node_name=f"n-{zone}-{i}",
                phase=PodPhase.RUNNING,
                req=build_resource_list(cpu="1", memory="1Gi"),
            )
            if port:
                p.containers[0].ports = [port]
            pods.append(p)
    return build_cluster(pods, nodes, groups, [build_queue("default")])


_SMOKE_TIERS = """
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


def _smoke_run(action, action_arguments=None) -> tuple[dict, dict]:
    """Open a session over a fresh smoke world, run ``action``, return
    (records, job uid -> condition reason after close)."""
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.testing import FakeCache

    tiers = parse_scheduler_conf(_SMOKE_TIERS).tiers
    cache = FakeCache(_smoke_world())
    ssn = open_session(cache, tiers, action_arguments or {})
    try:
        action.execute(ssn)
    finally:
        jobs = dict(ssn.jobs)  # close_session clears ssn.jobs
        close_session(ssn)
    recs = dict(getattr(ssn, "explain_records", {}) or {})
    conds = {}
    for uid, job in jobs.items():
        if job.pod_group is not None and job.pod_group.status.conditions:
            conds[uid] = job.pod_group.status.conditions[-1].reason
    return recs, conds


def smoke(out_dir: str | None = None, device: str = "cuda") -> dict:
    """The seeded explain self-check (``python -m
    kube_batch_tpu_torch.obs.explain``): the serial action and
    ``torch_allocate`` on its fused rung and on its sharded rung (a mesh
    of two shards on ``device``'s type) over the per-plane world must
    produce equal records; every designed gang must carry its designed
    reason with a consistent would-fit-if verdict; and the forensics must
    ride the flight recorder as an ``explain`` span."""
    import tempfile

    import torch

    from kube_batch_tpu_torch import obs
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
    from kube_batch_tpu_torch.streaming import _check_device

    _check_device(device)
    kind = torch.device(device).type
    fused_args = {"torch_allocate": {"device": device, "min_device_pairs": "0"}}
    sharded_args = {"torch_allocate": {"device": device, "mesh": f"{kind}:2"}}
    saved = {}
    for env, value in ((ENV, "1"), (obs.ENV, "1")):
        saved[env] = os.environ.get(env)
        os.environ[env] = value
    configure()
    obs.configure()
    obs.recorder.clear()
    records.clear()
    try:
        serial_recs, serial_conds = _smoke_run(AllocateAction())
        fused = TorchAllocateAction()
        fused_recs, fused_conds = _smoke_run(fused, fused_args)
        sharded = TorchAllocateAction()
        sharded_recs, sharded_conds = _smoke_run(sharded, sharded_args)
    finally:
        for env, value in saved.items():
            if value is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = value
        configure()
        obs.configure()

    def canon(recs):
        return json.dumps(recs, sort_keys=True)

    tiers_ok = fused.last_solver_tier == "fused" and sharded.last_solver_tier == "sharded"
    parity = canon(serial_recs) == canon(fused_recs) == canon(sharded_recs)
    expected = {
        "default/g-static": "static",
        "default/g-resources": "resources",
        "default/g-ports": "ports",
        "default/g-room": "room",
        "default/g-bound": REASON_BOUND,
    }
    reasons = {uid: rec["reason"] for uid, rec in fused_recs.items()}
    reasons_ok = all(reasons.get(uid) == want for uid, want in expected.items())
    would_ok = all(
        fused_recs[uid]["feasible"] == 0 and fused_recs[uid]["would_fit_if"][plane]
        for uid, plane in expected.items()
        if plane in PLANES and uid in fused_recs
    )
    conds_ok = all(
        conds.get(uid) == want
        for conds in (serial_conds, fused_conds, sharded_conds)
        for uid, want in expected.items()
        if want != REASON_BOUND
    )
    spans = obs.recorder.spans()
    explain_spans = [s for s in spans if s["name"] == "explain"]
    recorded = any(s["attrs"].get("unschedulable", 0) > 0 for s in explain_spans)

    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "kbt-explain-smoke")
    os.makedirs(out_dir, exist_ok=True)
    dump = os.path.join(out_dir, "explain.json")
    with open(dump, "w", encoding="utf-8") as f:
        json.dump(
            {"serial": serial_recs, "fused": fused_recs, "sharded": sharded_recs},
            f, sort_keys=True, indent=1,
        )

    return {
        "device": device,
        "gangs": len(fused_recs),
        "tiers": [fused.last_solver_tier, sharded.last_solver_tier],
        "parity": parity,
        "reasons": dict(sorted(reasons.items())),
        "reasons_ok": reasons_ok,
        "would_fit_if_ok": would_ok,
        "conditions_ok": conds_ok,
        "explain_spans": len(explain_spans),
        "recorded": recorded,
        "aggregate": aggregate(fused_recs.values()),
        "dump": dump,
        "ok": bool(tiers_ok and parity and reasons_ok and would_ok and conds_ok and recorded),
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="explain smoke: one forced-unschedulable gang per "
        "feasibility plane, serial/fused/sharded record parity asserted"
    )
    parser.add_argument("--out", default=None, help="record dump directory")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where torch_allocate solves (default: the card)",
    )
    parser.add_argument("--json", action="store_true", help="print the result dict as JSON")
    args = parser.parse_args(argv)
    result = smoke(out_dir=args.out, device=args.device)
    if args.json:
        print(json.dumps(result, sort_keys=True, default=str))
    else:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"explain smoke: {status} ({result['gangs']} gangs, "
            f"parity={result['parity']}, reasons={result['reasons']})"
        )
    return 0 if result["ok"] else 1


configure()


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` runs this file as
    # __main__, whose module state would otherwise differ from the one
    # other modules import
    from kube_batch_tpu_torch.obs.explain import main as _canonical_main

    raise SystemExit(_canonical_main())
