"""The port's verify gate: every module self-check of the package, each run
as its own process, with one summary.

    python -m kube_batch_tpu_torch.verify [--device cuda|cpu] [--json]
        [--strict] [--only G1,G2] [--interleave] [--federation] [--chaos]

The gates carry the names and the pass conditions of the JAX package's
``hack/verify.py`` module gates. The default set:

- ``analysis``, ``threads``: the AST suite and the concurrency sanitizer
  (``analysis``, ``analysis.threads``; ``--strict`` rejects stale
  baseline entries);
- ``trace_audit``: the warm-cycle audit of the solver rungs
  (``analysis.trace``; on the card it also audits the host syncs);
- ``chaos_smoke``: one injected fault per subsystem (``faults.smoke``);
- ``wire_codec``: the store codec's round trips (``apis.wire``);
- ``encode_cache_smoke``, ``pipeline_smoke``: warm and churned encodes
  byte-identical to cold ones, and pipelined cycles bind-for-bind equal
  to synchronous ones (``ops.encode_cache [--pipeline]``);
- ``streaming_smoke``: micro-cycles bind every arrival, in parity with
  full cycles (``streaming``);
- ``obs_tracing_smoke``, ``explain_smoke``, ``fleet_obs_smoke``: the span
  tree over a federated wire path, the forensics against their serial
  twin, and the fleet's merged quantiles at 2 and 4 shards (``obs``,
  ``obs.explain``, ``obs.fleet``);
- ``admission_smoke``: the deterministic 5x-overload plant on a fake
  clock, under a second of wall time (``admission``);
- ``class_solve_smoke``: the class-compressed solve in parity over two
  cycles (``ops.class_solve``).

Behind flags: ``interleave`` (``--interleave``: every distinguishable
schedule of the interleaving scenarios), ``federation`` (``--federation``:
the federation smoke, a seeded two-scheduler conflict drill, the
kill-and-adopt drill and the streaming federation), and under ``--chaos``
both ``chaos`` (the port's ``chaos``-marked tests, and ``recovery.fsck``
on a seeded journal) and ``admission_storm`` (``admission --storm
--duration 4``). ``--only`` runs the named gates alone, opt-in ones
included.

``--device`` goes to every entry point that takes one: the card by
default, and with no card visible the gate exits 2 before any gate runs;
no gate falls back to the CPU. ``analysis``, ``threads``, ``wire_codec``
and fsck have no card path and run as they are. The summary, with
``--json`` one JSON line last, holds each gate's ``ok``, its seconds and
the launches of each kernel that the gate's processes counted. The exit
code is 0 only if every gate that ran is ok.

Left to ``hack/verify.py``, which walks every tracked ``.py`` file of the
repository, the port's included: ``compileall``, ``tabnanny``, the AST
lint, ruff and mypy. ``bench_diff`` waits for a benchmark artifact of the
port.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the order the gates run in, as in hack/verify.py
ORDER = (
    "analysis", "threads", "trace_audit", "interleave", "chaos_smoke", "wire_codec",
    "encode_cache_smoke", "pipeline_smoke", "streaming_smoke", "obs_tracing_smoke",
    "explain_smoke", "fleet_obs_smoke", "admission_smoke", "class_solve_smoke",
    "federation", "chaos", "admission_storm",
)
# the gates that run only behind a flag, and their flag
OPT_IN_GATES = {
    "interleave": "--interleave",
    "federation": "--federation",
    "chaos": "--chaos",
    "admission_storm": "--chaos",
}
DEFAULT_GATES = tuple(name for name in ORDER if name not in OPT_IN_GATES)
# each kernel's wrapper and the counter it adds one to at each launch
KERNELS = (
    ("fused_solve", "kube_batch_tpu_torch.ops.fused_solve", "fused_solve"),
    ("block_step", "kube_batch_tpu_torch.ops.block_step", "block_step"),
    ("class_step", "kube_batch_tpu_torch.ops.class_solve", "class_step"),
    ("mesh_solve", "kube_batch_tpu_torch.ops.mesh_solve", "mesh_solve"),
)

# Runs one entry point as ``python -m`` would, and at exit writes the
# kernels' launch counters to the file named first.
_COUNTED = (
    "import sys; from kube_batch_tpu_torch.verify import run_counted; "
    "run_counted(sys.argv[1], sys.argv[2], sys.argv[3:])"
)


def launch_counts() -> dict[str, int]:
    """This process's launches of each kernel, from the wrappers' counters
    (a wrapper module never imported launched nothing)."""
    out = {}
    for name, module, attr in KERNELS:
        mod = sys.modules.get(module)
        out[name] = int(getattr(getattr(mod, attr, None), "launches", 0)) if mod is not None else 0
    return out


def run_counted(out_path: str, module: str, argv: list[str]) -> None:
    """``python -m module *argv`` in this process; at exit, whatever the
    exit, the kernels' launch counters go to ``out_path`` as JSON."""
    import atexit
    import runpy

    def dump() -> None:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(launch_counts(), fh)

    atexit.register(dump)
    sys.argv = [module, *argv]
    runpy.run_module(module, run_name="__main__", alter_sys=True)


class Runner:
    """Runs the entry points of the gates and sums their launches."""

    def __init__(self, env: dict) -> None:
        self.env = env
        self.launches = {name: 0 for name, _, _ in KERNELS}
        self._tmp = tempfile.mkdtemp(prefix="kbt-verify-")
        self._n = 0

    def run(self, module: str, args: list[str], env: Optional[dict] = None) -> subprocess.CompletedProcess:
        """``python -m module *args`` from the repository's root, output
        captured, its kernels' launches added to the runner's."""
        self._n += 1
        path = os.path.join(self._tmp, f"launches-{self._n}.json")
        res = subprocess.run(
            [sys.executable, "-c", _COUNTED, path, module, *args],
            cwd=REPO, env=self.env if env is None else env, capture_output=True, text=True,
        )
        try:
            with open(path, encoding="utf-8") as fh:
                for name, n in json.load(fh).items():
                    self.launches[name] = self.launches.get(name, 0) + int(n)
        except (OSError, ValueError):
            pass
        return res

    def run_code(self, code: str, env: Optional[dict] = None) -> subprocess.CompletedProcess:
        return subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=self.env if env is None else env,
            capture_output=True, text=True,
        )

    def close(self) -> None:
        import shutil

        shutil.rmtree(self._tmp, ignore_errors=True)


def _summary(res: subprocess.CompletedProcess, what: str, whole: bool = False) -> dict:
    """The JSON summary an entry point printed last (``whole``: its whole
    standard output is one JSON document); {} with the output shown when
    there is none."""
    try:
        text = res.stdout if whole else res.stdout.strip().splitlines()[-1]
        out = json.loads(text)
        return out if isinstance(out, dict) else {}
    except (ValueError, IndexError):
        print(f"verify: {what} produced no parseable summary")
        print(res.stdout[-4000:], res.stderr[-4000:], sep="\n")
        return {}


def _failed(res: subprocess.CompletedProcess, what: str, detail="") -> None:
    print(res.stdout[-4000:], res.stderr[-4000:], sep="\n")
    print(f"verify: {what} FAILED {detail}".rstrip())


def _scrubbed(env: dict, *names: str) -> dict:
    env = dict(env)
    for name in names:
        env.pop(name, None)
    return env


# -- the gates ----------------------------------------------------------------


def gate_analysis(r: Runner, device: str, strict: bool) -> dict:
    res = r.run("kube_batch_tpu_torch.analysis", ["--json"] + (["--strict"] if strict else []))
    summary = _summary(res, "analysis suite")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "analysis suite", "(python -m kube_batch_tpu_torch.analysis --explain CODE for any code)")
    return {
        "ok": ok,
        "counts": summary.get("counts", {}),
        "suppressed": summary.get("suppressed", 0),
        "baseline_errors": len(summary.get("baseline_errors", [])),
        "stale": len(summary.get("stale", [])),
    }


def gate_threads(r: Runner, device: str, strict: bool) -> dict:
    res = r.run("kube_batch_tpu_torch.analysis.threads", ["--json"] + (["--strict"] if strict else []))
    summary = _summary(res, "threads analyzer")
    ok = res.returncode == 0 and summary.get("ok", False)
    self_probs = summary.get("selfcheck") or {}
    problems = list(self_probs.get("static", ["?"])) + list(self_probs.get("witness", []))
    if not ok:
        _failed(res, "concurrency sanitizer", "(python -m kube_batch_tpu_torch.analysis.threads --explain CODE)")
    return {
        "ok": ok,
        "counts": summary.get("counts", {}),
        "suppressed": summary.get("suppressed", 0),
        "selfcheck_ok": not problems,
        "stale": len(summary.get("stale", [])),
    }


def gate_trace_audit(r: Runner, device: str, strict: bool) -> dict:
    res = r.run(
        "kube_batch_tpu_torch.analysis.trace", ["--json", "--device", device] + (["--strict"] if strict else [])
    )
    summary = _summary(res, "trace audit")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "trace audit", "(python -m kube_batch_tpu_torch.analysis.trace --explain CODE)")
    return {
        "ok": ok,
        "counts": summary.get("counts", {}),
        "suppressed": summary.get("suppressed", 0),
        "entries": summary.get("entries", {}),
        "stale": len(summary.get("stale", [])),
    }


def gate_interleave(r: Runner, device: str, strict: bool) -> dict:
    res = r.run(
        "kube_batch_tpu_torch.analysis.interleave", ["--json", "--device", device] + (["--strict"] if strict else [])
    )
    summary = _summary(res, "interleave explorer", whole=True)
    ok = res.returncode == 0 and bool(summary)
    if not ok:
        _failed(res, "interleave exploration", "(replay the trace id with python -m "
                "kube_batch_tpu_torch.analysis.interleave --replay)")
    scenarios = summary.get("scenarios", [])
    return {
        "ok": ok,
        "schedules": sum(s.get("schedules", 0) for s in scenarios),
        "counterexamples": sum(len(s.get("counterexamples", [])) for s in scenarios),
        "suppressed": summary.get("suppressed", 0),
    }


def gate_chaos_smoke(r: Runner, device: str, strict: bool) -> dict:
    res = r.run("kube_batch_tpu_torch.faults.smoke", ["--device", device])
    ok = res.returncode == 0
    if not ok:
        _failed(res, "chaos smoke")
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    return {"ok": ok, "summary": last}


def gate_wire_codec(r: Runner, device: str, strict: bool) -> dict:
    res = r.run("kube_batch_tpu_torch.apis.wire", ["--json"], env=_scrubbed(r.env, "KBT_WIRE_CODEC"))
    summary = _summary(res, "wire codec self-check")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "wire codec self-check")
    return {
        "ok": ok,
        "cases": summary.get("cases"),
        "json_bytes": summary.get("json_bytes"),
        "binary_bytes": summary.get("binary_bytes"),
    }


def _encode_cache_env(env: dict) -> dict:
    return _scrubbed(env, "KBT_ENCODE_CACHE")


def gate_encode_cache_smoke(r: Runner, device: str, strict: bool) -> dict:
    res = r.run("kube_batch_tpu_torch.ops.encode_cache", ["--device", device, "--json"], env=_encode_cache_env(r.env))
    summary = _summary(res, "encode-cache parity smoke")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "encode-cache parity smoke")
    return {"ok": ok, "warm_fraction": summary.get("warm_fraction"), "arena": summary.get("arena")}


def gate_pipeline_smoke(r: Runner, device: str, strict: bool) -> dict:
    env = _scrubbed(_encode_cache_env(r.env), "KBT_PIPELINE", "KBT_PIPELINE_FENCE_TIMEOUT_S", "KBT_EXCHANGE_BATCH")
    res = r.run("kube_batch_tpu_torch.ops.encode_cache", ["--pipeline", "--device", device, "--json"], env=env)
    summary = _summary(res, "pipelined-cycle parity smoke")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "pipelined-cycle parity smoke")
    return {"ok": ok, "banks": summary.get("banks"), "b1_launches": summary.get("b1_launches")}


def gate_streaming_smoke(r: Runner, device: str, strict: bool) -> dict:
    res = r.run("kube_batch_tpu_torch.streaming", ["--json", "--device", device])
    summary = _summary(res, "streaming smoke")
    ok = (
        res.returncode == 0
        and summary.get("ok", False)
        and summary.get("parity", False)
        and summary.get("micro_cycles", 0) > 0
    )
    if not ok:
        _failed(res, "streaming smoke")
    return {"ok": ok, "micro_cycles": summary.get("micro_cycles", 0), "p50_bind_ms": summary.get("p50_bind_ms")}


def gate_obs_tracing_smoke(r: Runner, device: str, strict: bool) -> dict:
    env = _scrubbed(r.env, "KBT_TRACE", "KBT_FEDERATION", "KBT_SHARD_KEY", "KBT_FLIGHT_RECORDER")
    res = r.run("kube_batch_tpu_torch.obs", ["--json", "--device", device], env=env)
    summary = _summary(res, "obs tracing smoke")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "obs tracing smoke", f"({summary})")
    return {
        "ok": ok,
        "spans": summary.get("spans"),
        "conflicted_gang_binds": summary.get("conflicted_gang_binds"),
        "remote_spans_joined": summary.get("remote_spans_joined"),
        "tree_violations": len(summary.get("tree_violations") or []),
    }


def gate_explain_smoke(r: Runner, device: str, strict: bool) -> dict:
    env = _scrubbed(r.env, "KBT_EXPLAIN", "KBT_TRACE", "KBT_FEDERATION", "KBT_SHARD_KEY", "KBT_FLIGHT_RECORDER")
    res = r.run("kube_batch_tpu_torch.obs.explain", ["--json", "--device", device], env=env)
    summary = _summary(res, "explain forensics smoke")
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "explain forensics smoke", f"({summary})")
    return {
        "ok": ok,
        "parity": summary.get("parity"),
        "reasons_ok": summary.get("reasons_ok"),
        "would_fit_if_ok": summary.get("would_fit_if_ok"),
        "conditions_ok": summary.get("conditions_ok"),
    }


def gate_fleet_obs_smoke(r: Runner, device: str, strict: bool) -> dict:
    env = _scrubbed(r.env, "KBT_FLEET", "KBT_TRACE", "KBT_FEDERATION", "KBT_SHARD_KEY", "KBT_FLIGHT_RECORDER")
    out: dict = {"ok": True}
    for shards in (2, 4):
        res = r.run("kube_batch_tpu_torch.obs.fleet", ["--json", "--shards", str(shards), "--device", device], env=env)
        summary = _summary(res, f"fleet obs smoke ({shards} shards)")
        ok = res.returncode == 0 and summary.get("ok", False)
        if not ok:
            _failed(res, f"fleet obs smoke at {shards} shards", f"({summary})")
            out["ok"] = False
        out[f"shards_{shards}"] = {
            "ok": ok,
            "max_rel_err": summary.get("max_rel_err"),
            "rel_err_bound": summary.get("rel_err_bound"),
            "exactly_once": summary.get("exactly_once"),
            "fsck_violations": len(summary.get("fsck_violations") or []),
        }
    return out


_ADMISSION_ENV = (
    "KBT_ADMISSION", "KBT_ADMISSION_RATE", "KBT_ADMISSION_BURST", "KBT_ADMISSION_BACKLOG",
    "KBT_ADMISSION_P99_SLO_S", "KBT_ADMISSION_BAND", "KBT_ADMISSION_INTERVAL_S",
    "KBT_ADMISSION_MIN_RATE", "KBT_FLEET",
)


def gate_admission_smoke(r: Runner, device: str, strict: bool) -> dict:
    # the plant's 40 s run on a fake clock: no device, under a second of wall time
    res = r.run("kube_batch_tpu_torch.admission", ["--json", "--device", device], env=_scrubbed(r.env, *_ADMISSION_ENV))
    summary = _summary(res, "admission smoke")
    on = summary.get("on") or {}
    ok = res.returncode == 0 and summary.get("ok", False)
    if not ok:
        _failed(res, "admission smoke")
    return {
        "ok": ok,
        "tail_p99_s": on.get("tail_p99_s"),
        "high_shed": ((on.get("counts") or {}).get("high") or {}).get("shed"),
        "level_final": on.get("level_final"),
    }


def gate_class_solve_smoke(r: Runner, device: str, strict: bool) -> dict:
    env = _scrubbed(r.env, "KBT_CLASS_COMPRESS", "KBT_MESH", "KBT_MESH_PALLAS")
    res = r.run("kube_batch_tpu_torch.ops.class_solve", ["--json", "--device", device], env=env)
    summary = _summary(res, "class-solve parity smoke")
    ok = (
        res.returncode == 0
        and summary.get("ok", False)
        and summary.get("parity_cycle1", False)
        and summary.get("parity_cycle2", False)
    )
    if not ok:
        _failed(res, "class-solve parity smoke")
    return {
        "ok": ok,
        "class_count": summary.get("class_count"),
        "compression_ratio": summary.get("compression_ratio"),
        "splits": summary.get("splits"),
    }


# The seeded two-scheduler conflict drill: both caches snapshot the same
# store version, both dispatch onto one node; the second dispatch must lose
# its optimistic check and win the refresh-retry, and the store must end
# fsck-clean with all six pods bound.
FED_DRILL = """
import json
from kube_batch_tpu_torch.api.job_info import job_key
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache import ClusterStore
from kube_batch_tpu_torch.federation import FederatedCache, fsck, shard_index
from kube_batch_tpu_torch.testing import (
    build_node, build_pod, build_pod_group, build_queue, build_resource_list,
)

store = ClusterStore()
store.create_queue(build_queue("default"))
store.create_node(build_node("n0", build_resource_list(cpu=16, memory="16Gi", pods=64)))
for g in ("ga", "gb"):
    store.create_pod_group(build_pod_group(g, min_member=3))
    for m in range(3):
        store.create_pod(build_pod(
            name=f"{g}-p{m}", group_name=g, req=build_resource_list(cpu=1, memory="512Mi"),
        ))
caches = {
    g: FederatedCache(store, shard=shard_index(job_key("default", g), 2), shards=2, shard_key="gang")
    for g in ("ga", "gb")
}
for c in caches.values():
    c.snapshot()  # same version: the second dispatch conflicts for real
for g, c in caches.items():
    job = c.jobs[job_key("default", g)]
    pending = list(job.task_status_index[TaskStatus.PENDING].values())
    c.bind_many([(t, "n0") for t in pending])
violations = fsck(store)
bound = sum(1 for p in store.list("pods") if p.node_name)
ok = not violations and bound == 6
print(json.dumps({"ok": ok, "bound": bound, "fsck_violations": violations}))
raise SystemExit(0 if ok else 1)
"""


def gate_federation(r: Runner, device: str, strict: bool) -> dict:
    env = _scrubbed(r.env, "KBT_FEDERATION", "KBT_SHARD_KEY")
    ok = True
    res = r.run("kube_batch_tpu_torch.federation", ["--json", "--device", device], env=env)
    summary = _summary(res, "federation smoke")
    if res.returncode != 0 or not summary.get("ok", False):
        _failed(res, "federation smoke", f"({summary})")
        ok = False
    res = r.run_code(FED_DRILL, env=env)
    drill = _summary(res, "federation two-scheduler conflict drill")
    if res.returncode != 0 or not drill.get("ok", False):
        _failed(res, "federation two-scheduler conflict drill", f"({drill})")
        ok = False
    # no --strict: the unowned-window fsck observation is timing-dependent
    res = r.run("kube_batch_tpu_torch.federation", ["--json", "--kill-one", "--device", device], env=env)
    kill = _summary(res, "federation kill drill")
    if res.returncode != 0 or not kill.get("ok", False):
        _failed(res, "federation kill-and-adopt drill", f"({kill})")
        ok = False
    res = r.run(
        "kube_batch_tpu_torch.federation", ["--json", "--streaming", "--device", device],
        env=_scrubbed(env, "KBT_STREAMING"),
    )
    stream = _summary(res, "streaming-federation smoke")
    if res.returncode != 0 or not stream.get("ok", False):
        _failed(res, "streaming-federation smoke", f"({stream})")
        ok = False
    return {
        "ok": ok,
        "shards": summary.get("shards"),
        "bound": summary.get("bound"),
        "exactly_once": summary.get("exactly_once"),
        "union_parity": summary.get("union_parity"),
        "drill_bound": drill.get("bound"),
        "kill_adopter": kill.get("adopter"),
        "kill_takeover_s": kill.get("takeover_s"),
        "kill_mttr_s": kill.get("mttr_s"),
        "streaming_micro_cycles": stream.get("micro_cycles"),
        "streaming_parity": stream.get("parity"),
    }


def seeded_journal_fixture(path: str) -> None:
    """A known journal: 3 bind intents for one gang, the first confirmed,
    what a leader killed after 1 of 3 bulk writes leaves."""
    lines = [
        '{"rec":"intent","seq":1,"cycle":4,"op":"bind","gang":"default/g0","pod":"default/p0","node":"n0"}',
        '{"rec":"intent","seq":2,"cycle":4,"op":"bind","gang":"default/g0","pod":"default/p1","node":"n1"}',
        '{"rec":"intent","seq":3,"cycle":4,"op":"bind","gang":"default/g0","pod":"default/p2","node":"n0"}',
        '{"rec":"confirm","seq":1}',
    ]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def gate_chaos(r: Runner, device: str, strict: bool) -> dict:
    ok = True
    files = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    res = r.run("pytest", [*files, "-q", "-m", "chaos", "-p", "no:cacheprovider"])
    tests = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    if res.returncode != 0:
        _failed(res, "chaos test subset")
        ok = False
    with tempfile.TemporaryDirectory() as tmp:
        fixture = os.path.join(tmp, "seeded.wal")
        seeded_journal_fixture(fixture)
        res = r.run("kube_batch_tpu_torch.recovery.fsck", ["--json", fixture])
        summary = _summary(res, "recovery.fsck") if res.returncode == 0 else {}
        if (
            res.returncode != 0
            or summary.get("intents") != 3
            or summary.get("orphaned") != 2
            or summary.get("corrupt_lines") != 0
        ):
            _failed(res, "recovery.fsck on the seeded journal", f"({summary})")
            ok = False
        # --strict must refuse a journal with in-flight intents
        res = r.run("kube_batch_tpu_torch.recovery.fsck", ["--strict", fixture])
        if res.returncode != 1:
            _failed(res, "recovery.fsck --strict", "(did not gate on orphans)")
            ok = False
    return {"ok": ok, "tests": tests}


def gate_admission_storm(r: Runner, device: str, strict: bool) -> dict:
    res = r.run(
        "kube_batch_tpu_torch.admission", ["--storm", "--json", "--duration", "4", "--device", device],
        env=_scrubbed(r.env, *_ADMISSION_ENV),
    )
    storm = _summary(res, "admission storm drill")
    ok = res.returncode == 0 and storm.get("ok", False)
    if not ok:
        _failed(res, "admission storm drill", f"({storm})")
    return {
        "ok": ok,
        "on_high_p99_s": (storm.get("on") or {}).get("lane_p99_s", {}).get("high"),
        "kill_mttr_s": (storm.get("kill") or {}).get("mttr_s"),
    }


GATES: dict[str, Callable[[Runner, str, bool], dict]] = {
    name: globals()[f"gate_{name}"] for name in ORDER
}


def selected(only: Optional[str], interleave: bool, federation: bool, chaos: bool) -> list[str]:
    """The gates to run, in order. Raises ValueError on an unknown name."""
    if only:
        names = {n.strip() for n in only.split(",") if n.strip()}
        unknown = sorted(names - set(GATES))
        if unknown:
            raise ValueError(f"unknown gate(s) {', '.join(unknown)} (known: {', '.join(ORDER)})")
        return [n for n in ORDER if n in names]
    flags = {"--interleave": interleave, "--federation": federation, "--chaos": chaos}
    return [n for n in ORDER if n in DEFAULT_GATES or flags[OPT_IN_GATES[n]]]


def run_gates(names: list[str], device: str, strict: bool = False, env: Optional[dict] = None) -> dict:
    """Runs ``names`` in order; returns the summary (``ok``, ``gates`` with
    each gate's record, ``launches`` by kernel, ``seconds``)."""
    if env is None:
        # the detector guards every store-backed cycle; a drill armed in
        # the shell would skew the smokes
        env = _scrubbed(dict(os.environ, KBT_CACHE_MUTATION_DETECTOR="1"), "KBT_FAULTS")
    runner = Runner(env)
    gates: dict = {}
    t_all = time.perf_counter()
    try:
        for name in names:
            before = dict(runner.launches)
            t0 = time.perf_counter()
            try:
                rec = GATES[name](runner, device, strict)
            except Exception as e:  # noqa: BLE001 - a gate that raises fails, the others still run
                print(f"verify: {name} raised {type(e).__name__}: {e}")
                rec = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            rec["seconds"] = round(time.perf_counter() - t0, 3)
            rec["launches"] = {k: runner.launches[k] - before.get(k, 0) for k in runner.launches}
            gates[name] = rec
            print(f"verify: {name}: {'ok' if rec['ok'] else 'FAILED'} ({rec['seconds']} s)", flush=True)
    finally:
        runner.close()
    return {
        "ok": all(g["ok"] for g in gates.values()),
        "device": device,
        "strict": strict,
        "gates": gates,
        "launches": dict(runner.launches),
        "seconds": round(time.perf_counter() - t_all, 3),
    }


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.verify", description="the port's module self-checks, one process each"
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"), help="where the entry points run (default: the card)"
    )
    parser.add_argument("--json", action="store_true", help="print the summary as one JSON line, last")
    parser.add_argument("--strict", action="store_true", help="the analyzers also reject stale baseline entries")
    parser.add_argument("--only", default=None, metavar="G1,G2", help="run only these gates (opt-in ones included)")
    parser.add_argument("--interleave", action="store_true", help="add the interleave gate")
    parser.add_argument("--federation", action="store_true", help="add the federation gate")
    parser.add_argument("--chaos", action="store_true", help="add the chaos and admission_storm gates")
    args = parser.parse_args(argv)
    try:
        names = selected(args.only, args.interleave, args.federation, args.chaos)
    except ValueError as e:
        print(f"verify: {e}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print(
                "verify: --device cuda but no CUDA device is visible; pass --device cpu to run the gates on the CPU",
                file=sys.stderr,
            )
            return 2
    result = run_gates(names, args.device, args.strict)
    print("verify:", "ok" if result["ok"] else "FAILED", f"({len(names)} gates, {result['seconds']} s)")
    if args.json:
        print(json.dumps(result, sort_keys=True))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    # re-enter through the canonical module, so that run_counted is the
    # module other processes import
    from kube_batch_tpu_torch.verify import main as _canonical_main

    raise SystemExit(_canonical_main())
