"""The port's verify gate (``python -m kube_batch_tpu_torch.verify``) and
the self-checks it runs that the JAX package's ``hack/verify.py`` also
runs: the encode-cache and pipelined-cycle smokes
(``kube_batch_tpu_torch.ops.encode_cache``) and the chaos smoke's drills
(``kube_batch_tpu_torch.faults.smoke``), all on the CPU.

Each smoke passes here and fails when a divergence is planted by
monkeypatching; the gate's names are ``hack/verify.py``'s module gates,
read from its source; a failing entry point or a gate that raises fails
the gate; ``--device cuda`` with no card exits non-zero with its reason;
and ``chip_smoke.py`` takes ``--verify``.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from kube_batch_tpu_torch import faults, pipeline, verify
from kube_batch_tpu_torch.faults import smoke as chaos
from kube_batch_tpu_torch.ops import encode as encode_mod
from kube_batch_tpu_torch.ops import encode_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# hack/verify.py's gates that walk the source tree or a benchmark artifact
# and stay there
STATIC_GATES = {"compileall", "tabnanny", "ast_lint", "ruff", "mypy", "bench_diff"}


@pytest.fixture(autouse=True)
def _clean_state():
    saved = os.environ.get(pipeline.ENV)
    ladder = faults.solver_ladder
    faults.registry.reset()
    pipeline.reset()
    yield
    if saved is None:
        os.environ.pop(pipeline.ENV, None)
    else:
        os.environ[pipeline.ENV] = saved
    faults.registry.reset()
    faults.set_solver_ladder(ladder)
    pipeline.reset()


# -- the encode-cache and pipelined-cycle smokes -------------------------------


def test_encode_cache_smoke_passes_on_cpu():
    out: dict = {}
    assert encode_cache.smoke(device="cpu", out=out) == 0
    assert out["ok"] and out["warm_fraction"] > 0.5
    assert out["arena"]["reuses"] == out["slabs"]


def test_encode_cache_smoke_fails_on_a_planted_divergence(monkeypatch, capsys):
    real = encode_mod.encode_session
    calls = []

    def second_encode_differs(*args, **kwargs):
        snap = real(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:  # the warm encode
            snap.arrays = dict(snap.arrays, eps=snap.arrays["eps"] + 1.0)
        return snap

    monkeypatch.setattr(encode_mod, "encode_session", second_encode_differs)
    assert encode_cache.smoke(device="cpu") == 1
    assert "warm-vs-cold: arrays['eps'] diverges" in capsys.readouterr().out


def test_pipeline_smoke_passes_on_cpu():
    out: dict = {}
    assert encode_cache.smoke_pipeline(device="cpu", out=out) == 0
    assert out["ok"] and out["binds"] == 600
    assert out["banks"]["sync"] == [0, 0] and sorted(out["banks"]["pipelined"]) == [0, 1]
    assert pipeline.fence.degraded_reason is None and not pipeline.env_on()


def test_pipeline_smoke_fails_on_a_planted_divergence(monkeypatch, capsys):
    from kube_batch_tpu_torch import testing

    real = testing.FakeBinder.bind_many_keyed

    def pipelined_drops_one(self, keys, hostnames):
        if pipeline.env_on():
            keys, hostnames = keys[1:], hostnames[1:]
        return real(self, keys, hostnames)

    monkeypatch.setattr(testing.FakeBinder, "bind_many_keyed", pipelined_drops_one)
    assert encode_cache.smoke_pipeline(device="cpu") == 1
    assert "pipelined binds diverge from synchronous" in capsys.readouterr().out


def test_smokes_raise_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (encode_cache.smoke, encode_cache.smoke_pipeline):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            fn(device="cuda")


# -- the chaos smoke's drills --------------------------------------------------


@pytest.mark.parametrize("drill", ["drill_bind", "drill_watch", "drill_lease", "drill_mutation_detector"])
def test_cache_drill_passes_on_cpu(drill):
    faults.set_solver_ladder(faults.DegradationLadder(("sharded", "fused", "serial")))
    getattr(chaos, drill)("cpu")
    assert getattr(chaos, drill) in [fn for _, fn in chaos.DRILLS]


def test_chaos_smoke_runs_nine_drills_on_cpu(capsys):
    assert chaos.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert sum(": ok (" in line for line in out.splitlines() if "drills)" not in line) == 9
    assert "chaos smoke: ok (9 drills)" in out
    assert not faults.registry.active()


# -- the gate ------------------------------------------------------------------


def hack_verify_gates() -> set[str]:
    """The names ``hack/verify.py`` records under ``gates["..."]``."""
    with open(os.path.join(REPO, "hack", "verify.py"), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    return {
        node.slice.value
        for node in ast.walk(tree)
        if isinstance(node, ast.Subscript)
        and isinstance(node.value, ast.Name)
        and node.value.id == "gates"
        and isinstance(node.slice, ast.Constant)
        and isinstance(node.slice.value, str)
    }


def test_gate_names_are_hack_verify_module_gates():
    assert set(verify.GATES) == hack_verify_gates() - STATIC_GATES
    assert set(verify.DEFAULT_GATES) | set(verify.OPT_IN_GATES) == set(verify.ORDER)
    assert len(verify.DEFAULT_GATES) == 13


def test_flags_select_the_opt_in_gates():
    assert verify.selected(None, False, False, False) == list(verify.DEFAULT_GATES)
    everything = verify.selected(None, True, True, True)
    assert everything == list(verify.ORDER)
    assert verify.selected(None, False, False, True)[-2:] == ["chaos", "admission_storm"]
    assert verify.selected("wire_codec,interleave", False, False, False) == ["interleave", "wire_codec"]
    with pytest.raises(ValueError, match="bench_diff"):
        verify.selected("bench_diff", False, False, False)


def test_gate_subset_exits_zero_on_cpu():
    gates = ["encode_cache_smoke", "pipeline_smoke", "chaos_smoke", "wire_codec"]
    run = subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch.verify", "--device", "cpu", "--only", ",".join(gates), "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["device"] == "cpu"
    assert set(summary["gates"]) == set(gates)
    for rec in summary["gates"].values():
        assert rec["ok"] and rec["seconds"] > 0
        assert set(rec["launches"]) == {name for name, _, _ in verify.KERNELS}
    assert summary["gates"]["pipeline_smoke"]["banks"]["sync"] == [0, 0]


def _failing_run(self, module, args, env=None):
    return subprocess.CompletedProcess([module, *args], 1, stdout="", stderr="planted failure")


def _raising_gate(runner, device, strict):
    raise RuntimeError("planted failure")


@pytest.mark.parametrize("plant", ["entry_point_exits_1", "gate_raises"])
def test_a_failing_gate_fails_the_gate(monkeypatch, capsys, plant):
    if plant == "entry_point_exits_1":
        monkeypatch.setattr(verify.Runner, "run", _failing_run)
    else:
        monkeypatch.setitem(verify.GATES, "wire_codec", _raising_gate)
    assert verify.main(["--device", "cpu", "--only", "wire_codec", "--json"]) == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] is False and summary["gates"]["wire_codec"]["ok"] is False


def test_cuda_without_a_card_exits_with_its_reason(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert verify.main(["--device", "cuda", "--only", "wire_codec"]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device is visible" in captured.err and "--device cpu" in captured.err
    assert captured.out == ""


def test_unknown_gate_exits_2(capsys):
    assert verify.main(["--device", "cpu", "--only", "no_such_gate"]) == 2
    assert "unknown gate(s) no_such_gate" in capsys.readouterr().err


def test_launch_counts_reach_the_runner():
    runner = verify.Runner(dict(os.environ))
    try:
        res = runner.run("kube_batch_tpu_torch.apis.wire", ["--json"])
    finally:
        runner.close()
    assert res.returncode == 0 and json.loads(res.stdout.strip().splitlines()[-1])["ok"]
    assert runner.launches == {name: 0 for name, _, _ in verify.KERNELS}
    assert verify.launch_counts().keys() == runner.launches.keys()


def test_chip_smoke_takes_verify(monkeypatch, capsys):
    import torch

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    called = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "card_line", lambda every=False: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "verify_only", lambda card, kind: called.append((card, kind)) or 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert chip_smoke.main(["--verify"]) == 0
    assert called == [("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3")]
    assert chip_smoke.main(["--verify", "--no-such-flag"]) == 2
    assert "--verify" in capsys.readouterr().err
    assert chip_smoke.VERIFY_ARGS == ["--device", "cuda", "--json", "--interleave", "--federation", "--chaos"]
