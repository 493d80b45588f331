"""The port's glog surface (kube_batch_tpu_torch/log.py) against the JAX
package's (kube_batch_tpu/log.py): the same line for the same record,
``V(n)`` gating alike at every verbosity, ``KB_TPU_V`` read at import;
and the port's records still reach the root logger (a test's ``caplog``
reads them there)."""

import logging
import os
import subprocess
import sys

import pytest

from kube_batch_tpu import log as jax_log

from kube_batch_tpu_torch import log as torch_log

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(level: int, msg: str, args=(), created: float = 1_792_300_211.123456) -> logging.LogRecord:
    rec = logging.LogRecord("kube_batch_tpu_torch.x", level, "/any/where/torch_allocate.py", 42, msg, args, None)
    rec.created = created
    rec.msecs = (created - int(created)) * 1000
    return rec


@pytest.mark.parametrize("level", [logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR, logging.CRITICAL])
@pytest.mark.parametrize("created", [1_792_300_211.123456, 1_767_225_599.000001, 0.5])
def test_formatter_renders_the_jax_line(level, created):
    rec = _record(level, "placed %d of %s", (3, "gang-a"), created)
    line = torch_log.GlogFormatter().format(rec)
    assert line == jax_log._GlogFormatter().format(rec)
    assert line.endswith(" torch_allocate.py:42] placed 3 of gang-a")
    assert line[0] == {logging.WARNING: "W", logging.ERROR: "E", logging.CRITICAL: "F"}.get(level, "I")


class _Collect(logging.Handler):
    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.messages: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


@pytest.fixture
def verbosity():
    saved = torch_log.get_verbosity(), jax_log.get_verbosity()
    yield
    torch_log.set_verbosity(saved[0])
    jax_log.set_verbosity(saved[1])


@pytest.mark.parametrize("v", range(6))
def test_v_gates_alike_at_each_verbosity(verbosity, caplog, v):
    """At verbosity ``v`` both packages' ``V(n)`` are on for n <= v, and
    ``V(n).infof`` emits exactly then; the port's records reach the root
    logger (``caplog``), the JAX package's only its own handler."""
    torch_log.set_verbosity(v)
    jax_log.set_verbosity(v)
    jax_seen = _Collect()
    jax_log._ensure_handler()  # its own stderr handler, at DEBUG, not propagated
    jax_logger = logging.getLogger("kube_batch_tpu")
    jax_logger.addHandler(jax_seen)
    try:
        with caplog.at_level(logging.DEBUG, logger="kube_batch_tpu_torch"):
            for n in range(6):
                assert torch_log.V(n).enabled == jax_log.V(n).enabled == (n <= v)
                torch_log.V(n).infof("level %d at %s", n, v)
                jax_log.V(n).infof("level %d at %s", n, v)
            torch_log.infof("plain %s", "info")
            torch_log.warningf("a %s", "warning")
            torch_log.errorf("an error")
            jax_log.infof("plain %s", "info")
            jax_log.warningf("a %s", "warning")
            jax_log.errorf("an error")
    finally:
        jax_logger.removeHandler(jax_seen)
    port = [r.getMessage() for r in caplog.records if r.name == "kube_batch_tpu_torch"]
    want = [f"level {n} at {v}" for n in range(v + 1)] + ["plain info", "a warning", "an error"]
    assert port == want
    assert jax_seen.messages == want
    levels = [r.levelno for r in caplog.records if r.name == "kube_batch_tpu_torch"]
    assert levels == [logging.INFO] * (v + 2) + [logging.WARNING, logging.ERROR]
    assert all(r.filename == "test_torch_log.py" for r in caplog.records if r.name == "kube_batch_tpu_torch")


@pytest.mark.parametrize("env, want", [("3", 3), (None, 0)])
def test_kb_tpu_v_sets_the_verbosity_at_import(env, want):
    """``KB_TPU_V`` read at import, as glog's ``-v``: in a fresh process
    both packages start at the variable's verbosity (0 without it)."""
    base = {k: v for k, v in os.environ.items() if k != "KB_TPU_V"}
    code = ("from kube_batch_tpu_torch import log as p; from kube_batch_tpu import log as j; "
            "print(p.get_verbosity(), j.get_verbosity(), p.V(3).enabled)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**base, "PYTHONPATH": ROOT, **({} if env is None else {"KB_TPU_V": env})})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [str(want), str(want), str(want >= 3)]


def test_a_process_without_logging_setup_prints_glog_lines():
    """With no handler on the root logger the port's first line installs
    the glog handler on stderr, so ``infof`` reaches an operator in the
    JAX package's format; where the root logger has a handler (a host
    application's), the port adds none and the line is printed once."""
    code = ("import logging; from kube_batch_tpu_torch import log; log.infof('bound %d', 7); "
            "logging.getLogger('kube_batch_tpu_torch.actions').info('child line'); "
            "logging.getLogger('kube_batch_tpu_torch.actions').debug('not shown')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("I") and lines[0].endswith(" <string>:1] bound 7")
    assert lines[1].endswith("] child line")
    configured = "import logging; logging.basicConfig(format='%(message)s', level=logging.INFO); " + code
    proc = subprocess.run([sys.executable, "-c", configured], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines() == ["bound 7", "child line"]
