"""The port's `torch_reclaim` against the JAX package's `xla_reclaim` and
both packages' serial `reclaim`, on the JAX tests' reclaim scenes
(tests/test_xla_reclaim.py; the port's copies of their generators live
in `kube_batch_tpu_torch.testing`). Outcomes compared exactly: task
statuses and nodes, binds, and the evict list in order."""

import pytest

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch.framework import get_action as torch_get_action

import test_xla_reclaim as jax_reclaim_tests
from test_torch_preempt import NO_PREDICATES, assert_four_way, jax_run, torch_run
from test_xla_reclaim import RECLAIM_TIERS


def assert_reclaim_parity(name, seed):
    return assert_four_way(
        lambda: getattr(jax_reclaim_tests, name)(seed),
        lambda: getattr(torch_testing, name)(seed),
        "reclaim", "reclaim", RECLAIM_TIERS,
    )


def test_cross_queue_reclaim_parity():
    state, binds, evicts = assert_reclaim_parity("gen_reclaim_cluster", 1)
    assert len(evicts) >= 1  # the scene reclaims something


@pytest.mark.parametrize("seed", range(16))
def test_reclaim_parity(seed):
    assert_reclaim_parity("gen_reclaim_cluster", seed)


@pytest.mark.parametrize("seed", range(24))
def test_contended_reclaim_parity(seed):
    assert_reclaim_parity("gen_contended_reclaim_cluster", seed)


def test_contended_sweep_evicts():
    evicts = sum(
        len(torch_run(["torch_reclaim"], torch_testing.gen_contended_reclaim_cluster(s), RECLAIM_TIERS)[2])
        for s in range(24)
    )
    assert evicts >= 10, f"sweep too tame to prove anything ({evicts} evicts)"


def test_reclaim_records_its_split():
    torch_run(["torch_reclaim"], torch_testing.gen_reclaim_cluster(1), RECLAIM_TIERS)
    t = torch_get_action("torch_reclaim").last_timings
    assert set(t) == {"encode_s", "warm_fraction", "reclaim_s", "serial_scans"}
    assert t["serial_scans"] == 0


@pytest.mark.parametrize("seed", [1, 5])
def test_out_of_envelope_conf_runs_serial_reclaim(seed):
    want = jax_run(["reclaim"], jax_reclaim_tests.gen_contended_reclaim_cluster(seed), NO_PREDICATES)
    assert jax_run(["xla_reclaim"], jax_reclaim_tests.gen_contended_reclaim_cluster(seed), NO_PREDICATES) == want
    got = torch_run(["torch_reclaim"], torch_testing.gen_contended_reclaim_cluster(seed), NO_PREDICATES)
    assert got == want
    assert torch_get_action("torch_reclaim").last_timings["serial_reason"] == "envelope"
