"""The scan actions' float64 encode and `VectorScan` against the JAX
package's.

- ``encode_session(..., dtype=np.float64)``: every array byte-identical
  to the JAX encoder's float64 output (``task_created``, pod creation
  wall-clock stamps, left out as in the float32 tests), over the encode
  test worlds, with and without the drf/proportion state. The float32
  encode is held by tests/test_torch_encode.py, unchanged.
- `VectorScan`: for every task of the session, the predicate-passing
  nodes (reclaim's walk) and the scored candidate order (preempt's) equal
  the JAX scan's, and so do the serial fallbacks (None).
"""

import numpy as np
import pytest

from kube_batch_tpu import models as jax_models
from kube_batch_tpu.actions.scan import VectorScan as JaxVectorScan
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.ops.encode import encode_session as jax_encode_session
from kube_batch_tpu.testing import FakeCache as JaxFakeCache
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch.actions.scan import VectorScan
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import open_session as torch_open
from kube_batch_tpu_torch.ops.encode import encode_session as torch_encode_session
from kube_batch_tpu_torch.plugins.drf import drf_state
from kube_batch_tpu_torch.plugins.proportion import proportion_state
from kube_batch_tpu_torch.solve import valid_jobs

import test_xla_preempt
from test_torch_actions import JAX, TORCH, make
from test_torch_encode import WORLDS, assert_encodings_identical, build_world
from test_xla_allocate import DEFAULT_TIERS_YAML


def jax_encode64(cluster, fair_share: bool):
    with x64_enabled(False):
        ssn = jax_open(JaxFakeCache(cluster), jax_parse(DEFAULT_TIERS_YAML).tiers)
        enc = jax_encode_session(
            ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float64,
            drf=ssn.plugins.get("drf") if fair_share else None,
            proportion=ssn.plugins.get("proportion") if fair_share else None,
        )
        jax_close(ssn)
    return enc


def torch_encode64(cluster, fair_share: bool):
    return torch_encode_session(
        valid_jobs(cluster), cluster.nodes, cluster.queues,
        drf=drf_state(cluster.jobs, cluster.nodes) if fair_share else None,
        proportion=proportion_state(cluster.jobs, cluster.nodes, cluster.queues) if fair_share else None,
        dtype=np.float64,
    )


@pytest.mark.parametrize("fair_share", [False, True])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_float64_encode_byte_identical(world, fair_share):
    j = jax_encode64(build_world(jax_models, world), fair_share)
    t = torch_encode64(build_world(torch_models, world), fair_share)
    assert t.arrays["node_used"].dtype == np.float64 and t.n_tasks > 0
    assert_encodings_identical(j, t)


@pytest.mark.parametrize("key", ["pod_affinity_one", "host_ports", "node_affinity_score", "scalar_resources"])
def test_float64_encode_byte_identical_on_scenarios(key):
    """Host-only rows, host ports, preferred node affinity, scalar dims."""
    for fair_share in (False, True):
        assert_encodings_identical(
            jax_encode64(make(key, JAX), fair_share), torch_encode64(make(key, TORCH), fair_share)
        )


def scan_walks(make_cluster, vector_scan, open_, close, parse, tiers_yaml):
    """[(task uid, feasible node names or None, candidate node names or
    None)] for every task of the session, in uid order."""
    ssn = open_(make_cluster(), parse(tiers_yaml).tiers)
    scan = vector_scan(ssn)
    out = []
    for t in sorted((t for j in ssn.jobs.values() for t in j.tasks.values()), key=lambda t: t.uid):
        feasible, cands = scan.feasible(t), scan.candidates(t)
        out.append((
            t.uid,
            None if feasible is None else [n.name for n in feasible],
            None if cands is None else [n.name for n in cands],
        ))
    close(ssn)
    return out


SCAN_WORLDS = {
    "contended_3": (lambda: test_xla_preempt.gen_contended_cluster(3), lambda: torch_testing.gen_contended_cluster(3)),
    "contended_11": (lambda: test_xla_preempt.gen_contended_cluster(11),
                     lambda: torch_testing.gen_contended_cluster(11)),
    "preempt_mix_400_40": (lambda: jax_models.preempt_mix(400, 40, tasks_per_job=10),
                           lambda: torch_models.preempt_mix(400, 40, tasks_per_job=10)),
    "host_ports": (lambda: make("host_ports", JAX), lambda: make("host_ports", TORCH)),
    "node_affinity_score": (lambda: make("node_affinity_score", JAX), lambda: make("node_affinity_score", TORCH)),
    # pod-affinity terms: the scan is disabled, every walk is serial
    "pod_affinity_many": (lambda: make("pod_affinity_many", JAX), lambda: make("pod_affinity_many", TORCH)),
}


@pytest.mark.parametrize("world", sorted(SCAN_WORLDS))
def test_vector_scan_walks_equal_jax(world):
    jax_make, torch_make = SCAN_WORLDS[world]
    with x64_enabled(False):
        want = scan_walks(lambda: JaxFakeCache(jax_make()), JaxVectorScan, jax_open, jax_close, jax_parse,
                          test_xla_preempt.PREEMPT_TIERS)
    got = scan_walks(lambda: torch_testing.FakeCache(torch_make()), VectorScan, torch_open, torch_close,
                     torch_parse, test_xla_preempt.PREEMPT_TIERS)
    assert got == want
    scanned = [w for w in got if w[1] is not None]
    if world == "pod_affinity_many":
        assert not scanned
    else:
        assert scanned and any(w[2] for w in scanned)
