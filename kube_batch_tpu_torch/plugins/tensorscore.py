"""tensorscore plugin: nodeorder's scores, computed as whole-node-axis
vectors (SURVEY.md section 2.7d — vectorized scoring exposed through the
plugin registry so a conf can toggle it).

Scores are policy-identical to the nodeorder plugin (same float64
formulas via nodeorder.vectorized_least_balanced, same weights
arguments), but the per-(task, node) calls the serial actions make
during PrioritizeNodes (scheduler_helper.go:60-109) are served from one
numpy pass per (task, session-state):

- the per-node Used vectors are re-read from the live NodeInfo objects
  on each (task, ssn.state_seq) memo miss — one O(N) attribute sweep per
  scored task instead of O(N) *per-plugin-formula* Python arithmetic.
  Reading live state (rather than mirroring events) keeps the scores
  correct under every mutation path, including torch_allocate's bulk
  replay, which updates node accounting without firing session events
  (and bumps ``state_seq`` so this memo misses after it);
- preferred node-affinity sums are memoized per task (pod specs are
  immutable within a session);
- InterPodAffinity reuses nodeorder's full symmetric-weight algorithm,
  memoized per (task, ssn.state_seq), with nodeorder's own
  no-terms-anywhere fast path.

Conf usage — swap it in for nodeorder::

    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
      - name: predicates
      - name: proportion
      - name: tensorscore

The torch_allocate action and the scan actions (torch_reclaim,
torch_backfill, torch_preempt) treat it exactly like nodeorder (same
policy envelope, same weights).
"""

from __future__ import annotations

import numpy as np

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.plugins.nodeorder import (
    BALANCED_RESOURCE_WEIGHT,
    LEAST_REQUESTED_WEIGHT,
    NODE_AFFINITY_WEIGHT,
    POD_AFFINITY_WEIGHT,
    any_pod_affinity_terms,
    interpod_affinity_scores,
    vectorized_least_balanced,
)


class TensorScorePlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    @property
    def name(self) -> str:
        return "tensorscore"

    def on_session_open(self, ssn: Session) -> None:
        least_req_w = self.arguments.get_int(LEAST_REQUESTED_WEIGHT, 1)
        balanced_w = self.arguments.get_int(BALANCED_RESOURCE_WEIGHT, 1)
        node_aff_w = self.arguments.get_int(NODE_AFFINITY_WEIGHT, 1)
        pod_aff_w = self.arguments.get_int(POD_AFFINITY_WEIGHT, 1)

        names = sorted(ssn.nodes)
        row_of = {name: i for i, name in enumerate(names)}
        nodes = [ssn.nodes[name] for name in names]
        n = len(nodes)
        cap_cpu = np.asarray([nd.allocatable.milli_cpu for nd in nodes], np.float64)
        cap_mem = np.asarray([nd.allocatable.memory for nd in nodes], np.float64)
        zeros = np.zeros(n, np.float64)

        # live Used sweep, shared across every task scored at one state_seq
        used_memo: dict = {"seq": -1, "cpu": zeros, "mem": zeros}

        def used_vectors():
            if used_memo["seq"] != ssn.state_seq:
                used_memo["seq"] = ssn.state_seq
                used_memo["cpu"] = np.asarray(
                    [nd.used.milli_cpu for nd in nodes], np.float64
                )
                used_memo["mem"] = np.asarray(
                    [nd.used.memory for nd in nodes], np.float64
                )
            return used_memo["cpu"], used_memo["mem"]

        # -- per-task lazy vectors ----------------------------------------
        node_aff_cache: dict[str, np.ndarray] = {}

        def node_aff_vec(task: TaskInfo) -> np.ndarray:
            aff = task.pod.affinity
            if aff is None or not aff.node_affinity_preferred:
                return zeros
            vec = node_aff_cache.get(task.uid)
            if vec is None:
                vec = np.asarray(
                    [
                        float(
                            sum(
                                w
                                for w, term in aff.node_affinity_preferred
                                if term.matches(nd.node.labels if nd.node else {})
                            )
                        )
                        for nd in nodes
                    ],
                    np.float64,
                )
                node_aff_cache[task.uid] = vec
            return vec

        interpod_memo: dict = {"uid": None, "seq": -1, "vec": zeros, "active": None}

        def interpod_vec(task: TaskInfo) -> np.ndarray:
            if interpod_memo["active"] is None:
                all_tasks = (t for j in ssn.jobs.values() for t in j.tasks.values())
                interpod_memo["active"] = any_pod_affinity_terms(ssn.nodes, all_tasks)
            if not interpod_memo["active"]:
                return zeros
            if interpod_memo["uid"] != task.uid or interpod_memo["seq"] != ssn.state_seq:
                scores = interpod_affinity_scores(task, ssn.nodes)
                interpod_memo["uid"] = task.uid
                interpod_memo["seq"] = ssn.state_seq
                interpod_memo["vec"] = np.asarray(
                    [scores[name] for name in names], np.float64
                )
            return interpod_memo["vec"]

        memo: dict = {"uid": None, "seq": -1, "scores": zeros}

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            if memo["uid"] != task.uid or memo["seq"] != ssn.state_seq:
                used_cpu, used_mem = used_vectors()
                least, balanced = vectorized_least_balanced(
                    used_cpu + task.resreq.milli_cpu,
                    used_mem + task.resreq.memory,
                    cap_cpu,
                    cap_mem,
                )
                memo["uid"] = task.uid
                memo["seq"] = ssn.state_seq
                memo["scores"] = (
                    least * least_req_w
                    + balanced * balanced_w
                    + node_aff_vec(task) * node_aff_w
                    + interpod_vec(task) * pod_aff_w
                )
            row = row_of.get(node.name)
            return float(memo["scores"][row]) if row is not None else 0.0

        ssn.add_node_order_fn(self.name, node_order_fn)


def new(arguments: Arguments) -> Plugin:
    return TensorScorePlugin(arguments)
