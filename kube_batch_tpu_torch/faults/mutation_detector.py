"""Cache-mutation detector.

The reference gates every unit run on ``KUBE_CACHE_MUTATION_DETECTOR=true``
(hack/make-rules/test.sh:27-28): the k8s mutation detector deep-copies
each informer-cache object and panics when shared state is mutated in
place. The equivalent risk here is real — the ClusterStore's objects are
shared by reference across the cache mirror, every session snapshot
(TaskInfo.pod, JobInfo.pod_group), the watch hub serializers, and the
async write pool — and correctness rests on the convention that every
legitimate write goes through ``dataclasses.replace`` + ``store.update_*``
(object REPLACEMENT, never in-place mutation).

Mechanics: ``snapshot()`` records (object identity, content digest) for
every stored object; ``verify()`` re-digests and fires for any object
whose identity is unchanged (no store update replaced it) but whose
content differs — that is precisely an in-place mutation of shared
cluster state. Records hold strong references, so id() reuse cannot
alias a freed object.

One deliberate mask: PodGroup ``status`` is excluded from the digest.
The scheduler itself owns status write-back (close_session ->
update_job_status), and ``JobInfo.clone`` shares the PodGroup object
with the mirror by design (api/job_info.py), so status mutation is the
sanctioned channel; spec/metadata mutations still fire.

Enabled via ``KBT_CACHE_MUTATION_DETECTOR`` (the test suite's conftest
turns it on, mirroring the reference's test gate); the scheduler wires it
around each cycle of a cache that has a store when enabled.
"""

from __future__ import annotations

import hashlib
import logging
import os

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.cache.store import KINDS, POD_GROUPS, obj_key

log = logging.getLogger(__name__)

ENV = "KBT_CACHE_MUTATION_DETECTOR"


def enabled() -> bool:
    return os.environ.get(ENV, "").strip().lower() in ("1", "true", "yes", "on")


class CacheMutationError(AssertionError):
    """Shared cluster state was mutated in place (the k8s mutation
    detector's panic, typed)."""


def _digest(kind: str, obj) -> str:
    if kind == POD_GROUPS:
        body = repr((obj.metadata, obj.spec))
    else:
        body = repr(obj)
    return hashlib.sha1(body.encode()).hexdigest()


class MutationDetector:
    """Digest-before / verify-after guard over one ClusterStore."""

    def __init__(self, store) -> None:
        self._store = store
        # (kind, key) -> (the object itself, digest). The strong ref both
        # pins identity semantics and keeps digesting race-free: objects
        # are only ever REPLACED under the store lock, never mutated by
        # legitimate writers.
        self._records: dict[tuple[str, str], tuple[object, str]] = {}

    def snapshot(self) -> None:
        self._records.clear()
        for kind in KINDS:
            for obj in self._store.list(kind):
                self._records[(kind, obj_key(kind, obj))] = (obj, _digest(kind, obj))

    def violations(self) -> list[str]:
        out: list[str] = []
        for kind in KINDS:
            for obj in self._store.list(kind):
                rec = self._records.get((kind, obj_key(kind, obj)))
                if rec is None or rec[0] is not obj:
                    # new since snapshot, or legitimately replaced via
                    # store.update_* — not ours to judge
                    continue
                if rec[1] != _digest(kind, obj):
                    out.append(f"{kind}/{obj_key(kind, obj)}")
        return out

    def verify(self) -> None:
        """Raise CacheMutationError (after metering + logging) if any
        cached object was mutated in place since snapshot()."""
        bad = self.violations()
        if not bad:
            return
        for name in bad:
            metrics.register_cache_mutation(name.split("/", 1)[0])
            log.error("cache mutation detected: %s was mutated in place", name)
        raise CacheMutationError(
            "cached cluster objects mutated in place (writes must go through "
            f"dataclasses.replace + store.update_*): {', '.join(bad)}"
        )
