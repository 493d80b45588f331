"""Incremental cross-cycle encode cache.

Consecutive scheduling cycles see snapshots that differ by a handful of
pods and nodes, and one cycle of the twin pipeline encodes three times
(reclaim's and preempt's float64 scans, allocate's float32 solve). This
module makes the encode cost scale with the *delta*:

- **signature memos**: `_task_signature` / `_node_signature` results are
  memoized per pod uid / node name, validated by *object identity* of
  the underlying API object (`task.pod` / `node_info.node`). Snapshot
  clones share those objects (TaskInfo.clone / NodeInfo.clone keep the
  reference), and every store-side change replaces the object wholesale,
  so identity is a sound freshness check with zero recomputation.
- **pair memo**: the static (task-group x node-group) predicate verdict
  and preferred-node-affinity score are pure functions of the two
  signatures (the same property the encoder's group dedup already
  relies on); unchanged group pairs are reused verbatim, so the
  O(GT*GN) compat product is paid only for *new* pairs.
- **block caches**: the task-side products of one encode (pending
  extraction, row order, grouping, dense task arrays) are reusable
  wholesale while the session is unmutated (`Session.state_seq`) and
  the job objects are identical; the node-side statics (signatures,
  condition/pressure verdicts, max_task_num) reuse per node while its
  `Node` object is unchanged. A steady-state warm encode is therefore
  O(dirty + gather): only churned objects recompute, plus the dynamic
  residency slabs (idle/releasing/used), which re-gather every encode
  because binds move them.
- **dirty feed** (`note_store_event`): a store's informer handlers report
  node/pod/podgroup/queue churn; each event bumps a monotonic `version`,
  drops the per-object memo entries, and meters
  `encode_cache_invalidations_total{reason}`. Identity validation makes
  the feed *advisory* for correctness — it bounds memo growth (deleted
  objects leave the memo), makes invalidation observable, and stamps a
  store version onto cache state for debugging. Listeners
  (`add_store_listener`) get every event whether the cache is on or not.

The package switch ``set_enabled(False)`` turns all of it off; the
``encode.cache`` fault point poisons the cache for one encode — the whole
state is dropped and that encode runs cold, which is also the recovery
story for any suspected-stale cache. Warm output is byte-identical to
cold by construction (every reused value is the value the cold path
would recompute).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kube_batch_tpu_torch import faults, metrics

log = logging.getLogger(__name__)

# Memo-size backstops: a cluster-scale snapshot holds ~400k pods / 40k
# nodes; past these the whole layer clears (cold next encode) rather
# than growing without bound on pathological churn.
_MAX_POD_ENTRIES = 2_000_000
_MAX_NODE_ENTRIES = 200_000
_MAX_PAIR_ENTRIES = 500_000

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> None:
    """The package switch: off, every encode runs cold and the dirty feed
    leaves the cache alone."""
    global _enabled
    _enabled = bool(flag)


class _TaskBlock:
    """One encode's task-side products, reusable while the session is
    unmutated and the job objects are identical."""

    __slots__ = (
        "session", "state_seq", "shortlist", "queues", "dtype", "pad",
        "job_list", "job_idx", "task_list", "task_plain", "host_only",
        "job_ranges", "host_only_rows", "ref_label_keys",
        "scalar_task_names", "interesting_ports",
        # grouping per interpod flag: {bool: (task_gid, t_reps, t_rep_sigs)}
        "groupings",
        # dense array bundle keyed by (scalar_names, ports): see encode.py
        "arrays_key", "arrays",
    )


class _NodeStatic:
    __slots__ = ("node", "ok", "max_tasks", "sig", "sig_label_keys")

    def __init__(self, node) -> None:
        self.node = node
        self.ok = None
        self.max_tasks = None
        self.sig = None
        self.sig_label_keys = None


class EncodeCache:
    """Process-wide incremental encode state (see module docstring).

    Thread-safe for the dirty feed (informer handlers run in store
    writer threads); the encode-side memo methods are called from the
    single scheduling thread, matching the session's own threading
    model.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: monotonic store version; bumped by every relevant store event
        self.version = 0
        self._pod_sigs: dict[str, tuple] = {}  # uid -> (pod, sig, sig_labels)
        self._node_static: dict[str, _NodeStatic] = {}
        self._pairs: dict[tuple, tuple] = {}  # (tsig, nsig) -> (compat, aff)
        self._task_block: Optional[_TaskBlock] = None
        # per-encode stats (reset by begin_encode)
        self._hits = 0
        self._misses = 0

    # -- dirty feed (cache/watch events) ------------------------------------

    def note_store_event(self, kind: str, key: str) -> None:
        """One informer event: bump the monotonic version, drop the
        object's memo entries, meter the invalidation. ``kind`` is the
        store kind ("pods"/"nodes"/...), ``key`` the object key (pod
        uid / node name)."""
        with self._lock:
            self.version += 1
            dropped = False
            if kind == "nodes":
                dropped = self._node_static.pop(key, None) is not None
            elif kind == "pods":
                dropped = self._pod_sigs.pop(key, None) is not None
            # any churn invalidates the whole-encode task block: its
            # validity is session-identity-scoped anyway, but dropping
            # here keeps a dead session's world from being retained
            # across real store churn
            if self._task_block is not None and kind in ("pods", "podgroups", "queues"):
                self._task_block = None
                dropped = True
        if dropped:
            metrics.register_encode_cache_invalidation(kind)

    def invalidate_all(self, reason: str) -> None:
        with self._lock:
            self.version += 1
            self._pod_sigs.clear()
            self._node_static.clear()
            self._pairs.clear()
            self._task_block = None
        metrics.register_encode_cache_invalidation(reason)

    # -- per-encode lifecycle ------------------------------------------------

    def begin_encode(self) -> None:
        self._hits = 0
        self._misses = 0
        # capacity backstops (cold next encode is the worst case)
        if (
            len(self._pod_sigs) > _MAX_POD_ENTRIES
            or len(self._node_static) > _MAX_NODE_ENTRIES
            or len(self._pairs) > _MAX_PAIR_ENTRIES
        ):
            self.invalidate_all("capacity")

    def end_encode(self) -> None:
        total = self._hits + self._misses
        if self._hits:
            metrics.register_encode_cache_hits(self._hits)
        metrics.set_encode_warm_fraction(self._hits / total if total else 0.0)

    @property
    def warm_fraction(self) -> float:
        total = self._hits + self._misses
        return self._hits / total if total else 0.0

    # -- memo layers ---------------------------------------------------------

    def task_sig(self, task, with_labels: bool, sig_fn) -> tuple:
        """Memoized `_task_signature(task, with_labels)`; valid while the
        entry's Pod object IS the task's Pod object."""
        entry = self._pod_sigs.get(task.uid)
        pod = task.pod
        if entry is not None and entry[0] is pod:
            sig = entry[2 if with_labels else 1]
            if sig is not None:
                self._hits += 1
                return sig
            sig = sig_fn(task, with_labels)
            self._pod_sigs[task.uid] = (
                pod,
                sig if not with_labels else entry[1],
                sig if with_labels else entry[2],
            )
            self._misses += 1
            return sig
        sig = sig_fn(task, with_labels)
        self._pod_sigs[task.uid] = (
            pod,
            sig if not with_labels else None,
            sig if with_labels else None,
        )
        self._misses += 1
        return sig

    def node_entry(self, node_info) -> _NodeStatic:
        """The per-node static slot (sig + condition/pressure verdict +
        max_task_num), re-keyed whenever the Node object was replaced."""
        entry = self._node_static.get(node_info.name)
        if entry is None or entry.node is not node_info.node:
            entry = _NodeStatic(node_info.node)
            self._node_static[node_info.name] = entry
        return entry

    def node_row(self, node_info, label_keys, sig_fn, statics_fn) -> _NodeStatic:
        """One cache touch per node per encode: the filled static slot
        (sig + verdicts), counted as one warm unit when fully reused."""
        entry = self.node_entry(node_info)
        if entry.ok is None:
            entry.ok, entry.max_tasks = statics_fn(node_info)
        if entry.sig is None or entry.sig_label_keys != label_keys:
            entry.sig = sig_fn(node_info, label_keys)
            entry.sig_label_keys = label_keys
            self._misses += 1
        else:
            self._hits += 1
        return entry

    def pair(self, tsig, nsig, compute) -> tuple:
        """(static compat verdict, preferred-affinity score) for one
        (task-group, node-group) signature pair — pure in the sigs."""
        key = (tsig, nsig)
        got = self._pairs.get(key)
        if got is not None:
            self._hits += 1
            return got
        got = compute()
        self._pairs[key] = got
        self._misses += 1
        return got

    # -- task block ----------------------------------------------------------

    def lookup_task_block(
        self, session, shortlist, queues, dtype, pad
    ) -> Optional[_TaskBlock]:
        """The whole task side of the previous encode, valid iff the
        session object and its mutation counter match (every
        allocate/pipeline/evict and the bulk replay bump `state_seq`)
        and the job/queue objects are identical (list `==` on
        identity-compared elements — TaskInfo/JobInfo define no __eq__)."""
        tb = self._task_block
        if (
            tb is not None
            and session is not None
            and tb.session is session
            and tb.state_seq == session.state_seq
            and tb.dtype == dtype
            and tb.pad == pad
            and tb.shortlist == shortlist
            and tb.queues is queues
        ):
            self._hits += 1
            return tb
        self._misses += 1
        return None

    def store_task_block(self, session, shortlist, queues, dtype, pad, **fields) -> Optional[_TaskBlock]:
        if session is None:
            return None
        tb = _TaskBlock()
        tb.session = session
        tb.state_seq = session.state_seq
        tb.shortlist = list(shortlist)
        tb.queues = queues
        tb.dtype = dtype
        tb.pad = pad
        tb.groupings = {}
        tb.scalar_task_names = None
        tb.interesting_ports = None
        tb.arrays_key = None
        tb.arrays = None
        for k, v in fields.items():
            setattr(tb, k, v)
        self._task_block = tb
        return tb


_cache = EncodeCache()


def get() -> EncodeCache:
    return _cache


def active() -> Optional[EncodeCache]:
    """The cache for this encode, or None (disabled / poisoned).

    The ``encode.cache`` fault point models a poisoned cache: the whole
    state is dropped and the encode runs cold — the operator's recovery
    story for a suspected-stale cache (switch it off or restart; the next
    cycle rebuilds from the store)."""
    if not _enabled:
        return None
    if faults.should_fire("encode.cache"):
        _cache.invalidate_all("fault")
        return None
    return _cache


# Store listeners: each gets the full event `(kind, key, obj, old)`
# whether or not the encode cache itself is enabled — the dirty feed
# doubles as a wake-up trigger. Listener errors are swallowed per call:
# an informer thread must never die on a trigger bug.
_listeners: list = []
_listeners_lock = threading.Lock()


def add_store_listener(fn) -> None:
    with _listeners_lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_store_listener(fn) -> None:
    with _listeners_lock:
        if fn in _listeners:
            _listeners.remove(fn)


def listener_count() -> int:
    """How many listeners are currently registered. A stopped consumer
    must leave this at its pre-attach value — a leaked listener keeps
    firing into a dead consumer on every store event."""
    with _listeners_lock:
        return len(_listeners)


def note_store_event(kind: str, key: str, obj=None, old=None) -> None:
    """Module-level dirty-feed entry point (what a store's informer
    handlers call). ``obj`` is the post-event object (None on delete),
    ``old`` the pre-event one (None on add)."""
    if _enabled:
        _cache.note_store_event(kind, key)
    if _listeners:
        with _listeners_lock:
            listeners = list(_listeners)
        for fn in listeners:
            try:
                fn(kind, key, obj, old)
            except Exception as e:  # noqa: BLE001 - see the listeners' comment
                log.error("store listener failed on %s/%s: %s", kind, key, e)
