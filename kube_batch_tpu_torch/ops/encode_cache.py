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

- **tensor arena** (`TensorArena`): the solve's static buffers stay
  resident on the card across cycles; an upload of the same slab reuses
  the buffer, writes only the changed rows into it in place, or uploads
  it whole.

The package switch ``set_enabled(False)`` turns all of it off (the
arena included); the
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

import numpy as np

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
    writer threads) and for several scheduling threads encoding at once
    (in-process federation runs one per shard, each over its own pending
    set): every memo entry is published whole and never mutated after,
    so a thread reads either a complete entry or none (a per-node slot is
    replaced, not updated, when its label keys or Node object change),
    and the per-encode hit/miss counts are per thread, so each encode's
    ``warm_fraction`` is its own.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: monotonic store version; bumped by every relevant store event
        self.version = 0
        self._pod_sigs: dict[str, tuple] = {}  # uid -> (pod, sig, sig_labels)
        self._node_static: dict[str, _NodeStatic] = {}
        self._pairs: dict[tuple, tuple] = {}  # (tsig, nsig) -> (compat, aff)
        self._task_block: Optional[_TaskBlock] = None
        # per-encode stats of the calling thread (reset by begin_encode)
        self._stats = threading.local()

    @property
    def _hits(self) -> int:
        return getattr(self._stats, "hits", 0)

    @_hits.setter
    def _hits(self, n: int) -> None:
        self._stats.hits = n

    @property
    def _misses(self) -> int:
        return getattr(self._stats, "misses", 0)

    @_misses.setter
    def _misses(self, n: int) -> None:
        self._stats.misses = n

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

    def node_row(self, node_info, label_keys, sig_fn, statics_fn) -> _NodeStatic:
        """One cache touch per node per encode: the filled static slot
        (sig + condition/pressure verdict + max_task_num), counted as one
        warm unit when fully reused. A slot whose Node object or label
        keys differ is replaced by a new one (its verdicts carried over
        while the Node object is the same), so the slot a caller holds
        never changes under it."""
        entry = self._node_static.get(node_info.name)
        if (
            entry is not None
            and entry.node is node_info.node
            and entry.sig_label_keys == label_keys
        ):
            self._hits += 1
            return entry
        fresh = _NodeStatic(node_info.node)
        if entry is not None and entry.node is node_info.node:
            fresh.ok, fresh.max_tasks = entry.ok, entry.max_tasks
        else:
            fresh.ok, fresh.max_tasks = statics_fn(node_info)
        fresh.sig = sig_fn(node_info, label_keys)
        fresh.sig_label_keys = label_keys
        self._node_static[node_info.name] = fresh
        self._misses += 1
        return fresh

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


# -- device-resident tensor arena ---------------------------------------------


class _Slot:
    __slots__ = ("host", "device", "placement")

    def __init__(self, host, device, placement) -> None:
        self.host = host
        self.device = device
        self.placement = placement


class TensorArena:
    """Persistent device buffers for the solve's big inputs.

    The encoder rebuilds its host arrays every cycle, but between
    consecutive cycles most *rows* are unchanged (only nodes that took
    or released pods move). The arena keeps last cycle's device buffer
    plus the host array it was uploaded from; the next upload of the
    same (name, shape, dtype) to the same placement:

    - reuses the buffer outright when the host array is the *same
      object* or compares equal;
    - for a ``ROW_DELTA`` name without a mesh, writes only the changed
      rows into the resident buffer in place (``index_copy_``: its
      ``data_ptr()`` does not move) when at most
      ``ROW_DELTA_MAX_FRACTION`` of the rows moved;
    - uploads the slab whole otherwise (a new buffer).

    The row comparison runs on host numpy; the comparison is the truth,
    so no dirty feed is needed. Host arrays handed to the arena must not
    be mutated afterwards: a caller that changes a slab builds a new host
    array and uploads it (``FusedSolver``'s affinity refresh does).

    A slot's placement is a ``torch.device`` (``device=``, or the arena's
    own), or with a mesh the mesh's device tuple plus the name: a mesh
    slab is a tuple of per-shard tensors, split along the node axis for
    the names ``parallel.sharded.SHARD_AXIS`` lists and replicated
    otherwise, and is reused on equal content or put whole, never row
    updated.

    **Pipelined mode** (``KBT_PIPELINE``): the slots double-buffer. Each
    name keeps two (host memo, device buffer) banks and every cycle
    (``_flip_bank``, which ``device_view`` calls) flips the active bank, so cycle
    N+1's in-place row update writes a buffer that cycle N's readers are
    not reading. The row delta is computed against the active bank's own
    memo, two cycles old, so a warm upload may write more rows than the
    single-buffer path, with the same result.

    The arena has no lock: each one belongs to one owner whose cycles run
    one at a time (``TorchAllocateAction`` keeps one per scheduler cache).

    **What the program takes.** The port's rungs call ``upload`` (through
    ``put``) with the names their kernels read (``kube_batch_tpu_torch/
    RUNBOOK.md`` maps them): only ``fused_fstatic`` is row updated, by the
    fused rung's affinity refresh after a pod-affinity host step; every
    other name is reused or uploaded whole. ``MANAGED``, ``device_view``,
    ``refresh`` and the ``node_*`` row-delta names are the JAX package's
    surface, kept so that the arena answers as the JAX one does; no path
    of the program takes them.
    """

    # JAX's node-axis slabs, and kernel B1's flat float buffer (a "row" is
    # an element: the affinity refresh rewrites a few scores), take the
    # row-delta path; the rest are replaced wholesale when their content
    # changes
    ROW_DELTA = frozenset({"node_idle", "node_rel", "node_used", "node_alloc", "fused_fstatic"})
    MANAGED = (
        "node_idle", "node_rel", "node_used", "node_alloc",
        "task_req", "task_res", "compat", "aff_sc", "pod_sc",
    )
    # past this fraction of changed rows a full transfer is cheaper
    # than the indexed write
    ROW_DELTA_MAX_FRACTION = 0.25

    def __init__(self, device=None) -> None:
        self.device = _indexed("cuda" if device is None else device)
        self._slots: dict[tuple, _Slot] = {}  # (name, bank) -> slot
        self._bank = 0
        self.reuses = 0
        self.row_updates = 0
        self.full_uploads = 0
        self.rows_uploaded = 0
        # uploads that raised and were redone as a fresh copy (``put``)
        self.failures = 0
        # high-water mark of live device bytes across all slabs and banks,
        # refreshed by _account_hbm
        self.hbm_watermark_bytes = 0

    @property
    def bank(self) -> int:
        return self._bank

    def counters(self) -> dict[str, int]:
        return {
            "reuses": self.reuses, "row_updates": self.row_updates, "full_uploads": self.full_uploads,
            "rows_uploaded": self.rows_uploaded, "failures": self.failures,
        }

    def _flip_bank(self) -> None:
        from kube_batch_tpu_torch import pipeline

        self._bank = (self._bank ^ 1) if pipeline.enabled() else 0

    def _placement_key(self, mesh, name: str, device):
        if mesh is None:
            return device
        return (tuple(mesh), name)

    def device_view(self, arrays: dict, mesh=None) -> dict:
        """``arrays`` with the ``MANAGED`` slabs replaced by device
        tensors (on the arena's device, or per shard of ``mesh``);
        everything else passes through."""
        out = dict(arrays)
        self._flip_bank()
        for name in self.MANAGED:
            host = arrays.get(name)
            if host is None:
                continue
            out[name] = self.upload(name, host, mesh=mesh)
        self._account_hbm()
        return out

    def hbm_bytes_by_slab(self) -> dict[str, int]:
        """Live device bytes per slab, summed over banks (in pipelined
        mode both double-buffers are resident, so both count) and over a
        mesh slab's shards."""
        out: dict[str, int] = {}
        for (name, _bank), slot in self._slots.items():
            parts = slot.device if isinstance(slot.device, tuple) else (slot.device,)
            out[name] = out.get(name, 0) + sum(int(t.nbytes) for t in parts)
        return out

    def _account_hbm(self) -> None:
        total = 0
        for slab, nbytes in self.hbm_bytes_by_slab().items():
            metrics.set_arena_hbm_bytes(slab, nbytes)
            total += nbytes
        if total > self.hbm_watermark_bytes:
            self.hbm_watermark_bytes = total
        metrics.set_arena_hbm_watermark(self.hbm_watermark_bytes)

    def refresh(self, views: list, name: str, host, mesh=None) -> None:
        """Re-upload one array into every live device view."""
        dev = self.upload(name, host, mesh=mesh)
        for v in views:
            v[name] = dev

    def upload(self, name: str, host, mesh=None, device=None):
        """``host`` (an array, or a CPU tensor) on the device: the
        resident buffer reused or row updated, or a full upload. Returns
        the device tensor (a tuple of per-shard tensors with a mesh)."""
        host = np.asarray(host)
        device = self.device if device is None else _indexed(device)
        slot = self._slots.get((name, self._bank))
        placement = self._placement_key(mesh, name, device)
        if (
            slot is not None
            and slot.placement == placement
            and slot.host.shape == host.shape
            and slot.host.dtype == host.dtype
        ):
            if slot.host is host:
                self.reuses += 1
                return slot.device
            if name in self.ROW_DELTA and host.ndim >= 1 and mesh is None:
                neq = slot.host != host
                changed = (
                    np.nonzero(neq.any(axis=tuple(range(1, host.ndim))))[0]
                    if host.ndim > 1
                    else np.nonzero(neq)[0]
                )
                if changed.size == 0:
                    slot.host = host
                    self.reuses += 1
                    return slot.device
                if changed.size <= self.ROW_DELTA_MAX_FRACTION * host.shape[0]:
                    _row_scatter(slot.device, changed, host)
                    slot.host = host
                    self.row_updates += 1
                    self.rows_uploaded += int(changed.size)
                    return slot.device
            elif np.array_equal(slot.host, host):
                slot.host = host
                self.reuses += 1
                return slot.device
        dev = _put(host, mesh, name, device)
        self._slots[(name, self._bank)] = _Slot(host, dev, placement)
        self.full_uploads += 1
        return dev

    def clear(self) -> None:
        self._slots.clear()
        self._bank = 0
        self.hbm_watermark_bytes = 0


def _indexed(device):
    """A bare ``cuda`` as the current card's indexed device, so that
    placements compare equal however the caller named the card."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to(src, device):
    """A copy of the CPU tensor ``src`` on ``device``, never waiting for
    work queued on the card. To a card whose current stream is idle it goes
    up from pageable memory, as a plain copy would (the CUDA driver stages it
    before the call returns, and nothing is queued ahead of it); behind
    queued work, through ``_staged_to``."""
    import torch

    if device.type != "cuda":
        return src.to(device, copy=True)
    if torch.cuda.current_stream(device).query():
        return src.to(device, non_blocking=True)
    return _staged_to(src, device)


def _staged_to(src, device):
    """``src`` on the card through a pinned staging copy with
    ``non_blocking=True`` on the current stream, so the upload does not
    wait for queued work (the staging block is not handed out again before
    the copy has run)."""
    import torch

    stage = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    stage.copy_(src)
    return stage.to(device, non_blocking=True)


def _put(host: np.ndarray, mesh, name: str, device):
    """A full upload: a new buffer on ``device``, or with a mesh a tuple of
    per-shard buffers (split along ``SHARD_AXIS[name]``, or replicated)."""
    import torch

    src = torch.from_numpy(host if host.flags.writeable else host.copy())
    if mesh is None:
        return _to(src, device)
    from kube_batch_tpu_torch.parallel.sharded import SHARD_AXIS

    axis = SHARD_AXIS.get(name)
    if axis is None:
        return tuple(_to(src, _indexed(d)) for d in mesh)
    m = len(mesh)
    if host.shape[axis] % m:
        raise ValueError(f"{name}: node axis {host.shape[axis]} not divisible by mesh size {m}")
    return tuple(_to(part.contiguous(), _indexed(d)) for part, d in zip(src.chunk(m, dim=axis), mesh))


def _row_scatter(buf, rows: np.ndarray, new_host: np.ndarray) -> None:
    """``buf[rows] = new_host[rows]`` in place (``index_copy_``; the
    buffer's ``data_ptr()`` does not move). On a card the row indices and
    the rows go up together through one pinned staging buffer, copied
    with ``non_blocking=True`` on the current stream, which the write
    then follows."""
    import torch

    vals = np.ascontiguousarray(new_host[rows])
    if buf.device.type != "cuda":
        buf.index_copy_(0, torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(vals))
        return
    n = int(rows.size)
    head = 8 * n  # int64 indices first: the rows after them stay 8-byte aligned
    stage = torch.empty(head + vals.nbytes, dtype=torch.uint8, pin_memory=True)
    staged = stage.numpy()
    staged[:head].view(np.int64)[:] = rows
    staged[head:] = vals.reshape(-1).view(np.uint8)
    dev = stage.to(buf.device, non_blocking=True)
    idx = dev[:head].view(torch.int64)
    new = dev[head:].view(buf.dtype).view((n,) + tuple(buf.shape[1:]))
    buf.index_copy_(0, idx, new)


def put(arena: Optional[TensorArena], name: str, host, device, mesh=None):
    """``host`` on ``device`` (or per shard of ``mesh``) through ``arena``,
    or as a plain copy when there is none. A failed arena upload is
    logged, counted in ``arena.failures`` and clears the arena (its memo
    may no longer match its buffers); the slab then goes up as a fresh
    copy to the same device. There is no fallback to the CPU."""
    if arena is not None:
        try:
            return arena.upload(name, host, mesh=mesh, device=device if mesh is None else None)
        except Exception:
            log.exception("tensor arena upload of %s failed; clearing the arena and uploading afresh", name)
            arena.failures += 1
            arena.clear()
    return _put(np.asarray(host), mesh, name, None if mesh is not None else _indexed(device))


# -- parity smokes (the verify gate's encode-cache and pipeline checks) ------

_SMOKE_TIERS = (
    "tiers:\n"
    "- plugins:\n"
    "  - name: priority\n"
    "  - name: gang\n"
    "  - name: conformance\n"
    "- plugins:\n"
    "{second}"
)


def smoke(device: str = "cuda", out: Optional[dict] = None) -> int:
    """Cold-vs-warm parity on a seeded snapshot: a warm encode (and a
    1%-node-churn encode) must be byte-identical to a fresh cold encode,
    and the warm encode must reuse more than half of its units. The cold
    and warm arrays then go up to ``device`` through one ``TensorArena``:
    the warm upload must reuse every slab, and each device copy must equal
    its host array byte for byte. Returns 0 when clean; prints one line
    per failure; fills ``out`` (when given) with the summary."""
    import torch

    from kube_batch_tpu_torch.streaming import _check_device

    _check_device(device)

    from kube_batch_tpu_torch import actions, plugins  # noqa: F401  (registries)
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.models import multi_queue
    from kube_batch_tpu_torch.ops.encode import encode_session
    from kube_batch_tpu_torch.testing import FakeCache, build_node, build_resource_list

    conf = parse_scheduler_conf(_SMOKE_TIERS.format(second=(
        "  - name: drf\n  - name: predicates\n  - name: proportion\n  - name: nodeorder\n"
    )))

    def encode(ssn):
        return encode_session(
            ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float64,
            drf=ssn.plugins.get("drf"), proportion=ssn.plugins.get("proportion"),
            session=ssn,
        )

    def diff(a, b, what: str) -> list[str]:
        if set(a.arrays) != set(b.arrays):
            return [f"{what}: array key sets differ"]
        bad = []
        for k in a.arrays:
            x, y = np.asarray(a.arrays[k]), np.asarray(b.arrays[k])
            if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(x, y):
                bad.append(f"{what}: arrays[{k!r}] diverges")
        return bad

    ec = get()
    cache = FakeCache(multi_queue(600, 96))
    ssn = open_session(cache, conf.tiers)
    try:
        ec.invalidate_all("smoke")
        cold = encode(ssn)
        warm = encode(ssn)
        warm_fraction = get().warm_fraction
        problems = diff(cold, warm, "warm-vs-cold")
        if warm_fraction <= 0.5:
            problems.append(f"warm encode reused only {warm_fraction:.0%} of units")
        # 1% node churn: replace one node object (a label flip), re-encode,
        # compare against a fully cold encode of the same world
        churned = sorted(ssn.nodes)[0]
        ssn.nodes[churned].set_node(
            build_node(
                churned,
                build_resource_list(cpu=8, memory="16Gi", pods=110),
                labels={"smoke/churned": "1"},
            )
        )
        churn = encode(ssn)
        ec.invalidate_all("smoke")
        cold2 = encode(ssn)
        problems += diff(cold2, churn, "churn-vs-cold")
    finally:
        close_session(ssn)

    arena = TensorArena(device)
    for name, host in cold.arrays.items():
        arena.upload(name, host)
    before = arena.reuses
    for name, host in warm.arrays.items():
        dev = arena.upload(name, host)
        got = dev.cpu().numpy()
        if got.dtype != host.dtype or got.shape != host.shape or got.tobytes() != np.ascontiguousarray(host).tobytes():
            problems.append(f"arena on {device}: {name!r} differs from its host array")
    if arena.reuses - before != len(warm.arrays):
        problems.append(
            f"arena on {device}: the warm upload reused {arena.reuses - before} of {len(warm.arrays)} slabs"
        )
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

    for p in problems:
        print(f"encode-cache smoke: {p}")
    if not problems:
        print("encode-cache smoke: ok (warm + 1%-churn encodes byte-identical to cold)")
    if out is not None:
        out.update(
            ok=not problems, device=device, warm_fraction=warm_fraction,
            slabs=len(warm.arrays), arena=arena.counters(), problems=problems,
        )
    return 1 if problems else 0


def smoke_pipeline(device: str = "cuda", out: Optional[dict] = None) -> int:
    """Pipelined-vs-synchronous parity: one seeded world (600 pods on 96
    nodes, 57,600 pairs: above torch_allocate's size floor, so the fused
    rung solves it) scheduled for two cycles with ``KBT_PIPELINE`` off,
    then on. Cycle 1's binds must be equal in both runs, the pipelined
    dispatch deferred through the fence, the arena's banks ping-pong when
    pipelined and stay put when synchronous, and the fence never degrade.
    On a card each run must launch kernel B1. Returns 0 when clean;
    fills ``out`` (when given) with the summary."""
    import os

    import torch

    from kube_batch_tpu_torch.streaming import _check_device

    _check_device(device)

    from kube_batch_tpu_torch import actions, pipeline, plugins  # noqa: F401  (registries)
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, get_action, open_session
    from kube_batch_tpu_torch.models import multi_queue
    from kube_batch_tpu_torch.ops.fused_solve import fused_solve
    from kube_batch_tpu_torch.testing import FakeCache

    conf = parse_scheduler_conf(_SMOKE_TIERS.format(second="  - name: predicates\n  - name: nodeorder\n"))
    action = get_action("torch_allocate")
    args = {"torch_allocate": {"device": device}}

    def run(pipelined: bool):
        save = os.environ.get(pipeline.ENV)
        os.environ[pipeline.ENV] = "1" if pipelined else "0"
        pipeline.reset()
        get().invalidate_all("smoke")
        launches0 = fused_solve.launches
        try:
            cache = FakeCache(multi_queue(600, 96))
            banks, deferred, tiers = [], [], []
            cycle1_binds = None
            for _ in range(2):  # two cycles: the bank must ping-pong
                ssn = open_session(cache, conf.tiers, args)
                action.execute(ssn)
                banks.append(action._arena.bank if action._arena is not None else None)
                tiers.append(action.last_solver_tier)
                deferred.append(getattr(ssn, "deferred_dispatch", None) is not None)
                close_session(ssn)  # joins the deferred dispatch first
                if cycle1_binds is None:
                    cycle1_binds = dict(cache.binder.binds)
            degraded = pipeline.fence.degraded_reason
            return cycle1_binds, banks, deferred, tiers, fused_solve.launches - launches0, degraded
        finally:
            if save is None:
                os.environ.pop(pipeline.ENV, None)
            else:
                os.environ[pipeline.ENV] = save
            pipeline.reset()

    problems = []
    sync_binds, sync_banks, sync_deferred, sync_tiers, sync_b1, sync_degraded = run(False)
    pipe_binds, pipe_banks, pipe_deferred, pipe_tiers, pipe_b1, pipe_degraded = run(True)
    if not sync_binds:
        problems.append("synchronous run bound nothing")
    if any(sync_deferred):
        problems.append("synchronous run unexpectedly deferred its dispatch")
    if not all(pipe_deferred):
        problems.append("pipelined run never deferred its dispatch")
    if len(set(pipe_banks)) != 2:
        problems.append(f"arena banks did not ping-pong across pipelined cycles: {pipe_banks}")
    if len(set(sync_banks)) != 1:
        problems.append(f"synchronous run flipped arena banks: {sync_banks}")
    if pipe_binds != sync_binds:
        diverged = {
            k: (sync_binds.get(k), pipe_binds.get(k))
            for k in set(sync_binds) | set(pipe_binds)
            if sync_binds.get(k) != pipe_binds.get(k)
        }
        problems.append(f"pipelined binds diverge from synchronous: {diverged}")
    for reason in (sync_degraded, pipe_degraded):
        if reason is not None:
            problems.append(f"pipeline degraded during smoke: {reason}")
    if torch.device(device).type == "cuda" and not (sync_b1 and pipe_b1):
        problems.append(f"kernel B1 launched {sync_b1} times synchronous, {pipe_b1} pipelined")
    for p in problems:
        print(f"pipeline smoke: {p}")
    if not problems:
        print(
            "pipeline smoke: ok (pipelined cycle bind-for-bind identical to "
            f"synchronous, dispatch deferred, arena banks {pipe_banks})"
        )
    if out is not None:
        out.update(
            ok=not problems, device=device, binds=len(sync_binds or {}),
            banks={"sync": sync_banks, "pipelined": pipe_banks},
            tiers={"sync": sync_tiers, "pipelined": pipe_tiers},
            b1_launches={"sync": sync_b1, "pipelined": pipe_b1}, problems=problems,
        )
    return 1 if problems else 0


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="encode-cache parity smoke (default) or the pipelined-cycle parity smoke (--pipeline)"
    )
    parser.add_argument("--pipeline", action="store_true", help="run the pipelined-vs-synchronous smoke")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"), help="where the smoke runs (default: the card)"
    )
    parser.add_argument("--json", action="store_true", help="print the summary as JSON on the last line")
    args = parser.parse_args(argv)
    summary: dict = {}
    rc = (smoke_pipeline if args.pipeline else smoke)(device=args.device, out=summary)
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    return rc


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` executes this
    # file as __main__, whose module-level singleton would otherwise be
    # a different object than the one encode_session uses
    from kube_batch_tpu_torch.ops.encode_cache import main as _canonical_main

    raise SystemExit(_canonical_main())
