"""Cycle-level tracing, flight recorder, and SLO accounting.

The histograms in ``metrics/`` answer "how slow"; this module answers
"where did this cycle's time go, and on which solver tier":

- **Spans.** A scheduling cycle opens a root span ``cycle``
  (scheduler.py) with children for the session's ``snapshot`` and
  ``commit`` (framework/session.py) and torch_allocate's ``encode`` (its
  cache temperature as ``warm_fraction``), ``solve`` (``tier``, ``mesh``,
  one ``host_step`` event per pause) and ``gang.assign`` (the replay and
  the dispatch). ``annotate`` puts the same label on the card's profile
  (``torch.profiler.record_function``), so a device trace lines up with
  the spans.
- **Flight recorder.** Finished spans land in a bounded in-memory ring
  (the last ``KBT_FLIGHT_RECORDER_CYCLES`` traces, default 256, about one
  trace per cycle) that is dumped to disk as JSON lines plus a Chrome
  trace-event file (loadable in Perfetto) on a fault point's fire, on a
  hard-deadline abort of a cycle, and on demand (``recorder.dump()``).
  The dump directory is ``KBT_FLIGHT_RECORDER`` (``0`` disables dumps),
  by default ``kbt-flight`` under the temporary directory.
- **SLO accountant.** Sliding-window (``KBT_SLO_WINDOW_S``, default
  300 s) p50/p90/p99 per queue, kept in mergeable DDSketch-style
  :class:`QuantileSketch` rings (relative error ``alpha``, LRU-bounded
  queue cardinality); ``slo.publish()`` writes them to the ``slo_*``
  gauges of the exposition. The session feeds ``queue_wait`` (pod
  creation to dispatch) at every serial dispatch.

Tracing is off by default and costs one module-level bool test when off:
every entry point returns the shared no-op span singleton
(``span(...) is NOOP_SPAN``). Arm it with ``KBT_TRACE=1`` or the conf's
``trace:`` key, which the scheduler re-reads every cycle.

``SPAN_NAMES`` declares every span name a call site opens; ``check_tree``
flags an undeclared name or a dangling parent. The cache's ``dispatch``
span (cache/cache.py ``bind_many``) parents the kb-write pool's half of
the binds; ``gang.bind`` and ``txn.batch`` cover a federated shard's
conditional writes, and the store side of such a write (``store.bind``,
``store.txn``, server.py) joins the shard's trace through the
``X-KBT-Trace-Id``/``X-KBT-Span-Id`` headers (``current_headers`` on the
client, ``from_headers`` on the server). A streaming micro-cycle opens the
root ``micro_cycle`` (scheduler.py ``run_micro``) in place of ``cycle``,
and the streaming trigger emits one synthetic ``time_to_bind`` span per
pod (arrival to bind echo) after the fact, and the allocate actions open
``explain`` over their post-solve forensics (obs/explain.py) when
``KBT_EXPLAIN`` is on. ``install_signal_dump`` dumps the ring on
SIGTERM (the server's ``run``).
"""

from __future__ import annotations

import collections
import contextvars
import json
import logging
import math
import os
import signal
import tempfile
import threading
import time

from kube_batch_tpu_torch import metrics

__all__ = [
    "ENV",
    "RECORDER_ENV",
    "RECORDER_CYCLES_ENV",
    "SLO_WINDOW_ENV",
    "SPAN_NAMES",
    "DEBUG_ENDPOINTS",
    "HDR_TRACE",
    "HDR_SPAN",
    "Span",
    "NOOP_SPAN",
    "enabled",
    "configure",
    "span",
    "emit",
    "event",
    "current",
    "current_trace_id",
    "current_headers",
    "from_headers",
    "annotate",
    "FlightRecorder",
    "recorder",
    "QuantileSketch",
    "SLOAccountant",
    "slo",
    "chrome_events",
    "export_jsonl",
    "export_chrome",
    "check_tree",
    "install_signal_dump",
    "smoke",
    "main",
]

log = logging.getLogger(__name__)

ENV = "KBT_TRACE"
RECORDER_ENV = "KBT_FLIGHT_RECORDER"  # dump dir; "0" disables dumping
RECORDER_CYCLES_ENV = "KBT_FLIGHT_RECORDER_CYCLES"  # ring size in traces
SLO_WINDOW_ENV = "KBT_SLO_WINDOW_S"  # SLO sliding window, seconds

HDR_TRACE = "X-KBT-Trace-Id"
HDR_SPAN = "X-KBT-Span-Id"

# Every /debug/* route server.py serves. The analyzers hold it against
# server.py's route literals and the runbook's route table (KBT-R009/R010).
DEBUG_ENDPOINTS = (
    "/debug/trace",
    "/debug/slo",
    "/debug/explain",
    "/debug/fleet",
    "/debug/admission",
)

# Every span name a call site may open; check_tree flags any other, so a
# typo'd name cannot silently fork the trace tree.
SPAN_NAMES = (
    "cycle",        # scheduler.run_once root
    "micro_cycle",  # scheduler.run_micro root (streaming)
    "snapshot",     # session open: cache snapshot/clone
    "encode",       # torch_allocate's SoA encode (warm_fraction as attr)
    "solve",        # solver entry to the last segment (tier, mesh size)
    "gang.assign",  # the replay of the solved assignments and the dispatch
    "dispatch",     # cache.bind_many's host side: resolve under the mutex, submit
    "commit",       # PodGroup status write-back at session close
    "journal.append",  # write-intent journal append (seqs as attr)
    "gang.bind",    # one gang's conditional store write, conflict retries as events
    "txn.batch",    # coalesced multi-gang conditional-write round trip
    "store.bind",   # store side of a conditional bind (remote parent)
    "store.txn",    # store side of a coalesced txn batch (remote parent)
    "time_to_bind",  # synthetic: streaming arrival -> bind echo, per pod
    "explain",      # post-solve unschedulability forensics (obs/explain)
)

# Wall/perf anchor pair: spans are stamped with the monotonic clock (so
# durations survive NTP steps) and exported in wall-clock microseconds
# via this one anchor (so timelines from several processes line up).
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def _now_us(perf_t: float) -> int:
    return int((_WALL0 + (perf_t - _PERF0)) * 1e6)


def _new_id() -> str:
    return os.urandom(8).hex()


_enabled = False
_current: contextvars.ContextVar = contextvars.ContextVar("kbt_span", default=None)


def enabled() -> bool:
    return _enabled


class _NoopSpan:
    """The shared do-nothing span. Every tracing entry point returns
    this singleton when tracing is off — no allocation, no contextvar
    touch; tests assert ``span(...) is NOOP_SPAN`` to pin the cost."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = ""

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set_attr(self, *a, **kw) -> None:
        pass

    def event(self, *a, **kw) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed, attributed node of a trace tree; a context manager
    that makes itself the thread/task-current span for its extent."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start", "end", "attrs", "events", "tid", "_token",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: str = "",
        **attrs,
    ) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.end = 0.0
        self.attrs = attrs
        self.events: list[tuple[str, float, dict]] = []
        self.tid = threading.get_ident() & 0x7FFFFFFF
        self._token = None

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs) -> None:
        self.events.append((name, time.perf_counter(), attrs))

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self.finish()
        return False

    def finish(self) -> None:
        if self.end:
            return
        self.end = time.perf_counter()
        recorder.add(self)

    def to_dict(self) -> dict:
        end = self.end or time.perf_counter()
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_us": _now_us(self.start),
            "dur_us": max(1, int((end - self.start) * 1e6)),
            "pid": os.getpid(),
            "tid": self.tid,
            "attrs": dict(self.attrs),
            "events": [
                {"name": n, "ts_us": _now_us(t), "attrs": a}
                for n, t, a in self.events
            ],
        }


def span(name: str, parent=None, **attrs):
    """Open a span. Returns :data:`NOOP_SPAN` when tracing is off.

    ``parent`` overrides the ambient current span: pass the captured
    :func:`current` when crossing an executor boundary (contextvars do
    not propagate into pool threads), or a ``(trace_id, span_id)`` pair."""
    if not _enabled:
        return NOOP_SPAN
    if parent is None:
        parent = _current.get()
    if isinstance(parent, Span):
        return Span(name, parent.trace_id, parent.span_id, **attrs)
    if isinstance(parent, tuple) and len(parent) == 2 and parent[0]:
        return Span(name, parent[0], parent[1], **attrs)
    return Span(name, _new_id(), "", **attrs)


def emit(name: str, start: float, end: float, parent=None, **attrs) -> None:
    """Record an already-elapsed interval as a finished span.
    ``start``/``end`` are ``time.perf_counter()`` stamps."""
    if not _enabled:
        return
    s = span(name, parent=parent, **attrs)
    if s is NOOP_SPAN:
        return
    s.start = start
    s.end = end
    recorder.add(s)


def event(name: str, **attrs) -> None:
    """Attach an event to the current span, if any (cheap no-op off)."""
    if not _enabled:
        return
    cur = _current.get()
    if cur is not None:
        cur.event(name, **attrs)


def current():
    """The thread/task-current span, or None. Capture this before
    handing work to a pool thread and pass it as ``parent=``."""
    if not _enabled:
        return None
    return _current.get()


def current_trace_id() -> str:
    """The current span's trace id, or "" (the metric-exemplar hook)."""
    if not _enabled:
        return ""
    cur = _current.get()
    return cur.trace_id if cur is not None else ""


def current_headers() -> dict:
    """Wire headers propagating the current trace context, or {}."""
    if not _enabled:
        return {}
    cur = _current.get()
    if cur is None:
        return {}
    return {HDR_TRACE: cur.trace_id, HDR_SPAN: cur.span_id}


def from_headers(headers) -> tuple[str, str] | None:
    """Parse the propagation headers of an incoming request into a
    ``parent=`` value for :func:`span`, or None when absent/off."""
    if not _enabled:
        return None
    try:
        tid = headers.get(HDR_TRACE)
        sid = headers.get(HDR_SPAN)
    except AttributeError:
        return None
    if not tid:
        return None
    return (str(tid), str(sid or ""))


def annotate(label: str):
    """A ``torch.profiler.record_function`` range around a solver entry,
    so the card's profile lines up with the scheduler's spans; the no-op
    span when tracing is off."""
    if not _enabled:
        return NOOP_SPAN
    from torch.profiler import record_function

    return record_function(label)


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent traces (insertion-ordered by trace id;
    one trace is about one scheduling cycle). Dump snapshots under the
    lock and writes files outside it: no blocking I/O under a lock the
    hot span path takes."""

    def __init__(self, max_traces: int = 256) -> None:
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, list[dict]]" = (
            collections.OrderedDict()
        )
        self.max_traces = max_traces
        self._dumps = 0
        self._last_dump_mono = 0.0
        self.last_dump_path: str | None = None

    def add(self, sp: Span) -> None:
        d = sp.to_dict()
        with self._lock:
            bucket = self._traces.get(sp.trace_id)
            if bucket is None:
                self._traces[sp.trace_id] = bucket = []
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            bucket.append(d)

    def resize(self, max_traces: int) -> None:
        with self._lock:
            self.max_traces = max(1, int(max_traces))
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def spans(self) -> list[dict]:
        with self._lock:
            return [s for bucket in self._traces.values() for s in bucket]

    def trace_count(self) -> int:
        with self._lock:
            return len(self._traces)

    def dump_dir(self) -> str | None:
        raw = os.environ.get(RECORDER_ENV, "")
        if raw == "0":
            return None
        return raw or os.path.join(tempfile.gettempdir(), "kbt-flight")

    def dump(self, reason: str = "on_demand", min_interval_s: float = 0.0) -> str | None:
        """Write the ring to ``<dir>/flight-<pid>-<n>-<reason>.jsonl``
        plus a sibling ``.trace.json`` (Chrome trace-event format).
        Returns the JSONL path, or None when disabled/empty/throttled.
        ``min_interval_s`` rate-limits dump storms (a fault point firing
        every cycle must not turn the dump dir into a firehose)."""
        directory = self.dump_dir()
        if directory is None:
            return None
        with self._lock:
            now = time.monotonic()
            if min_interval_s and now - self._last_dump_mono < min_interval_s:
                return None
            snapshot = [s for bucket in self._traces.values() for s in bucket]
            if not snapshot:
                return None
            self._last_dump_mono = now
            self._dumps += 1
            seq = self._dumps
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in reason)
        base = os.path.join(directory, f"flight-{os.getpid()}-{seq}-{safe}")
        path = base + ".jsonl"
        try:
            os.makedirs(directory, exist_ok=True)
            export_jsonl(snapshot, path)
            export_chrome(snapshot, base + ".trace.json")
        except OSError as e:
            log.error("flight recorder dump to %s failed: %s", path, e)
            return None
        with self._lock:
            self.last_dump_path = path
        log.info("flight recorder: %d spans dumped to %s (%s)", len(snapshot), path, reason)
        return path


recorder = FlightRecorder()


# -- exporters ---------------------------------------------------------------


def export_jsonl(spans: list[dict], path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for s in spans:
            f.write(json.dumps(s, sort_keys=True, default=str))
            f.write("\n")
    return path


def chrome_events(spans: list[dict]) -> list[dict]:
    """Chrome trace-event records (Perfetto-loadable): one complete
    ("X") event per span, instant events for span events, and flow
    ("s"/"f") arrows stitching parent->child edges that cross a
    process or thread."""
    evs: list[dict] = []
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        args = dict(s["attrs"])
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s["parent_id"]:
            args["parent_id"] = s["parent_id"]
        evs.append({
            "name": s["name"], "cat": "kbt", "ph": "X",
            "ts": s["start_us"], "dur": s["dur_us"],
            "pid": s["pid"], "tid": s["tid"], "args": args,
        })
        for ev in s["events"]:
            evs.append({
                "name": ev["name"], "cat": "kbt", "ph": "i", "s": "t",
                "ts": ev["ts_us"], "pid": s["pid"], "tid": s["tid"],
                "args": dict(ev["attrs"]),
            })
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None and (
            parent["pid"] != s["pid"] or parent["tid"] != s["tid"]
        ):
            flow_id = int(s["span_id"][:8], 16)
            evs.append({
                "name": "link", "cat": "kbt.flow", "ph": "s", "id": flow_id,
                "ts": parent["start_us"], "pid": parent["pid"],
                "tid": parent["tid"],
            })
            evs.append({
                "name": "link", "cat": "kbt.flow", "ph": "f", "bp": "e",
                "id": flow_id, "ts": s["start_us"], "pid": s["pid"],
                "tid": s["tid"],
            })
    return evs


def export_chrome(spans: list[dict], path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": chrome_events(spans)}, f, default=str)
    return path


# -- SLO accountant ----------------------------------------------------------


_QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))

# Values at or below this collapse into the sketch's zero bucket (a
# latency of < 1 ns is measurement noise, not signal).
_SKETCH_MIN = 1e-9


class QuantileSketch:
    """DDSketch-style relative-error quantile sketch over a sliding
    time window, built to merge: two shards' sketches combined with
    :meth:`merge` are cell for cell one sketch fed the pooled samples
    (cell assignment is a pure function of the observation's wall-clock
    time and value, given equal ``alpha`` and ``slice_s``, which
    :meth:`merge` asserts). ``to_wire``/``from_wire`` are the JSON form
    ``/debug/slo?raw=1`` serves and obs/fleet.py merges.

    Geometry: bucket ``i = ceil(ln(v) / ln(gamma))`` with
    ``gamma = (1 + alpha) / (1 - alpha)``; the bucket midpoint
    ``2 * gamma^i / (gamma + 1)`` reconstructs any member value within
    relative error ``alpha``. The window is a ring of ``slices`` time
    buckets keyed by absolute wall-clock epoch (``int(t // slice_s)``)
    so expiry drops whole slices and epochs line up across processes.
    Not thread-safe; callers (SLOAccountant) hold their own lock."""

    DEFAULT_ALPHA = 0.01
    DEFAULT_SLICES = 12

    __slots__ = ("alpha", "window_s", "slice_s", "_gamma", "_log_gamma", "_slices")

    def __init__(
        self,
        alpha: float = DEFAULT_ALPHA,
        window_s: float = 300.0,
        slices: int = DEFAULT_SLICES,
    ) -> None:
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self.window_s = float(window_s)
        self.slice_s = self.window_s / max(1, int(slices))
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self._gamma)
        # epoch -> [bucket -> count, zero_count, n, sum]
        self._slices: dict[int, list] = {}

    def bucket_of(self, v: float) -> int:
        return math.ceil(math.log(v) / self._log_gamma)

    def value_of(self, bucket: int) -> float:
        return 2.0 * self._gamma ** bucket / (self._gamma + 1.0)

    def add(self, v: float, t: float | None = None) -> None:
        t = time.time() if t is None else t
        epoch = int(t // self.slice_s)
        sl = self._slices.get(epoch)
        if sl is None:
            sl = self._slices[epoch] = [{}, 0, 0, 0.0]
        if v <= _SKETCH_MIN:
            sl[1] += 1
        else:
            b = self.bucket_of(v)
            sl[0][b] = sl[0].get(b, 0) + 1
        sl[2] += 1
        sl[3] += v

    def trim(self, now: float | None = None) -> None:
        """Drop slices whose entire span precedes the window horizon
        (expiry slack: at most one slice length)."""
        now = time.time() if now is None else now
        horizon = now - self.window_s
        for epoch in [
            e for e in self._slices if (e + 1) * self.slice_s <= horizon
        ]:
            del self._slices[epoch]

    def count(self) -> int:
        return sum(sl[2] for sl in self._slices.values())

    def total(self) -> float:
        return sum(sl[3] for sl in self._slices.values())

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (target rank ``ceil(q*n)``) within
        relative error ``alpha``; 0.0 for an empty sketch."""
        n = self.count()
        if n == 0:
            return 0.0
        target = min(n, max(1, math.ceil(q * n)))
        zeros = sum(sl[1] for sl in self._slices.values())
        if target <= zeros:
            return 0.0
        seen = zeros
        merged: dict[int, int] = {}
        for sl in self._slices.values():
            for b, c in sl[0].items():
                merged[b] = merged.get(b, 0) + c
        for b in sorted(merged):
            seen += merged[b]
            if seen >= target:
                return self.value_of(b)
        return self.value_of(max(merged)) if merged else 0.0

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (cell-wise count sums). Requires the
        same geometry: sketches of different ``alpha`` or ``slice_s`` mean
        different buckets."""
        if not math.isclose(other.alpha, self.alpha, rel_tol=1e-9):
            raise ValueError(f"cannot merge sketches with alpha {other.alpha} into {self.alpha}")
        if not math.isclose(other.slice_s, self.slice_s, rel_tol=1e-9):
            raise ValueError(f"cannot merge sketches with slice_s {other.slice_s} into {self.slice_s}")
        for epoch, osl in other._slices.items():
            sl = self._slices.get(epoch)
            if sl is None:
                sl = self._slices[epoch] = [{}, 0, 0, 0.0]
            for b, c in osl[0].items():
                sl[0][b] = sl[0].get(b, 0) + c
            sl[1] += osl[1]
            sl[2] += osl[2]
            sl[3] += osl[3]
        return self

    def to_wire(self) -> dict:
        """JSON-safe wire form (the /debug/slo?raw=1 payload unit)."""
        return {
            "alpha": self.alpha,
            "window_s": self.window_s,
            "slice_s": self.slice_s,
            "slices": {
                str(epoch): {
                    "b": {str(b): c for b, c in sl[0].items()},
                    "z": sl[1],
                    "n": sl[2],
                    "s": sl[3],
                }
                for epoch, sl in self._slices.items()
            },
        }

    @classmethod
    def from_wire(cls, data: dict) -> "QuantileSketch":
        window_s = float(data["window_s"])
        slice_s = float(data.get("slice_s") or window_s / cls.DEFAULT_SLICES)
        sk = cls(
            alpha=float(data["alpha"]),
            window_s=window_s,
            slices=max(1, round(window_s / slice_s)),
        )
        for epoch, sl in (data.get("slices") or {}).items():
            sk._slices[int(epoch)] = [
                {int(b): int(c) for b, c in (sl.get("b") or {}).items()},
                int(sl.get("z", 0)),
                int(sl.get("n", 0)),
                float(sl.get("s", 0.0)),
            ]
        return sk


class SLOAccountant:
    """Per-queue sliding-window latency percentiles. Two kinds:
    ``time_to_bind`` (arrival -> bind echo; fed by the streaming
    trigger) and ``queue_wait`` (pod creation ->
    dispatch). Unlike the cumulative histograms in metrics/, these windows
    answer "is queue Q meeting its SLO right now".

    Backed by :class:`QuantileSketch` rings (one per kind and queue)
    rather than raw sample windows; quantiles carry the sketch's declared
    relative error ``alpha`` (default 1%). Queue cardinality is LRU-bounded at
    ``max_queues`` (default 256): a tenant-name churn storm evicts the
    coldest queue, metered on ``slo_evicted_queues_total``, and drops
    its label sets from the slo gauges.

    Always on (a sketch increment is cheap and the SLO surface must
    not go dark when tracing is off); the window length comes from
    ``KBT_SLO_WINDOW_S`` (seconds, default 300)."""

    KINDS = ("time_to_bind", "queue_wait")
    MAX_QUEUES = 256

    def __init__(
        self,
        window_s: float | None = None,
        max_queues: int | None = None,
        alpha: float = QuantileSketch.DEFAULT_ALPHA,
    ) -> None:
        if window_s is None:
            try:
                window_s = float(os.environ.get(SLO_WINDOW_ENV, "") or 300.0)
            except ValueError:
                window_s = 300.0
        self.window_s = window_s
        self.alpha = float(alpha)
        self.max_queues = int(
            max_queues if max_queues is not None else self.MAX_QUEUES
        )
        self._lock = threading.Lock()
        # kind -> queue -> sketch, LRU-ordered (oldest-touched first)
        self._sketches: dict[str, "collections.OrderedDict[str, QuantileSketch]"] = {
            k: collections.OrderedDict() for k in self.KINDS
        }

    def observe(self, kind: str, queue: str, seconds: float) -> None:
        if kind not in self._sketches:
            return
        queue = queue or "default"
        with self._lock:
            per_queue = self._sketches[kind]
            sk = per_queue.get(queue)
            if sk is None:
                sk = per_queue[queue] = QuantileSketch(
                    alpha=self.alpha, window_s=self.window_s
                )
                while len(per_queue) > self.max_queues:
                    evicted, _ = per_queue.popitem(last=False)
                    metrics.register_slo_evicted_queue()
                    metrics.drop_slo_queue(evicted)
            else:
                per_queue.move_to_end(queue)
            sk.add(seconds)

    def reset(self) -> None:
        with self._lock:
            for per_queue in self._sketches.values():
                per_queue.clear()

    def snapshot(self) -> dict:
        """``{kind: {queue: {p50, p90, p99, n, window_s}}}`` over the
        currently in-window observations (n is exact; quantiles within
        relative error ``alpha``)."""
        now = time.time()
        out: dict[str, dict] = {}
        with self._lock:
            for kind, per_queue in self._sketches.items():
                out[kind] = {}
                for queue, sk in per_queue.items():
                    sk.trim(now)
                    n = sk.count()
                    if n == 0:
                        continue
                    stats = {"n": n, "window_s": self.window_s}
                    for label, q in _QUANTILES:
                        stats[label] = sk.quantile(q)
                    out[kind][queue] = stats
        return out

    def raw(self) -> dict:
        """The mergeable wire form (``/debug/slo?raw=1``): per kind and
        queue, the serialized sketches a fleet aggregator deserializes
        with :meth:`QuantileSketch.from_wire` and merges."""
        now = time.time()
        out: dict = {"alpha": self.alpha, "window_s": self.window_s, "kinds": {}}
        with self._lock:
            for kind, per_queue in self._sketches.items():
                out["kinds"][kind] = {}
                for queue, sk in per_queue.items():
                    sk.trim(now)
                    if sk.count() == 0:
                        continue
                    out["kinds"][kind][queue] = sk.to_wire()
        return out

    def publish(self) -> dict:
        """Push the current window percentiles into the exposition's
        ``slo_*`` gauges and return the snapshot."""
        snap = self.snapshot()
        for kind, per_queue in snap.items():
            for queue, stats in per_queue.items():
                for label, _ in _QUANTILES:
                    metrics.set_slo_quantile(kind, queue, label, stats[label])
        return snap


slo = SLOAccountant()


# -- configuration -----------------------------------------------------------

_OFF_WORDS = ("", "0", "false", "off", "no")


def configure(spec=None) -> bool:
    """(Re)resolve the tracing switch. ``spec`` is the conf ``trace:``
    value — empty/None defers to ``KBT_TRACE``. Hot-reloadable: the
    scheduler calls this from its conf-reload path every cycle. Also
    re-reads the flight-recorder ring size so a conf push can deepen
    the ring on a live process."""
    global _enabled
    if spec is None or str(spec).strip() == "":
        on = os.environ.get(ENV, "").strip().lower() not in _OFF_WORDS
    else:
        on = str(spec).strip().lower() not in _OFF_WORDS
    try:
        cycles = int(os.environ.get(RECORDER_CYCLES_ENV, "") or recorder.max_traces)
    except ValueError:
        cycles = recorder.max_traces
    if cycles != recorder.max_traces:
        recorder.resize(cycles)
    if on != _enabled:
        log.info("tracing %s", "enabled" if on else "disabled")
    _enabled = on
    return on


def install_signal_dump() -> bool:
    """Chain a SIGTERM handler that dumps the flight recorder before
    the previous disposition runs. Main-thread only (signal module
    restriction); returns False where it cannot install."""
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _dump_then_chain(signum, frame):
            try:
                recorder.dump(reason="sigterm")
            except Exception:  # noqa: BLE001 - dying anyway; don't mask SIGTERM
                pass
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _dump_then_chain)
        return True
    except (ValueError, OSError, RuntimeError):
        return False


def check_tree(spans: list[dict]) -> list[str]:
    """Structural violations of a span set (empty = complete tree):
    every span name is declared, and every non-root parent id resolves
    inside the same trace."""
    out: list[str] = []
    by_trace: dict[str, dict[str, dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], {})[s["span_id"]] = s
        if s["name"] not in SPAN_NAMES:
            out.append(f"undeclared span name {s['name']!r}")
    for trace_id, members in by_trace.items():
        for s in members.values():
            if s["parent_id"] and s["parent_id"] not in members:
                out.append(
                    f"span {s['name']} ({s['span_id']}) in trace {trace_id} "
                    f"has dangling parent {s['parent_id']}"
                )
    return out


# -- smoke -------------------------------------------------------------------

# The device pipeline, so the smoke exercises the full span tree: encode,
# solve and gang.assign come from torch_allocate, and the dispatch goes
# through bind_many to the conditional per-gang transaction whose conflict
# retries the smoke asserts on. No ``trace:`` key on purpose: every
# scheduler (the shards and the arbiter's idle loop) defers to the
# KBT_TRACE the smoke arms, so their conf reloads cannot fight over the
# module-wide switch. ``{device}`` is where torch_allocate solves.
SMOKE_CONF = """
actions: "enqueue, torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
actionArguments:
  torch_allocate:
    device: {device}
    min_device_pairs: 0
"""


def smoke(
    shards: int = 2,
    gangs: int = 4,
    members: int = 3,
    nodes: int = 6,
    out_dir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Tracing end to end (``python -m kube_batch_tpu_torch.obs``), with
    ``torch_allocate`` solving on ``device``:

    1. arm tracing, explain, and a one-shot ``federation.stale_assign``
       fault (the dispatched gang carries snapshot version 0, so a 409
       conflict and a winning retry are certain);
    2. run a seeded two-shard federated run over live LoopbackBackends
       against a real SchedulerServer store arbiter, headers and all;
    3. check the collected spans form a complete parent-child tree, that a
       ``gang.bind`` span carries a conflict event, and that a
       ``store.bind`` span recorded on the arbiter side joined a
       scheduler's trace;
    4. seed one unfittable gang and check its explain record
       (obs/explain) lands in the registry, rides an ``explain`` span, and
       that dispatched gangs' journal intents carry ``explain`` payloads;
    5. export the Chrome trace-event file and JSONL and return the paths.
    """
    import json as _json
    import threading as _threading

    from kube_batch_tpu_torch import faults
    from kube_batch_tpu_torch.cache import LoopbackBackend
    from kube_batch_tpu_torch.cache.store import PODS as _PODS
    from kube_batch_tpu_torch.federation import FederatedCache, _seed_world, fsck
    from kube_batch_tpu_torch.obs import explain as _explain
    from kube_batch_tpu_torch.recovery.journal import WriteIntentJournal
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.server import SchedulerServer
    from kube_batch_tpu_torch.streaming import _check_device
    from kube_batch_tpu_torch.testing import build_pod, build_pod_group, build_resource_list

    _check_device(device)
    # Arm through the environment, not configure() directly: every
    # scheduler cycle re-resolves the switches from conf and environment.
    prev_env = os.environ.get(ENV)
    os.environ[ENV] = "1"
    prev_explain = os.environ.get(_explain.ENV)
    os.environ[_explain.ENV] = "1"
    configure()
    _explain.configure()
    recorder.clear()
    slo.reset()
    _explain.records.clear()
    faults.registry.configure("federation.stale_assign:1:1")

    total = gangs * members
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "kbt-obs-smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as fh:
        fh.write(SMOKE_CONF.format(device=device))
        conf_path = fh.name
    server = SchedulerServer(
        scheduler_name="obs-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=conf_path, schedule_period=60.0,
    )
    server.start()
    backends: list = []
    scheds: list = []
    journal_paths: list[str] = []
    stop = _threading.Event()
    all_bound = False
    try:
        _seed_world(server.store, gangs, members, nodes)
        # One unfittable gang (cpu far beyond any node): the run leaves it
        # pending with an explain record whose reason is resources.
        server.store.create_pod_group(build_pod_group("fg-stuck", min_member=1))
        server.store.create_pod(
            build_pod(
                name="fg-stuck-p0",
                group_name="fg-stuck",
                req=build_resource_list(cpu=999, memory="512Mi"),
            )
        )
        base = f"http://127.0.0.1:{server.listen_port}"
        for i in range(shards):
            backend = LoopbackBackend(base)
            jpath = os.path.join(out_dir, f"smoke-journal-{i}.jsonl")
            if os.path.exists(jpath):
                os.unlink(jpath)
            journal_paths.append(jpath)
            cache = FederatedCache(
                backend, shard=i, shards=shards, shard_key="gang",
                staleness_fn=backend.snapshot_age,
                journal=WriteIntentJournal(jpath),
            )
            cache.run()
            backend.start(period=0.02)
            backends.append(backend)
            sched = Scheduler(cache, scheduler_conf=conf_path, schedule_period=0.05)
            t = _threading.Thread(target=sched.run, args=(stop,), name=f"kb-obs-{i}", daemon=True)
            t.start()
            scheds.append((sched, t))
        # the stuck pod never binds: wait on the bound count
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            pods = server.store.list(_PODS)
            if sum(1 for p in pods if p.node_name) >= total:
                all_bound = True
                break
            time.sleep(0.005)
    finally:
        stop.set()
        for _, t in scheds:
            t.join(timeout=10.0)
        for backend in backends:
            backend.stop()
        for sched, _ in scheds:
            sched.cache.stop()
        server.stop()
        faults.registry.disarm("federation.stale_assign")
        os.unlink(conf_path)

    spans = recorder.spans()
    violations = check_tree(spans)
    names = collections.Counter(s["name"] for s in spans)
    conflict_binds = [
        s for s in spans
        if s["name"] == "gang.bind" and any(ev["name"] == "conflict" for ev in s["events"])
    ]
    scheduler_traces = {s["trace_id"] for s in spans if s["name"] == "cycle"}
    joined_remote = [
        s for s in spans if s["name"] == "store.bind" and s["trace_id"] in scheduler_traces
    ]
    stuck_rec = _explain.records.get("default/fg-stuck")
    explain_spans = [
        s for s in spans if s["name"] == "explain" and s["attrs"].get("unschedulable", 0) > 0
    ]
    journaled_explains = 0
    for jpath in journal_paths:
        try:
            with open(jpath, encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = _json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("rec") == "intent" and "explain" in rec:
                        journaled_explains += 1
        except OSError:
            pass

    jsonl_path = export_jsonl(spans, os.path.join(out_dir, "smoke.jsonl"))
    chrome_path = export_chrome(spans, os.path.join(out_dir, "smoke.trace.json"))

    for env, prev in ((ENV, prev_env), (_explain.ENV, prev_explain)):
        if prev is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = prev
    configure()
    _explain.configure()
    result = {
        "shards": shards,
        "pods": total,
        "all_bound": all_bound,
        "spans": len(spans),
        "span_names": dict(sorted(names.items())),
        "tree_violations": violations,
        "conflicted_gang_binds": len(conflict_binds),
        "remote_spans_joined": len(joined_remote),
        "fsck_violations": fsck(server.store),
        "slo": slo.snapshot(),
        "jsonl": jsonl_path,
        "chrome_trace": chrome_path,
        "stuck_gang_reason": stuck_rec["reason"] if stuck_rec else None,
        "explain_spans": len(explain_spans),
        "journaled_explains": journaled_explains,
    }
    result["ok"] = bool(
        all_bound
        and not violations
        and not result["fsck_violations"]
        and names.get("cycle", 0) > 0
        and names.get("solve", 0) > 0
        and names.get("gang.bind", 0) > 0
        and conflict_binds
        and joined_remote
        and stuck_rec is not None
        and stuck_rec["verdict"] == "unschedulable"
        and explain_spans
        and journaled_explains > 0
    )
    return result


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="tracing smoke: seeded two-shard federated run, span "
        "tree checked, Chrome trace exported"
    )
    parser.add_argument("--shards", type=int, default=2)
    parser.add_argument("--gangs", type=int, default=4)
    parser.add_argument("--members", type=int, default=3)
    parser.add_argument("--out", default=None, help="export directory")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where torch_allocate solves (default: the card)",
    )
    parser.add_argument("--json", action="store_true", help="print the result dict as JSON")
    args = parser.parse_args(argv)
    result = smoke(
        shards=args.shards, gangs=args.gangs, members=args.members,
        out_dir=args.out, device=args.device,
    )
    if args.json:
        print(json.dumps(result, sort_keys=True, default=str))
    else:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"obs smoke: {status} ({result['spans']} spans, "
            f"{result['conflicted_gang_binds']} conflicted binds, "
            f"{result['remote_spans_joined']} remote spans joined, "
            f"tree={'complete' if not result['tree_violations'] else result['tree_violations']}, "
            f"chrome={result['chrome_trace']})"
        )
    return 0 if result["ok"] else 1


configure()
