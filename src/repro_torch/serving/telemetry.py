"""Process-wide metrics + tracing fabric — follow one query from client to
kernel and back.

The paper's evaluation is latency *attribution*: where does rerank time go
— the engine, the RPC hop, or feedforward evaluation? This module is the
measurement substrate that answers it for our stack:

``MetricsRegistry``
    Thread-safe counters / gauges / histograms with label support. One
    process-wide default registry (``get_registry()``) absorbs the signal
    that used to live in scattered per-component ``stats()`` dicts: the
    MicroBatcher's queue-wait vs compute split, admission accept/shed
    decisions, scorer batches per bucket, client reconnects/shed-retries,
    hedge attempts. ``snapshot()`` flattens everything to a ``str -> float``
    dict (histograms expand to ``_bucket{le=..}`` / ``_count`` / ``_sum``
    keys), which is exactly what wire v5's ``MSG_STATS`` ships — so a
    ``serving.fabric.Fabric`` supervisor can aggregate the registries of
    every worker *process*, not just health probes
    (``merge_snapshots`` sums them).

``Tracer``
    Per-request span trees: every span carries ``(trace_id, span_id,
    parent_id)`` plus a wall-clock interval, and the context propagates

      * down the call stack (thread-local current-span stack),
      * across threads (capture ``current_context()``, replay it with
        ``activate()`` — the hedge/batcher worker-thread pattern),
      * across the WIRE: wire v5 request frames carry an optional 16-byte
        trace context (``FLAG_TRACE``), so a server-side span parents into
        the caller's tree even across a process boundary.

    Finished spans land in a bounded ring; ``export_chrome_trace`` writes
    them as Chrome trace-event JSON (load in Perfetto / chrome://tracing),
    ``span_tree``/``format_span_tree`` render the per-request breakdown the
    paper's Tables 1-2 tabulate.

Overhead: a span is two ``perf_counter`` calls and one locked deque append;
a metric a locked dict update. Enabled telemetry costs <5% on the
jit-batched pipeline row (``benchmarks.run --table trace`` measures it).
``set_enabled(False)`` turns ``span()`` into a shared no-op for zero-cost
opt-out.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "Tracer", "SpanRecord", "SpanContext",
    "get_registry", "get_tracer", "reset_all",
    "merge_snapshots", "split_by_label", "export_chrome_trace",
    "chrome_trace_events", "span_tree", "format_span_tree",
    "stage_breakdown",
]

#: Default histogram bucket upper bounds, in milliseconds (latency-shaped).
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)

#: perf_counter -> unix epoch anchor, taken once at import so every span in
#: this process shares one consistent wall clock (cross-process span trees
#: align to within clock skew, which localhost fabrics don't have).
_EPOCH_ANCHOR = time.time() - time.perf_counter()


def perf_to_epoch_us(t_perf: float) -> float:
    """Map a ``time.perf_counter`` timestamp to epoch microseconds."""
    return (_EPOCH_ANCHOR + t_perf) * 1e6


# =========================================================== metrics =====


def _metric_key(name: str, labels: Dict[str, Any]) -> str:
    """Flattened metric key: ``name{a=1,b=x}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 = +inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.buckets):
            if value <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.total += value
        self.count += 1


class MetricsRegistry:
    """Thread-safe counters, gauges and histograms with label support.

    All three families share one flat ``snapshot()`` namespace so the whole
    registry crosses the wire as a ``str -> float`` dict (MSG_STATS):

      counter    ``name{labels}``                      monotonic total
      gauge      ``name{labels}``                      last set value
      histogram  ``name_bucket{le=B,labels}``          cumulative counts,
                 ``name_count{labels}`` / ``name_sum{labels}``

    Histogram bucket counts are cumulative (Prometheus-style): the value at
    ``le=B`` counts every observation ``<= B``, so merged snapshots from N
    worker processes stay valid histograms under plain summation
    (``merge_snapshots``).
    """

    def __init__(self):
        self._lock = Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}

    # ------------------------------------------------------- families --

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = _metric_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = _metric_key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None, **labels) -> None:
        """Record one histogram observation (default bucket ladder is
        latency-in-ms shaped; pass ``buckets`` on first observe to
        override)."""
        key = _metric_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = _Histogram(buckets or DEFAULT_BUCKETS_MS)
                self._hists[key] = h
            h.observe(value)

    # ------------------------------------------------------- snapshot --

    def snapshot(self) -> Dict[str, float]:
        """Flatten the whole registry to ``str -> float`` (wire-shippable)."""
        out: Dict[str, float] = {}
        with self._lock:
            out.update(self._counters)
            out.update(self._gauges)
            for key, h in self._hists.items():
                name, labels = key, ""
                if key.endswith("}"):
                    name, _, labels = key.partition("{")
                    labels = "," + labels[:-1]
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    out[f"{name}_bucket{{le={b:g}{labels}}}"] = float(cum)
                out[f"{name}_bucket{{le=+inf{labels}}}"] = float(h.count)
                out[f"{name}_count{labels and '{' + labels[1:] + '}'}"] = (
                    float(h.count))
                out[f"{name}_sum{labels and '{' + labels[1:] + '}'}"] = (
                    float(h.total))
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def merge_snapshots(snaps: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Sum N registry snapshots key-wise — the fabric supervisor's
    aggregation over worker processes. Valid for counters and histogram
    keys (cumulative buckets sum to a cumulative histogram); gauges become
    fleet totals (document per use)."""
    out: Dict[str, float] = {}
    for snap in snaps:
        for k, v in snap.items():
            out[k] = out.get(k, 0.0) + v
    return out


def _key_label(key: str, label: str) -> Optional[str]:
    """Value of ``label`` in a flattened metric key, or None. Label values
    never contain ``,``/``}`` (they come from ``_metric_key``), so plain
    splitting is exact."""
    if not key.endswith("}"):
        return None
    _, _, inner = key.partition("{")
    for part in inner[:-1].split(","):
        k, _, v = part.partition("=")
        if k == label:
            return v
    return None


def split_by_label(snapshot: Dict[str, float], label: str
                   ) -> Dict[str, Dict[str, float]]:
    """Group a flat snapshot's keys by one label's value — e.g.
    ``split_by_label(fabric.aggregate_metrics(), "model_version")`` returns
    per-version metric dicts, which is how A/B arms separate after
    cross-worker aggregation (see serving.rollout). Keys that do not carry
    the label land under ``""``; full keys are preserved in each group."""
    out: Dict[str, Dict[str, float]] = {}
    for key, value in snapshot.items():
        group = _key_label(key, label) or ""
        out.setdefault(group, {})[key] = value
    return out


# ============================================================ tracing ====


class SpanContext(Tuple[int, int]):
    """(trace_id, span_id) — the 16 bytes that cross the wire."""
    __slots__ = ()

    def __new__(cls, trace_id: int, span_id: int):
        return tuple.__new__(cls, (int(trace_id), int(span_id)))

    @property
    def trace_id(self) -> int:
        return self[0]

    @property
    def span_id(self) -> int:
        return self[1]


class SpanRecord:
    """One finished span: identity, interval, process/thread, attributes."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "ts_us",
                 "dur_us", "pid", "tid", "attrs")

    def __init__(self, trace_id: int, span_id: int, parent_id: int,
                 name: str, ts_us: float, dur_us: float,
                 pid: int, tid: int, attrs: Dict[str, Any]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.pid = pid
        self.tid = tid
        self.attrs = attrs

    def __repr__(self) -> str:
        return (f"<span {self.name} {self.dur_us / 1e3:.3f}ms "
                f"trace={self.trace_id:x} id={self.span_id:x} "
                f"parent={self.parent_id:x} pid={self.pid}>")

    # ----------------------------------------------------------- wire --

    _WIRE_FMT = "<QQQddQ"
    WIRE_FIXED = struct.calcsize(_WIRE_FMT)  # + 2 length-prefixed strings

    def to_wire(self) -> Tuple[int, int, int, float, float, int, str, str]:
        attrs = ";".join(f"{k}={v}" for k, v in self.attrs.items())
        return (self.trace_id, self.span_id, self.parent_id, self.ts_us,
                self.dur_us, self.pid, self.name, attrs)

    @classmethod
    def from_wire(cls, t: Sequence) -> "SpanRecord":
        trace_id, span_id, parent_id, ts_us, dur_us, pid, name, attrs = t
        parsed: Dict[str, Any] = {}
        if attrs:
            for part in attrs.split(";"):
                k, _, v = part.partition("=")
                parsed[k] = v
        return cls(trace_id, span_id, parent_id, name, ts_us, dur_us,
                   int(pid), 0, parsed)


class _Ids:
    """Cheap unique 64-bit ids: random per-process base + atomic counter
    (no per-span urandom syscall)."""

    def __init__(self):
        self._base = int.from_bytes(os.urandom(8), "little") | 1
        self._lock = Lock()
        self._n = 0

    def next(self) -> int:
        with self._lock:
            self._n += 1
            n = self._n
        return ((self._base + n * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)) or 1


class _NoopSpan:
    """Shared do-nothing span when tracing is disabled."""

    __slots__ = ()
    context: Optional[SpanContext] = None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """A live span; use as a context manager (``tracer.span(...)``)."""

    __slots__ = ("_tracer", "name", "context", "parent_id", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, context: SpanContext,
                 parent_id: int, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attrs = attrs

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        self._tracer._push(self.context)
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._tracer._pop()
        self._tracer._record_finished(
            self.context.trace_id, self.context.span_id, self.parent_id,
            self.name, self._t0, t1, self.attrs)


class Tracer:
    """Produce per-request span trees with cross-thread / cross-process
    context propagation; finished spans collect in a bounded ring."""

    def __init__(self, max_spans: int = 8192, enabled: bool = True):
        self._ids = _Ids()
        self._tls = threading.local()
        self._lock = Lock()
        self._ring: "deque[SpanRecord]" = deque(maxlen=max_spans)
        self._enabled = enabled

    # ------------------------------------------------------- lifecycle --

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # --------------------------------------------------------- context --

    def _stack(self) -> List[SpanContext]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, ctx: SpanContext) -> None:
        self._stack().append(ctx)

    def _pop(self) -> None:
        stack = self._stack()
        if stack:
            stack.pop()

    def current_context(self) -> Optional[SpanContext]:
        """The active span's (trace_id, span_id) in THIS thread, or None.
        This is what a client stamps on an outgoing wire frame."""
        if not self._enabled:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    def activate(self, ctx: Optional[SpanContext]):
        """Adopt a foreign context (captured in another thread, or decoded
        off the wire) as this thread's current parent — without opening a
        span. Usage: ``with tracer.activate(ctx): ...``."""
        return _Activation(self, ctx)

    # ----------------------------------------------------------- spans --

    def span(self, name: str, parent: Optional[SpanContext] = None,
             **attrs):
        """Open a child span of ``parent`` (default: the thread's current
        span; a fresh trace root when there is none)."""
        if not self._enabled:
            return NOOP_SPAN
        if parent is None:
            parent = self.current_context()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = self._ids.next(), 0
        ctx = SpanContext(trace_id, self._ids.next())
        return Span(self, name, ctx, parent_id, attrs)

    def record(self, name: str, t0_perf: float, t1_perf: float,
               parent: Optional[SpanContext] = None, **attrs
               ) -> Optional[SpanContext]:
        """Record an already-measured interval as a finished span with an
        explicit parent — the worker-thread pattern (a MicroBatcher item's
        queue wait / compute split is timed by the batch loop, not by a
        ``with`` block in the submitting thread). Returns the new span's
        context (None when disabled)."""
        if not self._enabled:
            return None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = self._ids.next(), 0
        span_id = self._ids.next()
        self._record_finished(trace_id, span_id, parent_id, name,
                              t0_perf, t1_perf, attrs)
        return SpanContext(trace_id, span_id)

    def _record_finished(self, trace_id: int, span_id: int, parent_id: int,
                         name: str, t0: float, t1: float,
                         attrs: Dict[str, Any]) -> None:
        rec = SpanRecord(trace_id, span_id, parent_id, name,
                         perf_to_epoch_us(t0), (t1 - t0) * 1e6,
                         os.getpid(), threading.get_ident(), attrs)
        with self._lock:
            self._ring.append(rec)

    # -------------------------------------------------------- finished --

    def finished(self, trace_id: Optional[int] = None,
                 limit: Optional[int] = None) -> List[SpanRecord]:
        """Finished spans (oldest first), optionally filtered to one trace
        and/or capped to the most recent ``limit``. Non-destructive."""
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return spans

    def wire_spans(self, limit: int = 512) -> List[Tuple]:
        """The most recent finished spans in wire-tuple form (what a
        MSG_STATS reply carries)."""
        return [s.to_wire() for s in self.finished(limit=limit)]


class _Activation:
    __slots__ = ("_tracer", "_ctx", "_pushed")

    def __init__(self, tracer: Tracer, ctx: Optional[SpanContext]):
        self._tracer = tracer
        self._ctx = ctx
        self._pushed = False

    def __enter__(self):
        if self._ctx is not None and self._tracer.enabled:
            self._tracer._push(self._ctx)
            self._pushed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._pushed:
            self._tracer._pop()


# ===================================================== trace rendering ===


def chrome_trace_events(spans: Sequence[SpanRecord]) -> List[Dict]:
    """Spans as Chrome trace-event objects (phase "X" = complete events).
    Thread idents are remapped to small ints per pid so the viewer's lane
    labels stay readable."""
    tids: Dict[Tuple[int, int], int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault((s.pid, s.tid), len(tids) + 1)
        args: Dict[str, Any] = {
            "trace_id": f"{s.trace_id:016x}",
            "span_id": f"{s.span_id:016x}",
            "parent_id": f"{s.parent_id:016x}",
        }
        args.update({k: str(v) for k, v in s.attrs.items()})
        events.append({
            "name": s.name, "ph": "X", "cat": "repro",
            "ts": s.ts_us, "dur": max(s.dur_us, 0.0),
            "pid": s.pid, "tid": tid, "args": args,
        })
    return events


def export_chrome_trace(path: str, spans: Sequence[SpanRecord]) -> int:
    """Write spans as Chrome trace-event JSON (open in Perfetto or
    chrome://tracing). Returns the number of events written."""
    events = chrome_trace_events(spans)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def span_tree(spans: Sequence[SpanRecord], trace_id: Optional[int] = None
              ) -> Tuple[List[SpanRecord], Dict[int, List[SpanRecord]]]:
    """Assemble (roots, children-by-parent-span-id) for one trace. A span
    whose parent is not in the set is a root too (e.g. worker-side spans
    fetched without the client half)."""
    if trace_id is not None:
        spans = [s for s in spans if s.trace_id == trace_id]
    by_id = {s.span_id: s for s in spans}
    children: Dict[int, List[SpanRecord]] = {}
    roots: List[SpanRecord] = []
    for s in spans:
        if s.parent_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.ts_us)
    roots.sort(key=lambda s: s.ts_us)
    return roots, children


def format_span_tree(spans: Sequence[SpanRecord],
                     trace_id: Optional[int] = None) -> str:
    """Render one trace as an indented tree with per-span latency — the
    human-readable answer to "where did this query's time go"."""
    roots, children = span_tree(spans, trace_id)
    lines: List[str] = []

    def walk(s: SpanRecord, depth: int) -> None:
        attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
        lines.append(f"{'  ' * depth}{s.name}  {s.dur_us / 1e3:.3f}ms"
                     f"  [pid {s.pid}]" + (f"  {attrs}" if attrs else ""))
        for kid in children.get(s.span_id, []):
            walk(kid, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)


def stage_breakdown(spans: Sequence[SpanRecord]) -> Dict[str, Dict[str, float]]:
    """Aggregate spans by name: count, total/mean ms — the per-stage
    latency table behind ``benchmarks.run --table trace``."""
    agg: Dict[str, Dict[str, float]] = {}
    for s in spans:
        row = agg.setdefault(s.name, {"count": 0.0, "total_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += s.dur_us / 1e3
    for row in agg.values():
        row["mean_ms"] = row["total_ms"] / max(row["count"], 1.0)
    return agg


# ================================================= process-wide default ==

_REGISTRY = MetricsRegistry()
_TRACER = Tracer()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what MSG_STATS snapshots)."""
    return _REGISTRY


def get_tracer() -> Tracer:
    """The process-wide default tracer (what wire trace contexts feed)."""
    return _TRACER


def reset_all() -> None:
    """Clear the default registry and tracer ring (tests)."""
    _REGISTRY.reset()
    _TRACER.clear()
