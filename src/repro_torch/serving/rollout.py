"""Live model rollout: guardrailed hot-swap, shadow serving, A/B splits.

The registry (``core.registry``) makes a trained reranker a versioned,
content-addressed artifact; this module operates the *lifecycle* of those
versions against live serving stacks — the step the paper's export story
("extract the parameters of a trained CNN ... and import the model",
arXiv:1707.08275) needs to become a production loop:

``RolloutController``
    Drives a hot-swap on any swap-capable target (a ``PipelineEngine``, a
    ``ReplicaPool`` behind one, or a whole ``Fabric`` fleet) and *judges*
    it: canary queries measure error rate and p99 before and after, and a
    candidate that regresses past the guardrails is automatically swapped
    back — the old version keeps serving, the report says why.

``ShadowEngine``
    Mirrors a deterministic hash-sampled fraction of ranking traffic to a
    candidate engine on a bounded background thread pool. Candidate
    rankings are DISCARDED — only per-version latency and score/rank
    divergence metrics escape — so a broken candidate can't hurt a single
    live response.

``ABEngine``
    Deterministic per-query hash routing between two version-bound engines.
    The same query always lands on the same arm (stable digest, not
    Python's salted ``hash``), and each arm's ``PipelineEngine`` labels its
    request metrics with its ``model_version``, so
    ``Fabric.aggregate_metrics()`` / ``telemetry.split_by_label`` separate
    the arms after any amount of cross-process aggregation.

All three compose with the existing serving fabric rather than replacing
it: the engines are drop-in ``core.service`` handlers (``rank_batch`` +
``supports_deadline`` + ``rows_per_query``), and the controller's fleet
path reuses the v4 drain machinery (drain -> MSG_SWAP -> rejoin).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving import telemetry

#: Hash space for deterministic traffic splitting (basis points: 0.01%).
_SPLIT_BUCKETS = 10_000


def query_bucket(query: str, buckets: int = _SPLIT_BUCKETS) -> int:
    """Deterministic bucket in [0, buckets) for a query string. Uses a
    stable digest (sha1), NOT Python's per-process-salted ``hash`` — the
    same query must land in the same bucket in every process of a fleet."""
    digest = hashlib.sha1(query.encode("utf-8", "replace")).digest()
    return int.from_bytes(digest[:8], "little") % buckets


def sample_query(query: str, fraction: float) -> bool:
    """Deterministically true for ~``fraction`` of distinct queries."""
    return query_bucket(query) < fraction * _SPLIT_BUCKETS


def _p99_ms(latencies_ms: Sequence[float]) -> float:
    if not latencies_ms:
        return 0.0
    ordered = sorted(latencies_ms)
    return ordered[min(int(0.99 * len(ordered)), len(ordered) - 1)]


class RolloutError(RuntimeError):
    """A rollout operation could not run (not: a guardrail rollback —
    rollbacks are a *successful* controller outcome, reported, not raised)."""


@dataclasses.dataclass
class CanaryReport:
    """One canary pass: per-query errors + latency over the canary set."""

    queries: int = 0
    errors: int = 0
    p99_ms: float = 0.0

    @property
    def error_rate(self) -> float:
        return self.errors / self.queries if self.queries else 0.0


@dataclasses.dataclass
class SwapReport:
    """Outcome of one guardrailed hot-swap."""

    target_version: str
    previous_version: str
    active_version: str
    swapped: bool
    rolled_back: bool = False
    reason: str = ""
    baseline: Optional[CanaryReport] = None
    candidate: Optional[CanaryReport] = None
    swap_ms: float = 0.0


class RolloutController:
    """Guardrailed rollout over any swap-capable ranking target.

    ``target`` needs ``swap_version(version) -> version_id``,
    ``model_version``, and ``rank_batch(queries)`` (the canary probe) —
    which is exactly a ``PipelineEngine`` (including one fronting a
    ``ReplicaPool``). Guardrails:

      * error rate: canary queries that raise, or return any non-finite
        score, count as errors; candidate error rate above
        ``max_error_rate`` (default: ZERO tolerance) rolls back.
      * latency: candidate canary p99 above ``baseline_p99 *
        p99_multiplier`` — and above ``min_p99_floor_ms``, so micro-second
        baselines don't flap on scheduler noise — rolls back.

    A rollback swaps back to the previous version and reports
    ``rolled_back=True``; the controller never leaves the target on a
    version whose canaries failed.
    """

    def __init__(self, target, canary_queries: Sequence[str],
                 max_error_rate: float = 0.0, p99_multiplier: float = 4.0,
                 min_p99_floor_ms: float = 25.0, canary_passes: int = 2):
        if not canary_queries:
            raise RolloutError("RolloutController needs canary queries — "
                               "an unjudged swap is ReplicaPool/Client.swap")
        self.target = target
        self.canary_queries = list(canary_queries)
        self.max_error_rate = max_error_rate
        self.p99_multiplier = p99_multiplier
        self.min_p99_floor_ms = min_p99_floor_ms
        self.canary_passes = max(int(canary_passes), 1)

    # ------------------------------------------------------------ canary --

    def probe(self) -> CanaryReport:
        """Run the canary set, one query per request (per-query latency is
        the guardrail signal), against whatever version is live."""
        report = CanaryReport()
        latencies: List[float] = []
        for _ in range(self.canary_passes):
            for query in self.canary_queries:
                report.queries += 1
                t0 = time.perf_counter()
                try:
                    rankings = self.target.rank_batch([query])
                except Exception:  # noqa: BLE001 — canaries judge failures
                    report.errors += 1
                    continue
                latencies.append((time.perf_counter() - t0) * 1e3)
                for ranking in rankings:
                    if any(not math.isfinite(float(score))
                           for _, _, score in ranking):
                        report.errors += 1
                        break
        report.p99_ms = _p99_ms(latencies)
        return report

    def _guardrail_breach(self, baseline: CanaryReport,
                          candidate: CanaryReport) -> str:
        if candidate.error_rate > self.max_error_rate:
            return (f"error rate {candidate.error_rate:.3f} > "
                    f"{self.max_error_rate:.3f} "
                    f"({candidate.errors}/{candidate.queries} canaries)")
        p99_limit = max(baseline.p99_ms * self.p99_multiplier,
                        self.min_p99_floor_ms)
        if candidate.p99_ms > p99_limit:
            return (f"canary p99 {candidate.p99_ms:.1f}ms > limit "
                    f"{p99_limit:.1f}ms (baseline {baseline.p99_ms:.1f}ms "
                    f"x {self.p99_multiplier:g})")
        return ""

    # ---------------------------------------------------------- hot-swap --

    def hot_swap(self, version: str) -> SwapReport:
        """Swap the target to ``version``, judge it with canaries, and roll
        back automatically on a guardrail breach. Never raises for a
        misbehaving CANDIDATE (that's a reported rollback); raises only
        when the swap machinery itself is unusable (no registry bound,
        unknown version — and the old version is still serving then)."""
        previous = str(getattr(self.target, "model_version", "unversioned"))
        baseline = self.probe()
        metrics = telemetry.get_registry()
        t0 = time.perf_counter()
        active = self.target.swap_version(version)
        swap_ms = (time.perf_counter() - t0) * 1e3
        candidate = self.probe()
        breach = self._guardrail_breach(baseline, candidate)
        if breach:
            # Roll back to the exact version that passed before. The old
            # weights are content-addressed, so this cannot "roll back"
            # onto something else.
            self.target.swap_version(previous)
            metrics.inc("rollout_rollbacks")
            return SwapReport(target_version=version,
                              previous_version=previous,
                              active_version=previous, swapped=False,
                              rolled_back=True, reason=breach,
                              baseline=baseline, candidate=candidate,
                              swap_ms=swap_ms)
        metrics.inc("rollout_swaps")
        metrics.observe("rollout_swap_ms", swap_ms)
        return SwapReport(target_version=version, previous_version=previous,
                          active_version=str(active), swapped=True,
                          baseline=baseline, candidate=candidate,
                          swap_ms=swap_ms)


# ============================================================= shadow =====


class ShadowEngine:
    """Serve ``primary``; mirror a sampled fraction of queries to
    ``candidate`` and throw the candidate's rankings away.

    The mirror runs on short-lived daemon threads bounded by a semaphore
    (``max_pending``): under a traffic burst the shadow DROPS samples
    (counted in ``shadow_dropped``) instead of queueing unboundedly or
    adding a microsecond to the primary path. Divergence metrics, all
    labeled with the candidate's ``model_version``:

      shadow_queries          mirrored query count
      shadow_rank_ms          candidate latency histogram
      shadow_top1_changed     queries whose top-1 (doc, sent) differs
      shadow_score_divergence histogram of |primary - candidate| top-1
                              score deltas
      shadow_errors           candidate exceptions (never surfaced)
    """

    supports_deadline = True

    def __init__(self, primary, candidate, fraction: float = 0.1,
                 max_pending: int = 8):
        self.primary = primary
        self.candidate = candidate
        self.fraction = fraction
        self._max_pending = max_pending
        self._pending = threading.Semaphore(max_pending)

    # The service-facing handler surface delegates to the primary: the
    # shadow is invisible to admission sizing and version probes.
    @property
    def rows_per_query(self) -> int:
        return getattr(self.primary, "rows_per_query", 1)

    @property
    def model_version(self) -> str:
        return getattr(self.primary, "model_version", "unversioned")

    def swap_version(self, version: str) -> str:
        return self.primary.swap_version(version)

    def _shadow_one(self, queries: List[str],
                    primary_rankings: List[List[Tuple]],
                    parent_ctx=None) -> None:
        version = str(getattr(self.candidate, "model_version",
                              "candidate"))
        metrics = telemetry.get_registry()
        tracer = telemetry.get_tracer()
        try:
            # Re-anchor this worker thread under the serving request's span
            # (thread-local span stacks don't cross threads on their own),
            # so shadow scoring shows up inside the request trace instead
            # of as a parentless root.
            with tracer.activate(parent_ctx):
                with tracer.span("shadow.rank_batch",
                                 queries=len(queries),
                                 model_version=version):
                    t0 = time.perf_counter()
                    shadow = self.candidate.rank_batch(queries)
            dt_ms = (time.perf_counter() - t0) * 1e3
            metrics.inc("shadow_queries", float(len(queries)),
                        model_version=version)
            metrics.observe("shadow_rank_ms", dt_ms, model_version=version)
            for prim, cand in zip(primary_rankings, shadow):
                if not prim or not cand:
                    continue
                p_doc, p_sent, p_score = prim[0]
                c_doc, c_sent, c_score = cand[0]
                if (p_doc, p_sent) != (c_doc, c_sent):
                    metrics.inc("shadow_top1_changed",
                                model_version=version)
                metrics.observe("shadow_score_divergence",
                                abs(float(p_score) - float(c_score)),
                                buckets=(0.001, 0.01, 0.05, 0.1, 0.5,
                                         1.0, 5.0),
                                model_version=version)
        except Exception:  # noqa: BLE001 — a shadow must never surface
            metrics.inc("shadow_errors", model_version=version)
        finally:
            self._pending.release()

    def _mirror(self, queries: List[str], rankings: List[List[Tuple]]):
        sampled_idx = [i for i, q in enumerate(queries)
                       if sample_query(q, self.fraction)]
        if not sampled_idx:
            return
        if not self._pending.acquire(blocking=False):
            telemetry.get_registry().inc("shadow_dropped",
                                         float(len(sampled_idx)))
            return
        # Capture the caller's span context BEFORE spawning: the shadow
        # thread has its own (empty) span stack, so without an explicit
        # handover its spans would detach from the request trace.
        parent_ctx = telemetry.get_tracer().current_context()
        threading.Thread(
            target=self._shadow_one,
            args=([queries[i] for i in sampled_idx],
                  [rankings[i] for i in sampled_idx],
                  parent_ctx),
            daemon=True).start()

    def rank(self, query: str):
        out = self.primary.rank(query)
        cands = out[0] if isinstance(out, tuple) else out
        self._mirror([query], [[(c.doc_id, c.sent_id, c.score)
                                for c in cands]])
        return out

    def rank_batch(self, queries: Sequence[str],
                   deadline_abs: Optional[float] = None):
        queries = list(queries)
        rankings = self.primary.rank_batch(queries,
                                           deadline_abs=deadline_abs)
        self._mirror(queries, rankings)
        return rankings

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Wait for ALL in-flight shadow threads to finish (tests,
        teardown): every semaphore permit must be reclaimable at once —
        one free permit only proves the shadow isn't saturated."""
        deadline = time.perf_counter() + timeout_s
        held = 0
        try:
            while held < self._max_pending:
                if self._pending.acquire(blocking=False):
                    held += 1
                    continue
                if time.perf_counter() >= deadline:
                    return False
                time.sleep(0.005)
            return True
        finally:
            for _ in range(held):
                self._pending.release()

    def stats(self) -> Dict[str, float]:
        s = dict(self.primary.stats()) if hasattr(self.primary,
                                                  "stats") else {}
        s["shadow_fraction"] = self.fraction
        return s


# ================================================================ A/B =====


class ABEngine:
    """Deterministic per-query A/B split between two version-bound engines.

    ``split_pct`` percent of the query hash space routes to ``arm_b``, the
    rest to ``arm_a``; the digest is stable, so the same query string hits
    the same arm on every request and in every process. Per-arm traffic is
    counted here (``ab_queries{arm=..,model_version=..}``), and each arm's
    own ``PipelineEngine`` metrics carry its ``model_version`` label — the
    per-version keys ``Fabric.aggregate_metrics()`` separates."""

    supports_deadline = True

    def __init__(self, arm_a, arm_b, split_pct: float = 50.0):
        if not 0.0 <= split_pct <= 100.0:
            raise ValueError(f"split_pct {split_pct} outside [0, 100]")
        self.arm_a = arm_a
        self.arm_b = arm_b
        self.split_pct = split_pct

    @property
    def rows_per_query(self) -> int:
        return max(getattr(self.arm_a, "rows_per_query", 1),
                   getattr(self.arm_b, "rows_per_query", 1))

    @property
    def model_version(self) -> str:
        return (f"{getattr(self.arm_a, 'model_version', 'a')}"
                f"|{getattr(self.arm_b, 'model_version', 'b')}")

    def arm_of(self, query: str) -> str:
        """"a" or "b" — exposed so tests/operators can predict routing."""
        in_b = query_bucket(query) < self.split_pct / 100.0 * _SPLIT_BUCKETS
        return "b" if in_b else "a"

    def _count(self, arm_name: str, engine, n: int) -> None:
        telemetry.get_registry().inc(
            "ab_queries", float(n), arm=arm_name,
            model_version=str(getattr(engine, "model_version", arm_name)))

    def rank(self, query: str):
        arm_name = self.arm_of(query)
        engine = self.arm_b if arm_name == "b" else self.arm_a
        self._count(arm_name, engine, 1)
        return engine.rank(query)

    def rank_batch(self, queries: Sequence[str],
                   deadline_abs: Optional[float] = None):
        """Partition the batch by arm, rank each side as one sub-batch,
        reassemble in request order."""
        queries = list(queries)
        idx_a = [i for i, q in enumerate(queries) if self.arm_of(q) == "a"]
        idx_b = [i for i in range(len(queries)) if i not in set(idx_a)]
        out: List[Any] = [None] * len(queries)
        for arm_name, engine, idx in (("a", self.arm_a, idx_a),
                                      ("b", self.arm_b, idx_b)):
            if not idx:
                continue
            self._count(arm_name, engine, len(idx))
            sub = engine.rank_batch([queries[i] for i in idx],
                                    deadline_abs=deadline_abs)
            for i, ranking in zip(idx, sub):
                out[i] = ranking
        return out

    def stats(self) -> Dict[str, float]:
        s: Dict[str, float] = {"ab_split_pct": self.split_pct}
        for arm_name, engine in (("a", self.arm_a), ("b", self.arm_b)):
            if hasattr(engine, "stats"):
                for k, v in engine.stats().items():
                    s[f"arm_{arm_name}_{k}"] = v
        return s
