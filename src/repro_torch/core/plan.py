"""Planner: lower one declarative ``ops.Pipeline`` to an execution plan.

The algebra (``repro_torch.core.ops``) describes *what* a ranking pipeline
computes; this module decides *how*. One pipeline lowers to:

  local    sequential per-query cascade — ``MultiStageRanker`` over the
           ``Stage`` impls (the paper's in-process feedforward integration).
  batched  cross-query coalesced execution — ``BatchedMultiStageRanker``'s
           one-featurization-pass / bucketed-scorer path for ``run_many``
           (one BM25 call and one scorer stream per query batch).

The ``remote`` and ``remote_pipeline`` targets keep their names and raise
``PlanError`` until the serving stack is ported.

Plan-level optimizations applied at lowering time:

  * ``ops.normalize``: adjacent Cutoff merging, folding a Cutoff into the
    preceding Rerank/Fuse ``k`` (see ops.py);
  * k / h pushdown into the scorer's bucket choice: the planner tracks an
    upper bound on the candidate count flowing into each rerank (retrieve
    ``h`` x max sentences per doc, clipped by upstream cutoffs) and builds
    the backend scorer with a bucket ladder capped there, so scorer calls
    are padded to no more rows than the plan can ever produce. The batched
    target scales the cap by ``ctx.batch_hint`` since its scorer calls span
    the query batch.
  * one shared ``FeaturizationCache`` per plan context, used by every
    coalesced rerank and fusion stage in the plan (and shared across plans
    built from the same context — so equivalence checks compare scorers,
    not featurization rounding).

Both plans produce identical rankings (``verify_plans`` asserts it,
tolerating order swaps only between float-level score ties). BM25 and the
scorers run on ``ctx.device``: the CUDA card unless the context is built
with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import ops
from repro_torch.core import pipeline as PL
from repro_torch.core.batch_pipeline import BatchedMultiStageRanker
from repro_torch.data.featurize import FeaturizationCache

TARGETS = ("local", "batched", "remote", "remote_pipeline")
PORTED_TARGETS = ("local", "batched")

#: Bucket ladder bounds: entries grow 1 -> 8 -> 64 -> x4 up to this cap.
MAX_BUCKET = 4096


class PlanError(ValueError):
    """A pipeline cannot be lowered to the requested target/context."""


def bucket_ladder(cap: Optional[int]) -> Tuple[int, ...]:
    """Ascending scorer buckets whose top entry covers ``cap`` rows (so a
    full-size stage call pads instead of chunking), trimmed so no bucket
    below the top is already >= cap. ``None`` -> the default ladder."""
    if cap is None:
        return (1, 8, 64, 256)
    cap = max(int(cap), 1)
    ladder = [1, 8, 64]
    while ladder[-1] < min(cap, MAX_BUCKET):
        ladder.append(ladder[-1] * 4)
    while len(ladder) > 1 and ladder[-2] >= cap:
        ladder.pop()
    return tuple(ladder)


@dataclasses.dataclass
class PlanContext:
    """Everything a description needs to become executable: the corpus-side
    bindings (tokenizer, idf, documents, indexes), the model-side bindings
    (cfg + params for building backend scorers by name), the shared
    featurization cache, and the device BM25 and the scorers run on.

    ``params`` is the JAX parameter tree as numpy arrays (or the port's
    tensors). ``device`` defaults to ``"cuda"``; without a card the context
    raises unless it is built with ``device="cpu"``.
    """

    tokenizer: Any
    idf: Dict[str, float]
    max_len: int
    index: Any = None
    documents: Sequence[Sequence[str]] = ()
    indexes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cfg: Any = None
    params: Any = None
    cache: Optional[FeaturizationCache] = None
    cache_capacity: int = 8192
    batch_hint: int = 32
    buckets: Optional[Tuple[int, ...]] = None
    device: Any = DEFAULT_DEVICE

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.cache is None:
            self.cache = FeaturizationCache(self.tokenizer, self.idf,
                                            self.max_len,
                                            self.cache_capacity)
        self._scorers: Dict[Tuple, Any] = {}

    @classmethod
    def from_world(cls, cfg, params, corpus, tokenizer, index,
                   **kw) -> "PlanContext":
        """Bind a demo world: config, weights, corpus, tokenizer, index."""
        return cls(tokenizer=tokenizer, idf=corpus.idf, max_len=cfg.max_len,
                   index=index, documents=corpus.documents, cfg=cfg,
                   params=params, **kw)

    def resolve_index(self, spec):
        if not isinstance(spec, str):
            return spec
        if spec in self.indexes:
            return self.indexes[spec]
        if spec == "default" and self.index is not None:
            return self.index
        raise PlanError(f"no index bound for {spec!r} "
                        f"(known: {sorted(self.indexes) + ['default']})")

    def scorer_for(self, spec, cap: Optional[int] = None):
        """A ``backends.Scorer`` for ``spec``: prebuilt scorers pass
        through; backend names are built (and memoized) with a bucket
        ladder capped at the plan's candidate bound."""
        if not isinstance(spec, str):
            return spec
        buckets = self.buckets or bucket_ladder(cap)
        key = (spec, buckets)
        if key not in self._scorers:
            if self.params is None or self.cfg is None:
                raise PlanError(f"building scorer {spec!r} needs cfg+params "
                                f"bound in the PlanContext")
            from repro_torch.core import backends as BK
            self._scorers[key] = BK.make_scorer(spec, self.params, self.cfg,
                                                buckets=buckets,
                                                device=self.device)
        return self._scorers[key]

    def scorers(self) -> List[Any]:
        """The backend scorers this context has built so far."""
        return list(self._scorers.values())


def _rank_by_scores(candidates, scores,
                    k: Optional[int]) -> List[PL.Candidate]:
    """Rebuild candidates with new scores, sorted desc, truncated to k."""
    ranked = sorted((PL.Candidate(c.doc_id, c.sent_id, c.text, float(s))
                     for c, s in zip(candidates, scores)),
                    key=lambda c: -c.score)
    return ranked[: k]


class _LocalChild:
    """Fusion child scoring through an in-process backend Scorer."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.name = scorer.name

    def score(self, q_tok, a_tok, feats) -> np.ndarray:
        return np.asarray(self.scorer(q_tok, a_tok, feats))


class FuseStage(PL.Stage):
    """Linear score interpolation (``ops.Fuse``): every child scores the
    same candidates; output score is ``sum(w_i * s_i)``, ranked desc, cut to
    ``k``. Featurization happens once per stage call through the plan's
    shared cache regardless of how many children there are; ``run_batch``
    coalesces across the query batch."""

    def __init__(self, children, weights: Sequence[float],
                 cache: FeaturizationCache, k: Optional[int] = None,
                 name: Optional[str] = None):
        self.children = list(children)
        self.weights = [float(w) for w in weights]
        self.cache = cache
        self.k = k
        self.name = name or ("fuse(" + "+".join(c.name for c in children)
                             + ")" + (f"-k{k}" if k is not None else ""))

    def _fused(self, pairs: List[Tuple[str, str]],
               q_rows: List[np.ndarray], a_rows: List[np.ndarray]
               ) -> np.ndarray:
        q_tok, a_tok = np.stack(q_rows), np.stack(a_rows)
        feats = self.cache.pair_feats_many(pairs)
        total = np.zeros((len(pairs),), np.float64)
        for child, w in zip(self.children, self.weights):
            total += w * np.asarray(child.score(q_tok, a_tok, feats),
                                    np.float64)
        return total

    def run(self, query, candidates):
        if not candidates:
            return []
        q_row = self.cache.query_row(query)
        pairs = [(query, c.text) for c in candidates]
        fused = self._fused(pairs, [q_row] * len(candidates),
                            [self.cache.answer_row(c.text)
                             for c in candidates])
        return _rank_by_scores(candidates, fused, self.k)

    def run_batch(self, queries, states):
        active = [i for i, c in enumerate(states or []) if c]
        pairs, q_rows, a_rows = [], [], []
        for i in active:
            q_row = self.cache.query_row(queries[i])
            for c in states[i]:
                pairs.append((queries[i], c.text))
                q_rows.append(q_row)
                a_rows.append(self.cache.answer_row(c.text))
        fused = (self._fused(pairs, q_rows, a_rows) if pairs
                 else np.zeros((0,)))
        outs: List[List[PL.Candidate]] = [[] for _ in queries]
        offset = 0
        for i in active:
            n = len(states[i])
            outs[i] = _rank_by_scores(states[i], fused[offset:offset + n],
                                      self.k)
            offset += n
        return outs


def _min_bound(bound: Optional[int], k: Optional[int]) -> Optional[int]:
    if k is None:
        return bound
    return k if bound is None else min(bound, k)


def _retrieve_bound(op: "ops.Retrieve", ctx: PlanContext) -> Optional[int]:
    """Candidate rows one query's Retrieve can produce: h docs x the widest
    document's sentence count (None when no documents are bound)."""
    max_sents = max((len(d) for d in ctx.documents), default=0)
    return op.h * max_sents if max_sents else None


def _scorer_cap(bound: Optional[int], target: str,
                ctx: PlanContext) -> Optional[int]:
    """k-pushdown: the scorer never sees more rows than the plan's candidate
    bound — scaled by the batch hint for the batched target, whose scorer
    calls span the whole query batch."""
    if bound is None:
        return None
    if target == "batched":
        return min(bound * max(ctx.batch_hint, 1), MAX_BUCKET)
    return bound


def _rerank_name(spec, k: Optional[int]) -> str:
    tag = spec if isinstance(spec, str) else getattr(spec, "name", "scorer")
    return f"rerank-{tag}" + (f"-k{k}" if k is not None else "")


def _check_target(target: str) -> None:
    if target not in TARGETS:
        raise PlanError(f"unknown target {target!r}; one of {TARGETS}")
    if target not in PORTED_TARGETS:
        raise PlanError(f"target {target!r} is not ported yet (ported: "
                        f"{PORTED_TARGETS}); it arrives with the serving "
                        f"slice of the port")


def lower(pipeline: ops.Op, target: str, ctx: PlanContext) -> List[PL.Stage]:
    """Normalize + lower a pipeline description to a Stage cascade."""
    _check_target(target)
    steps = ops.normalize(pipeline).steps
    if not steps:
        raise PlanError("empty pipeline")
    if not isinstance(steps[0], ops.Retrieve):
        raise PlanError(f"pipeline must start with Retrieve, "
                        f"got {type(steps[0]).__name__}")
    stages: List[PL.Stage] = []
    bound: Optional[int] = None
    for op in steps:
        if isinstance(op, ops.Retrieve):
            if stages:
                raise PlanError("Retrieve must be the first op")
            index = ctx.resolve_index(op.index)
            stages.append(PL.RetrievalStage(index, ctx.documents,
                                            ctx.tokenizer, h=op.h,
                                            device=ctx.device))
            bound = _retrieve_bound(op, ctx)
        elif isinstance(op, ops.Cutoff):
            stages.append(PL.TopKStage(op.k))
            bound = _min_bound(bound, op.k)
        elif isinstance(op, ops.DynamicCutoff):
            stages.append(PL.CutoffStage(op.margin, op.min_keep))
        elif isinstance(op, ops.Rerank):
            scorer = ctx.scorer_for(op.scorer, _scorer_cap(bound, target, ctx))
            stages.append(PL.RerankStage(
                scorer, ctx.tokenizer, ctx.idf, ctx.max_len, k=op.k,
                name=_rerank_name(op.scorer, op.k)))
            bound = _min_bound(bound, op.k)
        elif isinstance(op, ops.Fuse):
            cap = _scorer_cap(bound, target, ctx)
            children = []
            for child in op.children:
                if not isinstance(child, ops.Rerank):
                    raise PlanError("nested Fuse lowering is not supported "
                                    "yet; flatten the fusion")
                children.append(_LocalChild(ctx.scorer_for(child.scorer, cap)))
            stages.append(FuseStage(children, op.weights, ctx.cache,
                                    k=op.k))
            bound = _min_bound(bound, op.k)
        else:
            raise PlanError(f"cannot lower op {op!r}")
    return stages


class ExecutionPlan:
    """A lowered pipeline: ``run`` one query, ``run_many`` a batch.

    local    run/run_many are sequential ``MultiStageRanker`` passes.
    batched  both route through ``BatchedMultiStageRanker`` (run_many is
             the coalesced cross-query schedule).
    Both return ``(candidates, trace)`` per query.
    """

    def __init__(self, pipeline: ops.Op, target: str, stages: List[PL.Stage],
                 ctx: PlanContext):
        self.pipeline = pipeline
        self.target = target
        self.stages = stages
        self.ctx = ctx
        self._seq = PL.MultiStageRanker(stages)
        self._bat = BatchedMultiStageRanker(stages, shared_cache=ctx.cache)

    def _shed_if_expired(self, deadline_abs: Optional[float]) -> None:
        """Drop work whose deadline already passed: the cascade below
        would run entirely for an answer nobody is waiting for.  Raised
        as a retriable ShedError exactly like the server-side sheds."""
        if deadline_abs is None or time.perf_counter() < deadline_abs:
            return
        from repro_torch.core.wire import ShedError
        from repro_torch.serving import telemetry
        telemetry.get_registry().inc("plan_sheds_expired",
                                     target=self.target)
        raise ShedError("expired")

    def run(self, query: str, deadline_abs: Optional[float] = None):
        self._shed_if_expired(deadline_abs)
        if self.target == "batched":
            return self._bat.run(query)
        return self._seq.run(query)

    def run_many(self, queries: Sequence[str],
                 deadline_abs: Optional[float] = None):
        self._shed_if_expired(deadline_abs)
        if self.target == "local":
            return [self._seq.run(q) for q in queries]
        return self._bat.run_batch(queries)

    def describe(self) -> str:
        parts = []
        for s in self.stages:
            extra = ""
            scorer = getattr(s, "scorer", None)
            if scorer is not None and hasattr(scorer, "_buckets"):
                extra = f"[buckets={scorer._buckets}]"
            parts.append(s.name + extra)
        return f"{self.target}@{self.ctx.device}: " + " -> ".join(parts)

    def __repr__(self) -> str:
        return f"<ExecutionPlan {self.describe()}>"


def plan(pipeline: ops.Op, target: str = "local",
         ctx: Optional[PlanContext] = None, **ctx_kw) -> ExecutionPlan:
    """Lower ``pipeline`` to an ``ExecutionPlan`` for ``target``.

    ``ctx`` carries the bindings; keyword args build one ad hoc (they are
    ``PlanContext`` fields). The same pipeline value can be planned for
    every target — the description never changes, only the lowering.
    """
    _check_target(target)
    if ctx is None:
        ctx = PlanContext(**ctx_kw)
    elif ctx_kw:
        ctx = dataclasses.replace(ctx, **ctx_kw)
    return ExecutionPlan(pipeline, target, lower(pipeline, target, ctx), ctx)


def _ranking_ids(cands) -> List[Tuple[int, int, str]]:
    return [(c.doc_id, c.sent_id, c.text) for c in cands]


def verify_plans(plans: Sequence[ExecutionPlan], queries: Sequence[str],
                 tie_atol: float = 1e-5) -> None:
    """Assert every plan produces the ranking of ``plans[0]`` on every
    query: same candidate set, same order — order may differ only between
    candidates whose scores are within ``tie_atol`` (different execution
    schedules can flip float-level ties in the last ulp)."""
    base = plans[0].run_many(queries)
    for other in plans[1:]:
        got = other.run_many(queries)
        for q, (bc, _), (oc, _) in zip(queries, base, got):
            b_ids, o_ids = _ranking_ids(bc), _ranking_ids(oc)
            if b_ids == o_ids:
                continue
            assert sorted(b_ids) == sorted(o_ids), (
                f"candidate set mismatch ({plans[0].target} vs "
                f"{other.target}) for query {q!r}: {b_ids} != {o_ids}")
            for rank, (bi, oi) in enumerate(zip(b_ids, o_ids)):
                if bi != oi:
                    gap = abs(bc[rank].score - oc[rank].score)
                    assert gap <= tie_atol, (
                        f"ranking mismatch ({plans[0].target} vs "
                        f"{other.target}) for query {q!r} at rank {rank}: "
                        f"{bi} != {oi} (score gap {gap:g})")
