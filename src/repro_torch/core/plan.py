"""Planner: lower one declarative ``ops.Pipeline`` to an execution plan.

The algebra (``repro_torch.core.ops``) describes *what* a ranking pipeline
computes; this module decides *how*. One pipeline lowers to any of four
targets:

  local    sequential per-query cascade — ``MultiStageRanker`` over the
           ``Stage`` impls (the paper's in-process feedforward integration).
  batched  cross-query coalesced execution — ``BatchedMultiStageRanker``'s
           one-featurization-pass / bucketed-scorer path for ``run_many``
           (one BM25 call and one scorer stream per query batch).
  remote   rerank stages dispatch their (query, sentence) pairs through an
           RPC boundary — a ``core.service.Client`` (with a shed-retry
           budget), or any in-process handler with ``get_scores`` (e.g. a
           ``serving.engine.ServingEngine``). Retrieval and cutoffs stay
           local; ``run_many`` coalesces all queries' pairs into chunked
           batch RPCs (the paper's service integration).
  remote_pipeline
           the WHOLE cascade runs server-side behind wire v3 MSG_RANK /
           MSG_RANK_BATCH (a ``serving.engine.PipelineEngine`` handler):
           the client sends query strings — one RPC per query batch — and
           gets ranked (doc_id, sent_id, score) lists back, rebuilding
           candidate text from the context's bound documents. No candidate
           pairs cross the RPC boundary.

Remote endpoints may be given as a LIST of endpoints, which enables hedged
dispatch (``serving.hedge.HedgedTransport``): slow requests race a second
replica after a p95-based hedge delay (``ctx.hedge_ms`` forces a fixed
delay) and the first answer wins. The wire frames are the JAX package's,
so a remote endpoint may be a server of either package.

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

All targets produce identical rankings (``verify_plans`` asserts it,
tolerating order swaps only between float-level score ties). BM25 and the
scorers run on ``ctx.device``: the CUDA card unless the context is built
with ``device="cpu"``; a remote target scores wherever its server does.
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


class _HandlerTransport:
    """Adapt any ``get_scores(pairs)`` handler (QuestionAnsweringHandler,
    ServingEngine) to the client's ``get_score_batch``."""

    #: the plan threads request deadlines through this adapter; handlers
    #: that opt in (ServingEngine) drop expired work at their batcher
    #: dequeue exactly as they do behind a socket server.
    supports_deadline = True

    def __init__(self, handler):
        self._handler = handler

    def get_score_batch(self, pairs, deadline_abs: Optional[float] = None):
        if deadline_abs is not None and getattr(
                self._handler, "supports_deadline", False):
            return self._handler.get_scores(pairs,
                                            deadline_abs=deadline_abs)
        return self._handler.get_scores(pairs)


@dataclasses.dataclass
class PlanContext:
    """Everything a description needs to become executable: the corpus-side
    bindings (tokenizer, idf, documents, indexes), the model-side bindings
    (cfg + params for building backend scorers by name), the shared
    featurization cache, the device BM25 and the scorers run on, and the
    remote endpoints for the remote targets.

    ``remote`` may be a ``(host, port)`` address (a ``service.Client`` with
    a shed-retry budget is created lazily), an object with
    ``get_score_batch`` or ``get_scores``, a LIST of either (hedged
    dispatch: two endpoints raced through ``serving.hedge.HedgedTransport``
    with a p95-based — or fixed ``hedge_ms`` — hedge delay), or a dict
    mapping scorer specs to any of those (key "default" is the fallback) so
    fused remote stages can hit different endpoints per backend. The
    ``remote_pipeline`` target resolves the same binding but requires
    ranking-capable endpoints (``rank_batch``: a ``service.Client`` address
    or a ``serving.engine.PipelineEngine``). Anything exposing a
    ranking-capable ``.router`` (the JAX package's serving fabric) binds
    through that router.

    ``params`` is the JAX parameter tree as numpy arrays (or the port's
    tensors), or comes from ``registry`` at ``model_version``. ``device``
    defaults to ``"cuda"``; without a card the context raises unless it is
    built with ``device="cpu"``.
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
    remote: Any = None
    remote_retries: int = 2
    remote_backoff_s: float = 0.005
    #: Fixed hedge delay in milliseconds for list-of-endpoints remotes;
    #: ``None`` lets the HedgedTransport adapt (p95 of observed latency).
    hedge_ms: Optional[float] = None
    #: Max queries per ranking RPC (remote_pipeline target). ``None`` sends
    #: the whole query batch as ONE RPC. Set a chunk when driving huge
    #: batches at a tightly-bounded server: the server sizes a ranking
    #: request at len(queries) x rows_per_query, and a single RPC past its
    #: bound is a permanent too_large error.
    rank_chunk: Optional[int] = None
    #: Max pairs per remote scoring RPC. Coalesced run_many calls are
    #: chunked at this size so one query batch never exceeds a server's
    #: admission bound — an over-bound batch would be a permanent too_large
    #: rejection, while chunks at worst shed retriably under load (and the
    #: plan's Client carries a shed-retry budget).
    remote_chunk: int = 256
    #: Model registry binding (``core.registry.ModelRegistry``). With a
    #: ``model_version`` set, construction resolves the version and loads
    #: its weights INSTEAD of serving ``params`` as passed — the version id
    #: becomes the context's model identity. ``params`` then only serves as
    #: the template for restore (optional: without one the tree is rebuilt
    #: from the stored tensor names).
    registry: Any = None
    model_version: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.cache is None:
            self.cache = FeaturizationCache(self.tokenizer, self.idf,
                                            self.max_len,
                                            self.cache_capacity)
        if self.model_version is not None:
            if self.registry is None:
                raise PlanError(f"model_version "
                                f"{self.model_version!r} is bound but no "
                                f"registry is")
            self.model_version = self.registry.resolve(self.model_version)
            self.params = self.registry.load_params(self.model_version,
                                                    template=self.params)
        self._scorers: Dict[Tuple, Any] = {}
        self._transports: Dict[Any, Any] = {}
        self._owned_clients: List[Any] = []

    def bind_version(self, version: str) -> "PlanContext":
        """A NEW context serving ``version`` ("latest", an id, or a unique
        prefix): same corpus/cache/remote bindings, freshly resolved params
        and an empty scorer memo — the hot-swap building block
        (``serving.engine.PipelineEngine.swap_version`` plans against the
        rebound context, then swaps plans atomically)."""
        if self.registry is None:
            raise PlanError("bind_version needs ctx.registry bound")
        return dataclasses.replace(self, model_version=version)

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

    @staticmethod
    def _is_address(remote) -> bool:
        """A ``(host, port)`` pair — as opposed to a list of endpoints."""
        return (isinstance(remote, tuple) and len(remote) == 2
                and isinstance(remote[0], str)
                and isinstance(remote[1], int))

    def _resolve_remote(self, spec):
        remote = self.remote
        if isinstance(remote, dict):
            key = spec if isinstance(spec, str) else "default"
            remote = remote.get(key, remote.get("default"))
        if remote is None:
            raise PlanError(f"remote target needs ctx.remote bound "
                            f"(no endpoint for {spec!r})")
        return remote

    def _endpoint_key(self, remote):
        # Addresses key by value (two specs pointing at the same server
        # share one connection), handler objects by identity.
        if self._is_address(remote):
            return ("addr", remote)
        if isinstance(remote, (list, tuple)):
            return ("hedged", tuple(self._endpoint_key(r) for r in remote))
        return ("obj", id(remote))

    def _single_transport(self, remote, ranking: bool):
        router = getattr(remote, "router", None)
        if router is not None and hasattr(router, "rank_batch"):
            # A serving fabric: its router IS the transport (health-routed
            # and hedged across the worker processes). The fabric owns the
            # router's lifecycle — it is NOT added to _owned_clients.
            return router
        if self._is_address(remote):
            from repro_torch.core.service import Client
            client = Client(remote, retry_sheds=self.remote_retries,
                            backoff_s=self.remote_backoff_s)
            self._owned_clients.append(client)
            return client
        if ranking:
            if hasattr(remote, "rank_batch"):
                return remote
            raise PlanError(f"remote_pipeline endpoint {remote!r} cannot "
                            f"serve rankings (needs rank_batch — a server "
                            f"address or a PipelineEngine)")
        if hasattr(remote, "get_score_batch"):
            return remote
        if hasattr(remote, "get_scores"):
            return _HandlerTransport(remote)
        raise PlanError(f"unusable remote endpoint {remote!r}")

    def _transport(self, remote, ranking: bool):
        cache_key = (self._endpoint_key(remote), ranking)
        if cache_key not in self._transports:
            if (isinstance(remote, (list, tuple))
                    and not self._is_address(remote)):
                from repro_torch.serving.hedge import HedgedTransport
                hedge_s = (self.hedge_ms / 1e3 if self.hedge_ms is not None
                           else None)
                self._transports[cache_key] = HedgedTransport(
                    [self._single_transport(r, ranking) for r in remote],
                    hedge_s=hedge_s)
            else:
                self._transports[cache_key] = self._single_transport(
                    remote, ranking)
        return self._transports[cache_key]

    def transport_for(self, spec):
        """The remote scoring endpoint for a rerank spec (see class doc)."""
        return self._transport(self._resolve_remote(spec), ranking=False)

    def ranking_transport(self):
        """The whole-pipeline ranking endpoint (``remote_pipeline`` target):
        anything with ``rank_batch(queries) -> rankings`` — a v3
        ``service.Client`` (built lazily from an address), a
        ``PipelineEngine``, or a hedged list of either."""
        return self._transport(self._resolve_remote("default"),
                               ranking=True)

    def close(self) -> None:
        """Close the ``service.Client`` connections this context opened
        (endpoints passed in as live objects are the caller's to manage)."""
        for client in self._owned_clients:
            try:
                client.close()
            except OSError:
                pass
        self._owned_clients.clear()
        self._transports.clear()

    def __enter__(self) -> "PlanContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _deadline_kwargs(transport, deadline_abs: Optional[float]
                     ) -> Dict[str, float]:
    """The deadline keyword a transport understands, if any: transports
    advertising ``supports_deadline`` (clients, engines, hedged wrappers)
    take the absolute deadline; everything else gets nothing rather than an
    unexpected-keyword error."""
    if deadline_abs is not None and getattr(transport,
                                            "supports_deadline", False):
        return {"deadline_abs": deadline_abs}
    return {}


def _chunked_remote_scores(transport, pairs: List[Tuple[str, str]],
                           max_rpc_pairs: int,
                           deadline_abs: Optional[float] = None
                           ) -> np.ndarray:
    """Score pairs over a transport in RPC-sized chunks (see
    ``PlanContext.remote_chunk``). The request deadline rides along on
    every chunk so a late chunk sheds server-side instead of queueing."""
    kw = _deadline_kwargs(transport, deadline_abs)
    out: List[float] = []
    for i in range(0, len(pairs), max_rpc_pairs):
        out.extend(transport.get_score_batch(pairs[i:i + max_rpc_pairs],
                                             **kw))
    return np.asarray(out, np.float64)


def _rank_by_scores(candidates, scores,
                    k: Optional[int]) -> List[PL.Candidate]:
    """Rebuild candidates with new scores, sorted desc, truncated to k."""
    ranked = sorted((PL.Candidate(c.doc_id, c.sent_id, c.text, float(s))
                     for c, s in zip(candidates, scores)),
                    key=lambda c: -c.score)
    return ranked[: k]


class RemoteRerankStage(PL.Stage):
    """Rerank through an RPC boundary: ship (query, sentence) pairs to the
    transport, rank by the returned scores. ``run_batch`` coalesces every
    query's pairs into chunked batch calls — the remote analogue of the
    batched engine's coalesced scorer stream."""

    def __init__(self, transport, k: Optional[int] = None,
                 name: str = "rerank-remote", max_rpc_pairs: int = 256):
        self.name = name
        self.transport = transport
        self.k = k
        self.max_rpc_pairs = max_rpc_pairs

    def _score(self, pairs: List[Tuple[str, str]],
               deadline_abs: Optional[float] = None) -> np.ndarray:
        return _chunked_remote_scores(self.transport, pairs,
                                      self.max_rpc_pairs,
                                      deadline_abs=deadline_abs)

    def run(self, query, candidates,
            deadline_abs: Optional[float] = None):
        if not candidates:
            return []
        return _rank_by_scores(
            candidates,
            self._score([(query, c.text) for c in candidates],
                        deadline_abs=deadline_abs),
            self.k)

    def run_batch(self, queries, states,
                  deadline_abs: Optional[float] = None):
        active = [i for i, c in enumerate(states or []) if c]
        pairs: List[Tuple[str, str]] = []
        for i in active:
            pairs.extend((queries[i], c.text) for c in states[i])
        scores = (self._score(pairs, deadline_abs=deadline_abs)
                  if pairs else np.zeros((0,)))
        outs: List[List[PL.Candidate]] = [[] for _ in queries]
        offset = 0
        for i in active:
            n = len(states[i])
            outs[i] = _rank_by_scores(states[i], scores[offset:offset + n],
                                      self.k)
            offset += n
        return outs


class _LocalChild:
    """Fusion child scoring through an in-process backend Scorer."""

    needs_arrays = True

    def __init__(self, scorer):
        self.scorer = scorer
        self.name = scorer.name

    def score(self, pairs, q_tok, a_tok, feats) -> np.ndarray:
        return np.asarray(self.scorer(q_tok, a_tok, feats))


class _RemoteChild:
    """Fusion child scoring through a remote transport."""

    needs_arrays = False

    def __init__(self, transport, name: str, max_rpc_pairs: int = 256):
        self.transport = transport
        self.name = name
        self.max_rpc_pairs = max_rpc_pairs

    def score(self, pairs, q_tok, a_tok, feats) -> np.ndarray:
        return _chunked_remote_scores(self.transport, pairs,
                                      self.max_rpc_pairs)


class FuseStage(PL.Stage):
    """Linear score interpolation (``ops.Fuse``): every child scores the
    same candidates; output score is ``sum(w_i * s_i)``, ranked desc, cut to
    ``k``. Featurization happens once per stage call through the plan's
    shared cache regardless of how many local children there are;
    ``run_batch`` coalesces across the query batch."""

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
        if any(c.needs_arrays for c in self.children):
            q_tok, a_tok = np.stack(q_rows), np.stack(a_rows)
            feats = self.cache.pair_feats_many(pairs)
        else:
            q_tok = a_tok = feats = None
        total = np.zeros((len(pairs),), np.float64)
        for child, w in zip(self.children, self.weights):
            total += w * np.asarray(
                child.score(pairs, q_tok, a_tok, feats), np.float64)
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
    document's sentence count (None when no documents are bound). The single
    source for both plan lowering and admission estimates."""
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


def candidate_bound(pipeline: ops.Op, ctx: PlanContext) -> Optional[int]:
    """Upper bound on candidate rows ONE query pushes into the widest
    rerank/fuse stage of ``pipeline``: retrieve depth x max sentences per
    bound document, clipped by upstream cutoffs/k. This is the admission
    row estimate a ``PipelineEngine`` reports per ranking query
    (``rows_per_query``). ``None`` when no rerank work exists or no
    documents are bound."""
    bound: Optional[int] = None
    peak: Optional[int] = None
    for op in ops.normalize(pipeline).steps:
        if isinstance(op, ops.Retrieve):
            bound = _retrieve_bound(op, ctx)
        elif isinstance(op, ops.Cutoff):
            bound = _min_bound(bound, op.k)
        elif isinstance(op, (ops.Rerank, ops.Fuse)):
            if bound is not None:
                peak = bound if peak is None else max(peak, bound)
            bound = _min_bound(bound, op.k)
    return peak


def _rerank_name(spec, k: Optional[int], remote: bool) -> str:
    tag = spec if isinstance(spec, str) else getattr(spec, "name", "scorer")
    name = f"rerank-{tag}" + ("@remote" if remote else "")
    return name + (f"-k{k}" if k is not None else "")


def lower(pipeline: ops.Op, target: str, ctx: PlanContext) -> List[PL.Stage]:
    """Normalize + lower a pipeline description to a Stage cascade."""
    if target not in TARGETS:
        raise PlanError(f"unknown target {target!r}; one of {TARGETS}")
    if target == "remote_pipeline":
        raise PlanError("remote_pipeline has no local stage lowering — the "
                        "server runs the cascade; build it with plan()")
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
            if target == "remote":
                stages.append(RemoteRerankStage(
                    ctx.transport_for(op.scorer), k=op.k,
                    name=_rerank_name(op.scorer, op.k, remote=True),
                    max_rpc_pairs=ctx.remote_chunk))
            else:
                scorer = ctx.scorer_for(op.scorer,
                                        _scorer_cap(bound, target, ctx))
                stages.append(PL.RerankStage(
                    scorer, ctx.tokenizer, ctx.idf, ctx.max_len, k=op.k,
                    name=_rerank_name(op.scorer, op.k, remote=False)))
            bound = _min_bound(bound, op.k)
        elif isinstance(op, ops.Fuse):
            cap = _scorer_cap(bound, target, ctx)
            children = []
            for child in op.children:
                if not isinstance(child, ops.Rerank):
                    raise PlanError("nested Fuse lowering is not supported "
                                    "yet; flatten the fusion")
                if target == "remote":
                    children.append(_RemoteChild(
                        ctx.transport_for(child.scorer),
                        _rerank_name(child.scorer, None, remote=True),
                        max_rpc_pairs=ctx.remote_chunk))
                else:
                    children.append(_LocalChild(
                        ctx.scorer_for(child.scorer, cap)))
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
    remote   run is a sequential pass whose rerank stages RPC per query;
             run_many coalesces all queries' pairs per rerank stage.
    remote_pipeline
             the cascade runs server-side (wire v3 MSG_RANK_BATCH): run /
             run_many send query strings — ONE RPC per query batch — and
             rebuild candidates from the returned (doc_id, sent_id, score)
             rankings using the context's bound documents.
    All return ``(candidates, trace)`` per query (the remote_pipeline trace
    is a single stage: the server does not ship its per-stage accounting
    back).
    """

    def __init__(self, pipeline: ops.Op, target: str, stages: List[PL.Stage],
                 ctx: PlanContext):
        self.pipeline = pipeline
        self.target = target
        self.stages = stages
        self.ctx = ctx
        if target == "remote_pipeline":
            self._ranker = ctx.ranking_transport()
            self._seq = self._bat = None
        else:
            self._ranker = None
            self._seq = PL.MultiStageRanker(stages)
            self._bat = BatchedMultiStageRanker(stages,
                                                shared_cache=ctx.cache)

    def _sentence_text(self, doc_id: int, sent_id: int) -> str:
        docs = self.ctx.documents
        if 0 <= doc_id < len(docs) and 0 <= sent_id < len(docs[doc_id]):
            return docs[doc_id][sent_id]
        return ""    # ranking against a corpus this context doesn't bind

    def _run_remote_pipeline(self, queries: Sequence[str],
                             deadline_abs: Optional[float] = None):
        from repro_torch.serving import telemetry
        queries = list(queries)
        chunk = self.ctx.rank_chunk or len(queries) or 1
        kw = _deadline_kwargs(self._ranker, deadline_abs)
        t0 = time.perf_counter()
        rankings: List = []
        # One span per ranking RPC chunk: the transport underneath (Client
        # or HedgedTransport) hangs its own client/hedge spans off this, and
        # a v5 server continues the trace on the far side of the wire.
        with telemetry.get_tracer().span("plan.remote_pipeline",
                                         queries=len(queries)):
            for i in range(0, len(queries), chunk):
                rankings.extend(
                    self._ranker.rank_batch(queries[i:i + chunk], **kw))
        if len(rankings) != len(queries):
            raise ValueError(f"ranking reply held {len(rankings)} rankings "
                             f"for {len(queries)} queries")
        # Amortize the RPC wall time across the batch, matching the other
        # targets' contract that per-query trace latencies sum to ~wall.
        dt = (time.perf_counter() - t0) / max(len(queries), 1)
        out = []
        for ranking in rankings:
            cands = [PL.Candidate(int(d), int(s),
                                  self._sentence_text(int(d), int(s)),
                                  float(score))
                     for d, s, score in ranking]
            out.append((cands, [PL.StageResult("pipeline@remote", cands,
                                               dt)]))
        return out

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
        if self.target == "remote_pipeline":
            return self._run_remote_pipeline(
                [query], deadline_abs=deadline_abs)[0]
        if self.target == "batched":
            return self._bat.run(query)
        return self._seq.run(query)

    def run_many(self, queries: Sequence[str],
                 deadline_abs: Optional[float] = None):
        self._shed_if_expired(deadline_abs)
        if self.target == "remote_pipeline":
            return self._run_remote_pipeline(queries,
                                             deadline_abs=deadline_abs)
        if self.target == "local":
            return [self._seq.run(q) for q in queries]
        return self._bat.run_batch(queries)

    def describe(self) -> str:
        if self.target == "remote_pipeline":
            hedged = any(c.__name__ == "HedgedTransport"
                         for c in type(self._ranker).__mro__)
            return (f"{self.target}: rank-rpc[{self.pipeline!r}]"
                    + ("[hedged]" if hedged else ""))
        parts = []
        for s in self.stages:
            extra = ""
            scorer = getattr(s, "scorer", None)
            if scorer is not None and hasattr(scorer, "_buckets"):
                extra = f"[buckets={scorer._buckets}]"
            elif isinstance(s, RemoteRerankStage):
                extra = "[rpc]"
            parts.append(s.name + extra)
        return f"{self.target}@{self.ctx.device}: " + " -> ".join(parts)

    def __repr__(self) -> str:
        return f"<ExecutionPlan {self.describe()}>"

    def cache_stats(self) -> Dict[str, float]:
        return self.ctx.cache.stats()

    def close(self) -> None:
        """Release the remote connections the plan's context opened. Plans
        sharing one context share its transports — close once, at the end."""
        self.ctx.close()

    def __enter__(self) -> "ExecutionPlan":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def plan(pipeline: ops.Op, target: str = "local",
         ctx: Optional[PlanContext] = None, **ctx_kw) -> ExecutionPlan:
    """Lower ``pipeline`` to an ``ExecutionPlan`` for ``target``.

    ``ctx`` carries the bindings; keyword args build one ad hoc (they are
    ``PlanContext`` fields). The same pipeline value can be planned for
    every target — the description never changes, only the lowering.
    """
    if ctx is None:
        ctx = PlanContext(**ctx_kw)
    elif ctx_kw:
        ctx = dataclasses.replace(ctx, **ctx_kw)
    if target == "remote_pipeline":
        # The server lowers and runs the cascade; locally there is nothing
        # to lower — only the ranking endpoint to bind. Still validate the
        # description so a malformed pipeline fails at plan time here too.
        ops.normalize(pipeline)
        return ExecutionPlan(pipeline, target, [], ctx)
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
