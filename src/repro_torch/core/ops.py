"""Declarative pipeline algebra — one composable ranking API.

The paper's finding is that the *same* trained reranker slots into a
multi-stage architecture through interchangeable execution strategies
(in-process feedforward, RPC service, compiled artifact). Until now each
strategy was a separate entry point (``MultiStageRanker``,
``BatchedMultiStageRanker``, ``ServingEngine``/``Client``). Following
PyTerrier's operator algebra [Macdonald & Tonellotto 2020], this module
separates the *description* of a ranking pipeline from its *execution*:

  Retrieve(h=20) >> (Rerank("jit") | Rerank("numpy")) % 10

is a pure value — a frozen dataclass tree, picklable, printable — and
``repro_torch.core.plan.plan(pipeline, target, ctx)`` lowers it to a local,
batched, or remote execution plan. The runtime, not the caller, picks the
strategy.

Operators (leaf ops):

  Retrieve(index, h)          stage-1 BM25 retrieval + sentence segmentation;
                              ``index`` is a BM25Index or a name resolved by
                              the plan context ("default").
  Rerank(scorer, k)           neural rerank; ``scorer`` is an integration
                              backend name ("eager"/"jit"/"aot"/"numpy"/
                              "pallas"/"artifact"), a prebuilt
                              ``backends.Scorer``, or any callable scorer.
                              ``k=None`` keeps every candidate.
  Cutoff(k)                   rank cutoff: stable sort by score desc, top-k.
  DynamicCutoff(margin, m)    score-gap early exit [Culpepper et al. 2016]
                              (the existing ``CutoffStage``).
  Fuse(children, weights, k)  linear score interpolation of several scorers
                              run over the SAME input candidates:
                              ``score = sum(w_i * child_i.score)``.

Combinators:

  a >> b    compose: feed a's candidates into b (flattens nested pipelines).
  a | b     equal-weight linear fusion of two scoring ops (Rerank/Fuse);
            chaining ``a | b | c`` keeps the weights uniform. For custom
            weights build ``Fuse((a, b), (0.7, 0.3))`` directly.
  p % k     rank-cutoff sugar: ``p >> Cutoff(k)``.

``normalize`` applies plan-independent algebraic rewrites (adjacent-cutoff
merging, folding a Cutoff into the preceding Rerank/Fuse ``k``) so every
executor lowers the same simplified tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["Op", "Retrieve", "Rerank", "Cutoff", "DynamicCutoff", "Fuse",
           "Pipeline", "normalize"]


def _steps(op: "Op") -> Tuple["Op", ...]:
    return op.steps if isinstance(op, Pipeline) else (op,)


@dataclasses.dataclass(frozen=True, eq=False)
class Op:
    """Base of every pipeline operator: a pure, immutable description.

    ``eq`` is disabled because leaves may hold arbitrary payloads (a
    ``BM25Index`` of numpy arrays, a ``Scorer``) whose ``==`` is not
    boolean; compare pipelines structurally via ``repr``.
    """

    def __rshift__(self, other: "Op") -> "Pipeline":
        if not isinstance(other, Op):
            return NotImplemented
        return Pipeline(_steps(self) + _steps(other))

    def __or__(self, other: "Op") -> "Fuse":
        if not isinstance(other, Op):
            return NotImplemented
        for side in (self, other):
            if not isinstance(side, (Rerank, Fuse)):
                raise TypeError(f"| fuses scoring ops (Rerank/Fuse), "
                                f"got {type(side).__name__}")
        if (isinstance(self, Fuse) and self.k is None
                and len(set(self.weights)) == 1):
            kids = self.children + (other,)   # a | b | c stays uniform
            return Fuse(kids, (1.0 / len(kids),) * len(kids))
        return Fuse((self, other), (0.5, 0.5))

    def __mod__(self, k: int) -> "Pipeline":
        return self >> Cutoff(int(k))


@dataclasses.dataclass(frozen=True, eq=False)
class Retrieve(Op):
    index: Any = "default"
    h: int = 20

    def __repr__(self) -> str:
        idx = (f"{self.index!r}, " if isinstance(self.index, str)
               and self.index != "default" else "")
        return f"Retrieve({idx}h={self.h})"


@dataclasses.dataclass(frozen=True, eq=False)
class Rerank(Op):
    scorer: Any = "jit"
    k: Optional[int] = None

    def __repr__(self) -> str:
        spec = self.scorer if isinstance(self.scorer, str) else getattr(
            self.scorer, "name", type(self.scorer).__name__)
        tail = f", k={self.k}" if self.k is not None else ""
        return f"Rerank({spec!r}{tail})"


@dataclasses.dataclass(frozen=True, eq=False)
class Cutoff(Op):
    k: int

    def __repr__(self) -> str:
        return f"Cutoff({self.k})"


@dataclasses.dataclass(frozen=True, eq=False)
class DynamicCutoff(Op):
    margin: float = 2.0
    min_keep: int = 4

    def __repr__(self) -> str:
        return f"DynamicCutoff(margin={self.margin}, min_keep={self.min_keep})"


@dataclasses.dataclass(frozen=True, eq=False)
class Fuse(Op):
    """Linear fusion: every child scores the same input candidates; the
    output carries the weighted sum of the children's scores. Children must
    not truncate (``Rerank.k`` is rejected — interpolation needs every
    child's score for every candidate); apply ``% k`` after the fusion,
    which ``normalize`` folds into ``Fuse.k``."""

    children: Tuple[Op, ...]
    weights: Tuple[float, ...]
    k: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))
        object.__setattr__(self, "weights",
                           tuple(float(w) for w in self.weights))
        if len(self.children) != len(self.weights):
            raise ValueError(f"{len(self.children)} children but "
                             f"{len(self.weights)} weights")
        if len(self.children) < 2:
            raise ValueError("Fuse needs at least two children")
        for c in self.children:
            if not isinstance(c, (Rerank, Fuse)):
                raise TypeError(f"Fuse child must be a scoring op, "
                                f"got {type(c).__name__}")
            if isinstance(c, Rerank) and c.k is not None:
                raise ValueError(
                    "Rerank inside Fuse must not truncate (k must be None); "
                    "cut after the fusion: (a | b) % k")

    def __repr__(self) -> str:
        if len(set(self.weights)) == 1:
            body = "(" + " | ".join(repr(c) for c in self.children) + ")"
        else:
            body = (f"Fuse(({', '.join(repr(c) for c in self.children)}), "
                    f"weights={self.weights})")
        return body + (f" % {self.k}" if self.k is not None else "")


@dataclasses.dataclass(frozen=True, eq=False)
class Pipeline(Op):
    """A composed sequence of ops — what ``>>`` builds."""

    steps: Tuple[Op, ...]

    def __post_init__(self):
        flat = []
        for s in self.steps:
            flat.extend(_steps(s))
        object.__setattr__(self, "steps", tuple(flat))

    def __repr__(self) -> str:
        return " >> ".join(repr(s) for s in self.steps)


def normalize(p: Op) -> Pipeline:
    """Algebraic simplification applied before lowering (pure, tree-level):

      Cutoff(a) >> Cutoff(b)          -> Cutoff(min(a, b))
      Rerank(s) >> Cutoff(b)          -> Rerank(s, k=b)   (rerank sorts, so
      Rerank(s, k=a) >> Cutoff(b)     -> Rerank(s, k=min(a, b))  truncation
      Fuse(...) >> Cutoff(b)          -> Fuse(..., k=...)        commutes)

    Always returns a ``Pipeline`` (a single op is wrapped)."""
    out: list = []
    for step in _steps(p):
        if isinstance(step, Cutoff) and out:
            prev = out[-1]
            if isinstance(prev, Cutoff):
                out[-1] = Cutoff(min(prev.k, step.k))
                continue
            if isinstance(prev, Rerank):
                k = step.k if prev.k is None else min(prev.k, step.k)
                out[-1] = Rerank(prev.scorer, k)
                continue
            if isinstance(prev, Fuse):
                k = step.k if prev.k is None else min(prev.k, step.k)
                out[-1] = Fuse(prev.children, prev.weights, k)
                continue
        out.append(step)
    return Pipeline(tuple(out))
