"""Integration backends — the paper's strategies as ``Scorer``s.

  eager  : the model's plain PyTorch ops,        ~ PyTorch eager feedforward
           one dispatch at a time
  jit    : torch.compile (inductor), weights      ~ framework-optimized serving
           as runtime arguments; a bucket
           compiles on its first call
  aot    : weights frozen as constants, every     ~ 'compile the network into
           bucket compiled at build; on the card     a C++ binary'
           one CUDA graph a bucket, replayed
  numpy  : export -> pure-NumPy evaluator         ~ Deeplearning4J import
  pallas : both conv arms on the hand-written     ~ hand-optimized Blaze/BLAS
           CUDA conv kernel (``kernels/ops.
           sm_cnn_score``; the name is the JAX
           package's)
  artifact: one torch.export program a bucket,    ~ the shipped single binary
           serialized into one blob

All backends expose ``score(q_tok, a_tok, feats) -> np.ndarray`` over numpy
inputs: token rows ``(B, max_len)`` int, features ``(B, 4)`` float32. The
rows go to the scorer's device as int32 and float32, the scores come back
to the host. ``jit`` and ``aot`` compile with ``fullgraph=True``: a graph
break, or a bucket past dynamo's recompile limit, raises instead of running
the plain model.
"""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TextPairConfig
from repro_torch.core import compiled_artifact, export as export_lib, numpy_eval
from repro_torch.models import sm_cnn
from repro_torch.serving import telemetry

BACKENDS = ("eager", "jit", "aot", "numpy", "pallas", "artifact")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class ProgramStats:
    """What a compiled backend (``jit``, ``aot``) did: ``compiles`` counts
    the programs inductor compiled for it, ``replays`` the CUDA graphs
    ``aot`` replayed on the card, and ``inputs`` holds the number of inputs
    of each graph inductor lowered: the three row tensors alone where the
    weights were frozen into constants, three plus the weights where they
    are arguments. (A ``jit`` program served from AOTAutograd's cache is
    lowered again by no one and adds no entry; ``freezing`` bypasses that
    cache, so every ``aot`` program adds one.)"""

    compiles: int = 0
    replays: int = 0
    inputs: List[int] = dataclasses.field(default_factory=list)


class Scorer:
    """Uniform scoring interface over any integration backend.

    ``calls`` counts the batches handed to the backend (after padding to a
    bucket and chunking past the top bucket); ``programs`` is the
    ``ProgramStats`` of a compiled backend, else None."""

    def __init__(self, fn: Callable, buckets: Sequence[int], name: str,
                 programs: Optional[ProgramStats] = None):
        self._fn = fn
        self._buckets = tuple(buckets)
        self.name = name
        self.calls = 0
        self.programs = programs

    def __call__(self, q_tok, a_tok, feats) -> np.ndarray:
        n = q_tok.shape[0]
        cap = self._buckets[-1]
        if n > cap:  # coalesced cross-query batches: chunk to the top bucket
            return np.concatenate(
                [self(q_tok[i:i + cap], a_tok[i:i + cap], feats[i:i + cap])
                 for i in range(0, n, cap)])
        b = _bucket(n, self._buckets)
        if b != n:  # pad to the bucket: a fixed set of shapes reaches the card
            pad = b - n
            q_tok = np.concatenate([q_tok, np.zeros((pad,) + q_tok.shape[1:], q_tok.dtype)])
            a_tok = np.concatenate([a_tok, np.zeros((pad,) + a_tok.shape[1:], a_tok.dtype)])
            feats = np.concatenate([feats, np.zeros((pad,) + feats.shape[1:], feats.dtype)])
        tracer = telemetry.get_tracer()
        self.calls += 1
        # Only open a kernel-side span when this call is already inside a
        # request trace; untraced benchmark loops should not flood the ring
        # with roots. The copy of the scores to the host waits for the card,
        # so the time covers the device work.
        if tracer.current_context() is not None:
            with tracer.span("scorer", backend=self.name, rows=n, bucket=b):
                t0 = time.perf_counter()
                out = self._fn(q_tok, a_tok, feats)
                dt_ms = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            out = self._fn(q_tok, a_tok, feats)
            dt_ms = (time.perf_counter() - t0) * 1e3
        telemetry.get_registry().observe("scorer_batch_ms", dt_ms,
                                         backend=self.name, bucket=b)
        return out[:n]


def _rows(q, a, f, dev: torch.device):
    """numpy rows as int32 tokens and float32 features on ``dev``."""
    return (torch.from_numpy(np.ascontiguousarray(q, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(dev))


def _zero_rows(b: int, cfg: TextPairConfig, dev: torch.device):
    """A bucket's rows of zeros on ``dev``: the example (and, for graphs,
    the static) inputs of the programs built ahead of any call."""
    return (torch.zeros((b, cfg.max_len), dtype=torch.int32, device=dev),
            torch.zeros((b, cfg.max_len), dtype=torch.int32, device=dev),
            torch.zeros((b, cfg.n_extra_feats), dtype=torch.float32, device=dev))


def _on_device(model_fn: Callable, dev: torch.device) -> Callable:
    """numpy rows in, numpy scores out; ``model_fn(q, a, f)`` runs on
    ``dev``."""
    def fn(q, a, f) -> np.ndarray:
        with torch.inference_mode():
            return model_fn(*_rows(q, a, f, dev)).float().cpu().numpy()
    return fn


def _own_code(fn: Callable) -> Callable:
    """``fn`` with a code object of its own. Dynamo keeps compiled programs,
    and counts them against its recompile limit, per code object, so each
    scorer holds only its own buckets' programs."""
    return types.FunctionType(fn.__code__.replace(), fn.__globals__,
                              fn.__name__, fn.__defaults__, fn.__closure__)


def _inductor(stats: ProgramStats) -> Callable:
    """torch.compile's inductor backend, counting what it compiles and the
    inputs of each graph it lowers (after freezing folded any weights)."""
    def backend(gm, example_inputs):
        from torch._inductor.compile_fx import compile_fx, compile_fx_inner

        def lower(graph, inputs, **kwargs):
            stats.inputs.append(sum(n.op == "placeholder" for n in graph.graph.nodes))
            return compile_fx_inner(graph, inputs, **kwargs)
        stats.compiles += 1
        return compile_fx(gm, example_inputs, inner_compile=lower)
    return backend


def _compile(fn: Callable, stats: ProgramStats, buckets: Sequence[int]):
    limit = torch._dynamo.config.recompile_limit
    if len(buckets) > limit:
        raise ValueError(f"{len(buckets)} buckets need {len(buckets)} compiled "
                         f"programs, past dynamo's recompile_limit of {limit}")
    return torch.compile(_own_code(fn), fullgraph=True, dynamic=False,
                         backend=_inductor(stats))


def _jit(p: Dict, cfg: TextPairConfig, buckets: Sequence[int],
         dev: torch.device, stats: ProgramStats) -> Callable:
    """The plain ``sm_cnn.score`` compiled, the weights passed on every
    call; a bucket compiles on its first call. A first call that compiled
    nothing ran the plain function and raises. ``fullgraph=True`` turns a
    graph break or a recompile-limit hit into an error; whether it also
    refuses to run with dynamo disabled (``torch._dynamo.config.disable``,
    ``TORCHDYNAMO_DISABLE=1``) depends on the torch release (2.13 raises
    "found no compiled frames"), so this check does not lean on it."""
    program = _compile(sm_cnn.score, stats, buckets)
    compiled = set()

    def run(q, a, f):
        before = stats.compiles
        out = program(p, q, a, f, cfg)
        if q.shape[0] not in compiled:
            if stats.compiles == before:
                raise RuntimeError(f"jit: bucket {q.shape[0]} ran without a "
                                   f"compiled program")
            compiled.add(q.shape[0])
        return out
    return _on_device(run, dev)


def _capture(program: Callable, args) -> tuple:
    """One CUDA graph of ``program(*args)``: a warm-up on a side stream
    (which compiles), then the capture into the graph's own memory pool.
    Returns ``(graph, output)``; both live as long as the scorer."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            program(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = program(*args)
    return graph, out


def _as_parameters(tree):
    """The tree with ``nn.Parameter`` leaves: inductor's freezing folds
    parameters, and only those, into the program as constants."""
    if isinstance(tree, dict):
        return {k: _as_parameters(v) for k, v in tree.items()}
    return torch.nn.Parameter(tree, requires_grad=False)


def _aot(p: Dict, cfg: TextPairConfig, buckets: Sequence[int],
         dev: torch.device, stats: ProgramStats) -> Callable:
    """The weights frozen as constants of one program a bucket, every bucket
    compiled here, ahead of any call. On the card each bucket's call copies
    the rows into its graph's static inputs, replays the graph captured
    here and copies the scores out; on the CPU, where there are no graphs,
    the same programs run directly. A build that compiled fewer programs
    than buckets (dynamo disabled), or a program that still takes the
    weights as inputs (freezing did not fold them), raises."""
    from torch._inductor import config as inductor_config

    frozen = _as_parameters(p)
    program = _compile(lambda q, a, f: sm_cnn.score(frozen, q, a, f, cfg),
                       stats, buckets)
    slots = {}
    with torch.inference_mode(), inductor_config.patch(freezing=True):
        for b in buckets:
            args = _zero_rows(b, cfg, dev)
            if dev.type == "cuda":
                slots[b] = (args,) + _capture(program, args)
            else:
                program(*args)
    if stats.compiles != len(buckets) or stats.inputs != [3] * len(buckets):
        raise RuntimeError(f"aot: {stats.compiles} programs for {len(buckets)} "
                           f"buckets, with {stats.inputs} inputs (want 3 each: "
                           f"the rows, the weights frozen into constants)")
    if dev.type != "cuda":
        return _on_device(program, dev)

    def replay(q, a, f) -> np.ndarray:
        (qs, as_, fs), graph, out = slots[q.shape[0]]
        with torch.inference_mode():
            qs.copy_(torch.from_numpy(np.ascontiguousarray(q, np.int32)))
            as_.copy_(torch.from_numpy(np.ascontiguousarray(a, np.int32)))
            fs.copy_(torch.from_numpy(np.ascontiguousarray(f, np.float32)))
            graph.replay()
            stats.replays += 1
            return out.float().cpu().numpy()
    return replay


def make_scorer(backend: str, params: Dict, cfg: TextPairConfig,
                buckets: Sequence[int] = (1, 8, 64, 256),
                device="cuda") -> Scorer:
    """A ``Scorer`` for ``backend`` over ``params`` (the JAX parameter tree
    as numpy arrays, or the port's tensors), running on ``device``.
    ``numpy`` evaluates on the host and does not use ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "numpy":
        blob = export_lib.dumps(params, model=cfg.name,
                                meta={"filter_width": cfg.filter_width})
        ev = numpy_eval.NumpySMCNN.from_bytes(blob)
        return Scorer(lambda q, a, f: ev.get_score(np.asarray(q), np.asarray(a),
                                                   np.asarray(f)), buckets, backend)
    dev = resolve_device(device)
    p = sm_cnn.params_from_numpy(params, dev)
    if backend == "eager":
        return Scorer(_on_device(lambda q, a, f: sm_cnn.score(p, q, a, f, cfg), dev),
                      buckets, backend)
    if backend == "pallas":
        from repro_torch.kernels import ops as kops
        return Scorer(_on_device(lambda q, a, f: kops.sm_cnn_score(p, q, a, f, cfg), dev),
                      buckets, backend)
    if backend in ("jit", "aot"):
        stats = ProgramStats()
        build = _jit if backend == "jit" else _aot
        return Scorer(build(p, cfg, buckets, dev, stats), buckets, backend, stats)
    # artifact: weights closed over as constants, one exported program a bucket
    shapes = {f"b{b}": _zero_rows(b, cfg, dev) for b in buckets}
    blob = compiled_artifact.build_artifact(
        lambda q, a, f: sm_cnn.score(p, q, a, f, cfg), shapes,
        meta={"model": cfg.name})
    art = compiled_artifact.CompiledArtifact.from_bytes(blob, dev)
    return Scorer(_on_device(lambda q, a, f: art.call(f"b{q.shape[0]}", q, a, f), dev),
                  buckets, backend)
