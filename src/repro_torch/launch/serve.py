"""Serving launcher: stand up the QA reranking service on any backend.

  # paper-faithful single-threaded server (on the CUDA card; add
  # --device cpu to run on the CPU)
  PYTHONPATH=src python -m repro_torch.launch.serve --backend pallas --port 9090

  # concurrent cluster: 4 replicas behind a thread-pool server with
  # power-of-two-choices routing and a bounded admission queue
  PYTHONPATH=src python -m repro_torch.launch.serve --server threadpool \
      --replicas 4 --policy p2c --max-queue 256 --port 9090

  # print how the canonical ranking pipeline lowers to each execution plan
  PYTHONPATH=src python -m repro_torch.launch.serve --describe

  # multi-process fabric: 4 pipeline-serving worker processes behind a
  # health-probed hedging router (serving.fabric), supervised until ^C
  PYTHONPATH=src python -m repro_torch.launch.serve --fabric 4 --backend numpy

  # ask a running server to drain gracefully (finish in-flight, shed new)
  PYTHONPATH=src python -m repro_torch.launch.serve --drain 127.0.0.1:9090

  # version-bound serving from a model registry (core.registry), with
  # live hot-swap / shadow / A-B (serving.rollout; see docs/rollout.md):
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-pipeline \
      --registry /tmp/registry --model-version latest --port 9090
  PYTHONPATH=src python -m repro_torch.launch.serve --swap v-0123abcd --port 9090
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-pipeline \
      --registry /tmp/registry --shadow v-0123abcd --shadow-fraction 0.2
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-pipeline \
      --registry /tmp/registry --ab v-0123abcd:25

  # serve the WHOLE multi-stage pipeline behind one RPC (wire v3
  # MSG_RANK / MSG_RANK_BATCH; drive with Client.rank / rank_batch or a
  # plan(pipeline, "remote_pipeline", ctx) on the client side)
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-pipeline \
      --server threadpool --backend jit --port 9090

  (then drive it with repro_torch.core.service.Client, or with a client
  of either package: the wire frames are the JAX package's; --hedge-ms
  sets the fixed hedge delay
  clients of THIS process's plans use when ctx.remote lists several
  endpoints — 0 keeps the adaptive p95 delay)

Single-server scorer construction routes through the declarative pipeline
API's ``PlanContext`` (repro_torch.core.plan), the same factory the planner and
examples use; replica pools still build one independent scorer per replica
(``ReplicaPool.build``) so replicas don't share compiled-function state.

Everything runs on ``--device`` (default ``cuda``): the world trains there,
BM25 and the scorers run there, and fabric workers get the same flag.
Without a card the launcher raises unless it is given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.world import build_world
from repro_torch.core import backends as BK
from repro_torch.core import ops
from repro_torch.core import service as SV
from repro_torch.core.plan import PlanContext, plan
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.cluster import POLICIES, ReplicaPool


def canonical_pipeline(backend: str):
    """The demo cascade every launcher entry point serves/describes."""
    return (ops.Retrieve(h=10) >> ops.DynamicCutoff(margin=3.0)
            >> ops.Rerank(backend, k=3))


def _wrap_rollout(args, engine, ctx, target: str):
    """Wrap the primary engine in shadow / A-B layers (serving.rollout)
    when requested. Candidate arms are full ``PipelineEngine``s planned
    against a version-rebound context, so they never share compiled
    scorers with the primary."""
    shadow = getattr(args, "shadow", None)
    ab = getattr(args, "ab", None)
    if not shadow and not ab:
        return engine
    if target == "remote":
        raise SystemExit("--shadow/--ab need an in-process candidate plan; "
                         "use --plan-target local|batched (the remote "
                         "target's ReplicaPool would be shared by both "
                         "versions)")
    from repro_torch.serving.engine import PipelineEngine
    from repro_torch.serving.rollout import ABEngine, ShadowEngine
    if ab:
        version, _, pct = ab.partition(":")
        arm_b = PipelineEngine(canonical_pipeline(args.backend),
                               ctx.bind_version(version), target=target)
        engine = ABEngine(engine, arm_b,
                          split_pct=float(pct) if pct else 50.0)
    if shadow:
        candidate = PipelineEngine(canonical_pipeline(args.backend),
                                   ctx.bind_version(shadow), target=target)
        engine = ShadowEngine(engine, candidate,
                              fraction=getattr(args, "shadow_fraction",
                                               0.2))
    return engine


def build_server(args, cfg, params, corpus, tok, index=None, ctx=None):
    """Build (server, pool-or-None) from parsed CLI args."""
    if ctx is None:
        registry = None
        if getattr(args, "registry", None):
            from repro_torch.core.registry import ModelRegistry
            registry = ModelRegistry(args.registry)
        model_version = getattr(args, "model_version", None)
        if model_version and registry is None:
            raise SystemExit("--model-version needs --registry DIR")
        ctx = PlanContext.from_world(cfg, params, corpus, tok, index=index,
                                     buckets=(1, 8, 64, 256),
                                     hedge_ms=getattr(args, "hedge_ms",
                                                      None),
                                     registry=registry,
                                     model_version=model_version,
                                     device=getattr(args, "device", "cuda"))
    if getattr(args, "serve_pipeline", False):
        # Whole-pipeline ranking service (wire v3): the handler lowers the
        # canonical pipeline server-side and answers MSG_RANK_BATCH with
        # ranked lists — one RPC per query batch instead of pair scoring.
        from repro_torch.serving.engine import PipelineEngine
        target = getattr(args, "plan_target", "batched")
        pool = None
        if target == "remote":
            # Rerank stages dispatch through an in-process ReplicaPool
            # (MicroBatcher + replica scorers) instead of calling the
            # scorer inline — so each worker process exercises, and
            # reports telemetry for, the full admission -> batcher ->
            # scorer path (queue-wait vs compute histograms per worker).
            import dataclasses as _dc
            # ctx.params, not the raw build_world params: a --model-version
            # bind already resolved registry weights into the context.
            pool = ReplicaPool.build(args.backend, ctx.params, cfg, tok,
                                     corpus.idf, n_replicas=args.replicas,
                                     buckets=ctx.buckets or (1, 8, 64, 256),
                                     device=ctx.device, policy=args.policy)
            pool.model_version = getattr(ctx, "model_version", None)
            ctx = _dc.replace(ctx, remote=pool)
        engine = PipelineEngine(canonical_pipeline(args.backend), ctx,
                                target=target)
        engine = _wrap_rollout(args, engine, ctx, target)
        if args.server == "simple":
            return SV.SimpleServer(engine, host=args.host,
                                   port=args.port), pool
        # Ranking requests are sized at len(queries) x rows_per_query, so
        # the bound must cover a realistic query batch (one plan.run_many
        # is ONE RPC) — auto-raise to a 32-query batch; clients driving
        # bigger batches chunk with PlanContext.rank_chunk.
        admission = (AdmissionController(max_queue_rows=max(
                         args.max_queue, engine.rows_per_query * 32))
                     if args.max_queue > 0 else None)
        return SV.ThreadPoolServer(engine, host=args.host, port=args.port,
                                   num_workers=args.workers,
                                   admission=admission), pool
    if args.server == "simple":
        scorer = ctx.scorer_for(args.backend)
        handler = SV.QuestionAnsweringHandler(scorer, tok, corpus.idf,
                                              cfg.max_len)
        return SV.SimpleServer(handler, host=args.host, port=args.port), None
    pool = ReplicaPool.build(args.backend, params, cfg, tok, corpus.idf,
                             n_replicas=args.replicas,
                             buckets=ctx.buckets or (1, 8, 64, 256),
                             device=ctx.device, policy=args.policy)
    admission = (AdmissionController(max_queue_rows=args.max_queue)
                 if args.max_queue > 0 else None)
    srv = SV.ThreadPoolServer(pool, host=args.host, port=args.port,
                              num_workers=args.workers, admission=admission)
    return srv, pool


class _Unconnected:
    """Placeholder remote endpoint: lowers but refuses to score."""

    def get_score_batch(self, pairs):
        raise RuntimeError("no server connected (--describe only lowers)")

    def rank_batch(self, queries):
        raise RuntimeError("no server connected (--describe only lowers)")


def describe_plans(args, cfg, params, corpus, tok, index) -> str:
    """The canonical pipeline, lowered to every execution target."""
    pipeline = canonical_pipeline(args.backend)
    ctx = PlanContext.from_world(cfg, params, corpus, tok, index,
                                 remote=_Unconnected(),
                                 hedge_ms=getattr(args, "hedge_ms", None),
                                 device=getattr(args, "device", "cuda"))
    lines = [f"pipeline: {pipeline!r}"]
    for target in ("local", "batched", "remote", "remote_pipeline"):
        lines.append("  " + plan(pipeline, target, ctx).describe())
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="aot", choices=BK.BACKENDS)
    ap.add_argument("--device", default="cuda",
                    help="where the world trains and the scorers run: cuda "
                         "(the default; raises without a card) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--server", default="simple",
                    choices=["simple", "threadpool"],
                    help="simple = paper's TSimpleServer; threadpool = "
                         "concurrent worker pool over a replica cluster")
    ap.add_argument("--replicas", type=int, default=2,
                    help="scorer replicas behind the threadpool server")
    ap.add_argument("--policy", default="least_outstanding",
                    choices=list(POLICIES), help="replica routing policy")
    ap.add_argument("--max-queue", type=int, default=512,
                    help="admission bound on outstanding rows "
                         "(0 disables admission control)")
    ap.add_argument("--workers", type=int, default=8,
                    help="threadpool connection workers")
    ap.add_argument("--describe", action="store_true",
                    help="print the canonical pipeline lowered to every "
                         "execution plan, then exit")
    ap.add_argument("--serve-pipeline", action="store_true",
                    help="serve the WHOLE canonical multi-stage pipeline "
                         "behind wire v3 ranking RPCs (MSG_RANK / "
                         "MSG_RANK_BATCH) instead of pair scoring")
    ap.add_argument("--plan-target", default="batched",
                    choices=["local", "batched", "remote"],
                    help="execution plan for --serve-pipeline; 'remote' "
                         "routes rerank through an in-process ReplicaPool "
                         "(MicroBatcher + replicas), so this process "
                         "reports batcher queue-wait/compute telemetry")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="on shutdown, export this process's finished "
                         "spans as Chrome trace-event JSON (load in "
                         "Perfetto / chrome://tracing)")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="fixed hedge delay (ms) for plans whose "
                         "ctx.remote lists several endpoints; default "
                         "adapts to the observed p95")
    ap.add_argument("--fabric", type=int, default=0, metavar="N",
                    help="spawn N pipeline-serving worker PROCESSES "
                         "behind a health-probed hedging router "
                         "(serving.fabric) and supervise until ^C")
    ap.add_argument("--drain", default=None, metavar="HOST:PORT",
                    help="send MSG_DRAIN to a running server (finish "
                         "in-flight, shed new work), print its health "
                         "snapshot, and exit")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="model registry directory (core.registry): "
                         "enables --model-version binding and live "
                         "MSG_SWAP hot-swaps on this server")
    ap.add_argument("--model-version", default=None, metavar="VID",
                    help="serve this registry version ('latest', a full "
                         "id, or a unique prefix) instead of the "
                         "freshly-trained params; needs --registry")
    ap.add_argument("--swap", default=None, metavar="VERSION",
                    help="client command: hot-swap a RUNNING server "
                         "(--host/--port) to this registry version over "
                         "MSG_SWAP, print the reply, and exit")
    ap.add_argument("--shadow", default=None, metavar="VERSION",
                    help="mirror a sampled fraction of ranking traffic "
                         "to this registry version and record divergence "
                         "metrics; candidate rankings are discarded "
                         "(needs --serve-pipeline + --registry)")
    ap.add_argument("--shadow-fraction", type=float, default=0.2,
                    help="fraction of distinct queries mirrored by "
                         "--shadow (deterministic hash sampling)")
    ap.add_argument("--ab", default=None, metavar="VERSION[:PCT]",
                    help="A/B split: route PCT%% (default 50) of the "
                         "query hash space to this registry version; "
                         "per-arm metrics carry model_version labels "
                         "(needs --serve-pipeline + --registry)")
    args = ap.parse_args(argv)

    if args.swap:
        if args.port == 0:
            raise SystemExit("--swap is a client command: point it at a "
                             "running server with --host/--port")
        with SV.Client((args.host, args.port)) as client:
            vid, status = client.swap(args.swap)
        print(f"swap acknowledged: version={vid} status={status}")
        return

    if args.drain:
        host, _, port = args.drain.rpartition(":")
        with SV.Client((host or "127.0.0.1", int(port))) as client:
            snap = client.drain()
        print("drain acknowledged: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(snap.items())))
        return
    if args.fabric > 0:
        # The supervisor builds no world of its own — each worker process
        # trains/compiles independently (that is the point of the fabric).
        from repro_torch.serving.fabric import Fabric
        extra = []
        if args.plan_target != "batched":
            extra += ["--plan-target", args.plan_target]
        if args.registry:
            extra += ["--registry", args.registry]
        if args.model_version:
            extra += ["--model-version", args.model_version]
        with Fabric(n_workers=args.fabric, backend=args.backend,
                    train_steps=args.train_steps, server="threadpool",
                    worker_threads=args.workers,
                    max_queue=args.max_queue, extra_args=extra,
                    device=args.device) as fab:
            for w in fab.workers:
                print(f"fabric worker {w.slot} (pid {w.proc.pid}) "
                      f"on {w.address}")
            print(f"fabric up: {args.fabric} workers, router probing "
                  f"health; ^C to tear down", flush=True)
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
        return

    cfg, params, corpus, tok, index, _ = build_world(args.train_steps,
                                                     device=args.device)
    if args.describe:
        print(describe_plans(args, cfg, params, corpus, tok, index))
        return
    srv, pool = build_server(args, cfg, params, corpus, tok, index=index)
    mode = (f"{args.server}" if args.server == "simple" else
            f"{args.server} x{args.replicas} {args.policy} "
            f"max_queue={args.max_queue}")
    if args.serve_pipeline:
        mode += " serve-pipeline(rank-rpc)"
    print(f"serving QuestionAnswering ({args.backend}, {mode}) "
          f"on {srv.address}")
    # Machine-readable discovery line for the fabric supervisor: workers
    # bind port 0, so this flushed line is how serving.fabric learns the
    # address (stdout is a PIPE there — without flush=True the line sits
    # in the child's block buffer and the supervisor times out waiting).
    host, port = srv.address[0], srv.address[1]
    print(f"FABRIC_READY {host} {port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
        if pool is not None:
            pool.stop()
        if args.trace_out:
            from repro_torch.serving import telemetry
            n = telemetry.export_chrome_trace(
                args.trace_out, telemetry.get_tracer().finished())
            print(f"wrote {n} trace events to {args.trace_out}")


if __name__ == "__main__":
    main()
