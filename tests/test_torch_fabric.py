"""The port's multi-process serving fabric (``serving/fabric.py``), mirrored
from ``tests/test_fabric.py`` on the CPU: worker spawn and discovery,
health-probed routing, drain and restart, crash respawn, plan binding
through the router, traces across processes, MSG_STATS, and a rolling
hot-swap from ``tests/test_rollout.py``.

One module-scoped fabric of 2 worker processes serves every test that
needs one: ``python -m repro_torch.launch.serve --device cpu --backend
numpy --train-steps 1 --plan-target remote`` bound to one registry version,
``OMP_NUM_THREADS=1`` in the workers' environment. A worker trains its own
world and serves the registry's weights, so its rankings are those of the
in-process ``remote_pipeline`` plan over a ``PipelineEngine`` on that
version. None of ``tests/test_fabric.py``'s assertions on timing or on
where the router happened to send traffic is copied: where the JAX test
counted on the router spreading requests over both workers, this one
sends to each worker's own client. Every spawn has ``spawn_timeout_s``,
every join, read and wait a bound."""
import json
import os
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core.plan import PlanContext, plan
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.treepath import tree_map
from repro_torch.launch import serve
from repro_torch.launch.world import build_world
from repro_torch.serving import telemetry
from repro_torch.serving import fabric as FB
from repro_torch.serving.engine import PipelineEngine
from repro_torch.serving.fabric import Fabric, FabricWorker, HealthRouter

torch.set_num_threads(2)

WAIT_S = 30.0
SPAWN_S = 60.0
QUERIES = [f"fleet question number {i}" for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _bounded_sockets():
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(WAIT_S)
    yield
    socket.setdefaulttimeout(old)


@pytest.fixture(scope="module")
def served(_bounded_sockets, tmp_path_factory):
    """The launcher's world on the CPU, two of its versions in a registry,
    and a 2-worker fabric serving the first."""
    cfg, params, corpus, tok, index, _ = build_world(train_steps=1, device="cpu")
    reg_dir = str(tmp_path_factory.mktemp("registry"))
    reg = ModelRegistry(reg_dir)
    va = reg.publish(params, model=cfg.name).version_id
    vb = reg.publish(tree_map(lambda t: t * 1.5, params), model=cfg.name).version_id
    fab = Fabric(n_workers=2, backend="numpy", train_steps=1, device="cpu",
                 spawn_timeout_s=SPAWN_S, probe_interval_s=0.05,
                 extra_args=("--plan-target", "remote", "--registry", reg_dir,
                             "--model-version", va))
    # workers (and the ones restarted or respawned) inherit the environment
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with fab:
            yield types.SimpleNamespace(fab=fab, cfg=cfg, params=params,
                                        corpus=corpus, tok=tok, index=index,
                                        reg=reg, va=va, vb=vb)


def _engine(s, version):
    ctx = PlanContext.from_world(s.cfg, s.params, s.corpus, s.tok, s.index,
                                 buckets=(1, 8, 64, 256), registry=s.reg,
                                 model_version=version, device="cpu")
    return PipelineEngine(serve.canonical_pipeline("numpy"), ctx)


def _ids(rankings):
    return [[(d, s) for d, s, _ in r] for r in rankings]


def _wait_routable(fab, n, timeout_s=WAIT_S):
    deadline = time.time() + timeout_s
    while fab.router.stats()["routable_workers"] < n and time.time() < deadline:
        time.sleep(0.05)
    assert fab.router.stats()["routable_workers"] == n


# ------------------------------------------------------------------ smoke --

def test_fabric_smoke(served):
    """Spawn -> discover -> health-route -> rank -> stats, end to end."""
    fab = served.fab
    assert all(w.alive for w in fab.workers)
    snaps = fab.router.snapshot()
    assert set(snaps) == {0, 1}
    for snap in snaps.values():
        assert snap["draining"] == 0.0 and snap["rows_per_query"] > 0
    out = fab.router.rank_batch(["what is the capital", "who wrote the book"])
    assert len(out) == 2
    for ranking in out:
        doc, sent, score = ranking[0]
        assert isinstance(doc, int) and isinstance(score, float)
    s = fab.stats()
    assert s["alive_workers"] == 2.0 and s["router_routable_workers"] == 2.0


def test_every_worker_ranks_as_the_in_process_remote_pipeline_plan(served):
    """Each worker, asked on its own connection, and the router rank as
    ``plan(pipeline, "remote_pipeline")`` over an in-process engine on the
    same registry version."""
    local = _engine(served, served.va)
    ctx = PlanContext(tokenizer=served.tok, idf=served.corpus.idf,
                      max_len=served.cfg.max_len, documents=served.corpus.documents,
                      remote=local, device="cpu")
    pl = plan(serve.canonical_pipeline("numpy"), "remote_pipeline", ctx)
    queries = list(served.corpus.questions[:5])
    want = [[(c.doc_id, c.sent_id, c.score) for c in cands]
            for cands, _ in pl.run_many(queries)]
    for ep in served.fab.router._endpoints:
        assert ep.version() == (served.va, "active")
        got = ep.client.rank_batch(queries)
        assert _ids(got) == _ids(want)
        np.testing.assert_allclose([[x for _, _, x in r] for r in got],
                                   [[x for _, _, x in r] for r in want],
                                   rtol=1e-5, atol=1e-6)
    assert _ids(served.fab.router.rank_batch(queries)) == _ids(want)


def test_fabric_plan_binding(served):
    """``plan(pipeline, 'remote_pipeline', ctx)`` with ctx.remote = the
    fabric routes rankings through the HealthRouter."""
    ctx = PlanContext(tokenizer=served.tok, idf=served.corpus.idf,
                      max_len=served.cfg.max_len, documents=served.corpus.documents,
                      remote=served.fab, device="cpu")
    pl = plan(serve.canonical_pipeline("numpy"), "remote_pipeline", ctx)
    assert "hedged" in pl.describe()
    out = pl.run_many(list(served.corpus.questions[:3]))
    assert len(out) == 3 and all(len(r) > 0 for r in out)


def test_control_connection_takes_one_caller_at_a_time(served):
    """Probes, version reads and stats pulls from several threads at once
    on one worker's control connection each get their own reply (two RPCs
    interleaved on one socket would read each other's)."""
    ep = served.fab.router._endpoints[0]
    errors, done = [], []

    def hammer(i):
        try:
            for _ in range(20):
                if i % 3 == 0:
                    assert ep.version() == (served.va, "active")
                elif i % 3 == 1:
                    assert "inflight" in ep.probe()
                else:
                    assert ep.fetch_stats()[0]
            done.append(i)
        except Exception as e:  # noqa: BLE001 — counted, asserted
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()
    assert errors == [] and sorted(done) == list(range(6))


# -------------------------------------------------------------- telemetry --

def test_trace_crosses_process_boundary(served):
    """One query yields one trace whose span tree crosses the process
    boundary: the router's client span parents the worker's spans."""
    tr = telemetry.get_tracer()
    tr.clear()
    with tr.span("test.request") as root:
        assert served.fab.router.rank("follow this query across processes")
    trace_id = root.context.trace_id
    spans = served.fab.collect_spans(trace_id)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert "hedge.primary" in by_name
    client_ids = {s.span_id for s in by_name.get("client.rank", ())}
    assert client_ids
    here = os.getpid()
    servers = by_name.get("server.rank", [])
    assert servers and all(s.pid != here for s in servers)
    assert any(s.parent_id in client_ids for s in servers)
    for name in ("admission", "engine.rank_many", "pool.get_scores",
                 "batcher.queue_wait", "batcher.compute", "scorer"):
        assert name in by_name, name
        assert all(s.pid != here for s in by_name[name]), name
    roots, children = telemetry.span_tree(spans, trace_id=trace_id)
    assert [r.name for r in roots] == ["test.request"]

    def walk(span):
        yield span
        for kid in children.get(span.span_id, ()):
            yield from walk(kid)

    assert {"client.rank", "server.rank", "batcher.compute", "scorer"} <= \
        {s.name for s in walk(roots[0])}
    text = telemetry.format_span_tree(spans, trace_id=trace_id)
    assert text.splitlines()[0].startswith("test.request")


def test_msg_stats_per_worker_and_aggregate(served):
    """MSG_STATS returns each worker's registry snapshot with the batcher
    histograms; the fleet aggregate is their key-wise sum. Each worker is
    sent traffic on its own connection."""
    for ep in served.fab.router._endpoints:
        for i in range(2):
            assert ep.client.rank_batch([f"stats traffic {i}"])[0]
    per_worker = served.fab.worker_metrics()
    assert set(per_worker) == {0, 1}
    for slot, snap in per_worker.items():
        assert snap.get("batcher_queue_wait_ms_count", 0.0) > 0.0, slot
        assert snap.get("batcher_compute_ms_count", 0.0) > 0.0, slot
        assert any(k.startswith("batcher_queue_wait_ms_bucket{") for k in snap), slot
        assert snap.get("server_requests{type=rank}", 0.0) > 0.0, slot
    agg = served.fab.aggregate_metrics()
    assert agg["batcher_compute_ms_count"] == pytest.approx(
        sum(s["batcher_compute_ms_count"] for s in per_worker.values()))


def test_cross_process_chrome_trace_exports(served, tmp_path):
    tr = telemetry.get_tracer()
    tr.clear()
    with tr.span("test.export") as root:
        served.fab.router.rank_batch(["export this trace"])
    spans = served.fab.collect_spans(root.context.trace_id)
    path = tmp_path / "fabric_trace.json"
    n = telemetry.export_chrome_trace(str(path), spans)
    assert n == len(spans) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == n
    for ev in events:
        assert ev["ph"] == "X" and ev["ts"] > 0.0 and ev["dur"] >= 0.0
    pids = {ev["pid"] for ev in events}
    assert len(pids) >= 2 and os.getpid() in pids


# ------------------------------------------------------------ rolling swap --

def test_rolling_swap_and_per_version_aggregate(served):
    """One worker hot-swapped over MSG_SWAP while the fleet answers: no
    request fails, each worker reports its version, its rankings are the
    new version's, and the aggregate separates the versions by label;
    then it swaps back."""
    fab = served.fab
    errors = []
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                fab.router.rank_batch([QUERIES[0]])
            except Exception as e:  # noqa: BLE001 — counted, asserted
                errors.append(repr(e))

    t = threading.Thread(target=pump)
    t.start()
    try:
        reply = fab.swap_worker(1, served.vb, timeout_s=WAIT_S)
    finally:
        stop.set()
        t.join(WAIT_S)
    assert not t.is_alive()
    assert reply == (served.vb, "swapped") and errors == []
    eps = fab.router._endpoints
    assert eps[0].version() == (served.va, "active")
    assert eps[1].version() == (served.vb, "active")
    queries = list(served.corpus.questions[:3])
    assert _ids(eps[1].client.rank_batch(queries)) == \
        _ids(_engine(served, served.vb).rank_batch(queries))
    for ep in eps:
        ep.client.rank_batch(QUERIES)
    groups = telemetry.split_by_label(fab.aggregate_metrics(), "model_version")
    for vid in (served.va, served.vb):
        assert any(k.startswith("engine_rank_queries") for k in groups[vid])
    assert fab.swap_worker(1, served.va, timeout_s=WAIT_S) == (served.va, "swapped")


# ----------------------------------------------------- drain, restart, crash --

def test_router_routes_around_draining_worker(served):
    """After MSG_DRAIN a worker stops being routable; requests keep
    succeeding on the other; a restart brings it back."""
    fab = served.fab
    snap = fab.drain_worker(0, timeout_s=WAIT_S)
    assert snap["draining"] == 1.0 and snap["inflight"] == 0.0
    assert fab.router.stats()["routable_workers"] == 1.0
    for q in ("during drain one", "during drain two"):
        assert fab.router.rank_batch([q])[0]
    fab.restart_worker(0, timeout_s=WAIT_S)
    assert fab.router.stats()["routable_workers"] == 2.0
    assert fab.router.rank_batch(["after restart"])[0]


def test_crashed_worker_is_respawned_and_rejoins(served):
    fab = served.fab
    victim = fab.workers[1]
    first_pid = victim.proc.pid
    respawns = fab.respawns
    victim.proc.kill()                      # a hard crash, not expect_exit
    deadline = time.time() + SPAWN_S
    while fab.respawns == respawns and time.time() < deadline:
        time.sleep(0.05)
    assert fab.respawns == respawns + 1
    assert victim.alive and victim.proc.pid != first_pid
    _wait_routable(fab, 2)
    assert fab.router.rank_batch(["after respawn"])[0]


# ------------------------------------------------------------- unit-level --

def test_worker_command_shape():
    w = FabricWorker(3, backend="pallas", train_steps=7, workers=4, max_queue=128,
                     device="cuda")
    cmd = w.command()
    assert cmd[1:4] == ["-u", "-m", "repro_torch.launch.serve"]
    assert "--serve-pipeline" in cmd
    assert cmd[cmd.index("--backend") + 1] == "pallas"
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--train-steps") + 1] == "7"
    assert cmd[cmd.index("--port") + 1] == "0"
    assert FabricWorker(0).device == "cuda"


def test_src_root_is_the_ports_checkout():
    import repro_torch
    root = FB._src_root()
    assert os.path.isfile(os.path.join(root, "repro_torch", "__init__.py"))
    assert os.path.samefile(os.path.join(root, "repro_torch"),
                            os.path.dirname(repro_torch.__file__))


class _FakeEndpoint:
    def __init__(self, slot):
        self.slot = slot
        self.client = object()

    def close(self):
        pass


def test_health_router_prefers_less_loaded_worker():
    router = HealthRouter([_FakeEndpoint(0), _FakeEndpoint(1), _FakeEndpoint(2)])
    router._snaps = {
        0: {"queue_depth": 50.0, "inflight": 2.0, "draining": 0.0},
        1: {"queue_depth": 0.0, "inflight": 0.0, "draining": 0.0},
        2: {"queue_depth": 8.0, "inflight": 1.0, "draining": 0.0},
    }
    assert router._pick_endpoints() == (1, 2)
    router._snaps[1]["draining"] = 1.0
    assert router._pick_endpoints() == (2, 0)
    router._snaps[0]["draining"] = 1.0
    router._alive[2] = False
    primary, backup = router._pick_endpoints()
    assert primary in (0, 1, 2) and backup is not None


def test_health_router_spreads_ties_round_robin():
    router = HealthRouter([_FakeEndpoint(0), _FakeEndpoint(1)])
    router._snaps = {i: {"queue_depth": 0.0, "inflight": 0.0, "draining": 0.0}
                     for i in (0, 1)}
    assert {router._pick_endpoints()[0] for _ in range(4)} == {0, 1}


class _StubRestartWorker:
    """A FabricWorker stand-in whose wait_ready parks on an event."""

    def __init__(self, slot):
        self.slot = slot
        self.alive = False
        self.spawned = 0
        self.release = threading.Event()

    def spawn(self):
        self.spawned += 1
        self.alive = True

    def wait_ready(self, timeout_s):
        assert self.release.wait(WAIT_S), "test never released wait_ready"
        return ("127.0.0.1", 9000 + self.slot)


class _StubRouter:
    def __init__(self):
        self.replaced = []
        self.probes = 0

    def replace_endpoint(self, slot, ep):
        self.replaced.append((slot, ep))

    def probe_once(self):
        self.probes += 1


def test_respawn_claims_slot_then_works_outside_the_lock(monkeypatch):
    """A respawn claims its slot under Fabric._lock and does the slow part
    with the lock free; a second actor on the same slot backs off."""
    monkeypatch.setattr(FB, "WorkerEndpoint", lambda slot, addr: ("ep", slot, addr))
    fab = Fabric(n_workers=2, supervise=False, device="cpu")
    w0, w1 = _StubRestartWorker(0), _StubRestartWorker(1)
    fab.workers = [w0, w1]
    fab.router = _StubRouter()
    t = threading.Thread(target=fab._respawn, args=(w0,), daemon=True)
    t.start()
    deadline = time.time() + 5.0
    while w0.spawned == 0 and time.time() < deadline:
        time.sleep(0.001)
    assert w0.spawned == 1
    assert fab._lock.acquire(timeout=1.0), "_respawn holds Fabric._lock"
    fab._lock.release()
    assert not fab._claim_slot(0)
    assert fab._claim_slot(1)
    fab._release_slot(1)
    fab._respawn(w0)
    assert w0.spawned == 1
    with pytest.raises(RuntimeError, match="already restarting"):
        fab.restart_worker(0)
    w0.release.set()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert fab.respawns == 1
    assert fab.router.replaced == [(0, ("ep", 0, ("127.0.0.1", 9000)))]
    assert fab.router.probes == 1
    assert fab._claim_slot(0)
    fab._release_slot(0)
