"""Multi-process serving fabric: process-per-pipeline workers behind a
health-checked, hedging router.

The thread cluster (``serving.cluster``) caps at roughly one core because
featurization holds the GIL; the paper's own deployment answer — "expose
the neural network as a service" over Thrift — scales by running separate
*server processes*. ``Fabric`` reproduces that topology locally:

  Fabric        — supervisor. Spawns N ``python -m repro_torch.launch.serve
                  --serve-pipeline`` worker PROCESSES (each its own
                  interpreter, CUDA context, scorers and admission
                  controller, on ``device``), watches them, respawns
                  crashes, and drains workers gracefully for restarts.
  FabricWorker  — one worker process: the ``subprocess.Popen`` handle, a
                  stdout reader thread that captures the flushed
                  ``FABRIC_READY host port`` discovery line (workers bind
                  port 0), and a tail buffer for crash diagnostics.
  WorkerEndpoint— one worker's client bundle: a request connection plus a
                  separate control connection (``Client`` is strictly
                  one-RPC-at-a-time per socket, and health probes must not
                  queue behind a long rank call).
  HealthRouter  — ``HedgedTransport`` subclass whose endpoint choice is
                  driven by v4 MSG_HEALTH probes instead of round-robin:
                  a probe thread polls every worker's control connection,
                  and ``_pick_endpoints`` routes each request to the two
                  least-loaded live, non-draining workers (primary +
                  hedge backup). Draining or dead workers stop receiving
                  traffic within one probe interval; the hedge path
                  additionally absorbs the race where a request reaches a
                  worker just as it starts draining (the retriable
                  "draining" shed fails the primary attempt over to the
                  backup, so callers never observe the drain).

Workers speak the existing v3 wire protocol for work (MSG_RANK /
MSG_RANK_BATCH / pair scoring) — the fabric adds only the v4 control
frames (MSG_HEALTH / MSG_DRAIN). ``Fabric.router`` satisfies the same
transport protocol as a socket ``Client``, so ``plan(pipeline,
"remote_pipeline", ctx)`` binds to a whole fabric exactly as it binds to
one server (see ``core.plan``).

Lifecycle (mirrors a compose-style deployment: up / ps / drain / down):

    with Fabric(n_workers=4, backend="numpy", train_steps=1,
                device="cpu") as fab:
        out = fab.router.rank_batch(["query one", "query two"])
        fab.drain_worker(0)           # finishes in-flight, sheds new work
        fab.restart_worker(0)         # drain -> terminate -> respawn
    # __exit__ = stop(): drain probes, close clients, terminate workers
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import service as SV
from repro_torch.serving import telemetry
from repro_torch.serving.hedge import HedgedTransport

#: Discovery line a worker prints (flushed) once its listener is bound:
#: ``FABRIC_READY <host> <port>``. Workers bind port 0, so the supervisor
#: can only learn the address from this line.
READY_PREFIX = "FABRIC_READY"


def _src_root() -> str:
    """The ``src/`` directory that holds this ``repro_torch``, so spawned
    workers import the same checkout as the supervisor."""
    import repro_torch
    return str(Path(repro_torch.__file__).resolve().parent.parent)


class FabricWorker:
    """One worker process slot: Popen handle + stdout discovery/diagnostics.

    ``slot`` is the stable identity (survives respawns); the process and
    its address change every (re)spawn. ``device`` passes through to the
    worker's ``--device``.
    """

    def __init__(self, slot: int, backend: str = "numpy",
                 train_steps: int = 1, server: str = "threadpool",
                 workers: int = 8, max_queue: int = 512,
                 extra_args: Sequence[str] = (), tail_lines: int = 40,
                 device: str = "cuda"):
        self.slot = slot
        self.backend = backend
        self.device = str(device)
        self.train_steps = train_steps
        self.server = server
        self.workers = workers
        self.max_queue = max_queue
        self.extra_args = list(extra_args)
        self.proc: Optional[subprocess.Popen] = None
        self.address: Optional[Tuple[str, int]] = None
        #: Set by the supervisor before a deliberate terminate so the
        #: monitor does not count the exit as a crash.
        self.expect_exit = False
        self.spawns = 0
        self._tail: "collections.deque[str]" = collections.deque(
            maxlen=tail_lines)
        self._ready = threading.Event()
        self._reader: Optional[threading.Thread] = None

    # ------------------------------------------------------------ spawn --

    def command(self) -> List[str]:
        # -u: unbuffered stdout, so FABRIC_READY crosses the pipe even
        # though the child sees a pipe (block-buffered) not a tty.
        return [sys.executable, "-u", "-m", "repro_torch.launch.serve",
                "--serve-pipeline", "--server", self.server,
                "--backend", self.backend, "--device", self.device,
                "--port", "0",
                "--train-steps", str(self.train_steps),
                "--workers", str(self.workers),
                "--max-queue", str(self.max_queue)] + self.extra_args

    def spawn(self) -> None:
        """Start the process (non-blocking; pair with ``wait_ready``)."""
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_root() + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.address = None
        self._ready.clear()
        self.expect_exit = False
        self.proc = subprocess.Popen(
            self.command(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
        self.spawns += 1
        self._reader = threading.Thread(target=self._read_output,
                                        daemon=True,
                                        name=f"fabric-reader-{self.slot}")
        self._reader.start()

    def _read_output(self) -> None:
        proc = self.proc
        assert proc is not None and proc.stdout is not None
        for line in proc.stdout:
            line = line.rstrip("\n")
            self._tail.append(line)
            if line.startswith(READY_PREFIX + " "):
                try:
                    _, host, port = line.split()
                    self.address = (host, int(port))
                except ValueError:
                    self._tail.append(f"[fabric] bad ready line: {line!r}")
                self._ready.set()
        self._ready.set()   # EOF: unblock waiters (address may be None)

    def wait_ready(self, timeout_s: float = 120.0) -> Tuple[str, int]:
        """Block until the worker printed its address; raise with the
        captured output tail if it died or timed out instead."""
        if not self._ready.wait(timeout_s):
            raise RuntimeError(
                f"fabric worker {self.slot} not ready after {timeout_s}s; "
                f"output tail: {list(self._tail)!r}")
        if self.address is None:
            raise RuntimeError(
                f"fabric worker {self.slot} exited before ready "
                f"(rc={self.proc.poll() if self.proc else None}); "
                f"output tail: {list(self._tail)!r}")
        return self.address

    # ----------------------------------------------------------- status --

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def tail(self) -> List[str]:
        return list(self._tail)

    def terminate(self, timeout_s: float = 10.0) -> None:
        """Deliberate kill (not a crash): supervisor won't respawn it."""
        if self.proc is None:
            return
        self.expect_exit = True
        self.proc.terminate()
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout_s)
        # The reader thread drains the pipe to EOF once the process dies;
        # join it so a terminated worker leaves no thread behind (and the
        # tail it captured is complete before anyone reads it).
        if self._reader is not None:
            self._reader.join(timeout=timeout_s)
            self._reader = None


class WorkerEndpoint:
    """Client bundle for one worker: request + control connections.

    A ``service.Client`` serializes RPCs on its single socket, so health
    probes and drain commands get their own connection — a probe must
    answer while a long rank_batch is still in flight on the request
    connection, or the router would mistake "busy" for "dead".

    A ``Client`` is not safe for two callers at once: two RPCs interleaved
    on one socket read each other's replies. The control connection has
    several callers (the router's probe thread, and whoever drains, swaps,
    reads the version or pulls stats), so they take turns under
    ``_control_lock``. (The JAX package's endpoint has no such lock; there
    a probe racing a drain, swap or stats call can break the control
    connection.)
    """

    def __init__(self, slot: int, address: Tuple[str, int]):
        self.slot = slot
        self.address = address
        self.client = SV.Client(address)    # work: rank/rank_batch/scores
        # Control plane runs untraced: probes fire every probe_interval_s
        # and would otherwise drown real request spans in the trace ring.
        self.control = SV.Client(address, trace=False)
        self._control_lock = Lock()

    def _control_rpc(self, method: str, *args, **kw):
        with self._control_lock:
            # repro-lint: allow[LOCK001] the control connection carries one RPC at a time: the lock serializes its callers (probe thread, drain, swap, stats) so no two RPCs interleave on the socket
            return getattr(self.control, method)(*args, **kw)

    def probe(self) -> Dict[str, float]:
        return self._control_rpc("health")

    def drain(self) -> Dict[str, float]:
        return self._control_rpc("drain")

    def fetch_stats(self) -> Tuple[Dict[str, float], list]:
        """Pull the worker PROCESS's full telemetry (v5 MSG_STATS): its
        MetricsRegistry snapshot + recent finished spans."""
        return self._control_rpc("stats")

    def version(self) -> Tuple[str, str]:
        """(active model version, status) over MSG_VERSION."""
        return self._control_rpc("version")

    def swap(self, version: str,
             deadline_s: Optional[float] = None) -> Tuple[str, str]:
        """Hot-swap the worker to registry ``version`` over MSG_SWAP (the
        worker must have been spawned with ``--registry``). Runs on the
        control connection: a swap must not queue behind rank traffic."""
        return self._control_rpc("swap", version, deadline_s=deadline_s)

    def close(self) -> None:
        for c in (self.client, self.control):
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self) -> "WorkerEndpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HealthRouter(HedgedTransport):
    """Hedging transport that routes on live MSG_HEALTH snapshots.

    Load of a worker = ``queue_depth`` (admission-reserved rows) +
    ``inflight`` (requests being handled) from its latest probe; requests
    go to the two least-loaded live, non-draining workers (ties rotate
    round-robin so an idle fleet still spreads). With no routable worker
    (fleet still warming, or everything draining) it falls back to plain
    round-robin over all endpoints — failing over noisily beats failing
    closed, and the hedge absorbs a worker that sheds.
    """

    def __init__(self, endpoints: Sequence[WorkerEndpoint],
                 probe_interval_s: float = 0.05, **kw):
        super().__init__([e.client for e in endpoints], **kw)
        self._endpoints = list(endpoints)
        self._probe_interval_s = probe_interval_s
        self._snaps: Dict[int, Dict[str, float]] = {}
        self._alive: Dict[int, bool] = {i: True
                                        for i in range(len(self._endpoints))}
        self._probes = 0
        self._probe_failures = 0
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- probes --

    def start_probes(self) -> None:
        if self._probe_thread is not None:
            return
        self._probe_thread = threading.Thread(target=self._probe_loop,
                                              daemon=True,
                                              name="fabric-probe")
        self._probe_thread.start()

    def probe_once(self) -> None:
        """One synchronous probe round (tests call this directly)."""
        for i, ep in enumerate(list(self._endpoints)):
            try:
                snap = ep.probe()
            except (OSError, RuntimeError, ValueError):
                with self._meta:
                    self._alive[i] = False
                    self._snaps.pop(i, None)
                    self._probe_failures += 1
                continue
            with self._meta:
                self._alive[i] = True
                self._snaps[i] = snap
                self._probes += 1

    def _probe_loop(self) -> None:
        while not self._stop.wait(self._probe_interval_s):
            self.probe_once()

    # ---------------------------------------------------------- routing --

    @staticmethod
    def _load(snap: Optional[Dict[str, float]]) -> float:
        if not snap:
            return 0.0
        return snap.get("queue_depth", 0.0) + snap.get("inflight", 0.0)

    def _routable(self, i: int) -> bool:
        snap = self._snaps.get(i)
        return bool(self._alive.get(i, False) and snap is not None
                    and not snap.get("draining", 0.0))

    def _pick_endpoints(self):
        with self._meta:
            ok = [i for i in range(len(self._transports))
                  if self._routable(i)]
            if not ok:
                # No health signal yet (or whole fleet draining): behave
                # like the base round-robin hedger rather than stalling.
                ok = list(range(len(self._transports)))
            start = self._rr % len(ok)
            self._rr += 1
            order = ok[start:] + ok[:start]
            order.sort(key=lambda i: self._load(self._snaps.get(i)))
        return order[0], (order[1] if len(order) > 1 else None)

    # -------------------------------------------------------- endpoints --

    def replace_endpoint(self, slot_index: int,
                         endpoint: WorkerEndpoint) -> None:
        """Swap a respawned worker's fresh endpoint into the slot. Takes
        the slot's attempt lock, so an in-flight loser finishes draining
        on the OLD connection before it is closed."""
        with self._locks[slot_index]:
            old = self._endpoints[slot_index]
            self._endpoints[slot_index] = endpoint
            self._transports[slot_index] = endpoint.client
            old.close()
        with self._meta:
            self._snaps.pop(slot_index, None)
            self._alive[slot_index] = True

    def snapshot(self) -> Dict[int, Dict[str, float]]:
        with self._meta:
            return {i: dict(s) for i, s in self._snaps.items()}

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        with self._meta:
            s["probes"] = float(self._probes)
            s["probe_failures"] = float(self._probe_failures)
            s["routable_workers"] = float(
                sum(1 for i in range(len(self._transports))
                    if self._routable(i)))
        return s

    def close(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2.0)
            self._probe_thread = None
        for lock, ep in zip(self._locks, self._endpoints):
            with lock:
                ep.close()


class Fabric:
    """Supervisor for a fleet of pipeline-serving worker processes.

    ``spawn`` starts every worker concurrently (each imports torch, opens
    its CUDA context, builds its kernels and trains its world — the slow
    part overlaps across processes), waits for
    all the discovery lines, connects a ``HealthRouter`` over them, and
    starts the probe + crash-monitor threads. From then on:

      * a worker that EXITS unexpectedly is respawned into the same slot
        and its fresh endpoint swapped into the router (crash recovery);
      * ``drain_worker`` performs the graceful half: MSG_DRAIN, then poll
        health until in-flight hits zero — the router stops sending it
        work within a probe interval, and nothing in flight is lost;
      * ``restart_worker`` = drain -> terminate -> respawn -> rejoin, the
        checkpoint/upgrade cycle of a real deployment.
    """

    def __init__(self, n_workers: int = 2, backend: str = "numpy",
                 train_steps: int = 1, server: str = "threadpool",
                 worker_threads: int = 8, max_queue: int = 512,
                 spawn_timeout_s: float = 180.0,
                 probe_interval_s: float = 0.05,
                 hedge_s: Optional[float] = None,
                 supervise: bool = True,
                 extra_args: Sequence[str] = (),
                 device: str = "cuda"):
        if n_workers < 1:
            raise ValueError("Fabric needs at least one worker")
        self.workers = [FabricWorker(i, backend=backend,
                                     train_steps=train_steps, server=server,
                                     workers=worker_threads,
                                     max_queue=max_queue,
                                     extra_args=extra_args,
                                     device=device)
                        for i in range(n_workers)]
        self.spawn_timeout_s = spawn_timeout_s
        self.probe_interval_s = probe_interval_s
        self.hedge_s = hedge_s
        self.supervise = supervise
        self.router: Optional[HealthRouter] = None
        self.respawns = 0
        self._stopping = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # Guards only the tiny bookkeeping sections (respawn counter, the
        # claimed-slot set). Slot respawns follow claim-then-work: a slot
        # is CLAIMED under this lock, but the slow part — process spawn,
        # readiness wait, endpoint swap, probe — runs with the lock
        # released, so stats/metrics/other slots never stall behind a
        # respawn that can take spawn_timeout_s.
        self._lock = Lock()
        self._respawning: set = set()

    # -------------------------------------------------------- lifecycle --

    def spawn(self) -> "Fabric":
        for w in self.workers:
            w.spawn()
        endpoints = []
        deadline = time.perf_counter() + self.spawn_timeout_s
        for w in self.workers:
            left = max(deadline - time.perf_counter(), 1.0)
            endpoints.append(WorkerEndpoint(w.slot, w.wait_ready(left)))
        self.router = HealthRouter(endpoints,
                                   probe_interval_s=self.probe_interval_s,
                                   hedge_s=self.hedge_s)
        self.router.probe_once()        # routable before the first request
        self.router.start_probes()
        if self.supervise:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="fabric-monitor")
            self._monitor.start()
        return self

    def __enter__(self) -> "Fabric":
        return self.spawn()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        self._stopping.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        if self.router is not None:
            self.router.close()
        for w in self.workers:
            w.terminate()

    # ------------------------------------------------------ supervision --

    def _monitor_loop(self) -> None:
        while not self._stopping.wait(0.2):
            for w in self.workers:
                if w.proc is not None and not w.alive and not w.expect_exit:
                    try:
                        self._respawn(w)
                    except RuntimeError:
                        # Respawn failed (e.g. teardown racing the
                        # monitor); probe failures keep the slot
                        # unroutable, and the next tick retries.
                        if self._stopping.is_set():
                            return

    def _claim_slot(self, slot: int) -> bool:
        """Mark one slot as mid-respawn; False if already claimed (the
        monitor and an explicit restart_worker racing on the same slot)."""
        with self._lock:
            if slot in self._respawning:
                return False
            self._respawning.add(slot)
            return True

    def _release_slot(self, slot: int) -> None:
        with self._lock:
            self._respawning.discard(slot)

    def _respawn(self, w: FabricWorker) -> None:
        if not self._claim_slot(w.slot):
            return
        try:
            if self._stopping.is_set() or w.alive:
                return
            w.spawn()
            address = w.wait_ready(self.spawn_timeout_s)
            assert self.router is not None
            self.router.replace_endpoint(w.slot,
                                         WorkerEndpoint(w.slot, address))
            with self._lock:
                self.respawns += 1
            self.router.probe_once()
        finally:
            self._release_slot(w.slot)

    # ------------------------------------------------- drain / restart ---

    def drain_worker(self, slot: int,
                     timeout_s: float = 30.0) -> Dict[str, float]:
        """Gracefully drain one worker: it stops admitting work (new
        requests shed retriably as "draining" — the router's hedge path
        fails them over), finishes everything in flight, and reports its
        final health snapshot once idle. The router's probes observe
        ``draining`` and stop routing to the slot within one interval."""
        assert self.router is not None
        ep = self.router._endpoints[slot]
        snap = ep.drain()
        deadline = time.perf_counter() + timeout_s
        while snap.get("inflight", 0.0) or snap.get("queue_depth", 0.0):
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"worker {slot} still busy after {timeout_s}s drain: "
                    f"{snap}")
            time.sleep(0.01)
            snap = ep.probe()
        self.router.probe_once()        # propagate draining=1 to routing
        return snap

    def swap_worker(self, slot: int, version: str,
                    timeout_s: float = 30.0) -> Tuple[str, str]:
        """Hot-swap one worker to registry ``version`` with zero request
        loss: drain (router stops routing to the slot, in-flight work
        finishes), MSG_SWAP on the control connection (the worker engine
        re-plans on the new version and REJOINS — a successful swap clears
        its draining flag server-side), then a probe round so the router
        sees the slot routable again. The worker process never restarts:
        its jit caches, sockets and featurization cache survive."""
        if not self._claim_slot(slot):
            raise RuntimeError(f"worker {slot} is already cycling")
        try:
            assert self.router is not None
            self.drain_worker(slot, timeout_s=timeout_s)
            ep = self.router._endpoints[slot]
            vid, status = ep.swap(version, deadline_s=timeout_s)
            self.router.probe_once()    # draining cleared -> routable
        finally:
            self._release_slot(slot)
        return vid, status

    def swap_fleet(self, version: str,
                   timeout_s: float = 30.0) -> List[Tuple[str, str]]:
        """Rolling hot-swap of every worker, one slot at a time, so the
        rest of the fleet keeps absorbing traffic while each slot drains
        and reloads. Returns the per-slot (version, status) replies."""
        return [self.swap_worker(slot, version, timeout_s=timeout_s)
                for slot in range(len(self.workers))]

    def restart_worker(self, slot: int,
                       timeout_s: float = 30.0) -> Tuple[str, int]:
        """Drain -> terminate -> respawn -> rejoin for one slot; returns
        the respawned worker's new address."""
        w = self.workers[slot]
        if not self._claim_slot(slot):
            raise RuntimeError(f"worker {slot} is already restarting")
        try:
            self.drain_worker(slot, timeout_s=timeout_s)
            w.terminate()
            w.spawn()
            address = w.wait_ready(self.spawn_timeout_s)
            assert self.router is not None
            self.router.replace_endpoint(slot, WorkerEndpoint(slot,
                                                              address))
            self.router.probe_once()    # fresh worker is routable again
        finally:
            self._release_slot(slot)
        return address

    # ----------------------------------------------------------- status --

    def stats(self) -> Dict[str, float]:
        s: Dict[str, float] = {
            "n_workers": float(len(self.workers)),
            "respawns": float(self.respawns),
            "alive_workers": float(sum(1 for w in self.workers if w.alive)),
        }
        if self.router is not None:
            for k, v in self.router.stats().items():
                s[f"router_{k}"] = v
        return s

    # -------------------------------------------------------- telemetry --

    def worker_metrics(self) -> Dict[int, Dict[str, float]]:
        """Per-slot MetricsRegistry snapshots pulled over MSG_STATS.
        Unreachable workers (mid-respawn) are skipped — the fleet view
        should not fail because one slot is cycling."""
        assert self.router is not None
        out: Dict[int, Dict[str, float]] = {}
        for i, ep in enumerate(list(self.router._endpoints)):
            try:
                metrics, _ = ep.fetch_stats()
            except (OSError, RuntimeError, ValueError):
                continue
            out[i] = metrics
        return out

    def aggregate_metrics(self) -> Dict[str, float]:
        """The fleet-wide registry: every worker's snapshot summed key-wise
        (valid for counters and Prometheus-style histogram keys — see
        ``telemetry.merge_snapshots``)."""
        return telemetry.merge_snapshots(self.worker_metrics().values())

    def collect_spans(self, trace_id: Optional[int] = None) -> list:
        """Assemble the cross-process view of recent traces: this process's
        finished spans (router/client side) plus every reachable worker's
        spans fetched over MSG_STATS, optionally filtered to one trace.
        Returns ``telemetry.SpanRecord`` objects — feed them to
        ``telemetry.span_tree`` / ``export_chrome_trace``."""
        assert self.router is not None
        spans = list(telemetry.get_tracer().finished())
        for ep in list(self.router._endpoints):
            try:
                _, wire_spans = ep.fetch_stats()
            except (OSError, RuntimeError, ValueError):
                continue
            spans.extend(telemetry.SpanRecord.from_wire(w)
                         for w in wire_spans)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return spans
