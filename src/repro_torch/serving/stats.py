"""Serving-side latency/throughput accounting (the paper's Table 2 columns).

``LatencyTracker`` is hammered concurrently by every server worker thread and
replica completion callback, so ``observe``/``summary``/``percentile`` hold a
lock; percentiles use linear interpolation between order statistics (the
numpy default) rather than floor-indexing, so small sample counts don't bias
p99 low.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock


class LatencyTracker:
    """``max_samples`` bounds memory for long-running servers: percentiles
    are computed over a sliding window of the most recent observations
    (``count`` remains all-time).

    ``qps`` is the arrival rate over the trailing ``window_s`` seconds —
    NOT all-time count over process age. A server that idled for an hour
    and then took a burst reports the burst's rate, not a number diluted
    by the idle hour; an idle server decays to 0 within one window. The
    all-time average is still exported as ``qps_lifetime``. ``clock`` is
    injectable so tests drive the window deterministically.
    """

    def __init__(self, max_samples: int = 65536, window_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        self._samples: "deque[float]" = deque(maxlen=max_samples)
        self._clock = clock or time.perf_counter
        self._window_s = window_s
        #: (arrival time, n) per observe, pruned to the trailing window.
        self._arrivals: "deque[tuple]" = deque()
        self._started = self._clock()
        self._count = 0
        self._lock = Lock()

    def _prune(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._arrivals and self._arrivals[0][0] < cutoff:
            self._arrivals.popleft()

    def observe(self, seconds: float, n: int = 1):
        now = self._clock()
        with self._lock:
            self._samples.append(seconds)
            self._count += n
            self._arrivals.append((now, n))
            self._prune(now)

    def reset(self) -> None:
        """Forget everything, including the all-time count — a drained
        server re-entering rotation starts its story from zero."""
        with self._lock:
            self._samples.clear()
            self._arrivals.clear()
            self._count = 0
            self._started = self._clock()

    @staticmethod
    def _interp_percentile(xs: List[float], q: float) -> float:
        """Linear interpolation between closest ranks (xs must be sorted)."""
        if not xs:
            return 0.0
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def percentile(self, q: float) -> float:
        with self._lock:
            xs = sorted(self._samples)
        return self._interp_percentile(xs, q)

    def summary(self) -> Dict[str, float]:
        now = self._clock()
        with self._lock:
            self._prune(now)
            windowed = sum(n for _, n in self._arrivals)
            # Rate denominator: the full window once the process is old
            # enough, the actual elapsed time before that (so a 2-second-old
            # tracker doesn't divide 100 requests by 30s).
            span = min(max(now - self._started, 1e-9), self._window_s)
            xs = sorted(self._samples)
            count = self._count
        elapsed = max(now - self._started, 1e-9)
        return {
            "count": float(count),
            "qps": windowed / span,
            "qps_lifetime": count / elapsed,
            "p50_ms": self._interp_percentile(xs, 0.50) * 1e3,
            "p90_ms": self._interp_percentile(xs, 0.90) * 1e3,
            "p99_ms": self._interp_percentile(xs, 0.99) * 1e3,
        }
