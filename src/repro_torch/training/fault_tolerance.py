"""Fault-tolerance policies for long multi-host runs.

Three mechanisms (all exercised by tests; on a real cluster the triggers
come from the runtime instead of the injected fakes):

1. ``retry_step`` — transient-failure retry with checkpoint-restore fallback:
   a step that raises (a lost host, a link flap surfacing as a runtime
   error) is retried; after ``max_retries`` the caller restores the last
   checkpoint. A retry is safe only for a step that commits nothing before
   it returns: the port's optimizers build new tensors and mutate none of
   their inputs (``training.optimizer``), so a step that raised leaves the
   params as they were and its retry does not apply an update twice. A
   step that cannot be retried (a donated update that failed part way,
   ``training.train_loop``) raises ``StepFailure``, which is not retried.
2. ``StragglerMonitor`` — per-step deadline tracking with EWMA baseline;
   flags steps slower than ``threshold``x the moving median, the signal used
   to trigger re-sharding away from a slow host.
3. ``plan_elastic_mesh`` — given the surviving device count, picks the
   largest usable (data, model) sub-mesh so training resumes degraded
   instead of dying; checkpoints are topology-agnostic (see checkpoint.py)
   so restore-with-new-sharding is the whole story.
"""
from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Tuple


class StepFailure(RuntimeError):
    pass


def retry_step(fn: Callable, *args, max_retries: int = 3,
               backoff_s: float = 0.0, on_retry: Optional[Callable] = None):
    """Run fn(*args); retry on exception up to max_retries. A
    ``StepFailure`` from fn is final and raised at once."""
    last = None
    for attempt in range(max_retries + 1):
        try:
            return fn(*args)
        except StepFailure:
            raise
        except Exception as e:  # noqa: BLE001 — the retry boundary
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_s:
                time.sleep(backoff_s * (2 ** attempt))
    raise StepFailure(f"step failed after {max_retries + 1} attempts") from last


class StragglerMonitor:
    """EWMA step-time baseline; flags outlier steps."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup_steps: int = 5):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup_steps
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged: List[Tuple[int, float]] = []

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.ewma is None:
            self.ewma = duration_s
            return False
        is_straggler = (self.n > self.warmup and
                        duration_s > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append((step, duration_s))
        else:  # don't poison the baseline with outliers
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration_s
        return is_straggler


def plan_elastic_mesh(n_alive: int, model_parallel: int,
                      min_data: int = 1) -> Tuple[int, int]:
    """Largest (data, model) mesh from n_alive devices, preserving the
    model-parallel degree (params must still fit); data axis shrinks."""
    if n_alive < model_parallel * min_data:
        raise ValueError(
            f"{n_alive} devices cannot sustain model_parallel={model_parallel}")
    data = n_alive // model_parallel
    # power-of-two data axis keeps batch divisibility simple
    data = 2 ** int(math.floor(math.log2(data)))
    return data, model_parallel


def scale_batch_for_mesh(global_batch: int, old_data: int, new_data: int,
                         keep_global: bool = True) -> int:
    """Elastic batch policy: keep the global batch (per-device grows) or
    keep per-device batch (global shrinks -> LR rescale is caller's job)."""
    if keep_global:
        assert global_batch % new_data == 0, (global_batch, new_data)
        return global_batch
    return global_batch // old_data * new_data
