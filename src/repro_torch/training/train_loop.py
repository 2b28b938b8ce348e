"""Trainer: the step, metrics, checkpoint/restart, hooks.

Works for every model family: the caller supplies ``loss_fn(params, batch)
-> (loss, metrics)`` over a tree of tensors and a data iterator; the trainer
owns optimization, checkpointing cadence, straggler accounting, and
crash-resume (restore() picks up where the last atomic checkpoint left off).

The JAX package's ``jax.value_and_grad`` + ``jax.jit`` step becomes
``torch.autograd.grad`` on the loss, run eagerly. The step is functional:
it differentiates detached copies of the params and returns new trees from
the optimizer, so a step that raises commits nothing and ``retry_step``
may run it again. Batches are dicts of numpy arrays (``data.qa``) or
tensors; they are moved to the params' device.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.treepath import tree_leaves, tree_map
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import StragglerMonitor, retry_step
from repro_torch.training.optimizer import Optimizer


def _to_device(batch: Dict, device: torch.device) -> Dict:
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return {k: move(v) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict):
    """``loss_fn(params, batch) -> (loss, metrics)`` and the gradient tree of
    ``loss`` with respect to every leaf of ``params``: ``(loss, metrics,
    grads)``. It differentiates detached copies, so ``params`` is left as it
    was. A leaf the loss does not reach raises (``torch.autograd.grad``
    without ``allow_unused``) instead of training on a zero gradient: a
    model whose gradient stops somewhere fails here, not by a loss that
    still falls through its other leaves."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, batch)
    wrt = tree_leaves(live)
    grad_of = {id(p): g for p, g in zip(wrt, torch.autograd.grad(loss, wrt))}
    return loss, metrics, tree_map(lambda p: grad_of[id(p)], live)


class Trainer:
    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 params: Any, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 100, keep: int = 3,
                 donate: bool = False, max_retries: int = 2):
        # ``donate`` is accepted for the JAX signature; an eager step has no
        # buffers to donate.
        self.optimizer = optimizer
        self.params = params
        self.opt_state = optimizer.init(params)
        self.step = 0
        self.monitor = StragglerMonitor()
        self.max_retries = max_retries
        self.ckpt_every = ckpt_every
        self.manager = CheckpointManager(ckpt_dir, keep) if ckpt_dir else None
        self.history: List[Dict[str, float]] = []
        self._loss_fn = loss_fn

    def _step(self, params, opt_state, batch):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        loss, metrics, grads = value_and_grad(
            self._loss_fn, params, _to_device(batch, device))
        new_params, new_state = self.optimizer.update(params, grads,
                                                      opt_state)
        metrics = dict(metrics, loss=loss)
        return new_params, new_state, {k: v.detach() if isinstance(
            v, torch.Tensor) else v for k, v in metrics.items()}

    def restore(self) -> bool:
        if self.manager is None or self.manager.latest_step() is None:
            return False
        self.params, self.opt_state, self.step = self.manager.restore(
            self.params, self.opt_state)
        return True

    def run(self, batches: Iterable[Dict], max_steps: Optional[int] = None,
            log_every: int = 10, log_fn: Callable = print) -> Dict[str, float]:
        last_metrics: Dict[str, float] = {}
        for batch in batches:
            if max_steps is not None and self.step >= max_steps:
                break
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = retry_step(
                self._step, self.params, self.opt_state, batch,
                max_retries=self.max_retries)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step += 1
            self.monitor.record(self.step, dt)
            metrics["step_time_s"] = dt
            self.history.append(metrics)
            last_metrics = metrics
            if log_every and self.step % log_every == 0:
                msg = " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
                log_fn(f"step {self.step}: {msg}")
            if self.manager and self.step % self.ckpt_every == 0:
                self.manager.save(self.step, self.params, self.opt_state)
        if self.manager is not None:
            self.manager.save(self.step, self.params, self.opt_state)
        return last_metrics
