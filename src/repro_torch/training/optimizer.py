"""Optimizers as plain functions on tensor trees (the JAX package's
optax-like core, not ``torch.optim``).

Mixed-precision discipline: if params are low-precision (bf16), the optimizer
keeps fp32 master copies + moments in its state and casts back each step.
Schedules are step-indexed functions of the state's counter.

``adamw`` is not torch's default AdamW: ``b2=0.95``, global-norm clipping
at 1.0, float32 ``master`` copies, and the decay added to the update before
the lr scale. The state keeps the JAX package's keys (``step`` as a 0-d
int32, ``mu``, ``nu``, ``master``), so a checkpoint's ``opt.rpro`` restores
in either package.

Every update is functional: it builds new tensors and mutates none of its
inputs, so a step that raises halfway leaves params and state as they were
(``training.fault_tolerance.retry_step`` may run it again).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.treepath import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (params, grads, st)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def warmup_cosine_schedule(peak_lr: float, warmup: int, total: int,
                           floor: float = 0.1) -> Callable:
    def fn(step):
        step = _f32(torch.as_tensor(step))
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


# ---------------------------------------------------------------------------
# gradient transforms
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(_f32(leaf)))
                          for leaf in leaves))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda leaf: (_f32(leaf) * scale).to(leaf.dtype),
                    tree), g


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device_of(params)),
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            # fp32 master copies (mixed precision), never aliasing a param
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params),
        }

    def update(params, grads, st):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = st["step"] + 1
        lr_t = sched(step)
        stepf = _f32(step)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=step.device), stepf)

        def upd(m, v, g, p32):
            g = _f32(g)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p32
            return m, v, p32 - lr_t * u

        out = tree_map(upd, st["mu"], st["nu"], grads, st["master"])
        mu, nu, master = (_pick(out, i) for i in range(3))
        new_params = tree_map(lambda p32, p: p32.to(p.dtype, copy=True),
                              master, params)
        return new_params, {"step": step, "mu": mu, "nu": nu,
                            "master": master}

    return Optimizer(init, update)


def _pick(tree, i: int):
    """Component ``i`` of a tree whose leaves are tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def adam(lr, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def sgd(lr: Callable | float, momentum: float = 0.9,
        clip_norm: Optional[float] = None) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device_of(params)),
                "vel": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "master": tree_map(
                    lambda p: p.detach().to(torch.float32, copy=True),
                    params)}

    def update(params, grads, st):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = st["step"] + 1
        lr_t = sched(step)
        vel = tree_map(lambda v, g: momentum * v + _f32(g), st["vel"], grads)
        master = tree_map(lambda p, v: p - lr_t * v, st["master"], vel)
        new_params = tree_map(lambda p32, p: p32.to(p.dtype, copy=True),
                              master, params)
        return new_params, {"step": step, "vel": vel, "master": master}

    return Optimizer(init, update)
