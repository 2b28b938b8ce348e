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

By default an update is functional: it builds new tensors and mutates none
of its inputs, so a step that raises halfway leaves params and state as
they were (``training.fault_tolerance.retry_step`` may run it again).
``update(..., donate=True)`` is the port of JAX's buffer donation
(``Trainer(donate=True)``): it clips the grads, and writes the moments, the
``master`` copies and the params, in place, leaf by leaf, with the
functional update's float32 operations in the same order, so its values are
the functional update's to the bit. It holds no second copy of the state,
only a leaf's float32 temporaries; a donated update that raises leaves the
trees half updated.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.treepath import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (params, grads, st, donate=False) -> (params, st)
    update: Callable[..., Tuple[Any, Any]]


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


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda leaf: (_f32(leaf) * scale).to(leaf.dtype),
                    tree), g


def clip_by_global_norm_(tree, max_norm: float):
    """``clip_by_global_norm`` in place: each leaf scaled in float32 and
    written back in its own dtype, the same values."""
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    for leaf in tree_leaves(tree):
        if leaf.dtype == torch.float32:
            leaf.mul_(scale)
        else:
            leaf.copy_(_f32(leaf).mul_(scale))
    return tree, g


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

    def corrections(step):
        stepf = _f32(step)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=step.device), stepf)
        return c1, c2

    @torch.no_grad()
    def update_in_place(params, grads, st):
        if clip_norm is not None:
            clip_by_global_norm_(grads, clip_norm)
        step = st["step"].add_(1)
        lr_t = sched(step)
        c1, c2 = corrections(step)
        for m, v, g, p32, p in zip(*(tree_leaves(t) for t in (
                st["mu"], st["nu"], grads, st["master"], params))):
            g = _f32(g)
            m.mul_(b1).add_(g * (1 - b1))              # b1 m + (1 - b1) g
            t = g * (1 - b2)
            v.mul_(b2).add_(t.mul_(g))                 # b2 v + (1 - b2) g g
            del t, g
            u = m / c1
            den = (v / c2).sqrt_().add_(eps)
            u.div_(den)                                # (m / c1) / (sqrt(v / c2) + eps)
            del den
            if weight_decay:
                u.add_(p32 * weight_decay)
            p32.sub_(u.mul_(lr_t))                     # p32 - lr_t u
            p.copy_(p32)
        return params, st

    def update(params, grads, st, donate: bool = False):
        if donate:
            return update_in_place(params, grads, st)
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = st["step"] + 1
        lr_t = sched(step)
        c1, c2 = corrections(step)

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

    @torch.no_grad()
    def update_in_place(params, grads, st):
        if clip_norm is not None:
            clip_by_global_norm_(grads, clip_norm)
        lr_t = sched(st["step"].add_(1))
        for v, g, p32, p in zip(*(tree_leaves(t) for t in (
                st["vel"], grads, st["master"], params))):
            v.mul_(momentum).add_(_f32(g))             # momentum v + g
            p32.sub_(v * lr_t)                         # p32 - lr_t v
            p.copy_(p32)
        return params, st

    def update(params, grads, st, donate: bool = False):
        if donate:
            return update_in_place(params, grads, st)
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
