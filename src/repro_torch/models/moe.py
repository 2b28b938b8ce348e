"""Mixture-of-Experts FFN: shared + fine-grained routed experts (DeepSeekMoE),
the gather formulation.

The port of the JAX package's ``models/moe.py`` (``moe_params``,
``_capacity``, ``route``, ``moe_apply``), with its parameter tree and its
routing, dropped slots included:

* tokens are cut into groups of ``sg = min(group_size, B*S)`` (G, sg, d);
  a decode step of B rows is one group of B;
* the router (float32 in every model dtype) picks each token's top-k
  experts, ties going to the lower expert index as ``jax.lax.top_k``
  breaks them;
* each (token, choice) pair gets a slot in its expert's buffer of
  ``c = _capacity(spec, sg)`` rows, first come first served: choice j of
  every token queues behind choice j-1 of every token (``slots``); a pair
  whose slot is ``>= c`` is dropped, and still flows through the shared
  experts and the residual;
* experts run as batched products over their (G*c, d) buffers, and each
  token gathers its k outputs back, a dropped pair's at slot ``c - 1``
  multiplied by a weight of 0, as JAX does.

Shared experts are one fused SwiGLU of width ``n_shared * d_expert`` added to
every token. The expert products are plain torch (``torch.bmm``), as they are
``jnp.einsum`` outside any Pallas kernel in the JAX package.

Training differentiates ``moe_apply`` with autograd, and its gradient is
``jax.grad``'s of the JAX function for every input: the router's through the
kept weights and, through ``probs``, the aux loss (the top-k's indices
and the top-1 one-hot carry none); x's through the router, the shared
experts and the dispatch gather, whose backward accumulates each token's
rows; a dropped pair's slot, read at weight 0, gets exactly 0 from it, as
in JAX.

``count_drops()`` counts the pairs ``moe_apply`` routes and drops while it
is entered, for a caller that wants a run's drop share. A count is of
``moe_apply`` calls: under ``cfg.remat`` a training step runs each layer's
``moe_apply`` twice (the forward, then again in the backward, routing the
same pairs), so both counts double and the share is the step's.
``moe_apply_dense`` is the plain reference ``moe_apply`` is held against
(every expert on every token).
``moe_apply_a2a`` (expert parallelism across cards) is not ported
(ROADMAP.md §1 item 11).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig, MoESpec
from repro_torch.models import layers as L


def moe_params(generator: torch.Generator, cfg: LMConfig, dtype) -> Dict:
    """The router (d, E) in float32 at std 1/sqrt(d), whatever ``dtype``;
    the experts' ``w_gate``/``w_up`` (E, d, d_expert) at std 1/sqrt(d) and
    ``w_down`` (E, d_expert, d) at std 1/sqrt(d_expert), drawn in float32
    and cast to ``dtype``; ``shared`` a SwiGLU of width n_shared *
    d_expert. Drawn in that order from ``generator``, on its device."""
    spec = cfg.moe
    d, e, de = cfg.d_model, spec.n_routed, spec.d_expert
    dev = generator.device

    def normal(shape, std):   # one float32 temporary a tensor
        return torch.randn(shape, generator=generator, device=dev).mul_(std)

    p = {
        "router": normal((d, e), 1.0 / math.sqrt(d)),
        "w_gate": normal((e, d, de), 1.0 / math.sqrt(d)).to(dtype),
        "w_up": normal((e, d, de), 1.0 / math.sqrt(d)).to(dtype),
        "w_down": normal((e, de, d), 1.0 / math.sqrt(de)).to(dtype),
    }
    if spec.n_shared:
        p["shared"] = L.swiglu_params(generator, d, spec.n_shared * de, dtype)
    return p


def _capacity(spec: MoESpec, s: int) -> int:
    """Slots an expert holds for a group of ``s`` tokens: s * k *
    capacity_factor / E rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(s * spec.top_k * spec.capacity_factor / spec.n_routed))
    return max(8, ((c + 7) // 8) * 8)


def route(router_w: torch.Tensor, x: torch.Tensor, spec: MoESpec
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: x (G, S, d) -> (weights (G, S, k) float32, expert_idx (G, S, k)
    int64, aux_loss scalar). The logits are ``x`` in float32 times the
    float32 router; the top k of the softmax come from a stable descending
    sort, so equal probabilities go to the lower expert index first, as in
    ``jax.lax.top_k``; the weights are renormalised to sum to 1. The aux
    loss is GShard's ``E * mean_e(top-1 share_e * mean prob_e)``."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)               # (G,S,E)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :spec.top_k], idx[..., :spec.top_k]
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
    e = spec.n_routed
    sel = F.one_hot(idx[..., 0], e).float()                           # top-1
    aux = e * torch.mean(torch.mean(sel, dim=(0, 1)) * torch.mean(probs, dim=(0, 1)))
    return w, idx, aux


def slots(idx: torch.Tensor, n_routed: int, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice) pair's slot in its expert's buffer, and whether
    it is kept: idx (G, S, k) -> (pos (G, S, k) int64, keep = pos < c).

    For j = 0..k-1 in order, a pair's slot is the number of earlier tokens
    of the group whose choice j names the same expert, plus every token's
    choices 0..j-1 that name it: the exclusive cumsums of the JAX package's
    ``moe_apply``."""
    counts = torch.zeros((idx.shape[0], n_routed), dtype=torch.long, device=idx.device)
    pos = []
    for j in range(idx.shape[-1]):
        oh = F.one_hot(idx[:, :, j], n_routed)                        # (G,S,E)
        excl = torch.cumsum(oh, dim=1) - oh                          # exclusive
        pos.append(torch.gather(excl + counts[:, None, :], 2, idx[:, :, j:j + 1])[..., 0])
        counts = counts + oh.sum(dim=1)
    pos = torch.stack(pos, dim=-1)
    return pos, pos < c


class DropCount:
    """The (token, choice) pairs ``moe_apply`` routed and dropped while a
    ``count_drops()`` block was open. The dropped counts stay on the device
    until ``dropped`` is read."""

    def __init__(self):
        self.routed = 0
        self._dropped: List[torch.Tensor] = []

    @property
    def dropped(self) -> int:
        return sum(int(t) for t in self._dropped)

    @property
    def share(self) -> float:
        return self.dropped / self.routed if self.routed else 0.0


_open_counts: List[DropCount] = []


@contextlib.contextmanager
def count_drops():
    """``with count_drops() as n:`` counts every ``moe_apply`` call of the
    block (in any thread of the process, autograd's backward among them)
    into ``n``; a rematerialised layer's recompute counts again."""
    n = DropCount()
    _open_counts.append(n)
    try:
        yield n
    finally:
        _open_counts.remove(n)


def moe_apply(p: Dict, x: torch.Tensor, cfg: LMConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss): the routed experts' weighted
    outputs over each token's kept choices, plus the shared experts."""
    spec = cfg.moe
    b, s0, d = x.shape
    t = b * s0
    sg = min(spec.group_size, t)
    if t % sg:
        raise ValueError(f"tokens {t} % group {sg} != 0")
    g = t // sg
    e, k = spec.n_routed, spec.top_k
    c = _capacity(spec, sg)

    xg = x.reshape(g, sg, d)
    w, idx, aux = route(p["router"], xg, spec)                       # (G,S,k)
    pos, keep = slots(idx, e, c)
    for n in _open_counts:
        n.routed += keep.numel()
        n._dropped.append(torch.count_nonzero(~keep))
    pos_c = torch.where(keep, pos, c)          # c: the spare column, cut below

    # (G, E, c) token index buffer; the sentinel sg gathers a zero pad row
    gi = torch.arange(g, device=x.device)[:, None, None].expand(g, sg, k)
    si = torch.arange(sg, device=x.device)[None, :, None].expand(g, sg, k)
    idx_buf = torch.full((g, e, c + 1), sg, dtype=torch.long, device=x.device)
    idx_buf[gi, idx, pos_c] = si
    idx_buf = idx_buf[..., :c]

    # dispatch gather, expert-major: (E, G*c, d)
    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1).reshape(g * (sg + 1), d)
    rows = idx_buf + (sg + 1) * torch.arange(g, device=x.device)[:, None, None]
    dispatched = x_pad[rows.transpose(0, 1).reshape(e, g * c)]

    # expert FFN: one batched product per weight over the E experts
    h = F.silu(torch.bmm(dispatched, p["w_gate"])) * torch.bmm(dispatched, p["w_up"])
    eo = torch.bmm(h, p["w_down"]).reshape(e, g, c, d)

    # combine gather: each token reads its k slots, dropped ones times 0
    outs = eo[idx, gi, torch.clamp_max(pos_c, c - 1)]                 # (G,S,k,d)
    wk = (w * keep.float()).to(x.dtype)
    y = torch.einsum("gskd,gsk->gsd", outs, wk)

    if "shared" in p:
        y = y + L.swiglu_apply(p["shared"], xg)
    return y.reshape(b, s0, d), aux


def moe_apply_dense(p: Dict, x: torch.Tensor, spec: MoESpec,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference ``moe_apply`` is held against (``tests/test_moe.py``'s
    ``naive_moe``): every routed expert on every token of x (B, S, d),
    routed as one group, combined with ``route``'s top-k weights over the
    pairs ``keep`` (B*S, k) marks (all when None), plus the shared experts.
    It equals ``moe_apply`` where no slot drops, or, given its ``keep``, over
    the kept slots; it holds (B*S, E, d_expert) activations."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, idx, _ = route(p["router"], xt[None], spec)
    w, idx = w[0], idx[0]
    if keep is not None:
        w = w * keep
    h = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"]))
    h = h * torch.einsum("td,edf->tef", xt, p["w_up"])
    eo = torch.einsum("tef,efd->ted", h, p["w_down"])                   # (T, E, d)
    picked = torch.gather(eo, 1, idx[..., None].expand(-1, -1, d))     # (T, k, d)
    y = torch.einsum("tkd,tk->td", picked, w.to(x.dtype))
    if "shared" in p:
        y = y + L.swiglu_apply(p["shared"], xt)
    return y.reshape(b, s, d)
