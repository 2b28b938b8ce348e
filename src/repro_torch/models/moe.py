"""Mixture-of-Experts FFN: shared + fine-grained routed experts (DeepSeekMoE),
the gather formulation and the expert-parallel all-to-all.

The port of the JAX package's ``models/moe.py`` (``moe_params``,
``_capacity``, ``route``, ``moe_apply``, ``_local_dispatch``,
``moe_apply_a2a``), with its parameter tree and its routing, dropped slots
included. The gather formulation, ``moe_apply``:

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

Expert parallelism, ``moe_apply_a2a``, is JAX's ``shard_map`` block run by
every rank of a ``DeviceMesh`` on its own block of tokens (x sharded as
``P(data axes, "model", None)``) and its own ``E / M`` experts (M the size
of the ``model`` axis): route the local tokens over all E experts; send each
(token, choice) pair's row to the rank that owns its expert through a
buffer of ``cap`` rows a destination (``_local_dispatch``, first come first
served, in token-major order: token t's choice j is row ``t*k + j``), with
a meta buffer of (local expert, 1) beside it; all-to-all both over the
``model`` group; dispatch the received rows again by local expert into
``cap2`` rows each (1.1 of an even share); run the experts; gather the
outputs back into the received layout (rows not kept there times 0),
all-to-all them home, and combine each token's k rows (rows not kept at the
first dispatch times 0) with its router weights. A pair drops at either
dispatch. The aux loss is each rank's GShard loss over its tokens, then its
mean over ``model`` and over the data axes: each rank holds the same value,
whose cotangent each rank holds alike, so its backward is that cotangent
over the ranks, with no collective (``_MeanOver``). The all-to-alls are
``torch.distributed.nn.functional.all_to_all_single``, whose backward is
the reverse all-to-all. The router and the shared experts are replicated
and each rank's gradient of them is its own tokens' share: their local
views declare a ``Partial`` gradient over every mesh dim they are
replicated on, so the leaf's gradient is the sum over the mesh, JAX's; the
experts' gradient is ``Partial`` over the data axes alike.

``count_drops()`` counts the pairs ``moe_apply`` and ``moe_apply_a2a``
route and drop while it is entered, for a caller that wants a run's drop
share. A count is of calls: under ``cfg.remat`` a training step runs each
layer's MoE twice (the forward, then again in the backward, routing the
same pairs), so both counts double and the share is the step's. Under
``moe_apply_a2a`` each rank counts its own tokens' pairs and, as dropped,
its pairs not kept at the first dispatch and the received rows not kept at
the second: summed over the ranks, the world's.
``moe_apply_dense`` is the plain reference ``moe_apply`` is held against
(every expert on every token).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import randn
from repro_torch.configs.base import LMConfig, MoESpec
from repro_torch.distributed.sharding import is_dtensor
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
        return randn(shape, generator).mul_(std)

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
    outputs over each token's kept choices, plus the shared experts. On
    DTensors (a planned decode step) through ``_moe_apply_sharded``."""
    if is_dtensor(x):
        return _moe_apply_sharded(p, x, cfg)
    return _moe_apply(p, x, cfg)


def _moe_apply_sharded(p: Dict, x, cfg: LMConfig):
    """``moe_apply`` of DTensors, JAX's semantics (its groups and slots are
    the whole batch's): every rank routes all the tokens (x and the router
    gathered whole) and runs its own block of experts (their weights split
    over ``model`` on their expert dim, as the ``lm`` rules place them); the
    routed outputs are ``Partial`` over ``model``, summed where read, and
    the shared experts run as DTensor ops beside them. The aux loss is the
    same on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.mesh import mesh_shape
    mesh = x.device_mesh
    names = list(mesh_shape(mesh))
    whole = [Replicate()] * mesh.ndim
    m = names.index("model") if "model" in names else None
    ep = m is not None and cfg.moe.n_routed % mesh.size(m) == 0
    experts = [Shard(0) if ep and i == m else Replicate() for i in range(mesh.ndim)]
    routed = [Partial() if ep and i == m else Replicate() for i in range(mesh.ndim)]

    def local(xl, router, w_gate, w_up, w_down):
        lo = mesh.get_local_rank(m) * w_gate.shape[0] if ep else 0
        q = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        return _moe_apply(q, xl, cfg, expert_block=(lo, w_gate.shape[0]))

    args = [x, p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    args = [a if isinstance(a, DTensor) else DTensor.from_local(a, mesh, whole, run_check=False)
            for a in args]
    y, aux = local_map(local, out_placements=(routed, whole),
                       in_placements=(whole, whole, experts, experts, experts),
                       device_mesh=mesh, redistribute_inputs=True)(*args)
    if "shared" in p:
        y = y + L.swiglu_apply(p["shared"], x)
    return y, aux


def _moe_apply(p: Dict, x: torch.Tensor, cfg: LMConfig, expert_block=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on plain tensors. With ``expert_block`` = (first, n)
    the expert weights in ``p`` are those n experts only: the routing is
    over all of them, the FFN runs on the block, a pair routed elsewhere
    reads 0, and the shared experts are left to the caller."""
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
    if expert_block is not None:
        lo, n = expert_block
        dispatched = dispatched[lo:lo + n]
    h = F.silu(torch.bmm(dispatched, p["w_gate"])) * torch.bmm(dispatched, p["w_up"])
    eo = torch.bmm(h, p["w_down"])
    if expert_block is not None:
        eo = torch.cat([eo.new_zeros((lo, g * c, d)), eo,
                        eo.new_zeros((e - lo - n, g * c, d))])
    eo = eo.reshape(e, g, c, d)

    # combine gather: each token reads its k slots, dropped ones times 0
    outs = eo[idx, gi, torch.clamp_max(pos_c, c - 1)]                 # (G,S,k,d)
    wk = (w * keep.float()).to(x.dtype)
    y = torch.einsum("gskd,gsk->gsd", outs, wk)

    if "shared" in p and expert_block is None:
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


# ---------------------------------------------------------------------------
# Expert-parallel MoE with explicit all-to-all
# ---------------------------------------------------------------------------

def a2a_capacity(t: int, spec, m_size: int) -> Tuple[int, int]:
    """``moe_apply_a2a``'s buffer rows for ``t`` local tokens over ``m_size``
    ranks of "model": ``cap`` a destination rank (the first dispatch) and
    ``cap2`` a local expert (the second, 1.1 of an even share of the
    received rows), each a multiple of 8 and at least 8."""
    cap = max(8, int(math.ceil(t * spec.top_k * spec.capacity_factor / m_size / 8)) * 8)
    e_local = spec.n_routed // m_size
    return cap, max(8, int(math.ceil(m_size * cap * 1.1 / e_local / 8)) * 8)


def _local_dispatch(x: torch.Tensor, expert_ids: torch.Tensor, n_buckets: int, cap: int,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter rows of x (T, d) into (n_buckets, cap, d) by expert_ids,
    first-come-first-served capacity. Rows with valid=False neither occupy
    capacity nor get written. Returns (buffer, slot, kept): a row not kept
    has slot ``cap``. The buffer is a contiguous view (the collectives take
    it as it is); rows not kept are written to one spare row past it.

    The one-hot is laid out (n_buckets, T), transposed from JAX's, so that
    each bucket's running count scans its row's innermost dim: torch's scan
    along an outer dim runs one thread a column through all T rows (47 ms
    of a 61 ms deepseek-moe-16b layer at 8 x 2048 tokens on an H100)."""
    buckets = torch.arange(n_buckets, device=expert_ids.device)
    oh = (expert_ids[None, :] == buckets[:, None]).long()               # (M, T)
    if valid is not None:
        oh = oh * valid[None, :]
    pos = torch.cumsum(oh, dim=1) - oh                                 # exclusive
    slot = torch.gather(pos, 0, expert_ids[None, :])[0]
    kept = slot < cap
    if valid is not None:
        kept = kept & valid
    slot_c = torch.where(kept, slot, cap)
    row = torch.where(kept, expert_ids * cap + slot, n_buckets * cap)
    buf = x.new_zeros((n_buckets * cap + 1, x.shape[1])).index_put((row,), x)
    return buf[:-1].view(n_buckets, cap, x.shape[1]), slot_c, kept


class _MeanOver(torch.autograd.Function):
    """The mean over a process group of a scalar each rank holds, which
    every rank then holds alike (``lax.pmean``): an all-reduce forward; the
    backward gives each rank its alike cotangent over the group's size."""

    @staticmethod
    def forward(ctx, a, group):
        ctx.n = dist.get_world_size(group)
        total = a.detach().reshape(1).clone()
        dist.all_reduce(total, group=group)
        return total.reshape(()) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _local_block(t: torch.Tensor, spec, mesh, world: int) -> torch.Tensor:
    """A parameter leaf's block on this rank, placed by ``spec``: a DTensor
    leaf's local shard, whose gradient is declared ``Partial`` over the mesh
    dims it is replicated on (each rank's is its own tokens' share, and the
    leaf's is their sum); a plain tensor as it is on a mesh of one rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.sharding import placements
    if not isinstance(t, DTensor):
        if world > 1:
            raise ValueError("moe_apply_a2a on a mesh of more than one rank takes its "
                             "parameters as DTensors (sharding.distribute)")
        return t
    place = placements(spec, mesh)
    grad = [Partial() if isinstance(pl, Replicate) else pl for pl in place]
    return t.redistribute(mesh, place).to_local(grad_placements=grad)


def moe_apply_a2a(p: Dict, x, cfg: LMConfig, mesh, axis: str = "model"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux) over ``mesh`` (a ``DeviceMesh``): experts
    sharded over ``axis``, x a DTensor placed ``P(data axes, axis, None)``
    (sequence parallel; redistributed there if placed otherwise), or a
    plain tensor on a mesh of one rank. y comes back placed as x; aux is a
    plain scalar every rank holds. The parameters are DTensors (the
    experts sharded over ``axis`` on their expert dim, the router and the
    shared experts replicated), or plain tensors on a mesh of one rank."""
    import torch.distributed.nn.functional as dist_nn
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.mesh import data_axes, mesh_shape
    from repro_torch.distributed.sharding import P, placements

    spec = cfg.moe
    sizes = mesh_shape(mesh)
    world = math.prod(sizes.values())
    m_size = sizes[axis]
    if spec.n_routed % m_size:
        raise ValueError(f"{spec.n_routed} experts do not divide over {m_size} ranks")
    e_local = spec.n_routed // m_size
    dp = data_axes(mesh)
    x_place = placements(P(dp if len(dp) > 1 else dp[0], axis, None), mesh)
    if isinstance(x, DTensor):
        x_loc = x.redistribute(mesh, x_place).to_local()
    elif world > 1:
        raise ValueError("moe_apply_a2a on a mesh of more than one rank takes x as a "
                         "DTensor")
    else:
        x_loc = x
    router = _local_block(p["router"], P(None, None), mesh, world)
    w_gate, w_up, w_down = (_local_block(p[n], P(axis, None, None), mesh, world)
                            for n in ("w_gate", "w_up", "w_down"))
    shared = None
    if "shared" in p:
        shared = {n: _local_block(t, P(None, None), mesh, world) for n, t in p["shared"].items()}
    model_group = mesh.get_group(axis)

    def all_to_all(t):
        return dist_nn.all_to_all_single(torch.empty_like(t), t, group=model_group)

    b_loc, s_loc, d = x_loc.shape
    t = b_loc * s_loc
    k = spec.top_k
    xf = x_loc.reshape(t, d)
    # --- route (local tokens, global experts) ---
    w, idx, aux = route(router, xf[None], spec)
    w, idx = w[0], idx[0]                                               # (T, k)
    for group in (model_group, *(mesh.get_group(a) for a in dp)):
        aux = _MeanOver.apply(aux, group)

    # --- dispatch to owner ranks ---
    flat_e = idx.reshape(t * k)                                         # expert id
    dest = torch.div(flat_e, e_local, rounding_mode="floor")            # owner rank
    cap, cap2 = a2a_capacity(t, spec, m_size)
    x_rep = torch.repeat_interleave(xf, k, dim=0)                       # (T*k, d)
    send, slot, kept = _local_dispatch(x_rep, dest, m_size, cap)
    meta = torch.stack([flat_e % e_local, kept.long()], dim=1).to(torch.int32)
    send_meta = _local_dispatch(meta, dest, m_size, cap)[0]
    recv = all_to_all(send)                                             # (M, cap, d)
    recv_meta = torch.empty_like(send_meta)
    dist.all_to_all_single(recv_meta, send_meta, group=model_group)

    # --- local expert compute (second, local dispatch by expert) ---
    rx = recv.reshape(m_size * cap, d)
    rmeta = recv_meta.reshape(m_size * cap, 2).long()
    eid = torch.clamp_max(rmeta[:, 0], e_local - 1)
    rvalid = rmeta[:, 1] > 0
    ebuf, eslot, ekept = _local_dispatch(rx, eid, e_local, cap2, valid=rvalid)
    h = F.silu(torch.bmm(ebuf, w_gate)) * torch.bmm(ebuf, w_up)
    eo = torch.bmm(h, w_down)                                           # (E_l, cap2, d)
    # gather back into the recv layout; drop invalid + over-capacity
    back = eo[eid, torch.clamp_max(eslot, cap2 - 1)]
    back = (back * ekept[:, None].to(back.dtype)).reshape(m_size, cap, d)
    ret = all_to_all(back)                                              # (M, cap, d)
    for n in _open_counts:
        n.routed += t * k
        n._dropped.append(torch.count_nonzero(~kept) + torch.count_nonzero(rvalid & ~ekept))

    # --- combine: each token reads its k slots from its send buffer ---
    vals = ret[dest, torch.clamp_max(slot, cap - 1)]                    # (T*k, d)
    vals = (vals * kept[:, None].to(vals.dtype)).reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", vals, w.to(vals.dtype))
    if shared is not None:
        y = y + L.swiglu_apply(shared, xf)
    y = y.reshape(b_loc, s_loc, d)
    if isinstance(x, DTensor):
        y = DTensor.from_local(y, mesh, x_place, run_check=False)
    return y, aux
