"""Mixture-of-Experts FFN with fixed-capacity sort-based dispatch.

Counterpart of ``repro.models.moe`` (qwen3-moe-30b-a3b).  Expert weights
are stacked ``(E, k, n)``; each of the ``T`` tokens picks its ``top_k``
experts from an fp32 router, and each expert takes at most ``C =
_capacity(T, top_k, E, capacity_factor)`` of them, in token order
(a stable sort of the token-major expert ids).  A (token, slot) pair past
its expert's capacity is dropped: its expert output is zero, and the
token's residual stream passes through (Switch semantics).  Every shape
is static, and nothing here reads a value on the host, so a decode step
stays free of host syncs:

* JAX's scatter with ``mode="drop"`` becomes a write into an ``(E, C +
  1)`` table whose last column takes the dropped pairs and is cut off;
* the kept slots per expert (the load-balance term) are counted with
  ``index_add_``, not ``bincount``.

The dispatch (token rows into expert slots) and the combine (expert
slots back into (token, slot) pairs) are row gathers whose backward is
a gather too (:class:`_Gather`): each token sums the gradients of its
``top_k`` slots in slot order, so a training step's gradients repeat
bit for bit (``index_select``'s backward, an ``index_add_``, sums a
token's slots with CUDA atomics in a varying order).  The gradient
reaches the router (through ``top_w`` and, in ``lb_loss``, through the
mean of ``probs``) and an :class:`LRPack`'s ``b``, never ``w`` or ``v``.

``expert_mm`` takes a plain ``(E, k, n)`` tensor, an :class:`LRPack`
(``(E, k, r)`` V, ``(E, n, r)`` B: one adapter, the prefill) or a
:class:`BatchLRPack` with ``rows`` (the decode step): its ``b`` is the
adapter store's ``(E, T, n, r)`` stack and slot ``(e, c)`` is answered
with ``b[e, rows[min(table[e, c] // S, batch - 1)]]``, as the reference
answers it.  The port reads that stack in place: one product per tenant
slot of the store, each over the view ``b[:, t]`` with ``p = h V``
masked to the slots of that tenant, so no step copies a ``B``.
``W + V Bᵀ`` is never formed.  The expert products are library calls
(``torch.bmm``), as the reference's are ``jnp.einsum`` outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .linear import BatchLRPack, LRPack, linear, weight_of


class Routing(NamedTuple):
    """The router's decision for ``T`` tokens (``k = top_k`` slots each).

    ``logits``/``probs``: ``(T, E)`` fp32; ``top_w``/``top_idx``: ``(T,
    k)``, descending; ``flat_e``: ``(T k,)`` token-major expert ids;
    ``pos``: ``(T k,)`` place of each pair in its expert's queue;
    ``keep``: ``pos < C``; ``table``: ``(E, C)`` token id of each
    expert slot, ``T`` (the appended zero row) where empty.
    """
    logits: torch.Tensor
    probs: torch.Tensor
    top_w: torch.Tensor
    top_idx: torch.Tensor
    flat_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    table: torch.Tensor


def _capacity(tokens: int, k: int, n_experts: int, cf: float) -> int:
    c = int(-(-tokens * k * cf // n_experts))  # ceil
    return max(4, -(-c // 4) * 4)              # pad to multiple of 4


def route(xf: torch.Tensor, router_w, top_k: int, capacity: int,
          norm_topk: bool = True) -> Routing:
    """Top-k routing of ``xf`` (T, d) in fp32 and each kept pair's expert
    slot (see :class:`Routing`)."""
    T = xf.shape[0]
    w = weight_of(router_w)
    E = w.shape[-1]
    k = top_k
    dev = xf.device
    logits = linear(xf.float(), w.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_idx.reshape(-1)
    n = T * k
    ar = torch.arange(n, device=dev)
    sorted_e, order = torch.sort(flat_e, stable=True)
    grp_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos = torch.empty_like(flat_e).scatter_(0, order,
                                            ar - grp_start[sorted_e])
    keep = pos < capacity
    # dropped pairs land in column C, which is cut off
    table = torch.full((E, capacity + 1), T, dtype=torch.long, device=dev)
    col = torch.where(keep, pos, capacity)
    table.view(-1).scatter_(0, flat_e * (capacity + 1) + col, ar // k)
    return Routing(logits, probs, top_w, top_idx, flat_e, pos, keep,
                   table[:, :capacity])


class _Gather(torch.autograd.Function):
    """``rows = cat(src, 0)[idx]``: rows of ``src`` (n, d), where the
    index ``n`` reads a zero row.  ``inv`` (n, m) lists, for each row of
    ``src``, the output rows that read it (``len(idx)`` for none); the
    backward sums ``cat(grad, 0)[inv[i, j]]`` over j in order, with no
    atomics."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        pad = torch.cat([src, src.new_zeros((1, src.shape[1]))])
        return pad.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        rows = pad.index_select(0, inv.reshape(-1))
        return rows.reshape(inv.shape + (-1,)).sum(1), None, None


def _per_tenant(p: torch.Tensor, tenant: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``y[e, c] = p[e, c] B[e, tenant[e, c]]ᵀ`` from the ``(E, T, n, r)``
    stack read in place: one product per tenant slot over the view
    ``b[:, t]``, with ``p`` zeroed off that tenant's expert slots."""
    out = None
    for t in range(b.shape[1]):
        pt = p * (tenant == t).unsqueeze(-1).to(p.dtype)
        y = torch.bmm(pt, b[:, t].transpose(1, 2))
        out = y if out is None else out + y
    return out


def expert_mm(h: torch.Tensor, w, table: torch.Tensor, seq: int,
              batch: int) -> torch.Tensor:
    """``h`` (E, C, k) through every expert's weight ``w`` -> (E, C, n).

    ``table`` (E, C), ``seq`` and ``batch`` place each slot's token in
    its batch row, for the per-row adapters of a :class:`BatchLRPack`."""
    if not isinstance(w, LRPack):
        return torch.bmm(h, w)
    p = torch.bmm(h, w.v)                                    # (E, C, r)
    base = torch.bmm(h, w.w)
    if isinstance(w, BatchLRPack):
        # sentinel slots (table == T) gathered the zero row, so p is zero
        # there and the clamped row pick does not matter
        row = torch.clamp(table // seq, max=batch - 1)
        tenant = row if w.rows is None else w.rows[row]
        return base + _per_tenant(p, tenant, w.b)
    return base + torch.bmm(p, w.b.transpose(1, 2))


def moe_ffn(x: torch.Tensor, router_w, w_gate, w_up, w_down, *,
            top_k: int, capacity_factor: float = 1.25,
            norm_topk: bool = True, groups: int = 1):
    """Top-k routed SwiGLU expert FFN.

    x: (B, S, d); router_w: (d, E) fp32; w_gate/w_up: (E, d, f) and
    w_down: (E, f, d), each plain or packed.  Returns ``(y (B, S, d),
    aux)`` with ``aux = {"lb_loss", "router_z"}`` (the Switch
    load-balance term over the kept pairs, and the router's z-loss).
    """
    if groups > 1:
        raise NotImplementedError(
            "moe_ffn: grouped dispatch (moe_groups > 1, one group per "
            "data-parallel shard) is not ported to repro_torch; see "
            "ROADMAP.md Queue 1 item 10")
    B, S, d = x.shape
    T = B * S
    E = weight_of(router_w).shape[-1]
    k = top_k
    C = _capacity(T, k, E, capacity_factor)
    xf = x.reshape(T, d)
    r = route(xf, router_w, k, C, norm_topk)

    # each pair's expert slot (E C: dropped) and each slot's pair (T k:
    # empty), the two index maps of the dispatch and the combine
    n = T * k
    slot = torch.where(r.keep, r.flat_e * C + r.pos, E * C)
    pair = torch.full((E * C + 1,), n, dtype=torch.long, device=x.device)
    pair.scatter_(0, slot, torch.arange(n, device=x.device))
    pair = pair[:E * C]
    gathered = _Gather.apply(xf, r.table.reshape(-1),
                             slot.reshape(T, k)).reshape(E, C, d)
    g = expert_mm(gathered, w_gate, r.table, S, B)
    u = expert_mm(gathered, w_up, r.table, S, B)
    y_e = expert_mm(F.silu(g) * u, w_down, r.table, S, B)    # (E, C, d)

    # combine: each (token, slot) pair's expert output (zero where the
    # pair was dropped), weighted, summed
    val = _Gather.apply(y_e.reshape(E * C, d), slot, pair.reshape(-1, 1))
    val = val * r.top_w.reshape(-1, 1).to(val.dtype)
    y = val.reshape(T, k, d).sum(1)

    me = r.probs.mean(0)
    ce = torch.zeros_like(me).index_add_(
        0, r.flat_e, r.keep.to(me.dtype)) / max(T * k, 1)
    lb_loss = E * (me * ce).sum()
    router_z = torch.logsumexp(r.logits, dim=-1).square().mean()
    return y.reshape(B, S, d).to(x.dtype), {"lb_loss": lb_loss,
                                            "router_z": router_z}
