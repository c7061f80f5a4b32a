"""Low-rank-aware linear primitive.

Counterpart of ``repro.models.linear``.  Every matmul weight is consumed
through :func:`linear`.  A weight packed with its adapter evaluates

    y = x W + (x V) Bᵀ,        W: (k, n_out), V: (k, r), B: (n_out, r)

through :mod:`repro_torch.kernels.dispatch` — the merge ``W + V Bᵀ`` is
never formed.  When a gradient is wanted, :class:`LowRankMatmul` (the
counterpart of the reference's ``custom_vjp`` ``lowrank_matmul``) keeps
only ``p = x V`` from the forward and computes ``dx`` and ``dB`` in one
fused backward; ``W`` and ``V`` get no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dispatch


class LRPack:
    """A weight packed with one adapter for the whole batch.

    ``w``: lead + (k, n_out); ``b``: lead + (n_out, r); ``v``: lead +
    (k, r).  Indexing takes the same leading slice of all three (a layer
    of a scan-stacked leaf).
    """

    __slots__ = ("w", "b", "v")

    def __init__(self, w, b, v):
        self.w, self.b, self.v = w, b, v

    def __getitem__(self, i):
        return type(self)(self.w[i], self.b[i], self.v[i])

    def __repr__(self):
        return (f"{type(self).__name__}(w={tuple(self.w.shape)}, "
                f"b={tuple(self.b.shape)}, v={tuple(self.v.shape)})")


class BatchLRPack(LRPack):
    """A shared weight packed with one adapter per batch row.

    ``w``: lead + (k, n_out); ``v``: lead + (k, r).  Without ``rows``,
    ``b`` is lead + (batch, n_out, r) and row ``i`` of the batch is
    answered with adapter ``b[..., i, :, :]``.  With ``rows`` (a
    ``(batch,)`` int64 tensor), ``b`` is lead + (T, n_out, r) — the
    adapter store's stack as it is — and row ``i`` is answered with
    ``b[..., rows[i], :, :]``.  Indexing takes the same leading slice of
    ``w``, ``b`` and ``v``; ``rows`` is the same for every slice.
    """

    __slots__ = ("rows",)

    def __init__(self, w, b, v, rows=None):
        super().__init__(w, b, v)
        self.rows = rows

    def __getitem__(self, i):
        return type(self)(self.w[i], self.b[i], self.v[i], self.rows)


class LowRankMatmul(torch.autograd.Function):
    """y = x W + (x V) Bᵀ with the projected-residual backward.

    The forward saves only ``(p, w, b, v)`` — ``p = x V`` (x's dtype) is
    the one saved activation.  The backward returns ``dx`` and ``dB``,
    the latter rounded to B's dtype as the reference does
    (``db.astype(b.dtype)``): with a bf16 view of the fp32 master, the
    master's gradient is a bf16-rounded ``dB`` cast back up.
    """

    @staticmethod
    def forward(ctx, x, w, b, v):
        y, p = dispatch.lowrank_forward(x, w, v, b, return_p=True)
        ctx.save_for_backward(p, w, b, v)
        return y

    @staticmethod
    def backward(ctx, dy):
        p, w, b, v = ctx.saved_tensors
        dx, db = dispatch.lowrank_backward(dy, w, v, b, p)
        return dx, None, db.to(b.dtype), None


def lowrank_matmul(x, w, b, v):
    """y = x W + (x V) Bᵀ; differentiable in x and b when a gradient is
    wanted, else the plain forward (serving: no ``p`` is written)."""
    if torch.is_grad_enabled() and (x.requires_grad or b.requires_grad):
        return LowRankMatmul.apply(x, w, b, v)
    return dispatch.lowrank_forward(x, w, v, b)


def linear(x: torch.Tensor, p, bias: Optional[torch.Tensor] = None):
    """Apply a (possibly packed) linear map."""
    if isinstance(p, BatchLRPack):
        y = dispatch.lowrank_batch_forward(x, p.w, p.v, p.b, p.rows)
    elif isinstance(p, LRPack):
        y = lowrank_matmul(x, p.w, p.b, p.v)
    else:
        y = x @ p
    if bias is not None:
        y = y + bias
    return y


def weight_of(p) -> torch.Tensor:
    """The base weight regardless of packing (for shape queries)."""
    return p.w if isinstance(p, LRPack) else p


def effective_weight(p):
    """Materialised ``W + V Bᵀ`` in fp32, cast to W's dtype (the merged
    reference that lazy serving is held to)."""
    if isinstance(p, LRPack) and not isinstance(p, BatchLRPack):
        vbt = p.v.float() @ p.b.float().transpose(-1, -2)
        return (p.w.float() + vbt).to(p.w.dtype)
    return p


def pack_tree(params, lowrank):
    """Zip a param tree with a same-structure lowrank tree.

    ``lowrank`` leaves are either ``None`` (dense leaf — passes through)
    or a dict ``{"b": (n_out, r), "v": (k, r)}``.
    """
    if lowrank is None:
        return params
    if isinstance(lowrank, dict) and set(lowrank) == {"b", "v"}:
        return LRPack(params, lowrank["b"], lowrank["v"])
    return {k: pack_tree(params[k], lowrank[k]) for k in params}
