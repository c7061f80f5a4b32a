"""Low-rank-aware linear primitive (forward only).

Counterpart of ``repro.models.linear``.  Every matmul weight is consumed
through :func:`linear`.  A weight packed with its adapter evaluates

    y = x W + (x V) Bᵀ,        W: (k, n_out), V: (k, r), B: (n_out, r)

through :mod:`repro_torch.kernels.dispatch` — the merge ``W + V Bᵀ`` is
never formed.  The ``autograd.Function`` with the ``p = x V`` residual
arrives with the training slice.
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

    ``w``: lead + (k, n_out); ``v``: lead + (k, r);
    ``b``: lead + (batch, n_out, r) — row ``i`` of the batch is answered
    with adapter ``b[..., i, :, :]``.
    """

    __slots__ = ()


def linear(x: torch.Tensor, p, bias: Optional[torch.Tensor] = None):
    """Apply a (possibly packed) linear map."""
    if isinstance(p, BatchLRPack):
        y = dispatch.lowrank_batch_forward(x, p.w, p.v, p.b)
    elif isinstance(p, LRPack):
        y = dispatch.lowrank_forward(x, p.w, p.v, p.b)
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
