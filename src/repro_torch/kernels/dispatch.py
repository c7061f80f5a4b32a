"""Low-rank ops over any leading dimensions, routed by device.

Counterpart of ``repro.kernels.dispatch`` for the serving slice: the
public ``lowrank_forward`` and ``lowrank_batch_forward`` with the
reference's shape contract.  The route is the tensor's device alone — a
CPU tensor takes the plain version, a CUDA tensor the kernel (see
:mod:`.lowrank_forward`).  There is no environment knob and no ``auto``
route that would prefer the plain version on a CUDA tensor.

Only the activation ``x`` is folded (and made contiguous, a no-op on the
model's path).  ``w``, ``v`` and ``b`` go to the wrapper as they are, so
it refuses a non-contiguous weight instead of copying it on every call.
"""
from __future__ import annotations

import torch

from . import lowrank_forward as _lf


def lowrank_forward(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """y = x W + (x V) Bᵀ over arbitrary leading dims of x; y in x's
    dtype, accumulated in fp32."""
    lead = x.shape[:-1]
    y = _lf.lowrank_forward(x.reshape(-1, x.shape[-1]).contiguous(), w, v,
                            b)
    return y.reshape(lead + (w.shape[1],))


def lowrank_batch_forward(x: torch.Tensor, w: torch.Tensor,
                          v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[i]ᵀ — one call, one adapter per row.

    The multi-tenant serving op: ``x (batch, seq, k)`` against a shared
    base ``w (k, n)`` and projection ``v (k, r)`` and a per-row stack
    ``b (batch, n, r)``.  ``W + V Bᵀ`` is never formed.
    """
    return _lf.lowrank_batch_forward(x.contiguous(), w, v, b)
