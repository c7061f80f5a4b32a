"""Plain PyTorch versions of the low-rank forward — the ground truth the
CUDA kernel is held to, and the route a CPU tensor takes.

Counterpart of ``repro.kernels.ref``.  Every contraction runs in fp32 and
the output is cast to x's dtype.  ``p = x V`` stays fp32 for the ``Bᵀ``
product, as in the TPU kernel (``repro/kernels/lowrank_forward.py``); the
reference's XLA route rounds ``p`` to x's dtype first, so the two agree
exactly only in fp32.
"""
from __future__ import annotations

import torch


def lowrank_forward(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """y = x W + (x V) Bᵀ.  x (M,K), w (K,N), v (K,r), b (N,r)."""
    xf = x.float()
    return (xf @ w.float() + (xf @ v.float()) @ b.float().T).to(x.dtype)


def lowrank_batch_forward(x: torch.Tensor, w: torch.Tensor,
                          v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[i]ᵀ.  x (batch,S,K), b (batch,N,r)."""
    xf = x.float()
    p = xf @ v.float()                                   # (batch, S, r)
    return (xf @ w.float() + p @ b.float().transpose(-1, -2)).to(x.dtype)
