"""Plain PyTorch versions of the port's kernels — the ground truth each
CUDA kernel is held to, and the route a CPU tensor takes.

Counterpart of ``repro.kernels.ref``.  Operands may be mixed-dtype (bf16
compute slices over fp32 masters); every contraction runs in fp32.
Outputs: forward ``y`` and ``p`` in x's dtype; backward ``dx`` in dy's
dtype and ``dB`` in fp32; merge ``W'`` in W's dtype; subspace-Adam
``b'/m'/v'`` in fp32.

``p = x V`` stays fp32 for the forward's ``Bᵀ`` product, as in the TPU
kernel (``repro/kernels/lowrank_forward.py``); the reference's XLA route
rounds ``p`` to x's dtype first, so the two agree exactly only in fp32.
"""
from __future__ import annotations

import torch


def lowrank_forward(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor, return_p: bool = False):
    """y = x W + (x V) Bᵀ.  x (M,K), w (K,N), v (K,r), b (N,r).  With
    ``return_p`` also p = x V (M, r) in x's dtype."""
    xf = x.float()
    p = xf @ v.float()
    y = (xf @ w.float() + p @ b.float().T).to(x.dtype)
    return (y, p.to(x.dtype)) if return_p else y


def lowrank_batch_forward(x: torch.Tensor, w: torch.Tensor,
                          v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[i]ᵀ.  x (batch,S,K), b (batch,N,r)."""
    xf = x.float()
    p = xf @ v.float()                                   # (batch, S, r)
    return (xf @ w.float() + p @ b.float().transpose(-1, -2)).to(x.dtype)


def lowrank_backward(dy: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     b: torch.Tensor, p: torch.Tensor):
    """(dx, dB) of y = x W + (x V) Bᵀ from dy (M,N) and p = x V (M,r):
    dx = dy Wᵀ + (dy B) Vᵀ in dy's dtype, dB = dyᵀ p in fp32."""
    dyf = dy.float()
    q = dyf @ b.float()
    dx = (dyf @ w.float().T + q @ v.float().T).to(dy.dtype)
    db = dyf.T @ p.to(dy.dtype).float()
    return dx, db


def lowrank_merge(w: torch.Tensor, v: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """W + V Bᵀ over any leading dims: w (..,K,N), v (..,K,r), b (..,N,r);
    fp32 accumulate, W's dtype out."""
    return (w.float() + v.float() @ b.float().transpose(-1, -2)).to(w.dtype)


def subspace_adam(b, g, m, v, *, lr, bc1, bc2, beta1, beta2, eps, wd):
    """Fused Adam-with-decay on the subspace variable B.

    b/m/v are the fp32 masters and moments; g may arrive in a reduced
    compute dtype (cast up once).  ``bc1``/``bc2`` are the bias
    corrections ``1 − β**step``; ``lr``, ``bc1`` and ``bc2`` may be
    Python numbers or 0-d tensors.  Outputs are always fp32.
    """
    g = g.float()
    b = b.float()
    m2 = beta1 * m.float() + (1 - beta1) * g
    v2 = beta2 * v.float() + (1 - beta2) * g * g
    delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * b
    return b - lr * delta, m2, v2
