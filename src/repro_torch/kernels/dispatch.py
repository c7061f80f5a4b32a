"""Low-rank ops over any leading dimensions, routed by device.

Counterpart of ``repro.kernels.dispatch``: the public ops with the
reference's signatures and leading-dim folding — ``lowrank_forward``
(with ``return_p``), ``lowrank_batch_forward``, ``lowrank_backward``
(every leading axis contracted into ``dB``), ``lowrank_merge`` (over
leading dims, one launch per group) and ``subspace_adam`` (leading dims
folded into rows, one launch per group).  The route is the tensor's
device alone — a CPU tensor takes the plain version, a CUDA tensor the
kernel (see the wrapper modules).  There is no environment knob and no
``auto`` route that would prefer the plain version on a CUDA tensor.

The reference's TPU lane packing (``PackSpec``/``rank_pack_plan``) has
no counterpart: the Adam kernel runs one flat launch over a group
buffer, whatever its rank.

Only the activations (``x``, ``dy``, ``p``) are folded (and made
contiguous, a no-op on the model's path).  Weights go to the wrappers as
they are, so a wrapper refuses a non-contiguous weight instead of
copying it on every call.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import lowrank_backward as _lb
from . import lowrank_forward as _lf
from . import lowrank_update as _lu
from . import subspace_adam as _sa


def lowrank_forward(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor, *, return_p: bool = False):
    """y = x W + (x V) Bᵀ over arbitrary leading dims of x; y in x's
    dtype, accumulated in fp32.  ``return_p=True`` also returns
    p = x V (lead + (r,), x's dtype), the backward's only residual."""
    lead = x.shape[:-1]
    out = _lf.lowrank_forward(x.reshape(-1, x.shape[-1]).contiguous(), w,
                              v, b, return_p=return_p)
    if not return_p:
        return out.reshape(lead + (w.shape[1],))
    y, p = out
    return y.reshape(lead + (w.shape[1],)), p.reshape(lead + (v.shape[1],))


def lowrank_batch_forward(x: torch.Tensor, w: torch.Tensor,
                          v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[i]ᵀ — one call, one adapter per row.

    The multi-tenant serving op: ``x (batch, seq, k)`` against a shared
    base ``w (k, n)`` and projection ``v (k, r)`` and a per-row stack
    ``b (batch, n, r)``.  ``W + V Bᵀ`` is never formed.
    """
    return _lf.lowrank_batch_forward(x.contiguous(), w, v, b)


def lowrank_backward(dy: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     b: torch.Tensor, p: torch.Tensor):
    """(dx, dB) for y = x W + (x V) Bᵀ, from dy and the residual p = x V.

    dx has dy's leading dims + (K,) in dy's dtype; dB is (N, r) fp32 with
    every leading (batch/seq) axis contracted."""
    lead = dy.shape[:-1]
    N, r = dy.shape[-1], v.shape[-1]
    dx, db = _lb.lowrank_backward(dy.reshape(-1, N).contiguous(), w, v, b,
                                  p.reshape(-1, r).contiguous())
    return dx.reshape(lead + (w.shape[0],)), db


def lowrank_merge(w: torch.Tensor, v: torch.Tensor, b: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W + V Bᵀ in fp32 over any leading (group/layer) dims, W's dtype out.

    V may be a reduced-precision draw and B the fp32 master — the delta
    accumulates in fp32 either way, so the stored weight never sees a
    double rounding.  ``out=w`` merges in place (the training loop's
    use: the grouped master buffer is updated where it lies).
    """
    return _lu.lowrank_merge(w, v, b, out=out)


def adam_scalars(lr, step, beta1: float, beta2: float,
                 device) -> torch.Tensor:
    """``(lr, 1 − β1**step, 1 − β2**step)`` as one (3,) fp32 tensor on
    ``device``; ``lr`` and ``step`` may be numbers or 0-d tensors (a
    device tensor keeps the step free of host round trips)."""
    f32 = dict(dtype=torch.float32, device=device)
    stepf = torch.as_tensor(step, **f32)
    return torch.stack([torch.as_tensor(lr, **f32),
                        1.0 - beta1 ** stepf, 1.0 - beta2 ** stepf])


def subspace_adam(b: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, *, lr, step, beta1: float = 0.9,
                  beta2: float = 0.999, eps: float = 1e-8,
                  wd: float = 0.0):
    """Fused Adam on stacked subspace variables.

    b/m/v share shape (..., n, r) in fp32 (masters and moments, never
    downcast); g may arrive in the compute dtype and is cast up in the
    kernel.  Leading (group/layer) dims fold into rows, so ONE launch
    covers a whole group of same-shape B leaves.  Returns (b', m', v')
    with the input shape.
    """
    scalars = adam_scalars(lr, step, beta1, beta2, b.device)
    return _sa.subspace_adam(b.contiguous(), g.contiguous(), m.contiguous(),
                             v.contiguous(), scalars, beta1=beta1,
                             beta2=beta2, eps=eps, wd=wd)
