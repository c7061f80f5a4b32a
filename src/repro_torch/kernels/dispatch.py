"""Low-rank ops over any leading dimensions, routed by device.

Counterpart of ``repro.kernels.dispatch``: the public ops with the
reference's signatures and leading-dim folding — ``lowrank_forward``
(with ``return_p``), ``lowrank_batch_forward``, ``lowrank_backward``
(every leading axis contracted into ``dB``), ``lowrank_merge`` and
``lowrank_merge_sr`` (over leading dims, one launch per group),
``lowrank_project`` (GaLore's ``Gᵀ V``, over leading dims, one launch
per group),
``subspace_adam`` and ``subspace_lion`` (leading dims folded into rows,
one launch per group) and ``subspace_adam_q8`` / ``subspace_lion_q8``
(the whole buffer tiled into ``(R, qblock)`` rows, a ragged last row
zero-padded, one launch per group).  The route is the tensor's
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
import torch.nn.functional as F

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
                          v: torch.Tensor, b: torch.Tensor,
                          rows: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[t]ᵀ — one call, one adapter per row.

    The multi-tenant serving op: ``x (batch, seq, k)`` against a shared
    base ``w (k, n)`` and projection ``v (k, r)``, and either a per-row
    stack ``b (batch, n, r)`` (t = i) or, with ``rows (batch,)``, the
    adapter store's ``(T, n, r)`` stack read by tenant index
    (t = rows[i]; nothing is gathered).  ``W + V Bᵀ`` is never formed.
    """
    return _lf.lowrank_batch_forward(x.contiguous(), w, v, b, rows)


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


def lowrank_merge_sr(w: torch.Tensor, v: torch.Tensor, b: torch.Tensor,
                     bits: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W + V Bᵀ stochastically rounded into a bf16 W: the
    :func:`lowrank_merge` contract plus ``bits`` (w-shaped, values in
    ``[0, 2**16)``) feeding the unbiased round — the merge under bf16
    masters, so the once-per-``lazy_k`` merge accumulates no
    round-to-nearest bias across outer cycles."""
    return _lu.lowrank_merge(w, v, b, out=out,
                             bits=bits.to(torch.int32))


def lowrank_project(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Gᵀ V (.., N, r) in fp32 over any leading (group/layer) dims of g
    (.., K, N) and v (.., K, r): GaLore's projection of the full
    gradient onto its basis.  g and v may differ in dtype (an fp32
    gradient and a basis stored in the compute dtype); the product
    accumulates in fp32 either way."""
    return _lu.lowrank_project(g, v)


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


def lion_scalars(lr, device) -> torch.Tensor:
    """``(lr,)`` as one (1,) fp32 tensor on ``device`` (the Lion kernels
    read only the LR)."""
    return torch.as_tensor(lr, dtype=torch.float32,
                           device=device).reshape(1)


def subspace_lion(b: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                  lr, beta1: float = 0.9, beta2: float = 0.99,
                  wd: float = 0.0):
    """Fused momentum-only Lion on stacked subspace variables: the
    :func:`subspace_adam` contract minus v (b fp32 or bf16, m fp32, g any
    compute dtype).  Returns (b', m') fp32 with the input shape."""
    return _sa.subspace_lion(b.contiguous(), g.contiguous(), m.contiguous(),
                             lion_scalars(lr, b.device), beta1=beta1,
                             beta2=beta2, wd=wd)


# --- int8 block-quantized state ---------------------------------------------
#
# The whole flattened buffer is tiled into (R, qblock) rows, one
# quantization block (and one fp32 scale) per row.  The public functions
# take LOGICAL shapes — b/g/mq/vq the state's (..., n, r), ms/vs the flat
# (R,) scale vectors of ``optim.quant`` — and own the tiling both ways.

def _to_blocks(a: torch.Tensor, R: int, L: int) -> torch.Tensor:
    flat = a.reshape(-1)
    pad = R * L - flat.shape[0]
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(R, L)


def _unblock(a: torch.Tensor, shape, size: int) -> torch.Tensor:
    return a.reshape(-1)[:size].reshape(shape)


def _rows(b: torch.Tensor, qblock: int) -> int:
    return max(1, -(-b.numel() // qblock))


def subspace_adam_q8(b: torch.Tensor, g: torch.Tensor, mq: torch.Tensor,
                     ms: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor, *,
                     lr, step, beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, wd: float = 0.0, qblock: int = 128,
                     bits: Optional[torch.Tensor] = None):
    """Fused Adam with int8 block-quantized moments.

    b/g/mq/vq share the logical state shape (..., n, r) — b the fp32 or
    bf16 master, g any compute dtype, mq/vq int8; ms/vs are (R,) fp32
    absmax scales (R = ceil(size / qblock)).  ``bits`` (b-shaped, values
    in [0, 2**16)) stochastically rounds b' (bf16 values in b's dtype).
    Returns (b', mq', ms', vq', vs').
    """
    shape, size, R = b.shape, b.numel(), _rows(b, qblock)
    nb, nmq, nms, nvq, nvs = _sa.subspace_adam_q8(
        _to_blocks(b, R, qblock), _to_blocks(g, R, qblock),
        _to_blocks(mq, R, qblock), ms.reshape(R),
        _to_blocks(vq, R, qblock), vs.reshape(R),
        adam_scalars(lr, step, beta1, beta2, b.device),
        beta1=beta1, beta2=beta2, eps=eps, wd=wd,
        bits=None if bits is None
        else _to_blocks(bits.to(torch.int32), R, qblock))
    return (_unblock(nb, shape, size), _unblock(nmq, shape, size), nms,
            _unblock(nvq, shape, size), nvs)


def subspace_lion_q8(b: torch.Tensor, g: torch.Tensor, mq: torch.Tensor,
                     ms: torch.Tensor, *, lr, beta1: float = 0.9,
                     beta2: float = 0.99, wd: float = 0.0, qblock: int = 128,
                     bits: Optional[torch.Tensor] = None):
    """Fused Lion with int8 block-quantized momentum — the
    :func:`subspace_adam_q8` contract minus v.  Returns (b', mq', ms')."""
    shape, size, R = b.shape, b.numel(), _rows(b, qblock)
    nb, nmq, nms = _sa.subspace_lion_q8(
        _to_blocks(b, R, qblock), _to_blocks(g, R, qblock),
        _to_blocks(mq, R, qblock), ms.reshape(R),
        lion_scalars(lr, b.device), beta1=beta1, beta2=beta2, wd=wd,
        bits=None if bits is None
        else _to_blocks(bits.to(torch.int32), R, qblock))
    return _unblock(nb, shape, size), _unblock(nmq, shape, size), nms
