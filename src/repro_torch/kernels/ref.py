"""Plain PyTorch versions of the port's kernels — the ground truth each
CUDA kernel is held to, and the route a CPU tensor takes.

Counterpart of ``repro.kernels.ref``.  Operands may be mixed-dtype (bf16
compute slices over fp32 masters); every contraction runs in fp32.
Outputs: forward ``y`` and ``p`` in x's dtype; backward ``dx`` in dy's
dtype and ``dB`` in fp32; merge ``W'`` in W's dtype; the projection
``Gᵀ V`` in fp32; subspace-Adam and
-Lion ``b'/m'/v'`` in fp32; the q8 variants ``b'`` in b's dtype (fp32 or
bf16), int8 moments and fp32 scales; the SSD intra-chunk block ``y`` in
x's dtype and its chunk end states in fp32.

Stochastic rounding (:func:`sr_bf16`) takes its noise from the caller:
``bits`` holds values in ``[0, 2**16)`` (int32 here, uint32 in the
reference; the same bit patterns).

``p = x V`` stays fp32 for the forward's ``Bᵀ`` product, as in the TPU
kernel (``repro/kernels/lowrank_forward.py``); the reference's XLA route
rounds ``p`` to x's dtype first, so the two agree exactly only in fp32.
The kernels' tensor-core route carries that fp32 ``p`` (and the
backward's ``q``) into bf16 operands as a (hi, lo) pair
(:func:`split_hi_lo`).
"""
from __future__ import annotations

import torch


def sr_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastically round fp32 ``x`` to bf16 with ``bits`` uniform over
    ``[0, 2**16)``: add them to the fp32 bit pattern and drop the low 16
    bits, so a value rounds up with probability equal to the dropped
    fraction (unbiased, unlike round to nearest)."""
    u = x.float().contiguous().view(torch.int32)
    u = (u + bits.to(torch.int32)) & -0x10000       # & 0xFFFF0000
    return u.view(torch.float32).to(torch.bfloat16)


def split_hi_lo(p: torch.Tensor):
    """fp32 ``p`` as two bf16 tensors, ``hi = bf16(p)`` and
    ``lo = bf16(p − hi)``, both rounded to nearest: ``hi + lo`` keeps 16
    significant bits, within 2⁻¹⁶·|p| of ``p``.  How the tensor-core
    route of the forward and backward kernels feeds the fp32 rank-r
    activations (``p = x V``, ``q = dy B``) to bf16 ``wgmma`` segments;
    :func:`lowrank_forward` and :func:`lowrank_backward` keep them in
    fp32."""
    pf = p.float()
    hi = pf.to(torch.bfloat16)
    return hi, (pf - hi.float()).to(torch.bfloat16)


def _requant(x: torch.Tensor):
    """Per-row absmax int8 requantization of (R, L) rows: (q, scale) with
    scale (R, 1) = absmax / 127 (a true division: a Python divisor would
    become a multiply by its reciprocal on CUDA), rounded half to
    even."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127.0, 127.0).to(torch.int8)
    return q, scale


def _requant_sqrt(x: torch.Tensor):
    """The sqrt codec (second moments): requant of ``sqrt(max(x, 0))``."""
    return _requant(torch.sqrt(torch.clamp(x, min=0.0)))


def _deq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def _deq_sqrt(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    y = q.float() * s
    return y * y


def _round_b(b_new: torch.Tensor, bits, dtype) -> torch.Tensor:
    if bits is not None:
        return sr_bf16(b_new, bits).to(dtype)
    return b_new.to(dtype)


def lowrank_forward(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor, return_p: bool = False):
    """y = x W + (x V) Bᵀ.  x (M,K), w (K,N), v (K,r), b (N,r).  With
    ``return_p`` also p = x V (M, r) in x's dtype."""
    xf = x.float()
    p = xf @ v.float()
    y = (xf @ w.float() + p @ b.float().T).to(x.dtype)
    return (y, p.to(x.dtype)) if return_p else y


def lowrank_batch_forward(x: torch.Tensor, w: torch.Tensor,
                          v: torch.Tensor, b: torch.Tensor,
                          rows: torch.Tensor | None = None) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[t]ᵀ.  x (batch,S,K); b (batch,N,r) and
    t = i, or with ``rows`` (batch,) a (T,N,r) stack and t = rows[i]
    (gathered first, then the same arithmetic)."""
    if rows is not None:
        b = b.index_select(0, rows)
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


def lowrank_merge_sr(w: torch.Tensor, v: torch.Tensor, b: torch.Tensor,
                     bits: torch.Tensor) -> torch.Tensor:
    """W + V Bᵀ stochastically rounded into bf16 with w-shaped ``bits``
    (bf16 stored weights under bf16 masters)."""
    acc = w.float() + v.float() @ b.float().transpose(-1, -2)
    return sr_bf16(acc, bits).to(w.dtype)


def lowrank_project(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """G_B = Gᵀ V over any leading dims: g (..,K,N), v (..,K,r) ->
    (..,N,r) in fp32 (GaLore's projection of a full gradient)."""
    return g.float().mT @ v.float()


def subspace_adam(b, g, m, v, *, lr, bc1, bc2, beta1, beta2, eps, wd):
    """Fused Adam-with-decay on the subspace variable B.

    m/v are the fp32 moments; b is the fp32 master or a bf16 one, and g
    may arrive in a reduced compute dtype (both cast up once).
    ``bc1``/``bc2`` are the bias corrections ``1 − β**step``; ``lr``,
    ``bc1`` and ``bc2`` may be Python numbers or 0-d tensors.  Outputs
    are always fp32.
    """
    g = g.float()
    b = b.float()
    m2 = beta1 * m.float() + (1 - beta1) * g
    v2 = beta2 * v.float() + (1 - beta2) * g * g
    delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * b
    return b - lr * delta, m2, v2


def subspace_lion(b, g, m, *, lr, beta1, beta2, wd):
    """Momentum-only Lion on B: ``b' = b − lr (sign(β1 m + (1−β1) g) +
    wd b)``, ``m' = β2 m + (1−β2) g``; b fp32 or bf16, g any compute
    dtype; outputs fp32."""
    g = g.float()
    b = b.float()
    m = m.float()
    u = torch.sign(beta1 * m + (1 - beta1) * g)
    return b - lr * (u + wd * b), beta2 * m + (1 - beta2) * g


def subspace_adam_q8(b, g, mq, ms, vq, vs, *, lr, bc1, bc2, beta1, beta2,
                     eps, wd, bits=None):
    """int8-state Adam over (R, L) blocks: mq/vq (R, L) int8 with ms/vs
    (R, 1) fp32 scales (m linear codec, v sqrt codec); b fp32 or bf16,
    b' in b's dtype, stochastically rounded when ``bits`` is given.
    Returns (b', mq', ms', vq', vs')."""
    g = g.float()
    bf = b.float()
    m2 = beta1 * _deq(mq, ms) + (1 - beta1) * g
    v2 = beta2 * _deq_sqrt(vq, vs) + (1 - beta2) * g * g
    delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * bf
    b2 = _round_b(bf - lr * delta, bits, b.dtype)
    mq2, ms2 = _requant(m2)
    vq2, vs2 = _requant_sqrt(v2)
    return b2, mq2, ms2, vq2, vs2


def subspace_lion_q8(b, g, mq, ms, *, lr, beta1, beta2, wd, bits=None):
    """int8-momentum Lion over (R, L) blocks; the
    :func:`subspace_adam_q8` contract minus v.  Returns (b', mq', ms')."""
    g = g.float()
    bf = b.float()
    m = _deq(mq, ms)
    u = torch.sign(beta1 * m + (1 - beta1) * g)
    b2 = _round_b(bf - lr * (u + wd * bf), bits, b.dtype)
    mq2, ms2 = _requant(beta2 * m + (1 - beta2) * g)
    return b2, mq2, ms2


def _ssd_decay(clog: torch.Tensor) -> torch.Tensor:
    """``L[b, i, j, h] = exp(clog_i - clog_j)`` for i >= j, else 0, from
    clog (BC,Q,H).  A masked pair (i < j) takes the exponential of -inf:
    its difference is positive and past 88.7 ``exp`` gives inf, which a
    ``where`` would drop from the value but not from the gradient (0 · inf
    = NaN).  No infinity is formed, so the values are those of the masked
    ``where`` and autograd through this is finite."""
    Q = clog.shape[1]
    diff = clog[:, :, None, :] - clog[:, None, :, :]        # (BC,Q,Q,H) i-j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=clog.device).tril()
    return torch.exp(diff.masked_fill(~mask[:, :, None], float("-inf")))


def ssd_intra_chunk(x, dt, da, b, c):
    """Mamba2 SSD intra-chunk block over BC = batch x chunks flattened.

    x (BC,Q,H,P); dt, da (BC,Q,H); b, c (BC,Q,H,N), heads already
    broadcast.  With ``clog = cumsum(da)`` over the chunk,
    ``y_i = sum_{j<=i} (C_i . B_j) exp(clog_i - clog_j) dt_j x_j`` (x's
    dtype) and the chunk's local end state
    ``sum_j exp(clog_last - clog_j) dt_j B_j x_jᵀ`` (BC,H,N,P) in fp32.
    """
    xf, dtf, daf, bf, cf = (t.float() for t in (x, dt, da, b, c))
    clog = torch.cumsum(daf, dim=1)                         # (BC,Q,H)
    L = _ssd_decay(clog)
    s = torch.einsum("bihn,bjhn->bijh", cf, bf)
    att = s * L * dtf[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", att, xf)
    wj = torch.exp(clog[:, -1:, :] - clog) * dtf            # (BC,Q,H)
    state = torch.einsum("bjhn,bjhp,bjh->bhnp", bf, xf, wj)
    return y.to(x.dtype), state


def ssd_intra_chunk_bwd(x, dt, da, b, c, dy, dstate):
    """The backward of :func:`ssd_intra_chunk`, as explicit formulas.

    x, dy (BC,Q,H,P); dt, da (BC,Q,H); b, c (BC,Q,G,N) **per B/C group**,
    head h reading group ``h // (H // G)``; dstate (BC,H,N,P).  Returns
    ``(dx, ddt, dda, db, dc)`` in fp32, db and dc per group (summed over
    the group's heads).  With ``clog = cumsum(da)``, ``L`` the masked
    decay, ``s = C Bᵀ``, ``att = s ⊙ L ⊙ dt_j`` and ``w_j = exp(clog_Q -
    clog_j) dt_j``:

    * ``datt = dY Xᵀ``; ``ds = datt ⊙ L ⊙ dt_j``; ``K = datt ⊙ s ⊙ L``
      and ``M = K ⊙ dt_j = ds ⊙ s``;
    * ``u = B dS`` (Q,P); ``dx = attᵀ dY + w ⊙ u``; ``dw_j = u_j · x_j``;
    * ``ddt_j = Σ_i K_ij + dw_j exp(clog_Q - clog_j)``;
    * ``dclog_i = Σ_j M_ij - Σ_j M_ji - dw_i w_i``, plus ``Σ_j dw_j w_j``
      at the last token; ``dda`` its reverse cumsum;
    * per group, ``D = Σ_h ds_h``: ``dC = D B``, ``dB = Dᵀ C + Σ_h w_h ⊙
      (X_h dS_hᵀ)``.

    The masked decay forms no infinity (:func:`_ssd_decay`), so a decay
    whose masked differences pass exp's range gives finite gradients,
    where autograd through the reference's ``where`` gives NaN.
    """
    xf, dtf, daf, bf, cf, dyf, dsf = (
        t.float() for t in (x, dt, da, b, c, dy, dstate))
    BC, Q, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bh = bf.repeat_interleave(rep, dim=2)                   # (BC,Q,H,N)
    ch = cf.repeat_interleave(rep, dim=2)
    clog = torch.cumsum(daf, dim=1)                         # (BC,Q,H)
    s = torch.einsum("bihn,bjhn->bijh", ch, bh)
    L = _ssd_decay(clog)                                    # 0 where i < j
    e = torch.exp(clog[:, -1:, :] - clog)                   # (BC,Q,H)
    w = e * dtf
    datt = torch.einsum("bihp,bjhp->bijh", dyf, xf)
    K = datt * s * L
    ds = datt * L * dtf[:, None, :, :]
    m = ds * s
    u = torch.einsum("bjhn,bhnp->bjhp", bh, dsf)            # B dS
    dx = torch.einsum("bijh,bihp->bjhp", s * L * dtf[:, None, :, :], dyf) \
        + w[..., None] * u
    dw = (u * xf).sum(-1)                                   # (BC,Q,H)
    ddt = K.sum(1) + dw * e
    dclog = m.sum(2) - m.sum(1) - dw * w
    dclog[:, -1] += (dw * w).sum(1)
    dda = torch.flip(torch.cumsum(torch.flip(dclog, (1,)), 1), (1,))
    dsum = ds.reshape(BC, Q, Q, G, rep).sum(-1)             # (BC,Q,Q,G)
    e_x = torch.einsum("bjhp,bhnp,bjh->bjhn", xf, dsf, w)   # w ⊙ X dSᵀ
    dc = torch.einsum("bijg,bjgn->bign", dsum, bf)
    db = torch.einsum("bijg,bign->bjgn", dsum, cf) \
        + e_x.reshape(BC, Q, G, rep, N).sum(3)
    return dx, ddt, dda, db, dc
