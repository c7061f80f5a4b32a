"""Attention: blockwise prefill (causal, or bidirectional for the
encoder), paged decode, and MLA's absorbed paged decode.

Counterpart of ``repro.models.attention``.  Plain PyTorch ops that keep
the reference's arithmetic — scores and the online softmax in fp32,
probabilities cast to V's dtype before the PV product — so the parity
tests compare like with like.  Attention is not a TPU kernel in the
reference, and no fused library attention is used here.

Layout conventions (as in the reference):
  q: (B, Sq, Hq, D)   k: (B, Skv, Hkv, D)   v: (B, Skv, Hkv, Dv)
Paged arenas: (n_pages, page, H, D); a sequence's token t lives at
``arena[page_table[b, t // page], t % page]``.  MLA's arenas hold the
compressed ``c_kv`` and the roped ``k_rope``: (n_pages, page, 1, kvl)
and (n_pages, page, 1, rope).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024,
                        softmax_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Online-softmax attention over query and key chunks (the prefill
    path of the reference's ``blockwise_attention``), causal unless
    ``causal=False`` (every query sees every key, as the encoder's).
    ``q_offset`` is the absolute position of q[0]."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    Sq0, Skv0 = Sq, Skv
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % qc:
        q = F.pad(q, (0, 0, 0, 0, 0, qc - Sq % qc))
        Sq = q.shape[1]
    if Skv % kc:
        pad = kc - Skv % kc
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        Skv = k.shape[1]
    dev = q.device
    outs = []
    for qi in range(Sq // qc):
        qblk = q[:, qi * qc:(qi + 1) * qc].reshape(B, qc, Hkv, G, D)
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        acc = torch.zeros((B, qc, Hkv, G, Dv), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, qc, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, qc, Hkv, G), dtype=torch.float32, device=dev)
        for ki in range(Skv // kc):
            kblk = k[:, ki * kc:(ki + 1) * kc]
            vblk = v[:, ki * kc:(ki + 1) * kc]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk.float(),
                             kblk.float()) * scale
            kpos = ki * kc + torch.arange(kc, device=dev)
            mask = (kpos < Skv0)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vblk.dtype).float(),
                vblk.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).reshape(B, qc, Hq, Dv))
    return torch.cat(outs, dim=1)[:, :Sq0]


def paged_write(arena: torch.Tensor, new: torch.Tensor,
                page_table: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Write one new token per batch slot into a paged arena, in place.

    arena: (n_pages, page, H, D); new: (B, 1, H, D) or (B, H, D);
    page_table: (B, max_pages) int, -1 = unmapped; lengths: (B,) — the
    new token lands at position ``lengths[b]``.  Slots whose target page
    is unmapped (inactive rows) are dropped.  Returns ``arena``.

    The write stays on the device (no host sync): a dropped slot is
    redirected to the first mapped slot's target and carries that slot's
    value, so it writes what is written there anyway.  When no slot is
    mapped, every slot writes back what row 0's clamped target already
    holds.
    """
    if new.ndim == 4:
        new = new[:, 0]
    page = arena.shape[1]
    pidx = torch.clamp(lengths // page, max=page_table.shape[1] - 1)
    rows = page_table.gather(1, pidx[:, None].long())[:, 0].long()
    mapped = rows >= 0
    first = torch.argmax(mapped.int())           # 0 when none is mapped
    src = torch.where(mapped, torch.arange(rows.shape[0],
                                           device=rows.device), first)
    r, s = torch.clamp(rows[src], min=0), (lengths % page)[src].long()
    val = torch.where(mapped[src][:, None, None], new[src].to(arena.dtype),
                      arena[r, s])
    arena.index_put_((r, s), val)
    return arena


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Single-token attention over a paged KV arena (online softmax).

    q: (B, 1, Hq, D); lengths: (B,) valid tokens per slot including the
    one written this step.  Pages are visited in slot order; rows with
    no mapped pages produce finite zeros.
    """
    B, _, Hq, D = q.shape
    _, page, Hkv, _ = k_arena.shape
    Dv = v_arena.shape[-1]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    dev = q.device
    qg = q.reshape(B, Hkv, G, D).float()
    acc = torch.zeros((B, Hkv, G, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev)
    for j in range(page_table.shape[1]):
        rows = page_table[:, j]
        safe = torch.clamp(rows, min=0).long()
        kblk = k_arena[safe]                              # (B,page,Hkv,D)
        vblk = v_arena[safe]
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kblk.float()) * scale
        pos = j * page + torch.arange(page, device=dev)
        mask = (rows[:, None] >= 0) & (pos[None, :] < lengths[:, None])
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgk,bkhd->bhgd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


def paged_mla_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                        cc_arena: torch.Tensor, cr_arena: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor, *,
                        softmax_scale: float) -> torch.Tensor:
    """Absorbed-MLA decode over paged compressed caches (online softmax,
    fp32).

    q_eff: (B, H, kvl) fp32, already absorbed through ``W_uk``; q_rope:
    (B, H, rope); arenas: (n_pages, page, kvl) and (n_pages, page, rope);
    lengths: (B,) valid tokens per slot including the one written this
    step.  Returns the fp32 context (B, H, kvl): the caller applies
    ``W_uv``.  Rows with no mapped pages produce finite zeros.
    """
    B, H, kvl = q_eff.shape
    page = cc_arena.shape[1]
    dev = q_eff.device
    qr = q_rope.float()
    acc = torch.zeros((B, H, kvl), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H), dtype=torch.float32, device=dev)
    for j in range(page_table.shape[1]):
        rows = page_table[:, j]
        safe = torch.clamp(rows, min=0).long()
        cc = cc_arena[safe].float()                       # (B, page, kvl)
        cr = cr_arena[safe].float()
        s = (torch.einsum("bhk,btk->bht", q_eff, cc)
             + torch.einsum("bhr,btr->bht", qr, cr)) * softmax_scale
        pos = j * page + torch.arange(page, device=dev)
        mask = ((rows[:, None] >= 0) & (pos[None, :] < lengths[:, None])
                )[:, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bht,btk->bhk", p, cc)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


class KVCache(NamedTuple):
    """Per-layer-stacked KV cache. k: (L, B, Smax, Hkv, D), v: (L, B,
    Smax, Hkv, Dv) (MLA keeps ``c_kv`` in k and the roped ``k_rope`` in
    v, with ``Hkv == 1``)."""
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def alloc(layers: int, batch: int, max_len: int, kv_heads: int,
              head_dim: int, v_dim: Optional[int] = None, *, dtype,
              device) -> "KVCache":
        shape = (layers, batch, max_len, kv_heads, head_dim)
        vshape = shape[:-1] + (v_dim or head_dim,)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(vshape, dtype=dtype, device=device))


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, index: int):
    """Write (B, S_new, Hkv, D) at position ``index`` of (B, Smax, Hkv,
    D), in place; returns the two caches."""
    S = k_new.shape[1]
    cache_k[:, index:index + S] = k_new.to(cache_k.dtype)
    cache_v[:, index:index + S] = v_new.to(cache_v.dtype)
    return cache_k, cache_v
