"""Chunked cross-entropy, and the classification loss and accuracy of
the fine-tuning scenario (:func:`cls_ce`, :func:`cls_accuracy`).

Counterpart of ``repro.train.loss``.  Logits for a whole
(B, S, vocab) block would dominate activation memory, so the sequence
is cut into chunks; each chunk's logits are reduced to per-token CE at
once and recomputed in the backward (``torch.utils.checkpoint``, as the
reference wraps ``one_chunk`` in ``jax.checkpoint``).  The unembedding
flows through :func:`linear`, so the low-rank estimator covers the LM
head.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.linear import LRPack, linear


def chunked_ce(hidden: torch.Tensor, unembed, labels: torch.Tensor, *,
               true_vocab: int, chunk: int = 512,
               label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (B, S) labels; hidden (B, S, d).

    ``unembed`` may be a tensor or an :class:`LRPack`; padded-vocab
    columns are set to -1e30 before an fp32 logsumexp, so padding never
    changes the loss.
    """
    B, S, d = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    n = S // c
    h = hidden.reshape(B, n, c, d).transpose(0, 1)
    y = labels.reshape(B, n, c).transpose(0, 1).long()
    if label_mask is None:
        m = torch.ones((n, B, c), dtype=torch.float32, device=hidden.device)
    else:
        m = label_mask.reshape(B, n, c).transpose(0, 1).float()
    vp = (unembed.w if isinstance(unembed, LRPack) else unembed).shape[-1]
    col_ok = torch.arange(vp, device=hidden.device) < true_vocab

    def one_chunk(hc, yc, mc):
        lg = linear(hc, unembed).float()
        lg = torch.where(col_ok, lg, -1e30)
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1, yc[..., None])[..., 0]
        return torch.stack([((lse - picked) * mc).sum(), mc.sum()])

    totals = torch.stack([checkpoint(one_chunk, h[i], y[i], m[i],
                                     use_reentrant=False)
                          for i in range(n)]).sum(dim=0)
    return totals[0] / torch.clamp(totals[1], min=1.0)


def cls_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of class logits (B, n_classes), in fp32."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long()[:, None])[:, 0]
    return (lse - picked).mean()


def cls_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose largest logit is the label's."""
    return (torch.argmax(logits, -1) == labels.long()).float().mean()
