"""Temperature / top-k token selection for sampled decoding.

Counterpart of the sampled branch of ``repro.serve.engine``'s decode
step: the real vocab lanes in fp32, scaled by ``1/T``, every logit below
the k-th largest set to ``-inf`` (ties with the k-th kept), then
``argmax(scaled + g)`` with Gumbel noise ``g`` — the Gumbel-max draw
that ``jax.random.categorical`` computes.  The noise is an argument, so
a test can inject the reference's; the engine draws it from a
``torch.Generator`` on its device with :func:`gumbel_noise`.  Nothing
here synchronises with the host.
"""
from __future__ import annotations

import torch


def gumbel_noise(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)`` (the reference's ``jax.random.gumbel``), fp32, drawn
    from ``gen`` on its device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def select_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  noise: torch.Tensor) -> torch.Tensor:
    """``(batch,)`` int64 token ids drawn from ``softmax(logits / T)``
    restricted to each row's top ``top_k`` (0: the whole row).

    ``logits``: ``(batch, vocab)``, the real vocab lanes only;
    ``noise``: standard Gumbel noise of the same shape.
    """
    # a true division, as the reference's (a Python divisor would be a
    # multiplication by its reciprocal on the card); the divisor is
    # filled on the device, so no copy from the host waits
    scaled = logits.float() / torch.full((), temperature,
                                         dtype=torch.float32,
                                         device=logits.device)
    if 0 < top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    return torch.argmax(scaled + noise, dim=-1)
