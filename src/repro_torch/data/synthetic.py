"""Deterministic, restart-safe synthetic data.

Counterpart of ``repro.data.synthetic``: ``lm_batch`` and
``classification_batch``, and ``StatelessLoader("lm" | "cls")``.  Every
batch is a pure function of ``(seed, step)``: a restarted run resumes
with exactly the stream it would have seen.  The laws are the
reference's, drawn from a ``torch.Generator`` keyed by ``(seed, step)``:

* ``lm``: a random-walk mode picks one of ``n_modes`` vocabulary
  slices, and tokens are uniform in that slice;
* ``cls`` (the fine-tuning task): a uniform class label, and each token
  uniform in the class's own vocabulary slice with probability 0.7, else
  uniform over the vocabulary.

JAX's threefry and torch's generators give different numbers, so the
two streams agree in law, not bit for bit.
"""
from __future__ import annotations

import torch

from .. import resolve_device


def _generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen


def lm_batch(seed: int, step: int, *, batch: int, seq_len: int, vocab: int,
             n_modes: int = 8, device=None) -> dict:
    """Tokens + next-token labels (int32, ``(batch, seq_len)``), made on
    ``device`` (cuda unless the caller names another)."""
    dev = resolve_device(device)
    gen = _generator(seed, step, dev)
    i64 = dict(dtype=torch.int64, device=dev, generator=gen)
    mode0 = torch.randint(0, n_modes, (batch, 1), **i64)
    walk = torch.rand((batch, seq_len + 1), generator=gen, device=dev) < 0.05
    mode = (mode0 + torch.cumsum(walk.long(), dim=1)) % n_modes
    width = max(vocab // n_modes, 2)
    offs = torch.randint(0, width, (batch, seq_len + 1), **i64)
    toks = (mode * width + offs).int()
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def classification_batch(seed: int, step: int, *, batch: int, seq_len: int,
                         vocab: int, n_classes: int, device=None) -> dict:
    """Tokens (int32, ``(batch, seq_len)``) and class labels (int32,
    ``(batch,)``) of the fine-tuning task, separable by the tokens' share
    in the class's slice; made on ``device`` (cuda unless named)."""
    dev = resolve_device(device)
    gen = _generator(seed + 7919, step, dev)
    i64 = dict(dtype=torch.int64, device=dev, generator=gen)
    y = torch.randint(0, n_classes, (batch,), **i64)
    width = max(vocab // n_classes, 2)
    clean = y[:, None] * width + torch.randint(0, width, (batch, seq_len),
                                               **i64)
    noise = torch.randint(0, vocab, (batch, seq_len), **i64)
    keep = torch.rand((batch, seq_len), generator=gen, device=dev) < 0.7
    toks = torch.where(keep, clean, noise).int()
    return {"tokens": toks, "labels": y.int()}


SOURCES = {"cls": classification_batch, "lm": lm_batch}


class StatelessLoader:
    """Step-indexed loader: ``loader(step) -> batch`` from the ``"lm"`` or
    ``"cls"`` source (the reference's ``"encdec"`` waits for its
    family)."""

    def __init__(self, kind: str, seed: int, device=None, **kw):
        if kind not in SOURCES:
            raise ValueError(f"unknown data source {kind!r}; available: "
                             f"{', '.join(sorted(SOURCES))}")
        self.kind, self.seed, self.kw = kind, seed, dict(kw)
        self.device = resolve_device(device)

    def __call__(self, step: int) -> dict:
        return SOURCES[self.kind](self.seed, step, device=self.device,
                                  **self.kw)
