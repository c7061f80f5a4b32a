"""Per-row decode-logit health (counterpart of
``repro.train.health.logits_row_ok``)."""
from __future__ import annotations

import torch


def logits_row_ok(rows: torch.Tensor) -> torch.Tensor:
    """``(batch,)`` bool, True = servable.

    A row fails when any logit is non-finite (bf16 adapter overflow) or
    when the distribution has collapsed to a constant (zero spread).
    Pass only the real vocab lanes: padded lanes carry a large negative
    fill that would hide a collapse.
    """
    finite = torch.isfinite(rows).all(dim=-1)
    spread = (rows.amax(dim=-1) - rows.amin(dim=-1)) > 0
    return finite & spread
