"""Global-norm gradient clipping.

Counterpart of ``global_norm`` and ``clip_by_global_norm`` of
``repro.optim.adamw`` (the dense AdamW baseline itself is not ported
yet).  The norm and the clip factor stay tensors on the device: clipping
never waits on the host.
"""
from __future__ import annotations

import torch


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def clip_by_global_norm(tensors, max_norm: float):
    """(clipped tensors, global norm).  ``max_norm`` 0 disables clipping
    (the norm is then reported as 0, as in the reference).  The clipped
    tensors are fp32: the reference scales by an fp32 array, which
    promotes a bf16 gradient (a bf16 B master's) to fp32 unrounded."""
    tensors = list(tensors)
    if not max_norm:
        dev = tensors[0].device if tensors else None
        return tensors, torch.zeros((), device=dev)
    gn = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [t.float() * scale for t in tensors], gn
