"""PyTorch/CUDA port of the low-rank serving system, for one NVIDIA H100.

Sits beside the JAX package ``repro`` (the reference) and imports
nothing from it.  Module names follow the reference's, so each module's
counterpart is ``repro.<same path>``.  The hot op ``y = xW + (xV)Bᵀ``
runs through a hand-written CUDA kernel (``kernels/csrc``) on the card
and through its plain PyTorch version on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when CUDA is asked for and absent — the port
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
