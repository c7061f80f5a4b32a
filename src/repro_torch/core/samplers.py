"""Random projection samplers for low-rank gradient estimation.

Counterpart of ``repro.core.samplers`` for the Haar–Stiefel sampler
(Algorithm 2), the paper's default: thin QR of a Gaussian with the sign
fix that makes the law exactly Haar on St(n, r), scaled by
``alpha = sqrt(c n / r)``, so that ``E[V Vᵀ] = c I_n`` and
``Vᵀ V = (c n / r) I_r``.  The Gaussian, coordinate and
instance-dependent samplers are not ported yet.

Draws come from an explicit ``torch.Generator``.  JAX's threefry and
torch's generators give different numbers from the same seed, so the
port is held to the reference by law, or by feeding both the same
draws.  Every draw is made in fp32 on the generator's device and cast
once to ``dtype``.
"""
from __future__ import annotations

import math

import torch


def stiefel_batched(gen: torch.Generator, batch: int, n: int, r: int,
                    c: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """(batch, n, r) independent Haar–Stiefel projections (one row per
    group member): one Gaussian draw and one batched thin QR."""
    g = torch.randn((batch, n, r), generator=gen, dtype=torch.float32,
                    device=gen.device)
    q, rmat = torch.linalg.qr(g, mode="reduced")
    d = torch.sign(torch.diagonal(rmat, dim1=-2, dim2=-1))
    d = torch.where(d == 0, 1.0, d)               # measure-zero guard
    # the QR may hand back column-major factors (it does on CUDA); the
    # kernels read V row-major
    v = math.sqrt(c * n / r) * (q * d[..., None, :])
    return v.to(dtype).contiguous()


def stiefel(gen: torch.Generator, n: int, r: int, c: float = 1.0,
            dtype=torch.float32) -> torch.Tensor:
    """One (n, r) Haar–Stiefel projection (Algorithm 2)."""
    return stiefel_batched(gen, 1, n, r, c=c, dtype=dtype)[0]


def available_batched() -> tuple:
    """Sampler names :func:`sample_v_batched` accepts in the port."""
    return ("stiefel",)


def sample_v_batched(name: str, gen: torch.Generator, batch: int, n: int,
                     r: int, c: float = 1.0,
                     dtype=torch.float32) -> torch.Tensor:
    """One (batch, n, r) draw for a whole group of same-shape leaves."""
    if name == "stiefel":
        return stiefel_batched(gen, batch, n, r, c=c, dtype=dtype)
    raise NotImplementedError(
        f"sampler {name!r} is not ported to repro_torch yet; available: "
        f"{', '.join(available_batched())} (see ROADMAP.md Queue 1)")
