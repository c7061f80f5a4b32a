"""Closed-form MSE theory of the paper (Prop. 1, Theorems 2 and 3,
Remark 1), the oracles the Monte-Carlo estimators are checked against.

Counterpart of ``repro.core.mse``.  The closed forms take and return
float64 tensors (their inputs are widened), so that they stay oracles
for fp32 estimators; :func:`empirical_ep` and :func:`empirical_ep2`
average a batch of drawn projections in its own dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from .samplers import waterfill_inclusion_probs


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


def mse_decomposition(sigma_xi, sigma_theta, e_p2, c: float) -> dict:
    """Proposition 1: ``MSE = tr(Sigma_xi E[P²]) + tr(Sigma_Theta (E[P²] -
    c² I)) + (1 - c)² tr(Sigma_Theta)``.

    ``sigma_xi``: ``E[(ĝ - g)ᵀ (ĝ - g)]`` (n × n); ``sigma_theta``: ``gᵀ g``
    (n × n); ``e_p2``: ``E[P²]`` of the projection law (n × n).
    """
    sigma_xi, sigma_theta, e_p2 = map(_f64, (sigma_xi, sigma_theta, e_p2))
    n = e_p2.shape[0]
    eye = torch.eye(n, dtype=torch.float64, device=e_p2.device)
    t1 = torch.trace(sigma_xi @ e_p2)
    t2 = torch.trace(sigma_theta @ (e_p2 - c ** 2 * eye))
    t3 = (1.0 - c) ** 2 * torch.trace(sigma_theta)
    return {"ipa_lr_variance": t1, "projection_variance": t2,
            "scalar_bias": t3, "total": t1 + t2 + t3}


def trace_ep2_optimal(n: int, r: int, c: float) -> float:
    """Theorem 2's optimum: ``min tr E[P²] = n² c² / r``."""
    return n * n * c * c / r


def trace_ep2_gaussian(n: int, r: int, c: float) -> float:
    """``tr E[P²]`` of the i.i.d. Gaussian sampler, entries N(0, c/r):
    ``c² n (n + r + 1) / r``."""
    return c * c * n * (n + r + 1) / r


def mse_full_rank(sigma_xi) -> torch.Tensor:
    """Remark 1's baseline: ``MSE_F = tr(Sigma_xi)``."""
    return torch.trace(_f64(sigma_xi))


def mse_gaussian(sigma_xi, sigma_theta, n: int, r: int) -> torch.Tensor:
    """Remark 1 (the Gaussian sampler, c = 1): ``MSE_G = (n + r + 1)/r
    tr(Sigma_xi) + (n + 1)/r tr(Sigma_Theta)``."""
    return ((n + r + 1) / r) * torch.trace(_f64(sigma_xi)) + \
        ((n + 1) / r) * torch.trace(_f64(sigma_theta))


def mse_isotropic_optimal(sigma_xi, sigma_theta, n: int, r: int,
                          c: float) -> torch.Tensor:
    """MSE of the Theorem-2-optimal projector, exact for the Stiefel law
    (``E[P²] = (c² n / r) I``): ``(c² n / r) tr(Sigma_xi) + (c² n / r -
    c²) tr(Sigma_Theta) + (1 - c)² tr(Sigma_Theta)``."""
    k = c * c * n / r
    tr_xi, tr_th = torch.trace(_f64(sigma_xi)), torch.trace(
        _f64(sigma_theta))
    return k * tr_xi + (k - c * c) * tr_th + (1 - c) ** 2 * tr_th


def phi_min_dependent(sigma_eigs, r: int, c: float,
                      pi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Theorem 3's optimal value ``Phi_min = c² sum_i sigma_i / pi*_i``
    (Eq. 16); a given ``pi`` is used as it is (a suboptimal pi too)."""
    sigma_eigs = _f64(sigma_eigs)
    if pi is None:
        pi = waterfill_inclusion_probs(sigma_eigs, r)
    return c * c * torch.sum(sigma_eigs / torch.clamp(_f64(pi), min=1e-12))


def mse_dependent_optimal(sigma_xi, sigma_theta, r: int,
                          c: float) -> torch.Tensor:
    """The least MSE of the optimal instance-dependent projector:
    ``Phi_min(Sigma) + (1 - 2c) tr(Sigma_Theta)``, ``Sigma = Sigma_xi +
    Sigma_Theta``."""
    sigma_theta = _f64(sigma_theta)
    eigs = torch.clamp(torch.linalg.eigvalsh(_f64(sigma_xi) + sigma_theta),
                       min=0.0)
    return phi_min_dependent(eigs, r, c) + \
        (1 - 2 * c) * torch.trace(sigma_theta)


def empirical_ep2(vs: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo ``E[P²]`` from a batch of projections (k, n, r)."""
    p = vs @ vs.mT
    return (p @ p).mean(dim=0)


def empirical_ep(vs: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo ``E[P]`` from a batch of projections (k, n, r)."""
    return (vs @ vs.mT).mean(dim=0)
