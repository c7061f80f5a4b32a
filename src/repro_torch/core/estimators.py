"""Low-rank stochastic gradient estimators (Definition 2).

Counterpart of ``repro.core.estimators``.  Given a loss ``F(theta)`` of
one parameter block ``theta`` (m × n) and a projection ``V`` (n × r):

* LowRank-IPA:    ``ĝ = (d/dB F(theta + B Vᵀ)|_{B=0}) Vᵀ = ∇F(theta) V Vᵀ``
* LowRank-LR-1pt: ``ĝ = F(theta + σ Z Vᵀ) Z Vᵀ / σ``
* LowRank-LR-2pt: ``ĝ = [F(theta + σZVᵀ) − F(theta − σZVᵀ)] / (2σ) Z Vᵀ``

The IPA form is taken the memory-efficient way: ``torch.autograd`` with
respect to the m × r auxiliary ``B`` only; ``theta`` never receives a
gradient of its own.  The ``*_bgrad`` forms return the subspace
gradient ``G_B`` (m × r), what Algorithm 1 feeds the optimizer; the
others lift it back to m × n, what the MSE theory speaks of.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.common import tree_flatten_with_path, tree_unflatten

LossFn = Callable[[torch.Tensor], torch.Tensor]  # theta -> scalar loss


# ---------------------------------------------------------------------------
# IPA family
# ---------------------------------------------------------------------------

def ipa_full(loss_fn: LossFn, theta: torch.Tensor) -> torch.Tensor:
    """The classical full-rank IPA estimator (Eq. 2): plain backprop."""
    theta = theta.detach().requires_grad_()
    return torch.autograd.grad(loss_fn(theta), theta)[0]


def lowrank_ipa_bgrad(loss_fn: LossFn, theta: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """``G_B = d/dB F(theta + B Vᵀ)|_{B=0}`` (m × r), the quantity
    Algorithm 1 updates."""
    b = torch.zeros((theta.shape[0], v.shape[1]), dtype=theta.dtype,
                    device=theta.device, requires_grad=True)
    loss = loss_fn(theta.detach() + b @ v.T)
    return torch.autograd.grad(loss, b)[0]


def lowrank_ipa(loss_fn: LossFn, theta: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """The lifted LowRank-IPA estimator (Eq. 4): ``G_B Vᵀ`` (m × n)."""
    return lowrank_ipa_bgrad(loss_fn, theta, v) @ v.T


# ---------------------------------------------------------------------------
# LR / ZO family
# ---------------------------------------------------------------------------

@torch.no_grad()
def lowrank_lr_1pt(loss_fn: LossFn, theta, v, z, sigma: float,
                   baseline: float = 0.0) -> torch.Tensor:
    """The one-point LowRank-LR estimator (Example 3 ii)."""
    fp = loss_fn(theta + sigma * z @ v.T)
    return ((fp - baseline) / sigma) * (z @ v.T)


@torch.no_grad()
def lowrank_lr_2pt_bgrad(loss_fn: LossFn, theta, v, z,
                         sigma: float) -> torch.Tensor:
    """The antithetic two-point subspace gradient ``[(F+ − F−)/(2σ)] Z``
    (m × r)."""
    fp = loss_fn(theta + sigma * z @ v.T)
    fm = loss_fn(theta - sigma * z @ v.T)
    return ((fp - fm) / (2.0 * sigma)) * z


def lowrank_lr_2pt(loss_fn: LossFn, theta, v, z,
                   sigma: float) -> torch.Tensor:
    """The lifted antithetic two-point LowRank-LR estimator."""
    return lowrank_lr_2pt_bgrad(loss_fn, theta, v, z, sigma) @ v.T


@torch.no_grad()
def lr_full_2pt(loss_fn: LossFn, theta, z_full, sigma: float) -> torch.Tensor:
    """The classical full-space two-point ZO/LR baseline (Example 2)."""
    fp = loss_fn(theta + sigma * z_full)
    fm = loss_fn(theta - sigma * z_full)
    return ((fp - fm) / (2.0 * sigma)) * z_full


# ---------------------------------------------------------------------------
# Tree-level IPA: the production path
# ---------------------------------------------------------------------------

def lowrank_ipa_pytree_bgrad(loss_fn: Callable, theta_tree,
                             v_tree) -> Tuple[torch.Tensor, object]:
    """Subspace gradients of a whole tree of matrix parameters.

    ``loss_fn(effective_params) -> scalar``; ``v_tree`` (nested dicts, as
    ``theta_tree``) holds one (n_i × r) projection per (m_i × n_i) leaf,
    or ``None`` for a leaf trained dense (norms, biases, routers: its
    gradient comes back at full shape).  Returns ``(loss, G_B tree)``, each
    ``G_B`` leaf (m_i × r).
    """
    flat = tree_flatten_with_path(theta_tree)
    paths = [p for p, _ in flat]
    vs = dict(tree_flatten_with_path(v_tree))
    bs = []
    for path, theta in flat:
        v = vs[path]
        shape = theta.shape if v is None else (theta.shape[0], v.shape[1])
        bs.append(torch.zeros(shape, dtype=theta.dtype, device=theta.device,
                              requires_grad=True))
    eff = [theta.detach() + (b if vs[path] is None else b @ vs[path].T)
           for (path, theta), b in zip(flat, bs)]
    loss = loss_fn(tree_unflatten(paths, eff))
    grads = torch.autograd.grad(loss, bs)
    return loss.detach(), tree_unflatten(paths, list(grads))
