"""LowRank-LR (zeroth-order) training — the paper's Definition 2 /
Example 3.

Counterpart of ``repro.optim.zo``.  Forward-only: per step, draw a
``B``-shaped ``Z`` per group (and a full-shape ``z`` per dense leaf),
evaluate the loss at ``Θ ± σ (Z Vᵀ)`` (antithetic two-point), and form
the subspace gradient estimate

    g_B = (F+ − F−) / (2σ) · Z

which feeds the same subspace update as LowRank-IPA
(:func:`~.subspace.inner_update`).  No backprop and no stored
activations: both forwards run without autograd, through the low-rank
forward kernel in its shared-B form.

The reference folds the step into a PRNG key for each draw; the port
draws the noise from the state's ``torch.Generator`` in sequence, on the
generator's device, and moves it to the training device, so a card run
and a CPU run that share a ``sample_device`` draw the same noise, as they
draw the same ``V``.
"""
from __future__ import annotations

import torch

from . import subspace
from .subspace import SubspaceState, Trainable, packed_params, trainable_of


def _sample_noise(state: SubspaceState) -> Trainable:
    """One fp32 ``Z`` per trainable buffer — a W-shaped draw per dense leaf,
    then a stacked B-shaped draw per group — from the state's generator,
    on the training device."""
    gen = state.gen
    device = state.step.device

    def draw(shape):
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                           device=gen.device).to(device)

    return Trainable(dense=tuple(draw(s.m.shape) for s in state.dense),
                     groups=tuple(draw(s.b.shape) for s in state.groups))


def _perturbed(params, state, trainable: Trainable, noise: Trainable,
               sigma: float, sign: float, dtype=None):
    """Packed params at ``trainable + sign · σ · noise``."""
    def shift(ts, zs):
        return tuple(t + sign * sigma * z.to(t.dtype)
                     for t, z in zip(ts, zs, strict=True))
    pert = Trainable(dense=shift(trainable.dense, noise.dense),
                     groups=shift(trainable.groups, noise.groups))
    return packed_params(params, state, pert, dtype=dtype)


@torch.no_grad()
def zo_value_and_grad(loss_fn, params, state: SubspaceState, batch,
                      sigma: float, dtype=None):
    """Antithetic two-point LowRank-LR estimate of the trainable gradient:
    ``(loss at the centre, approximately; grads; trainable)``."""
    trainable = trainable_of(params, state)
    noise = _sample_noise(state)
    fp = loss_fn(_perturbed(params, state, trainable, noise, sigma, +1.0,
                            dtype), batch)
    fm = loss_fn(_perturbed(params, state, trainable, noise, sigma, -1.0,
                            dtype), batch)
    coeff = (fp - fm) / (2.0 * sigma)
    grads = Trainable(dense=tuple(coeff * z for z in noise.dense),
                      groups=tuple(coeff * z for z in noise.groups))
    return 0.5 * (fp + fm), grads, trainable


def zo_inner_step(loss_fn, params, state: SubspaceState, batch, *, lr,
                  tcfg, dtype=None):
    """One LowRank-LR inner step: two forwards, then the subspace update.
    Returns ``(loss, new_params, new_state, grad_norm)``."""
    loss, grads, trainable = zo_value_and_grad(
        loss_fn, params, state, batch, tcfg.zo_sigma, dtype=dtype)
    new_params, _, new_state, gn = subspace.inner_update(
        grads, trainable, params, state, lr=lr, tcfg=tcfg)
    return loss, new_params, new_state, gn
