"""GaLore-style projected-gradient baseline (Zhao et al., 2024).

Counterpart of ``repro.optim.galore``.  GaLore computes the FULL gradient
by backprop, projects each weight's gradient onto the top-r left
singular basis ``U`` of a recent full gradient (refreshed every
``lazy_k`` steps), runs Adam on the projection ``R = Uᵀ G`` and lifts
the step back, ``W -= lr (U delta + wd W)``, every step.  It saves
optimizer memory only: the ``(k, n)`` gradient and the full activations
are materialised (the paper's Section 2 critique).

It runs on the grouped layout of :mod:`.subspace`: the master weights
stay stacked per group, the gradient arrives in the same grouped layout
(``torch.autograd.grad`` over the stacked buffers), and each group's
projection is ONE ``dispatch.lowrank_project`` call, the hand-written
kernel on the card.  ``U`` is stored in the compute dtype; the
eigendecomposition, the projection and the moments are fp32, and the
slots stay fp32 whatever ``state_dtype``/``master_dtype`` say
(``quantize_state=False``).

Two departures from the reference:

* The refresh cadence is decided on the host.  :class:`GaLoreState`
  keeps ``host_step`` beside the device ``step`` that the bias
  corrections read, so the decision reads nothing from the device and
  the eigendecomposition runs only on a refresh step (the reference
  traces both branches of a ``lax.cond``).
* Each basis column's sign is fixed: its largest-magnitude entry is
  made positive (:func:`_fix_signs`).  ``eigh`` returns each column up
  to sign and LAPACK and cuSOLVER may disagree; the update within one
  refresh interval does not depend on the sign, but ``m`` carries across
  refreshes in ``U``'s coordinates, so an unfixed sign would change the
  trajectory after the second refresh.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..kernels import dispatch
from ..models.common import (compute_view, resolve_compute_dtype,
                             tree_flatten_with_path, tree_unflatten)
from . import subspace
from .adamw import clip_by_global_norm, global_norm


@dataclasses.dataclass
class GaLoreState(subspace.SubspaceState):
    """The grouped subspace state (``proj`` holds ``U``, ``m``/``v`` the
    projected moments; ``b`` stays zero) plus the host's view of the
    cadence."""
    host_step: int = 0      # the device ``step`` as a host int
    refreshes: int = 0      # bases computed so far


def init(params, tcfg, gen: torch.Generator) -> GaLoreState:
    """The subspace paradigms' grouped slot layout with fp32 slots; ``U``
    starts as zeros (the first step's refresh fills it)."""
    state = subspace.init(params, tcfg, gen, quantize_state=False)
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state)}
    fields["groups"] = tuple(g._replace(proj=torch.zeros_like(g.proj))
                             for g in state.groups)
    return GaLoreState(**fields)


def init_grouped(params, tcfg, gen: torch.Generator, donate: bool = False):
    """``(GroupedParams, GaLoreState)``: the per-step weight write then
    lands on the stacked buffers (``donate``: see
    ``subspace.group_params``)."""
    params = subspace.params_of(params)
    grouped = subspace.group_params(
        params, subspace.build_layout(params, tcfg, quantize_state=False),
        donate)
    state = init(grouped, tcfg, gen)
    return dataclasses.replace(grouped, layout=state.layout), state


def _fix_signs(u: torch.Tensor) -> torch.Tensor:
    """Each column of ``u`` (.., k, r) with its largest-magnitude entry
    positive (the first such entry on a tie)."""
    idx = u.abs().argmax(dim=-2, keepdim=True)
    return u * torch.sign(torch.gather(u, -2, idx))


def _top_r_basis(g: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r left singular vectors of g (.., k, n) as a row-major (.., k, r)
    basis: the eigenvectors of the fp32 gram ``g gᵀ`` for its r largest
    eigenvalues, in ``eigh``'s ascending order, signs fixed."""
    gram = (g @ g.mT).float()
    _, vecs = torch.linalg.eigh(gram)               # ascending
    return _fix_signs(vecs[..., -r:]).contiguous()


def value_and_full_grads(loss_fn, params, batch):
    """Full backprop (the baselines' memory cost): ``(loss, grads)`` with
    the gradient in the params' own form.  For grouped masters the
    model sees views of the stacked buffers (``subspace.params_of``) and
    ``grads`` is a :class:`~.subspace.GroupedParams` of ``(G,) + lead +
    (k, n)`` gradients; for a nested dict tree, a tree."""
    if isinstance(params, subspace.GroupedParams):
        leaves = [t.detach().requires_grad_()
                  for t in params.dense + params.groups]
        nd = len(params.dense)
        grouped = dataclasses.replace(params, dense=tuple(leaves[:nd]),
                                      groups=tuple(leaves[nd:]))
        loss = loss_fn(subspace.params_of(grouped), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dataclasses.replace(
            params, dense=tuple(grads[:nd]), groups=tuple(grads[nd:]))
    flat = tree_flatten_with_path(params)
    paths = [p for p, _ in flat]
    leaves = [x.detach().requires_grad_() for _, x in flat]
    loss = loss_fn(tree_unflatten(paths, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(paths, list(grads))


@torch.no_grad()
def update(full_grads: subspace.GroupedParams,
           params: subspace.GroupedParams, state: GaLoreState, *, lr, tcfg,
           refresh: bool) -> Tuple[subspace.GroupedParams, GaLoreState]:
    """Adam on the projected gradient, lifted back to W, every step.

    Per group: ``U`` is recomputed from the clipped gradient when
    ``refresh``, ``R = Uᵀ G`` is ONE ``dispatch.lowrank_project`` call
    over the stacked gradients, the moments update in fp32, and the
    stacked master buffer gets ``W - lr (U delta + wd W)`` in its own
    dtype.  Dense leaves get plain AdamW.  ``lr`` may be a 0-d device
    tensor; only a refresh (``eigh``) waits on the device.
    """
    nd = len(full_grads.dense)
    flat, _ = clip_by_global_norm(
        list(full_grads.dense) + list(full_grads.groups), tcfg.grad_clip)
    g_dense, g_groups = flat[:nd], flat[nd:]
    step = state.step + 1
    stepf = step.float()
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    new_dense_w, new_dense = [], []
    for di, (w, g) in enumerate(zip(params.dense, g_dense)):
        new_p, slot = subspace._dense_adam(state.dense[di], w, g, lr=lr,
                                           bc1=bc1, bc2=bc2, tcfg=tcfg)
        new_dense_w.append(new_p)
        new_dense.append(slot)

    new_wgroups, new_groups = [], []
    for g_i, (spec, slot) in enumerate(zip(state.layout.groups,
                                           state.groups)):
        gs = g_groups[g_i].float()
        ws = params.groups[g_i].float()
        proj = (_top_r_basis(gs, spec.rank).to(slot.proj.dtype)
                if refresh else slot.proj)
        rproj = dispatch.lowrank_project(gs, proj)
        m = b1 * slot.m + (1 - b1) * rproj
        v = b2 * slot.v + (1 - b2) * rproj * rproj
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        lifted = proj.float() @ delta.mT
        if tcfg.weight_decay:
            lifted = lifted + tcfg.weight_decay * ws
        new_wgroups.append((ws - lr * lifted).to(params.groups[g_i].dtype))
        new_groups.append(slot._replace(proj=proj, m=m, v=v))
    new_state = dataclasses.replace(
        state, dense=tuple(new_dense), groups=tuple(new_groups), step=step,
        host_step=state.host_step + 1,
        refreshes=state.refreshes + int(refresh))
    return dataclasses.replace(params, dense=tuple(new_dense_w),
                               groups=tuple(new_wgroups)), new_state


def view_loss(loss_fn, tcfg, device):
    """``loss_fn`` read through the compute-dtype view of the weights (the
    masters keep their dtype; gradients flow back through the cast)."""
    cdt = resolve_compute_dtype(tcfg, device)
    return lambda p, mb: loss_fn(compute_view(p, cdt), mb)


def make_train_step(cfg, tcfg, loss_fn=None):
    """The step with an explicit ``refresh`` flag:
    ``step(params, opt_state, batch, refresh) -> (params, opt_state,
    metrics)``; the caller schedules the refreshes."""
    from ..train import steps as steps_mod
    base_loss = loss_fn or steps_mod.build_loss_fn(cfg)

    def train_step(params, opt_state: GaLoreState, batch, refresh: bool):
        lr = steps_mod.lr_at(tcfg, opt_state.step)
        loss, grads = value_and_full_grads(
            view_loss(base_loss, tcfg, opt_state.step.device), params,
            batch)
        gn = global_norm(grads.dense + grads.groups)
        new_p, new_s = update(grads, params, opt_state, lr=lr, tcfg=tcfg,
                              refresh=refresh)
        return new_p, new_s, {"loss": loss, "grad_norm": gn, "lr": lr}

    return train_step


def make_inner_step(cfg, tcfg, loss_fn=None):
    """The trainer's step, ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the basis is refreshed when
    ``opt_state.host_step % lazy_k == 0`` (so the first step always
    refreshes), decided on the host."""
    train_step = make_train_step(cfg, tcfg, loss_fn)

    def inner_step(params, opt_state: GaLoreState, batch):
        refresh = opt_state.host_step % tcfg.lazy_k == 0
        return train_step(params, opt_state, batch, refresh)

    return inner_step
