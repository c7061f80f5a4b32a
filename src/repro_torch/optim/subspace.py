"""LowRankLazyAdam — the paper's Algorithm 1 — on grouped structure-of-
arrays state.

Counterpart of ``repro.optim.subspace`` on its fp32-state path:

* the layout (``is_lowrank_leaf``, ``_rank_for``, ``GroupSpec``,
  ``SubspaceLayout``, ``build_layout``): leaves are numbered in
  sorted-key order, as JAX flattens dicts, so ``leaf_idx`` agrees with
  the reference and adapters and states cross over one to one;
* the state: every group of same-shape, same-rank low-rank leaves keeps
  its ``B``/``m``/``v`` stacked as one ``(G,) + lead + (n_out, r)`` fp32
  buffer and its ``V`` as ``(G,) + lead + (k, r)`` in the compute dtype
  (:class:`GroupedLowRankSlot`); the master weights are stacked the same
  way (:class:`GroupedParams`), so the Adam and merge kernels take a
  whole group in one launch and the model sees views;
* the INNER step (:func:`inner_update`): global-norm clip, one fused
  ``subspace_adam`` launch per group, plain AdamW on the dense leaves;
* the OUTER step (:func:`outer_merge_resample`): ``W += V Bᵀ`` per group
  in place, a fresh Stiefel ``V``, ``B`` zeroed, moments reset.

Unlike the reference's pure functions, the outer merge updates the
grouped master buffer where it lies (the training loop never reads the
old weights again).  The reference key becomes a ``torch.Generator``
carried in the state.  int8 moments, bf16 masters, Lion and the
instance-dependent sampler's energy EMA are not ported yet.
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import samplers
from ..kernels import dispatch
from ..models.common import (resolve_compute_dtype, tree_flatten_with_path,
                             tree_unflatten)
from ..models.linear import LRPack
from .adamw import clip_by_global_norm

EXCLUDE_DEFAULT = r"(/embed/|/tok$|/pos$|router|conv_w)"


class GroupSpec(NamedTuple):
    """Static description of one group."""
    shape: Tuple[int, ...]      # the member weight shape lead + (k, n_out)
    rank: int
    leaf_idx: Tuple[int, ...]   # member positions in params flat-leaf order


class SubspaceLayout(NamedTuple):
    """Static index map param-tree <-> grouped buffers.  ``compute_dtype``
    names the dtype V is stored in and the packed views are cast to."""
    n_leaves: int
    dense_idx: Tuple[int, ...]
    groups: Tuple[GroupSpec, ...]
    compute_dtype: str = "float32"


class DenseSlot(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


class GroupedLowRankSlot(NamedTuple):
    """All same-shape low-rank leaves of one group, pre-stacked: ``proj``
    (V) ``(G,) + lead + (k, r)``; ``b``/``m``/``v`` ``(G,) + lead +
    (n_out, r)`` fp32."""
    proj: torch.Tensor
    b: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class SubspaceState:
    dense: Tuple[DenseSlot, ...]            # one per dense leaf
    groups: Tuple[GroupedLowRankSlot, ...]  # one per group
    step: torch.Tensor                      # 0-d int32 on the device
    outer_step: torch.Tensor
    gen: torch.Generator                    # draws the next V
    layout: SubspaceLayout


@dataclasses.dataclass
class GroupedParams:
    """Master weights in the grouped layout: ``groups[g]`` stacks the
    g-th group's member weights as ``(G,) + lead + (k, n_out)`` (axis 0
    in ``leaf_idx`` order); ``dense`` holds the other leaves in
    ``layout.dense_idx`` order; ``paths`` rebuilds the model tree."""
    dense: Tuple[torch.Tensor, ...]
    groups: Tuple[torch.Tensor, ...]
    layout: SubspaceLayout
    paths: Tuple[Tuple[str, ...], ...]


class Trainable(NamedTuple):
    """The differentiation tree: stacked B per group, W per dense leaf."""
    dense: Tuple[torch.Tensor, ...]
    groups: Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def _path_str(path) -> str:
    return "/" + "/".join(str(p) for p in path)


def is_lowrank_leaf(path: str, x, tcfg) -> bool:
    if re.search(getattr(tcfg, "lowrank_exclude", EXCLUDE_DEFAULT), path):
        return False
    shape = tuple(x.shape)
    if len(shape) == 2:
        return min(shape) >= tcfg.min_dim_for_lowrank
    if len(shape) == 3:  # scan-stacked (L, k, n_out) or experts (E, k, n)
        return min(shape[1:]) >= tcfg.min_dim_for_lowrank
    if len(shape) == 4:  # scan-stacked experts (L, E, k, n_out)
        return min(shape[2:]) >= tcfg.min_dim_for_lowrank
    return False


def _rank_for(shape, tcfg) -> int:
    k, n_out = shape[-2], shape[-1]
    return max(1, min(tcfg.rank, min(k, n_out) // 2))


def build_layout(params, tcfg) -> SubspaceLayout:
    """Classify leaves once; same-shape, same-rank low-rank leaves share a
    group.  ``params`` may hold tensors or ``ParamSpec``s — only shapes
    are read."""
    leaves = tree_flatten_with_path(params)
    dense_idx = []
    by_sig: dict = {}
    for i, (path, x) in enumerate(leaves):
        if is_lowrank_leaf(_path_str(path), x, tcfg):
            sig = (tuple(int(d) for d in x.shape), _rank_for(x.shape, tcfg))
            by_sig.setdefault(sig, []).append(i)
        else:
            dense_idx.append(i)
    groups = tuple(GroupSpec(shape=sig[0], rank=sig[1], leaf_idx=tuple(idx))
                   for sig, idx in by_sig.items())
    return SubspaceLayout(n_leaves=len(leaves), dense_idx=tuple(dense_idx),
                          groups=groups)


def _require_fp32_state(tcfg) -> None:
    for field in ("state_dtype", "master_dtype"):
        if getattr(tcfg, field, "float32") != "float32":
            raise NotImplementedError(
                f"{field}={getattr(tcfg, field)!r}: only fp32 subspace "
                f"state is ported to repro_torch yet (ROADMAP.md Queue 1)")


# ---------------------------------------------------------------------------
# State and grouped master weights
# ---------------------------------------------------------------------------

def _sample_proj_group(name: str, gen: torch.Generator, spec: GroupSpec,
                       n_members: int, c: float, dtype,
                       device) -> torch.Tensor:
    """One batched draw for a whole group, ``(G,) + lead + (k, r)``:
    leading layer dims fold into the sample batch."""
    lead, k_dim = spec.shape[:-2], spec.shape[-2]
    batch = n_members
    for d in lead:
        batch *= d
    v = samplers.sample_v_batched(name, gen, batch, k_dim, spec.rank, c=c,
                                  dtype=dtype)
    return v.reshape((n_members,) + tuple(lead) + (k_dim, spec.rank)).to(
        device)


def group_params(params, layout: SubspaceLayout) -> GroupedParams:
    """Stack each group's member weights into one ``(G,)+lead+(k, n)``
    buffer (one stack per group, at init).  Other leaves pass through."""
    if isinstance(params, GroupedParams):
        return params
    flat = tree_flatten_with_path(params)
    return GroupedParams(
        dense=tuple(flat[i][1] for i in layout.dense_idx),
        groups=tuple(torch.stack([flat[i][1] for i in spec.leaf_idx])
                     for spec in layout.groups),
        layout=layout, paths=tuple(p for p, _ in flat))


def params_of(params):
    """Model-shaped param tree from either representation; grouped leaves
    are views of the stacked buffers."""
    if not isinstance(params, GroupedParams):
        return params
    out: list = [None] * params.layout.n_leaves
    for di, i in enumerate(params.layout.dense_idx):
        out[i] = params.dense[di]
    for g, spec in enumerate(params.layout.groups):
        for j, i in enumerate(spec.leaf_idx):
            out[i] = params.groups[g][j]
    return tree_unflatten(params.paths, out)


def init(params, tcfg, gen: torch.Generator) -> SubspaceState:
    """Classify leaves, build the grouped layout, draw the initial
    projections (one batched draw per group, from ``gen``), zero B and
    the moments.  The state lives on the device of ``params``."""
    _require_fp32_state(tcfg)
    params = params_of(params)
    flat = tree_flatten_with_path(params)
    device = flat[0][1].device
    cdt = resolve_compute_dtype(tcfg, device)
    layout = build_layout(params, tcfg)._replace(
        compute_dtype=str(cdt).removeprefix("torch."))
    f32 = dict(dtype=torch.float32, device=device)
    dense = tuple(DenseSlot(m=torch.zeros(flat[i][1].shape, **f32),
                            v=torch.zeros(flat[i][1].shape, **f32))
                  for i in layout.dense_idx)
    groups = []
    for spec in layout.groups:
        n_members = len(spec.leaf_idx)
        bshape = (n_members,) + spec.shape[:-2] + (spec.shape[-1],
                                                   spec.rank)
        proj = _sample_proj_group(tcfg.sampler, gen, spec, n_members,
                                  tcfg.c, cdt, device)
        groups.append(GroupedLowRankSlot(
            proj=proj, b=torch.zeros(bshape, **f32),
            m=torch.zeros(bshape, **f32), v=torch.zeros(bshape, **f32)))
    i32 = dict(dtype=torch.int32, device=device)
    return SubspaceState(dense=dense, groups=tuple(groups),
                         step=torch.zeros((), **i32),
                         outer_step=torch.zeros((), **i32), gen=gen,
                         layout=layout)


def init_grouped(params, tcfg, gen: torch.Generator):
    """The trainer's entry: ``(grouped_params, state)`` built from one
    layout."""
    state = init(params, tcfg, gen)
    return group_params(params, state.layout), state


# ---------------------------------------------------------------------------
# Packing and trainable extraction
# ---------------------------------------------------------------------------

def trainable_of(params: GroupedParams, state: SubspaceState) -> Trainable:
    """The differentiation tree: every group's stacked B and the W of
    every dense leaf, as fresh leaves that share storage with the state
    (no copies) and require a gradient."""
    return Trainable(
        dense=tuple(w.detach().requires_grad_() for w in params.dense),
        groups=tuple(g.b.detach().requires_grad_() for g in state.groups))


def packed_params(params: GroupedParams, state: SubspaceState,
                  trainable: Trainable, dtype: Optional[torch.dtype] = None):
    """Model-facing tree: ``LRPack(W[g][j], B[g][j], V[g][j])`` at the
    low-rank leaves and the trainable tensor at the dense leaves.

    ``dtype`` casts all three pack members of a group once (the compute
    dtype of the fused forward/backward); the fp32 B masters and the
    stored weights are untouched, and autograd carries the B gradient
    back up through the cast to fp32.
    """
    def cast(x):
        return x if dtype is None else x.to(dtype)

    out: list = [None] * state.layout.n_leaves
    for di, i in enumerate(state.layout.dense_idx):
        out[i] = trainable.dense[di]
    for g, spec in enumerate(state.layout.groups):
        tb = cast(trainable.groups[g])
        tv = cast(state.groups[g].proj)
        wg = cast(params.groups[g])
        for j, i in enumerate(spec.leaf_idx):
            out[i] = LRPack(wg[j], tb[j], tv[j])
    return tree_unflatten(params.paths, out)


# ---------------------------------------------------------------------------
# Inner step (Algorithm 1, lines 5-6)
# ---------------------------------------------------------------------------

def _dense_adam(slot: DenseSlot, p, g, *, lr, bc1, bc2, tcfg):
    g32 = g.float()
    m = tcfg.beta1 * slot.m + (1 - tcfg.beta1) * g32
    v = tcfg.beta2 * slot.v + (1 - tcfg.beta2) * g32 * g32
    delta = (m / bc1) / (torch.sqrt(v / bc2) + tcfg.eps)
    if tcfg.weight_decay and p.ndim >= 2:
        delta = delta + tcfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), DenseSlot(m, v)


@torch.no_grad()
def inner_update(grads: Trainable, trainable: Trainable,
                 params: GroupedParams, state: SubspaceState, *, lr,
                 tcfg) -> Tuple[GroupedParams, Trainable, SubspaceState,
                                torch.Tensor]:
    """One Adam step on the trainable tree.

    Returns ``(new_params, new_trainable, new_state, grad_norm)``.  Dense
    updates land in the params' dense leaves; low-rank updates land in
    each group's stacked B through one ``subspace_adam`` launch.  ``lr``
    is a 0-d tensor on the device (or a number); nothing here waits on
    the host.
    """
    flat, gn = clip_by_global_norm(list(grads.dense) + list(grads.groups),
                                   tcfg.grad_clip)
    nd = len(grads.dense)
    g_dense, g_groups = flat[:nd], flat[nd:]
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - tcfg.beta1 ** stepf
    bc2 = 1.0 - tcfg.beta2 ** stepf

    new_dense_w, new_dense = [], []
    for di, w in enumerate(params.dense):
        new_p, slot = _dense_adam(state.dense[di], w, g_dense[di], lr=lr,
                                  bc1=bc1, bc2=bc2, tcfg=tcfg)
        new_dense_w.append(new_p)
        new_dense.append(slot)

    new_groups = []
    for slot, g in zip(state.groups, g_groups):
        nb, nm, nv = dispatch.subspace_adam(
            slot.b, g.float(), slot.m, slot.v, lr=lr, step=stepf,
            beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps,
            wd=float(tcfg.weight_decay))
        new_groups.append(slot._replace(b=nb, m=nm, v=nv))

    new_params = dataclasses.replace(params, dense=tuple(new_dense_w))
    new_state = dataclasses.replace(state, dense=tuple(new_dense),
                                    groups=tuple(new_groups), step=step)
    new_trainable = Trainable(dense=tuple(new_dense_w),
                              groups=tuple(s.b for s in new_groups))
    return new_params, new_trainable, new_state, gn


# ---------------------------------------------------------------------------
# Outer step (Algorithm 1, lines 3 and 8)
# ---------------------------------------------------------------------------

@torch.no_grad()
def outer_merge_resample(params: GroupedParams, state: SubspaceState,
                         tcfg) -> Tuple[GroupedParams, SubspaceState]:
    """``W += V Bᵀ`` (fp32 accumulate, one ``lowrank_merge`` launch per
    group, in place on the grouped buffer), a fresh V per group from the
    state's generator (stored in V's dtype), B zeroed, and the moments
    zeroed when ``tcfg.reset_moments``."""
    new_groups = []
    for g, (spec, slot) in enumerate(zip(state.layout.groups,
                                         state.groups)):
        dispatch.lowrank_merge(params.groups[g], slot.proj, slot.b,
                               out=params.groups[g])
        proj = _sample_proj_group(tcfg.sampler, state.gen, spec,
                                  len(spec.leaf_idx), tcfg.c,
                                  slot.proj.dtype, slot.proj.device)
        m, v = ((torch.zeros_like(slot.m), torch.zeros_like(slot.v))
                if tcfg.reset_moments else (slot.m, slot.v))
        new_groups.append(slot._replace(proj=proj,
                                        b=torch.zeros_like(slot.b), m=m,
                                        v=v))
    return params, dataclasses.replace(state, groups=tuple(new_groups),
                                       outer_step=state.outer_step + 1)

