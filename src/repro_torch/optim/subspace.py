"""LowRankLazyAdam — the paper's Algorithm 1 — on grouped structure-of-
arrays state.

Counterpart of ``repro.optim.subspace``:

* the layout (``is_lowrank_leaf``, ``_rank_for``, ``GroupSpec``,
  ``SubspaceLayout``, ``build_layout``): leaves are numbered in
  sorted-key order, as JAX flattens dicts, so ``leaf_idx`` agrees with
  the reference and adapters and states cross over one to one;
* the state: every group of same-shape, same-rank low-rank leaves keeps
  its ``B``/``m``/``v`` stacked as one ``(G,) + lead + (n_out, r)``
  buffer and its ``V`` as ``(G,) + lead + (k, r)`` in the compute dtype
  (:class:`GroupedLowRankSlot`); the master weights are stacked the same
  way (:class:`GroupedParams`), so the update and merge kernels take a
  whole group in one launch and the model sees views;
* the storage precision (``SubspaceLayout.state_dtype`` and
  ``master_dtype``): fp32 or int8 block-quantized moments
  (:class:`~repro_torch.optim.quant.QuantizedTensor`), fp32 or bf16 ``B``
  masters whose updates are stochastically rounded with noise drawn
  from the state's generator (:func:`_sr_bits`);
* the update rule (``SubspaceLayout.algo``): ``"adam"``, or ``"lion"``
  (one moment; ``v`` is a zero-size ``(G,) + lead + (0, r)``
  placeholder);
* the INNER step (:func:`inner_update`): global-norm clip, one fused
  update launch per group (Adam or Lion, on fp32 or int8 moments), plain
  AdamW or Lion on the dense leaves;
* the energy EMA of the instance-dependent sampler
  (``tcfg.sampler == "dependent_diag"``): every group keeps a ``(G, k)``
  running estimate of diag(Sigma), updated by each inner step from the
  clipped subspace gradients (:func:`_group_energy_update`), and the
  resample water-fills it (:func:`_sample_proj_group`);
* the OUTER step (:func:`outer_merge_resample`): ``W += V Bᵀ`` per group
  in place (stochastically rounded into a bf16 ``W`` under bf16
  masters), a fresh ``V`` from ``tcfg.sampler``, ``B`` zeroed, moments
  reset, the energy carried over.

Unlike the reference's pure functions, the outer merge updates the
grouped master buffer where it lies (the training loop never reads the
old weights again).  The reference key becomes a ``torch.Generator``
carried in the state, which also draws the stochastic-rounding noise.
GaLore's opt-out (``quantize_state=False``) pins fp32 storage whatever
the knobs say.  The reference's ``REPRO_STATE_DTYPE``/
``REPRO_MASTER_DTYPE`` overrides are not ported.
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core import samplers
from ..kernels import dispatch, ref
from ..models.common import (DTYPES, resolve_compute_dtype,
                             resolve_master_dtype, resolve_state_dtype,
                             tree_flatten_with_path, tree_unflatten)
from ..models.linear import LRPack
from . import quant
from .adamw import clip_by_global_norm

EXCLUDE_DEFAULT = r"(/embed/|/tok$|/pos$|router|conv_w)"
# fp32 elements of one piece of a group's V draw (1 GiB): a group whose
# draw is larger (qwen3-moe's expert groups, G L E matrices) is drawn
# piece by piece, by the same law
SAMPLE_PIECE = 1 << 28


class GroupSpec(NamedTuple):
    """Static description of one group."""
    shape: Tuple[int, ...]      # the member weight shape lead + (k, n_out)
    rank: int
    leaf_idx: Tuple[int, ...]   # member positions in params flat-leaf order


class SubspaceLayout(NamedTuple):
    """Static index map param-tree <-> grouped buffers.  ``compute_dtype``
    names the dtype V is stored in and the packed views are cast to;
    ``state_dtype`` the moments' storage (``'float32'`` | ``'int8'``),
    ``master_dtype`` the B masters' (``'float32'`` | ``'bfloat16'``),
    ``qblock`` the elements per int8 scale and ``algo`` the update rule
    (``'adam'`` | ``'lion'``)."""
    n_leaves: int
    dense_idx: Tuple[int, ...]
    groups: Tuple[GroupSpec, ...]
    compute_dtype: str = "float32"
    state_dtype: str = "float32"
    master_dtype: str = "float32"
    qblock: int = quant.QBLOCK
    algo: str = "adam"


class DenseSlot(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


class GroupedLowRankSlot(NamedTuple):
    """All same-shape low-rank leaves of one group, pre-stacked: ``proj``
    (V) ``(G,) + lead + (k, r)``; ``b`` ``(G,) + lead + (n_out, r)`` in
    the master dtype; ``m``/``v`` the same shape, fp32 tensors or
    :class:`~repro_torch.optim.quant.QuantizedTensor` (``v`` is
    ``(G,) + lead + (0, r)`` under Lion); ``energy`` the ``(G, k)`` fp32
    EMA of diag(Sigma) under ``dependent_diag``, else ``(G, 0)``."""
    proj: torch.Tensor
    b: torch.Tensor
    m: Union[torch.Tensor, quant.QuantizedTensor]
    v: Union[torch.Tensor, quant.QuantizedTensor]
    energy: torch.Tensor


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
    if len(shape) == 3:  # scan-stacked (L, k, n_out)
        return min(shape[1:]) >= tcfg.min_dim_for_lowrank
    if len(shape) == 4:  # scan-stacked experts (L, E, k, n_out)
        return min(shape[2:]) >= tcfg.min_dim_for_lowrank
    return False


def _rank_for(shape, tcfg) -> int:
    k, n_out = shape[-2], shape[-1]
    return max(1, min(tcfg.rank, min(k, n_out) // 2))


def build_layout(params, tcfg, algo: str = "adam",
                 quantize_state: bool = True) -> SubspaceLayout:
    """Classify leaves once; same-shape, same-rank low-rank leaves share a
    group.  ``params`` may hold tensors or ``ParamSpec``s — only shapes
    are read.  The layout also pins the storage precision
    (``tcfg.state_dtype``, ``tcfg.master_dtype``; fp32 for both under
    ``quantize_state=False``) and the update rule (``algo``)."""
    if algo not in ("adam", "lion"):
        raise ValueError(f"algo {algo!r}: expected 'adam' or 'lion'")
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
                          groups=groups,
                          state_dtype=(resolve_state_dtype(tcfg)
                                       if quantize_state else "float32"),
                          master_dtype=(resolve_master_dtype(tcfg)
                                        if quantize_state else "float32"),
                          qblock=quant.QBLOCK, algo=algo)


# ---------------------------------------------------------------------------
# State and grouped master weights
# ---------------------------------------------------------------------------

def _sample_proj_group(name: str, gen: torch.Generator, spec: GroupSpec,
                       n_members: int, c: float, dtype, device,
                       energy: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One batched draw for a whole group, ``(G,) + lead + (k, r)``:
    leading layer (and expert) dims fold into the sample batch, drawn in
    pieces of at most ``SAMPLE_PIECE`` fp32 elements (one piece for all
    but the largest groups).  Under ``dependent_diag`` each member's
    ``(k,)`` energy row is repeated across its own leading dims (one EMA
    per member, shared by its layers and experts), and a member whose
    row sums to zero draws from a row of ones: the warm-up, whose uniform
    pi is the coordinate law."""
    lead, k_dim = spec.shape[:-2], spec.shape[-2]
    lead_n = 1
    for d in lead:
        lead_n *= d
    batch = n_members * lead_n
    diag = None
    if name == "dependent_diag":
        e = torch.where(energy.sum(-1, keepdim=True) > 0, energy,
                        torch.ones_like(energy))
        diag = e[:, None, :].expand(n_members, lead_n,
                                    k_dim).reshape(batch, k_dim)
    per = max(1, SAMPLE_PIECE // (k_dim * spec.rank))
    out = None
    for a in range(0, batch, per):
        z = min(batch, a + per)
        kw = {} if diag is None else {"diag_energy": diag[a:z]}
        v = samplers.sample_v_batched(name, gen, z - a, k_dim, spec.rank,
                                      c=c, dtype=dtype, **kw)
        if z - a == batch:
            out = v.to(device)
            break
        if out is None:
            out = torch.empty((batch, k_dim, spec.rank), dtype=dtype,
                              device=device)
        out[a:z] = v
        del v
    return out.reshape((n_members,) + tuple(lead) + (k_dim, spec.rank))


def _set_leaf(tree: dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = leaf


def group_params(params, layout: SubspaceLayout,
                 donate: bool = False) -> GroupedParams:
    """Stack each group's member weights into one ``(G,)+lead+(k, n)``
    buffer (one buffer per group, at init).  Other leaves pass through.

    ``donate=True`` hands the caller's tree over: as each member is
    copied into its group's buffer, the tree's leaf is replaced by its
    view of the buffer, so the member's own storage is freed at once
    (qwen3-moe's w_gate and w_up leaves at 20 layers are 8 GB each) and
    the copies never all coexist with the leaves."""
    if isinstance(params, GroupedParams):
        return params
    flat = tree_flatten_with_path(params)
    groups = []
    for spec in layout.groups:
        one = flat[spec.leaf_idx[0]][1]
        buf = torch.empty((len(spec.leaf_idx),) + tuple(one.shape),
                          dtype=one.dtype, device=one.device)
        del one
        for j, i in enumerate(spec.leaf_idx):
            path, leaf = flat[i]
            buf[j].copy_(leaf)
            del leaf
            if donate:
                flat[i] = (path, buf[j])
                _set_leaf(params, path, buf[j])
        groups.append(buf)
    return GroupedParams(
        dense=tuple(flat[i][1] for i in layout.dense_idx),
        groups=tuple(groups), layout=layout,
        paths=tuple(p for p, _ in flat))


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


def _moment_zeros(shape, layout: SubspaceLayout, device,
                  codec: str = "linear"):
    """A zeroed grouped moment buffer in the layout's storage precision
    (second moments use the sqrt codec)."""
    if layout.state_dtype == "int8":
        return quant.zeros(shape, layout.qblock, codec=codec, device=device)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init(params, tcfg, gen: torch.Generator, algo: str = "adam",
         quantize_state: bool = True) -> SubspaceState:
    """Classify leaves, build the grouped layout, draw the initial
    projections (one batched draw per group, from ``gen``), zero B and
    the moments.  The state lives on the device of ``params``.

    B is stored in ``tcfg.master_dtype`` and the moments in
    ``tcfg.state_dtype`` (int8: :class:`quant.QuantizedTensor`, v in the
    sqrt codec); ``algo="lion"`` keeps only the first moment.
    ``quantize_state=False`` (GaLore, whose moment math runs in plain
    torch ops) keeps B and the moments fp32 whatever the knobs say."""
    params = params_of(params)
    flat = tree_flatten_with_path(params)
    device = flat[0][1].device
    cdt = resolve_compute_dtype(tcfg, device)
    layout = build_layout(params, tcfg, algo, quantize_state)._replace(
        compute_dtype=str(cdt).removeprefix("torch."))
    mdt = DTYPES[layout.master_dtype]
    f32 = dict(dtype=torch.float32, device=device)
    dense = tuple(DenseSlot(m=torch.zeros(flat[i][1].shape, **f32),
                            v=torch.zeros(flat[i][1].shape, **f32))
                  for i in layout.dense_idx)
    groups = []
    for spec in layout.groups:
        n_members = len(spec.leaf_idx)
        bshape = (n_members,) + spec.shape[:-2] + (spec.shape[-1],
                                                   spec.rank)
        energy = torch.zeros(
            (n_members, spec.shape[-2] if tcfg.sampler == "dependent_diag"
             else 0), **f32)
        proj = _sample_proj_group(tcfg.sampler, gen, spec, n_members,
                                  tcfg.c, cdt, device, energy=energy)
        v = (torch.zeros(bshape[:-2] + (0, spec.rank), **f32)
             if layout.algo == "lion"
             else _moment_zeros(bshape, layout, device, codec="sqrt"))
        groups.append(GroupedLowRankSlot(
            proj=proj, b=torch.zeros(bshape, dtype=mdt, device=device),
            m=_moment_zeros(bshape, layout, device), v=v, energy=energy))
    i32 = dict(dtype=torch.int32, device=device)
    return SubspaceState(dense=dense, groups=tuple(groups),
                         step=torch.zeros((), **i32),
                         outer_step=torch.zeros((), **i32), gen=gen,
                         layout=layout)


def init_grouped(params, tcfg, gen: torch.Generator, algo: str = "adam",
                 donate: bool = False):
    """The trainer's entry: ``(grouped_params, state)`` built from one
    layout.  The weights are grouped before the state is drawn, so a
    donated tree (:func:`group_params`) is gone before B, m, v and V take
    their room."""
    params = params_of(params)
    grouped = group_params(params, build_layout(params, tcfg, algo),
                           donate)
    state = init(grouped, tcfg, gen, algo)
    return dataclasses.replace(grouped, layout=state.layout), state


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
    dtype of the fused forward/backward); the B masters and the stored
    weights are untouched, and autograd carries the B gradient back
    through the cast to the master's dtype (a bf16 master gets a bf16
    gradient, as the reference's cotangent of a bf16 primal).
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


def _dense_lion(slot: DenseSlot, p, g, *, lr, tcfg):
    """Momentum-only Lion on a dense leaf; its v slot rides along
    unchanged (zero), as in the reference."""
    g32 = g.float()
    u = torch.sign(tcfg.beta1 * slot.m + (1 - tcfg.beta1) * g32)
    if tcfg.weight_decay and p.ndim >= 2:
        u = u + tcfg.weight_decay * p.float()
    m = tcfg.beta2 * slot.m + (1 - tcfg.beta2) * g32
    return (p.float() - lr * u).to(p.dtype), DenseSlot(m, slot.v)


def _sr_bits(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Stochastic-rounding noise for a bf16 store: int32 values uniform
    over ``[0, 2**16)``, drawn from the state's generator on its own
    device (the reference keys them from its PRNG key, step and group)."""
    return torch.randint(0, 1 << 16, tuple(shape), dtype=torch.int32,
                         generator=gen, device=gen.device).to(device)


def _group_energy_update(slot: GroupedLowRankSlot, g32) -> torch.Tensor:
    """``dependent_diag``: the EMA ``0.99 e + 0.01 diag(V (gᵀ g) Vᵀ)`` of
    diag(Sigma) from the group's clipped fp32 subspace gradients ``g32``
    and its current ``V`` (cast to fp32), batched over the group and
    averaged over the leading layer dims of each member; O(k r²), with
    no ``(k, r, r)`` intermediate.  A zero-width energy passes through."""
    if not slot.energy.shape[-1]:
        return slot.energy
    proj32 = slot.proj.float()
    mm = g32.mT @ g32
    e = ((proj32 @ mm) * proj32).sum(-1)
    if e.ndim > 2:
        e = e.mean(dim=tuple(range(1, e.ndim - 1)))
    return 0.99 * slot.energy + 0.01 * e


def _update_group(slot: GroupedLowRankSlot, g32, bits, *, lr, stepf,
                  layout: SubspaceLayout, tcfg) -> GroupedLowRankSlot:
    """One group's fused update through the kernel that fits its layout:
    Adam or Lion on fp32 or int8 moments; bf16 masters are rounded with
    ``bits`` (fused into the q8 kernels, after the fp32-state ones).  The
    energy EMA follows the gradient in every branch."""
    lion = layout.algo == "lion"
    wd = float(tcfg.weight_decay)
    slot = slot._replace(energy=_group_energy_update(slot, g32))
    if layout.state_dtype == "int8":
        if lion:
            nb, nmq, nms = dispatch.subspace_lion_q8(
                slot.b, g32, slot.m.q, slot.m.scale, lr=lr,
                beta1=tcfg.beta1, beta2=tcfg.beta2, wd=wd,
                qblock=layout.qblock, bits=bits)
            return slot._replace(b=nb, m=quant.QuantizedTensor(
                nmq, nms, layout.qblock))
        nb, nmq, nms, nvq, nvs = dispatch.subspace_adam_q8(
            slot.b, g32, slot.m.q, slot.m.scale, slot.v.q, slot.v.scale,
            lr=lr, step=stepf, beta1=tcfg.beta1, beta2=tcfg.beta2,
            eps=tcfg.eps, wd=wd, qblock=layout.qblock, bits=bits)
        return slot._replace(
            b=nb, m=quant.QuantizedTensor(nmq, nms, layout.qblock),
            v=quant.QuantizedTensor(nvq, nvs, layout.qblock, codec="sqrt"))
    if lion:
        nb, nm = dispatch.subspace_lion(slot.b, g32, slot.m, lr=lr,
                                        beta1=tcfg.beta1, beta2=tcfg.beta2,
                                        wd=wd)
        nv = slot.v
    else:
        nb, nm, nv = dispatch.subspace_adam(
            slot.b, g32, slot.m, slot.v, lr=lr, step=stepf,
            beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps, wd=wd)
    if bits is not None:
        nb = ref.sr_bf16(nb, bits).to(slot.b.dtype)
    return slot._replace(b=nb, m=nm, v=nv)


@torch.no_grad()
def inner_update(grads: Trainable, trainable: Trainable,
                 params: GroupedParams, state: SubspaceState, *, lr,
                 tcfg) -> Tuple[GroupedParams, Trainable, SubspaceState,
                                torch.Tensor]:
    """One optimizer step on the trainable tree.

    Returns ``(new_params, new_trainable, new_state, grad_norm)``.  Dense
    updates (AdamW, or Lion under ``algo="lion"``) land in the params'
    dense leaves; low-rank updates land in each group's stacked B through
    one fused launch per group.  ``lr`` is a 0-d tensor on the device (or
    a number); nothing here waits on the host.  ``grads`` is the step's
    own: its fp32 tensors are clipped in place.
    """
    flat, gn = clip_by_global_norm(list(grads.dense) + list(grads.groups),
                                   tcfg.grad_clip, inplace=True)
    nd = len(grads.dense)
    g_dense, g_groups = flat[:nd], flat[nd:]
    layout = state.layout
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - tcfg.beta1 ** stepf
    bc2 = 1.0 - tcfg.beta2 ** stepf

    new_dense_w, new_dense = [], []
    for di, w in enumerate(params.dense):
        if layout.algo == "lion":
            new_p, slot = _dense_lion(state.dense[di], w, g_dense[di],
                                      lr=lr, tcfg=tcfg)
        else:
            new_p, slot = _dense_adam(state.dense[di], w, g_dense[di],
                                      lr=lr, bc1=bc1, bc2=bc2, tcfg=tcfg)
        new_dense_w.append(new_p)
        new_dense.append(slot)

    new_groups = []
    for slot, g in zip(state.groups, g_groups):
        bits = (_sr_bits(state.gen, slot.b.shape, slot.b.device)
                if layout.master_dtype == "bfloat16" else None)
        new_groups.append(_update_group(slot, g.float(), bits, lr=lr,
                                        stepf=stepf, layout=layout,
                                        tcfg=tcfg))

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
    """``W += V Bᵀ`` (fp32 accumulate, one merge launch per group, in
    place on the grouped buffer; stochastically rounded into a bf16 W
    under bf16 masters), a fresh V per group from the state's generator
    (stored in V's dtype; ``dependent_diag`` water-fills the group's
    energy, which carries over), B zeroed, and the moments zeroed when
    ``tcfg.reset_moments``."""
    sr_master = state.layout.master_dtype == "bfloat16"
    new_groups = []
    for g, (spec, slot) in enumerate(zip(state.layout.groups,
                                         state.groups)):
        w = params.groups[g]
        if sr_master and w.dtype == torch.bfloat16:
            dispatch.lowrank_merge_sr(
                w, slot.proj, slot.b, _sr_bits(state.gen, w.shape, w.device),
                out=w)
        else:
            dispatch.lowrank_merge(w, slot.proj, slot.b, out=w)
        proj = _sample_proj_group(tcfg.sampler, state.gen, spec,
                                  len(spec.leaf_idx), tcfg.c,
                                  slot.proj.dtype, slot.proj.device,
                                  energy=slot.energy)
        m, v = ((quant.zeros_like(slot.m), quant.zeros_like(slot.v))
                if tcfg.reset_moments else (slot.m, slot.v))
        new_groups.append(slot._replace(proj=proj,
                                        b=torch.zeros_like(slot.b), m=m,
                                        v=v))
    return params, dataclasses.replace(state, groups=tuple(new_groups),
                                       outer_step=state.outer_step + 1)
