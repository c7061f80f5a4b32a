"""Carry weights and training state across from the JAX package.

The reference's parameter tree, as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, lm.init_params(cfg, key))``), becomes
the port's tree under the same names, the same ``(L, k, n_out)``
stacking (MoE experts ``(L, E, k, n_out)``, the router fp32) and the
same ``y = x @ W`` orientation.  Its grouped training
state (``repro.optim.subspace.SubspaceState`` with numpy leaves) becomes
the port's grouped master weights and subspace state
(:func:`subspace_from_numpy`); a GaLore state becomes the port's
(:func:`galore_from_numpy`), and a dense AdamW run's parameters and
moments the port's (:func:`adamw_from_numpy`).  The encoder classifier's
parameters are checked against the port's specs on the way
(:func:`encoder_params_from_numpy`).  The ``*_to_numpy`` functions
are the inverses: the port's state as the numpy arrays the
``*_from_numpy`` functions take (a bfloat16 tensor as ``|V2`` records,
the bytes of an ``ml_dtypes`` bfloat16 array, as the checkpoints hold
it).  Adapters need no
conversion:
``AdapterStore.add_tenant`` takes the numpy ``B`` and ``V`` buffers the
JAX package hands over.
"""
from __future__ import annotations

import numpy as np
import torch

from . import methods, resolve_device
from .models.common import DTYPES, tree_map
from .optim import adamw, quant, subspace


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """One numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor
    on ``device``, optionally cast to ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(t) -> np.ndarray:
    """The inverse of :func:`to_tensor`: a host array in the tensor's
    dtype, a bfloat16 tensor as ``|V2`` records."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def params_from_numpy(tree, device=None, dtype=None) -> dict:
    """The port's parameter tree from the reference's (nested dicts of
    numpy arrays).  ``dtype`` casts the floating leaves."""
    dev = resolve_device(device)
    return tree_map(lambda a: to_tensor(a, dev, dtype), tree)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _moment(ref_m, like, dev):
    """One moment buffer in the form of ``like`` (the port's zero
    moment): a tensor, or a quantized moment whose block and codec must
    be ``like``'s."""
    if not quant.is_quantized(like):
        return to_tensor(ref_m, dev)
    block, codec = _field(ref_m, "block"), _field(ref_m, "codec")
    if (block, codec) != (like.block, like.codec):
        raise ValueError(
            f"quantized moment with block {block} and codec {codec!r}; the "
            f"layout expects block {like.block} and codec {like.codec!r}")
    return quant.QuantizedTensor(q=to_tensor(_field(ref_m, "q"), dev),
                                 scale=to_tensor(_field(ref_m, "scale"), dev),
                                 block=block, codec=codec)


def _b_master(ref_b, like, dev):
    b = to_tensor(ref_b, dev)
    if b.dtype != like.dtype:
        raise ValueError(f"B is {b.dtype}; the layout's masters are "
                         f"{like.dtype}")
    return b


def _energy(group, like, dev):
    """A group's energy EMA from the reference's slot, or ``like`` (the
    port's zeros) where the item carries none."""
    has = ("energy" in group) if isinstance(group, dict) else \
        hasattr(group, "energy")
    if not has:
        return like
    e = to_tensor(_field(group, "energy"), dev, torch.float32)
    if e.shape != like.shape:
        raise ValueError(f"energy of shape {tuple(e.shape)}; the layout "
                         f"expects {tuple(like.shape)}")
    return e


def subspace_from_numpy(params, tcfg, *, groups=None, dense=None, step=0,
                        outer_step=0, gen=None, device=None):
    """The port's ``(GroupedParams, SubspaceState)`` from the reference's.

    ``params`` is the model-shaped tree of numpy arrays (the reference's
    ``subspace.params_of(grouped_params)``); the grouped master buffers
    are stacked from it in the reference's group order.  ``groups`` holds
    one item per group with fields ``proj``, ``b``, ``m`` and ``v`` (the
    reference's ``GroupedLowRankSlot`` with numpy leaves, or dicts);
    ``dense`` one item per dense leaf with ``m`` and ``v`` (its
    ``DenseSlot``).  A group item's ``energy`` (the ``dependent_diag``
    EMA, ``(G, k)`` or ``(G, 0)``) is carried when it has one and must
    have the shape the port's layout gives it.  Missing parts start as
    the port's ``init`` makes them (fresh V from ``gen``, zero B and
    moments).  ``V`` is stored in
    the run's compute dtype, everything else as given: an int8 moment
    (the reference's ``QuantizedTensor``, or a dict with its ``q``,
    ``scale``, ``block`` and ``codec``) carries its payload and scales,
    and its block and codec must be the ones the port's layout expects;
    ``B`` must be in the layout's master dtype, and Lion's ``v`` is the
    zero-size placeholder.
    ``tcfg.optimizer`` names the registered method whose ``init`` builds
    the port's side (its update rule).
    """
    dev = resolve_device(device)
    tree = params_from_numpy(params, dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(tcfg.seed + 1)
    gparams, state = methods.get(tcfg.optimizer).init(tree, tcfg, gen)
    cdt = DTYPES[state.layout.compute_dtype]
    if groups is not None:
        state.groups = tuple(
            slot._replace(proj=to_tensor(_field(g, "proj"), dev, cdt),
                          b=_b_master(_field(g, "b"), slot.b, dev),
                          m=_moment(_field(g, "m"), slot.m, dev),
                          v=_moment(_field(g, "v"), slot.v, dev),
                          energy=_energy(g, slot.energy, dev))
            for slot, g in zip(state.groups, groups, strict=True))
    if dense is not None:
        state.dense = tuple(
            subspace.DenseSlot(m=to_tensor(_field(d, "m"), dev),
                               v=to_tensor(_field(d, "v"), dev))
            for d in dense)
        if len(state.dense) != len(state.layout.dense_idx):
            raise ValueError(
                f"{len(state.dense)} dense slots for "
                f"{len(state.layout.dense_idx)} dense leaves")
    state.step = torch.tensor(int(step), dtype=torch.int32, device=dev)
    state.outer_step = torch.tensor(int(outer_step), dtype=torch.int32,
                                    device=dev)
    return gparams, state


def galore_from_numpy(params, tcfg, *, groups=None, dense=None, step=0,
                      device=None):
    """The port's ``(GroupedParams, GaLoreState)`` from the reference's
    GaLore run: the model-shaped param tree, one item per group with its
    basis ``proj`` (``U``), ``b`` and the projected moments ``m``/``v``,
    the dense slots and ``step`` (see :func:`subspace_from_numpy`).  The
    host's cadence counter starts at ``step``.  ``tcfg.optimizer`` must
    be ``"galore"``."""
    if tcfg.optimizer != "galore":
        raise ValueError(f"galore_from_numpy: tcfg.optimizer is "
                         f"{tcfg.optimizer!r}, not 'galore'")
    gparams, state = subspace_from_numpy(params, tcfg, groups=groups,
                                         dense=dense, step=step,
                                         device=device)
    state.host_step = int(step)
    return gparams, state


def encoder_params_from_numpy(tree, cfg, n_classes: int,
                              device=None) -> dict:
    """The port's ``encoder_cls`` parameters from the reference's
    ``encoder_cls.init_params`` tree (numpy leaves): every path, shape and
    dtype must be the one :func:`repro_torch.models.encoder_cls.
    param_specs` gives, so a tree of another config or class count is
    refused rather than half loaded."""
    from .models import encoder_cls
    from .models.common import tree_flatten_with_path
    params = params_from_numpy(tree, device)
    want = {p: (s.shape, s.dtype) for p, s in tree_flatten_with_path(
        encoder_cls.param_specs(cfg, n_classes))}
    got = {p: (tuple(t.shape), t.dtype)
           for p, t in tree_flatten_with_path(params)}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"encoder tree does not fit {cfg.name} with "
                         f"{n_classes} classes: {bad[:4]}")
    return params


def adamw_from_numpy(params, *, m=None, v=None, step=0, device=None):
    """The port's ``(params, AdamWState)`` from the reference's dense AdamW
    run: its param tree and its ``AdamWState`` moments ``m``/``v`` (trees
    of fp32 numpy arrays with the params' structure; zeros when absent)
    and ``step``."""
    dev = resolve_device(device)
    tree = params_from_numpy(params, dev)
    state = adamw.init(tree)
    return tree, adamw.AdamWState(
        m=state.m if m is None else params_from_numpy(m, dev),
        v=state.v if v is None else params_from_numpy(v, dev),
        step=torch.tensor(int(step), dtype=torch.int32, device=dev))


def params_to_numpy(tree) -> dict:
    """The inverse of :func:`params_from_numpy`."""
    return tree_map(to_numpy, tree)


def _moment_to_numpy(m):
    if quant.is_quantized(m):
        return {"q": to_numpy(m.q), "scale": to_numpy(m.scale),
                "block": m.block, "codec": m.codec}
    return to_numpy(m)


def subspace_to_numpy(gparams, state) -> dict:
    """The inverse of :func:`subspace_from_numpy`: the keyword arguments
    that rebuild ``(gparams, state)`` (``params`` model-shaped, one dict
    per group with ``proj``, ``b``, ``m``, ``v`` and ``energy``, one per
    dense leaf with ``m`` and ``v``, an int8 moment as a dict of its
    ``q``, ``scale``, ``block`` and ``codec``; ``step`` and
    ``outer_step`` as ints).  The generator is not an array: pass
    ``gen`` to rebuild it."""
    return {
        "params": params_to_numpy(subspace.params_of(gparams)),
        "groups": [{"proj": to_numpy(g.proj), "b": to_numpy(g.b),
                    "m": _moment_to_numpy(g.m), "v": _moment_to_numpy(g.v),
                    "energy": to_numpy(g.energy)} for g in state.groups],
        "dense": [{"m": to_numpy(d.m), "v": to_numpy(d.v)}
                  for d in state.dense],
        "step": int(state.step), "outer_step": int(state.outer_step)}


def galore_to_numpy(gparams, state) -> dict:
    """The inverse of :func:`galore_from_numpy` (see
    :func:`subspace_to_numpy`; GaLore has no ``outer_step``)."""
    out = subspace_to_numpy(gparams, state)
    del out["outer_step"]
    return out


def adamw_to_numpy(params, state) -> dict:
    """The inverse of :func:`adamw_from_numpy`."""
    return {"params": params_to_numpy(params),
            "m": params_to_numpy(state.m), "v": params_to_numpy(state.v),
            "step": int(state.step)}
