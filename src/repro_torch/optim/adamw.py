"""Dense AdamW — the Vanilla-IPA baseline (full backprop, full moments),
and the global-norm clip every method shares.

Counterpart of ``repro.optim.adamw``: fp32 moments per leaf of a nested
dict tree, decoupled weight decay, the global-norm clip.  The norm, the
clip factor, the step and the bias corrections stay tensors on the
device: an update never waits on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.common import tree_flatten_with_path, tree_unflatten


class AdamWState(NamedTuple):
    m: dict                 # fp32, the params' tree
    v: dict
    step: torch.Tensor      # 0-d int32 on the device


def init(params) -> AdamWState:
    """Zero fp32 moments for every leaf, on the leaves' devices."""
    flat = tree_flatten_with_path(params)
    paths = [p for p, _ in flat]

    def zeros():
        return tree_unflatten(paths, [torch.zeros(x.shape,
                                                  dtype=torch.float32,
                                                  device=x.device)
                                      for _, x in flat])

    return AdamWState(m=zeros(), v=zeros(),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=flat[0][1].device))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def _dense(t: torch.Tensor) -> bool:
    """No element shared, no gap: some order of t's dims is contiguous."""
    want = 1
    for stride, size in sorted((st, n) for n, st in zip(t.shape, t.stride())
                               if n != 1):
        if stride != want:
            return False
        want *= size
    return True


def _span(t: torch.Tensor):
    """(storage, first byte, byte past the last) of a dense tensor."""
    size = t.element_size()
    lo = t.storage_offset() * size
    return t.untyped_storage().data_ptr(), lo, lo + t.numel() * size


def writable_once(tensors) -> list:
    """For each tensor, whether it may be written in place without
    touching what another entry holds: ``"own"`` for an fp32 tensor that
    is dense (no stride 0 or overlap) and shares no byte with another
    entry, or is the first of entries that view the very same bytes;
    ``"alias"`` for a later entry over the bytes of an ``"own"`` one (an
    aliased gradient: autograd gives ``x + y``'s leaves one tensor);
    ``"copy"`` for the rest, a partial overlap among them."""
    spans = [_span(t) if t.dtype == torch.float32 and t.numel()
             and _dense(t) else None
             for t in tensors]
    by_storage: dict = {}
    for s in set(filter(None, spans)):
        by_storage.setdefault(s[0], []).append(s)
    partial = {a for group in by_storage.values() for a in group
               for b in group if a != b and a[1] < b[2] and b[1] < a[2]}
    out, seen = [], set()
    for s in spans:
        if s is None or s in partial:
            out.append("copy")
        else:
            out.append("alias" if s in seen else "own")
            seen.add(s)
    return out


def clip_by_global_norm(tensors, max_norm: float, inplace: bool = False):
    """(clipped tensors, global norm).  ``max_norm`` 0 disables clipping
    (the norm is then reported as 0, as in the reference).  The clipped
    tensors are fp32: the reference scales by an fp32 array, which
    promotes a bf16 gradient (a bf16 B master's) to fp32 unrounded.
    ``inplace``: the caller owns ``tensors`` (fresh gradients), so an
    fp32 one is scaled where it lies rather than copied (qwen3-moe's B
    gradients at 20 layers are 4.9 GB): each storage's bytes once, and
    an entry that aliases them returns them as scaled (the reference
    scales each leaf once); entries that overlap in part are copied
    before anything is scaled in place."""
    tensors = list(tensors)
    if not max_norm:
        dev = tensors[0].device if tensors else None
        return tensors, torch.zeros((), device=dev)
    gn = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    how = writable_once(tensors) if inplace else ["copy"] * len(tensors)
    out = [t.float() * scale if h == "copy" else None
           for t, h in zip(tensors, how)]
    for i, (t, h) in enumerate(zip(tensors, how)):
        if h == "own":
            out[i] = t.mul_(scale)
        elif h == "alias":
            out[i] = t
    return out, gn


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, beta1=0.9,
           beta2=0.999, eps=1e-8, weight_decay=0.0, grad_clip=0.0):
    """One AdamW step over a nested dict tree; returns ``(new_params,
    new_state, grad_norm)``.  Each new parameter is computed in fp32 and
    stored in its master's dtype; ``lr`` may be a 0-d device tensor."""
    flat = tree_flatten_with_path(params)
    paths = [p for p, _ in flat]
    flat_g = [g for _, g in tree_flatten_with_path(grads)]
    flat_m = [m for _, m in tree_flatten_with_path(state.m)]
    flat_v = [v for _, v in tree_flatten_with_path(state.v)]
    flat_g, gn = clip_by_global_norm(flat_g, grad_clip)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - beta1 ** stepf
    bc2 = 1.0 - beta2 ** stepf
    new_p, new_m, new_v = [], [], []
    for (_, p), g, m, v in zip(flat, flat_g, flat_m, flat_v, strict=True):
        g = g.float()
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        new_p.append((p.float() - lr * delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (tree_unflatten(paths, new_p),
            AdamWState(tree_unflatten(paths, new_m),
                       tree_unflatten(paths, new_v), step), gn)
