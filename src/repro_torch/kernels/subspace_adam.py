"""Fused Adam-with-decay on the subspace variable ``B`` on the card:
wrapper of the hand-written CUDA kernel ``csrc/subspace_adam.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/subspace_adam.py::
subspace_adam``.  ``b``, ``m`` and ``v`` are fp32 (masters and moments
are never downcast); ``g`` is fp32 or bf16.  ``lr``, ``bc1`` and ``bc2``
reach the kernel as one ``(3,)`` fp32 tensor on the device, so a step
never waits on the host for them.  One launch covers a whole group
buffer, any shape.  The route is the tensor's device alone: a CPU tensor
takes the plain version in :mod:`.ref`; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts launches per shape of ``b``.
Lion and the int8-state variants of the reference module are not ported
yet.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build, ref
from .lowrank_forward import DTYPE_CODE, _route

# b's shape -> launches on CUDA tensors
LAUNCHES: collections.Counter = collections.Counter()


def launches() -> int:
    return sum(LAUNCHES.values())


def reset_launches() -> None:
    LAUNCHES.clear()


@functools.cache
def _kernel():
    fn = _build.load("subspace_adam").subspace_adam_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                   cf, cf, cf, cf, cf, cf, vp]
    fn.restype = ci
    return fn


def _check(b, g, m, v, scalars) -> None:
    for name, t in (("g", g), ("m", m), ("v", v), ("scalars", scalars)):
        if t.device != b.device:
            raise ValueError(
                f"subspace_adam: {name} is on {t.device}, b on {b.device}")
    for name, t in (("b", b), ("m", m), ("v", v), ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"subspace_adam: {name} must be float32, got {t.dtype}")
    if g.dtype not in DTYPE_CODE:
        raise TypeError(
            f"subspace_adam: g must be float32 or bfloat16, got {g.dtype}")
    for name, t in (("b", b), ("g", g), ("m", m), ("v", v),
                    ("scalars", scalars)):
        if not t.is_contiguous():
            raise ValueError(f"subspace_adam: {name} is not contiguous")
    if not (b.shape == g.shape == m.shape == v.shape) \
            or tuple(scalars.shape) != (3,):
        raise ValueError(
            f"subspace_adam: b {tuple(b.shape)}, g {tuple(g.shape)}, m "
            f"{tuple(m.shape)}, v {tuple(v.shape)} must share one shape "
            f"and scalars {tuple(scalars.shape)} must be (3,)")


def subspace_adam(b: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, scalars: torch.Tensor, *, beta1: float,
                  beta2: float, eps: float, wd: float):
    """(b', m', v') fp32.  ``scalars`` is ``(lr, bc1, bc2)`` as a (3,)
    fp32 tensor on b's device."""
    if not _route(b, "subspace_adam"):
        lr, bc1, bc2 = scalars.float()
        return ref.subspace_adam(b, g, m, v, lr=lr, beta1=beta1,
                                 beta2=beta2, eps=eps, wd=wd, bc1=bc1,
                                 bc2=bc2)
    _check(b, g, m, v, scalars)
    outs = tuple(torch.empty_like(t) for t in (b, m, v))
    if b.numel():
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            rc = _kernel()(DTYPE_CODE[g.dtype], b.data_ptr(), g.data_ptr(),
                           m.data_ptr(), v.data_ptr(),
                           *(o.data_ptr() for o in outs),
                           scalars.data_ptr(), b.numel(), beta1, 1 - beta1,
                           beta2, 1 - beta2, eps, wd, stream)
        if rc != 0:
            raise RuntimeError(
                f"subspace_adam kernel launch failed with CUDA error {rc} "
                f"(b {tuple(b.shape)})")
        LAUNCHES[tuple(b.shape)] += 1
    return outs
