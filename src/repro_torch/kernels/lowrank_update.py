"""The outer step's weight merge ``W' = W + V Bᵀ`` on the card: wrapper of
the hand-written CUDA kernel ``csrc/lowrank_merge.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/lowrank_update.py::
lowrank_merge`` and the reference dispatch's vmap over leading dims: one
launch covers every leading item of a group buffer (``(G, L, K, N)``).
``W``, ``V`` and ``B`` may each be fp32 or bf16 (the training path
meets a bf16 W, a bf16 V and the fp32 B master); the sum accumulates in
fp32 and is written in W's dtype, into ``out`` when given (``out=w``
merges in place).  The route is the tensor's device alone: a CPU tensor
takes the plain version in :mod:`.ref`; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts launches per shape of ``w``.
``merge_sr`` and ``project`` of the reference module are not ported yet.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .lowrank_forward import DTYPE_CODE, _route

# w's shape -> launches on CUDA tensors
LAUNCHES: collections.Counter = collections.Counter()


def launches() -> int:
    return sum(LAUNCHES.values())


def reset_launches() -> None:
    LAUNCHES.clear()


@functools.cache
def _kernel():
    fn = _build.load("lowrank_merge").lowrank_merge_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, ctypes.c_longlong, ci, ci,
                   ci, vp]
    fn.restype = ci
    return fn


def _check(w, v, b, out) -> None:
    for name, t in (("v", v), ("b", b), ("out", out)):
        if t.device != w.device:
            raise ValueError(
                f"lowrank_merge: {name} is on {t.device}, w on {w.device}")
    for name, t in (("w", w), ("v", v), ("b", b)):
        if t.dtype not in DTYPE_CODE:
            raise TypeError(
                f"lowrank_merge: the CUDA kernel takes float32 or bfloat16 "
                f"operands, got {name} {t.dtype}")
    if out.dtype != w.dtype:
        raise TypeError(f"lowrank_merge: out is {out.dtype}, w {w.dtype}")
    for name, t in (("w", w), ("v", v), ("b", b), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"lowrank_merge: {name} is not contiguous")
    lead, (K, N), r = w.shape[:-2], w.shape[-2:], v.shape[-1]
    if (tuple(v.shape) != tuple(lead) + (K, r)
            or tuple(b.shape) != tuple(lead) + (N, r)
            or out.shape != w.shape):
        raise ValueError(
            f"lowrank_merge: shapes w {tuple(w.shape)}, v {tuple(v.shape)}, "
            f"b {tuple(b.shape)}, out {tuple(out.shape)} do not fit "
            f"w (.., K, N), v (.., K, r), b (.., N, r)")


def lowrank_merge(w: torch.Tensor, v: torch.Tensor, b: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W + V Bᵀ over any leading dims: w (..,K,N), v (..,K,r), b (..,N,r);
    fp32 accumulate, W's dtype out (``out`` if given, else a new
    tensor)."""
    if w.ndim < 2:
        raise ValueError(f"lowrank_merge: w must be (.., K, N), got "
                         f"{tuple(w.shape)}")
    if not _route(w, "lowrank_merge"):
        merged = ref.lowrank_merge(w, v, b)
        return merged if out is None else out.copy_(merged)
    if out is None:
        out = torch.empty_like(w)
    _check(w, v, b, out)
    K, N = w.shape[-2:]
    r = v.shape[-1]
    batch = w.numel() // max(K * N, 1)
    if w.numel() == 0 or r == 0:
        return out.copy_(w)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = _kernel()(DTYPE_CODE[w.dtype], DTYPE_CODE[v.dtype],
                       DTYPE_CODE[b.dtype], w.data_ptr(), v.data_ptr(),
                       b.data_ptr(), out.data_ptr(), batch, K, N, r, stream)
    if rc != 0:
        raise RuntimeError(
            f"lowrank_merge kernel launch failed with CUDA error {rc} "
            f"(w {tuple(w.shape)}, r={r})")
    LAUNCHES[tuple(w.shape)] += 1
    return out
