"""The outer step's weight merge ``W' = W + V Bᵀ`` on the card: the
wrapper of the hand-written CUDA kernel ``csrc/lowrank_merge.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/lowrank_update.py::
lowrank_merge`` and ``::lowrank_merge_sr`` and the reference dispatch's
vmap over leading dims: one launch covers every leading item of a group
buffer (``(G, L, K, N)``).
``W``, ``V`` and ``B`` may each be fp32 or bf16 (the training path
meets a bf16 W, a bf16 V and the fp32 B master); the sum accumulates in
fp32 and is written in W's dtype, into ``out`` when given (``out=w``
merges in place).  The route is the tensor's device alone: a CPU tensor
takes the plain version in :mod:`.ref`; a CUDA tensor launches the
kernel or raises.

With ``bits`` (W-shaped int32, values in ``[0, 2**16)``) it is the merge
into a bf16 ``W`` under bf16 masters: the fp32 sum is stochastically
rounded with that caller-supplied noise.  ``LAUNCHES`` counts launches
per ``(kernel, shape of w)``, kernel ``"lowrank_merge"`` or
``"lowrank_merge_sr"`` (the rounded form).  ``project`` of the reference
module is not ported yet.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .lowrank_forward import DTYPE_CODE, _route

# (kernel, w's shape) -> launches on CUDA tensors
LAUNCHES: collections.Counter = collections.Counter()


def launches(kernel: Optional[str] = None) -> int:
    """Launches counted so far, of one kernel or of all."""
    return sum(n for (k, _), n in LAUNCHES.items()
               if kernel is None or k == kernel)


def reset_launches() -> None:
    LAUNCHES.clear()


_VP, _CI = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    fn = _build.load("lowrank_merge").lowrank_merge_launch
    # tw, tv, tb, w, v, b, bits, out, batch, K, N, r, stream
    fn.argtypes = [_CI] * 3 + [_VP] * 5 + [ctypes.c_longlong] + [_CI] * 3 \
        + [_VP]
    fn.restype = _CI
    return fn


def _check(w, v, b, out, bits=None, name="lowrank_merge") -> None:
    named = (("w", w), ("v", v), ("b", b), ("out", out)) + (
        () if bits is None else (("bits", bits),))
    for t_name, t in named[1:]:
        if t.device != w.device:
            raise ValueError(
                f"{name}: {t_name} is on {t.device}, w on {w.device}")
    for t_name, t in named[:3]:
        if t.dtype not in DTYPE_CODE:
            raise TypeError(
                f"{name}: the CUDA kernel takes float32 or bfloat16 "
                f"operands, got {t_name} {t.dtype}")
    if out.dtype != w.dtype:
        raise TypeError(f"{name}: out is {out.dtype}, w {w.dtype}")
    for t_name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} is not contiguous")
    lead, (K, N), r = w.shape[:-2], w.shape[-2:], v.shape[-1]
    if (tuple(v.shape) != tuple(lead) + (K, r)
            or tuple(b.shape) != tuple(lead) + (N, r)
            or out.shape != w.shape
            or (bits is not None and bits.shape != w.shape)):
        raise ValueError(
            f"{name}: shapes w {tuple(w.shape)}, v {tuple(v.shape)}, "
            f"b {tuple(b.shape)}, out {tuple(out.shape)}"
            + ("" if bits is None else f", bits {tuple(bits.shape)}")
            + " do not fit w (.., K, N), v (.., K, r), b (.., N, r)")


def lowrank_merge(w: torch.Tensor, v: torch.Tensor, b: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W + V Bᵀ over any leading dims: w (..,K,N), v (..,K,r), b (..,N,r);
    fp32 accumulate, W's dtype out (``out`` if given, else a new tensor;
    ``out=w`` merges in place).  With ``bits`` (w-shaped int32 in
    [0, 2**16)) the sum is stochastically rounded into a bf16 W:
    sr_bf16(W + V Bᵀ, bits)."""
    name = "lowrank_merge" if bits is None else "lowrank_merge_sr"
    if w.ndim < 2:
        raise ValueError(f"{name}: w must be (.., K, N), got "
                         f"{tuple(w.shape)}")
    if not _route(w, name):
        merged = (ref.lowrank_merge(w, v, b) if bits is None
                  else ref.lowrank_merge_sr(w, v, b, bits))
        return merged if out is None else out.copy_(merged)
    if bits is not None and (w.dtype != torch.bfloat16
                             or bits.dtype != torch.int32):
        raise TypeError(f"{name}: w must be bfloat16 and bits int32, got "
                        f"w {w.dtype}, bits {bits.dtype}")
    if out is None:
        out = torch.empty_like(w)
    _check(w, v, b, out, bits, name)
    K, N = w.shape[-2:]
    r = v.shape[-1]
    if w.numel() == 0 or r == 0:
        return out.copy_(w)     # sr_bf16 keeps a bf16 value as it is
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = _kernel()(DTYPE_CODE[w.dtype], DTYPE_CODE[v.dtype],
                       DTYPE_CODE[b.dtype], w.data_ptr(), v.data_ptr(),
                       b.data_ptr(), None if bits is None else
                       bits.data_ptr(), out.data_ptr(), w.numel() // (K * N),
                       K, N, r, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with CUDA error {rc} "
            f"(w {tuple(w.shape)}, r={r})")
    LAUNCHES[(name, tuple(w.shape))] += 1
    return out
