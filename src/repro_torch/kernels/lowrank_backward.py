"""The low-rank backward ``dx = dy Wᵀ + (dy B) Vᵀ``, ``dB = dyᵀ p`` on
the card: wrapper of the hand-written CUDA kernel
``csrc/lowrank_backward.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/lowrank_backward.py::
lowrank_backward``.  The route is the tensor's device alone: a CPU
tensor takes the plain version in :mod:`.ref`; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES`` counts launches per ``(K, N)``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build, ref
from .lowrank_forward import DTYPE_CODE, MIN_K_PER_SPLIT, SMS, TILE, _route

# (K, N) -> launches on CUDA tensors
LAUNCHES: collections.Counter = collections.Counter()


def launches() -> int:
    return sum(LAUNCHES.values())


def reset_launches() -> None:
    LAUNCHES.clear()


def db_splits(M: int, N: int, r: int) -> int:
    """How many M ranges the ``dB = dyᵀ p`` pass splits into: about four
    blocks per SM, each range at least ``MIN_K_PER_SPLIT`` rows deep."""
    tiles = -(-N // TILE) * -(-r // TILE)
    return max(1, min(-(-4 * SMS // tiles), -(-M // MIN_K_PER_SPLIT)))


@functools.cache
def _kernel():
    fn = _build.load("lowrank_backward").lowrank_backward_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                   ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def _check(dy, w, v, b, p) -> None:
    for name, t in (("w", w), ("v", v), ("b", b), ("p", p)):
        if t.device != dy.device:
            raise ValueError(
                f"lowrank_backward: {name} is on {t.device}, dy on "
                f"{dy.device}")
        if t.dtype != dy.dtype:
            raise TypeError(
                f"lowrank_backward: the CUDA kernel takes one dtype for "
                f"dy, w, v, b, p; got dy {dy.dtype}, {name} {t.dtype}")
    if dy.dtype not in DTYPE_CODE:
        raise TypeError(
            f"lowrank_backward: the CUDA kernel takes float32 or bfloat16, "
            f"got {dy.dtype}")
    for name, t in (("dy", dy), ("w", w), ("v", v), ("b", b), ("p", p)):
        if not t.is_contiguous():
            raise ValueError(f"lowrank_backward: {name} is not contiguous")
    M, N = dy.shape
    K, r = w.shape[0], v.shape[-1]
    if (w.ndim != 2 or v.ndim != 2 or b.ndim != 2 or p.ndim != 2
            or tuple(w.shape) != (K, N) or tuple(v.shape) != (K, r)
            or tuple(b.shape) != (N, r) or tuple(p.shape) != (M, r)):
        raise ValueError(
            f"lowrank_backward: shapes dy {tuple(dy.shape)}, w "
            f"{tuple(w.shape)}, v {tuple(v.shape)}, b {tuple(b.shape)}, "
            f"p {tuple(p.shape)} do not fit dy (M, N), w (K, N), v (K, r), "
            f"b (N, r), p (M, r)")


def lowrank_backward(dy: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     b: torch.Tensor, p: torch.Tensor):
    """(dx (M,K) in dy's dtype, dB (N,r) fp32) from dy (M,N), w (K,N),
    v (K,r), b (N,r) and the forward's residual p (M,r)."""
    if not _route(dy, "lowrank_backward"):
        return ref.lowrank_backward(dy, w, v, b, p)
    if dy.ndim != 2:
        raise ValueError(f"lowrank_backward: dy must be (M, N), got "
                         f"{tuple(dy.shape)}")
    _check(dy, w, v, b, p)
    M, N = dy.shape
    K, r = w.shape[0], v.shape[1]
    dev = dy.device
    dx = torch.empty((M, K), dtype=dy.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if M == 0:
        return dx, torch.zeros((N, r), **f32)
    s = db_splits(M, N, r)
    db = torch.empty((N, r), **f32)
    q = torch.empty((M, r), **f32)
    db_part = torch.empty((s, N, r), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(DTYPE_CODE[dy.dtype], dy.data_ptr(), w.data_ptr(),
                       v.data_ptr(), b.data_ptr(), p.data_ptr(),
                       dx.data_ptr(), db.data_ptr(), q.data_ptr(),
                       db_part.data_ptr(), s, M, K, N, r, stream)
    if rc != 0:
        raise RuntimeError(
            f"lowrank_backward kernel launch failed with CUDA error {rc} "
            f"(dy {tuple(dy.shape)}, w {tuple(w.shape)}, r={r})")
    LAUNCHES[(K, N)] += 1
    return dx, db
