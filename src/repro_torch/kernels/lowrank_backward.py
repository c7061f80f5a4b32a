"""The low-rank backward ``dx = dy Wᵀ + (dy B) Vᵀ``, ``dB = dyᵀ p`` on
the card: wrapper of the hand-written CUDA kernel
``csrc/lowrank_backward.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/lowrank_backward.py::
lowrank_backward``.  The tensor's device chooses between kernel and
plain version: a CPU tensor takes the plain version in :mod:`.ref`; a
CUDA tensor launches a kernel or raises.  On the card
:func:`~.lowrank_forward.tc_route` chooses the tensor-core route
(``"tc"``: bf16, row lengths multiples of 8, aligned pointers) or the
SIMT one (``"simt"``); neither gives way to the other.  ``LAUNCHES``
counts launches per ``(route, K, N)``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build, ref
from .lowrank_forward import (DTYPE_CODE, MIN_K_PER_SPLIT, SMS, TILE,
                              _counters, _route, gemm_plan, gemm_scratch,
                              tc_route)

# (route, K, N) -> launches on CUDA tensors; route "tc" | "simt"
LAUNCHES: collections.Counter = collections.Counter()


def launches(route: str | None = None) -> int:
    return sum(n for (rt, _, _), n in LAUNCHES.items()
               if route in (None, rt))


def reset_launches() -> None:
    LAUNCHES.clear()


def db_splits(M: int, N: int, r: int) -> int:
    """How many M ranges the ``dB = dyᵀ p`` pass splits into: about four
    blocks per SM, each range at least ``MIN_K_PER_SPLIT`` rows deep."""
    tiles = -(-N // TILE) * -(-r // TILE)
    return max(1, min(-(-4 * SMS // tiles), -(-M // MIN_K_PER_SPLIT)))


def tc_plan(M: int, K: int, N: int, r: int) -> tuple:
    """``(plan of the q pass, of the dx pass, of the dB pass)`` of one
    tensor-core launch, each ``(bn, splits, cluster)`` from
    :func:`~.lowrank_forward.gemm_plan` over its output and depth: q (M,
    r) over N, dx (M, K) over N, dB (N, r) over M."""
    return gemm_plan(M, r, N), gemm_plan(M, K, N, 2 * r), gemm_plan(N, r, M)


def scratch_plan(route: str, M: int, N: int, r: int, K: int) -> dict:
    """``{name: (shape, dtype)}`` of the scratch one launch allocates:
    q = dy B as a bf16 (hi, lo) pair on the tensor-core route (fp32 on
    the SIMT one); on the tensor-core route each pass's fp32 partials
    where it splits (``part_q``, ``part_x``, ``part_b``: a 128 × bn
    partial per unit), on the SIMT one dB's split partials."""
    f32 = torch.float32
    if route == "tc":
        plan = {"q_hi": ((M, r), torch.bfloat16),
                "q_lo": ((M, r), torch.bfloat16)}
        outs = ((M, r), (M, K), (N, r))
        for name, (rows, cols), pl in zip(
                ("part_q", "part_x", "part_b"), outs, tc_plan(M, K, N, r)):
            n, _ = gemm_scratch(rows, cols, *pl[:2])
            if n:
                plan[name] = ((n,), f32)
        return plan
    return {"q": ((M, r), f32),
            "db_part": ((db_splits(M, N, r), N, r), f32)}


@functools.cache
def _kernel():
    """The SIMT route's C entry point, built and loaded on first use."""
    fn = _build.load("lowrank_backward").lowrank_backward_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                   ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


@functools.cache
def _tc_kernel():
    """The tensor-core route's C entry point."""
    fn = _build.load("lowrank_backward").lowrank_backward_tc_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 14 + [ci] * 4 + [vp]
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
    route = tc_route(dy.dtype, K, N, r,
                     (t.data_ptr() for t in (dy, w, v, b, p)))
    buf = {name: torch.empty(shape, dtype=dt, device=dev) for name,
           (shape, dt) in scratch_plan(route, M, N, r, K).items()}
    db = torch.empty((N, r), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc":
            plan = tc_plan(M, K, N, r)
            tiles = sum(gemm_scratch(rows, cols, *pl[:2])[1]
                        for (rows, cols), pl
                        in zip(((M, r), (M, K), (N, r)), plan))
            ints = (ctypes.c_int * 9)(*(i for pl in plan for i in pl))
            ptr = {name: None if name not in buf else buf[name].data_ptr()
                   for name in ("part_q", "part_x", "part_b")}
            rc = _tc_kernel()(dy.data_ptr(), w.data_ptr(), v.data_ptr(),
                              b.data_ptr(), p.data_ptr(), dx.data_ptr(),
                              db.data_ptr(), buf["q_hi"].data_ptr(),
                              buf["q_lo"].data_ptr(), ptr["part_q"],
                              ptr["part_x"], ptr["part_b"],
                              _counters(dev, tiles).data_ptr(), ints, M, K,
                              N, r, stream)
        else:
            rc = _kernel()(DTYPE_CODE[dy.dtype], dy.data_ptr(),
                           w.data_ptr(), v.data_ptr(), b.data_ptr(),
                           p.data_ptr(), dx.data_ptr(), db.data_ptr(),
                           buf["q"].data_ptr(), buf["db_part"].data_ptr(),
                           db_splits(M, N, r), M, K, N, r, stream)
    if rc != 0:
        raise RuntimeError(
            f"lowrank_backward kernel ({route} route) launch failed with "
            f"error {rc} (a CUDA error, or a negated CUresult of the "
            f"tensor-map encoding; dy {tuple(dy.shape)}, w "
            f"{tuple(w.shape)}, r={r})")
    LAUNCHES[(route, K, N)] += 1
    return dx, db
