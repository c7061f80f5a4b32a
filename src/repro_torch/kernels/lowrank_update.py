"""The outer step's weight merge ``W' = W + V Bᵀ`` and GaLore's
projection ``G_B = Gᵀ V`` on the card: the wrappers of the hand-written
CUDA kernels ``csrc/lowrank_merge.cu`` and ``csrc/lowrank_project.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/lowrank_update.py::
lowrank_merge``, ``::lowrank_merge_sr`` and ``::lowrank_project`` and the
reference dispatch's vmap over leading dims: one call covers every
leading item of a group buffer (``(G, L, K, N)``).
``W``, ``V`` and ``B`` may each be fp32 or bf16 (the training path
meets a bf16 W, a bf16 V and the fp32 B master); the sum accumulates in
fp32 and is written in W's dtype, into ``out`` when given (``out=w``
merges in place).  The route is the tensor's device alone: a CPU tensor
takes the plain version in :mod:`.ref`; a CUDA tensor launches the
kernel or raises.

With ``bits`` (W-shaped int32, values in ``[0, 2**16)``) it is the merge
into a bf16 ``W`` under bf16 masters: the fp32 sum is stochastically
rounded with that caller-supplied noise.

:func:`lowrank_project` takes ``g`` (..,K,N) and ``v`` (..,K,r), each
fp32 or bf16 (GaLore's path meets an fp32 gradient and a bf16 basis),
and returns ``Gᵀ V`` (..,N,r) in fp32; a long K is split into ranges
summed in a fixed order.

Each kernel source has its routes on the card, chosen per launch by
dtype, rank and alignment alone (:func:`merge_route`,
:func:`project_route`): ``"tc"`` (TMA and ``wgmma`` on the tensor cores:
bf16 W and V with an fp32 or bf16 B for the merge, a bf16 V with an fp32
or bf16 G for the projection, every row length a multiple of 8 and every
pointer 16-byte aligned; an fp32 B or G is carried into the bf16
products as a (hi, lo) pair, :func:`ref.split_hi_lo`), ``"ew"`` (the
plain merge of an fp32 W or V at rank at most ``SMALL_RANK``: an
elementwise pass over W, the rank-r product in registers) or ``"simt"``
(fp32 FMAs: fp32 W or V at larger rank, the stochastically rounded
merge, bf16 rows TMA cannot address).  None gives way to another: a
failed launch raises.

``LAUNCHES`` counts launches per ``(kernel, route, shape)``: kernel
``"lowrank_merge"`` or ``"lowrank_merge_sr"`` (the rounded form) with
the shape of w, or ``"lowrank_project"`` with the shape of g.  A
projection whose K is split keeps one int counter per output tile in
the per-device buffer of the decode forward (``lowrank_forward``), which
every launch leaves zeroed, so launches on one device are ordered on one
stream.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .lowrank_forward import (DTYPE_CODE, MIN_K_PER_SPLIT, SMALL_RANK, SMS,
                              TILE, _counters, _route, tc_route)

# (kernel, route, shape of w or g) -> launches on CUDA tensors; route
# "tc" | "ew" | "simt"
LAUNCHES: collections.Counter = collections.Counter()

# the tensor-core projection: 128 output rows x 128 rank columns per
# block, 64-deep stages, a K range at least 4 stages deep
PROJECT_TILE, PROJECT_BK, PROJECT_MIN_STAGES = 128, 64, 4


def launches(kernel: Optional[str] = None,
             route: Optional[str] = None) -> int:
    """Launches counted so far, of one kernel and route or of all."""
    return sum(n for (k, rt, _), n in LAUNCHES.items()
               if kernel in (None, k) and route in (None, rt))


def reset_launches() -> None:
    LAUNCHES.clear()


_VP, _CI = ctypes.c_void_p, ctypes.c_int


def merge_route(w_dtype: torch.dtype, v_dtype: torch.dtype,
                b_dtype: torch.dtype, K: int, N: int, r: int,
                bits: bool = False, ptrs=()) -> str:
    """``"tc"`` where the tensor-core merge takes a launch — bf16 W and
    V, an fp32 or bf16 B, no rounding ``bits``, K, N and r multiples of
    8 and every pointer 16-byte aligned; ``"ew"`` for the plain merge of
    an fp32 W or V (the dtypes the tensor cores do not take) of rank at
    most ``SMALL_RANK``; else ``"simt"``."""
    if bits:
        return "simt"
    if torch.float32 in (w_dtype, v_dtype):
        return "ew" if r <= SMALL_RANK else "simt"
    if w_dtype != torch.bfloat16 or b_dtype not in (
            torch.float32, torch.bfloat16):
        return "simt"
    return tc_route(v_dtype, K, N, r, ptrs)


def project_route(g_dtype: torch.dtype, v_dtype: torch.dtype, K: int,
                  N: int, r: int, ptrs=()) -> str:
    """``"tc"`` where the tensor-core projection takes a launch — a bf16
    V, an fp32 or bf16 G, K, N and r multiples of 8 and every pointer
    16-byte aligned — else ``"simt"``."""
    if g_dtype not in (torch.float32, torch.bfloat16):
        return "simt"
    return tc_route(v_dtype, K, N, r, ptrs)


def project_tiles(items: int, N: int, r: int) -> int:
    """Output tiles of a tensor-core projection launch."""
    return items * -(-N // PROJECT_TILE) * -(-r // PROJECT_TILE)


def project_plan(items: int, K: int, N: int, r: int) -> int:
    """How many K ranges a tensor-core projection launch splits into.  A
    block holds 210 KB of shared memory, so the card runs one per SM: as
    many ranges as keep the blocks (tiles x ranges) within one wave of
    ``SMS``, each at least ``PROJECT_MIN_STAGES`` 64-deep stages.  A
    second wave costs more than it fills (``chip_smoke.py`` times
    llama-100m's w_down group, 60 tiles over K = 1712, at 1, 2 and 3
    ranges)."""
    stages = -(-K // PROJECT_BK)
    return max(1, min(SMS // project_tiles(items, N, r),
                      stages // PROJECT_MIN_STAGES))


def project_ranges(K: int, splits: int) -> list:
    """The ``[begin, end)`` K ranges of a tensor-core projection launch,
    as the kernel cuts them: range z holds stages ``[z S / splits, (z +
    1) S / splits)`` of the S = ceil(K / 64), so every range starts on a
    stage, holds whole stages (the last ends at K) and none is empty."""
    stages = -(-K // PROJECT_BK)
    return [(z * stages // splits * PROJECT_BK,
             min(K, (z + 1) * stages // splits * PROJECT_BK))
            for z in range(splits)]


@functools.cache
def _kernel():
    fn = _build.load("lowrank_merge").lowrank_merge_launch
    # tw, tv, tb, w, v, b, out, batch, K, N, r, stream
    fn.argtypes = [_CI] * 3 + [_VP] * 4 + [ctypes.c_longlong] + [_CI] * 3 \
        + [_VP]
    fn.restype = _CI
    return fn


@functools.cache
def _ew_kernel():
    fn = _build.load("lowrank_merge").lowrank_merge_ew_launch
    # tw, tv, tb, w, v, b, out, batch, K, N, r, stream
    fn.argtypes = [_CI] * 3 + [_VP] * 4 + [ctypes.c_longlong] + [_CI] * 3 \
        + [_VP]
    fn.restype = _CI
    return fn


@functools.cache
def _sr_kernel():
    fn = _build.load("lowrank_merge").lowrank_merge_sr_launch
    # tv, tb, w, v, b, bits, out, batch, K, N, r, stream
    fn.argtypes = [_CI] * 2 + [_VP] * 5 + [ctypes.c_longlong] + [_CI] * 3 \
        + [_VP]
    fn.restype = _CI
    return fn


@functools.cache
def _tc_kernel():
    fn = _build.load("lowrank_merge").lowrank_merge_tc_launch
    # tb, w, v, b, out, batch, K, N, r, stream
    fn.argtypes = [_CI] + [_VP] * 4 + [ctypes.c_longlong] + [_CI] * 3 + [_VP]
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
    items = w.numel() // (K * N)
    route = merge_route(w.dtype, v.dtype, b.dtype, K, N, r,
                        bits is not None,
                        (t.data_ptr() for t in (w, v, b, out)))
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        if route == "tc":
            rc = _tc_kernel()(DTYPE_CODE[b.dtype], w.data_ptr(),
                              v.data_ptr(), b.data_ptr(), out.data_ptr(),
                              items, K, N, r, stream)
        elif route == "ew":
            rc = _ew_kernel()(DTYPE_CODE[w.dtype], DTYPE_CODE[v.dtype],
                              DTYPE_CODE[b.dtype], w.data_ptr(),
                              v.data_ptr(), b.data_ptr(), out.data_ptr(),
                              items, K, N, r, stream)
        elif bits is not None:
            rc = _sr_kernel()(DTYPE_CODE[v.dtype], DTYPE_CODE[b.dtype],
                              w.data_ptr(), v.data_ptr(), b.data_ptr(),
                              bits.data_ptr(), out.data_ptr(), items, K, N,
                              r, stream)
        else:
            rc = _kernel()(DTYPE_CODE[w.dtype], DTYPE_CODE[v.dtype],
                           DTYPE_CODE[b.dtype], w.data_ptr(), v.data_ptr(),
                           b.data_ptr(), out.data_ptr(), items, K, N, r,
                           stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel ({route} route) launch failed with error {rc} "
            f"(a CUDA error, or a negated CUresult of the tensor-map "
            f"encoding; w {tuple(w.shape)}, r={r})")
    LAUNCHES[(name, route, tuple(w.shape))] += 1
    return out


# ---------------------------------------------------------------------------
# G_B = Gᵀ V (GaLore's projection)
# ---------------------------------------------------------------------------

MAX_GRID_Z = 65535          # the SIMT grid's z extent: items x K ranges


def project_splits(items: int, K: int, N: int, r: int) -> int:
    """How many K ranges the SIMT projection splits into: about four blocks
    per SM over all ``items``, each range at least ``MIN_K_PER_SPLIT``
    deep, and ``items`` x ranges within the grid's z extent."""
    tiles = items * -(-N // TILE) * -(-r // TILE)
    s = min(-(-4 * SMS // tiles), -(-K // MIN_K_PER_SPLIT),
            MAX_GRID_Z // items)
    return max(1, s)


@functools.cache
def _project_tc_kernel():
    fn = _build.load("lowrank_project").lowrank_project_tc_launch
    # tg, g, v, out, part, counters, splits, batch, K, N, r, stream
    fn.argtypes = [_CI] + [_VP] * 5 + [_CI, ctypes.c_longlong] \
        + [_CI] * 3 + [_VP]
    fn.restype = _CI
    return fn


@functools.cache
def _project_kernel():
    fn = _build.load("lowrank_project").lowrank_project_launch
    # tg, tv, g, v, out, part, splits, batch, K, N, r, stream
    fn.argtypes = [_CI, _CI, _VP, _VP, _VP, _VP, _CI, ctypes.c_longlong,
                   _CI, _CI, _CI, _VP]
    fn.restype = _CI
    return fn


def _check_project(g, v) -> None:
    name = "lowrank_project"
    if v.device != g.device:
        raise ValueError(f"{name}: v is on {v.device}, g on {g.device}")
    for t_name, t in (("g", g), ("v", v)):
        if t.dtype not in DTYPE_CODE:
            raise TypeError(
                f"{name}: the CUDA kernel takes float32 or bfloat16 "
                f"operands, got {t_name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} is not contiguous")
    if v.ndim != g.ndim or tuple(v.shape[:-1]) != tuple(g.shape[:-1]):
        raise ValueError(
            f"{name}: shapes g {tuple(g.shape)}, v {tuple(v.shape)} do not "
            f"fit g (.., K, N), v (.., K, r)")


def lowrank_project(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Gᵀ V over any leading dims: g (..,K,N), v (..,K,r), each fp32 or
    bf16 -> (..,N,r) fp32, accumulated in fp32."""
    if g.ndim < 2:
        raise ValueError(f"lowrank_project: g must be (.., K, N), got "
                         f"{tuple(g.shape)}")
    if not _route(g, "lowrank_project"):
        return ref.lowrank_project(g, v)
    _check_project(g, v)
    lead, (K, N), r = tuple(g.shape[:-2]), g.shape[-2:], v.shape[-1]
    out = torch.empty(lead + (N, r), dtype=torch.float32, device=g.device)
    items = math.prod(lead)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    route = project_route(g.dtype, v.dtype, K, N, r,
                          (t.data_ptr() for t in (g, v, out)))
    dev = g.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc":
            s = project_plan(items, K, N, r)
            tiles = project_tiles(items, N, r)
            part = torch.empty(s * tiles * PROJECT_TILE ** 2 if s > 1 else 0,
                               dtype=torch.float32, device=dev)
            counters = _counters(dev, tiles) if s > 1 else None
            rc = _project_tc_kernel()(
                DTYPE_CODE[g.dtype], g.data_ptr(), v.data_ptr(),
                out.data_ptr(), part.data_ptr() if s > 1 else None,
                None if counters is None else counters.data_ptr(), s, items,
                K, N, r, stream)
        else:
            if items > MAX_GRID_Z:
                raise ValueError(f"lowrank_project: {items} leading items, "
                                 f"the SIMT kernel takes at most "
                                 f"{MAX_GRID_Z}")
            s = project_splits(items, K, N, r)
            part = torch.empty((items * s, N, r) if s > 1 else (0,),
                               dtype=torch.float32, device=dev)
            rc = _project_kernel()(DTYPE_CODE[g.dtype], DTYPE_CODE[v.dtype],
                                   g.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), part.data_ptr(), s, items,
                                   K, N, r, stream)
    if rc != 0:
        raise RuntimeError(
            f"lowrank_project kernel ({route} route) launch failed with "
            f"error {rc} (a CUDA error, or a negated CUresult of the "
            f"tensor-map encoding; g {tuple(g.shape)}, r={r})")
    LAUNCHES[("lowrank_project", route, tuple(g.shape))] += 1
    return out
