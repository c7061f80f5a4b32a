"""The low-rank forward ``y = xW + (xV)Bᵀ`` on the card: wrapper of the
hand-written CUDA kernel ``csrc/lowrank_forward.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/lowrank_forward.py::
lowrank_forward``, both its forms, and the reference's per-row-B form
``repro/kernels/dispatch.py::_pallas_batch_forward`` (a ``vmap`` over
that kernel).  Three call forms share one kernel source:

* :func:`lowrank_forward` — one ``B (N, r)`` for every row (prefill,
  ``LRPack``);
* :func:`lowrank_forward` with ``return_p=True`` — the same, and also
  ``p = x V`` in x's dtype, the residual the training backward keeps
  (the TPU kernel's ``return_p`` form);
* :func:`lowrank_batch_forward` — one ``B`` per batch row (decode,
  ``BatchLRPack``): ``b (batch, N, r)``, or the adapter store's
  ``(T, N, r)`` stack read by a ``(batch,)`` tenant index ``rows``.

The tensor's device chooses between kernel and plain version: a CPU
tensor takes the plain version in :mod:`.ref`; a CUDA tensor launches a
kernel or raises.  There is no fallback.  On the card, :func:`tc_route`
chooses between the kernel source's two routes by dtype and alignment
alone, for every form: ``"tc"`` (TMA and ``wgmma`` on the tensor cores,
in bf16 with every row length a multiple of 8 and 16-byte-aligned
pointers) or ``"simt"`` (fp32 FMAs: fp32 and rows TMA cannot address).
Neither gives way to the other: a failed build or launch raises.
``LAUNCHES`` counts launches per ``(form, route, K, N)`` — form
``"shared"``, ``"p"`` (return_p) or ``"batched"`` — so a run can show
that its main path went through the kernel, and by which route.

The per-row-B ``"tc"`` launch reads nothing back on the host (not
``rows``, not a length), so a decode step can be captured in a CUDA
graph; it keeps one int counter per output tile in a per-device buffer
that every launch leaves zeroed, so launches on one device are ordered
on one stream.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build, ref

# (form, route, K, N) -> launches on CUDA tensors; form "shared" | "p" |
# "batched", route "tc" | "simt"
LAUNCHES: collections.Counter = collections.Counter()

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                 # BM = BN of the SIMT kernels
SMS = 132                 # H100 SXM streaming multiprocessors
MIN_K_PER_SPLIT = 256
TC_ALIGN = 8              # bf16 elements in the 16 bytes TMA aligns to
# the per-row-B tensor-core kernel: 128 output columns per block, 64-deep
# stages, two blocks resident per SM, a split at least 8 stages deep
DEC_TILE, DEC_BK, DEC_BLOCKS, DEC_MIN_STAGES = 128, 64, 2 * SMS, 8

_COUNTERS: dict = {}      # device index -> zeroed int32 tile counters


def launches(form: str | None = None, route: str | None = None) -> int:
    """Launches counted so far, of one form and route or of all."""
    return sum(n for (f, rt, _, _), n in LAUNCHES.items()
               if form in (None, f) and route in (None, rt))


def reset_launches() -> None:
    LAUNCHES.clear()


def splits(M: int, N: int, K: int) -> int:
    """How many K ranges the kernel's GEMM passes split into: enough
    blocks for about four per SM, each range at least
    ``MIN_K_PER_SPLIT`` deep."""
    tiles = -(-N // TILE) * -(-M // TILE)
    return max(1, min(-(-4 * SMS // tiles), -(-K // MIN_K_PER_SPLIT)))


def dec_tile_rows(M: int) -> int:
    """Decode rows per block of the per-row-B tensor-core kernel:
    ``wgmma``'s n8 or n16."""
    return 8 if M <= 8 else 16


def dec_splits(tiles: int, K: int) -> int:
    """How many K ranges a pass of the per-row-B tensor-core kernel
    splits into: enough for ``DEC_BLOCKS`` blocks over ``tiles`` output
    tiles, each range at least ``DEC_MIN_STAGES`` 64-deep stages; no
    range is empty."""
    s = max(1, min(-(-DEC_BLOCKS // tiles),
                   -(-K // (DEC_BK * DEC_MIN_STAGES))))
    chunk = -(-(-(-K // s)) // DEC_BK) * DEC_BK
    return -(-K // chunk)


@functools.lru_cache(maxsize=1024)
def dec_plan(M: int, K: int, N: int, r: int, seq: int = 1) -> tuple:
    """``(rows per tile, p-pass splits, y-pass splits, rank slots)`` of one
    per-row-B tensor-core launch of M = batch × seq rows.  Where the y
    pass splits K, each tile also gets a rank slot per distinct tenant its
    rows can hold (the rows of at most ``(bn - 1) // seq + 2`` batch
    rows), which computes that tenant's rank-r term beside the splits."""
    bn = dec_tile_rows(M)
    tiles_m = -(-M // bn)
    s_y = dec_splits(-(-N // DEC_TILE) * tiles_m, K)
    slots = 0 if s_y == 1 else min(bn, -(-M // seq), (bn - 1) // seq + 2)
    return bn, dec_splits(-(-r // DEC_TILE) * tiles_m, K), s_y, slots


def tc_route(dtype: torch.dtype, K: int, N: int, r: int,
             ptrs=()) -> str:
    """``"tc"`` where the tensor-core route can take a launch of any form
    — bf16, every row length (K, N, r) a multiple of 8 and every pointer
    16-byte aligned, as TMA (and the per-row-B form's ``cp.async`` of B)
    addresses them — else ``"simt"``."""
    if dtype != torch.bfloat16 or any(d % TC_ALIGN for d in (K, N, r)):
        return "simt"
    return "simt" if any(int(p) % 16 for p in ptrs) else "tc"


def scratch_plan(form: str, route: str, M: int, K: int, N: int,
                 r: int, seq: int = 1) -> dict:
    """``{name: (shape, dtype)}`` of the scratch one launch allocates.
    The shared-B tensor-core route keeps p as a bf16 (hi, lo) pair — hi
    is the ``"p"`` form's output itself — and never an (s, M, N) fp32
    buffer.  The per-row-B one keeps p in fp32 and the fp32 partials of
    each pass that splits K, all in one buffer: at decode (M ≤ 16) an
    ``(s + slots, M, N)`` buffer (the splits' and the rank slots'
    partials) only where the output tiles alone cannot fill the card.
    The SIMT route sums split-K partials in fp32."""
    bf16, f32 = torch.bfloat16, torch.float32
    if route == "tc" and form == "batched":
        _, s_p, s_y, slots = dec_plan(M, K, N, r, seq)
        plan = {"p": ((M, r), f32)}
        if s_p > 1:
            plan["p_part"] = ((s_p, M, r), f32)
        if s_y > 1:
            plan["y_part"] = ((s_y + slots, M, N), f32)
        return plan
    if route == "tc":
        plan = {"p_lo": ((M, r), bf16)}
        if form == "shared":
            plan["p_hi"] = ((M, r), bf16)
        return plan
    s_p, s_y = splits(M, r, K), splits(M, N, K)
    plan = {"p_part": ((s_p, M, r), f32), "p": ((M, r), f32)}
    if form == "batched" or s_y > 1:
        plan["y_part"] = ((s_y, M, N), f32)
    return plan


@functools.cache
def _kernel():
    """The SIMT route's C entry point, built and loaded on first use."""
    fn = _build.load("lowrank_forward").lowrank_forward_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, ci,
                   ci, ci, ci, ci, ci, ctypes.c_longlong, vp, ci, vp]
    fn.restype = ci
    return fn


@functools.cache
def _tc_kernel():
    """The tensor-core route's C entry point."""
    fn = _build.load("lowrank_forward").lowrank_forward_tc_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    fn.restype = ci
    return fn


@functools.cache
def _dec_kernel():
    """The per-row-B tensor-core route's C entry point."""
    fn = _build.load("lowrank_forward").lowrank_batch_forward_tc_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 10 + [ci] * 10 + [vp]
    fn.restype = ci
    return fn


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tile counters on ``dev``, kept across
    launches (each launch leaves them zero again)."""
    buf = _COUNTERS.get(dev.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[dev.index] = buf
    return buf


def _check(x, w, v, b, b_ndim: int) -> None:
    dev = x.device
    for name, t in (("w", w), ("v", v), ("b", b)):
        if t.device != dev:
            raise ValueError(
                f"lowrank_forward: {name} is on {t.device}, x on {dev}")
        if t.dtype != x.dtype:
            raise TypeError(
                f"lowrank_forward: the CUDA kernel takes one dtype for "
                f"x, w, v, b; got x {x.dtype}, {name} {t.dtype}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(
            f"lowrank_forward: the CUDA kernel takes float32 or bfloat16, "
            f"got {x.dtype}")
    for name, t in (("x", x), ("w", w), ("v", v), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"lowrank_forward: {name} is not contiguous")
    K, N, r = x.shape[-1], w.shape[-1], v.shape[-1]
    if (w.ndim != 2 or v.ndim != 2 or b.ndim != b_ndim
            or w.shape[0] != K or v.shape[0] != K
            or tuple(b.shape[-2:]) != (N, r)):
        raise ValueError(
            f"lowrank_forward: shapes x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, v {tuple(v.shape)}, b {tuple(b.shape)} "
            f"do not fit x (.., K), w (K, N), v (K, r), b (.., N, r)")


def _launch(form: str, x2, w, v, b, seq: int, rows=None):
    """Queue the kernel; returns y, or (y, p) for the ``"p"`` form."""
    M, K = x2.shape
    N, r = w.shape[1], v.shape[1]
    dev = x2.device
    y = torch.empty((M, N), dtype=x2.dtype, device=dev)
    p_out = torch.empty((M, r), dtype=x2.dtype, device=dev) \
        if form == "p" else None
    if M == 0:
        return y if p_out is None else (y, p_out)
    route = tc_route(x2.dtype, K, N, r,
                     (t.data_ptr() for t in (x2, w, v, b)))
    plan = scratch_plan(form, route, M, K, N, r, seq)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc" and form == "batched":
            rc = _launch_dec(x2, w, v, b, y, plan, seq, rows, stream)
        elif route == "tc":
            buf = {name: torch.empty(shape, dtype=dt, device=dev)
                   for name, (shape, dt) in plan.items()}
            p_hi = buf["p_hi"] if p_out is None else p_out
            rc = _tc_kernel()(x2.data_ptr(), w.data_ptr(), v.data_ptr(),
                              b.data_ptr(), y.data_ptr(), p_hi.data_ptr(),
                              buf["p_lo"].data_ptr(), M, K, N, r, stream)
        else:
            buf = {name: torch.empty(shape, dtype=dt, device=dev)
                   for name, (shape, dt) in plan.items()}
            y_part = buf.get("y_part")
            batched = form == "batched"
            rc = _kernel()(DTYPE_CODE[x2.dtype], x2.data_ptr(),
                           w.data_ptr(), v.data_ptr(), b.data_ptr(),
                           y.data_ptr(),
                           None if p_out is None else p_out.data_ptr(),
                           buf["p_part"].data_ptr(), splits(M, r, K),
                           buf["p"].data_ptr(),
                           None if y_part is None else y_part.data_ptr(),
                           splits(M, N, K), M, K, N, r, seq,
                           N * r if batched else 0,
                           None if rows is None else rows.data_ptr(),
                           b.shape[0] if batched else 1, stream)
    if rc != 0:
        raise RuntimeError(
            f"lowrank_forward kernel ({form} form, {route} route) launch "
            f"failed with error {rc} (a CUDA error, or a negated CUresult "
            f"of the tensor-map encoding; x {tuple(x2.shape)}, w "
            f"{tuple(w.shape)}, r={r})")
    LAUNCHES[(form, route, K, N)] += 1
    return y if p_out is None else (y, p_out)


def _launch_dec(x2, w, v, b, y, plan, seq, rows, stream) -> int:
    """Queue the per-row-B tensor-core route's two launches (p pass, y
    pass) in one C call; one fp32 scratch buffer holds ``plan``."""
    M, K = x2.shape
    N, r = w.shape[1], v.shape[1]
    bn, s_p, s_y, slots = dec_plan(M, K, N, r, seq)
    sizes = [math.prod(shape) for shape, _ in plan.values()]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x2.device)
    base, ptr, off = scratch.data_ptr(), {}, 0
    for name, n in zip(plan, sizes):
        ptr[name] = base + 4 * off
        off += n
    tiles_m = -(-M // bn)
    # the two passes may overlap: each has its own counters
    counters = _counters(x2.device, (-(-r // DEC_TILE) + -(-N // DEC_TILE))
                         * tiles_m)
    return _dec_kernel()(
        x2.data_ptr(), w.data_ptr(), v.data_ptr(), b.data_ptr(),
        None if rows is None else rows.data_ptr(), y.data_ptr(), ptr["p"],
        ptr.get("p_part"), ptr.get("y_part"), counters.data_ptr(), M, K, N,
        r, seq, b.shape[0], bn, s_p, s_y, slots, stream)


def _route(x, op: str = "lowrank_forward") -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{op}: no route for device {x.device}")


def lowrank_forward(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    b: torch.Tensor, return_p: bool = False):
    """y = x W + (x V) Bᵀ.  x (M,K), w (K,N), v (K,r), b (N,r); y in
    x's dtype.  ``return_p=True`` returns ``(y, p)`` with ``p = x V``
    (M, r) in x's dtype; y is built from p at fp32 precision either
    way."""
    if not _route(x):
        return ref.lowrank_forward(x, w, v, b, return_p=return_p)
    if x.ndim != 2:
        raise ValueError(f"lowrank_forward: x must be (M, K), got "
                         f"{tuple(x.shape)}")
    _check(x, w, v, b, b_ndim=2)
    return _launch("p" if return_p else "shared", x, w, v, b,
                   seq=x.shape[0])


def lowrank_batch_forward(x: torch.Tensor, w: torch.Tensor,
                          v: torch.Tensor, b: torch.Tensor,
                          rows: torch.Tensor | None = None) -> torch.Tensor:
    """y[i] = x[i] W + (x[i] V) B[t]ᵀ.  x (batch,S,K).  Without ``rows``,
    b is (batch,N,r) and t = i; with ``rows``, a (batch,) int64 tensor on
    x's device, b is a (T,N,r) stack and t = rows[i].  The kernel trusts
    ``rows``: an index outside [0, T) traps on the card (a CUDA error at
    the next synchronisation), never a quiet out-of-bounds read."""
    _check_batch(x, b, rows)
    if not _route(x):
        return ref.lowrank_batch_forward(x, w, v, b, rows)
    _check(x, w, v, b, b_ndim=3)
    if rows is not None and (rows.device != x.device
                             or rows.dtype != torch.int64
                             or not rows.is_contiguous()):
        raise ValueError(
            f"lowrank_batch_forward: rows must be a contiguous int64 "
            f"tensor on {x.device}; got {rows.dtype} on {rows.device}")
    batch, S, K = x.shape
    N = w.shape[1]
    y = _launch("batched", x.reshape(batch * S, K), w, v, b, seq=S,
                rows=rows)
    return y.reshape(batch, S, N)


def _check_batch(x, b, rows) -> None:
    if x.ndim != 3 or b.ndim != 3:
        raise ValueError(
            f"lowrank_batch_forward: x must be (batch, seq, k) and b "
            f"(batch, n, r) or (tenants, n, r); got x {tuple(x.shape)}, "
            f"b {tuple(b.shape)}")
    if rows is None:
        if b.shape[0] != x.shape[0]:
            raise ValueError(
                f"lowrank_batch_forward: b (batch, n, r) needs the batch "
                f"of x; got x {tuple(x.shape)}, b {tuple(b.shape)}")
    elif (rows.ndim != 1 or rows.shape[0] != x.shape[0]
          or rows.dtype.is_floating_point or rows.dtype == torch.bool):
        raise ValueError(
            f"lowrank_batch_forward: rows must be one integer tenant "
            f"index per batch row, ({x.shape[0]},); got "
            f"{tuple(rows.shape)} {rows.dtype}")
