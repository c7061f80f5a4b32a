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
is the one place that chooses among the kernel source's three routes,
by dtype, form, rank and alignment alone: ``"tc"`` (TMA and ``wgmma`` on
the tensor cores, in bf16 with every row length a multiple of 8 and
16-byte-aligned pointers, every form), ``"tf32x3"`` (fp32 shared-B and
``return_p`` launches of rank at most ``SMALL_RANK``: one launch of
3xTF32 ``mma.sync`` with p formed in the tile) or ``"simt"`` (fp32 FMAs:
fp32 at larger rank, fp32 per-row B, and bf16 rows TMA cannot address).
None gives way to another: a failed build or launch raises.
``LAUNCHES`` counts launches per ``(form, route, K, N)`` — form
``"shared"``, ``"p"`` (return_p) or ``"batched"`` — so a run can show
that its main path went through the kernel, and by which route.

The ``"tc"`` launches read nothing back on the host (not ``rows``, not
a length), so a decode step can be captured in a CUDA graph.  Where a
pass splits its reduction they keep one int counter per output tile in
a per-device buffer that every launch leaves zeroed, so launches on one
device are ordered on one stream.  The shared-B and ``return_p`` plans
(:func:`gemm_plan`, :func:`tc_plan`) are pure functions of the shapes.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build, ref

# (form, route, K, N) -> launches on CUDA tensors; form "shared" | "p" |
# "batched", route "tc" | "tf32x3" | "simt"
LAUNCHES: collections.Counter = collections.Counter()

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                 # BM = BN of the SIMT kernels
SMS = 132                 # H100 SXM streaming multiprocessors
MIN_K_PER_SPLIT = 256
TC_ALIGN = 8              # bf16 elements in the 16 bytes TMA aligns to
# the per-row-B tensor-core kernel: 128 output columns per block, 64-deep
# stages, two blocks resident per SM, a split at least 8 stages deep
DEC_TILE, DEC_BK, DEC_BLOCKS, DEC_MIN_STAGES = 128, 64, 2 * SMS, 8
# the shared-B mainloop (csrc/wgmma_gemm.cuh): 128-row tiles 64, 128 or
# 256 wide, 64-deep stages, one block resident per SM, a split at least 8
# stages deep, tiles walked in groups of 8 rows
GEMM_BM, GEMM_BK, GEMM_MIN_STAGES, GEMM_GROUP = 128, 64, 8, 8
# the plan's cost model (gemm_plan), in units of one 128-wide stage on one
# SM, fitted to the H100's times at the path's shapes: a stage's
# tensor-core time by tile width at the operations bound (per operation,
# against the 128-wide tile), alone and with two blocks sharing B; a
# tile's epilogue per 128 columns; an fp32 partial written, and one read
# back by the tile's last split; the SMs that stream the weights at the
# card's memory rate, and the output tile's intensity (rows x cols /
# (rows + cols)) from which a pass is bound by operations
OPS_STAGE = {64: 1.2, 128: 1.0, 256: 0.8}
OPS_STAGE_PAIRED = {128: 0.85, 256: 0.7}
EPILOGUE, PART_WRITE, PART_READ = 2.0, 2.5, 2.5
BYTES_SMS, OPS_INTENSITY = 48, 512
# shared-B launches of at most this many rows take the per-row-B kernel
# with one B (W read once by a swap-AB tile)
SKINNY_ROWS = 16
# fp32 shared-B and return_p launches of at most this rank take the
# "tf32x3" route: V's columns are one or two n8 blocks of its tile
SMALL_RANK = 16

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


@functools.lru_cache(maxsize=4096)
def gemm_plan(M: int, N: int, K: int, rank_k: int = 0) -> tuple:
    """``(bn, splits, cluster)`` of one pass of the shared-B mainloop
    over an (M, N) output, a depth K and rank segments of ``rank_k`` in
    all: the tile width (64, 128 or 256), how many depth ranges segment 0
    splits into, each at least ``GEMM_MIN_STAGES`` stages and none
    empty, and how many blocks, one tile above the other, share each
    stage of B (2: each loads half and multicasts it to both; for a pass
    bound by operations whose tile rows pair up, and with rank segments:
    the y and dx passes, whose bf16 epilogue that kernel is built
    for).  The grid holds one block per SM, so a pass takes ``ceil(units
    / SMS)`` rounds; a unit costs its stages (a wide stage its bytes,
    ``bn / 128``, where the pass is bound by bytes — an output of few
    rows or columns — and its operations, ``OPS_STAGE``, where it is
    bound by operations) and, split, its fp32 partial.  The plan
    minimises the larger of the rounds' cost and the whole pass over the
    SMs it can keep busy (``BYTES_SMS`` where it streams bytes), plus
    the last split's reading the partials back."""
    kst, rst = max(1, -(-K // GEMM_BK)), -(-rank_k // GEMM_BK)
    w = min(1.0, M * N / (M + N) / OPS_INTENSITY)
    busy = max(BYTES_SMS, SMS * w)
    best = None
    for bn, ops in OPS_STAGE.items():
        tiles = -(-M // GEMM_BM) * -(-N // bn)
        pair = rank_k > 0 and w >= 1.0 and bn in OPS_STAGE_PAIRED \
            and -(-M // GEMM_BM) % 2 == 0
        part = bn / 128
        cost = part * (1 - w + w * (OPS_STAGE_PAIRED[bn] if pair else ops))
        for s in range(1, max(1, kst // GEMM_MIN_STAGES) + 1):
            chunk = -(-kst // s)
            if -(-kst // chunk) != s:
                continue
            write = PART_WRITE * part if s > 1 else 0.0
            unit = (chunk + rst) * cost + write + w * EPILOGUE * part
            total = tiles * ((kst + rst) * cost + s * write)
            key = (max(-(-tiles * s // SMS) * unit, total / busy)
                   + (s - 1) * PART_READ * part, abs(bn - 128), s)
            if best is None or key < best[0]:
                best = (key, bn, s, 2 if pair else 1)
    return best[1:]


def gemm_units(M: int, N: int, K: int, bn: int, splits: int,
               cluster: int = 1, rank_ks=()) -> list:
    """Every work unit of one pass in the order the kernel walks them
    (``unit_of`` and ``seg_range`` in ``csrc/wgmma_gemm.cuh``), a
    cluster's ``cluster`` blocks side by side: ``(tile, z, m0, n0,
    (k_begin, k_end), rank)`` — split z of the tile at rows m0, columns
    n0 takes segment 0's depth range and, in the last split only, the
    rank segments of depths ``rank_ks`` (``rank`` True).  Tiles are
    taken in groups of ``GEMM_GROUP`` rows (of clusters), column by
    column."""
    tiles_m, tiles_n = -(-M // GEMM_BM), -(-N // bn)
    chunk = -(-(-(-max(K, 1) // splits)) // GEMM_BK) * GEMM_BK
    span = GEMM_GROUP * tiles_n
    units = []
    for pu in range(tiles_m // cluster * tiles_n * splits):
        ptile, z = divmod(pu, splits)
        group, inner = divmod(ptile, span)
        rows = min(GEMM_GROUP, tiles_m // cluster - group * GEMM_GROUP)
        for rank in range(cluster):
            m0 = (cluster * (group * GEMM_GROUP + inner % rows) + rank) \
                * GEMM_BM
            kb = z * chunk
            units.append((ptile * cluster + rank, z, m0, (inner // rows) * bn,
                          (kb, min(K, kb + chunk)),
                          bool(rank_ks) and z == splits - 1))
    return units


def gemm_scratch(M: int, N: int, bn: int, splits: int) -> tuple:
    """``(fp32 partial elements, tile counters)`` of one pass: a 128 ×
    bn partial per unit and a counter per tile where the pass splits."""
    tiles = -(-M // GEMM_BM) * -(-N // bn)
    return (tiles * splits * GEMM_BM * bn, tiles) if splits > 1 \
        else (0, tiles)


def tc_plan(form: str, M: int, K: int, N: int, r: int) -> dict:
    """How the tensor-core route runs a shared-B or ``"p"`` launch:
    ``{"route": "skinny"}`` for a shared-B launch of at most
    ``SKINNY_ROWS`` rows (the per-row-B kernel with one B: p and y
    passes as :func:`dec_plan` says), else ``{"route": "gemm", "p":
    plan, "y": plan}``, each :func:`gemm_plan`'s ``(bn, splits,
    cluster)`` of the mainloop's p or y pass."""
    if form == "shared" and M <= SKINNY_ROWS:
        return {"route": "skinny"}
    return {"route": "gemm", "p": gemm_plan(M, r, K),
            "y": gemm_plan(M, N, K, 2 * r)}


def tc_route(dtype: torch.dtype, K: int, N: int, r: int,
             ptrs=(), form: str | None = None) -> str:
    """The route of a launch.  ``"tc"`` where the ``wgmma`` route can take
    a launch of any form — bf16, every row length (K, N, r) a multiple of
    8 and every pointer 16-byte aligned, as TMA (and the per-row-B form's
    ``cp.async`` of B) addresses them; ``"tf32x3"`` for an fp32 launch of
    the forward's ``form`` ``"shared"`` or ``"p"`` with ``r <=
    SMALL_RANK``; else ``"simt"``.  Without a form (the backward, the
    merge and the projection ask for their bf16 operands) only ``"tc"``
    or ``"simt"``."""
    if (dtype == torch.float32 and form in ("shared", "p")
            and r <= SMALL_RANK):
        return "tf32x3"
    if dtype != torch.bfloat16 or any(d % TC_ALIGN for d in (K, N, r)):
        return "simt"
    return "simt" if any(int(p) % 16 for p in ptrs) else "tc"


def scratch_plan(form: str, route: str, M: int, K: int, N: int,
                 r: int, seq: int = 1) -> dict:
    """``{name: (shape, dtype)}`` of the scratch one launch allocates.
    The shared-B tensor-core route keeps p as a bf16 (hi, lo) pair — hi
    is the ``"p"`` form's output itself — and, for each pass that splits
    K (:func:`gemm_plan`), a 128 × bn fp32 partial per unit
    (``part_p``, ``part_y``).  The per-row-B one (and a shared-B launch
    of at most ``SKINNY_ROWS`` rows, which runs on it) keeps p in fp32
    and the fp32 partials of each pass that splits K, all in one buffer:
    at decode (M ≤ 16) an ``(s + slots, M, N)`` buffer (the splits' and
    the rank slots' partials) only where the output tiles alone cannot
    fill the card.
    The SIMT route sums split-K partials in fp32; ``"tf32x3"`` keeps
    nothing."""
    bf16, f32 = torch.bfloat16, torch.float32
    if route == "tf32x3":
        return {}
    if route == "tc" and form == "shared" and M <= SKINNY_ROWS:
        form, seq = "batched", M
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
        for name, cols, rank_k in (("part_p", r, 0), ("part_y", N, 2 * r)):
            n, _ = gemm_scratch(M, cols, *gemm_plan(M, cols, K, rank_k)[:2])
            if n:
                plan[name] = ((n,), f32)
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
    fn.argtypes = [vp] * 11 + [ci] * 4 + [vp]
    fn.restype = ci
    return fn


@functools.cache
def _f3_kernel():
    """The fp32 small-rank route's C entry point."""
    fn = _build.load("lowrank_forward").lowrank_forward_f3_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # x, w, v, b, y, p, M, K, N, r, stream
    fn.argtypes = [vp] * 6 + [ci] * 4 + [vp]
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
                     (t.data_ptr() for t in (x2, w, v, b)), form)
    plan = scratch_plan(form, route, M, K, N, r, seq)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tf32x3":
            rc = _f3_kernel()(
                x2.data_ptr(), w.data_ptr(), v.data_ptr(), b.data_ptr(),
                y.data_ptr(), None if p_out is None else p_out.data_ptr(),
                M, K, N, r, stream)
        elif route == "tc" and form == "batched":
            rc = _launch_dec(x2, w, v, b, y, plan, seq, rows, stream)
        elif route == "tc" and tc_plan(form, M, K, N, r)["route"] == \
                "skinny":
            # one B for every row: the per-row-B kernel, adapter 0
            rc = _launch_dec(x2, w, v, b.unsqueeze(0), y, plan, M, None,
                             stream)
        elif route == "tc":
            rc = _launch_tc(x2, w, v, b, y, p_out, plan, stream)
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


def _launch_tc(x2, w, v, b, y, p_out, plan, stream) -> int:
    """Queue the shared-B tensor-core route's two launches (p pass, y
    pass) in one C call, as :func:`tc_plan` planned them."""
    M, K = x2.shape
    N, r = w.shape[1], v.shape[1]
    plan_tc = tc_plan("p", M, K, N, r)
    buf = {name: torch.empty(shape, dtype=dt, device=x2.device)
           for name, (shape, dt) in plan.items()}
    p_hi = buf["p_hi"] if p_out is None else p_out
    tiles = gemm_scratch(M, r, *plan_tc["p"][:2])[1] + \
        gemm_scratch(M, N, *plan_tc["y"][:2])[1]
    part_p, part_y = buf.get("part_p"), buf.get("part_y")
    ints = (ctypes.c_int * 6)(*plan_tc["p"], *plan_tc["y"])
    return _tc_kernel()(
        x2.data_ptr(), w.data_ptr(), v.data_ptr(), b.data_ptr(),
        y.data_ptr(), p_hi.data_ptr(), buf["p_lo"].data_ptr(),
        None if part_p is None else part_p.data_ptr(),
        None if part_y is None else part_y.data_ptr(),
        _counters(x2.device, tiles).data_ptr(), ints, M, K, N, r, stream)


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
