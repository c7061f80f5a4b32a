"""The Mamba2 SSD intra-chunk block on the card: wrapper of the
hand-written CUDA kernel ``csrc/ssd_chunk.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py::
ssd_intra_chunk``.  x (BC,Q,H,P); dt, da (BC,Q,H); b, c (BC,Q,H,N) with
BC = batch x chunks flattened and the B/C groups already broadcast to
heads; all five share one dtype, fp32 or bf16.  Returns y (BC,Q,H,P) in
x's dtype and the chunks' local end states (BC,H,N,P) in fp32.  b and c
may be contiguous or a head broadcast of one group (``expand`` of a
contiguous (BC,Q,1,N) tensor: head stride 0), which the kernel reads
without a copy.

Both routes refuse what the kernel cannot take (another dtype, a
mismatched shape, a non-contiguous x, dt or da, Q, N or P outside
1..128).  Then the route is the tensor's device alone: a CPU tensor
takes the plain version in :mod:`.ref`; a CUDA tensor launches the
kernel or raises.

Gradients: :func:`ssd_intra_chunk_grouped` takes b and c **per B/C
group** (BC, Q, G, N), head h reading group ``h // (H // G)``, and is a
``torch.autograd.Function``: forward the kernel above (b and c a head
broadcast of stride 0 for one group, per head otherwise), backward the
hand-written ``csrc/ssd_chunk_bwd.cu`` (:func:`ssd_intra_chunk_bwd`;
the plain ``ref.ssd_intra_chunk_bwd`` on the CPU), which returns db and
dc per group.  It saves only its inputs.  The TPU kernel has no
backward (the reference autodiffs its jnp ``ssd_chunked``), so the
backward replaces that autodiff.  It takes fp32 alone: an input that
requires a gradient in another dtype is refused on both routes, as
training casts every SSD operand to fp32.  :func:`ssd_intra_chunk`
with inputs that require a gradient goes through the same Function.

The kernel splits the work by a fixed rule of the shapes and of b's and
c's head stride, :func:`ssd_plan`, which the wrapper passes to the C
launcher; the launcher refuses a split other than its own.  A grid of
Gram CTAs computes G = C Bᵀ once per B/C group into a scratch tensor,
then a grid of chunk CTAs (bc, head, part) each take a tile of the end
state and a pair of 16-row strips of y from it.  :func:`ssd_cta` says
what each CTA computes, as the kernels decode their block index.

``LAUNCHES`` counts launches per ``("ssd_intra_chunk", (BC, Q, H, P,
N))``: one per call, which queues both grids; and the backward's per
``("ssd_intra_chunk_bwd", (BC, Q, H, P, N))``: one per call, which
queues its two grids (:func:`ssd_bwd_plan`, :func:`ssd_bwd_cta`).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from . import _build, ref
from .lowrank_forward import DTYPE_CODE, _route

# ("ssd_intra_chunk", (BC, Q, H, P, N)) -> launches on CUDA tensors
LAUNCHES: collections.Counter = collections.Counter()
MAX_Q = MAX_N = MAX_P = 128         # the kernel's shared-memory tiles
STRIP = 16          # y rows per strip (one m16 MMA tile)
STATE_TILE = 32     # state rows n per chunk CTA
GRAM_COLS = 32      # G columns per Gram CTA


@dataclasses.dataclass(frozen=True)
class SSDPlan:
    """How one launch cuts the work: a grid of ``gram_ctas`` Gram tiles
    ``(bc, group, pair, column block)``, then one of ``chunk_ctas`` chunk
    parts ``(bc, head, part)``, each index's last field fastest."""
    groups: int         # Gram matrices per chunk (1: one shared B/C group)
    pairs: int          # y strip pairs
    n_tiles: int        # state tiles of STATE_TILE rows of n
    parts: int          # chunk CTAs per (bc, head): max(pairs, n_tiles)
    gram_cols: int      # Gram column blocks per pair
    gram_ctas: int
    chunk_ctas: int

    @property
    def ctas(self) -> int:
        return self.gram_ctas + self.chunk_ctas


def ssd_plan(BC: int, Q: int, H: int, N: int, P: int,
             shared: bool) -> SSDPlan:
    """The split of a launch.  ``shared``: b and c have head stride 0, so
    every head reads one B/C group and the chunk has one Gram matrix
    (else one a head).

    Gram CTAs compute G = C Bᵀ once per group in 32 x 32 tiles: the rows
    of a strip pair (16-row strips s and strips-1-s), one block of 32
    columns (a block past the pair's causal columns does nothing).  A
    chunk CTA (bc, head, part r) computes state rows [32r, 32r + 32) and
    the y rows of pair r from G: each part holds about the same share of
    the causal half.  At mamba2-780m's prefill (H 48, N 128, one group)
    a single chunk makes 16 Gram and 192 chunk CTAs, three per SM: the
    card is full from BC = 1.  P does not change the split."""
    strips = -(-Q // STRIP)
    pairs = -(-strips // 2)
    n_tiles = -(-N // STATE_TILE)
    parts = max(pairs, n_tiles)
    gram_cols = -(-Q // GRAM_COLS)
    groups = 1 if shared else H
    return SSDPlan(groups, pairs, n_tiles, parts, gram_cols,
                   BC * groups * pairs * gram_cols, BC * H * parts)


def _pair(Q: int, r: int):
    """Strips of pair r and each one's causal columns (as the kernel's
    Pair): [(strip, columns), ...]."""
    strips = -(-Q // STRIP)
    q8 = -(-Q // 8) * 8
    pair = [r] + ([strips - 1 - r] if strips - 1 - r > r else [])
    return [(s, min(STRIP * (s + 1), q8)) for s in pair]


def ssd_cta(plan: SSDPlan, Q: int, H: int, N: int, cta: int):
    """What CTA ``cta`` computes, counting the Gram grid's blocks first
    and then the chunk grid's, as the kernels decode their block index:
    ``("gram", bc, group, cells)`` (the (i, j) of G it stores, i, j < Q)
    or ``("chunk", bc, head, y_rows, n_rows)`` (those rows of y and of the
    end state, every column p)."""
    if cta < plan.gram_ctas:
        cb, rest = cta % plan.gram_cols, cta // plan.gram_cols
        r, rest = rest % plan.pairs, rest // plan.pairs
        j0 = GRAM_COLS * cb
        cells = tuple((i, j) for s, kc in _pair(Q, r)
                      for i in range(STRIP * s, min(STRIP * (s + 1), Q))
                      for j in range(j0, min(j0 + GRAM_COLS, kc, Q)))
        return ("gram", rest // plan.groups, rest % plan.groups, cells)
    cta -= plan.gram_ctas
    r, rest = cta % plan.parts, cta // plan.parts
    y_rows = () if r >= plan.pairs else tuple(
        i for s, _ in _pair(Q, r)
        for i in range(STRIP * s, min(STRIP * (s + 1), Q)))
    n0 = STATE_TILE * r
    return ("chunk", rest // H, rest % H, y_rows,
            tuple(range(n0, min(n0 + STATE_TILE, N))))


def launches() -> int:
    """Launches counted so far, over every shape."""
    return sum(LAUNCHES.values())


def reset_launches() -> None:
    LAUNCHES.clear()


_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _kernel(defines=()):
    fn = _build.load("ssd_chunk", defines).ssd_intra_chunk_launch
    # dtype, x, dt, da, b, c, y, state, gram, BC, Q, H, P, N, groups,
    # pairs, parts, gram_cols, b strides (3), c strides (3), stream
    fn.argtypes = [_CI] + [_VP] * 8 + [_LL] + [_CI] * 8 + [_LL] * 6 + [_VP]
    fn.restype = _CI
    return fn


def _bc_strides(name: str, t: torch.Tensor):
    """(bc, q, head) element strides of b or c: contiguous, or a head
    broadcast of a contiguous one-group tensor."""
    BC, Q, H, N = t.shape
    broadcast = (t.stride(2) == 0 and t.stride(3) == 1
                 and t.stride(1) == N and t.stride(0) == Q * N)
    if not (t.is_contiguous() or broadcast):
        raise ValueError(
            f"ssd_intra_chunk: {name} must be contiguous or a head "
            f"broadcast of a contiguous (BC, Q, 1, N) tensor; got strides "
            f"{t.stride()}")
    return t.stride(0), t.stride(1), t.stride(2)


def _check(x, dt, da, b, c):
    """Refuse what the kernel cannot take, on either route (so the plain
    version on the CPU holds callers to the kernel's contract); returns
    the (bc, q, head) strides of b and c."""
    if x.ndim != 4 or b.ndim != 4:
        raise ValueError(
            f"ssd_intra_chunk: x must be (BC, Q, H, P) and b, c (BC, Q, H, "
            f"N); got x {tuple(x.shape)}, b {tuple(b.shape)}")
    lead = tuple(x.shape[:3])
    if (tuple(dt.shape) != lead or tuple(da.shape) != lead
            or tuple(b.shape[:3]) != lead or tuple(c.shape) != tuple(b.shape)):
        raise ValueError(
            f"ssd_intra_chunk: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, da {tuple(da.shape)}, b {tuple(b.shape)}, "
            f"c {tuple(c.shape)} do not fit x (BC, Q, H, P), dt and da "
            f"(BC, Q, H), b and c (BC, Q, H, N)")
    named = (("x", x), ("dt", dt), ("da", da), ("b", b), ("c", c))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(
                f"ssd_intra_chunk: {name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(
                f"ssd_intra_chunk: the kernel takes one dtype for x, dt, da, "
                f"b, c; got x {x.dtype}, {name} {t.dtype}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"ssd_intra_chunk: the kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    for name, t in named[:3]:
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk: {name} is not contiguous")
    _, Q, _, P = x.shape
    N = b.shape[-1]
    if not (0 < Q <= MAX_Q and 0 < N <= MAX_N and 0 < P <= MAX_P):
        raise ValueError(
            f"ssd_intra_chunk: the kernel takes chunks of 1..{MAX_Q} "
            f"tokens, state 1..{MAX_N} and head dim 1..{MAX_P}; got Q={Q}, "
            f"N={N}, P={P}")
    return _bc_strides("b", b), _bc_strides("c", c)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    checked: bool = False):
    """Batched intra-chunk SSD: ``(y (BC,Q,H,P) in x's dtype, state
    (BC,H,N,P) fp32)``; see :func:`repro_torch.kernels.ref.
    ssd_intra_chunk` for the function.  ``checked``: launch the
    bounds-checked build (``_build.CHECKED``; the same arithmetic, every
    shared and global index asserted, a trap on the first outside its
    array), on a CUDA tensor that wants no gradient."""
    b_strides, c_strides = _check(x, dt, da, b, c)
    if checked and (x.device.type != "cuda" or _wants_grad(x, dt, da, b, c)):
        raise ValueError("ssd_intra_chunk: the checked build takes CUDA "
                         "tensors that want no gradient")
    if _wants_grad(x, dt, da, b, c):
        # one group read by every head (stride 0), else a group per head
        if b_strides[2] == 0 and c_strides[2] == 0:
            b, c = b[:, :, :1], c[:, :, :1]
        return ssd_intra_chunk_grouped(x, dt, da, b, c)
    if not _route(x, "ssd_intra_chunk"):
        return ref.ssd_intra_chunk(x, dt, da, b, c)
    BC, Q, H, P = x.shape
    N = b.shape[-1]
    if BC == 0 or H == 0:
        return torch.empty_like(x), torch.empty(
            (BC, H, N, P), dtype=torch.float32, device=x.device)
    plan = ssd_plan(BC, Q, H, N, P, b_strides[2] == 0 and c_strides[2] == 0)
    out = _launch(x, dt, da, b, c, plan, b_strides, c_strides,
                  _build.CHECKED if checked else ())
    LAUNCHES[("ssd_intra_chunk", (BC, Q, H, P, N))] += 1
    return out


def _launch(x, dt, da, b, c, plan, b_strides, c_strides, defines=()):
    """The kernel's two launches split by ``plan``, on CUDA tensors that
    passed ``_check``; counts nothing.  Raises if the launcher refuses
    the split (any other than :func:`ssd_plan`'s for these strides)."""
    BC, Q, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((BC, H, N, P), dtype=torch.float32, device=x.device)
    gram = torch.empty(BC * plan.groups * Q * Q, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel(defines)(DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
                       da.data_ptr(), b.data_ptr(), c.data_ptr(),
                       y.data_ptr(), state.data_ptr(), gram.data_ptr(), BC,
                       Q, H, P, N, plan.groups, plan.pairs, plan.parts,
                       plan.gram_cols, *b_strides, *c_strides, stream)
    if rc != 0:
        raise RuntimeError(
            f"ssd_intra_chunk kernel launch failed with CUDA error {rc} "
            f"(x {tuple(x.shape)}, N={N}, {plan.groups} Gram groups)")
    return y, state


# ---------------------------------------------------------------------------
# Gradient: per-group b and c, the backward kernel
# ---------------------------------------------------------------------------

SLICE_HEADS = 16    # heads a backward CTA walks, at most
GROUP_COLS = 32     # columns n of db, dc per group CTA


class SSDBwdPlan(NamedTuple):
    """The backward's split: a grid of ``heads_ctas`` heads CTAs ``(bc,
    group, slice)``, each walking ``heads_per_slice`` heads of its group
    in head order, then one of ``group_ctas`` group CTAs ``(bc, group,
    block of GROUP_COLS columns n)``, which sum the slices' partial sums
    in slice order; each index's last field fastest."""
    heads_per_slice: int
    slices: int
    heads_ctas: int
    n_blocks: int
    group_ctas: int


def ssd_bwd_plan(BC: int, H: int, N: int, G: int) -> SSDBwdPlan:
    """The split of a backward launch (the launcher refuses another).  At
    mamba2-780m's training shape (BC 128, H 48, N 128, one group): 3
    slices of 16 heads, 384 heads CTAs (one an SM at a time: 2.9 an SM),
    then 512 group CTAs."""
    rep = H // G
    hs = min(rep, SLICE_HEADS)
    slices = -(-rep // hs)
    n_blocks = -(-N // GROUP_COLS)
    return SSDBwdPlan(hs, slices, BC * G * slices, n_blocks,
                      BC * G * n_blocks)


def ssd_bwd_cta(plan: SSDBwdPlan, H: int, N: int, G: int, cta: int):
    """What CTA ``cta`` computes, counting the heads grid's blocks first,
    as the kernels decode their block index: ``("heads", bc, group,
    heads)`` (dx, ddt and dda of those heads, in the order it walks them,
    and their partial sums of D and E) or ``("group", bc, group,
    columns)`` (those columns n of db and dc)."""
    rep = H // G
    if cta < plan.heads_ctas:
        sl, rest = cta % plan.slices, cta // plan.slices
        grp = rest % G
        h0 = grp * rep + sl * plan.heads_per_slice
        h1 = min(h0 + plan.heads_per_slice, (grp + 1) * rep)
        return ("heads", rest // G, grp, tuple(range(h0, h1)))
    cta -= plan.heads_ctas
    nb, rest = cta % plan.n_blocks, cta // plan.n_blocks
    n0 = GROUP_COLS * nb
    return ("group", rest // G, rest % G,
            tuple(range(n0, min(n0 + GROUP_COLS, N))))


BWD_WARPS = 8       # warps of a heads CTA (256 threads)


def ssd_bwd_tiles(Q: int, warp: int):
    """The causal 16 x 8 tiles ``(i0, j0)`` of datt (rows i, columns j)
    that warp ``warp`` of a heads CTA forms, as the kernel's ``Slots``:
    16-row strips a = warp // 2 and b = S-1-a (S = ceil(Q / 16)), the
    column blocks of the warp's parity below each strip's diagonal block's
    end that hold a token."""
    S = -(-Q // STRIP)
    pair, par = warp // 2, warp % 2
    if pair >= -(-S // 2):
        return []
    cbq = -(-Q // 8)
    strips = [pair] + ([S - 1 - pair] if S - 1 - pair > pair else [])
    return [(STRIP * s, 8 * cb) for s in strips
            for cb in range(par, min(2 * s + 2, cbq), 2)]


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _check_grouped(x, dt, da, b, c):
    """The per-group form's shapes; returns (H, G)."""
    if b.ndim != 4 or tuple(c.shape) != tuple(b.shape) \
            or tuple(b.shape[:2]) != tuple(x.shape[:2]):
        raise ValueError(
            f"ssd_intra_chunk: b and c must be (BC, Q, G, N) per group; got "
            f"x {tuple(x.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    H, G = x.shape[2], b.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"ssd_intra_chunk: {G} B/C groups do not divide "
                         f"{H} heads")
    return H, G


def _heads(b, c, H):
    """Per-group b, c as the forward kernel reads them: one group a head
    broadcast (stride 0, no copy), H groups as they are, else each group
    repeated over its heads."""
    BC, Q, G, N = b.shape
    if G == 1:
        return (b.contiguous().expand(BC, Q, H, N),
                c.contiguous().expand(BC, Q, H, N))
    if G == H:
        return b.contiguous(), c.contiguous()
    return (torch.repeat_interleave(b, H // G, dim=2),
            torch.repeat_interleave(c, H // G, dim=2))


def _require_fp32(*ts):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(
                f"ssd_intra_chunk: the backward takes float32 alone (training "
                f"casts every SSD operand to float32); got {t.dtype} for an "
                f"input that requires a gradient")


class _SSDIntraChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, da, b, c):
        ctx.save_for_backward(x, dt, da, b, c)
        return ssd_intra_chunk(x, dt, da, *_heads(b, c, x.shape[2]))

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, da, b, c = ctx.saved_tensors
        BC, Q, H, P = x.shape
        if dy is None:
            dy = torch.zeros_like(x)
        if dstate is None:
            dstate = torch.zeros((BC, H, b.shape[-1], P), dtype=x.dtype,
                                 device=x.device)
        return ssd_intra_chunk_bwd(x, dt, da, b, c, dy, dstate)


def ssd_intra_chunk_grouped(x: torch.Tensor, dt: torch.Tensor,
                            da: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor):
    """:func:`ssd_intra_chunk` with b and c per B/C group (BC, Q, G, N),
    head h reading group ``h // (H // G)``; differentiable (the backward
    kernel on the card).  Returns ``(y, state)`` as the head form does."""
    _check_grouped(x, dt, da, b, c)
    if _wants_grad(x, dt, da, b, c):
        _require_fp32(x, dt, da, b, c)
    return _SSDIntraChunk.apply(x, dt, da, b, c)


def ssd_intra_chunk_bwd(x, dt, da, b, c, dy, dstate, *, checked=False):
    """The backward of :func:`ssd_intra_chunk_grouped`: ``(dx, ddt, dda,
    db, dc)`` in fp32, db and dc per group.  x, dy (BC,Q,H,P); dt, da
    (BC,Q,H); b, c (BC,Q,G,N); dstate (BC,H,N,P); all fp32.  A CPU
    tensor takes ``ref.ssd_intra_chunk_bwd``; a CUDA tensor launches the
    kernel or raises.  ``checked``: the bounds-checked build, as
    :func:`ssd_intra_chunk` takes it (CUDA tensors only)."""
    if checked and x.device.type != "cuda":
        raise ValueError("ssd_intra_chunk_bwd: the checked build takes "
                         "CUDA tensors")
    H, G = _check_grouped(x, dt, da, b, c)
    BC, Q, _, P = x.shape
    N = b.shape[-1]
    named = (("x", x), ("dt", dt), ("da", da), ("b", b), ("c", c),
             ("dy", dy), ("dstate", dstate))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"ssd_intra_chunk_bwd: {name} is on "
                             f"{t.device}, x on {x.device}")
    _require_fp32(*(t for _, t in named))
    if (tuple(dt.shape) != (BC, Q, H) or tuple(da.shape) != (BC, Q, H)
            or tuple(dy.shape) != tuple(x.shape)
            or tuple(dstate.shape) != (BC, H, N, P)):
        raise ValueError(
            f"ssd_intra_chunk_bwd: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, da {tuple(da.shape)}, b {tuple(b.shape)}, "
            f"dy {tuple(dy.shape)}, dstate {tuple(dstate.shape)} do not fit")
    if not (0 < Q <= MAX_Q and 0 < N <= MAX_N and 0 < P <= MAX_P):
        raise ValueError(
            f"ssd_intra_chunk_bwd: the kernel takes chunks of 1..{MAX_Q} "
            f"tokens, state 1..{MAX_N} and head dim 1..{MAX_P}; got Q={Q}, "
            f"N={N}, P={P}")
    if not _route(x, "ssd_intra_chunk_bwd"):
        return ref.ssd_intra_chunk_bwd(x, dt, da, b, c, dy, dstate)
    ts = [t.contiguous() for _, t in named]
    outs = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(da),
            torch.empty_like(b), torch.empty_like(c))
    if BC == 0 or H == 0:
        return outs
    _bwd_launch(ts, outs, ssd_bwd_plan(BC, H, N, G),
                _build.CHECKED if checked else ())
    LAUNCHES[("ssd_intra_chunk_bwd", (BC, Q, H, P, N))] += 1
    return outs


def _bwd_launch(ts, outs, plan, defines=()):
    """The backward kernel's two launches split by ``plan``, on the
    contiguous CUDA tensors (x, dt, da, b, c, dy, dstate) and outputs;
    counts nothing.  Raises if the launcher refuses the split (any other
    than :func:`ssd_bwd_plan`'s)."""
    x, b = ts[0], ts[3]
    BC, Q, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    dpart = torch.empty(BC * G * plan.slices * Q * Q, **f32)
    epart = torch.empty(BC * G * plan.slices * Q * N, **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _bwd_kernel(defines)(*(t.data_ptr() for t in ts),
                           *(t.data_ptr() for t in outs), dpart.data_ptr(),
                           epart.data_ptr(), BC, Q, H, P, N, G,
                           plan.heads_per_slice, plan.slices, stream)
    if rc != 0:
        raise RuntimeError(
            f"ssd_intra_chunk_bwd kernel launch failed with CUDA error {rc} "
            f"(x {tuple(x.shape)}, N={N}, {G} groups, plan {plan})")


@functools.cache
def _bwd_kernel(defines=()):
    fn = _build.load("ssd_chunk_bwd", defines).ssd_intra_chunk_bwd_launch
    # x, dt, da, b, c, dy, dstate, dx, ddt, dda, db, dc, dpart, epart,
    # BC, Q, H, P, N, G, heads_per_slice, slices, stream
    fn.argtypes = [_VP] * 14 + [_LL] + [_CI] * 7 + [_VP]
    fn.restype = _CI
    return fn
