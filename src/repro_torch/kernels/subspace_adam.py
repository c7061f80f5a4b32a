"""Fused subspace optimizer updates on ``B`` on the card: wrappers of the
hand-written CUDA kernels ``csrc/subspace_adam.cu`` (fp32 moments) and
``csrc/subspace_q8.cu`` (int8 moments).

Replace the Pallas TPU kernels of ``repro/kernels/subspace_adam.py``:

* :func:`subspace_adam` — Adam with decay on fp32 ``m``/``v``;
* :func:`subspace_lion` — momentum-only Lion on fp32 ``m``;
* :func:`subspace_adam_q8` / :func:`subspace_lion_q8` — the same rules
  on int8 block-quantized moments in the ``(R, 128)`` row layout, one
  fp32 scale per row (``(R,)``), dequantized, updated and requantized in
  one pass; with ``bits`` the new ``b`` is stochastically rounded to
  bf16.

``b`` is the fp32 or bf16 master and ``g`` fp32 or bf16.  The fp32-state
kernels write ``b'`` in fp32; the q8 kernels in ``b``'s dtype.  ``lr``
(and the bias corrections ``bc1``, ``bc2`` for Adam) reach the kernels
as a small fp32 tensor on the device, so a step never waits on the host
for them.  One launch covers a whole group buffer; the fp32-state
kernels' grid is :func:`update_grid`'s, and every operand of theirs
(the q8 kernels' too) must be 16-byte aligned (an int8 payload 8-byte)
for their vector accesses.  The route is the tensor's device alone: a
CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises (a misaligned view too).  ``LAUNCHES``
counts launches per ``(kernel, shape of b)``: a call of an fp32-state
kernel is two where its group is not a whole number of tiles.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .lowrank_forward import DTYPE_CODE, _route

# (kernel, b's shape) -> launches on CUDA tensors; kernel is one of
# "subspace_adam" | "subspace_lion" | "subspace_adam_q8" | "subspace_lion_q8"
LAUNCHES: collections.Counter = collections.Counter()
QROW = 128                # elements per quantization row (the q8 kernels)
# the fp32-state kernels' launch (csrc/subspace_adam.cu)
THREADS = 256             # lanes a block
VEC = 4                   # consecutive elements a lane owns per vector step
UNROLL = 4                # vector steps a lane loads before its arithmetic
TILE = THREADS * UNROLL * VEC     # elements a block takes per trip
ALIGN = 16                # bytes: the vector accesses' word


def launches(kernel: Optional[str] = None) -> int:
    """Launches counted so far, of one kernel or of all."""
    return sum(n for (k, _), n in LAUNCHES.items()
               if kernel is None or k == kernel)


def reset_launches() -> None:
    LAUNCHES.clear()


_VP, _CI, _CF, _CL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
_ARGTYPES = {
    ("subspace_adam", "subspace_adam_launch"):
        [_CI, _CI] + [_VP] * 8 + [_CL] + [_CF] * 6
        + [_CI, ctypes.POINTER(_CI), _VP],
    ("subspace_adam", "subspace_lion_launch"):
        [_CI, _CI] + [_VP] * 6 + [_CL] + [_CF] * 5
        + [_CI, ctypes.POINTER(_CI), _VP],
    ("subspace_q8", "subspace_adam_q8_launch"):
        [_CI, _CI] + [_VP] * 13 + [_CL] + [_CF] * 6 + [_VP],
    ("subspace_q8", "subspace_lion_q8_launch"):
        [_CI, _CI] + [_VP] * 9 + [_CL] + [_CF] * 5 + [_VP],
}


@functools.cache
def _kernel(source: str, entry: str):
    """The C entry point, built and loaded on first use."""
    fn = getattr(_build.load(source), entry)
    fn.argtypes = _ARGTYPES[(source, entry)]
    fn.restype = _CI
    return fn


def _check(name, b, tensors: dict, scalars, n_scalars: int) -> None:
    """Same device, contiguity; b and g fp32 or bf16."""
    for t_name, t in tensors.items():
        if t is not None and t.device != b.device:
            raise ValueError(
                f"{name}: {t_name} is on {t.device}, b on {b.device}")
    if scalars.device != b.device:
        raise ValueError(f"{name}: scalars is on {scalars.device}, b on "
                         f"{b.device}")
    for t_name in ("b", "g"):
        if tensors[t_name].dtype not in DTYPE_CODE:
            raise TypeError(f"{name}: {t_name} must be float32 or bfloat16, "
                            f"got {tensors[t_name].dtype}")
    if scalars.dtype != torch.float32 \
            or tuple(scalars.shape) != (n_scalars,):
        raise ValueError(f"{name}: scalars must be ({n_scalars},) float32, "
                         f"got {tuple(scalars.shape)} {scalars.dtype}")
    for t_name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} is not contiguous")


def _check_dtypes(name, **want) -> None:
    for t_name, (t, dtype) in want.items():
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {t_name} must be {dtype}, got "
                            f"{t.dtype}")


def _check_shapes(name, shape, **tensors) -> None:
    bad = {k: tuple(t.shape) for k, t in tensors.items()
           if t is not None and tuple(t.shape) != tuple(shape)}
    if bad:
        raise ValueError(f"{name}: {bad} must share one shape with b "
                         f"{tuple(shape)}")


def _launch(name, source, entry, b, args, launched=None):
    """One call of the C entry; counts one launch, or ``launched.value``
    where the entry writes how many grids it queued."""
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = _kernel(source, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (b {tuple(b.shape)})")
    LAUNCHES[(name, tuple(b.shape))] += (1 if launched is None
                                         else launched.value)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_aligned(name, tensors: dict) -> None:
    """Refuse an operand that the kernels' vector accesses cannot read:
    each must start on a 16-byte word (an int8 payload on an 8-byte
    one).  A misaligned view is refused, never routed elsewhere."""
    for t_name, t in tensors.items():
        if t is not None and t.data_ptr() % (8 if t.dtype == torch.int8
                                             else ALIGN):
            raise ValueError(f"{name}: {t_name} is not aligned for the "
                             f"kernel's vector accesses")


def update_grid(n: int) -> int:
    """The grid of :func:`subspace_adam` and :func:`subspace_lion` over
    ``n`` >= 1 elements: one block of ``THREADS`` lanes a whole tile of
    ``TILE``; in vector step u < ``UNROLL`` of the tile from t·TILE, lane
    l owns the ``VEC`` elements from t·TILE + (u·THREADS + l)·VEC.  Where
    ``TILE`` does not divide n, the kernel's entry launches one block
    more over the ragged last tile, and reports the two launches."""
    return n // TILE


def _launch_update(kernel: str, ins, outs, scalars: torch.Tensor,
                   consts) -> None:
    """One call of an fp32-state kernel ("subspace_adam" or
    "subspace_lion"): ``ins`` (b, g, m[, v]) and ``outs`` (b', m'[, v'],
    fp32), which may be the inputs themselves; ``consts`` the rule's
    constants after n (β1, 1 − β1, β2, 1 − β2[, eps], wd).  The wrappers
    check everything but the alignment, checked here first."""
    b, g = ins[0], ins[1]
    _check_aligned(kernel, dict(zip(("b", "g", "m", "v"), ins))
                   | dict(zip(("b'", "m'", "v'"), outs)))
    n, launched = b.numel(), _CI(0)
    _launch(kernel, "subspace_adam", kernel + "_launch", b,
            (DTYPE_CODE[b.dtype], DTYPE_CODE[g.dtype],
             *(t.data_ptr() for t in (*ins, *outs)), scalars.data_ptr(), n,
             *consts, update_grid(n), ctypes.byref(launched)), launched)


# ---------------------------------------------------------------------------
# fp32 moments
# ---------------------------------------------------------------------------

def subspace_adam(b: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, scalars: torch.Tensor, *, beta1: float,
                  beta2: float, eps: float, wd: float):
    """(b', m', v') fp32.  ``scalars`` is ``(lr, bc1, bc2)`` as a (3,)
    fp32 tensor on b's device."""
    name = "subspace_adam"
    if not _route(b, name):
        lr, bc1, bc2 = scalars.float()
        return ref.subspace_adam(b, g, m, v, lr=lr, beta1=beta1,
                                 beta2=beta2, eps=eps, wd=wd, bc1=bc1,
                                 bc2=bc2)
    _check(name, b, dict(b=b, g=g, m=m, v=v), scalars, 3)
    _check_dtypes(name, m=(m, torch.float32), v=(v, torch.float32))
    _check_shapes(name, b.shape, g=g, m=m, v=v)
    outs = tuple(torch.empty(b.shape, dtype=torch.float32, device=b.device)
                 for _ in range(3))
    if b.numel():
        _launch_update(name, (b, g, m, v), outs, scalars,
                       (beta1, 1 - beta1, beta2, 1 - beta2, eps, wd))
    return outs


def subspace_lion(b: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  scalars: torch.Tensor, *, beta1: float, beta2: float,
                  wd: float):
    """(b', m') fp32.  ``scalars`` is ``(lr,)`` as a (1,) fp32 tensor on
    b's device."""
    name = "subspace_lion"
    if not _route(b, name):
        return ref.subspace_lion(b, g, m, lr=scalars.float()[0],
                                 beta1=beta1, beta2=beta2, wd=wd)
    _check(name, b, dict(b=b, g=g, m=m), scalars, 1)
    _check_dtypes(name, m=(m, torch.float32))
    _check_shapes(name, b.shape, g=g, m=m)
    outs = tuple(torch.empty(b.shape, dtype=torch.float32, device=b.device)
                 for _ in range(2))
    if b.numel():
        _launch_update(name, (b, g, m), outs, scalars,
                       (beta1, 1 - beta1, beta2, 1 - beta2, wd))
    return outs


# ---------------------------------------------------------------------------
# int8 moments, (R, 128) rows
# ---------------------------------------------------------------------------

def _check_q8(name, b, g, bits, moments) -> None:
    if b.ndim != 2 or b.shape[1] != QROW:
        raise ValueError(f"{name}: the CUDA kernel takes (R, {QROW}) rows, "
                         f"got b {tuple(b.shape)}")
    # each lane reads 8 contiguous elements: 16-byte vectors (8-byte for
    # the int8 payloads)
    _check_aligned(name, dict(b=b, g=g, bits=bits, **{
        f"{k}q": q for k, (q, _) in moments.items()}))
    R = b.shape[0]
    _check_shapes(name, b.shape, g=g, bits=bits,
                  **{k: q for k, (q, _) in moments.items()})
    for k, (q, s) in moments.items():
        _check_dtypes(name, **{k: (q, torch.int8),
                               f"{k} scales": (s, torch.float32)})
        if tuple(s.shape) != (R,):
            raise ValueError(f"{name}: {k} scales {tuple(s.shape)} must be "
                             f"({R},), one per row")
    _check_dtypes(name, bits=(bits, torch.int32))


def subspace_adam_q8(b: torch.Tensor, g: torch.Tensor, mq: torch.Tensor,
                     ms: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                     scalars: torch.Tensor, *, beta1: float, beta2: float,
                     eps: float, wd: float,
                     bits: Optional[torch.Tensor] = None):
    """(b', mq', ms', vq', vs') over (R, 128) rows: b (fp32 or bf16;
    b' keeps its dtype), g, int8 mq/vq, (R,) fp32 scales ms/vs, and
    ``bits`` (R, 128) int32 noise in [0, 2**16) (b' stochastically
    rounded to bf16 values; round to nearest without).  ``scalars`` is
    (lr, bc1, bc2) on b's device."""
    name = "subspace_adam_q8"
    if not _route(b, name):
        lr, bc1, bc2 = scalars.float()
        nb, nmq, nms, nvq, nvs = ref.subspace_adam_q8(
            b, g, mq, ms.reshape(-1, 1), vq, vs.reshape(-1, 1), lr=lr,
            bc1=bc1, bc2=bc2, beta1=beta1, beta2=beta2, eps=eps, wd=wd,
            bits=bits)
        return nb, nmq, nms.reshape(-1), nvq, nvs.reshape(-1)
    _check(name, b, dict(b=b, g=g, mq=mq, ms=ms, vq=vq, vs=vs, bits=bits),
           scalars, 3)
    _check_q8(name, b, g, bits, dict(m=(mq, ms), v=(vq, vs)))
    nb = torch.empty_like(b)
    nmq, nvq = torch.empty_like(mq), torch.empty_like(vq)
    nms, nvs = torch.empty_like(ms), torch.empty_like(vs)
    if b.numel():
        _launch(name, "subspace_q8", "subspace_adam_q8_launch", b,
                (DTYPE_CODE[b.dtype], DTYPE_CODE[g.dtype], b.data_ptr(),
                 g.data_ptr(), mq.data_ptr(), ms.data_ptr(), vq.data_ptr(),
                 vs.data_ptr(), _ptr(bits), nb.data_ptr(), nmq.data_ptr(),
                 nms.data_ptr(), nvq.data_ptr(), nvs.data_ptr(),
                 scalars.data_ptr(), b.shape[0], beta1, 1 - beta1, beta2,
                 1 - beta2, eps, wd))
    return nb, nmq, nms, nvq, nvs


def subspace_lion_q8(b: torch.Tensor, g: torch.Tensor, mq: torch.Tensor,
                     ms: torch.Tensor, scalars: torch.Tensor, *,
                     beta1: float, beta2: float, wd: float,
                     bits: Optional[torch.Tensor] = None):
    """(b', mq', ms'): the :func:`subspace_adam_q8` contract minus v;
    ``scalars`` is (lr,) on b's device."""
    name = "subspace_lion_q8"
    if not _route(b, name):
        nb, nmq, nms = ref.subspace_lion_q8(
            b, g, mq, ms.reshape(-1, 1), lr=scalars.float()[0], beta1=beta1,
            beta2=beta2, wd=wd, bits=bits)
        return nb, nmq, nms.reshape(-1)
    _check(name, b, dict(b=b, g=g, mq=mq, ms=ms, bits=bits), scalars, 1)
    _check_q8(name, b, g, bits, dict(m=(mq, ms)))
    nb, nmq, nms = (torch.empty_like(t) for t in (b, mq, ms))
    if b.numel():
        _launch(name, "subspace_q8", "subspace_lion_q8_launch", b,
                (DTYPE_CODE[b.dtype], DTYPE_CODE[g.dtype], b.data_ptr(),
                 g.data_ptr(), mq.data_ptr(), ms.data_ptr(), _ptr(bits),
                 nb.data_ptr(), nmq.data_ptr(), nms.data_ptr(),
                 scalars.data_ptr(), b.shape[0], beta1, 1 - beta1, beta2,
                 1 - beta2, wd))
    return nb, nmq, nms
