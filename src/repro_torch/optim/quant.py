"""Block-wise int8 quantization for optimizer state.

Counterpart of ``repro.optim.quant``, with the same layout, so a
quantized moment crosses between the packages as its two arrays:

* ``q``: int8 in the LOGICAL shape of the tensor it encodes;
* ``scale``: flat ``(nblocks,)`` fp32 absmax/127 scales over the
  raveled order, one per ``block`` contiguous elements (the last block
  zero-padded);
* ``block`` and ``codec``: ``"linear"`` (signed absmax, first moments)
  or ``"sqrt"`` (absmax over ``sqrt(x)``, squared on dequant, second
  moments: their dynamic range inside a block would collapse to zero
  under a linear 127-level code).

The q8 optimizer kernels dequantize, update in fp32 and requantize in
one pass, so the fp32 moments never reach device memory.  Rounding is
half to even (``torch.round``, as ``jnp.round``) and the scale a true
division by 127: the rule of the plain versions in
:mod:`repro_torch.kernels.ref`, which :func:`quantize` applies.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ref

# one quantization block per 128 contiguous elements (the reference's
# TPU lane row; one warp row of the q8 kernels)
QBLOCK = 128
CODECS = ("linear", "sqrt")


@dataclasses.dataclass
class QuantizedTensor:
    """Block-quantized int8 encoding of an fp32 tensor."""
    q: torch.Tensor
    scale: torch.Tensor
    block: int = QBLOCK
    codec: str = "linear"

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:   # the dtype of the tensor it ENCODES
        return torch.float32

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()


def nblocks(size: int, block: int = QBLOCK) -> int:
    return max(1, -(-int(size) // int(block)))


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"codec {codec!r}: expected 'linear' or 'sqrt'")


def _blocks(x: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """The raveled ``x`` zero-padded to ``nb`` rows of ``block``."""
    return F.pad(x.reshape(-1), (0, nb * block - x.numel())).reshape(nb,
                                                                     block)


def quantize(x: torch.Tensor, block: int = QBLOCK,
             codec: str = "linear") -> QuantizedTensor:
    """Block-wise absmax int8 quantization of ``x`` (any shape), with the
    q8 kernels' rounding rule (:func:`repro_torch.kernels.ref._requant`)
    applied to its zero-padded blocks."""
    _check_codec(codec)
    requant = ref._requant if codec == "linear" else ref._requant_sqrt
    q, scale = requant(_blocks(x.float(), nblocks(x.numel(), block), block))
    return QuantizedTensor(q=q.reshape(-1)[:x.numel()].reshape(x.shape),
                           scale=scale.reshape(-1), block=block, codec=codec)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """fp32 reconstruction (the exact inverse of the block scaling)."""
    deq = ref._deq if qt.codec == "linear" else ref._deq_sqrt
    x = deq(_blocks(qt.q, qt.scale.shape[0], qt.block), qt.scale[:, None])
    return x.reshape(-1)[:qt.q.numel()].reshape(qt.q.shape)


def zeros(shape, block: int = QBLOCK, codec: str = "linear",
          device=None) -> QuantizedTensor:
    """Quantized all-zeros tensor of the given logical shape."""
    _check_codec(codec)
    size = 1
    for d in shape:
        size *= int(d)
    return QuantizedTensor(
        q=torch.zeros(shape, dtype=torch.int8, device=device),
        scale=torch.zeros((nblocks(size, block),), dtype=torch.float32,
                          device=device),
        block=block, codec=codec)


def zeros_like(x: Any) -> Any:
    """Zeros matching ``x``, quantization-aware (plain tensors pass
    through to ``torch.zeros_like``)."""
    if is_quantized(x):
        return dataclasses.replace(x, q=torch.zeros_like(x.q),
                                   scale=torch.zeros_like(x.scale))
    return torch.zeros_like(x)


def as_f32(x: Any) -> torch.Tensor:
    """Dequantize if quantized, else the tensor as fp32."""
    return dequantize(x) if is_quantized(x) else x.float()


def is_quantized(x: Any) -> bool:
    return isinstance(x, QuantizedTensor)
