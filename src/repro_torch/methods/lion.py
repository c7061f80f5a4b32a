"""LowRank-Lion: the momentum-only subspace paradigm, registered as
``lowrank_lion``.

Counterpart of ``repro.methods.lion``: Algorithm 1's structure (grouped
masters, lazy outer merge + resample, one fused launch per group) with
the sign-based Lion rule on B,

    u  = sign(β1 m + (1 − β1) g_B)
    B' = B − lr (u + wd B)
    m' = β2 m + (1 − β2) g_B

which keeps one moment instead of Adam's two (``v`` becomes a zero-size
placeholder), on top of whatever ``state_dtype``/``master_dtype``
compress.  The method reads ``tcfg.beta1``/``beta2`` as they are: set
them per the Lion recipe (lr 3-10x smaller than Adam's, β2 about 0.99).
"""
from __future__ import annotations

from .lowrank import _LowRankBase
from .registry import register


@register("lowrank_lion")
class LowRankLionMethod(_LowRankBase):
    name = "lowrank_lion"
    algo = "lion"
