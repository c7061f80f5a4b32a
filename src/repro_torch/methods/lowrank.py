"""The paper's own paradigms: LowRank-IPA (Algorithm 1) as
``lowrank_adam`` and LowRank-LR as ``lowrank_lr``.

Counterpart of ``repro.methods.lowrank``: grouped master weights and
grouped subspace state built once by ``subspace.init_grouped``, and the
lazy outer merge + resample every ``lazy_k`` steps.  The two differ only
in how the subspace gradient ``g_B`` is produced: autodiff through the
packed model (IPA) or the antithetic two-point forward-only estimate
(LR).  :class:`_LowRankBase` holds what the subspace paradigms share
(``lowrank_lion`` in :mod:`.lion` too).  The fused outer step and the
sharding hook are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..optim import subspace
from ..train import steps as steps_mod
from .base import Method
from .registry import register


class _LowRankBase(Method):
    """Shared init, inner and outer step of the subspace paradigms; the
    update rule is the layout's ``algo``."""
    algo = "adam"

    def init(self, params, tcfg, gen, donate=False):
        return subspace.init_grouped(params, tcfg, gen, algo=self.algo,
                                     donate=donate)

    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        # one train step for both rules: inner_update branches on the
        # layout's algo, state_dtype and master_dtype
        return steps_mod.make_train_step(cfg, tcfg, loss_fn)

    def make_outer_step(self, cfg, tcfg) -> Optional[Callable]:
        return steps_mod.make_outer_step(cfg, tcfg)

    def reseed(self, params, opt_state, seed: int, tcfg):
        """Anomaly-rollback reseed: a fresh generator, then one outer
        merge + resample — function-preserving (``W += V Bᵀ``, B zeroed)
        with the offending ``V`` replaced by a fresh draw from the same
        law, so unbiasedness is untouched."""
        params, state = super().reseed(params, opt_state, seed, tcfg)
        return subspace.outer_merge_resample(params, state, tcfg)


@register("lowrank_adam")
class LowRankAdamMethod(_LowRankBase):
    name = "lowrank_adam"


@register("lowrank_lr")
class LowRankLRMethod(_LowRankBase):
    name = "lowrank_lr"
    family = "zo"

    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        return steps_mod.make_zo_train_step(cfg, tcfg, loss_fn)
