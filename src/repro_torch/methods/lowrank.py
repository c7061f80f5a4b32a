"""LowRank-IPA (Algorithm 1) as the ``lowrank_adam`` method.

Counterpart of ``repro.methods.lowrank``: grouped master weights and
grouped subspace state built once by ``subspace.init_grouped``, the
inner step through autodiff of the packed model, and the lazy outer
merge + resample every ``lazy_k`` steps.  ``lowrank_lr`` (the
forward-only estimator) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..optim import subspace
from ..train import steps as steps_mod
from .base import Method
from .registry import register


@register("lowrank_adam")
class LowRankAdamMethod(Method):
    name = "lowrank_adam"
    family = "bp"

    def init(self, params, tcfg, gen):
        return subspace.init_grouped(params, tcfg, gen)

    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        return steps_mod.make_train_step(cfg, tcfg, loss_fn)

    def make_outer_step(self, cfg, tcfg) -> Optional[Callable]:
        return steps_mod.make_outer_step(cfg, tcfg)
