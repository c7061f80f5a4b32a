"""Vanilla IPA as the ``adamw`` method: full backprop and dense AdamW
(the paper's memory ceiling).

Counterpart of ``repro.methods.adamw``: the parameters stay the model's
nested dict tree, with fp32 moments beside every leaf.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..optim import adamw
from ..train import steps as steps_mod
from .base import Method
from .registry import register


@register("adamw")
class AdamWMethod(Method):
    name = "adamw"
    family = "bp"

    def init(self, params, tcfg, gen, donate=False):
        return params, adamw.init(params)

    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        return steps_mod.make_adamw_train_step(cfg, tcfg, loss_fn)
