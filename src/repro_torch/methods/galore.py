"""GaLore as the ``galore`` method: the full-backprop gradient projected
onto a data-dependent basis.

Counterpart of ``repro.methods.galore``.  It runs on the grouped master
weights and grouped state layout of the subspace paradigms (the
per-step weight write lands on the stacked buffers).  The basis refresh
happens inside the inner step (it needs that step's full gradient),
every ``lazy_k`` steps as counted on the host, so the method has no
outer step.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..optim import galore
from .base import Method
from .registry import register


@register("galore")
class GaLoreMethod(Method):
    name = "galore"
    family = "bp"

    def init(self, params, tcfg, gen, donate=False):
        return galore.init_grouped(params, tcfg, gen, donate)

    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        return galore.make_inner_step(cfg, tcfg, loss_fn)
