"""The Method protocol: one gradient-estimation paradigm, end to end.

Counterpart of ``repro.methods.base``.  A ``Method`` owns the state
construction and the inner and outer steps; the trainer calls them
through ``methods.get(tcfg.optimizer)`` and never branches on the name.
The reference's sharding hook (``pspecs``), rollback ``reseed``,
checkpoint tag and table description wait for the slices that use them.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Optional, Tuple


class Method(abc.ABC):
    """One gradient-estimation paradigm (strategy object, stateless)."""

    #: registry name == the ``tcfg.optimizer`` string
    name: str = ""
    #: gradient family: "bp" (backprop/IPA) or "zo" (forward-only/LR)
    family: str = "bp"

    @abc.abstractmethod
    def init(self, params, tcfg, gen) -> Tuple[Any, Any]:
        """``(params, opt_state)`` from a model param tree; ``gen`` is the
        ``torch.Generator`` the paradigm draws from."""

    @abc.abstractmethod
    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        """``step(params, opt_state, batch) -> (params, opt_state,
        metrics)`` with ``metrics["loss"]`` always present."""

    def make_outer_step(self, cfg, tcfg) -> Optional[Callable]:
        """The every-``lazy_k``-steps step, or ``None``."""
        return None
