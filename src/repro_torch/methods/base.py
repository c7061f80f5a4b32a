"""The Method protocol: one gradient-estimation paradigm, end to end.

Counterpart of ``repro.methods.base``.  A ``Method`` owns the state
construction, the inner and outer steps, the checkpoint tag and the
rollback reseed; the trainer calls them through
``methods.get(tcfg.optimizer)`` and never branches on the name.  The
reference's sharding hook (``pspecs``) and table description wait for
the slices that use them.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


class Method(abc.ABC):
    """One gradient-estimation paradigm (strategy object, stateless)."""

    #: registry name == the ``tcfg.optimizer`` string
    name: str = ""
    #: gradient family: "bp" (backprop/IPA) or "zo" (forward-only/LR)
    family: str = "bp"

    @property
    def checkpoint_tag(self) -> str:
        """Tag written into checkpoint manifests; a resume under a method
        with another tag is refused (the state trees differ)."""
        return self.name

    @abc.abstractmethod
    def init(self, params, tcfg, gen, donate: bool = False
             ) -> Tuple[Any, Any]:
        """``(params, opt_state)`` from a model param tree; ``gen`` is the
        ``torch.Generator`` the paradigm draws from.  ``donate`` hands
        the tree over (a method that regroups the weights may then free
        each leaf as it copies it; the tree stays valid)."""

    @abc.abstractmethod
    def make_inner_step(self, cfg, tcfg,
                        loss_fn: Optional[Callable] = None) -> Callable:
        """``step(params, opt_state, batch) -> (params, opt_state,
        metrics)`` with ``metrics["loss"]`` always present."""

    def make_outer_step(self, cfg, tcfg) -> Optional[Callable]:
        """The every-``lazy_k``-steps step, or ``None``."""
        return None

    def reseed(self, params, opt_state, seed: int, tcfg) -> Tuple[Any, Any]:
        """Rotate the paradigm's draws after an anomaly rollback, so the
        restored run does not replay the offending draw: a state that
        carries a generator gets a fresh one on the same device, seeded
        with ``seed``; anything else (dense AdamW) is returned as is.
        Subspace paradigms also draw a fresh projection."""
        if not hasattr(opt_state, "gen"):
            return params, opt_state
        gen = torch.Generator(device=opt_state.gen.device)
        gen.manual_seed(seed)
        return params, dataclasses.replace(opt_state, gen=gen)
