"""Gradient-estimation paradigms of the port.

Counterpart of ``repro.methods``: ``methods.get(tcfg.optimizer)`` resolves
a :class:`~repro_torch.methods.base.Method`.  ``lowrank_adam``
(Algorithm 1) and ``lowrank_lion`` (its momentum-only variant) are
ported; the other paradigms wait in ROADMAP.md Queue 1.
"""
from .base import Method  # noqa: F401
from .registry import available, get, register  # noqa: F401

# importing the implementation modules runs their @register decorators
from . import lion, lowrank  # noqa: E402,F401
