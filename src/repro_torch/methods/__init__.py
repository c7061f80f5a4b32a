"""Gradient-estimation paradigms of the port.

Counterpart of ``repro.methods``: ``methods.get(tcfg.optimizer)`` resolves
a :class:`~repro_torch.methods.base.Method`.  Every paradigm of the
reference's registry is ported: ``lowrank_adam`` (Algorithm 1),
``lowrank_lion`` (its momentum-only variant), ``lowrank_lr`` (the
forward-only estimator), and the baselines ``galore`` and ``adamw``.
"""
from .base import Method  # noqa: F401
from .registry import available, get, register  # noqa: F401

# importing the implementation modules runs their @register decorators
from . import adamw, galore, lion, lowrank  # noqa: E402,F401
