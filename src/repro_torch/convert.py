"""Carry weights across from the JAX package.

The reference's parameter tree, as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, lm.init_params(cfg, key))``), becomes
the port's tree under the same names, the same ``(L, k, n_out)``
stacking and the same ``y = x @ W`` orientation.  Adapters need no
conversion: ``AdapterStore.add_tenant`` takes the numpy ``B`` and ``V``
buffers the JAX package hands over.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.common import tree_map


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """One numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor
    on ``device``, optionally cast to ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype=None) -> dict:
    """The port's parameter tree from the reference's (nested dicts of
    numpy arrays).  ``dtype`` casts the floating leaves."""
    dev = resolve_device(device)
    return tree_map(lambda a: to_tensor(a, dev, dtype), tree)
