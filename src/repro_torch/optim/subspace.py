"""The grouped low-rank layout: which leaves carry an adapter, at what
rank, and how same-shape leaves stack into groups.

Counterpart of the layout part of ``repro.optim.subspace``
(``_path_str``, ``is_lowrank_leaf``, ``_rank_for``, ``GroupSpec``,
``SubspaceLayout``, ``build_layout``).  Leaves are numbered in sorted-key
order, as JAX flattens dicts, so ``leaf_idx`` agrees with the reference
and adapters trained there serve here unchanged.  The optimizer state
and the compute-dtype and rank-packing fields of the reference layout
arrive with the training slice.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Tuple

from ..models.common import tree_flatten_with_path

EXCLUDE_DEFAULT = r"(/embed/|/tok$|/pos$|router|conv_w)"


class GroupSpec(NamedTuple):
    """Static description of one group."""
    shape: Tuple[int, ...]      # the member weight shape lead + (k, n_out)
    rank: int
    leaf_idx: Tuple[int, ...]   # member positions in params flat-leaf order


class SubspaceLayout(NamedTuple):
    """Static index map param-tree <-> grouped adapter buffers."""
    n_leaves: int
    dense_idx: Tuple[int, ...]
    groups: Tuple[GroupSpec, ...]


def _path_str(path) -> str:
    return "/" + "/".join(str(p) for p in path)


def is_lowrank_leaf(path: str, x, tcfg) -> bool:
    if re.search(getattr(tcfg, "lowrank_exclude", EXCLUDE_DEFAULT), path):
        return False
    shape = tuple(x.shape)
    if len(shape) == 2:
        return min(shape) >= tcfg.min_dim_for_lowrank
    if len(shape) == 3:  # scan-stacked (L, k, n_out) or experts (E, k, n)
        return min(shape[1:]) >= tcfg.min_dim_for_lowrank
    if len(shape) == 4:  # scan-stacked experts (L, E, k, n_out)
        return min(shape[2:]) >= tcfg.min_dim_for_lowrank
    return False


def _rank_for(shape, tcfg) -> int:
    k, n_out = shape[-2], shape[-1]
    return max(1, min(tcfg.rank, min(k, n_out) // 2))


def build_layout(params, tcfg) -> SubspaceLayout:
    """Classify leaves once; same-shape, same-rank low-rank leaves share a
    group.  ``params`` may hold tensors or ``ParamSpec``s — only shapes
    are read."""
    leaves = tree_flatten_with_path(params)
    dense_idx = []
    by_sig: dict = {}
    for i, (path, x) in enumerate(leaves):
        if is_lowrank_leaf(_path_str(path), x, tcfg):
            sig = (tuple(int(d) for d in x.shape), _rank_for(x.shape, tcfg))
            by_sig.setdefault(sig, []).append(i)
        else:
            dense_idx.append(i)
    groups = tuple(GroupSpec(shape=sig[0], rank=sig[1], leaf_idx=tuple(idx))
                   for sig, idx in by_sig.items())
    return SubspaceLayout(n_leaves=len(leaves), dense_idx=tuple(dense_idx),
                          groups=groups)
