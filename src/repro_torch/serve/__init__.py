"""Multi-tenant low-rank serving on one GPU: continuous batching over a
paged decode cache, with per-tenant ``B`` adapters served lazily as
``W + V Bᵀ`` (counterpart of ``repro.serve``)."""

from .adapters import AdapterMismatchError, AdapterStore, batched_pack_tree
from .engine import (Engine, EngineBusy, EngineConfig, Request,
                     TenantQuarantinedError)
from .pages import PagePool

__all__ = [
    "AdapterMismatchError",
    "AdapterStore",
    "batched_pack_tree",
    "Engine",
    "EngineBusy",
    "EngineConfig",
    "PagePool",
    "Request",
    "TenantQuarantinedError",
]
