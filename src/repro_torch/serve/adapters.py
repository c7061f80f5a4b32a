"""Multi-tenant adapter store: per-tenant ``B`` over a shared ``V``.

Counterpart of ``repro.serve.adapters``.  Each same-shape group of
low-rank leaves (:func:`repro_torch.optim.subspace.build_layout`) keeps
its tenants' ``B`` stacked as ``(G,) + lead + (T, n, r)`` — tenant axis
at -3 — and a decode batch reads it in place: each per-row
:class:`BatchLRPack` of one batched forward holds a view of the stack and
the ``(batch,)`` tenant index of the decode slots, so no step copies a
``B``.  ``W + V Bᵀ`` is never materialised; unloaded tenant rows are
zero, which serves the base weights exactly.

Adapters arrive as arrays (numpy, as the JAX package hands them over, or
tensors) through :meth:`AdapterStore.add_tenant`, or from a training
checkpoint of either package through :meth:`AdapterStore.load_tenant`,
which reads only the ``opt||groups||g||b`` and ``...||proj`` records
(CRC-checked) and refuses a manifest whose method has no servable
``(B, V)`` or whose arch differs, before the store is touched.
Installs are two-phase: validate and stage into fresh buffers first,
then commit by plain attribute rebinds, so a refusal, or a crash at one
of the labeled ``chaos.SWAP_SITES`` before the commit, leaves the store
unchanged.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import lm
from ..models.common import act_dtype, tree_flatten_with_path, tree_unflatten
from ..models.linear import BatchLRPack, LRPack
from ..optim.subspace import build_layout
from ..train import chaos, checkpoint

# Methods whose checkpointed B is a servable low-rank adapter: adamw has
# no subspace, and galore's projected moments are no weight delta.
ADAPTER_METHODS = ("lowrank_adam", "lowrank_lion", "lowrank_lr")

# elements of V compared at a time when a tenant joins (256 MB in fp32)
_DRIFT_PIECE = 1 << 26

_SEP = re.escape(checkpoint.SEP)
_GROUP_KEY = re.compile(rf"^opt{_SEP}groups{_SEP}(\d+){_SEP}(b|proj)$")


class AdapterMismatchError(ValueError):
    """Tenant adapter is incompatible with this serving engine — a
    config error (wrong rank/arch/V), refused before any state is
    mutated."""


def _as_tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))


class AdapterStore:
    """Stacked per-tenant adapters for one model config.

    ``b_full[g]``: ``(G,) + lead + (max_tenants, n, r)``;
    ``projs[g]``: ``(G,) + lead + (k, r)`` shared projection; both in the
    model's activation dtype on ``device``.
    """

    def __init__(self, cfg, tcfg, max_tenants: int, *, device=None):
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.cfg = cfg
        self.tcfg = tcfg
        self.max_tenants = int(max_tenants)
        self.device = resolve_device(device)
        self.layout = build_layout(lm.param_specs(cfg), tcfg)
        dt = act_dtype(cfg)
        self.b_full: List[torch.Tensor] = []
        self.projs: List[torch.Tensor] = []
        for spec in self.layout.groups:
            g = len(spec.leaf_idx)
            lead = spec.shape[:-2]
            k, n = spec.shape[-2], spec.shape[-1]
            self.b_full.append(torch.zeros(
                (g,) + lead + (self.max_tenants, n, spec.rank), dtype=dt,
                device=self.device))
            self.projs.append(torch.zeros(
                (g,) + lead + (k, spec.rank), dtype=dt, device=self.device))
        self._tenants: Dict[str, int] = {}
        self._proj_loaded = False

    @property
    def n_tenants(self) -> int:
        return len(self._tenants)

    def tenant_index(self, tenant: str) -> int:
        return self._tenants[tenant]

    def has_tenant(self, tenant: str) -> bool:
        return tenant in self._tenants

    def _next_slot(self, tenant: str) -> int:
        if tenant in self._tenants:
            return self._tenants[tenant]  # hot-swap in place
        if len(self._tenants) >= self.max_tenants:
            raise AdapterMismatchError(
                f"adapter store is full ({self.max_tenants} tenants); "
                f"cannot load {tenant!r}")
        return len(self._tenants)

    def add_tenant(self, tenant: str, b_groups, projs=None) -> int:
        """Install adapter arrays directly.

        ``b_groups``: one ``(G,) + lead + (n, r)`` array per group;
        ``projs``: matching V buffers (the first installation pins them,
        later ones must agree).  Two-phase: validate, stage, commit.
        """
        b_groups = [_as_tensor(b) for b in b_groups]
        projs = None if projs is None else [_as_tensor(v) for v in projs]
        self._check_group_shapes(tenant, b_groups, projs)
        if projs is not None:
            self._check_proj_drift(tenant, projs)
        return self._two_phase_install(tenant, b_groups, projs)

    def load_tenant(self, tenant: str, workdir: str,
                    step: Optional[int] = None) -> int:
        """Load a tenant's ``(B, V)`` from a training checkpoint (the
        newest step unless ``step`` is named), written by either package.

        The manifest's method and arch, the records' CRCs and the group
        count and shapes are checked before the store is touched; a
        refusal raises :class:`AdapterMismatchError` (corruption raises
        the checkpoint layer's ``IOError``).  Reloading a known tenant
        swaps its slot in place, two-phase."""
        if step is None:
            step = checkpoint.latest_step(workdir)
            if step is None:
                raise AdapterMismatchError(
                    f"no checkpoint found in {workdir!r} for tenant "
                    f"{tenant!r}")
        leaves, manifest = checkpoint.read_leaves(
            workdir, step, lambda k: _GROUP_KEY.match(k) is not None)
        extra = manifest.get("extra") or {}
        method = extra.get("method")
        if method not in ADAPTER_METHODS:
            raise AdapterMismatchError(
                f"tenant {tenant!r}: checkpoint method {method!r} does not "
                f"produce servable low-rank adapters (expected one of "
                f"{ADAPTER_METHODS}); adamw/galore states have no (B, V) "
                f"to serve")
        arch = extra.get("arch")
        if arch is not None and arch != self.cfg.name:
            raise AdapterMismatchError(
                f"tenant {tenant!r}: checkpoint arch {arch!r} != engine "
                f"arch {self.cfg.name!r}")
        n_g = len(self.layout.groups)
        seen = {int(m.group(1)) for m in map(_GROUP_KEY.match, leaves)}
        if seen != set(range(n_g)) or len(leaves) != 2 * n_g:
            raise AdapterMismatchError(
                f"tenant {tenant!r}: checkpoint group ids {sorted(seen)} "
                f"!= engine layout groups {list(range(n_g))} (arch/config "
                f"drift?)")
        pre = [f"opt{checkpoint.SEP}groups{checkpoint.SEP}{g}"
               f"{checkpoint.SEP}" for g in range(n_g)]
        b_groups = [leaves[p + "b"].float() for p in pre]
        projs = [leaves[p + "proj"].float() for p in pre]
        self._check_group_shapes(tenant, b_groups, projs)
        self._check_proj_drift(tenant, projs)
        return self._two_phase_install(tenant, b_groups, projs)

    def _two_phase_install(self, tenant, b_groups, projs) -> int:
        """Stage-then-commit: everything that can fail (allocation, the
        chaos crashes) happens on staged copies; the commit is plain
        attribute rebinds with nothing between them that can raise."""
        chaos.maybe_raise("swap:pre_stage")
        slot = self._next_slot(tenant)
        staged_b = []
        for g, b in enumerate(b_groups):
            buf = self.b_full[g].clone()
            buf[..., slot, :, :] = b.to(self.device, buf.dtype)
            staged_b.append(buf)
        staged_v = None
        if projs is not None and not self._proj_loaded:
            staged_v = [v.to(self.device, self.projs[g].dtype)
                        for g, v in enumerate(projs)]
        chaos.maybe_raise("swap:pre_commit")
        if staged_v is not None:
            self.projs = staged_v
            self._proj_loaded = True
        self.b_full = staged_b
        self._tenants[tenant] = slot
        chaos.maybe_raise("swap:post_commit")
        return slot

    def _check_group_shapes(self, tenant, b_groups, projs):
        if len(b_groups) != len(self.layout.groups):
            raise AdapterMismatchError(
                f"tenant {tenant!r}: {len(b_groups)} adapter groups, "
                f"engine layout expects {len(self.layout.groups)}")
        for g, spec in enumerate(self.layout.groups):
            lead = spec.shape[:-2]
            want_b = (len(spec.leaf_idx),) + lead + (spec.shape[-1],
                                                     spec.rank)
            if tuple(b_groups[g].shape) != want_b:
                raise AdapterMismatchError(
                    f"tenant {tenant!r}: group {g} B has shape "
                    f"{tuple(b_groups[g].shape)}, engine expects {want_b} "
                    f"(rank/arch mismatch between tenant training and "
                    f"serving config)")
            if projs is not None:
                want_v = (len(spec.leaf_idx),) + lead + (spec.shape[-2],
                                                         spec.rank)
                if tuple(projs[g].shape) != want_v:
                    raise AdapterMismatchError(
                        f"tenant {tenant!r}: group {g} V has shape "
                        f"{tuple(projs[g].shape)}, engine expects {want_v}")

    def _check_proj_drift(self, tenant, projs):
        """Validation only — never mutates.  The incoming V is compared
        after the store's own dtype cast, so a bf16 store accepts the
        fp32 V it was installed from; in fp32 pieces of at most
        ``_DRIFT_PIECE`` elements, so a large group (an MoE's expert V:
        3.2 GB in bf16 for qwen3-moe at 24 layers) takes no whole fp32
        copy."""
        if not self._proj_loaded:
            return
        for g, v in enumerate(projs):
            have = self.projs[g].reshape(-1)
            got = v.to(self.device, have.dtype).reshape(-1)
            if not all(torch.allclose(have[i:i + _DRIFT_PIECE].float(),
                                      got[i:i + _DRIFT_PIECE].float(),
                                      rtol=1e-5, atol=1e-6)
                       for i in range(0, have.numel(), _DRIFT_PIECE)):
                raise AdapterMismatchError(
                    f"tenant {tenant!r}: projection V of group {g} "
                    f"differs from the store's shared V — tenants must "
                    f"come from runs with the same sampler key that have "
                    f"not crossed an outer merge-resample cycle (lazy_k)")

    def lrpack_tree(self, params, tenant: str):
        """Single-tenant :class:`LRPack` tree (the prefill path)."""
        t = self._tenants[tenant]
        flat = tree_flatten_with_path(params)
        out = [leaf for _, leaf in flat]
        for g, spec in enumerate(self.layout.groups):
            bt = self.b_full[g][..., t, :, :]        # (G,)+lead+(n, r)
            for j, i in enumerate(spec.leaf_idx):
                out[i] = LRPack(out[i], bt[j], self.projs[g][j])
        return tree_unflatten([p for p, _ in flat], out)


def batched_pack_tree(params, layout, b_fulls, projs, slot_tenants):
    """Per-row :class:`BatchLRPack` tree for one decode batch.

    ``slot_tenants``: (batch,) int64 tensor on the store's device, tenant
    index per decode slot.  Each pack holds a view of its group's stack
    ``b_fulls[g]`` and the index; nothing is gathered or copied.
    """
    flat = tree_flatten_with_path(params)
    out = [leaf for _, leaf in flat]
    for g, spec in enumerate(layout.groups):
        for j, i in enumerate(spec.leaf_idx):
            out[i] = BatchLRPack(out[i], b_fulls[g][j], projs[g][j],
                                 rows=slot_tenants)
    return tree_unflatten([p for p, _ in flat], out)
