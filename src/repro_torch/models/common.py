"""Shared model machinery: ParamSpec trees, norms, RoPE, initializers.

Counterpart of ``repro.models.common``.  Parameters are plain nested
dicts of tensors with the reference's names, ``(L, ...)`` layer
stacking and ``y = x @ W`` orientation, so trees convert one to one
(:mod:`repro_torch.convert`).  Flattening walks dict keys in sorted
order — the leaf order of JAX's ``tree_flatten`` on dicts — so leaf
indices (the adapter layout's ``leaf_idx``) agree between the packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"      # normal | zeros | ones | scaled | ssm_a | ssm_dt
    scale: float = 0.02


def init_param(gen: torch.Generator, spec: ParamSpec,
               device) -> torch.Tensor:
    """One parameter drawn from ``gen`` (which lives on ``device``) by the
    reference's laws: ``normal`` is N(0, scale²), ``scaled`` is
    N(0, 1/fan_in) with fan_in the second-to-last dim; ``ssm_a`` (Mamba's
    ``A_log``) is log of U[1, 16]; ``ssm_dt`` (``dt_bias``) is the
    inverse softplus of dt = exp(U[log 1e-3, log 0.1])."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("normal", "scaled"):
        if spec.init == "normal":
            s = spec.scale
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            s = 1.0 / max(fan_in, 1) ** 0.5
        z = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return z.mul_(s).to(spec.dtype)
    if spec.init in ("ssm_a", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" \
            else (math.log(1e-3), math.log(0.1))
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device) * (hi - lo) + lo
        if spec.init == "ssm_a":
            return torch.log(u).to(spec.dtype)
        dt = torch.exp(u)
        return (dt + torch.log(-torch.expm1(-dt))).to(spec.dtype)
    raise ValueError(f"init {spec.init!r} is not ported yet")


# ---------------------------------------------------------------------------
# Nested-dict trees
# ---------------------------------------------------------------------------

def tree_flatten_with_path(tree, prefix=()):
    """[(path, leaf)] in sorted-key order; anything not a dict is a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths, leaves) -> dict:
    """Rebuild a nested dict from the paths of
    :func:`tree_flatten_with_path` and new leaves in the same order."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree):
    flat = tree_flatten_with_path(tree)
    return tree_unflatten([p for p, _ in flat], [fn(x) for _, x in flat])


def tree_init(gen: torch.Generator, specs, device) -> dict:
    """Materialise a spec tree, drawing leaves in sorted-key order."""
    return tree_map(lambda s: init_param(gen, s, device), specs)


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding, half-split form.  x: (..., S, H, D); positions:
    broadcastable (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., :, None, None].float() * inv     # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def prm_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def resolve_compute_dtype(tcfg, device) -> torch.dtype:
    """The hot-path compute dtype: what the packed W/B/V views, the fused
    forward/backward and the merge read.  ``auto`` is bf16 on CUDA and
    fp32 on the CPU, as the reference resolves it by backend; masters
    and moments stay fp32 regardless."""
    name = getattr(tcfg, "compute_dtype", "auto") or "auto"
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" \
            else torch.float32
    if name not in DTYPES:
        raise ValueError(f"compute_dtype {name!r}: expected one of "
                         f"{', '.join(sorted(DTYPES))} or 'auto'")
    return DTYPES[name]


STATE_DTYPES = ("float32", "int8")
MASTER_DTYPES = ("float32", "bfloat16")


def _storage_dtype(tcfg, field: str, allowed) -> str:
    name = getattr(tcfg, field, "float32") or "float32"
    if name == "auto":
        name = "float32"
    if name not in allowed:
        raise ValueError(f"{field} {name!r}: expected one of "
                         f"{', '.join(allowed)}")
    return name


def resolve_state_dtype(tcfg=None) -> str:
    """Storage dtype NAME of the grouped subspace moments m/v:
    ``'float32'`` (dense fp32 buffers) or ``'int8'`` (block-quantized,
    dequant -> update -> requant fused in the kernels).  Read from
    ``tcfg.state_dtype`` alone (``''`` and ``'auto'`` mean fp32); the
    reference's ``REPRO_STATE_DTYPE`` override is not read."""
    return _storage_dtype(tcfg, "state_dtype", STATE_DTYPES)


def resolve_master_dtype(tcfg=None) -> str:
    """Storage dtype NAME of the subspace B masters: ``'float32'`` or
    ``'bfloat16'`` (updates stochastically rounded, so the narrow store
    stays unbiased).  Read from ``tcfg.master_dtype`` alone; the
    reference's ``REPRO_MASTER_DTYPE`` override is not read."""
    return _storage_dtype(tcfg, "master_dtype", MASTER_DTYPES)


def compute_view(tree, cdt: torch.dtype):
    """Reduced-precision read view of a weight tree for the loss and its
    backward (the ``adamw`` and ``galore`` baselines).

    Floating leaves are cast to ``cdt`` (nothing is copied at fp32);
    the masters the optimizer updates keep their dtype, and gradients
    flow back through the cast into the master's dtype."""
    if cdt == torch.float32:
        return tree
    return tree_map(lambda x: x.to(cdt) if x.is_floating_point() else x,
                    tree)
