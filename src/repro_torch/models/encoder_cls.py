"""Bidirectional encoder with a classification head: the fine-tuning
scenario of the paper's §6.2.1 (Tables 1 and 2).

Counterpart of ``repro.models.encoder_cls``, the scaled-down stand-in
for RoBERTa-large (``encoder-small``): a token and a learned position
embedding (``rope_theta = 0``), the dense blocks of :mod:`.lm` run with
``causal=False`` (each under per-block remat with ``cfg.remat``), a
final norm, mean pooling and an fp32 ``head``.  The parameter tree has
the reference's names and ``(L, ...)`` stacking, so weights convert one
to one (:func:`repro_torch.convert.encoder_params_from_numpy`), and its
projections thread through :func:`~.linear.linear` as packed low-rank
adapters in training.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .common import ParamSpec, prm_dtype, rms_norm, tree_init, tree_map
from .linear import linear
from .lm import _attn_specs, _layer, _mlp_specs, _stack, _w, dense_block

POS_LEN = 2048          # learned positions, as the reference's table


def param_specs(cfg, n_classes: int) -> dict:
    d = cfg.d_model
    layer = {"ln1": _w((d,), cfg, "ones"), "attn": _attn_specs(cfg, d),
             "ln2": _w((d,), cfg, "ones"),
             "mlp": _mlp_specs(cfg, d, cfg.d_ff)}
    return {
        "embed": {"tok": ParamSpec((cfg.vocab_size, d), prm_dtype(cfg)),
                  "pos": ParamSpec((POS_LEN, d), prm_dtype(cfg))},
        "layers": tree_map(lambda sp: _stack(sp, cfg.num_layers), layer),
        "final_norm": _w((d,), cfg, "ones"),
        "head": ParamSpec((d, n_classes), torch.float32, "scaled"),
    }


def init_params(cfg, n_classes: int, seed: int = 0, *, device=None) -> dict:
    """Random parameters by the reference's laws from a generator seeded
    with ``seed`` on ``device`` (cuda unless the caller names another)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_init(gen, param_specs(cfg, n_classes), dev)


def forward(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) -> class logits (B, n_classes), fp32."""
    S = tokens.shape[1]
    h = params["embed"]["tok"][tokens.long()]
    h = h + params["embed"]["pos"][:S][None].to(h.dtype)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)

        def block(h, lp=lp):
            return dense_block(h, lp, cfg, causal=False)[0]

        h = checkpoint(block, h, use_reentrant=False) if cfg.remat \
            else block(h)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return linear(h.mean(dim=1).float(), params["head"])
