"""Decoder-only LM: the dense, SSM (Mamba2), hybrid and MoE families.

Counterpart of ``repro.models.lm`` for the dense family (``qwen2-7b``,
the LLaMA grid), the SSM family (``mamba2-780m``), the hybrid family
(``zamba2-7b``: Mamba2 layers with ONE shared attention + MLP block
applied after every ``attn_every``-th of them, then a tail of the
``L % attn_every`` layers left) and the MoE family
(``qwen3-moe-30b-a3b``: attention, then a routed expert FFN,
:mod:`repro_torch.models.moe`, with experts stacked ``(L, E, k, n)``;
``deepseek-v2-236b``: multi-head latent attention (MLA), shared experts
beside the routed ones, and ``first_dense_layers`` leading dense layers
stacked apart in ``params["dense_layers"]``).  Every family here trains
and serves (MoE's aux loss terms come back in ``forward_hidden``'s
``aux``, and ``build_loss_fn`` adds them), but MLA, which serves only.

MLA (:func:`mla_apply`) caches the compressed ``c_kv`` and the roped
``k_rope`` (one "head" each).  Prefill expands them to per-head K and V
through ``w_uk`` / ``w_uv``; a decode step absorbs ``w_uk`` into the
query and ``w_uv`` into the context instead (:func:`_uk_absorb`,
:func:`_uv_absorb`: fp32 torch products, as the reference's einsums
outside any Pallas kernel), with an adapter's ``V Bᵀ`` applied in rank-r
form and a decode pack's per-row ``B`` read from the store's stack in
place.
Layers stay stacked on a leading ``L`` axis, as in the reference, and
a Python loop over ``L`` takes the place
of ``lax.scan``.  Every matmul weight is consumed through
:func:`repro_torch.models.linear.linear`, so a packed adapter threads
through unchanged.

Caches are updated in place (the reference returns new arrays): a
prefill writes into the ``DecodeState`` it was given and a paged decode
step writes into the KV arenas of its ``PagedDecodeState`` (the hybrid's
shared block: one arena per application of it).  The recurrent state of
the SSM and hybrid families is the exception in decode: the step
returns it as new tensors and leaves the old ones as they were, so the
serving engine can keep a faulted row's state (a masked write-back).

Entry points:
  param_specs / init_params
  forward_hidden(params, tokens, cfg)          -> ((B, S, d), aux)
  prefill(params, tokens, cfg, state)          -> (last logits, state)
  decode_step_paged(params, token, cfg, state) -> (logits, state)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .attention import (KVCache, blockwise_attention, cache_update,
                        paged_decode_attention, paged_mla_attention,
                        paged_write)
from .common import (ParamSpec, act_dtype, apply_rope, prm_dtype, rms_norm,
                     swiglu, tree_flatten_with_path, tree_init, tree_map,
                     tree_unflatten)
from .linear import BatchLRPack, LRPack, linear, weight_of
from .moe import moe_ffn
from .ssm import SSMState, mamba2_mixer

VOCAB_PAD = 256


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def _require_ported(cfg) -> None:
    """Refuse what the port does not run: enc-dec, vlm and audio
    (ROADMAP.md Queue 1 item 9), and MoE's grouped dispatch (item 10).
    It runs the dense, SSM, hybrid and MoE families, MLA, shared experts
    and leading dense layers (deepseek-v2) included."""
    if cfg.family not in ("dense", "ssm", "hybrid", "moe") \
            or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch (the {cfg.family!r} "
            f"family); it runs the dense, SSM, hybrid and MoE families; "
            f"see ROADMAP.md Queue 1 item 9")
    if cfg.family == "moe" and cfg.moe_groups > 1:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch (grouped MoE dispatch, "
            f"moe_groups={cfg.moe_groups}); see ROADMAP.md Queue 1 item 10")


def _hybrid(cfg) -> bool:
    """zamba2: Mamba2 layers and one shared attention + MLP block."""
    return cfg.family == "hybrid" and bool(cfg.attn_every)


def _n_attn_apps(cfg) -> int:
    """Applications of the hybrid's shared block (one KV cache each)."""
    return cfg.num_layers // cfg.attn_every if _hybrid(cfg) else 0


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _w(shape, cfg, init="scaled"):
    return ParamSpec(tuple(shape), prm_dtype(cfg), init=init)


def _stack(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, spec.dtype, spec.init, spec.scale)


def _attn_specs(cfg, d):
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    s = {
        "wq": _w((d, hq * dh), cfg),
        "wk": _w((d, hkv * dh), cfg),
        "wv": _w((d, hkv * dh), cfg),
        "wo": _w((hq * dh, d), cfg),
    }
    if cfg.qkv_bias:
        s["bq"] = _w((hq * dh,), cfg, "zeros")
        s["bk"] = _w((hkv * dh,), cfg, "zeros")
        s["bv"] = _w((hkv * dh,), cfg, "zeros")
    if cfg.qk_norm:
        s["q_norm"] = _w((dh,), cfg, "ones")
        s["k_norm"] = _w((dh,), cfg, "ones")
    return s


def _mlp_specs(cfg, d, ff):
    return {"w_gate": _w((d, ff), cfg), "w_up": _w((d, ff), cfg),
            "w_down": _w((ff, d), cfg)}


def _mla_specs(cfg, d):
    h = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qlr, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "w_dq": _w((d, qlr), cfg),
        "q_norm": _w((qlr,), cfg, "ones"),
        "w_uq": _w((qlr, h * (nope + rope)), cfg),
        "w_dkv": _w((d, kvl + rope), cfg),
        "kv_norm": _w((kvl,), cfg, "ones"),
        "w_uk": _w((kvl, h * nope), cfg),
        "w_uv": _w((kvl, h * vd), cfg),
        "wo": _w((h * vd, d), cfg),
    }


def _moe_specs(cfg, d):
    """The router (fp32, kept dense by the ``router`` exclusion), the
    experts stacked ``(E, k, n)`` and, with ``num_shared_experts``, one
    shared SwiGLU MLP of their summed width."""
    e, f = cfg.num_experts, cfg.moe_d_ff
    s = {"router": ParamSpec((d, e), torch.float32, "scaled"),
         "w_gate": _w((e, d, f), cfg), "w_up": _w((e, d, f), cfg),
         "w_down": _w((e, f, d), cfg)}
    if cfg.num_shared_experts:
        s["shared"] = _mlp_specs(cfg, d, cfg.num_shared_experts * f)
    return s


def _attn_or_mla_specs(cfg, d):
    return _mla_specs(cfg, d) if cfg.use_mla else _attn_specs(cfg, d)


def _ssm_specs(cfg, d):
    d_in, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    g = max(1, cfg.ssm_groups)
    conv_ch = d_in + 2 * g * n
    f32 = torch.float32
    return {
        "in_proj": _w((d, 2 * d_in + 2 * g * n + h), cfg),
        "conv_w": _w((cfg.ssm_conv_dim, conv_ch), cfg),
        "conv_b": _w((conv_ch,), cfg, "zeros"),
        "a_log": ParamSpec((h,), f32, "ssm_a"),
        "d_skip": ParamSpec((h,), f32, "ones"),
        "dt_bias": ParamSpec((h,), f32, "ssm_dt"),
        "norm": _w((d_in,), cfg, "ones"),
        "out_proj": _w((d_in, d), cfg),
    }


def _layer_specs(cfg, d):
    """Specs of one stacked layer (without the leading L axis)."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ln1": _w((d,), cfg, "ones"), "ssm": _ssm_specs(cfg, d)}
    if cfg.family == "moe":
        return {"ln1": _w((d,), cfg, "ones"),
                "attn": _attn_or_mla_specs(cfg, d),
                "ln2": _w((d,), cfg, "ones"), "moe": _moe_specs(cfg, d)}
    return {"ln1": _w((d,), cfg, "ones"), "attn": _attn_specs(cfg, d),
            "ln2": _w((d,), cfg, "ones"),
            "mlp": _mlp_specs(cfg, d, cfg.d_ff)}


def _n_stacked(cfg) -> int:
    """Layers in the stacked ``params["layers"]``: all but the leading
    dense ones."""
    return cfg.num_layers - cfg.first_dense_layers


def param_specs(cfg) -> dict:
    _require_ported(cfg)
    d = cfg.d_model
    vp = padded_vocab(cfg)
    layer = _layer_specs(cfg, d)
    specs = {
        "embed": {"tok": _w((vp, d), cfg, "normal")},
        "final_norm": _w((d,), cfg, "ones"),
        "unembed": _w((d, vp), cfg),
        "layers": tree_map(lambda sp: _stack(sp, _n_stacked(cfg)), layer),
    }
    if cfg.first_dense_layers:
        # deepseek: leading dense-MLP layers, stacked apart, with the
        # config's attention (MLA)
        lead = {"ln1": _w((d,), cfg, "ones"),
                "attn": _attn_or_mla_specs(cfg, d),
                "ln2": _w((d,), cfg, "ones"),
                "mlp": _mlp_specs(cfg, d, cfg.moe_dense_ff or cfg.d_ff)}
        specs["dense_layers"] = tree_map(
            lambda sp: _stack(sp, cfg.first_dense_layers), lead)
    if _hybrid(cfg):
        # zamba2: ONE attention + MLP block, unstacked, reused after
        # every attn_every-th Mamba layer (weight sharing)
        specs["shared_attn"] = {
            "ln1": _w((d,), cfg, "ones"), "attn": _attn_specs(cfg, d),
            "ln2": _w((d,), cfg, "ones"),
            "mlp": _mlp_specs(cfg, d, cfg.d_ff)}
    return specs


def init_params(cfg, seed: int = 0, *, device=None) -> dict:
    """Random parameters by the reference's laws, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (cuda unless
    the caller names another)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_init(gen, param_specs(cfg), dev)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of an ``(L, ...)``-stacked tree (packs included)."""
    return tree_map(lambda x: x[i], tree)


def _layers(tree, n: int) -> list:
    """The ``n`` layers of an ``(L, ...)``-stacked tree taken apart at
    once with ``unbind`` (an :class:`LRPack`'s ``w``, ``b`` and ``v``
    alike): its backward stacks the layers' gradients in one pass, where
    indexing each layer alone makes the backward add a full-size,
    zero-padded gradient of the stacked leaf per layer (qwen3-moe's
    expert B views at 20 layers: 1 GB a layer and group)."""
    def split(x):
        if isinstance(x, BatchLRPack):
            return [x[i] for i in range(n)]
        if isinstance(x, LRPack):
            return [LRPack(w, b, v) for w, b, v in
                    zip(x.w.unbind(0), x.b.unbind(0), x.v.unbind(0))]
        return list(x.unbind(0))
    flat = tree_flatten_with_path(tree)
    cols = [split(x) for _, x in flat]
    paths = [p for p, _ in flat]
    return [tree_unflatten(paths, [c[i] for c in cols]) for i in range(n)]


def attn_apply(h, p, cfg, *, pos_offset=0, cache=None, cache_index=None,
               causal=True, decode=False, paged=None):
    """GQA attention. Returns (out, (k, v) caches or None).  ``causal=False``
    lets every position attend to every other (the encoder's blocks).

    ``pos_offset`` is an int or a per-row ``(B,)`` tensor (serving:
    sequences at different depths share one decode batch).  Decoding
    needs ``paged=(page_table, lengths)``; the cache is then a pair of
    paged arenas ``(n_pages, page, Hkv, dh)``.
    """
    B, S, _ = h.shape
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = linear(h, p["wq"], p.get("bq")).reshape(B, S, hq, dh)
    k = linear(h, p["wk"], p.get("bk")).reshape(B, S, hkv, dh)
    v = linear(h, p["wv"], p.get("bv")).reshape(B, S, hkv, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        ar = torch.arange(S, device=h.device)
        if torch.is_tensor(pos_offset):
            positions = pos_offset[:, None] + ar
        else:
            positions = (pos_offset + ar).expand(B, S)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    if decode:
        if paged is None:
            raise NotImplementedError(
                "repro_torch decodes over paged caches only")
        pt, lengths = paged
        ck, cv = cache
        paged_write(ck, k, pt, lengths)
        paged_write(cv, v, pt, lengths)
        out = paged_decode_attention(q, ck, cv, pt, lengths + 1)
        new_kv = (ck, cv)
    else:
        out = blockwise_attention(
            q, k, v, causal=causal, q_offset=pos_offset,
            q_chunk=cfg.attn_chunk // 2, kv_chunk=cfg.attn_chunk)
        if cache is not None:   # prefill: persist k/v
            new_kv = cache_update(*cache, k, v, cache_index or 0)
    return linear(out.reshape(B, S, hq * dh), p["wo"]), new_kv


def _picked(y, rows):
    """``y[i, rows[i]]`` of a ``(B, T, ...)`` product against every
    tenant of the store (``torch.gather``: no index of a B stack)."""
    idx = rows.reshape((-1, 1) + (1,) * (y.ndim - 2)).expand(
        (y.shape[0], 1) + y.shape[2:])
    return y.gather(1, idx)[:, 0]


def _uk_absorb(q32, p, h: int, nope: int):
    """Absorb q_nope through ``W_uk``: (B, H, nope) fp32 -> (B, H, kvl).

    With a packed ``p`` the correction is applied in rank-r form, ``W_uk
    + V Bᵀ`` never formed: ``t = q B`` per head, then ``t Vᵀ``.  A
    :class:`BatchLRPack` with ``rows`` holds the store's ``(T, n, r)``
    stack: ``t`` is taken against every tenant's ``B`` and each row's
    picked, so no ``B`` is gathered."""
    w = weight_of(p).float().reshape(-1, h, nope)
    y = torch.einsum("bhn,khn->bhk", q32, w)
    if isinstance(p, LRPack):
        if isinstance(p, BatchLRPack):
            b4 = p.b.float().reshape(p.b.shape[-3], h, nope, -1)
            if p.rows is None:
                t = torch.einsum("bhn,bhnr->bhr", q32, b4)
            else:
                t = _picked(torch.einsum("bhn,thnr->bthr", q32, b4), p.rows)
        else:
            t = torch.einsum("bhn,hnr->bhr", q32,
                             p.b.float().reshape(h, nope, -1))
        y = y + torch.einsum("bhr,kr->bhk", t, p.v.float())
    return y


def _uv_absorb(ctx, p, h: int, vd: int):
    """Absorb the fp32 context through ``W_uv``: (B, H, kvl) -> (B, H,
    vd), a packed ``p``'s correction in rank-r form (as
    :func:`_uk_absorb`)."""
    w = weight_of(p).float().reshape(-1, h, vd)
    y = torch.einsum("bhk,khv->bhv", ctx, w)
    if isinstance(p, LRPack):
        t = torch.einsum("bhk,kr->bhr", ctx, p.v.float())
        if isinstance(p, BatchLRPack):
            b4 = p.b.float().reshape(p.b.shape[-3], h, vd, -1)
            if p.rows is None:
                y = y + torch.einsum("bhr,bhvr->bhv", t, b4)
            else:
                y = y + _picked(torch.einsum("bhr,thvr->bthv", t, b4),
                                p.rows)
        else:
            y = y + torch.einsum("bhr,hvr->bhv", t,
                                 p.b.float().reshape(h, vd, -1))
    return y


def mla_apply(h, p, cfg, *, pos_offset=0, cache=None, cache_index=None,
              decode=False, paged=None):
    """Multi-head latent attention (deepseek-v2).  Returns (out, the
    compressed caches or None).

    Prefill expands K and V per head (``k = [k_nope, k_rope]``, the rope
    part shared by the heads) and runs blockwise attention at qk dim
    ``nope + rope``; with ``cache`` (the dense ``(B, Smax, 1, kvl)`` and
    ``(B, Smax, 1, rope)`` slices) it persists ``c_kv`` and the roped
    ``k_rope``.  Decoding needs ``paged=(page_table, lengths)`` over the
    arenas ``(n_pages, page, 1, kvl)`` / ``(n_pages, page, 1, rope)`` and
    runs the absorbed form.  ``pos_offset`` is an int or a per-row
    ``(B,)`` tensor, as in :func:`attn_apply`.
    """
    B, S, _ = h.shape
    hq = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    scale = (nope + rope) ** -0.5
    ar = torch.arange(S, device=h.device)
    if torch.is_tensor(pos_offset):
        positions = pos_offset[:, None] + ar
    else:
        positions = (pos_offset + ar).expand(B, S)

    cq = rms_norm(linear(h, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = linear(cq, p["w_uq"]).reshape(B, S, hq, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    dkv = linear(h, p["w_dkv"])                          # (B, S, kvl+rope)
    # fresh tensors, both: c_kv feeds w_uk / w_uv in prefill
    c_kv = rms_norm(dkv[..., :kvl], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., kvl:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]      # (B, S, rope)

    if decode:
        if paged is None:
            raise NotImplementedError(
                "repro_torch decodes over paged caches only")
        pt, lengths = paged
        cc_a, cr_a = cache
        paged_write(cc_a, c_kv, pt, lengths)
        paged_write(cr_a, k_rope, pt, lengths)
        q_eff = _uk_absorb(q_nope[:, 0].float(), p["w_uk"], hq, nope)
        ctx = paged_mla_attention(q_eff, q_rope[:, 0], cc_a[:, :, 0],
                                  cr_a[:, :, 0], pt, lengths + 1,
                                  softmax_scale=scale)
        out = _uv_absorb(ctx, p["w_uv"], hq, vd).reshape(B, 1, hq * vd)
        return linear(out.to(h.dtype), p["wo"]), (cc_a, cr_a)

    k_nope = linear(c_kv, p["w_uk"]).reshape(B, S, hq, nope)
    v = linear(c_kv, p["w_uv"]).reshape(B, S, hq, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, hq, rope)],
                  dim=-1)
    out = blockwise_attention(
        torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True,
        q_offset=pos_offset, q_chunk=cfg.attn_chunk // 2,
        kv_chunk=cfg.attn_chunk, softmax_scale=scale)
    new_cache = None
    if cache is not None:   # prefill: persist the compressed caches
        cc, cr = cache
        i = cache_index or 0
        cc[:, i:i + S, 0] = c_kv.to(cc.dtype)
        cr[:, i:i + S, 0] = k_rope.to(cr.dtype)
        new_cache = (cc, cr)
    return linear(out.reshape(B, S, hq * vd), p["wo"]), new_cache


def _attend(h, p, cfg, **kw):
    """A block's pre-norm attention: MLA where the layer holds MLA's
    weights (deepseek's MoE and leading dense layers), else GQA."""
    fn = mla_apply if "w_dkv" in p["attn"] else attn_apply
    return fn(rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"], cfg, **kw)


def mlp_apply(h, p, cfg):
    return linear(swiglu(linear(h, p["w_gate"]), linear(h, p["w_up"])),
                  p["w_down"])


def dense_block(h, p, cfg, **kw):
    """Pre-norm attention (:func:`_attend`) and SwiGLU MLP; ``kw``
    (``causal``, the cache and decode arguments) goes to the
    attention."""
    a, kv = _attend(h, p, cfg, **kw)
    h = h + a
    h = h + mlp_apply(rms_norm(h, p["ln2"], cfg.norm_eps), p["mlp"], cfg)
    return h, kv


def moe_block(h, p, cfg, **kw):
    """Pre-norm attention (:func:`_attend`), then the routed expert FFN
    and, where the layer has one, the shared experts' MLP on the same
    normed input; ``kw`` goes to the attention.  Returns (h, kv, aux)."""
    a, kv = _attend(h, p, cfg, **kw)
    h = h + a
    m = p["moe"]
    hn = rms_norm(h, p["ln2"], cfg.norm_eps)
    out, aux = moe_ffn(hn, m["router"], m["w_gate"], m["w_up"], m["w_down"],
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       norm_topk=cfg.norm_topk, groups=cfg.moe_groups)
    if "shared" in m:
        out = out + mlp_apply(hn, m["shared"], cfg)
    return h + out, kv, aux


def _embed(params, tokens, cfg):
    return params["embed"]["tok"][tokens.long()]


# ---------------------------------------------------------------------------
# Forward (train / eval): full sequence, loop over layers
# ---------------------------------------------------------------------------

def _shared_after(cfg, i: int) -> Optional[int]:
    """The application of the hybrid's shared block that follows layer
    ``i`` (after every ``attn_every``-th Mamba layer; none in the
    ``L % attn_every`` tail), else None."""
    if _hybrid(cfg) and (i + 1) % cfg.attn_every == 0:
        return (i + 1) // cfg.attn_every - 1
    return None


def _blocks(params, cfg) -> list:
    """Every layer in order as ``(block, layer params)``: the leading
    dense layers (``params["dense_layers"]``; cache slots
    ``[0:first_dense_layers]``), then the stacked layers (dense, MoE or
    Mamba2 blocks; the slots after them)."""
    out = []
    if cfg.first_dense_layers:
        out = [(dense_block, lp) for lp in
               _layers(params["dense_layers"], cfg.first_dense_layers)]
    blk = {"dense": dense_block, "moe": moe_block}.get(cfg.family,
                                                        _mamba_block)
    return out + [(blk, lp) for lp in _layers(params["layers"],
                                               _n_stacked(cfg))]


def forward_hidden(params, tokens, cfg):
    """(B, S) tokens -> ((B, S, d) final hidden after the final norm,
    aux).  ``aux`` holds the reference's MoE loss terms, ``lb_loss`` and
    ``router_z`` summed over the layers (zero for the dense, SSM and
    hybrid families).  A dense block is attention and MLP, an MoE block
    attention and the routed experts;
    an SSM block ``h + mamba2_mixer(rms_norm(h, ln1))`` (the reference's
    ``mamba_body``); the hybrid runs the shared dense block
    (``params["shared_attn"]``) after every ``attn_every``-th SSM block.

    With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` around the scan body): only the
    block inputs are kept, and the backward recomputes the block.  The
    hybrid's shared block is checkpointed once per application (the
    reference checkpoints whole groups with a nested per-layer remat;
    the numbers are the same), so zamba2-7b keeps 94 block inputs.  Its
    parameters enter every application's recompute by closure, so their
    gradient is the sum over the applications.  A leading dense layer
    (deepseek) runs first and is checkpointed like any block.
    """
    _require_ported(cfg)

    def run(fn, h, p):
        def block(h):
            out = fn(h, p, cfg)
            if fn is moe_block:
                return out[0], out[2]["lb_loss"], out[2]["router_z"]
            return out[0]
        return checkpoint(block, h, use_reentrant=False) if cfg.remat \
            else block(h)

    h = _embed(params, tokens, cfg)
    lb = rz = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (fn, lp) in enumerate(_blocks(params, cfg)):
        h = run(fn, h, lp)
        if fn is moe_block:
            h, a, z = h
            lb, rz = lb + a, rz + z
        if _shared_after(cfg, i) is not None:
            h = run(dense_block, h, params["shared_attn"])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, {"lb_loss": lb, "router_z": rz}


def logits(params, hidden, cfg):
    """Full logits; padded vocabulary lanes are filled with -1e30."""
    lg = linear(hidden, params["unembed"])
    vp = padded_vocab(cfg)
    if vp != cfg.vocab_size:
        pad = torch.arange(vp, device=lg.device) >= cfg.vocab_size
        lg = lg.masked_fill(pad, -1e30)
    return lg


# ---------------------------------------------------------------------------
# Serving: prefill into a dense cache
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    kv: Optional[KVCache]         # dense and MoE families
    ssm: Optional[SSMState]       # SSM and hybrid families
    shared_kv: Optional[KVCache]  # hybrid: one cache per shared-block app
    pos: int                      # tokens already in cache


def _alloc_ssm(cfg, batch: int, device) -> SSMState:
    conv_ch = cfg.ssm_d_inner + 2 * max(1, cfg.ssm_groups) * cfg.ssm_state
    return SSMState.alloc(cfg.num_layers, batch, cfg.ssm_heads,
                          cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv_dim,
                          conv_ch, dtype=act_dtype(cfg), device=device)


def alloc_decode_state(cfg, batch: int, max_len: int, *,
                       device) -> DecodeState:
    _require_ported(cfg)

    def kv(layers):
        return KVCache.alloc(layers, batch, max_len, cfg.num_kv_heads,
                             cfg.resolved_head_dim, dtype=act_dtype(cfg),
                             device=device)
    if cfg.use_mla:     # c_kv in k, the roped k_rope in v
        return DecodeState(
            KVCache.alloc(cfg.num_layers, batch, max_len, 1,
                          cfg.kv_lora_rank, v_dim=cfg.qk_rope_dim,
                          dtype=act_dtype(cfg), device=device),
            None, None, 0)
    if _attention_layers(cfg):
        return DecodeState(kv(cfg.num_layers), None, None, 0)
    shared = kv(_n_attn_apps(cfg)) if _hybrid(cfg) else None
    return DecodeState(None, _alloc_ssm(cfg, batch, device), shared, 0)


def _attention_layers(cfg) -> bool:
    """Every stacked layer holds attention with a KV cache (dense, MoE)."""
    return cfg.family in ("dense", "moe")


def _mamba_block(h, lp, cfg, **kw):
    m, states = mamba2_mixer(rms_norm(h, lp["ln1"], cfg.norm_eps), lp["ssm"],
                             cfg, **kw)
    return h + m, states


def prefill(params, tokens, cfg, state: DecodeState):
    """Full forward writing the caches (the dense and MoE families: each
    layer's K/V, MLA's compressed ``c_kv`` and ``k_rope``, the leading
    dense layers' first; the SSM and hybrid families: each layer's end
    state and conv window; the hybrid also each application of its
    shared block's K/V); returns (last-position logits, state)."""
    _require_ported(cfg)
    h = _embed(params, tokens, cfg)
    S = h.shape[1]
    for i, (blk, lp) in enumerate(_blocks(params, cfg)):
        if _attention_layers(cfg):
            h = blk(h, lp, cfg, cache=(state.kv.k[i], state.kv.v[i]),
                    cache_index=0)[0]
            continue
        h, (ns, nc) = _mamba_block(h, lp, cfg, want_state=True)
        state.ssm.ssm[i].copy_(ns)
        state.ssm.conv[i].copy_(nc)
        g = _shared_after(cfg, i)
        if g is not None:
            h, _ = dense_block(h, params["shared_attn"], cfg,
                               cache=(state.shared_kv.k[g],
                                      state.shared_kv.v[g]),
                               cache_index=0)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    last = logits(params, h[:, -1:], cfg)
    return last, state._replace(pos=S)


# ---------------------------------------------------------------------------
# Serving: paged decode state (shared page arena across ragged sequences)
# ---------------------------------------------------------------------------

class PagedDecodeState(NamedTuple):
    """Paged decode caches (serving engine).

    ``kv_k`` / ``kv_v``: ``(L, n_pages, page, Hkv, D)`` arenas (dense
    and MoE families; MLA keeps ``c_kv`` and ``k_rope`` with ``Hkv == 1``,
    the leading dense layers in ``[0:first_dense_layers]``); ``ssm``: the slot-indexed :class:`SSMState` of
    the SSM and hybrid families (O(1) per slot, so not paged);
    ``shared_k`` / ``shared_v``: the hybrid's shared-attention arenas
    ``(n_apps, n_pages, page, Hkv, D)``, one per application of its
    shared block;
    ``page_table``: ``(batch, max_pages)`` int32, ``-1`` = unmapped, one
    page-id space for every layer and application; ``lengths``:
    ``(batch,)`` int32 tokens stored per slot, ``0`` marks an inactive
    slot.
    """
    kv_k: Optional[torch.Tensor]
    kv_v: Optional[torch.Tensor]
    ssm: Optional[SSMState]
    shared_k: Optional[torch.Tensor]
    shared_v: Optional[torch.Tensor]
    page_table: torch.Tensor
    lengths: torch.Tensor


def alloc_paged_state(cfg, batch: int, num_pages: int, page_size: int,
                      max_len: int, *, device) -> PagedDecodeState:
    _require_ported(cfg)
    max_pages = -(-max_len // page_size)

    def arenas(layers, heads, k_dim, v_dim):
        shp = (layers, num_pages, page_size, heads)
        return (torch.zeros(shp + (k_dim,), dtype=act_dtype(cfg),
                            device=device),
                torch.zeros(shp + (v_dim,), dtype=act_dtype(cfg),
                            device=device))
    kv_k = kv_v = ssm = sk = sv = None
    dh = cfg.resolved_head_dim
    if cfg.use_mla:
        kv_k, kv_v = arenas(cfg.num_layers, 1, cfg.kv_lora_rank,
                            cfg.qk_rope_dim)
    elif _attention_layers(cfg):
        kv_k, kv_v = arenas(cfg.num_layers, cfg.num_kv_heads, dh, dh)
    else:
        ssm = _alloc_ssm(cfg, batch, device)
        if _hybrid(cfg):
            sk, sv = arenas(_n_attn_apps(cfg), cfg.num_kv_heads, dh, dh)
    return PagedDecodeState(
        kv_k, kv_v, ssm, sk, sv,
        torch.full((batch, max_pages), -1, dtype=torch.int32,
                   device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def decode_step_paged(params, token, cfg, state: PagedDecodeState):
    """One-token decode over paged caches. token: (B, 1) int.

    Slot ``b``'s new token lands at position ``lengths[b]`` of its page
    chain; rows with ``lengths == 0`` are inactive — their cache writes
    are dropped and their logits are never read.  The SSM and hybrid
    families step every slot's recurrent state (inactive rows included,
    as in the reference) into new tensors; ``state.ssm`` is left as it
    was.  The hybrid's application ``g`` of its shared block reads and
    writes the arenas ``shared_k[g]``, ``shared_v[g]``.  MoE routes every
    row, inactive ones included, as the reference does: they take expert
    capacity like the active rows.
    """
    _require_ported(cfg)
    h = _embed(params, token, cfg)
    pt, lengths = state.page_table, state.lengths
    ssm = state.ssm
    if ssm is not None:
        ssm = SSMState(torch.empty_like(ssm.ssm), torch.empty_like(ssm.conv))
    for i, (blk, lp) in enumerate(_blocks(params, cfg)):
        if _attention_layers(cfg):
            h = blk(h, lp, cfg, pos_offset=lengths,
                    cache=(state.kv_k[i], state.kv_v[i]), decode=True,
                    paged=(pt, lengths))[0]
            continue
        h, (ns, nc) = _mamba_block(
            h, lp, cfg, ssm_state=state.ssm.ssm[i],
            conv_state=state.ssm.conv[i], decode=True)
        ssm.ssm[i].copy_(ns)
        ssm.conv[i].copy_(nc)
        g = _shared_after(cfg, i)
        if g is not None:
            h, _ = dense_block(h, params["shared_attn"], cfg,
                               pos_offset=lengths,
                               cache=(state.shared_k[g], state.shared_v[g]),
                               decode=True, paged=(pt, lengths))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    lg = logits(params, h, cfg)
    new_len = torch.where(lengths > 0, lengths + 1, 0).to(lengths.dtype)
    return lg, state._replace(ssm=ssm, lengths=new_len)
