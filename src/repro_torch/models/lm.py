"""Decoder-only LM: the dense, SSM (Mamba2), hybrid and MoE families.

Counterpart of ``repro.models.lm`` for the dense family (``qwen2-7b``,
the LLaMA grid), the SSM family (``mamba2-780m``), the hybrid family
(``zamba2-7b``: Mamba2 layers with ONE shared attention + MLP block
applied after every ``attn_every``-th of them, then a tail of the
``L % attn_every`` layers left) and the MoE family
(``qwen3-moe-30b-a3b``: attention, then a routed expert FFN,
:mod:`repro_torch.models.moe`, with experts stacked ``(L, E, k, n)``).
Every family here trains and serves (MoE's aux loss terms come back
in ``forward_hidden``'s ``aux``, and ``build_loss_fn`` adds them).
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
                        paged_decode_attention, paged_write)
from .common import (ParamSpec, act_dtype, apply_rope, prm_dtype, rms_norm,
                     swiglu, tree_flatten_with_path, tree_init, tree_map,
                     tree_unflatten)
from .linear import BatchLRPack, LRPack, linear
from .moe import moe_ffn
from .ssm import SSMState, mamba2_mixer

VOCAB_PAD = 256


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def _require_ported(cfg) -> None:
    """Refuse what the port does not run: enc-dec, vlm and audio, and
    MLA, shared experts and leading dense layers (deepseek-v2) (ROADMAP.md
    Queue 1 item 9), and MoE's grouped dispatch (item 10).  It trains and
    serves the dense, SSM, hybrid and MoE families."""
    what = None
    if cfg.family not in ("dense", "ssm", "hybrid", "moe") \
            or cfg.is_encoder_decoder:
        what = f"the {cfg.family!r} family"
    elif cfg.use_mla or cfg.num_shared_experts or cfg.first_dense_layers:
        what = "MLA, shared experts, leading dense layers"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch ({what}); it trains "
            f"and serves the dense, SSM, hybrid and MoE families; see "
            f"ROADMAP.md Queue 1 item 9")
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


def _moe_specs(cfg, d):
    """The router (fp32, kept dense by the ``router`` exclusion) and the
    experts stacked ``(E, k, n)``."""
    e, f = cfg.num_experts, cfg.moe_d_ff
    return {"router": ParamSpec((d, e), torch.float32, "scaled"),
            "w_gate": _w((e, d, f), cfg), "w_up": _w((e, d, f), cfg),
            "w_down": _w((e, f, d), cfg)}


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
    ffn = {"moe": _moe_specs(cfg, d)} if cfg.family == "moe" \
        else {"mlp": _mlp_specs(cfg, d, cfg.d_ff)}
    return {"ln1": _w((d,), cfg, "ones"), "attn": _attn_specs(cfg, d),
            "ln2": _w((d,), cfg, "ones"), **ffn}


def param_specs(cfg) -> dict:
    _require_ported(cfg)
    d = cfg.d_model
    vp = padded_vocab(cfg)
    layer = _layer_specs(cfg, d)
    specs = {
        "embed": {"tok": _w((vp, d), cfg, "normal")},
        "final_norm": _w((d,), cfg, "ones"),
        "unembed": _w((d, vp), cfg),
        "layers": tree_map(lambda sp: _stack(sp, cfg.num_layers), layer),
    }
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


def mlp_apply(h, p, cfg):
    return linear(swiglu(linear(h, p["w_gate"]), linear(h, p["w_up"])),
                  p["w_down"])


def dense_block(h, p, cfg, **kw):
    """Pre-norm attention and SwiGLU MLP; ``kw`` (``causal``, the cache
    and decode arguments) goes to :func:`attn_apply`."""
    a, kv = attn_apply(rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"], cfg,
                       **kw)
    h = h + a
    h = h + mlp_apply(rms_norm(h, p["ln2"], cfg.norm_eps), p["mlp"], cfg)
    return h, kv


def moe_block(h, p, cfg, **kw):
    """Pre-norm attention, then the routed expert FFN; ``kw`` goes to
    :func:`attn_apply`.  Returns (h, kv, aux)."""
    a, kv = attn_apply(rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"], cfg,
                       **kw)
    h = h + a
    m = p["moe"]
    out, aux = moe_ffn(rms_norm(h, p["ln2"], cfg.norm_eps), m["router"],
                       m["w_gate"], m["w_up"], m["w_down"], top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       norm_topk=cfg.norm_topk, groups=cfg.moe_groups)
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
    gradient is the sum over the applications.
    """
    _require_ported(cfg)
    apply = {"dense": dense_block, "moe": moe_block}.get(cfg.family,
                                                          _mamba_block)

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
    for i, lp in enumerate(_layers(params["layers"], cfg.num_layers)):
        h = run(apply, h, lp)
        if apply is moe_block:
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
    layer's K/V; the SSM and hybrid families: each layer's end state and
    conv window; the hybrid also each application of its shared block's
    K/V); returns (last-position logits, state)."""
    _require_ported(cfg)
    h = _embed(params, tokens, cfg)
    S = h.shape[1]
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if _attention_layers(cfg):
            blk = moe_block if cfg.family == "moe" else dense_block
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
    and MoE families); ``ssm``: the slot-indexed :class:`SSMState` of
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

    def arenas(layers):
        shp = (layers, num_pages, page_size, cfg.num_kv_heads,
               cfg.resolved_head_dim)
        return (torch.zeros(shp, dtype=act_dtype(cfg), device=device),
                torch.zeros(shp, dtype=act_dtype(cfg), device=device))
    kv_k = kv_v = ssm = sk = sv = None
    if _attention_layers(cfg):
        kv_k, kv_v = arenas(cfg.num_layers)
    else:
        ssm = _alloc_ssm(cfg, batch, device)
        if _hybrid(cfg):
            sk, sv = arenas(_n_attn_apps(cfg))
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
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if _attention_layers(cfg):
            blk = moe_block if cfg.family == "moe" else dense_block
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
