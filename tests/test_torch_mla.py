"""The MLA family (deepseek-v2-236b) served by the port, against the JAX
package, on the CPU, fp32.

The config is deepseek-v2-236b ``.reduced()``: 2 layers (the leading
dense layer and one MoE layer), d 64, 4 heads, q_lora 48, kv_lora 32,
qk nope 16 + rope 8, v_head 16, 8 routed experts top-2 with
``norm_topk=False``, one shared expert (moe_d_ff 32), the dense MLP 128
wide; and the same at 4 layers (the dense layer and 3 MoE layers, so
that ``layers`` is stacked deeper than ``dense_layers``).
``min_dim_for_lowrank`` 32 so that every matmul leaf, the experts'
included, carries a rank-16 adapter.  Weights are the reference's (seed
0), carried across by ``convert.params_from_numpy``; adapters are numpy
arrays installed in both packages' stores.

Every comparison of values holds the routing of every ``moe_ffn`` call
equal first (``tests/_torch_parity.py``: equal top-k and keep masks, the
k-th/(k+1)-th gap above twice the largest probability difference).  The
limit, ``REL`` · max|y| of the reference's output, is set against a
float64 run of the port's plain path (``float64_plain_path``, weights,
adapters and caches widened): the port and the reference each lie
within it of float64 too, so it is the scale of fp32 sums taken in
another order and not of a fault (measured threaded and with
``XLA_FLAGS="--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1"``).

* ``param_specs`` and the converted tree (``dense_layers`` stacked apart,
  the shared experts' MLP), the adapter layout and the stores at both
  depths and at full size: at 2 layers the leading layer's and the MoE
  layer's attention leaves are both ``(1, k, n)`` and share groups, at 4
  they do not;
* ``forward_hidden`` with its aux, ``prefill`` (logits and the
  compressed caches ``c_kv`` / ``k_rope``) and four paged decode steps
  (two tenants at different depths and an inactive slot) against
  ``repro.models.lm``;
* the absorbs (``_uk_absorb``, ``_uv_absorb``) over a plain weight, an
  ``LRPack``, a per-row ``BatchLRPack`` and one with ``rows`` (the
  store's stack read in place, tenants [1, 0]) against the reference's;
  two planted faults (the rope term dropped from the absorbed scores,
  ``B`` left out of ``_uk_absorb``) fail the decode check; the absorbs
  index no ``B`` stack;
* prefill then absorbed paged decode equals the expanded forward, teacher
  forced, where capacity drops nothing;
* the port's ``Engine`` gives the JAX engine's tokens (every greedy
  step's top-2 logit gap above 1e-4), lazy serving equals merged
  serving, a tenant loads from a checkpoint the JAX package wrote, and a
  snapshot in mid-decode restores into an engine that finishes with the
  uninterrupted tokens.

The reference's entry points are jitted once for the module (the
routing recorder in place), so the file runs in tens of seconds.  The
card's tests of this path, which import no JAX, are in
``tests/test_torch_mla_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.linear import BatchLRPack as JBatchLRPack  # noqa: E402
from repro.models.linear import LRPack as JLRPack  # noqa: E402
from repro.optim import subspace as jsubspace  # noqa: E402
from repro.serve import AdapterStore as JStore  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import batched_pack_tree as jbatched  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.common import (tree_flatten_with_path,  # noqa: E402
                                       tree_map)
from repro_torch.models.linear import (BatchLRPack, LRPack,  # noqa: E402
                                       effective_weight)
from repro_torch.optim.subspace import build_layout  # noqa: E402
from repro_torch.serve import (AdapterStore, Engine,  # noqa: E402
                               EngineConfig, Request, batched_pack_tree)
from repro_torch.serve import engine as engine_mod  # noqa: E402

from _torch_parity import (assert_same_routing,  # noqa: E402
                           float64_plain_path, jax_routing_recorder,
                           port_routing_recorder)

REL = 1e-5
RANK = 16
MIN_GAP = 1e-4
TCFG = TrainConfig(rank=RANK, min_dim_for_lowrank=32)
JTCFG = JTrainConfig(optimizer="lowrank_adam", rank=RANK,
                     min_dim_for_lowrank=32)
ARCH = "deepseek-v2-236b"


def _model(layers):
    jcfg = jget_config(ARCH).reduced().replace(num_layers=layers)
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    return SimpleNamespace(
        cfg=get_config(ARCH).reduced().replace(num_layers=layers),
        jcfg=jcfg, jparams=jparams,
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu"))


M2 = _model(2)
CFG, JCFG = M2.cfg, M2.jcfg
TOP_K = CFG.top_k
_M4 = {}


def _m4():
    if not _M4:
        _M4["m"] = _model(4)
    return _M4["m"]


@pytest.fixture(scope="module")
def ref():
    """The reference's entry points, each jitted once for the module,
    with a routing recorder in place of ``repro.models.lm.moe_ffn``
    (tests clear ``record`` before use)."""
    record = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jlm, "moe_ffn", jax_routing_recorder(record))
    yield SimpleNamespace(
        record=record,
        forward=jax.jit(jlm.forward_hidden, static_argnums=2),
        prefill=jax.jit(jlm.prefill, static_argnums=2),
        decode=jax.jit(jlm.decode_step_paged, static_argnums=2))
    mp.undo()


def _stores(n_tenants, m=M2, seed=1, scale=0.05):
    js = JStore(m.jcfg, JTCFG, max_tenants=n_tenants)
    ts = AdapterStore(m.cfg, TCFG, max_tenants=n_tenants, device="cpu")
    rng = np.random.default_rng(seed)
    projs = [scale * rng.standard_normal(v.shape).astype(np.float32)
             for v in js.projs]
    for t in range(n_tenants):
        bs = [scale * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
              .astype(np.float32) for b in js.b_full]
        js.add_tenant(f"t{t}", bs, projs)
        ts.add_tenant(f"t{t}", bs, projs)
    return js, ts


def _wide(store):
    """A float64 copy of a port store (the float64 run's adapters)."""
    w = AdapterStore(CFG, TCFG, max_tenants=store.max_tenants, device="cpu")
    w.b_full = [b.double() for b in store.b_full]
    w.projs = [v.double() for v in store.projs]
    w._tenants, w._proj_loaded = dict(store._tenants), True
    return w


WIDE_PARAMS = tree_map(lambda t: t.double(), M2.params)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _close(got, want, f64=None, what="", rel=REL):
    """``got`` (the port) within ``rel`` · max|want| of ``want`` (the
    reference) and, given ``f64``, each of them within it of the float64
    run."""
    scale = float(np.abs(np.asarray(want, np.float64)).max())
    err = _gap(got, want)
    assert err <= rel * scale, \
        f"{what} max abs err {err:.3g} > {rel} * {scale:.3g}"
    if f64 is not None:
        e_port, e_ref = _gap(got, f64), _gap(want, f64)
        print(f"{what}: port-reference {err:.3g}, port-float64 "
              f"{e_port:.3g}, reference-float64 {e_ref:.3g}, max {scale:.3g}")
        assert max(e_port, e_ref) <= rel * scale, (e_port, e_ref)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# Parameters, layout, stores
# ---------------------------------------------------------------------------

def test_param_specs_and_the_converted_tree_match_the_reference():
    jflat = jax.tree_util.tree_flatten_with_path(M2.jparams)[0]
    tflat = tree_flatten_with_path(M2.params)
    specs = tree_flatten_with_path(lm.param_specs(CFG))
    assert [jsubspace._path_str(p) for p, _ in jflat] == \
        ["/" + "/".join(p) for p, _ in tflat] == \
        ["/" + "/".join(p) for p, _ in specs]
    for (_, a), (_, t), (_, s) in zip(jflat, tflat, specs):
        assert tuple(a.shape) == tuple(t.shape) == tuple(s.shape)
        assert t.dtype == s.dtype
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    p = M2.params
    d, nope, rope = CFG.d_model, CFG.qk_nope_dim, CFG.qk_rope_dim
    h, kvl = CFG.num_heads, CFG.kv_lora_rank
    assert tuple(p["dense_layers"]["mlp"]["w_up"].shape) == \
        (1, d, CFG.moe_dense_ff)
    assert tuple(p["layers"]["moe"]["shared"]["w_gate"].shape) == \
        (1, d, CFG.num_shared_experts * CFG.moe_d_ff)
    for sub in ("dense_layers", "layers"):
        attn = p[sub]["attn"]
        assert tuple(attn["w_uq"].shape) == (1, CFG.q_lora_rank,
                                             h * (nope + rope))
        assert tuple(attn["w_dkv"].shape) == (1, d, kvl + rope)
        assert tuple(attn["w_uk"].shape) == (1, kvl, h * nope)


@pytest.mark.parametrize("layers", [2, 4, 60])
def test_layout_and_store_shapes_match_the_reference(layers):
    """At 2 layers the leading layer's and the MoE layer's attention and
    MLP-shaped leaves are both (1, k, n) and share groups, keyed by
    (shape, rank) in sorted-key order; at 4 (1 against 3) they do not.
    At full size (60 layers, r = 128) the layouts are compared from the
    specs alone."""
    if layers == 60:
        cfg, jcfg = get_config(ARCH), jget_config(ARCH)
        tcfg, jtcfg = TrainConfig(), JTrainConfig(optimizer="lowrank_adam")
    else:
        m = M2 if layers == 2 else _m4()
        cfg, jcfg, tcfg, jtcfg = m.cfg, m.jcfg, TCFG, JTCFG
    got = build_layout(lm.param_specs(cfg), tcfg)
    want = jsubspace.build_layout(jlm.abstract_params(jcfg), jtcfg)
    assert [tuple(g) for g in got.groups] == \
        [(g.shape, g.rank, g.leaf_idx) for g in want.groups]
    assert got.dense_idx == want.dense_idx
    paths = ["/".join(p) for p, _ in
             tree_flatten_with_path(lm.param_specs(cfg))]
    group_of = {paths[i]: n for n, g in enumerate(got.groups)
                for i in g.leaf_idx}
    shared = group_of["dense_layers/attn/w_uk"] == \
        group_of["layers/attn/w_uk"]
    assert shared == (layers == 2)
    if layers == 60:
        return
    js, ts = _stores(2, m)
    assert [tuple(b.shape) for b in ts.b_full] == \
        [tuple(b.shape) for b in js.b_full]
    assert [tuple(v.shape) for v in ts.projs] == \
        [tuple(v.shape) for v in js.projs]


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def test_forward_hidden_with_aux_matches_jax(ref, monkeypatch):
    js, ts = _stores(1)
    toks = _tokens((2, 24), 3)
    got = []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    ref.record.clear()
    th, aux = lm.forward_hidden(ts.lrpack_tree(M2.params, "t0"),
                                torch.as_tensor(toks), CFG)
    jh, jaux = ref.forward(js.lrpack_tree(M2.jparams, "t0"),
                           jnp.asarray(toks), JCFG)
    jax.effects_barrier()
    assert_same_routing(got, ref.record, TOP_K)
    assert len(got) == CFG.num_layers - CFG.first_dense_layers
    with float64_plain_path():
        fh, faux = lm.forward_hidden(_wide(ts).lrpack_tree(WIDE_PARAMS, "t0"),
                                     torch.as_tensor(toks), CFG)
    assert fh.dtype == torch.float64
    _close(th, jh, fh, "hidden")
    for name in ("lb_loss", "router_z"):
        assert float(aux[name]) > 0
        _close(aux[name], jaux[name], faux[name], name)


def _prefill_both(ref, js, ts, toks, tenant, cap):
    jst = jlm.alloc_decode_state(JCFG, 1, cap)
    jlg, jst = ref.prefill(js.lrpack_tree(M2.jparams, tenant),
                           jnp.asarray(toks), JCFG, jst)
    tst = lm.alloc_decode_state(CFG, 1, cap, device="cpu")
    tlg, tst = lm.prefill(ts.lrpack_tree(M2.params, tenant),
                          torch.as_tensor(toks), CFG, tst)
    return jlg, jst, tlg, tst


def test_prefill_logits_and_compressed_caches_match_jax(ref, monkeypatch):
    js, ts = _stores(2, seed=2)
    got = []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    ref.record.clear()
    toks = _tokens((1, 20), 4)
    for tenant in ("t0", "t1"):
        jlg, jst, tlg, tst = _prefill_both(ref, js, ts, toks, tenant, 24)
        with float64_plain_path():
            st = lm.alloc_decode_state(CFG, 1, 24, device="cpu")
            st = st._replace(kv=KVCache(st.kv.k.double(), st.kv.v.double()))
            flg, fst = lm.prefill(_wide(ts).lrpack_tree(WIDE_PARAMS, tenant),
                                  torch.as_tensor(toks), CFG, st)
        jax.effects_barrier()
        # (L, 1, 24, 1, kvl) c_kv and (L, 1, 24, 1, rope) roped k_rope
        assert tuple(tst.kv.k.shape) == tuple(jst.kv.k.shape) == \
            (2, 1, 24, 1, CFG.kv_lora_rank)
        assert tuple(tst.kv.v.shape) == (2, 1, 24, 1, CFG.qk_rope_dim)
        vs = CFG.vocab_size
        _close(tlg[..., :vs], jlg[..., :vs], flg[..., :vs], "prefill logits")
        _close(tst.kv.k, jst.kv.k, fst.kv.k, "c_kv cache")
        _close(tst.kv.v, jst.kv.v, fst.kv.v, "k_rope cache")
        assert tst.pos == int(jst.pos) == 20
        assert not tst.kv.k[:, :, 20:].any()
    # each port call is followed by the float64 run's
    assert_same_routing(got[0::2], ref.record, TOP_K)
    assert_same_routing(got[1::2], ref.record, TOP_K)


PAGE, N_PAGES, NB = 4, 10, 3
PT = np.full((NB, 4), -1, np.int32)
PT[0, :2] = [0, 1]
PT[1, :3] = [5, 2, 7]
LENS = np.array([3, 9, 0], np.int32)
TENANTS = np.array([1, 0, 0])


def _decode_run(ref, steps=4, record=None):
    """``steps`` teacher-forced paged decode steps of a batch of three
    (tenant 1 at depth 3, tenant 0 at depth 9, an inactive slot) over
    random compressed arenas, through the reference, the port and the
    port's plain path in float64.  Returns their logits and arenas."""
    js, ts = _stores(2, seed=2)
    jst = jlm.alloc_paged_state(JCFG, NB, N_PAGES, PAGE, 16)
    tst = lm.alloc_paged_state(CFG, NB, N_PAGES, PAGE, 16, device="cpu")
    assert tst.ssm is None and tuple(tst.kv_k.shape) == \
        tuple(jst.kv_k.shape) == (2, N_PAGES, PAGE, 1, CFG.kv_lora_rank)
    assert tuple(tst.kv_v.shape) == tuple(jst.kv_v.shape)
    rng = np.random.default_rng(6)
    kk, vv = (rng.standard_normal(a.shape).astype(np.float32)
              for a in (jst.kv_k, jst.kv_v))
    jst = jst._replace(kv_k=jnp.asarray(kk), kv_v=jnp.asarray(vv),
                       page_table=jnp.asarray(PT),
                       lengths=jnp.asarray(LENS))
    tst = tst._replace(kv_k=torch.tensor(kk), kv_v=torch.tensor(vv),
                       page_table=torch.tensor(PT),
                       lengths=torch.tensor(LENS))
    fst = tst._replace(kv_k=torch.tensor(kk).double(),
                       kv_v=torch.tensor(vv).double())
    jpack = jbatched(M2.jparams, js.layout, js.b_full, js.projs,
                     jnp.asarray(TENANTS))
    tpack = batched_pack_tree(M2.params, ts.layout, ts.b_full, ts.projs,
                              torch.tensor(TENANTS))
    ws = _wide(ts)
    fpack = batched_pack_tree(WIDE_PARAMS, ws.layout, ws.b_full, ws.projs,
                              torch.tensor(TENANTS))
    tok = np.array([[5], [9], [0]], np.int32)
    out = []
    for _ in range(steps):
        jlg, jst = ref.decode(jpack, jnp.asarray(tok), JCFG, jst)
        tlg, tst = lm.decode_step_paged(tpack, torch.tensor(tok), CFG, tst)
        with float64_plain_path():
            flg, fst = lm.decode_step_paged(fpack, torch.tensor(tok), CFG,
                                            fst)
        jax.effects_barrier()
        out.append((tlg, jlg, flg))
        np.testing.assert_array_equal(tst.lengths.numpy(),
                                      np.asarray(jst.lengths))
        tok = np.asarray(jnp.argmax(jlg[:, -1], -1))[:, None].astype(
            np.int32)
    return out, (tst, jst, fst)


def test_paged_decode_matches_jax(ref, monkeypatch):
    got = []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    ref.record.clear()
    steps, (tst, jst, fst) = _decode_run(ref)
    vs = CFG.vocab_size
    for tlg, jlg, flg in steps:               # row 2 is inactive
        _close(tlg[:2, ..., :vs], jlg[:2, ..., :vs], flg[:2, ..., :vs],
               "decode logits")
    # the float64 run routes too: its calls follow the port's
    assert_same_routing(got[0::2], ref.record, TOP_K)
    assert_same_routing(got[1::2], ref.record, TOP_K)
    assert len(ref.record) == 4 * (CFG.num_layers - CFG.first_dense_layers)
    _close(tst.kv_k, jst.kv_k, fst.kv_k, "c_kv arena")
    _close(tst.kv_v, jst.kv_v, fst.kv_v, "k_rope arena")
    # the new tokens landed at each active slot's depth, the inactive
    # slot wrote nothing
    assert tst.kv_k[:, 1, 3].abs().sum() > 0


# ---------------------------------------------------------------------------
# The absorbs
# ---------------------------------------------------------------------------

B_ROWS = np.array([1, 0])


def _absorb_operands(form, name, seed=0):
    """A w_uk or w_uv leaf and its adapter in ``form`` for both packages:
    the store's (T, n, r) stack read at ``B_ROWS`` for ``batch_rows``,
    the reference given ``b`` gathered per row."""
    rng = np.random.default_rng(seed)
    kvl, h = CFG.kv_lora_rank, CFG.num_heads
    n = h * (CFG.qk_nope_dim if name == "w_uk" else CFG.v_head_dim)
    w = (kvl ** -0.5 * rng.standard_normal((kvl, n))).astype(np.float32)
    v = (kvl ** -0.5 * rng.standard_normal((kvl, RANK))).astype(np.float32)
    b = (0.05 * rng.standard_normal((3, n, RANK))).astype(np.float32)
    tw, tv, tb = (torch.as_tensor(a) for a in (w, v, b))
    if form == "plain":
        return tw, jnp.asarray(w)
    if form == "lrpack":
        return LRPack(tw, tb[2], tv), JLRPack(jnp.asarray(w),
                                              jnp.asarray(b[2]),
                                              jnp.asarray(v))
    jp = JBatchLRPack(jnp.asarray(w), jnp.asarray(b[B_ROWS]), jnp.asarray(v))
    if form == "batch":
        return BatchLRPack(tw, tb[B_ROWS], tv), jp
    return BatchLRPack(tw, tb, tv, rows=torch.as_tensor(B_ROWS)), jp


@pytest.mark.parametrize("form", ["plain", "lrpack", "batch", "batch_rows"])
def test_absorbs_match_jax(form):
    h, nope, vd = CFG.num_heads, CFG.qk_nope_dim, CFG.v_head_dim
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, h, nope)).astype(np.float32)
    ctx = rng.standard_normal((2, h, CFG.kv_lora_rank)).astype(np.float32)
    tp, jp = _absorb_operands(form, "w_uk")
    _close(lm._uk_absorb(torch.as_tensor(q), tp, h, nope),
           jlm._uk_absorb(jnp.asarray(q), jp, h, nope), what="uk absorb")
    tp, jp = _absorb_operands(form, "w_uv", seed=2)
    _close(lm._uv_absorb(torch.as_tensor(ctx), tp, h, vd),
           jlm._uv_absorb(jnp.asarray(ctx), jp, h, vd), what="uv absorb")


def _no_b(q32, p, h, nope):
    """``_uk_absorb`` with ``B`` left out: the base weight's product and
    nothing of the adapter."""
    w = p.w.float().reshape(-1, h, nope)
    return torch.einsum("bhn,khn->bhk", q32, w)


def _no_rope(real):
    def attend(q_eff, q_rope, *a, **kw):
        return real(q_eff, torch.zeros_like(q_rope), *a, **kw)
    return attend


@pytest.mark.parametrize("fault", ["rope term dropped", "B left out"])
def test_planted_faults_fail_the_decode_check(ref, fault, monkeypatch):
    if fault == "B left out":
        monkeypatch.setattr(lm, "_uk_absorb", _no_b)
    else:
        monkeypatch.setattr(lm, "paged_mla_attention",
                            _no_rope(lm.paged_mla_attention))
    ref.record.clear()
    steps, _ = _decode_run(ref, steps=1)
    tlg, jlg, _ = steps[0]
    vs = CFG.vocab_size
    with pytest.raises(AssertionError, match="max abs err"):
        _close(tlg[:2, ..., :vs], jlg[:2, ..., :vs], what="decode logits")


def test_absorbs_index_no_b_stack():
    """The absorbs read the store's (T, n, r) stack in place, through the
    decode pack of a layer: no ``index`` or ``index_select`` of a tensor
    of 3 or more dims (the per-row forward's plain version, which the
    CPU runs, gathers; its kernel reads by tenant index, and the card's
    decode step is profiled whole in ``tests/test_torch_mla_kernels.py``
    and ``chip_smoke.py``)."""
    from torch.profiler import ProfilerActivity, profile
    _, ts = _stores(2)
    attn = batched_pack_tree(M2.params, ts.layout, ts.b_full, ts.projs,
                             torch.tensor(B_ROWS))["layers"]["attn"]
    uk, uv = attn["w_uk"][0], attn["w_uv"][0]
    assert uk.rows is not None and uk.b.shape[0] == 2
    h, nope, kvl = CFG.num_heads, CFG.qk_nope_dim, CFG.kv_lora_rank
    q, ctx = torch.randn(2, h, nope), torch.randn(2, h, kvl)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        lm._uk_absorb(q, uk, h, nope)
        lm._uv_absorb(ctx, uv, h, CFG.v_head_dim)
    reads = [e.input_shapes[0] for e in prof.events()
             if e.name in ("aten::index", "aten::index_select")
             and e.input_shapes and len(e.input_shapes[0]) >= 3]
    assert not reads
    assert "aten::gather" in {e.name for e in prof.events()}


def test_prefill_then_absorbed_decode_equals_the_expanded_forward():
    """Without drops (capacity factor 16) routing is per token, so a
    prefill then absorbed paged decode steps give the teacher-forced
    expanded forward's logits (the absorbed form against the expanded
    one, inside the port)."""
    cfg = CFG.replace(capacity_factor=16.0)
    _, ts = _stores(1, seed=3)
    pre = ts.lrpack_tree(M2.params, "t0")
    dec = batched_pack_tree(M2.params, ts.layout, ts.b_full, ts.projs,
                            torch.tensor([0]))
    seq = _tokens((24,), 8)
    S, steps = 16, 8
    st = lm.alloc_decode_state(cfg, 1, 28, device="cpu")
    lg, st = lm.prefill(pre, torch.as_tensor(seq[None, :S]), cfg, st)
    ps = lm.alloc_paged_state(cfg, 1, 7, PAGE, 28, device="cpu")
    ps.kv_k.copy_(st.kv.k[:, 0].reshape(ps.kv_k.shape))
    ps.kv_v.copy_(st.kv.v[:, 0].reshape(ps.kv_v.shape))
    ps = ps._replace(page_table=torch.arange(7, dtype=torch.int32)[None],
                     lengths=torch.tensor([S], dtype=torch.int32))
    got = [lg[0, -1]]
    for t in range(S, S + steps - 1):
        lg, ps = lm.decode_step_paged(dec, torch.as_tensor(seq[t:t + 1])
                                      [None], cfg, ps)
        got.append(lg[0, -1])
    h, _ = lm.forward_hidden(pre, torch.as_tensor(seq[None]), cfg)
    want = lm.logits(pre, h, cfg)[0, S - 1:S + steps - 1]
    vs = cfg.vocab_size
    _close(torch.stack(got)[:, :vs], want[:, :vs], rel=1e-4,
           what="absorbed decode")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _prompt(n, seed):
    return _tokens((n,), seed)


def _ecfg(**over):
    base = dict(page_size=4, max_batch=2, max_len=48, max_out=8)
    base.update(over)
    return base


def _logit_recorder(monkeypatch, record):
    """Record the logits of every prefill and of every active row of
    every decode step the port's engine runs."""
    real_prefill, real_decode = engine_mod.prefill, \
        engine_mod.decode_step_paged

    def prefill(params, tokens, cfg, state):
        lg, state = real_prefill(params, tokens, cfg, state)
        record.append(lg[:, -1, :cfg.vocab_size])
        return lg, state

    def decode(params, token, cfg, state):
        active = state.lengths > 0
        lg, new = real_decode(params, token, cfg, state)
        record.append(lg[active, -1, :cfg.vocab_size])
        return lg, new
    monkeypatch.setattr(engine_mod, "prefill", prefill)
    monkeypatch.setattr(engine_mod, "decode_step_paged", decode)


REQS = [("r0", _prompt(3, 5), 6, "t0"), ("r1", _prompt(6, 6), 3, "t1")]
MORE = [("r2", _prompt(4, 7), 5, "t1")]


def _drive(eng, R, reqs=REQS, more=MORE):
    for rid, p, n, ten in reqs:
        eng.submit(R(rid, p, n, tenant=ten))
    for _ in range(3):
        assert eng.step()
    for rid, p, n, ten in more:
        eng.submit(R(rid, p, n, tenant=ten))
    return eng.run()


def test_engine_two_tenants_staggered_match_jax(ref, monkeypatch):
    js, ts = _stores(2)
    got, logits = [], []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    _logit_recorder(monkeypatch, logits)
    ref.record.clear()
    jout = _drive(JEngine(M2.jparams, JCFG, adapters=js,
                          engine_cfg=JEngineConfig(**_ecfg())), JRequest)
    eng = Engine(M2.params, CFG, adapters=ts, engine_cfg=EngineConfig(
        **_ecfg()), device="cpu")
    tout = _drive(eng, Request)
    jax.effects_barrier()
    assert sorted(tout) == ["r0", "r1", "r2"]
    for rid, _, n, _ in REQS + MORE:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n and eng.reasons[rid] == "completed"
    assert_same_routing(got, ref.record, TOP_K)
    rows = torch.cat(logits)
    top = torch.topk(rows, 2, dim=-1).values
    gap = (top[:, 0] - top[:, 1]).min().item()
    print(f"smallest top-2 logit gap over {len(logits)} steps: {gap:.3g}")
    assert gap > MIN_GAP
    assert eng.pool.outstanding == 0


def test_lazy_serving_equals_merged_serving(monkeypatch):
    _, ts = _stores(1, scale=0.02)
    prompt = _prompt(20, 20)
    runs = []
    for lazy in (True, False):
        rec = []
        monkeypatch.undo()        # record each run around the real route
        monkeypatch.setattr(moe, "route", port_routing_recorder(rec))
        params = M2.params if lazy else tree_map(
            effective_weight, ts.lrpack_tree(M2.params, "t0"))
        eng = Engine(params, CFG, adapters=ts if lazy else None,
                     device="cpu",
                     engine_cfg=EngineConfig(**_ecfg(max_batch=1)))
        eng.submit(Request("r", prompt, 6, tenant="t0" if lazy else None))
        runs.append((eng.run()["r"], rec))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert_same_routing(runs[0][1], runs[1][1], TOP_K)


def test_reference_checkpoint_loads_and_a_snapshot_resumes(tmp_path):
    """A tenant's (B, V) from a checkpoint the JAX package wrote loads
    into the port's store as into the reference's (swapped into tenant
    t1's slot in place); an engine over it
    snapshotted mid-decode restores into a fresh engine that finishes
    with the uninterrupted engine's tokens."""
    js, ts = _stores(2)
    rng = np.random.default_rng(40)
    bs = [0.05 * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
          .astype(np.float32) for b in js.b_full]
    projs = [np.asarray(v, np.float32) for v in js.projs]
    wd = str(tmp_path / "ckpt")
    jckpt.save(wd, 1, {"opt": {"groups": {
        str(g): {"b": bs[g], "proj": projs[g]} for g in range(len(bs))}}},
        extra={"method": "lowrank_adam", "arch": ARCH})
    assert ts.load_tenant("t1", wd) == js.load_tenant("t1", wd) == 1
    for tb, jb in zip(ts.b_full, js.b_full):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    def engine(store):
        return Engine(M2.params, CFG, adapters=store, device="cpu",
                      engine_cfg=EngineConfig(**_ecfg()))

    def reqs():
        return [Request("a", _prompt(8, 51), 8, tenant="t0"),
                Request("b", _prompt(12, 52), 8, tenant="t1"),
                Request("c", _prompt(4, 53), 4, tenant="t0")]
    base = engine(ts)
    for r in reqs():
        base.submit(r)
    want = base.run()
    eng = engine(ts)
    for r in reqs():
        eng.submit(r)
    for _ in range(3):
        eng.step()     # mid-flight: two in flight, one queued
    snap = str(tmp_path / "snap")
    eng.snapshot(snap)
    assert sum(1 for s in eng._slots if s is not None) == 2 and eng._queue
    _, fresh = _stores(2)
    eng2 = Engine.restore(snap, M2.params, CFG, adapters=fresh,
                          device="cpu")
    assert torch.equal(eng2.state.kv_k, eng.state.kv_k)
    assert torch.equal(eng2.state.kv_v, eng.state.kv_v)
    out = eng2.run()
    for rid in ("a", "b", "c"):
        np.testing.assert_array_equal(out[rid], want[rid])


def test_a_tenant_serves_at_four_layers(monkeypatch):
    """At 4 layers (``layers`` stacked 3 deep against ``dense_layers``'
    1) the engine's tokens equal the JAX engine's, a tenant each."""
    m = _m4()
    js, ts = _stores(2, m)
    got, want = [], []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    monkeypatch.setattr(jlm, "moe_ffn", jax_routing_recorder(want))
    reqs = [("x", _prompt(5, 70), 5, "t1"), ("y", _prompt(7, 71), 4, "t0")]
    outs = []
    for eng, R in ((JEngine(m.jparams, m.jcfg, adapters=js,
                            engine_cfg=JEngineConfig(**_ecfg())), JRequest),
                   (Engine(m.params, m.cfg, adapters=ts, device="cpu",
                           engine_cfg=EngineConfig(**_ecfg())), Request)):
        outs.append(_drive(eng, R, reqs, []))
    jax.effects_barrier()
    for rid, _, n, _ in reqs:
        np.testing.assert_array_equal(outs[1][rid], outs[0][rid])
        assert len(outs[1][rid]) == n
    assert_same_routing(got, want, TOP_K)
    assert len(got) % (m.cfg.num_layers - 1) == 0

