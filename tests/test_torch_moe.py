"""The MoE family (qwen3-moe-30b-a3b) in the port against the JAX
package, on the CPU, fp32.

The config is qwen3-moe-30b-a3b ``.reduced()`` (2 layers, d 64, 8
experts, top-2, moe_d_ff 32); ``min_dim_for_lowrank`` 32 so that every
expert leaf carries an adapter (rank 16, as do the attention
projections and the unembedding).  Weights are the reference's (seed
0), carried across by ``convert.params_from_numpy``.

Every comparison first holds the routing equal (``top_idx`` and the
keep masks, call by call, with the smallest gap between the k-th and
(k+1)-th probability logged and asserted above the comparison's error
scale: ``tests/_torch_parity.py``), then the values: 1e-5 · max|y| of
the JAX output (fp32 sums in another order; measured threaded and with
``XLA_FLAGS="--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1"``).

* ``_capacity`` equals the reference's;
* ``moe_ffn`` with plain, ``LRPack``, ``BatchLRPack`` (one ``b`` per
  batch row) and ``BatchLRPack``-with-``rows`` experts (the store's
  stack read by tenant index; the reference given ``b`` gathered per
  batch row, its ``(E, batch, f, r)`` layout), with drops (capacity
  factor 0.1), at the
  config's 1.25 and without drops (16.0): output, ``lb_loss`` and
  ``router_z``; a planted fault (one pair's queue position off by one)
  fails the same check;
* ``forward_hidden`` with its ``aux``, ``prefill`` and
  ``decode_step_paged`` (two tenants at different depths and an
  inactive row) against ``repro.models.lm``, at capacity factors 1.25
  and 0.1; the routing at qwen3-moe's own 128 experts and top-8 (d 256,
  6 layers);
* a decode step reads each tenant's expert ``B`` in place: no
  ``index_select`` or ``index`` of a stack of three or more dims;
* ``BatchLRPack`` slices a layer of an ``(L, E, T, n, r)`` stack; grouped
  dispatch is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.linear import BatchLRPack as JBatchLRPack  # noqa: E402
from repro.models.linear import LRPack as JLRPack  # noqa: E402
from repro.serve import AdapterStore as JStore  # noqa: E402
from repro.serve import batched_pack_tree as jbatched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.linear import BatchLRPack, LRPack  # noqa: E402
from repro_torch.serve import AdapterStore, batched_pack_tree  # noqa: E402

from _torch_parity import (assert_same_routing,  # noqa: E402
                           jax_routing, jax_routing_recorder,
                           port_routing_recorder)

REL = 1e-5
RANK = 16
TCFG = TrainConfig(rank=RANK, min_dim_for_lowrank=32)
JTCFG = JTrainConfig(optimizer="lowrank_adam", rank=RANK,
                     min_dim_for_lowrank=32)
CFG = get_config("qwen3-moe-30b-a3b").reduced()
JCFG = jget_config("qwen3-moe-30b-a3b").reduced()
JPARAMS = jlm.init_params(JCFG, jax.random.key(0))
PARAMS = convert.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                   device="cpu")
# drops, the config's factor, no drops
CFS = (0.1, 1.25, 16.0)


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"max abs err {err:.3g} > {rel} * {scale:.3g}"


def _stores(n_tenants, cfg=CFG, jcfg=JCFG, seed=1, scale=0.05):
    js = JStore(jcfg, JTCFG, max_tenants=n_tenants)
    ts = AdapterStore(cfg, TCFG, max_tenants=n_tenants, device="cpu")
    rng = np.random.default_rng(seed)
    projs = [scale * rng.standard_normal(v.shape).astype(np.float32)
             for v in js.projs]
    for t in range(n_tenants):
        bs = [scale * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
              .astype(np.float32) for b in js.b_full]
        js.add_tenant(f"t{t}", bs, projs)
        ts.add_tenant(f"t{t}", bs, projs)
    return js, ts


# ---------------------------------------------------------------------------
# The dispatch against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,k,experts,cf", [
    (1, 8, 128, 1.25), (4, 8, 128, 1.25), (128, 8, 128, 1.25),
    (24, 2, 8, 0.1), (24, 2, 8, 1.25), (24, 2, 8, 16.0), (64, 1, 2, 0.1),
    (7, 3, 5, 2.5)])
def test_capacity_matches_jax(tokens, k, experts, cf):
    assert moe._capacity(tokens, k, experts, cf) == \
        jmoe._capacity(tokens, k, experts, cf)


# batch 3 x 8 tokens, 8 experts, top-2; per-row adapters: a store of 3
# tenants read at rows [2, 0, 2]
B, S, E, K = 3, 8, 8, 2
D, F = CFG.d_model, CFG.moe_d_ff
ROWS = np.array([2, 0, 2])


def _operands(seed=0):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    ops = dict(x=rnd(B, S, D), router=rnd(D, E, scale=D ** -0.5))
    for name, k, n in (("w_gate", D, F), ("w_up", D, F), ("w_down", F, D)):
        ops[name] = dict(w=rnd(E, k, n, scale=k ** -0.5),
                         v=rnd(E, k, RANK, scale=k ** -0.5),
                         b=rnd(E, 3, n, RANK, scale=0.05))
    return ops


def _weights(ops, form, port):
    """Expert weights of ``form`` for the port (tensors) or the
    reference (jnp arrays)."""
    out = []
    for name in ("w_gate", "w_up", "w_down"):
        w, v, b = ops[name]["w"], ops[name]["v"], ops[name]["b"]
        if port:
            w, v, bt = (torch.as_tensor(a) for a in (w, v, b))
            out.append(w if form == "plain" else
                       LRPack(w, bt[:, 1], v) if form == "lrpack" else
                       BatchLRPack(w, bt[:, ROWS], v) if form == "batch"
                       else BatchLRPack(w, bt, v,
                                        rows=torch.as_tensor(ROWS)))
        else:
            w, v = jnp.asarray(w), jnp.asarray(v)
            out.append(w if form == "plain" else
                       JLRPack(w, jnp.asarray(b[:, 1]), v)
                       if form == "lrpack" else
                       JBatchLRPack(w, jnp.asarray(b[:, ROWS]), v))
    return out


def _check_moe_ffn(form, cf):
    ops = _operands()
    got_routes = []
    real = moe.route
    record = port_routing_recorder(got_routes)
    moe.route = record
    try:
        y, aux = moe.moe_ffn(torch.as_tensor(ops["x"]),
                             torch.as_tensor(ops["router"]),
                             *_weights(ops, form, True), top_k=K,
                             capacity_factor=cf)
    finally:
        moe.route = real
    jy, jaux = jmoe.moe_ffn(jnp.asarray(ops["x"]), jnp.asarray(ops["router"]),
                            *_weights(ops, form, False), top_k=K,
                            capacity_factor=cf)
    C = jmoe._capacity(B * S, K, E, cf)
    want_routes = [jax_routing(jnp.asarray(ops["x"].reshape(B * S, D)),
                               jnp.asarray(ops["router"]), K, C)]
    assert_same_routing(got_routes, want_routes, K)
    keep = got_routes[0][2]
    _close(y, jy)
    _close(aux["lb_loss"], jaux["lb_loss"])
    _close(aux["router_z"], jaux["router_z"])
    return keep


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("form", ["plain", "lrpack", "batch", "batch_rows"])
def test_moe_ffn_matches_jax(form, cf):
    keep = _check_moe_ffn(form, cf)
    # the factors do what they are here for: 0.1 drops pairs, 16 none
    dropped = int((~keep).sum())
    assert (dropped > 0) if cf < 1 else (dropped == 0 if cf > 8 else True)


@pytest.mark.parametrize("form", ["plain", "batch_rows"])
def test_a_pair_placed_one_slot_off_fails_the_check(form, monkeypatch):
    """The planted fault: one kept pair's queue position off by one (its
    keep mask unchanged), so the combine reads a neighbour's slot."""
    real = moe.route

    def off_by_one(xf, router_w, top_k, capacity, norm_topk=True):
        r = real(xf, router_w, top_k, capacity, norm_topk)
        j = int(torch.nonzero(r.keep & (r.pos + 1 < capacity))[0])
        pos = r.pos.clone()
        pos[j] += 1
        return r._replace(pos=pos)
    monkeypatch.setattr(moe, "route", off_by_one)
    with pytest.raises(AssertionError, match="max abs err"):
        _check_moe_ffn(form, 1.25)


def test_grouped_dispatch_is_refused():
    ops = _operands()
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        moe.moe_ffn(torch.as_tensor(ops["x"]), torch.as_tensor(ops["router"]),
                    *_weights(ops, "plain", True), top_k=K, groups=2)


def test_batch_lrpack_slices_a_layer_of_an_expert_stack():
    L, T, n = 2, 3, 5
    w, v = torch.randn(L, E, 4, n), torch.randn(L, E, 4, RANK)
    b = torch.randn(L, E, T, n, RANK)
    rows = torch.tensor([2, 0])
    pack = BatchLRPack(w, b, v, rows=rows)[1]
    assert pack.rows is rows and tuple(pack.b.shape) == (E, T, n, RANK)
    assert pack.b.data_ptr() == b[1].data_ptr()      # a view, no copy
    assert torch.equal(pack.w, w[1]) and torch.equal(pack.v, v[1])


def test_decode_reads_each_tenant_b_in_place():
    """The per-row form's expert products read ``b[:, t]`` views: no
    ``index_select`` or ``index`` takes a tensor of 3 or more dims."""
    from torch.profiler import ProfilerActivity, profile
    ops = _operands()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        moe.moe_ffn(torch.as_tensor(ops["x"]), torch.as_tensor(ops["router"]),
                    *_weights(ops, "batch_rows", True), top_k=K)
    gathers = [e.input_shapes for e in
               prof.key_averages(group_by_input_shape=True)
               if e.key in ("aten::index_select", "aten::index")
               and e.input_shapes and len(e.input_shapes[0]) >= 3]
    assert not gathers
    names = {e.key for e in prof.key_averages()}
    assert "aten::select" in names        # the tenant views b[:, t]


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def _with_cf(cf):
    return CFG.replace(capacity_factor=cf), JCFG.replace(capacity_factor=cf)


def test_layout_and_store_shapes_match_jax():
    from repro.optim import subspace as jsubspace
    from repro_torch.optim.subspace import build_layout
    got = build_layout(lm.param_specs(CFG), TCFG)
    want = jsubspace.build_layout(jlm.abstract_params(JCFG), JTCFG)
    assert [tuple(g) for g in got.groups] == \
        [(g.shape, g.rank, g.leaf_idx) for g in want.groups]
    assert got.dense_idx == want.dense_idx
    # the expert leaves (L, E, k, n) carry rank-16 adapters
    experts = [g for g in got.groups if len(g.shape) == 4]
    assert {g.shape for g in experts} == {(2, E, D, F), (2, E, F, D)}
    assert {g.rank for g in experts} == {RANK}


@pytest.mark.parametrize("cf", (1.25, 0.1))
def test_forward_hidden_with_aux_matches_jax(cf, monkeypatch):
    cfg, jcfg = _with_cf(cf)
    js, ts = _stores(1)
    toks = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(
        np.int32)
    got, want = [], []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    monkeypatch.setattr(jlm, "moe_ffn", jax_routing_recorder(want))
    th, aux = lm.forward_hidden(ts.lrpack_tree(PARAMS, "t0"),
                                torch.as_tensor(toks), cfg)
    jh, jaux = jlm.forward_hidden(js.lrpack_tree(JPARAMS, "t0"),
                                  jnp.asarray(toks), jcfg)
    jax.effects_barrier()
    assert_same_routing(got, want, CFG.top_k)
    assert len(got) == CFG.num_layers
    dropped = sum(int((~k).sum()) for _, _, k in got)
    print(f"capacity factor {cf}: {dropped} of {2 * 24 * CFG.top_k} pairs "
          f"a layer dropped, summed over the layers")
    assert dropped > 0 or cf > 1
    _close(th, jh)
    for name in ("lb_loss", "router_z"):
        assert float(aux[name]) > 0
        _close(aux[name], jaux[name])


@pytest.mark.parametrize("cf", (1.25, 0.1))
def test_prefill_and_paged_decode_match_jax(cf, monkeypatch):
    """Prefill of each tenant's prompt, then three teacher-forced paged
    decode steps of a batch of three: two tenants at different depths and
    an inactive row, which routes and takes capacity as the others do."""
    cfg, jcfg = _with_cf(cf)
    js, ts = _stores(2, seed=2)
    got, want = [], []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    monkeypatch.setattr(jlm, "moe_ffn", jax_routing_recorder(want))
    toks = np.random.default_rng(4).integers(0, 512, (1, 20)).astype(
        np.int32)
    for tenant in ("t0", "t1"):
        jst = jlm.alloc_decode_state(jcfg, 1, 24)
        jlg, jst = jlm.prefill(js.lrpack_tree(JPARAMS, tenant),
                               jnp.asarray(toks), jcfg, jst)
        tst = lm.alloc_decode_state(cfg, 1, 24, device="cpu")
        tlg, tst = lm.prefill(ts.lrpack_tree(PARAMS, tenant),
                              torch.as_tensor(toks), cfg, tst)
        jax.effects_barrier()
        _close(tlg, jlg)
        _close(tst.kv.k, jst.kv.k)
        _close(tst.kv.v, jst.kv.v)
        assert tst.pos == int(jst.pos) == 20
    page, n_pages, nb = 4, 10, 3
    jst = jlm.alloc_paged_state(jcfg, nb, n_pages, page, 16)
    tst = lm.alloc_paged_state(cfg, nb, n_pages, page, 16, device="cpu")
    assert tst.ssm is None and tst.kv_k.shape == jst.kv_k.shape
    rng = np.random.default_rng(6)
    kk, vv = (rng.standard_normal(a.shape).astype(np.float32)
              for a in (jst.kv_k, jst.kv_v))
    pt = np.full((nb, 4), -1, np.int32)
    pt[0, :2] = [0, 1]
    pt[1, :3] = [5, 2, 7]
    lens = np.array([3, 9, 0], np.int32)
    jst = jst._replace(kv_k=jnp.asarray(kk), kv_v=jnp.asarray(vv),
                       page_table=jnp.asarray(pt), lengths=jnp.asarray(lens))
    tst = tst._replace(kv_k=torch.tensor(kk), kv_v=torch.tensor(vv),
                       page_table=torch.tensor(pt), lengths=torch.tensor(lens))
    tenants = np.array([1, 0, 0])
    tok = np.array([[5], [9], [0]], np.int32)
    for _ in range(3):
        jlg, jst = jlm.decode_step_paged(
            jbatched(JPARAMS, js.layout, js.b_full, js.projs,
                     jnp.asarray(tenants)), jnp.asarray(tok), jcfg, jst)
        tlg, tst = lm.decode_step_paged(
            batched_pack_tree(PARAMS, ts.layout, ts.b_full, ts.projs,
                              torch.tensor(tenants)),
            torch.tensor(tok), cfg, tst)
        jax.effects_barrier()
        _close(tlg[:2], jlg[:2])                  # row 2 is inactive
        np.testing.assert_array_equal(tst.lengths.numpy(),
                                      np.asarray(jst.lengths))
        tok = np.asarray(jnp.argmax(jlg[:, -1], -1))[:, None]
        tok = tok.astype(np.int32)
    assert_same_routing(got, want, CFG.top_k)
    # 2 prefills and 3 decode steps, a call per layer each
    assert len(got) == 5 * CFG.num_layers
    _close(tst.kv_k, jst.kv_k)
    _close(tst.kv_v, jst.kv_v)


def test_routing_at_qwen3_expert_count_matches_jax(monkeypatch):
    """qwen3-moe's 128 experts and top-8 (the reduced config has 8 and
    top-2) at d 256 and 6 layers: the routing of every layer and the
    hidden state equal the reference's.  Prints the pairs each layer
    drops: at the random init both packages concentrate the routing
    more with every layer."""
    kw = dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
              moe_d_ff=96, num_experts=128, top_k=8, num_layers=6)
    cfg, jcfg = CFG.replace(**kw), JCFG.replace(**kw)
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    toks = np.random.default_rng(0).integers(0, 512, (1, 128)).astype(
        np.int32)
    got, want = [], []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    monkeypatch.setattr(jlm, "moe_ffn", jax_routing_recorder(want))
    th, _ = lm.forward_hidden(params, torch.as_tensor(toks), cfg)
    jh, _ = jlm.forward_hidden(jparams, jnp.asarray(toks), jcfg)
    jax.effects_barrier()
    assert_same_routing(got, want, 8)
    _close(th, jh)
    dropped = [int((~k).sum()) for _, _, k in got]
    print(f"pairs dropped by layer, of {128 * 8}: {dropped}")
    assert len(dropped) == 6 and dropped[-1] > dropped[0]


def test_prefill_then_decode_equals_the_forward_without_drops():
    """With capacity for every pair (factor 16), routing is per token, so
    prefill then paged decode gives the teacher-forced forward's logits."""
    cfg = CFG.replace(capacity_factor=16.0)
    seq = np.random.default_rng(8).integers(0, 512, (24,)).astype(np.int32)
    S, page, steps = 16, 4, 8
    st = lm.alloc_decode_state(cfg, 1, 28, device="cpu")
    lg, st = lm.prefill(PARAMS, torch.as_tensor(seq[None, :S]), cfg, st)
    ps = lm.alloc_paged_state(cfg, 1, 7, page, 28, device="cpu")
    ps.kv_k.copy_(st.kv.k[:, 0].reshape(ps.kv_k.shape))
    ps.kv_v.copy_(st.kv.v[:, 0].reshape(ps.kv_v.shape))
    ps = ps._replace(page_table=torch.arange(7, dtype=torch.int32)[None],
                     lengths=torch.tensor([S], dtype=torch.int32))
    got = [lg[0, -1]]
    for t in range(S, S + steps - 1):
        lg, ps = lm.decode_step_paged(PARAMS, torch.as_tensor(seq[t:t + 1])
                                      [None], cfg, ps)
        got.append(lg[0, -1])
    h, _ = lm.forward_hidden(PARAMS, torch.as_tensor(seq[None]), cfg)
    want = lm.logits(PARAMS, h, cfg)[0, S - 1:S + steps - 1]
    vs = cfg.vocab_size
    _close(torch.stack(got)[:, :vs], want[:, :vs], rel=1e-4)
