"""The hybrid family (zamba2-7b: Mamba2 layers with one shared attention
+ MLP block after every ``attn_every``-th of them) in the port against
the JAX package, on the CPU, fp32.

Two configs: zamba2-7b ``.reduced()`` (4 layers, ``attn_every`` 2: two
groups and no tail) and the same at 5 layers (a tail layer after the
second application).  Weights are the reference's (seed 0), carried
across by ``convert.params_from_numpy``; adapters are numpy arrays
installed in both packages' stores.

* The parameter tree (with the shared block's unstacked ``shared_attn``
  subtree) converts one to one, and the low-rank layout equals the
  reference's, at both configs and at full size.
* ``forward_hidden``, ``prefill`` (logits, every layer's SSM state and
  conv window, each application's K/V) and ``decode_step_paged`` (two
  slots at different depths on different tenants and an inactive one,
  over random recurrent state and shared arenas) against the
  reference's: rtol 1e-4, atol 1e-5, fp32 sums in another order
  (measured at most 6e-6 of max|logit|, threaded and with XLA's
  single-thread flags).
* Prefill then paged decode equals the teacher-forced forward.
* The port's ``Engine`` gives the JAX engine's tokens: two tenants,
  staggered joins, every step's top-2 logit gap above 1e-4; lazy
  serving equals merged serving; a snapshot in mid-decode restores
  into a fresh engine that finishes with the uninterrupted tokens.
* A preempted hybrid sequence re-enters (the longest chunk-multiple
  prefix prefilled, the rest teacher-forced through one-row decode
  steps) and finishes with the tokens of its unpreempted run; the JAX
  engine fails the same case (a deliberate departure).

The hybrid's card tests, which import no JAX, are in
``tests/test_torch_hybrid_kernels.py``.
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
from repro.optim import subspace as jsubspace  # noqa: E402
from repro.serve import AdapterStore as JStore  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import batched_pack_tree as jbatched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import (tree_flatten_with_path,  # noqa: E402
                                       tree_map)
from repro_torch.models.linear import effective_weight  # noqa: E402
from repro_torch.optim.subspace import build_layout  # noqa: E402
from repro_torch.serve import (AdapterStore, Engine,  # noqa: E402
                               EngineConfig, Request, batched_pack_tree)

RTOL, ATOL = 1e-4, 1e-5
MIN_GAP = 1e-4
TCFG = TrainConfig(rank=4, min_dim_for_lowrank=32)
JTCFG = JTrainConfig(optimizer="lowrank_adam", rank=4,
                     min_dim_for_lowrank=32)
LAYERS = {"reduced": 4, "tail": 5}


def _model(kind, seed=0):
    L = LAYERS[kind]
    jcfg = jget_config("zamba2-7b").reduced().replace(num_layers=L)
    jparams = jlm.init_params(jcfg, jax.random.key(seed))
    return SimpleNamespace(
        cfg=get_config("zamba2-7b").reduced().replace(num_layers=L),
        jcfg=jcfg, jparams=jparams,
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu"))


MODELS = {kind: _model(kind) for kind in LAYERS}


def _stores(m, n_tenants, seed=1, scale=0.05):
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


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, (n,)).astype(
        np.int32)


def _min_top2_gap(params, prompt, out, cfg):
    """Smallest top-2 logit gap over the greedy steps that produced
    ``out`` (teacher-forced full forwards of the port's model, each
    sequence padded to whole SSD chunks: the forward is causal, so the
    padding does not reach the last real position)."""
    gaps = []
    q = cfg.ssd_chunk
    for t in range(len(out)):
        seq = np.concatenate([prompt, out[:t]]).astype(np.int32)
        n = len(seq)
        padded = np.zeros((n if n <= q else -(-n // q) * q,), np.int32)
        padded[:n] = seq
        h, _ = lm.forward_hidden(params, torch.as_tensor(padded[None]), cfg)
        top = torch.topk(
            lm.logits(params, h[:, n - 1], cfg)[0, :cfg.vocab_size], 2).values
        gaps.append((top[0] - top[1]).item())
    return min(gaps)


# ---------------------------------------------------------------------------
# Parameters and the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [*LAYERS, "full"])
def test_layout_groups_match_jax(kind):
    if kind == "full":
        cfg, jcfg = get_config("zamba2-7b"), jget_config("zamba2-7b")
        tcfg, jtcfg = TrainConfig(), JTrainConfig()
    else:
        cfg, jcfg, tcfg, jtcfg = MODELS[kind].cfg, MODELS[kind].jcfg, \
            TCFG, JTCFG
    got = build_layout(lm.param_specs(cfg), tcfg)
    want = jsubspace.build_layout(jlm.abstract_params(jcfg), jtcfg)
    assert [tuple(g) for g in got.groups] == \
        [(g.shape, g.rank, g.leaf_idx) for g in want.groups]
    assert got.dense_idx == want.dense_idx
    assert got.n_leaves == want.n_leaves
    if kind == "full":
        # in_proj, out_proj, the unembedding and the shared block's seven
        # projections, all at r = 128
        assert {g.rank for g in got.groups} == {128}
        assert sum(len(g.leaf_idx) for g in got.groups) == 10


@pytest.mark.parametrize("kind", LAYERS)
def test_param_tree_with_the_shared_block_converts_one_to_one(kind):
    m = MODELS[kind]
    jflat = jax.tree_util.tree_flatten_with_path(m.jparams)[0]
    tflat = tree_flatten_with_path(m.params)
    assert [jsubspace._path_str(p) for p, _ in jflat] == \
        ["/" + "/".join(p) for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(t.shape)
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    specs = tree_flatten_with_path(lm.param_specs(m.cfg))
    assert [tuple(s.shape) for _, s in specs] == \
        [tuple(t.shape) for _, t in tflat]
    shared = m.params["shared_attn"]
    assert sorted(shared) == ["attn", "ln1", "ln2", "mlp"]
    d = m.cfg.d_model
    assert tuple(shared["attn"]["wq"].shape) == (d, d)   # unstacked


@pytest.mark.parametrize("kind", LAYERS)
def test_forward_hidden_matches_jax(kind):
    m = MODELS[kind]
    toks = np.random.default_rng(3).integers(0, 512, (2, 64)).astype(
        np.int32)
    jh, _ = jlm.forward_hidden(m.jparams, jnp.asarray(toks), m.jcfg)
    th, aux = lm.forward_hidden(m.params, torch.as_tensor(toks), m.cfg)
    _close(th, jh)
    assert not aux["lb_loss"] and not aux["router_z"]
    # the shared block runs: dropping it changes the hidden state
    no_shared = m.cfg.replace(attn_every=0)
    other, _ = lm.forward_hidden(m.params, torch.as_tensor(toks), no_shared)
    assert (other - th).abs().max() > 1e-3


@pytest.mark.parametrize("kind", LAYERS)
def test_prefill_matches_jax_with_lrpack(kind):
    m = MODELS[kind]
    js, ts = _stores(m, 2)
    toks = _prompt(32, 4)[None]
    for tenant in ("t0", "t1"):
        jst = jlm.alloc_decode_state(m.jcfg, 1, 40)
        jlg, jst = jlm.prefill(js.lrpack_tree(m.jparams, tenant),
                               jnp.asarray(toks), m.jcfg, jst)
        tst = lm.alloc_decode_state(m.cfg, 1, 40, device="cpu")
        tlg, tst = lm.prefill(ts.lrpack_tree(m.params, tenant),
                              torch.as_tensor(toks), m.cfg, tst)
        _close(tlg, jlg)
        _close(tst.ssm.ssm, jst.ssm.ssm)
        _close(tst.ssm.conv, jst.ssm.conv)
        assert tst.shared_kv.k.shape[0] == 2      # one cache per app
        _close(tst.shared_kv.k, jst.shared_kv.k)
        _close(tst.shared_kv.v, jst.shared_kv.v)
        assert tst.kv is None and tst.pos == int(jst.pos) == 32


@pytest.mark.parametrize("kind", LAYERS)
def test_paged_decode_matches_jax_with_batch_lrpack(kind):
    """Teacher-forced paged decode: two slots on different tenants at
    different depths plus one inactive slot, over random recurrent state
    and random shared-attention arenas."""
    m = MODELS[kind]
    js, ts = _stores(m, 2, seed=2)
    page, n_pages, B = 4, 10, 3
    jst = jlm.alloc_paged_state(m.jcfg, B, n_pages, page, 16)
    tst = lm.alloc_paged_state(m.cfg, B, n_pages, page, 16, device="cpu")
    assert tst.kv_k is None and tst.shared_k.shape == jst.shared_k.shape
    rng = np.random.default_rng(6)
    ss, cv, sk, sv = (rng.standard_normal(a.shape).astype(np.float32)
                      for a in (jst.ssm.ssm, jst.ssm.conv, jst.shared_k,
                                jst.shared_v))
    pt = np.full((B, 4), -1, np.int32)
    pt[0, :2] = [0, 1]
    pt[1, :3] = [5, 2, 7]
    lens = np.array([3, 9, 0], np.int32)
    jst = jst._replace(
        ssm=type(jst.ssm)(jnp.asarray(ss), jnp.asarray(cv)),
        shared_k=jnp.asarray(sk), shared_v=jnp.asarray(sv),
        page_table=jnp.asarray(pt), lengths=jnp.asarray(lens))
    tst = tst._replace(
        ssm=type(tst.ssm)(torch.tensor(ss), torch.tensor(cv)),
        shared_k=torch.tensor(sk), shared_v=torch.tensor(sv),
        page_table=torch.tensor(pt), lengths=torch.tensor(lens))
    tenants = np.array([1, 0, 0])
    tok = np.array([[5], [9], [0]], np.int32)
    for _ in range(3):
        jlg, jst = jlm.decode_step_paged(
            jbatched(m.jparams, js.layout, js.b_full, js.projs,
                     jnp.asarray(tenants)), jnp.asarray(tok), m.jcfg, jst)
        before = tst.ssm
        tlg, tst = lm.decode_step_paged(
            batched_pack_tree(m.params, ts.layout, ts.b_full, ts.projs,
                              torch.tensor(tenants)),
            torch.tensor(tok), m.cfg, tst)
        assert tst.ssm.ssm is not before.ssm     # new tensors, old kept
        _close(tlg[:2], jlg[:2])                  # row 2 is inactive
        np.testing.assert_array_equal(tst.lengths.numpy(),
                                      np.asarray(jst.lengths))
        tok = np.asarray(jnp.argmax(jlg[:, -1], -1))[:, None]
        tok = tok.astype(np.int32)
    _close(tst.ssm.ssm, jst.ssm.ssm)
    _close(tst.ssm.conv, jst.ssm.conv)
    _close(tst.shared_k, jst.shared_k)
    _close(tst.shared_v, jst.shared_v)


@pytest.mark.parametrize("kind", LAYERS)
def test_prefill_then_decode_equals_the_teacher_forced_forward(kind):
    m = MODELS[kind]
    cfg, params = m.cfg, m.params
    # 32 tokens prefilled, 8 decoded; the forward (causal) runs over 64,
    # two whole chunks
    seq = _prompt(64, 8)
    S, page, steps = 32, 4, 8
    st = lm.alloc_decode_state(cfg, 1, 40, device="cpu")
    lg, st = lm.prefill(params, torch.as_tensor(seq[None, :S]), cfg, st)
    ps = lm.alloc_paged_state(cfg, 1, 10, page, 40, device="cpu")
    ps.shared_k.copy_(st.shared_kv.k[:, 0].reshape(ps.shared_k.shape))
    ps.shared_v.copy_(st.shared_kv.v[:, 0].reshape(ps.shared_v.shape))
    for arena, cache in zip(ps.ssm, st.ssm):
        arena.copy_(cache)
    ps = ps._replace(page_table=torch.arange(10, dtype=torch.int32)[None],
                     lengths=torch.tensor([S], dtype=torch.int32))
    got = [lg[0, -1]]
    for t in range(S, S + steps):
        lg, ps = lm.decode_step_paged(params, torch.as_tensor(seq[t:t + 1])
                                      [None], cfg, ps)
        got.append(lg[0, -1])
    h, _ = lm.forward_hidden(params, torch.as_tensor(seq[None]), cfg)
    want = lm.logits(params, h, cfg)[0, S - 1:S + steps]
    got = torch.stack(got)
    vs = cfg.vocab_size
    err = (got[:, :vs] - want[:, :vs]).abs().max().item()
    assert err <= RTOL * want[:, :vs].abs().max().item()


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

def _ecfg(**over):
    base = dict(page_size=4, max_batch=2, max_len=48, max_out=8)
    base.update(over)
    return base


@pytest.mark.parametrize("kind", LAYERS)
def test_engine_two_tenants_staggered_match_jax(kind):
    m = MODELS[kind]
    js, ts = _stores(m, 2)
    reqs = [("r0", _prompt(3, 5), 6, "t0"), ("r1", _prompt(6, 6), 3, "t1")]
    more = [("r2", _prompt(4, 7), 5, "t1")]
    outs = []
    for eng, R in ((JEngine(m.jparams, m.jcfg, adapters=js,
                            engine_cfg=JEngineConfig(**_ecfg())), JRequest),
                   (Engine(m.params, m.cfg, adapters=ts,
                           engine_cfg=EngineConfig(**_ecfg()),
                           device="cpu"), Request)):
        for rid, p, n, ten in reqs:
            eng.submit(R(rid, p, n, tenant=ten))
        for _ in range(3):
            assert eng.step()
        for rid, p, n, ten in more:
            eng.submit(R(rid, p, n, tenant=ten))
        outs.append(eng.run())
    jout, tout = outs
    assert sorted(tout) == ["r0", "r1", "r2"]
    for rid, prompt, n, tenant in reqs + more:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n and eng.reasons[rid] == "completed"
        assert _min_top2_gap(ts.lrpack_tree(m.params, tenant), prompt,
                             tout[rid], m.cfg) > MIN_GAP
    assert eng.pool.outstanding == 0


def test_lazy_serving_equals_merged_serving():
    m = MODELS["tail"]
    _, ts = _stores(m, 1, scale=0.02)
    prompt = _prompt(32, 20)
    lazy = Engine(m.params, m.cfg, adapters=ts, device="cpu",
                  engine_cfg=EngineConfig(**_ecfg(max_batch=1)))
    lazy.submit(Request("r", prompt, 6, tenant="t0"))
    merged_params = tree_map(effective_weight, ts.lrpack_tree(m.params, "t0"))
    merged = Engine(merged_params, m.cfg, device="cpu",
                    engine_cfg=EngineConfig(**_ecfg(max_batch=1)))
    merged.submit(Request("r", prompt, 6))
    np.testing.assert_array_equal(lazy.run()["r"], merged.run()["r"])


def test_snapshot_restore_mid_decode_gives_the_uninterrupted_tokens(
        tmp_path):
    m = MODELS["tail"]

    def engine():
        return Engine(m.params, m.cfg, adapters=_stores(m, 2)[1],
                      engine_cfg=EngineConfig(**_ecfg()), device="cpu")

    def reqs():
        return [Request("a", _prompt(8, 51), 8, tenant="t0"),
                Request("b", _prompt(32, 52), 8, tenant="t1"),
                Request("c", _prompt(4, 53), 4, tenant="t0")]
    base = engine()
    for r in reqs():
        base.submit(r)
    base = base.run()
    eng = engine()
    for r in reqs():
        eng.submit(r)
    for _ in range(3):
        eng.step()     # mid-flight: two in flight, one queued
    snap = str(tmp_path / "snap")
    assert eng.snapshot(snap) == eng.step_count
    assert sum(1 for s in eng._slots if s is not None) == 2 and eng._queue
    _, store = _stores(m, 2)
    eng2 = Engine.restore(snap, m.params, m.cfg, adapters=store,
                          device="cpu")
    for a, b in zip((*eng2.state.ssm, eng2.state.shared_k,
                     eng2.state.shared_v),
                    (*eng.state.ssm, eng.state.shared_k, eng.state.shared_v)):
        assert torch.equal(a, b)
    out = eng2.run()
    assert set(out) == set(base)
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])
    assert eng2.pool.outstanding == 0


# a pool of 14 pages of 4: "old" (8 tokens) and "young" (32) hold 2 + 8
# pages at admission and grow a page every 4 steps; at step 9 "old"
# needs its fifth page, the pool is dry and "young", 9 tokens in, is
# preempted; it re-enters with 41 tokens (32 prefilled, 9 teacher-forced)
# once "old" has finished
PREEMPT_ECFG = _ecfg(num_pages=14, max_out=16)
PREEMPT_REQS = (("old", 8, 12), ("young", 32, 16))


@pytest.mark.parametrize("kind", LAYERS)
def test_preempted_hybrid_sequence_reenters_with_its_unpreempted_tokens(
        kind, monkeypatch):
    m = MODELS[kind]
    _, ts = _stores(m, 2)
    eng = Engine(m.params, m.cfg, adapters=ts, device="cpu",
                 engine_cfg=EngineConfig(**PREEMPT_ECFG))
    seen = []
    preempt, teacher = eng._preempt, eng._teacher_force

    def record_preempt(slot):
        seen.append(("preempt", eng._slots[slot]["rid"],
                     eng._slots[slot]["generated"]))
        preempt(slot)

    def record_teacher(req, pages, slot, head):
        seen.append(("tail", req.rid, head, len(req.prompt) - head))
        return teacher(req, pages, slot, head)
    monkeypatch.setattr(eng, "_preempt", record_preempt)
    monkeypatch.setattr(eng, "_teacher_force", record_teacher)
    for i, (rid, n, new) in enumerate(PREEMPT_REQS):
        eng.submit(Request(rid, _prompt(n, 60 + i), new, tenant=f"t{i}"))
    out = eng.run()
    assert seen == [("preempt", "young", 9), ("tail", "young", 32, 9)]
    assert all(eng.reasons[rid] == "completed" for rid, _, _ in PREEMPT_REQS)
    for i, (rid, n, new) in enumerate(PREEMPT_REQS):
        solo = Engine(m.params, m.cfg, adapters=ts, device="cpu",
                      engine_cfg=EngineConfig(**_ecfg(max_out=16)))
        solo.submit(Request(rid, _prompt(n, 60 + i), new, tenant=f"t{i}"))
        want = solo.run()[rid]
        np.testing.assert_array_equal(out[rid], want)
        assert len(want) == new
        assert _min_top2_gap(ts.lrpack_tree(m.params, f"t{i}"),
                             _prompt(n, 60 + i), want, m.cfg) > MIN_GAP
    assert eng.pool.outstanding == 0


def test_the_reference_engine_fails_a_preempted_hybrid_sequence():
    """The deliberate departure: the JAX engine re-prefills the 41-token
    readmission prompt, off the SSD chunk of 32, and fails."""
    m = MODELS["reduced"]
    jeng = JEngine(m.jparams, m.jcfg, engine_cfg=JEngineConfig(
        **PREEMPT_ECFG))
    for i, (rid, n, new) in enumerate(PREEMPT_REQS):
        jeng.submit(JRequest(rid, _prompt(n, 60 + i), new))
    with pytest.raises(AssertionError):
        jeng.run()


def test_off_chunk_prompt_is_refused_at_submit():
    m = MODELS["reduced"]
    eng = Engine(m.params, m.cfg, engine_cfg=EngineConfig(**_ecfg()),
                 device="cpu")
    with pytest.raises(ValueError, match="SSD chunk"):
        eng.submit(Request("bad", _prompt(40, 1), 4))
    assert not eng._queue and eng.pool.outstanding == 0
