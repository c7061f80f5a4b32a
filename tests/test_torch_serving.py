"""The port's serving engine against the JAX package's, on llama-tiny
and mamba2-780m (reduced, fp32): the dense family's paged KV cache and
the SSM family's per-slot recurrent state.

Engine parity asserts equal generated tokens — not bit-identical logits.
Greedy tokens agree between the packages when no step's top-2 logit gap
falls inside fp32 summation-order noise: the prompts and seeds below were
chosen so that every generated step has a gap above 1e-4, and each test
re-checks that with :func:`_min_top2_gap` so a changed model cannot turn
a near tie into a spurious failure.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import AdapterStore as JStore  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.linear import effective_weight  # noqa: E402
from repro_torch.serve import (AdapterMismatchError, AdapterStore,  # noqa
                               Engine, EngineBusy, EngineConfig, PagePool,
                               Request, TenantQuarantinedError)

TCFG = TrainConfig(rank=4, min_dim_for_lowrank=32)
JTCFG = JTrainConfig(optimizer="lowrank_adam", rank=4,
                     min_dim_for_lowrank=32)
MIN_GAP = 1e-4


def _model(arch):
    """A reduced config of both packages and the reference's weights
    (seed 0) carried across."""
    jcfg = jget_config(arch).reduced()
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    return SimpleNamespace(
        cfg=get_config(arch).reduced(), jcfg=jcfg, jparams=jparams,
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu"))


LLAMA, MAMBA = _model("llama-tiny"), _model("mamba2-780m")
CFG, JCFG, JPARAMS, PARAMS = LLAMA.cfg, LLAMA.jcfg, LLAMA.jparams, \
    LLAMA.params


def _stores(n_tenants, seed=1, scale=0.05, m=LLAMA):
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


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (n,)).astype(np.int32)


def _ecfg(**over):
    base = dict(page_size=4, max_batch=2, max_len=24, max_out=8)
    base.update(over)
    return base


def _min_top2_gap(params, prompt, out, cfg=CFG):
    """Smallest top-2 logit gap over the greedy steps that produced
    ``out`` (teacher-forced full forwards of the port's model)."""
    gaps = []
    for t in range(len(out)):
        seq = np.concatenate([prompt, out[:t]]).astype(np.int32)
        st = lm.alloc_decode_state(cfg, 1, len(seq), device="cpu")
        lg, _ = lm.prefill(params, torch.as_tensor(seq[None]), cfg, st)
        top = torch.topk(lg[0, -1, :cfg.vocab_size], 2).values
        gaps.append((top[0] - top[1]).item())
    return min(gaps)


def _both(ecfg, reqs, stores=None, mid=None, m=LLAMA):
    """Run the same workload through both engines.  ``reqs``: (rid,
    prompt, max_new, tenant); ``mid``: (after_steps, more reqs)."""
    js, ts = stores if stores is not None else (None, None)
    jeng = JEngine(m.jparams, m.jcfg, adapters=js,
                   engine_cfg=JEngineConfig(**ecfg))
    teng = Engine(m.params, m.cfg, adapters=ts,
                  engine_cfg=EngineConfig(**ecfg), device="cpu")
    outs = []
    for eng, R in ((jeng, JRequest), (teng, Request)):
        for rid, p, n, ten in reqs:
            eng.submit(R(rid, p, n, tenant=ten))
        if mid is not None:
            steps, more = mid
            for _ in range(steps):
                assert eng.step()
            for rid, p, n, ten in more:
                eng.submit(R(rid, p, n, tenant=ten))
        outs.append(eng.run())
    return outs, teng


# ---------------------------------------------------------------------------
# Engine token parity with the JAX engine
# ---------------------------------------------------------------------------

def _two_tenants_staggered(m):
    js, ts = _stores(2, m=m)
    reqs = [("r0", _prompt(3, 5), 6, "t0"), ("r1", _prompt(6, 6), 3, "t1")]
    more = [("r2", _prompt(4, 7), 5, "t1")]
    (jout, tout), teng = _both(_ecfg(), reqs, (js, ts), mid=(3, more), m=m)
    assert sorted(tout) == ["r0", "r1", "r2"]
    for rid, prompt, n, tenant in reqs + more:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n and teng.reasons[rid] == "completed"
        assert _min_top2_gap(ts.lrpack_tree(m.params, tenant), prompt,
                             tout[rid], m.cfg) > MIN_GAP
    # distinct adapters really change the generation
    solo = Engine(m.params, m.cfg, adapters=ts,
                  engine_cfg=EngineConfig(**_ecfg()), device="cpu")
    solo.submit(Request("x", _prompt(4, 7), 5, tenant="t0"))
    assert not np.array_equal(solo.run()["x"], tout["r2"])
    assert teng.pool.outstanding == 0


def test_two_tenants_staggered_joins_and_evictions_match_jax():
    _two_tenants_staggered(LLAMA)


def test_mamba2_two_tenants_staggered_joins_and_evictions_match_jax():
    _two_tenants_staggered(MAMBA)


def test_backpressure_queues_then_serves_all_like_jax():
    # the pool holds one sequence's chain: b waits for a's eviction
    reqs = [("a", _prompt(8, 10), 4, None), ("b", _prompt(8, 11), 4, None)]
    (jout, tout), teng = _both(
        _ecfg(num_pages=3, max_len=12, max_out=4), reqs)
    for rid, prompt, n, _ in reqs:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n
        assert _min_top2_gap(PARAMS, prompt, tout[rid]) > MIN_GAP
    assert teng.pool.outstanding == 0


def test_preemption_recomputes_and_matches_jax():
    # both fit at admission; page-chain growth exhausts the pool
    # mid-stream and the youngest sequence is preempted and re-admitted
    reqs = [("a", _prompt(4, 12), 6, None), ("b", _prompt(4, 13), 6, None)]
    (jout, tout), teng = _both(
        _ecfg(page_size=2, num_pages=6, max_len=12, max_out=6), reqs)
    for rid, prompt, n, _ in reqs:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n
        assert _min_top2_gap(PARAMS, prompt, tout[rid]) > MIN_GAP
    assert teng.pool.outstanding == 0


# ---------------------------------------------------------------------------
# Port-only engine behaviour
# ---------------------------------------------------------------------------

def _engine(adapters=None, m=LLAMA, **over):
    return Engine(m.params, m.cfg, adapters=adapters,
                  engine_cfg=EngineConfig(**_ecfg(**over)), device="cpu")


def _lazy_equals_merged(m):
    _, ts = _stores(1, scale=0.02, m=m)
    prompt = _prompt(5, 20)
    lazy = _engine(ts, m, max_batch=1)
    lazy.submit(Request("r", prompt, 6, tenant="t0"))
    merged_params = tree_map(effective_weight, ts.lrpack_tree(m.params, "t0"))
    merged = Engine(merged_params, m.cfg,
                    engine_cfg=EngineConfig(**_ecfg(max_batch=1)),
                    device="cpu")
    merged.submit(Request("r", prompt, 6))
    np.testing.assert_array_equal(lazy.run()["r"], merged.run()["r"])


def test_lazy_adapter_serving_equals_merged_weights():
    _lazy_equals_merged(LLAMA)


def test_mamba2_lazy_adapter_serving_equals_merged_weights():
    _lazy_equals_merged(MAMBA)


def _quarantine(m):
    _, ts = _stores(2, m=m)
    bad = [np.full(b.shape[:-3] + b.shape[-2:], np.nan, np.float32)
           for b in ts.b_full]
    ts.add_tenant("t1", bad)                   # hot-swap t1 to a NaN adapter
    prompt = _prompt(4, 21)
    eng = _engine(ts, m, max_strikes=1)
    eng.submit(Request("good", prompt, 5, tenant="t0"))
    eng.submit(Request("bad", prompt, 5, tenant="t1"))
    out = eng.run()
    assert isinstance(eng.errors["bad"], TenantQuarantinedError)
    assert eng.reasons["bad"] == "quarantined" and "bad" not in out
    assert eng.strikes("t1") == 1 and eng.disabled_tenants() == ("t1",)
    solo = _engine(ts, m, max_batch=1)
    solo.submit(Request("good", prompt, 5, tenant="t0"))
    np.testing.assert_array_equal(out["good"], solo.run()["good"])
    with pytest.raises(TenantQuarantinedError):
        eng.submit(Request("again", prompt, 2, tenant="t1"))
    assert eng.pool.outstanding == 0


def test_faulted_tenant_is_quarantined_and_co_tenant_unaffected():
    _quarantine(LLAMA)


def test_mamba2_faulted_tenant_is_quarantined_and_co_tenant_unaffected():
    _quarantine(MAMBA)


def test_mamba2_faulted_row_keeps_its_recurrent_state(monkeypatch):
    """The masked write-back: a row the guard faults keeps its SSM state
    and conv window from before the step; the other row advances."""
    import repro_torch.serve.engine as engine_mod
    _, ts = _stores(2, m=MAMBA)
    eng = _engine(ts, MAMBA)
    eng.submit(Request("a", _prompt(4, 30), 4, tenant="t0"))
    eng.submit(Request("b", _prompt(5, 31), 4, tenant="t1"))
    assert eng.step()                         # both admitted and stepped
    state = eng.state._replace(page_table=torch.as_tensor(eng._pt),
                               lengths=torch.as_tensor(eng._len))
    before = [t.clone() for t in state.ssm]
    monkeypatch.setattr(engine_mod, "logits_row_ok",
                        lambda rows: torch.tensor([True, False]))
    nstate, *_, fault = eng._decode(state)
    assert fault.tolist() == [False, True]
    for new, old in zip(nstate.ssm, before):
        assert torch.equal(new[:, 1], old[:, 1])
        assert not torch.equal(new[:, 0], old[:, 0])
    # only row 0 advances
    assert nstate.lengths.tolist() == [eng._len[0] + 1, eng._len[1]]


def test_admission_queue_bound_and_deadlines():
    eng = _engine(max_batch=1, max_queue=1)
    eng.submit(Request("a", _prompt(3, 22), 8, ttl=3))
    with pytest.raises(EngineBusy):
        eng.submit(Request("b", _prompt(3, 23), 2))
    out = eng.run()
    assert eng.reasons["a"] == "deadline" and 1 <= len(out["a"]) < 8


def test_impossible_request_raises_instead_of_deadlocking():
    eng = _engine(page_size=4, max_batch=1, num_pages=1, max_len=16,
                  max_out=4)
    eng.submit(Request("a", _prompt(8, 14), 2))
    with pytest.raises(RuntimeError, match="num_pages"):
        eng.run()
    assert eng.pool.outstanding == 0


def test_submit_validation():
    _, ts = _stores(1)
    eng = _engine(ts)
    with pytest.raises(ValueError, match="max_out"):
        eng.submit(Request("a", _prompt(3, 1), 99, tenant="t0"))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request("a", _prompt(23, 1), 8, tenant="t0"))
    with pytest.raises(ValueError, match="tenant"):
        eng.submit(Request("a", _prompt(3, 1), 2))
    with pytest.raises(KeyError):
        eng.submit(Request("a", _prompt(3, 1), 2, tenant="nope"))
    with pytest.raises(ValueError, match="max_new"):
        Request("a", _prompt(3, 1), 0)


def test_mamba2_prompt_off_the_chunk_is_refused_at_submit():
    """A deliberate departure: the reference's engine accepts a prompt
    whose length is no multiple of ``min(ssd_chunk, len)`` and its
    prefill then fails (``src/repro/models/ssm.py``); the port refuses
    it at ``submit``, before it holds a page, and serves the rest."""
    ecfg = _ecfg(page_size=4, max_len=48, max_out=8)
    assert MAMBA.cfg.ssd_chunk == 32
    bad, good = _prompt(40, 30), _prompt(32, 31)
    jeng = JEngine(MAMBA.jparams, MAMBA.jcfg,
                   engine_cfg=JEngineConfig(**ecfg))
    jeng.submit(JRequest("bad", bad, 4))
    with pytest.raises(Exception):
        jeng.run()
    eng = _engine(m=MAMBA, **ecfg)
    with pytest.raises(ValueError, match="SSD chunk"):
        eng.submit(Request("bad", bad, 4))
    assert not eng._queue and eng.pool.outstanding == 0
    eng.submit(Request("good", good, 4))
    out = eng.run()
    assert list(out) == ["good"] and len(out["good"]) == 4
    assert eng.reasons == {"good": "completed"}
    assert eng.pool.outstanding == 0


def test_mamba2_preempted_sequence_is_readmitted():
    # two 32-token prompts in a pool of 17 pages of 4: each needs a ninth
    # page at its first decode step, and a paged sequence would be
    # preempted and re-enter with 33 tokens, off the chunk of 32.  A
    # pure-SSM sequence holds no page chain, so neither is preempted and
    # each generates what it generates alone.  A deliberate departure:
    # the reference's engine fails this case with an AssertionError.
    ecfg = _ecfg(page_size=4, num_pages=17, max_len=48, max_out=8)
    reqs = [("a", _prompt(32, 32)), ("b", _prompt(32, 33))]
    eng = _engine(m=MAMBA, **ecfg)
    for rid, prompt in reqs:
        eng.submit(Request(rid, prompt, 6))
    out = eng.run()
    assert sorted(out) == ["a", "b"]
    assert all(eng.reasons[rid] == "completed" for rid, _ in reqs)
    for rid, prompt in reqs:
        solo = _engine(m=MAMBA, **ecfg)
        solo.submit(Request(rid, prompt, 6))
        np.testing.assert_array_equal(out[rid], solo.run()[rid])
        assert len(out[rid]) == 6
    assert eng.pool.outstanding == 0
    jeng = JEngine(MAMBA.jparams, MAMBA.jcfg,
                   engine_cfg=JEngineConfig(**ecfg))
    for rid, prompt in reqs:
        jeng.submit(JRequest(rid, prompt, 6))
    with pytest.raises(AssertionError):
        jeng.run()


def test_adapter_store_refusals_leave_it_unchanged():
    _, ts = _stores(1)
    rng = np.random.default_rng(20)
    bs = [0.1 * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
          .astype(np.float32) for b in ts.b_full]
    with pytest.raises(AdapterMismatchError, match="full"):
        ts.add_tenant("overflow", bs)
    roomy = AdapterStore(CFG, TCFG, max_tenants=2, device="cpu")
    projs = [v.numpy() for v in ts.projs]
    roomy.add_tenant("t0", bs, projs)
    before = [b.clone() for b in roomy.b_full]
    with pytest.raises(AdapterMismatchError, match="lazy_k"):
        roomy.add_tenant("drift", bs, [v + 1.0 for v in projs])
    with pytest.raises(AdapterMismatchError, match="rank/arch"):
        roomy.add_tenant("r8", [np.zeros(b.shape[:-1] + (8,), np.float32)
                                for b in bs])
    assert roomy.n_tenants == 1
    assert all(torch.equal(a, b) for a, b in zip(before, roomy.b_full))


# (store dtype, V of the second tenant, port accepts, reference accepts).
# The last case is a deliberate departure: the reference compares its
# stored (bf16-cast) V with the incoming fp32 V at rtol 1e-5, so a bf16
# store refuses the very V it was installed from; the port compares after
# the store's own cast and accepts it.
DRIFT_CASES = [("float32", "same", True, True),
               ("float32", "drifted", False, False),
               ("bfloat16", "drifted", False, False),
               ("bfloat16", "same", True, False)]


@pytest.mark.parametrize("dtype,second,port_ok,ref_ok", DRIFT_CASES,
                         ids=[f"{d}-{s}" for d, s, _, _ in DRIFT_CASES])
def test_proj_drift_check_against_the_reference(dtype, second, port_ok,
                                                 ref_ok):
    from repro.serve import AdapterMismatchError as JMismatch
    cfg, jcfg = CFG.replace(dtype=dtype), JCFG.replace(dtype=dtype)
    js = JStore(jcfg, JTCFG, max_tenants=2)
    ts = AdapterStore(cfg, TCFG, max_tenants=2, device="cpu")
    rng = np.random.default_rng(21)
    projs = [rng.standard_normal(v.shape).astype(np.float32)
             for v in js.projs]
    bs = [0.1 * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
          .astype(np.float32) for b in js.b_full]
    js.add_tenant("t0", bs, projs)
    ts.add_tenant("t0", bs, projs)
    again = projs if second == "same" else [1.01 * v for v in projs]
    for store, mismatch, ok in ((ts, AdapterMismatchError, port_ok),
                                (js, JMismatch, ref_ok)):
        if ok:
            store.add_tenant("t1", bs, again)
            assert store.n_tenants == 2
        else:
            with pytest.raises(mismatch, match="lazy_k"):
                store.add_tenant("t1", bs, again)
            assert store.n_tenants == 1


# ---------------------------------------------------------------------------
# Page pool
# ---------------------------------------------------------------------------

def test_page_pool_alloc_release():
    pool = PagePool(4, 8)
    assert pool.pages_for(1) == 1 and pool.pages_for(8) == 1
    assert pool.pages_for(9) == 2
    assert pool.alloc(3) == [0, 1, 2]         # deterministic lowest-first
    assert pool.alloc(2) is None              # all-or-nothing
    assert pool.available == 1 and pool.outstanding == 3
    pool.release([1])
    assert pool.alloc(2) == [1, 3]
    assert pool.outstanding == 4


@pytest.mark.parametrize("bad,match", [([99], "foreign"), ([0, 0], "dupl"),
                                       ([0], "double")])
def test_page_pool_refuses_bad_releases(bad, match):
    pool = PagePool(4, 8)
    pool.alloc(1)
    if match == "double":
        pool.release([0])
    with pytest.raises(ValueError, match=match):
        pool.release(bad)


def test_page_pool_reserve_and_sizes():
    pool = PagePool(4, 8)
    pool.reserve([2, 0])
    assert pool.alloc(2) == [1, 3]
    with pytest.raises(ValueError, match="already-held"):
        pool.reserve([1])
    with pytest.raises(ValueError):
        PagePool(0, 8)
