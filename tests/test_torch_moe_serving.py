"""Serving the MoE family (qwen3-moe-30b-a3b): the port's ``Engine``
against the JAX ``Engine``, the adapter store at the experts' lead, the
weights carried across, lazy == merged, and the card's decode step.

On the CPU, fp32, at qwen3-moe-30b-a3b ``.reduced()`` (2 layers, d 64,
8 experts, top-2) with ``min_dim_for_lowrank`` 32 (every expert leaf
carries a rank-16 adapter), weights the reference's (seed 0):

* two tenants, staggered joins: the port's tokens equal the JAX
  engine's, every greedy step's top-2 logit gap (prefill and decode,
  every active row) is above 1e-4, and the routing of every ``moe_ffn``
  call of both engines is equal (``tests/_torch_parity.py``);
* a decode batch of 8 with 5 inactive slots: every slot routes, so the
  inactive rows (one token each, at position 0) crowd their experts and
  decode drops pairs; tokens and routing equal the JAX engine's;
* a preempted sequence re-prefilled whole (prompt and the tokens it had
  made) gives the JAX engine's tokens;
* the store's ``B`` and ``V`` at ``lead = (L, E)`` after the group axis
  equal the reference store's shapes, and the per-tenant and per-row
  packs slice one layer of them in place;
* the reference's parameters convert leaf for leaf (the router fp32);
* lazy serving (``W + V Bᵀ`` never formed, every expert's ``w_gate``,
  ``w_up``, ``w_down`` included) gives the merged model's tokens, with
  equal routing.

The JAX package is imported only where present, so the ``cuda``-marked
tests run on a card host without it (``PYTHONPATH=src python -m pytest
-m cuda tests/test_torch_moe_serving.py``): every qwen3-moe (K, N) of
the low-rank forward takes the tensor cores (checked on the CPU), and a
bf16 paged decode step of the reduced model over 3 tenants makes no
host sync, launches the per-row-B forward on the tensor cores only and
gathers no ``B`` (no ``index_select`` or ``index`` of a stack of three
or more dims under the profiler).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.common import (tree_flatten_with_path,  # noqa: E402
                                       tree_map)
from repro_torch.models.linear import (BatchLRPack, LRPack,  # noqa: E402
                                       effective_weight)
from repro_torch.serve import (AdapterStore, Engine,  # noqa: E402
                               EngineConfig, Request, batched_pack_tree)
from repro_torch.serve import engine as engine_mod  # noqa: E402

from _torch_parity import (assert_same_routing,  # noqa: E402
                           jax_routing_recorder, port_routing_recorder)

try:
    import jax
    import jax.numpy as jnp  # noqa: F401
except ImportError:       # a card host: the cuda tests run without it
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package "
                               "(the reference these tests hold the port to)")

RANK = 16
MIN_GAP = 1e-4
TCFG = TrainConfig(rank=RANK, min_dim_for_lowrank=32)
QWEN3 = get_config("qwen3-moe-30b-a3b")
CFG = QWEN3.reduced()
E, TOP_K = CFG.num_experts, CFG.top_k


def _ref():
    """The reference's config, parameters and store factory (JAX)."""
    from repro.configs import TrainConfig as JTrainConfig
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    jcfg = jget_config("qwen3-moe-30b-a3b").reduced()
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    jtcfg = JTrainConfig(optimizer="lowrank_adam", rank=RANK,
                         min_dim_for_lowrank=32)
    return jcfg, jparams, jtcfg


_CACHE = {}


def _model():
    if not _CACHE:
        jcfg, jparams, jtcfg = _ref()
        _CACHE.update(jcfg=jcfg, jparams=jparams, jtcfg=jtcfg,
                      params=convert.params_from_numpy(
                          jax.tree.map(np.asarray, jparams), device="cpu"))
    return _CACHE


def _stores(n_tenants, seed=1, scale=0.05):
    from repro.serve import AdapterStore as JStore
    m = _model()
    js = JStore(m["jcfg"], m["jtcfg"], max_tenants=n_tenants)
    ts = AdapterStore(CFG, TCFG, max_tenants=n_tenants, device="cpu")
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
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n,)
                                                ).astype(np.int32)


def _ecfg(**over):
    base = dict(page_size=4, max_batch=2, max_len=48, max_out=8)
    base.update(over)
    return base


def _logit_recorder(monkeypatch, record):
    """Record the logits of every prefill and of every active row of every
    decode step the port's engine runs."""
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


def _min_top2_gap(record):
    rows = torch.cat(record)
    top = torch.topk(rows, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).min().item()


def _run_both(monkeypatch, reqs, more, ecfg, n_tenants=2):
    """Run ``reqs`` (then ``more`` after three steps) through the JAX
    engine and the port's, recording each one's routing and the port's
    logits.  Returns (port outputs, JAX outputs, port routing, JAX
    routing, port logits, the port engine)."""
    from repro.models import lm as jlm
    from repro.serve import Engine as JEngine
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import Request as JRequest
    m = _model()
    js, ts = _stores(n_tenants)
    got, want, logits = [], [], []
    monkeypatch.setattr(moe, "route", port_routing_recorder(got))
    monkeypatch.setattr(jlm, "moe_ffn", jax_routing_recorder(want))
    _logit_recorder(monkeypatch, logits)
    outs = []
    for eng, R in ((JEngine(m["jparams"], m["jcfg"], adapters=js,
                            engine_cfg=JEngineConfig(**ecfg)), JRequest),
                   (Engine(m["params"], CFG, adapters=ts,
                           engine_cfg=EngineConfig(**ecfg), device="cpu"),
                    Request)):
        for rid, p, n, ten in reqs:
            eng.submit(R(rid, p, n, tenant=ten))
        for _ in range(3):
            assert eng.step()
        for rid, p, n, ten in more:
            eng.submit(R(rid, p, n, tenant=ten))
        outs.append(eng.run())
    jax.effects_barrier()
    return outs[1], outs[0], got, want, logits, eng


@needs_jax
def test_engine_two_tenants_staggered_match_jax(monkeypatch):
    reqs = [("r0", _prompt(3, 5), 6, "t0"), ("r1", _prompt(6, 6), 3, "t1")]
    more = [("r2", _prompt(4, 7), 5, "t1")]
    tout, jout, got, want, logits, eng = _run_both(monkeypatch, reqs, more,
                                                   _ecfg())
    assert sorted(tout) == ["r0", "r1", "r2"]
    for rid, _, n, _ in reqs + more:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n and eng.reasons[rid] == "completed"
    assert_same_routing(got, want, TOP_K)
    gap = _min_top2_gap(logits)
    print(f"smallest top-2 logit gap over {len(logits)} steps: {gap:.3g}")
    assert gap > MIN_GAP
    assert eng.pool.outstanding == 0


@needs_jax
def test_decode_batch_of_8_with_inactive_slots_drops_and_matches_jax(
        monkeypatch):
    reqs = [("a", _prompt(5, 11), 7, "t0"), ("b", _prompt(9, 12), 4, "t1"),
            ("c", _prompt(2, 13), 6, "t0")]
    tout, jout, got, want, logits, eng = _run_both(
        monkeypatch, reqs, [], _ecfg(max_batch=8, max_len=24))
    for rid, _, n, _ in reqs:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n
    assert_same_routing(got, want, TOP_K)
    # decode calls route all 8 slots; the 5 inactive ones share a token
    # and position, so their experts overflow C = 4
    decode = [k for _, idx, k in got if idx.shape[0] == 8]
    dropped = sum(int((~k).sum()) for k in decode)
    print(f"{dropped} pairs of {sum(k.size for k in decode)} dropped over "
          f"{len(decode)} decode calls")
    assert decode and dropped > 0
    assert _min_top2_gap(logits) > MIN_GAP


@needs_jax
def test_preempted_moe_sequence_matches_the_jax_engine(monkeypatch):
    """A pool of 14 pages of 4: "young" is preempted 9 tokens in and
    re-enters with its prompt and those tokens prefilled whole, which
    can route otherwise than the decode steps that made them; held to
    the JAX engine, which does the same, not to the unpreempted
    tokens."""
    seen = []
    real = Engine._preempt

    def preempt(self, slot):
        seen.append((self._slots[slot]["rid"],
                     self._slots[slot]["generated"]))
        real(self, slot)
    monkeypatch.setattr(Engine, "_preempt", preempt)
    reqs = [("old", _prompt(8, 60), 12, "t0"),
            ("young", _prompt(32, 61), 16, "t1")]
    tout, jout, got, want, logits, eng = _run_both(
        monkeypatch, reqs, [], _ecfg(num_pages=14, max_out=16))
    assert seen == [("young", 9)]
    for rid, _, n, _ in reqs:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        assert len(tout[rid]) == n and eng.reasons[rid] == "completed"
    assert_same_routing(got, want, TOP_K)
    assert _min_top2_gap(logits) > MIN_GAP
    assert eng.pool.outstanding == 0


@needs_jax
def test_store_shapes_at_the_experts_lead_match_jax():
    js, ts = _stores(3)
    assert [tuple(b.shape) for b in ts.b_full] == \
        [tuple(b.shape) for b in js.b_full]
    assert [tuple(v.shape) for v in ts.projs] == \
        [tuple(v.shape) for v in js.projs]
    L = CFG.num_layers
    d, f = CFG.d_model, CFG.moe_d_ff
    experts = {tuple(b.shape) for b, g in zip(ts.b_full, ts.layout.groups)
               if len(g.shape) == 4}
    # (G, L, E, T, n, r): w_gate and w_up share a group, w_down its own
    assert experts == {(2, L, E, 3, f, RANK), (1, L, E, 3, d, RANK)}
    params = _model()["params"]
    pre = ts.lrpack_tree(params, "t2")["layers"]["moe"]["w_down"]
    assert isinstance(pre, LRPack) and tuple(pre.b.shape) == \
        (L, E, d, RANK)
    dec = batched_pack_tree(params, ts.layout, ts.b_full, ts.projs,
                            torch.tensor([2, 0]))["layers"]["moe"]["w_up"]
    layer = dec[1]
    assert isinstance(layer, BatchLRPack) and \
        tuple(layer.b.shape) == (E, 3, f, RANK)
    g = next(i for i, s in enumerate(ts.layout.groups)
             if s.shape == (L, E, d, f))
    assert layer.b.data_ptr() == ts.b_full[g][1][1].data_ptr()   # a view


@needs_jax
def test_convert_carries_the_reference_params_leaf_for_leaf():
    from repro.optim import subspace as jsubspace
    m = _model()
    jflat = jax.tree_util.tree_flatten_with_path(m["jparams"])[0]
    tflat = tree_flatten_with_path(m["params"])
    assert [jsubspace._path_str(p) for p, _ in jflat] == \
        ["/" + "/".join(p) for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(t.shape)
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    specs = tree_flatten_with_path(lm.param_specs(CFG))
    assert [(p, tuple(s.shape), s.dtype) for p, s in specs] == \
        [(p, tuple(t.shape), t.dtype) for p, t in tflat]
    layer = m["params"]["layers"]["moe"]
    assert layer["router"].dtype == torch.float32
    assert tuple(layer["w_gate"].shape) == (CFG.num_layers, E, CFG.d_model,
                                            CFG.moe_d_ff)


@needs_jax
def test_lazy_serving_equals_merged_serving(monkeypatch):
    params = _model()["params"]
    _, ts = _stores(1, scale=0.02)
    prompt = _prompt(20, 20)
    runs = []
    for lazy in (True, False):
        rec = []
        monkeypatch.undo()        # record each run around the real route
        monkeypatch.setattr(moe, "route", port_routing_recorder(rec))
        if lazy:
            eng = Engine(params, CFG, adapters=ts, device="cpu",
                         engine_cfg=EngineConfig(**_ecfg(max_batch=1)))
            eng.submit(Request("r", prompt, 6, tenant="t0"))
        else:
            merged = tree_map(effective_weight, ts.lrpack_tree(params, "t0"))
            eng = Engine(merged, CFG, device="cpu",
                         engine_cfg=EngineConfig(**_ecfg(max_batch=1)))
            eng.submit(Request("r", prompt, 6))
        runs.append((eng.run()["r"], rec))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert_same_routing(runs[0][1], runs[1][1], TOP_K)


def test_store_compares_a_joining_v_piece_by_piece(monkeypatch):
    """A tenant's V is held to the store's in pieces (an expert V is
    gigabytes at full size): a difference in the last piece alone is
    refused, an equal V accepted."""
    from repro_torch.serve import adapters
    monkeypatch.setattr(adapters, "_DRIFT_PIECE", 7)
    store = AdapterStore(CFG, TCFG, max_tenants=3, device="cpu")
    rng = np.random.default_rng(0)
    projs = [0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for v in store.projs]
    bs = [np.zeros(b.shape[:-3] + b.shape[-2:], np.float32)
          for b in store.b_full]
    store.add_tenant("t0", bs, projs)
    store.add_tenant("t1", bs, [v.copy() for v in projs])
    g = max(range(len(projs)), key=lambda i: projs[i].size)
    assert projs[g].size % 7      # the last piece is a short one
    moved = [v.copy() for v in projs]
    moved[g].reshape(-1)[-1] += 1.0
    with pytest.raises(adapters.AdapterMismatchError, match="differs"):
        store.add_tenant("t2", bs, moved)
    assert store.n_tenants == 2


# ---------------------------------------------------------------------------
# The card (no JAX)
# ---------------------------------------------------------------------------

RANK_FULL = 128
# qwen3-moe-30b-a3b's low-rank forward (K, N): wq, wk and wv, wo, the
# unembedding (152064 = the 151936-token vocabulary padded to 256)
SHAPES = [(2048, 4096), (2048, 512), (4096, 2048), (2048, 152064)]


def test_the_shapes_are_the_models():
    shapes = set()
    for path, spec in tree_flatten_with_path(lm.param_specs(QWEN3)):
        if path[-1] in ("wq", "wk", "wv", "wo", "unembed"):
            shapes.add(tuple(spec.shape[-2:]))
    assert shapes == set(SHAPES)
    assert lm.padded_vocab(QWEN3) == 152064


@pytest.mark.parametrize("K,N", SHAPES)
def test_every_qwen3_moe_shape_takes_the_tensor_cores(K, N):
    for form in ("shared", "batched"):
        assert lf.tc_route(torch.bfloat16, K, N, RANK_FULL, (0, 128),
                           form=form) == "tc"


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture
def cuda():
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_tests_skip_with_a_reason():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to skip")
    with pytest.raises(pytest.skip.Exception, match="CUDA device"):
        _require_cuda()


def _bf16_decode_step(dev):
    """A bf16 paged decode step of the reduced model, 4 slots over a
    store of 3 tenants read at rows [2, 0, 2, 1]."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16", param_dtype="bfloat16")
    store = AdapterStore(cfg, TCFG, max_tenants=3, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    projs = [0.05 * torch.randn(v.shape, generator=g, device=dev)
             for v in store.projs]
    for t in range(3):
        store.add_tenant(f"t{t}", [
            0.05 * torch.randn(b.shape[:-3] + b.shape[-2:], generator=g,
                               device=dev) for b in store.b_full], projs)
    params = lm.init_params(cfg, seed=1, device=dev)
    packed = batched_pack_tree(params, store.layout, store.b_full,
                               store.projs,
                               torch.tensor([2, 0, 2, 1], device=dev))
    ps = lm.alloc_paged_state(cfg, 4, 8, 4, 8, device=dev)
    ps = ps._replace(
        page_table=torch.arange(8, dtype=torch.int32,
                                device=dev).reshape(4, 2),
        lengths=torch.tensor([1, 3, 5, 7], dtype=torch.int32, device=dev))
    tok = torch.randint(0, cfg.vocab_size, (4, 1), device=dev)
    return cfg, (packed, tok, cfg, ps)


@pytest.mark.cuda
def test_bf16_moe_decode_step_makes_no_host_sync(cuda):
    cfg, args = _bf16_decode_step(cuda)
    lf.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = lm.decode_step_paged(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
    assert lf.launches("batched", "tc") > 0
    assert lf.launches(route="simt") == 0


@pytest.mark.cuda
def test_bf16_moe_decode_step_gathers_no_b(cuda):
    from torch.profiler import ProfilerActivity, profile
    _, args = _bf16_decode_step(cuda)
    lm.decode_step_paged(*args)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        lm.decode_step_paged(*args)
        torch.cuda.synchronize()
    gathers = [e.input_shapes for e in
               prof.key_averages(group_by_input_shape=True)
               if e.key == "aten::index_select" and e.input_shapes
               and len(e.input_shapes[0]) >= 3]
    assert not gathers
