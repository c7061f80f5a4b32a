"""MoE training in the port (qwen3-moe-30b-a3b: attention, then a routed
expert FFN with per-expert adapters) against the JAX package, on the
CPU, fp32.

The config is qwen3-moe-30b-a3b ``.reduced()`` (2 layers, d 64, 8
experts, top-2, moe_d_ff 32) with ``min_dim_for_lowrank`` 32, so every
expert leaf carries a rank-16 adapter: the groups are (wk, wv), (wq,
wo), the experts' (w_gate, w_up) and (w_down) stacked ``(G, L, E, k,
n)``, and the unembedding.  Two capacity factors: the config's 1.25,
whose capacity drops pairs at these batches, and 16, which drops none.
Weights and state are the reference's, carried across by
``repro_torch.convert``; after each merge the reference's own ``V`` draw
is injected into the port.  Every comparison first holds the routing
equal (``tests/_torch_parity.py``: equal top-k and keep masks call by
call, the forward's and its remat recompute's, and every k-th/(k+1)-th
probability gap above twice the largest probability difference).

* The loss (CE + 0.01 lb_loss + 1e-3 router_z) and the gradient of every
  group's ``B`` (the experts' included), of the router and of every other
  dense leaf against ``jax.grad`` of the reference's ``build_loss_fn``,
  with remat on and off, at both capacity factors; under remat the
  recompute routes as the forward and the gradients equal those of the
  forward without remat.
* The gate: the ``lowrank_adam`` ``Trainer`` against the JAX ``Trainer``
  over two outer cycles (merges and resamples over the ``(G, L, E, k,
  n)`` groups), with a float64 run of the port's plain path beside
  (``GATE_REL``); two planted faults must fail it: the aux terms left
  out of the loss, and the router's gradient through the combine
  weights cut.
* The dispatch's backward (:class:`repro_torch.models.moe._Gather`, a
  gather with no atomics) equals autograd's ``index_select`` backward in
  float64 and repeats bit for bit; a whole step's B gradients repeat bit
  for bit.
* A group's V drawn in pieces (``subspace.SAMPLE_PIECE``) keeps the
  shape and the Stiefel law, and each piece of a ``dependent_diag`` draw
  reads its own members' energy rows; a donated weight tree is grouped
  with its leaves replaced by views of the group buffers.

The other methods, the checkpoint crossing and a trained tenant:
``tests/test_torch_moe_train_methods.py``.
"""
import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import StatelessLoader as JLoader  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import samplers  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.optim import subspace  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_parity import (assert_float64, assert_same_masks,  # noqa
                           assert_same_routing, float64_plain_path,
                           jax_routing_recorder, port_routing_recorder,
                           widened)

REL = 1e-5          # gradients, relative to each one's largest magnitude
CFS = {"drops": 1.25, "no drops": 16.0}
KW = dict(optimizer="lowrank_adam", sampler="stiefel", rank=16, lazy_k=3,
          lr=5e-3, warmup_steps=0, total_steps=100, min_dim_for_lowrank=32,
          weight_decay=0.0, schedule="constant", seed=0)
BATCH = dict(batch=4, seq_len=32)       # T = 128 tokens, C = 40 at 1.25
STEPS = 7           # two merges (lazy_k 3), then one inner step


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(kind, remat=True):
    cf = CFS[kind]
    return SimpleNamespace(
        cfg=get_config("qwen3-moe-30b-a3b").reduced().replace(
            capacity_factor=cf, remat=remat),
        jcfg=jget_config("qwen3-moe-30b-a3b").reduced().replace(
            capacity_factor=cf, remat=remat))


def _batch(cfg):
    return dict(BATCH, vocab=cfg.vocab_size)


def _close(got, want, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, err


@contextlib.contextmanager
def _routings():
    """The routings of every ``moe_ffn`` call on both sides while
    inside: ``(port, jax)`` lists of ``(probs, top_idx, keep)``."""
    got, want = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", port_routing_recorder(got))
        mp.setattr(jlm, "moe_ffn", jax_routing_recorder(want))
        yield got, want
        jax.effects_barrier()


# ---------------------------------------------------------------------------
# The loss and every gradient against jax.grad
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _start():
    """The reference's grouped params and state (random B, so every
    adapter carries a gradient path), one batch, and the same in the
    port."""
    m = _model("drops")
    jtcfg, tcfg = JTrainConfig(**KW), TrainConfig(**KW)
    jgp, jst = jsub.init_grouped(jlm.init_params(m.jcfg, jax.random.key(0)),
                                 jtcfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    jst = dataclasses.replace(jst, groups=tuple(
        s._replace(b=jnp.asarray(0.02 * rng.standard_normal(s.b.shape),
                                 jnp.float32)) for s in jst.groups))
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(jgp)), tcfg, groups=_np(jst.groups),
        dense=_np(jst.dense), device="cpu")
    jbatch = jlm_batch(0, 3, **_batch(m.cfg))
    return dict(jgp=jgp, jst=jst, gp=gp, st=st, jbatch=jbatch,
                batch={k: _t(v) for k, v in jbatch.items()})


def _port_grads(s, cfg):
    """The loss and the gradients of every trainable leaf (dense, then one
    stacked B per group) of the port's loss."""
    tr = subspace.trainable_of(s["gp"], s["st"])
    leaves = [t.detach().clone().requires_grad_(True)
              for t in list(tr.dense) + list(tr.groups)]
    tr = subspace.Trainable(dense=tuple(leaves[:len(tr.dense)]),
                            groups=tuple(leaves[len(tr.dense):]))
    loss = steps.build_loss_fn(cfg)(
        subspace.packed_params(s["gp"], s["st"], tr), s["batch"])
    return loss, torch.autograd.grad(loss, leaves)


def _paths(cfg):
    return [subspace._path_str(p) for p, _ in
            subspace.tree_flatten_with_path(lm.param_specs(cfg))]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no remat"])
@pytest.mark.parametrize("kind", CFS)
def test_loss_and_every_gradient_match_jax_grad(kind, remat):
    m, s = _model(kind, remat), _start()
    jloss_fn = jsteps.build_loss_fn(m.jcfg)
    with _routings() as (got_r, want_r):
        want, wgrad = jax.jit(jax.value_and_grad(
            lambda tr: jloss_fn(jsub.packed_params(s["jgp"], s["jst"], tr),
                                s["jbatch"])))(jsub.trainable_of(s["jgp"],
                                                                 s["jst"]))
        got, grads = _port_grads(s, m.cfg)
    # each layer's forward, and under remat its recompute (last layer
    # first); the reference's grad also replays its callbacks in the
    # backward without remat, so its first calls are the forward's
    L = m.cfg.num_layers
    assert len(got_r) == L * (2 if remat else 1) and len(want_r) == 2 * L
    assert_same_routing(got_r, want_r[:len(got_r)], m.cfg.top_k)
    dropped = sum(int((~k).sum()) for _, _, k in got_r)
    assert (dropped > 0) == (kind == "drops")
    assert abs(got.item() - float(want)) <= REL * abs(float(want))
    layout = s["st"].layout
    nd = len(layout.dense_idx)
    paths = _paths(m.cfg)
    router = 0
    for i, g in zip(layout.dense_idx, grads[:nd]):
        w = wgrad.dense[layout.dense_idx.index(i)]
        _close(g, w, REL)
        router += paths[i].endswith("/router")
        if paths[i].endswith("/router"):
            assert g.abs().max() > 0
    assert router == 1       # the (L, d, E) router, one dense leaf
    experts = 0
    for spec, g, w in zip(layout.groups, grads[nd:], wgrad.groups):
        _close(g, w, REL)
        experts += any("/moe/" in paths[i] for i in spec.leaf_idx)
    assert experts == 2      # (w_gate, w_up) and (w_down), (L, E) lead


@pytest.mark.parametrize("kind", CFS)
def test_remat_recompute_routes_as_the_forward_and_keeps_its_gradients(
        kind):
    """Each block under ``torch.utils.checkpoint``: the backward's
    recompute (last layer first) routes as the forward did, and the
    recomputed graph gives the gradients of the forward that keeps every
    activation, the aux terms' included."""
    m, s = _model(kind), _start()
    rec = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", port_routing_recorder(rec))
        loss, grads = _port_grads(s, m.cfg)
    L = m.cfg.num_layers
    assert len(rec) == 2 * L
    for i in range(L):
        for a, b in zip(rec[i], rec[2 * L - 1 - i]):
            np.testing.assert_array_equal(a, b)
    loss0, grads0 = _port_grads(s, _model(kind, remat=False).cfg)
    assert loss.item() == loss0.item()
    for g, g0 in zip(grads, grads0):
        assert torch.isfinite(g).all()
        _close(g, g0.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# The gate: the lowrank_adam Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

# Per-step relative loss gap allowed between any two of the port, the JAX
# Trainer and a float64 run of the port's plain path.  Measured on an
# 8-core host: the port against the reference at most 1.27e-6 with XLA
# threaded and 1.55e-6 single-threaded; the reference against float64
# 1.43e-6 and 1.71e-6, the port against it 3.5e-7 (fp32 sums in other
# orders, no fault).  The limit is about 5x the largest.
GATE_REL = 8e-6
GATE_KIND = "drops"


@pytest.fixture(scope="module")
def jax_gate():
    """Seven steps of the JAX Trainer: its start, losses, each step's V
    draws, the steps its guard skipped and its routings."""
    m = _model(GATE_KIND)
    with _routings() as (_, routes):
        jt = JTrainer(m.jcfg, JTrainConfig(**KW),
                      JLoader("lm", 0, **_batch(m.cfg)))
        start = (_np(jsub.params_of(jt.params)), _np(jt.opt_state.groups),
                 _np(jt.opt_state.dense))
        losses, projs, skipped = [], [], []
        for s in range(STEPS):
            rep = jt.run(1)
            losses += rep.losses
            skipped += [s] * rep.skipped_steps
            projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])
    return start, np.array(losses, np.float64), projs, skipped, routes


def _port_gate_run(jax_gate, f64=False):
    """The same steps of the port's Trainer from the reference's start,
    its V draws injected; under ``f64`` the state widened and the plain
    path in float64.  Returns the losses and the routings."""
    m = _model(GATE_KIND)
    tcfg = TrainConfig(**KW)
    (params0, groups0, dense0), _, projs, _, _ = jax_gate
    jloader = JLoader("lm", 0, **_batch(m.cfg))
    tr = Trainer(m.cfg, tcfg,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, tcfg, groups=groups0, dense=dense0, device="cpu")
    if f64:
        tr.params, tr.opt_state = widened(tr.params, tr.opt_state)
    queue, losses, outer, routes = [], [], 0, []
    with pytest.MonkeyPatch.context() as mp, \
            float64_plain_path() if f64 else contextlib.nullcontext():
        mp.setattr(subspace, "_sample_proj_group",
                   lambda name, gen, spec, n, c, dtype, device,
                   energy=None: _t(queue.pop(0)).to(device, dtype))
        mp.setattr(moe, "route", port_routing_recorder(routes))
        for s in range(STEPS):
            if tr.outer_due():
                queue[:] = projs[s]
            rep = tr.run(1)
            losses += rep.losses
            outer += rep.outer_steps
            assert not queue and not rep.skipped_steps
    if f64:
        assert_float64(tr.params, tr.opt_state)
    assert outer == 2 and int(tr.opt_state.outer_step) == 2
    return np.array(losses, np.float64), routes


def _gate(losses, jlosses, f64):
    """The port, the JAX Trainer and the float64 run pairwise within
    GATE_REL at every step."""
    assert np.isfinite(losses).all()
    for a, b in ((losses, jlosses), (losses, f64), (jlosses, f64)):
        assert (np.abs(a - b) <= GATE_REL * np.abs(b)).all(), \
            np.abs(a - b).max()


@pytest.fixture(scope="module")
def f64_gate(jax_gate):
    """The float64 run's losses; it routes as the reference in every call
    (its probabilities part from the fp32 runs' by up to 5.3e-5 after
    the first step, against a smallest k-th/(k+1)-th gap of 2.5e-5)."""
    losses, routes = _port_gate_run(jax_gate, f64=True)
    cfg = _model(GATE_KIND).cfg
    assert_same_masks(routes, jax_gate[4], cfg.top_k, 2 * cfg.num_layers)
    return losses


def test_trainer_tracks_the_jax_trainer_over_two_outer_cycles(jax_gate,
                                                              f64_gate):
    """Every step of the port routed as the reference's (forward and
    recompute: 28 calls), with pairs dropped in each; the losses within
    ``GATE_REL`` of each other and of the float64 run."""
    losses, routes = _port_gate_run(jax_gate)
    assert jax_gate[3] == []
    cfg = _model(GATE_KIND).cfg
    assert_same_masks(routes, jax_gate[4], cfg.top_k, 2 * cfg.num_layers)
    assert all((~k).any() for _, _, k in routes)
    _gate(losses, jax_gate[1], f64_gate)


def _route_without_router_grad(xf, router_w, top_k, capacity,
                               norm_topk=True):
    r = _REAL_ROUTE(xf, router_w, top_k, capacity, norm_topk)
    return r._replace(top_w=r.top_w.detach())


_REAL_ROUTE = moe.route


@pytest.mark.parametrize("fault", ["aux terms left out",
                                   "router gradient through top_w cut"])
def test_a_planted_fault_fails_the_gate(fault, jax_gate, f64_gate,
                                        monkeypatch):
    if fault == "aux terms left out":
        monkeypatch.setattr(steps, "LB_COEFF", 0.0)
        monkeypatch.setattr(steps, "ZLOSS_COEFF", 0.0)
    else:
        monkeypatch.setattr(moe, "route", _route_without_router_grad)
    losses, _ = _port_gate_run(jax_gate)
    with pytest.raises(AssertionError):
        _gate(losses, jax_gate[1], f64_gate)


# ---------------------------------------------------------------------------
# A deterministic dispatch backward
# ---------------------------------------------------------------------------

def _dispatch_case(seed=0, T=24, k=3, E=5, cf=1.0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((T, 6)))
    router = torch.tensor(rng.standard_normal((6, E)))
    C = moe._capacity(T, k, E, cf)
    r = moe.route(x, router, k, C)
    return x, r, C


def test_gather_backward_equals_index_select_backward():
    """The dispatch (tokens into expert slots) and the combine (slots
    into pairs) through ``_Gather`` against ``index_select`` of the
    zero-padded source under autograd, float64, with dropped pairs."""
    x, r, C = _dispatch_case()
    T, k = r.top_idx.shape
    E = r.table.shape[0]
    assert (~r.keep).any()
    slot = torch.where(r.keep, r.flat_e * C + r.pos, E * C)
    pair = torch.full((E * C + 1,), T * k, dtype=torch.long)
    pair.scatter_(0, slot, torch.arange(T * k))
    pair = pair[:E * C]
    rng = np.random.default_rng(1)
    for src, idx, inv in ((x, r.table.reshape(-1), slot.reshape(T, k)),
                          (torch.tensor(rng.standard_normal((E * C, 6))),
                           slot, pair.reshape(-1, 1))):
        a = src.clone().requires_grad_(True)
        b = src.clone().requires_grad_(True)
        out = moe._Gather.apply(a, idx, inv)
        pad = torch.cat([b, b.new_zeros((1, b.shape[1]))])
        want = pad.index_select(0, idx)
        assert torch.equal(out, want)
        g = torch.tensor(rng.standard_normal(out.shape))
        ga, = torch.autograd.grad(out, a, g)
        gb, = torch.autograd.grad(want, b, g)
        torch.testing.assert_close(ga, gb, rtol=1e-12, atol=1e-12)


def test_a_step_b_gradients_repeat_bit_for_bit():
    """Two backward passes of one MoE step from one state give every
    group's B gradient (the experts' included) bit for bit."""
    s = _start()
    cfg = _model("drops").cfg
    _, g1 = _port_grads(s, cfg)
    _, g2 = _port_grads(s, cfg)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


# ---------------------------------------------------------------------------
# The resample in pieces, the donated grouping
# ---------------------------------------------------------------------------

EXPERT_SPEC = subspace.GroupSpec(shape=(2, 8, 64, 32), rank=16,
                                 leaf_idx=(12, 13))


def test_a_group_drawn_in_pieces_keeps_its_shape_and_law(monkeypatch):
    """A (2 members x 2 layers x 8 experts) group of (64, 16) draws in
    pieces of 5 matrices (``SAMPLE_PIECE`` set to 5 of them): 7 calls,
    every matrix on the Stiefel manifold scaled by alpha (VᵀV = alpha² I,
    alpha² = c k / r)."""
    calls = []
    real = samplers.sample_v_batched

    def counted(name, gen, batch, *a, **kw):
        calls.append(batch)
        return real(name, gen, batch, *a, **kw)
    monkeypatch.setattr(samplers, "sample_v_batched", counted)
    monkeypatch.setattr(subspace, "SAMPLE_PIECE", 5 * 64 * 16)
    gen = torch.Generator()
    gen.manual_seed(0)
    v = subspace._sample_proj_group("stiefel", gen, EXPERT_SPEC, 2, 1.0,
                                    torch.float32, torch.device("cpu"))
    assert v.shape == (2, 2, 8, 64, 16)
    assert calls == [5] * 6 + [2]
    vtv = v.double().mT @ v.double()
    eye = torch.eye(16, dtype=torch.float64) * (64 / 16)
    torch.testing.assert_close(vtv, eye.expand_as(vtv), rtol=0, atol=1e-4)
    # the pieces are distinct draws
    flat = v.reshape(-1, 64, 16)
    assert not torch.equal(flat[0], flat[5])


def test_dependent_diag_pieces_read_their_members_energy(monkeypatch):
    """Under ``dependent_diag`` a piece that spans both members reads
    member 0's energy row for its first matrices and member 1's after."""
    seen = []
    real = samplers.sample_v_batched

    def counted(name, gen, batch, n, r, diag_energy=None, **kw):
        seen.append(diag_energy.clone())
        return real(name, gen, batch, n, r, diag_energy=diag_energy, **kw)
    monkeypatch.setattr(samplers, "sample_v_batched", counted)
    monkeypatch.setattr(subspace, "SAMPLE_PIECE", 12 * 64 * 16)
    energy = torch.stack([torch.linspace(1.0, 2.0, 64),
                          torch.linspace(3.0, 5.0, 64)])
    gen = torch.Generator()
    gen.manual_seed(0)
    v = subspace._sample_proj_group("dependent_diag", gen, EXPERT_SPEC, 2,
                                    1.0, torch.float32, torch.device("cpu"),
                                    energy=energy)
    assert v.shape == (2, 2, 8, 64, 16)
    rows = torch.cat(seen)
    assert [e.shape[0] for e in seen] == [12, 12, 8]
    assert torch.equal(rows[:16], energy[0].expand(16, 64))
    assert torch.equal(rows[16:], energy[1].expand(16, 64))


def test_a_donated_tree_is_grouped_into_views():
    """``donate=True``: each grouped leaf of the caller's tree becomes its
    view of the group buffer (same values; the leaf's own storage let
    go); without it the tree keeps its own tensors."""
    cfg = _model("drops").cfg
    tcfg = TrainConfig(**KW)
    for donate in (False, True):
        params = lm.init_params(cfg, seed=0, device="cpu")
        before = subspace.tree_flatten_with_path(params)
        copies = [(p, x.clone()) for p, x in before]
        gp, _ = subspace.init_grouped(params, tcfg, torch.Generator(),
                                      donate=donate)
        after = dict(subspace.tree_flatten_with_path(params))
        for g, spec in enumerate(gp.layout.groups):
            for j, i in enumerate(spec.leaf_idx):
                path, want = copies[i]
                assert torch.equal(gp.groups[g][j], want)
                shares = after[path].data_ptr() == \
                    gp.groups[g][j].data_ptr()
                assert shares == donate
                assert torch.equal(after[path], want)
