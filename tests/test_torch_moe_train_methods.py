"""MoE training in the port against the JAX package, every method of the
registry, on the CPU, fp32: qwen3-moe-30b-a3b ``.reduced()`` (2 layers,
d 64, 8 experts, top-2, moe_d_ff 32), ``min_dim_for_lowrank`` 32 so every
expert leaf carries a rank-16 adapter, capacity factor 1.25 (pairs
dropped at batch 4 x 32).

* Every method other than the gate's (``lowrank_lion``, ``lowrank_adam``
  on int8 moments with bf16 masters, ``galore``, whose projection and
  basis refresh run over the experts' ``(L, E)`` lead, ``adamw``,
  ``lowrank_lr``) and the ``dependent_diag`` sampler (its energy EMA
  averaged over each expert member's ``(L, E)`` matrices) for two steps
  against the JAX ``Trainer``, within 1e-5 (the reference's rounding
  bits, ZO noise and the GaLore basis sign rule injected as the dense
  tests inject them), routed alike in every call.
* An MoE training checkpoint (the ``(L, E, ...)`` group records, the
  method tag) crosses to and from the reference's format.
* A trained MoE tenant loads through ``AdapterStore.load_tenant`` with
  every expert's B and V and serves lazy == merged, routed alike.

The loss, the gradients, the gate and the dispatch's backward:
``tests/test_torch_moe_train.py``.
"""
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
from repro.optim import galore as jgalore  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.optim import zo as jzo  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.linear import effective_weight  # noqa: E402
from repro_torch.optim import subspace, zo  # noqa: E402
from repro_torch.serve import AdapterStore  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_parity import (SAVED, assert_reference_restores,  # noqa: E402
                           assert_same_format, assert_same_masks,
                           assert_same_routing, jax_routing_recorder,
                           port_routing_recorder)

KW = dict(optimizer="lowrank_adam", sampler="stiefel", rank=16, lazy_k=3,
          lr=5e-3, warmup_steps=0, total_steps=100, min_dim_for_lowrank=32,
          weight_decay=0.0, schedule="constant", seed=0)
BATCH = dict(batch=4, seq_len=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model():
    return SimpleNamespace(
        cfg=get_config("qwen3-moe-30b-a3b").reduced(),
        jcfg=jget_config("qwen3-moe-30b-a3b").reduced())


def _batch(cfg):
    return dict(BATCH, vocab=cfg.vocab_size)


def _paths(cfg):
    return [subspace._path_str(p) for p, _ in
            subspace.tree_flatten_with_path(lm.param_specs(cfg))]


# ---------------------------------------------------------------------------
# The other methods of the registry and the dependent_diag sampler
# ---------------------------------------------------------------------------

METHODS = {
    "lowrank_lion": dict(optimizer="lowrank_lion", lr=3e-4, beta2=0.99),
    "lowrank_adam int8+bf16": dict(optimizer="lowrank_adam",
                                   state_dtype="int8",
                                   master_dtype="bfloat16"),
    "galore": dict(optimizer="galore"),
    "adamw": dict(optimizer="adamw"),
    "lowrank_lr": dict(optimizer="lowrank_lr"),
    "lowrank_adam dependent_diag": dict(sampler="dependent_diag"),
}
METHOD_STEPS = 2
# the dependent_diag energy EMA after the two steps, relative to its
# largest entry: quadratic in the clipped gradients, the second of them
# taken at weights a sign-like first Adam step apart; measured 1.6e-5
# with XLA single-threaded (below 1e-5 threaded) on an 8-core host
ENERGY_REL = 1e-4


def _jax_fix_signs(u):
    idx = jnp.argmax(jnp.abs(u), axis=-2, keepdims=True)
    return u * jnp.sign(jnp.take_along_axis(u, idx, axis=-2))


def _jax_method_run(m, kw, routes):
    """Two steps of the JAX Trainer: its trainer before the first, the
    losses, what the port's steps must be fed (each step's rounding bits
    under bf16 masters, its ZO noise under ``lowrank_lr``) and its final
    state."""
    jtcfg = JTrainConfig(**kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlm, "moe_ffn", jax_routing_recorder(routes))
        jt = JTrainer(m.jcfg, jtcfg, JLoader("lm", 0, **_batch(m.cfg)))
        if kw.get("master_dtype") == "bfloat16":
            jt.params = dataclasses.replace(jt.params, groups=tuple(
                w.astype(jnp.bfloat16) for w in jt.params.groups))
        start = (_np(jsub.params_of(jt.params)), jt.opt_state)
        losses, feeds = [], []
        for _ in range(METHOD_STEPS):
            st, feed = jt.opt_state, {}
            if kw.get("master_dtype") == "bfloat16":
                feed["bits"] = [np.asarray(jsub._sr_bits(st.key, st.step, g,
                                                         slot.b.shape))
                                .astype(np.int32)
                                for g, slot in enumerate(st.groups)]
            losses += jt.run(1).losses
            if kw["optimizer"] == "lowrank_lr":
                st = jt.opt_state   # the inner step keeps the key it folded
                noise = jzo._sample_noise(st, jax.random.fold_in(
                    st.key, st.step - 1))
                feed["noise"] = (_np(noise.dense), _np(noise.groups))
            feeds.append(feed)
        jax.effects_barrier()
    return start, np.array(losses, np.float64), feeds, jt.opt_state


def _port_start(m, tcfg, params0, jst0):
    """The port's Trainer at the reference's start, by method."""
    jloader = JLoader("lm", 0, **_batch(m.cfg))
    tr = Trainer(m.cfg, tcfg,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    if tcfg.optimizer == "galore":
        tr.params, tr.opt_state = convert.galore_from_numpy(
            params0, tcfg, groups=_np(jst0.groups), dense=_np(jst0.dense),
            device="cpu")
    elif tcfg.optimizer == "adamw":
        tr.params, tr.opt_state = convert.adamw_from_numpy(
            params0, m=_np(jst0.m), v=_np(jst0.v), step=int(jst0.step),
            device="cpu")
    else:
        tr.params, tr.opt_state = convert.subspace_from_numpy(
            params0, tcfg, groups=_np(jst0.groups), dense=_np(jst0.dense),
            device="cpu")
    return tr


@pytest.mark.parametrize("method", METHODS)
def test_each_method_tracks_the_jax_trainer_for_two_steps(method,
                                                          monkeypatch):
    m = _model()
    kw = dict(KW, **METHODS[method])
    if kw["optimizer"] == "galore":     # both bases under one sign rule
        orig = jgalore._top_r_basis
        monkeypatch.setattr(jgalore, "_top_r_basis",
                            lambda g, r: _jax_fix_signs(orig(g, r)))
    want_r, got_r = [], []
    (params0, jst0), jlosses, feeds, jst2 = _jax_method_run(m, kw, want_r)
    tr = _port_start(m, TrainConfig(**kw), params0, jst0)
    queue = []

    def injected_bits(gen, shape, device):
        b = queue.pop(0)
        assert tuple(shape) == b.shape
        return _t(b).to(device)

    def injected_noise(state):
        dense, groups = queue.pop(0)
        return subspace.Trainable(dense=tuple(_t(d) for d in dense),
                                  groups=tuple(_t(g) for g in groups))
    monkeypatch.setattr(subspace, "_sr_bits", injected_bits)
    monkeypatch.setattr(zo, "_sample_noise", injected_noise)
    monkeypatch.setattr(moe, "route", port_routing_recorder(got_r))
    losses = []
    for feed in feeds:
        queue[:] = feed.get("bits", []) + (
            [feed["noise"]] if "noise" in feed else [])
        losses += tr.run(1).losses
        assert not queue
    # the forward-only method routes each layer twice a step (its two
    # perturbed forwards); the others route it and recompute it
    per_step = 2 * m.cfg.num_layers
    assert len(got_r) == len(want_r) == per_step * METHOD_STEPS
    assert_same_masks(got_r, want_r, m.cfg.top_k, per_step)
    if kw["optimizer"] == "galore":
        assert tr.opt_state.refreshes == 1
        paths = _paths(m.cfg)
        experts = [g for g, spec in enumerate(tr.opt_state.layout.groups)
                   if any("/moe/" in paths[i] for i in spec.leaf_idx)]
        assert len(experts) == 2 and all(
            tr.opt_state.groups[g].proj.ndim == 5
            and tr.opt_state.groups[g].proj.abs().sum() > 0 for g in experts)
    if kw.get("master_dtype") == "bfloat16":
        assert all(w.dtype == torch.bfloat16 for w in tr.params.groups)
    if kw["sampler"] == "dependent_diag":
        for mine, ref in zip(tr.opt_state.groups, jst2.groups):
            ref = np.asarray(ref.energy, np.float64)
            assert mine.energy.shape == ref.shape and ref.any()
            err = np.abs(mine.energy.numpy() - ref).max()
            assert err <= ENERGY_REL * np.abs(ref).max(), err
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints and trained tenants
# ---------------------------------------------------------------------------

CKPT_KW = dict(KW, lazy_k=4)


def test_moe_checkpoint_crosses_to_and_from_the_reference(tmp_path):
    """A JAX MoE Trainer's checkpoint (the experts' ``(L, E, ...)`` group
    records, the router's dense slot, the method tag) restores in the
    port and is written back record for record; the port's restores
    through the reference unquarantined, byte for byte."""
    m = _model()
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    loader = JLoader("lm", 0, batch=2, seq_len=32, vocab=m.cfg.vocab_size)
    jt = JTrainer(m.jcfg, JTrainConfig(**CKPT_KW), loader, workdir=jwd,
                  checkpoint_every=SAVED)
    jt.run(SAVED)

    def port_loader(s):
        return {k: _t(v) for k, v in loader(s).items()}
    Trainer(m.cfg, TrainConfig(**CKPT_KW), port_loader, pwd,
            checkpoint_every=SAVED, device="cpu").run(SAVED)
    man = ckpt.read_manifest(pwd, SAVED)
    assert man["extra"]["arch"] == m.cfg.name == "qwen3-moe-30b-a3b"
    assert man["extra"]["method"] == "lowrank_adam"
    layout = subspace.build_layout(lm.param_specs(m.cfg),
                                   TrainConfig(**CKPT_KW))
    paths = _paths(m.cfg)
    experts = [g for g, spec in enumerate(layout.groups)
               if any("/moe/" in paths[i] for i in spec.leaf_idx)]
    assert len(experts) == 2
    for g in experts:
        E, L = m.cfg.num_experts, m.cfg.num_layers
        assert man["shapes"][f"params||groups||{g}"][1:3] == [L, E]
        assert man["shapes"][f"opt||groups||{g}||b"][1:3] == [L, E]
    tr = Trainer(m.cfg, TrainConfig(**CKPT_KW), port_loader, jwd,
                 device="cpu")
    assert tr.maybe_resume() == SAVED
    out = str(tmp_path / "again")
    ckpt.save(out, SAVED, tr._template())
    assert_same_format(jwd, out)
    assert_reference_restores(pwd, {"params": jt.params,
                                    "opt": jt.opt_state}, "lowrank_adam")


def test_trained_moe_tenant_serves_lazy_equals_merged(tmp_path):
    """Three steps of the port's Trainer, its checkpoint loaded by
    ``load_tenant``: the store holds the trainer's B and V, every
    expert's, and the lazy model's logits equal those of the merged
    weights (every expert merged) within 1e-5 of max|logit| (fp32 sums
    in another order), routed alike."""
    m = _model()
    tcfg = TrainConfig(**CKPT_KW)
    wd = str(tmp_path / "trained")
    loader = JLoader("lm", 0, batch=2, seq_len=32, vocab=m.cfg.vocab_size)
    tr = Trainer(m.cfg, tcfg, lambda s: {k: _t(v) for k, v in
                                         loader(s).items()},
                 wd, checkpoint_every=3, device="cpu")
    tr.run(3)
    store = AdapterStore(m.cfg, tcfg, max_tenants=1, device="cpu")
    store.load_tenant("trained", wd)
    for slot, b, v in zip(tr.opt_state.groups, store.b_full, store.projs):
        assert slot.b.any()
        assert torch.equal(b[..., 0, :, :], slot.b)
        assert torch.equal(v, slot.proj)
    params = lm.init_params(m.cfg, seed=3, device="cpu")
    tokens = torch.as_tensor(jlm_batch(1, 0, batch=1, seq_len=32,
                                       vocab=m.cfg.vocab_size)["tokens"])
    lazy = store.lrpack_tree(params, "trained")
    merged = tree_map(effective_weight, lazy)
    outs, routes = [], []
    for p in (lazy, merged):
        routes.append([])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe, "route", port_routing_recorder(routes[-1]))
            outs.append(lm.logits(p, lm.forward_hidden(p, tokens, m.cfg)[0],
                                  m.cfg)[..., :m.cfg.vocab_size])
    assert_same_routing(routes[0], routes[1], m.cfg.top_k)
    got, want = outs
    assert (got - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()
