"""The port's training with the instance-dependent sampler and with
gradient accumulation, against the JAX package on llama-tiny in fp32.

* The energy EMA (``optim.subspace._group_energy_update``, run inside
  ``inner_update``): from one state and one set of injected gradients,
  the port's energy after one inner step within 1e-5 of the largest
  entry of the reference's, for Adam and Lion on fp32 and int8 moments.
  The gradients' global norm is above ``grad_clip``, so the EMA reads
  clipped gradients; llama-tiny's groups carry a layer dim (one EMA per
  member, averaged over its layers) and the unembedding none.
* A ``dependent_diag`` Trainer over two outer cycles (``lazy_k`` 3,
  seven steps), the reference's ``V`` injected at each resample: every
  loss within 1e-5 relative of the JAX Trainer's, the energy after every
  step within 1e-5 of its largest entry, and the energy each resample
  water-fills equal to the reference's at that step, to the same limit.
  The port also runs the same steps in float64 (``tests/_torch_parity.
  py``), and its fp32 run stays within the same limits of that run.
* ``grad_accum = 2``: the port's Trainer against the JAX Trainer, every
  loss within 1e-5 relative; and one accumulated step against the
  one-batch step on the same batch from the same mid-run state: the loss
  within 1e-6 relative, B, the moments and the dense leaves within 1e-4
  of each buffer's largest magnitude (Adam divides by ``sqrt(v)``; the
  fp32 gradients are summed in another order).

The port's own ``dependent_diag`` draw inside the outer step (the
warm-up, the repeat across a member's layers, the lift weights) is held
by ``test_resample_water_fills_each_members_energy``.  A planted fault
fails each parity check.
"""
import contextlib
import dataclasses

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
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import samplers  # noqa: E402
from repro_torch.data.synthetic import StatelessLoader  # noqa: E402
from repro_torch.optim import subspace  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_parity import (assert_float64, float64_plain_path,  # noqa
                           widened)

CFG, JCFG = get_config("llama-tiny"), jget_config("llama-tiny")
BATCH = dict(batch=2, seq_len=64, vocab=CFG.vocab_size)
KW = dict(lazy_k=3, warmup_steps=2, total_steps=7, lr=3e-3, seed=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, rel):
    got = got.detach().double().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


# ---------------------------------------------------------------------------
# The energy EMA on injected gradients
# ---------------------------------------------------------------------------

EMA_CASES = [(a, sd) for a in ("adam", "lion") for sd in ("float32", "int8")]


def _ema_case(algo, state_dtype):
    kw = dict(KW, sampler="dependent_diag", optimizer=f"lowrank_{algo}",
              state_dtype=state_dtype)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    # the reference's state built under Stiefel (its eager dependent_diag
    # init compiles for half a minute), then given a dense V, so the
    # EMA's cross terms count, and a running (G, k) energy
    jgp, jst = jsub.init_grouped(
        jlm.init_params(JCFG, jax.random.key(5)),
        JTrainConfig(**dict(kw, sampler="stiefel")), jax.random.key(6),
        algo=algo)
    rng = np.random.default_rng(8)

    def rnd(shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    groups = tuple(s._replace(
        proj=jnp.asarray(rnd(s.proj.shape, 0.3)),
        energy=jnp.asarray(np.abs(rnd(s.proj.shape[:1] + s.proj.shape[-2:-1],
                                      1e-3))))
        for s in jst.groups)
    jst = dataclasses.replace(jst, groups=groups,
                              step=jnp.asarray(2, jnp.int32))
    jgrads = jsub.Trainable(
        dense=tuple(jnp.asarray(rnd(w.shape, 0.1)) for w in jgp.dense),
        groups=tuple(jnp.asarray(rnd(s.b.shape, 0.1)) for s in jst.groups))
    return tcfg, jtcfg, jgp, jst, jgrads


def _check_energy_ema(algo, state_dtype):
    tcfg, jtcfg, jgp, jst, jgrads = _ema_case(algo, state_dtype)
    _, _, js2, jgn = jax.jit(lambda g, p, s: jsub.inner_update(
        g, jsub.trainable_of(p, s), p, s, lr=1e-3, tcfg=jtcfg))(
            jgrads, jgp, jst)
    assert float(jgn) > jtcfg.grad_clip          # the EMA reads clipped g
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(jgp)), tcfg, groups=_np(jst.groups),
        dense=_np(jst.dense), step=2, device="cpu")
    grads = subspace.Trainable(dense=tuple(map(_t, jgrads.dense)),
                               groups=tuple(map(_t, jgrads.groups)))
    _, _, s2, _ = subspace.inner_update(
        grads, subspace.trainable_of(gp, st), gp, st, lr=1e-3, tcfg=tcfg)
    assert [tuple(g.energy.shape) for g in s2.groups] == \
        [g.energy.shape for g in js2.groups]
    for mine, ref, before in zip(s2.groups, js2.groups, jst.groups):
        assert not np.array_equal(np.asarray(ref.energy),
                                  np.asarray(before.energy))
        _rel_close(mine.energy, ref.energy, 1e-5)


@pytest.mark.parametrize("algo,state_dtype", EMA_CASES,
                         ids=["-".join(c) for c in EMA_CASES])
def test_energy_ema_matches_jax(algo, state_dtype):
    _check_energy_ema(algo, state_dtype)


def test_energy_is_zero_width_unless_dependent_diag():
    loader = StatelessLoader("lm", 0, device="cpu", **BATCH)
    tr = Trainer(CFG, TrainConfig(**KW), loader, device="cpu")
    assert all(g.energy.shape == (g.proj.shape[0], 0)
               for g in tr.opt_state.groups)
    tr = Trainer(CFG, TrainConfig(**dict(KW, sampler="dependent_diag")),
                 loader, device="cpu")
    assert all(g.energy.shape == (g.proj.shape[0], g.proj.shape[-2])
               and g.energy.dtype == torch.float32 and not g.energy.any()
               for g in tr.opt_state.groups)


# ---------------------------------------------------------------------------
# The dependent_diag Trainer over two outer cycles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dependent_run():
    """Seven steps of the JAX Trainer under ``dependent_diag``: its start,
    losses, V after each step and energy after each step."""
    jtcfg = JTrainConfig(**dict(KW, sampler="dependent_diag"))
    # the reference's init draws V eagerly, which compiles each op of the
    # vmapped water-filling apart (half a minute): jitted here, the same
    # draw compiles once
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsub, "_sample_proj_group", jax.jit(
            jsub._sample_proj_group, static_argnums=(0, 2, 3, 4, 6)))
        jt = JTrainer(JCFG, jtcfg, JLoader("lm", 0, **BATCH))
    start = (_np(jsub.params_of(jt.params)), _np(jt.opt_state.groups),
             _np(jt.opt_state.dense))
    losses, projs, energies = [], [], []
    for _ in range(7):
        losses += jt.run(1).losses
        projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])
        energies.append([np.asarray(g.energy) for g in jt.opt_state.groups])
    return start, np.array(losses), projs, energies


def _port_dependent_run(start, projs, f64=False):
    """The port's Trainer over the same steps, the reference's V injected
    at each resample; returns the losses, the energy after each step and
    the energy each resample was handed."""
    tcfg = TrainConfig(**dict(KW, sampler="dependent_diag"))
    params0, groups0, dense0 = start
    jloader = JLoader("lm", 0, **BATCH)
    tr = Trainer(CFG, tcfg,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, tcfg, groups=groups0, dense=dense0, device="cpu")
    if f64:
        tr.params, tr.opt_state = widened(tr.params, tr.opt_state)
    queue, handed = [], []

    def injected(name, gen, spec, n, c, dtype, device, energy=None):
        assert name == "dependent_diag"
        handed.append(energy.clone())
        return _t(queue.pop(0)).to(device, dtype)

    losses, energies, outer = [], [], 0
    with pytest.MonkeyPatch.context() as mp, \
            float64_plain_path() if f64 else contextlib.nullcontext():
        mp.setattr(subspace, "_sample_proj_group", injected)
        for s in range(7):
            if tr.outer_due():
                queue[:] = projs[s]
            report = tr.run(1)
            losses += report.losses
            outer += report.outer_steps
            assert not queue
            energies.append([g.energy.clone() for g in tr.opt_state.groups])
    if f64:
        assert_float64(tr.params, tr.opt_state)
    assert outer == 2
    return np.array(losses), energies, handed


def test_dependent_trainer_tracks_the_jax_trainer(jax_dependent_run):
    start, jlosses, projs, jenergies = jax_dependent_run
    losses, energies, handed = _port_dependent_run(start, projs)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for mine, ref in zip(energies, jenergies):
        for e, je in zip(mine, ref):
            _rel_close(e, je, 1e-5)
    # each resample water-fills the energy of the step before it
    n_groups = len(energies[0])
    assert len(handed) == 2 * n_groups
    for i, step in enumerate((3, 6)):
        for g in range(n_groups):
            _rel_close(handed[i * n_groups + g], jenergies[step - 1][g],
                       1e-5)
    # the same limits of the port's own float64 run
    losses64, energies64, _ = _port_dependent_run(start, projs, f64=True)
    np.testing.assert_allclose(losses, losses64, rtol=1e-5)
    for mine, ref in zip(energies, energies64):
        for e, e64 in zip(mine, ref):
            _rel_close(e, e64, 1e-5)


def test_resample_water_fills_each_members_energy():
    """The port's own outer step under ``dependent_diag``: a member with a
    zero energy draws the coordinate law (uniform pi = r/k: every weight
    sqrt(k/r)), and each layer of a member draws from that member's pi:
    one nonzero per column, in distinct rows, each sqrt(c/pi_i)."""
    tcfg = TrainConfig(**dict(KW, sampler="dependent_diag", c=0.5))
    loader = StatelessLoader("lm", 0, device="cpu", **BATCH)
    tr = Trainer(CFG, tcfg, loader, device="cpu")
    rng = np.random.default_rng(2)
    st = tr.opt_state
    energies = []
    for slot in st.groups:
        e = torch.from_numpy(rng.exponential(
            size=tuple(slot.energy.shape)).astype(np.float32)) ** 3
        e[0] = 0.0                                    # member 0 warms up
        energies.append(e)
    st.groups = tuple(s._replace(energy=e)
                      for s, e in zip(st.groups, energies))
    _, st2 = subspace.outer_merge_resample(tr.params, st, tcfg)
    for spec, slot, e in zip(st2.layout.groups, st2.groups, energies):
        k, r = spec.shape[-2], spec.rank
        assert torch.equal(slot.energy, e)              # carried over
        v = slot.proj.reshape(e.shape[0], -1, k, r)
        for j in range(e.shape[0]):
            pi = samplers.waterfill_inclusion_probs(
                e[j] if e[j].sum() > 0 else torch.ones(k), r)
            for layer in v[j]:
                nz = layer != 0
                assert (nz.sum(0) == 1).all() and (nz.sum(1) <= 1).all()
                rows = nz.int().argmax(0)
                np.testing.assert_allclose(
                    layer[rows, torch.arange(r)].numpy(),
                    torch.sqrt(0.5 / pi[rows]).numpy(), rtol=1e-6)
            if j == 0:
                assert torch.allclose(pi, torch.full((k,), r / k))


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------

ACC_BATCH = dict(batch=4, seq_len=64, vocab=CFG.vocab_size)


def test_grad_accum_trainer_tracks_the_jax_trainer(monkeypatch):
    kw = dict(KW, grad_accum=2)
    jt = JTrainer(JCFG, JTrainConfig(**kw), JLoader("lm", 0, **ACC_BATCH))
    params0 = _np(jsub.params_of(jt.params))
    groups0, dense0 = _np(jt.opt_state.groups), _np(jt.opt_state.dense)
    jlosses, projs = [], []
    for _ in range(7):
        jlosses += jt.run(1).losses
        projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])
    tcfg = TrainConfig(**kw)
    jloader = JLoader("lm", 0, **ACC_BATCH)
    tr = Trainer(CFG, tcfg,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, tcfg, groups=groups0, dense=dense0, device="cpu")
    queue = []
    monkeypatch.setattr(
        subspace, "_sample_proj_group",
        lambda name, gen, spec, n, c, dtype, device, energy=None:
        _t(queue.pop(0)).to(device, dtype))
    losses = []
    for s in range(7):
        if tr.outer_due():
            queue[:] = projs[s]
        losses += tr.run(1).losses
        assert not queue
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


@pytest.fixture(scope="module")
def mid_run():
    """A mid-run state of the port (random B and moments, step 2) and one
    batch of four rows."""
    tcfg = TrainConfig(**KW)
    gp, st = convert.subspace_from_numpy(
        _np(jlm.init_params(JCFG, jax.random.key(5))), tcfg, device="cpu")
    gen = torch.Generator().manual_seed(3)

    def rnd(t, scale, positive=False):
        x = scale * torch.randn(t.shape, generator=gen)
        return x.abs() if positive else x

    st.groups = tuple(s._replace(b=rnd(s.b, 0.02), m=rnd(s.m, 1e-3),
                                 v=rnd(s.v, 1e-6, True)) for s in st.groups)
    st.step = torch.tensor(2, dtype=torch.int32)
    batch = {k: _t(v) for k, v in jlm_batch(0, 3, **ACC_BATCH).items()}
    return gp, st, batch


def _fresh(gp, st):
    """A copy the step may update in place."""
    return (dataclasses.replace(gp, dense=tuple(w.clone() for w in gp.dense),
                                groups=tuple(w.clone() for w in gp.groups)),
            dataclasses.replace(st))


def _check_accumulated_step(mid_run):
    gp, st, batch = mid_run
    one = steps.make_train_step(CFG, TrainConfig(**KW))(*_fresh(gp, st),
                                                         batch)
    acc = steps.make_train_step(CFG, TrainConfig(**dict(KW, grad_accum=2)))(
        *_fresh(gp, st), batch)
    (p1, s1, m1), (p2, s2, m2) = one, acc
    assert abs(m2["loss"].item() - m1["loss"].item()) <= \
        1e-6 * abs(m1["loss"].item())
    _rel_close(m2["grad_norm"], m1["grad_norm"], 1e-5)
    for a, b in zip(s2.groups, s1.groups):
        for f in ("b", "m", "v"):
            _rel_close(getattr(a, f), getattr(b, f), 1e-4)
    for a, b in zip(p2.dense, p1.dense):
        _rel_close(a, b, 1e-4)


def test_accumulated_step_equals_the_one_batch_step(mid_run):
    _check_accumulated_step(mid_run)


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------

def test_planted_fault_ema_rate_fails_the_energy_parity(monkeypatch):
    def wrong(slot, g32):
        if not slot.energy.shape[-1]:
            return slot.energy
        p = slot.proj.float()
        e = ((p @ (g32.mT @ g32)) * p).sum(-1)
        if e.ndim > 2:
            e = e.mean(dim=tuple(range(1, e.ndim - 1)))
        return 0.98 * slot.energy + 0.02 * e
    monkeypatch.setattr(subspace, "_group_energy_update", wrong)
    with pytest.raises(AssertionError):
        _check_energy_ema("adam", "float32")


def test_planted_fault_last_microbatch_dropped_fails(mid_run, monkeypatch):
    orig = steps._microbatches
    monkeypatch.setattr(steps, "_microbatches",
                        lambda batch, n: orig(batch, n)[:-1] * 2)
    with pytest.raises(AssertionError):
        _check_accumulated_step(mid_run)
