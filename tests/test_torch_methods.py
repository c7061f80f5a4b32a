"""The paper's comparison methods in the port — ``galore``, ``adamw`` and
``lowrank_lr`` — against the JAX package, on llama-tiny in fp32.

Parameters, states, gradients, batches and (for ``lowrank_lr``) the
perturbation noise ``Z`` and the resampled ``V`` come from the reference
and are carried across as numpy arrays: threefry and torch's generators
cannot agree bit for bit.  Tolerances, fp32 with sums taken in another
order:

* the full gradient, in the grouped layout: 1e-5 of each buffer's
  largest magnitude (measured 1.5e-6);
* GaLore, one step, refresh on and off: weights, ``m``, ``v`` and the
  projector ``U Uᵀ`` within 1e-5 of each buffer's largest magnitude
  (measured: at most 4.0e-6); a kept basis ``U`` within 1e-5 too, a
  refreshed one column by column within ``8 u / gap`` of the
  reference's and of the float64 basis (``_basis_close``): fp32 ``eigh``
  solvers differ by up to 1.04e-5 of the largest entry here, and each
  package's is as far from float64 as the other's;
* the GaLore ``Trainer`` over 7 steps at ``lazy_k`` 3 (three bases):
  every per-step loss within 1e-5 relative of the JAX ``Trainer``'s
  (measured 1.4e-7), below the 1e-4 the port is held to;
* the AdamW ``Trainer``: 1e-5 relative per step (measured 2.1e-7); the
  weights after 7 steps within 1e-3 of their largest magnitude
  (measured 7.5e-5 to 1.3e-4 over runs: Adam divides by ``sqrt(v)``,
  which lifts the gradients' last-bit differences where ``v`` is
  small);
* ``lowrank_lr``, one inner step: the loss within 1e-5 relative, B, m, v
  and the dense leaves within 1e-5 of their largest magnitude (measured
  1.7e-7); the gradient norm within 1e-3 relative (measured 1.7e-4: the
  estimate is a loss difference over ``2σ``, which lifts the losses'
  last-bit differences by ``1/σ``; the clip then divides that scale out
  of the update);
* the ``lowrank_lr`` ``Trainer`` over two outer cycles: 1e-5 relative
  per step (measured 1.4e-7).

``eigh`` returns each eigenvector up to its sign, and the solvers of the
two packages need not agree.  The port fixes each basis column's sign
(its largest-magnitude entry positive, ``galore._fix_signs``, pinned
below) and the tests apply the same rule to the reference's
``_top_r_basis`` by wrapping it; the JAX package is not edited.  A
top-r basis is well defined only where the gram's top ``r + 1``
eigenvalues are apart, so each GaLore test asserts that gap at every
refresh (at least 1e-3 of the largest eigenvalue; measured 0.0168 and
more), and a near-tie shows as that and not as a tolerance miss.  The
tests run at rank 4 with 512 tokens per batch, more than any weight's
input width (128 or 384), so no gram is rank-deficient.
"""
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
from repro.models.common import compute_view as jcompute_view  # noqa: E402
from repro.optim import galore as jgalore  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.optim import zo as jzo  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert, methods  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.models.common import compute_view  # noqa: E402
from repro_torch.optim import adamw, galore, subspace, zo  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

CFG, JCFG = get_config("llama-tiny"), jget_config("llama-tiny")
KW = dict(rank=4, lazy_k=3, warmup_steps=2, total_steps=7, lr=3e-3, seed=0)
BATCH = dict(batch=4, seq_len=128, vocab=CFG.vocab_size)
GAP_MIN = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _loader(jloader):
    return lambda s: {k: _t(v) for k, v in jloader(s).items()}


def _jax_fix_signs(u):
    idx = jnp.argmax(jnp.abs(u), axis=-2, keepdims=True)
    return u * jnp.sign(jnp.take_along_axis(u, idx, axis=-2))


@pytest.fixture
def signed(monkeypatch):
    """Both packages' basis under the port's sign rule; returns the list
    of the smallest relative eigengap among the top r + 1 eigenvalues of
    every gram the port decomposes."""
    orig = jgalore._top_r_basis
    monkeypatch.setattr(jgalore, "_top_r_basis",
                        lambda g, r: _jax_fix_signs(orig(g, r)))
    gaps = []
    port_orig = galore._top_r_basis

    def recorded(g, r):
        ev = torch.linalg.eigvalsh((g @ g.mT).double())
        top = ev[..., -(r + 1):]
        gaps.append(((top[..., 1:] - top[..., :-1])
                     / top[..., -1:]).min().item())
        return port_orig(g, r)

    monkeypatch.setattr(galore, "_top_r_basis", recorded)
    return gaps


# ---------------------------------------------------------------------------
# The registry, the sign rule, the opt-out
# ---------------------------------------------------------------------------

def test_every_reference_method_is_registered():
    from repro import methods as jmethods
    assert methods.available() == jmethods.available() == (
        "adamw", "galore", "lowrank_adam", "lowrank_lion", "lowrank_lr")
    assert methods.get("lowrank_lr").family == "zo"
    assert methods.get("galore").make_outer_step(CFG, TrainConfig()) is None
    assert methods.get("adamw").make_outer_step(CFG, TrainConfig()) is None


@pytest.mark.parametrize("k,r", [(6, 3), (40, 5)])
def test_the_basis_sign_rule_is_pinned(k, r):
    """Each column's largest-magnitude entry comes out positive, whatever
    sign the solver gave the column; the basis is the gram's top-r
    eigenvectors, orthonormal and row-major."""
    gen = torch.Generator().manual_seed(k)
    u = torch.linalg.qr(torch.randn(k, r, generator=gen,
                                    dtype=torch.float64))[0]
    flips = torch.tensor([(-1.0) ** j for j in range(r)],
                         dtype=torch.float64)
    fixed = galore._fix_signs(u)
    assert torch.equal(galore._fix_signs(u * flips), fixed)
    idx = fixed.abs().argmax(dim=0)
    assert (fixed[idx, torch.arange(r)] > 0).all()
    assert torch.equal(fixed.abs(), u.abs())
    # ties: the first largest entry decides
    tie = torch.tensor([[-1.0], [1.0], [0.5]])
    assert torch.equal(galore._fix_signs(tie), -tie)

    g = torch.randn(k, 3 * k, generator=gen)
    basis = galore._top_r_basis(g, r)
    assert basis.shape == (k, r) and basis.is_contiguous()
    ev, vecs = torch.linalg.eigh((g @ g.T).double())
    np.testing.assert_allclose(
        (basis.double().T @ vecs[:, -r:]).abs().numpy(),
        np.eye(r), atol=1e-4)
    idx = basis.abs().argmax(dim=0)
    assert (basis[idx, torch.arange(r)] > 0).all()
    # the reference's basis under the same rule agrees
    want = _jax_fix_signs(jgalore._top_r_basis(jnp.asarray(g.numpy()), r))
    _rel_close(basis, want, 1e-4)


def test_galore_state_stays_fp32_whatever_the_knobs_say():
    tcfg = TrainConfig(**dict(KW, optimizer="galore", state_dtype="int8",
                              master_dtype="bfloat16"))
    tr = Trainer(CFG, tcfg, _loader(JLoader("lm", 0, **BATCH)),
                 device="cpu")
    st = tr.opt_state
    assert (st.layout.state_dtype, st.layout.master_dtype) == (
        "float32", "float32")
    assert all(s.m.dtype == s.v.dtype == s.b.dtype == torch.float32
               for s in st.groups)
    assert all(not s.proj.any() for s in st.groups)
    assert st.host_step == st.refreshes == 0


# ---------------------------------------------------------------------------
# GaLore: the full gradient, one update step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def galore_start():
    """A reference GaLore state mid-run (random moments, a basis from an
    earlier gradient, step 4), its full gradient on one batch, and the
    same in the port."""
    jtcfg = JTrainConfig(**dict(KW, optimizer="galore"))
    tcfg = TrainConfig(**dict(KW, optimizer="galore"))
    jparams = jlm.init_params(JCFG, jax.random.key(3))
    jgp, jst = jgalore.init_grouped(jparams, jtcfg, jax.random.key(4))
    jloss = jsteps.build_loss_fn(JCFG)
    earlier = jlm_batch(1, 9, **BATCH)
    vg = jax.jit(lambda p, b: jgalore.value_and_full_grads(jloss, p, b))
    _, jg_old = vg(jgp, earlier)
    rng = np.random.default_rng(5)
    groups = []
    for spec, slot, g in zip(jst.layout.groups, jst.groups, jg_old.groups):
        fn = lambda a: _jax_fix_signs(jgalore._top_r_basis(a, spec.rank))
        for _ in range(g.ndim - 2):
            fn = jax.vmap(fn)
        groups.append(slot._replace(
            proj=fn(g),
            m=jnp.asarray(1e-3 * rng.standard_normal(slot.m.shape),
                          jnp.float32),
            v=jnp.asarray(1e-6 * np.abs(rng.standard_normal(slot.v.shape)),
                          jnp.float32)))
    jst = dataclasses.replace(jst, groups=tuple(groups),
                              step=jnp.asarray(4, jnp.int32))
    jbatch = jlm_batch(0, 3, **BATCH)
    jl, jgrads = vg(jgp, jbatch)
    gp, st = convert.galore_from_numpy(
        _np(jsub.params_of(jgp)), tcfg, groups=_np(jst.groups),
        dense=_np(jst.dense), step=4, device="cpu")
    return dict(jtcfg=jtcfg, tcfg=tcfg, jgp=jgp, jst=jst, jbatch=jbatch,
                jl=jl, jgrads=jgrads, gp=gp, st=st,
                batch={k: _t(v) for k, v in jbatch.items()})


def test_full_grads_arrive_grouped_and_match_jax(galore_start):
    s = galore_start
    loss, grads = galore.value_and_full_grads(
        steps.build_loss_fn(CFG), s["gp"], s["batch"])
    assert isinstance(grads, subspace.GroupedParams)
    assert abs(loss.item() - float(s["jl"])) <= 1e-5 * abs(float(s["jl"]))
    for mine, ref, w in zip(grads.groups, s["jgrads"].groups,
                            s["gp"].groups):
        assert mine.shape == w.shape and mine.is_contiguous()
        _rel_close(mine, ref, 1e-5)
    for mine, ref in zip(grads.dense, s["jgrads"].dense):
        _rel_close(mine, ref, 1e-5)


EIGH_TOL = 8.0


def _basis_close(got, want, g64):
    """A refreshed basis against the reference's and both against the
    float64 basis of the same gradient, column by column: an fp32 ``eigh``
    places eigenvector ``i`` within about ``u / gap_i`` of the exact one
    (``u = 2**-24``, ``gap_i`` its eigenvalue's distance to the nearest
    other one over the largest), whatever order its sums take, so each
    side is held to ``EIGH_TOL · u / gap_i`` of float64 and of the other.
    Every ``gap_i`` is asserted at least ``GAP_MIN``, so no column's
    limit exceeds ``EIGH_TOL · u / GAP_MIN`` = 4.8e-4 (the smallest gap
    here 0.0093, its limit 5.1e-5).  Measured, with XLA's CPU dot
    threaded and not: the port 3.5 and 2.9 ``u / gap_i`` from float64,
    the reference 2.9 and 3.0, the two 4.0 and 3.0 from each other."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    r = got.shape[-1]
    for idx in np.ndindex(*g64.shape[:-2]):
        lam, vecs = np.linalg.eigh(g64[idx] @ g64[idx].T)
        lam = lam / lam[-1]
        top = vecs[:, -r:]
        top = top * np.sign(top[np.abs(top).argmax(axis=0), np.arange(r)])
        gap = np.array([np.abs(np.delete(lam, j) - lam[j]).min()
                        for j in range(len(lam) - r, len(lam))])
        assert gap.min() >= GAP_MIN, gap.min()
        tol = EIGH_TOL * 2.0 ** -24 / gap
        for a, b in ((got[idx], want[idx]), (got[idx], top),
                     (want[idx], top)):
            assert (np.abs(a - b).max(axis=0) <= tol).all()


@pytest.mark.parametrize("refresh", [True, False])
def test_one_galore_step_matches_jax(galore_start, signed, refresh):
    s = galore_start
    grads = dataclasses.replace(
        s["gp"], dense=tuple(_t(g) for g in _np(s["jgrads"].dense)),
        groups=tuple(_t(g) for g in _np(s["jgrads"].groups)))
    jp2, js2 = jgalore.update(s["jgrads"], s["jgp"], s["jst"], lr=2e-3,
                              tcfg=s["jtcfg"], refresh=refresh)
    p2, s2 = galore.update(grads, s["gp"], s["st"], lr=2e-3,
                           tcfg=s["tcfg"], refresh=refresh)
    assert len(signed) == (len(s["st"].groups) if refresh else 0)
    assert min(signed, default=1.0) >= GAP_MIN
    assert (s2.host_step, s2.refreshes, int(s2.step)) == (5, int(refresh),
                                                          5)
    for mine, ref in zip(s2.groups, js2.groups):
        for f in ("m", "v"):
            _rel_close(getattr(mine, f), getattr(ref, f), 1e-5)
        u, ju = mine.proj.double(), np.asarray(ref.proj, np.float64)
        _rel_close(u @ u.mT, ju @ np.swapaxes(ju, -1, -2), 1e-5)
    if refresh:
        for g, mine, ref in zip(s["jgrads"].groups, s2.groups, js2.groups):
            _basis_close(mine.proj, ref.proj, np.asarray(g, np.float64))
    else:
        for mine, ref in zip(s2.groups, js2.groups):
            _rel_close(mine.proj, ref.proj, 1e-5)
    for mine, ref in zip(p2.groups, jp2.groups):
        _rel_close(mine, ref, 1e-5)
    for mine, ref in zip(p2.dense, jp2.dense):
        _rel_close(mine, ref, 1e-5)
    if not refresh:
        assert all(a.proj is b.proj for a, b in zip(s2.groups,
                                                     s["st"].groups))


# ---------------------------------------------------------------------------
# The Trainers against the reference's
# ---------------------------------------------------------------------------

def _jax_run(jtcfg, jloader, steps_n=7):
    jt = JTrainer(JCFG, jtcfg, jloader)
    start = (_np(jsub.params_of(jt.params)), jt.opt_state)
    losses = []
    for _ in range(steps_n):
        losses += jt.run(1).losses
    return jt, start, losses


def test_galore_trainer_tracks_the_jax_trainer(signed):
    tcfg = TrainConfig(**dict(KW, optimizer="galore"))
    jloader = JLoader("lm", 0, **BATCH)
    _, (params0, jst0), jlosses = _jax_run(
        JTrainConfig(**dict(KW, optimizer="galore")), jloader)
    tr = Trainer(CFG, tcfg, _loader(jloader), device="cpu",
                 params=convert.params_from_numpy(params0, "cpu"))
    tr.params, tr.opt_state = convert.galore_from_numpy(
        params0, tcfg, groups=_np(jst0.groups), dense=_np(jst0.dense),
        device="cpu")
    report = tr.run(7)
    assert tr.opt_state.refreshes == 3 and report.outer_steps == 0
    assert len(signed) == 3 * len(tr.opt_state.groups)
    assert min(signed) >= GAP_MIN
    np.testing.assert_allclose(report.losses, jlosses, rtol=1e-5)
    assert all(np.isfinite(report.losses))


def test_adamw_trainer_tracks_the_jax_trainer():
    kw = dict(KW, optimizer="adamw")
    jloader = JLoader("lm", 0, **BATCH)
    jt, (params0, jst0), jlosses = _jax_run(JTrainConfig(**kw), jloader)
    tr = Trainer(CFG, TrainConfig(**kw), _loader(jloader), device="cpu",
                 params=convert.params_from_numpy(params0, "cpu"))
    tr.params, tr.opt_state = convert.adamw_from_numpy(
        params0, m=_np(jst0.m), v=_np(jst0.v), step=int(jst0.step),
        device="cpu")
    assert isinstance(tr.opt_state, adamw.AdamWState)
    report = tr.run(7)
    np.testing.assert_allclose(report.losses, jlosses, rtol=1e-5)
    assert int(tr.opt_state.step) == int(jt.opt_state.step) == 7
    for path, w in subspace.tree_flatten_with_path(tr.params):
        ref = jt.params
        for k in path:
            ref = ref[k]
        _rel_close(w, ref, 1e-3)


def test_compute_view_casts_floating_leaves_only():
    tree = {"a": torch.ones(2), "b": {"c": torch.arange(3)}}
    assert compute_view(tree, torch.float32) is tree
    view = compute_view(tree, torch.bfloat16)
    assert view["a"].dtype == torch.bfloat16
    assert view["b"]["c"].dtype == torch.int64
    jview = jcompute_view({"a": jnp.ones(2), "b": {"c": jnp.arange(3)}},
                          jnp.bfloat16)
    assert jview["a"].dtype == jnp.bfloat16 and \
        jview["b"]["c"].dtype == jnp.int32


# ---------------------------------------------------------------------------
# LowRank-LR
# ---------------------------------------------------------------------------

def _inject_noise(monkeypatch, queue):
    def injected(state):
        dense, groups = queue.pop(0)
        assert [tuple(d.shape) for d in dense] == [
            tuple(s.m.shape) for s in state.dense]
        assert [tuple(g.shape) for g in groups] == [
            tuple(s.b.shape) for s in state.groups]
        return subspace.Trainable(dense=tuple(_t(d) for d in dense),
                                  groups=tuple(_t(g) for g in groups))
    monkeypatch.setattr(zo, "_sample_noise", injected)


def test_one_lowrank_lr_step_matches_jax(monkeypatch):
    kw = dict(KW, optimizer="lowrank_lr", rank=8)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jparams = jlm.init_params(JCFG, jax.random.key(7))
    jgp, jst = jsub.init_grouped(jparams, jtcfg, jax.random.key(8))
    rng = np.random.default_rng(9)
    jst = dataclasses.replace(jst, groups=tuple(
        s._replace(b=jnp.asarray(0.02 * rng.standard_normal(s.b.shape),
                                 jnp.float32)) for s in jst.groups),
        step=jnp.asarray(2, jnp.int32))
    jbatch = jlm_batch(0, 5, **BATCH)
    key = jax.random.fold_in(jst.key, jst.step)
    jloss, jp2, js2, jgn = jax.jit(
        lambda p, st, b, k: jzo.zo_inner_step(
            jsteps.build_loss_fn(JCFG), p, st, b, k, lr=3e-3, tcfg=jtcfg))(
        jgp, jst, jbatch, key)
    noise = jzo._sample_noise(jst, key)
    _inject_noise(monkeypatch, [(_np(noise.dense), _np(noise.groups))])
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(jgp)), tcfg, groups=_np(jst.groups),
        dense=_np(jst.dense), step=2, device="cpu")
    loss, p2, s2, gn = zo.zo_inner_step(
        steps.build_loss_fn(CFG), gp, st, {k: _t(v) for k, v in
                                           jbatch.items()},
        lr=3e-3, tcfg=tcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    _rel_close(gn, jgn, 1e-3)
    for mine, ref in zip(s2.groups, js2.groups):
        for f in ("b", "m", "v"):
            _rel_close(getattr(mine, f), getattr(ref, f), 1e-5)
    for mine, ref in zip(p2.dense, jp2.dense):
        _rel_close(mine, ref, 1e-5)


def test_lowrank_lr_trainer_tracks_the_jax_trainer_over_two_outer_cycles(
        monkeypatch):
    kw = dict(KW, optimizer="lowrank_lr", rank=8)
    tcfg = TrainConfig(**kw)
    jloader = JLoader("lm", 0, **BATCH)
    jt = JTrainer(JCFG, JTrainConfig(**kw), jloader)
    params0 = _np(jsub.params_of(jt.params))
    groups0, dense0 = _np(jt.opt_state.groups), _np(jt.opt_state.dense)
    jlosses, projs, noises = [], [], []
    for _ in range(7):
        jlosses += jt.run(1).losses
        st = jt.opt_state       # the inner step keeps the key it folded
        noise = jzo._sample_noise(st, jax.random.fold_in(st.key,
                                                          st.step - 1))
        noises.append((_np(noise.dense), _np(noise.groups)))
        projs.append([np.asarray(g.proj) for g in st.groups])

    tr = Trainer(CFG, tcfg, _loader(jloader), device="cpu",
                 params=convert.params_from_numpy(params0, "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, tcfg, groups=groups0, dense=dense0, device="cpu")
    v_queue, n_queue = [], []
    monkeypatch.setattr(
        subspace, "_sample_proj_group",
        lambda name, gen, spec, n, c, dtype, device, energy=None:
        _t(v_queue.pop(0)).to(device, dtype))
    _inject_noise(monkeypatch, n_queue)
    losses, outer = [], 0
    for s in range(7):
        if tr.outer_due():
            v_queue[:] = projs[s]     # the reference's V after this outer
        n_queue[:] = [noises[s]]
        report = tr.run(1)
        losses += report.losses
        outer += report.outer_steps
        assert not v_queue and not n_queue
    assert outer == 2 and int(tr.opt_state.outer_step) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert all(np.isfinite(losses))


def test_zo_noise_comes_from_the_state_generator_in_sequence():
    """Card and CPU runs that share a ``sample_device`` draw the same
    noise: the draws are a function of the generator alone."""
    tcfg = TrainConfig(**dict(KW, optimizer="lowrank_lr"))
    loader = _loader(JLoader("lm", 0, **BATCH))
    a, b = (Trainer(CFG, tcfg, loader, device="cpu") for _ in range(2))
    za, zb = zo._sample_noise(a.opt_state), zo._sample_noise(b.opt_state)
    for x, y in zip(za.dense + za.groups, zb.dense + zb.groups):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert [tuple(z.shape) for z in za.groups] == [
        tuple(s.b.shape) for s in a.opt_state.groups]
    z2 = zo._sample_noise(a.opt_state)
    assert not torch.equal(z2.groups[0], za.groups[0])
