"""The port's low-rank gradient estimators (``repro_torch.core.
estimators``) against the JAX package's, on the CPU.

Each estimator is given the same ``theta``, ``V`` and ``Z`` (numpy
arrays from a seed) on both sides and must agree within 1e-5 of the
largest entry (fp32; autodiff and sums in other orders).  Weak
unbiasedness (Theorem 1) is held by Monte Carlo over the port's own
samplers, each limit at six standard deviations of the mean measured
from the draws.  A planted fault fails the parity check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro_torch.core import estimators, samplers  # noqa: E402

Z = 6.0


def _quadratic(m=6, n=10, seed=0):
    """A quadratic loss, its point and its exact gradient, in numpy."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    theta = rng.normal(size=(m, n)).astype(np.float32)
    return a, theta, theta - a


def _losses(a):
    """The same nonlinear loss in both packages (a quadratic plus a
    quartic term, so the two-point estimates are not exact)."""
    def jloss(th):
        d = th - jnp.asarray(a)
        return 0.5 * jnp.sum(d ** 2) + 0.1 * jnp.sum(d ** 4)

    def tloss(th):
        d = th - torch.from_numpy(a)
        return 0.5 * (d ** 2).sum() + 0.1 * (d ** 4).sum()
    return jloss, tloss


def _inputs(seed=0, r=3):
    """Inputs of the parity checks.  ``theta`` lies near the loss's
    minimum, so a loss value is small beside its change along ``Z Vᵀ``:
    the two-point estimates divide that change by 2σ, and fp32 sums of
    the loss taken in other orders (about 1e-7 of its value) would
    otherwise outweigh the limit."""
    a, _, _ = _quadratic(seed=seed)
    rng = np.random.default_rng(seed + 10)
    theta = (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    v = (np.asarray(jax.random.normal(jax.random.key(seed), (10, r)))
         / np.sqrt(r)).astype(np.float32)
    z = rng.normal(size=(6, r)).astype(np.float32)
    z_full = rng.normal(size=(6, 10)).astype(np.float32)
    return a, theta, v, z, z_full


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


ESTIMATORS = {
    "ipa_full": lambda e, loss, th, v, z, zf: e.ipa_full(loss, th),
    "lowrank_ipa_bgrad": lambda e, loss, th, v, z, zf:
        e.lowrank_ipa_bgrad(loss, th, v),
    "lowrank_ipa": lambda e, loss, th, v, z, zf: e.lowrank_ipa(loss, th, v),
    "lowrank_lr_1pt": lambda e, loss, th, v, z, zf:
        e.lowrank_lr_1pt(loss, th, v, z, 1e-2, baseline=0.5),
    "lowrank_lr_2pt_bgrad": lambda e, loss, th, v, z, zf:
        e.lowrank_lr_2pt_bgrad(loss, th, v, z, 1e-2),
    "lowrank_lr_2pt": lambda e, loss, th, v, z, zf:
        e.lowrank_lr_2pt(loss, th, v, z, 1e-2),
    "lr_full_2pt": lambda e, loss, th, v, z, zf:
        e.lr_full_2pt(loss, th, zf, 1e-2),
}


def _check_estimator(name, seed=0):
    a, theta, v, z, zf = _inputs(seed)
    jloss, tloss = _losses(a)
    want = ESTIMATORS[name](jest, jloss, *map(jnp.asarray, (theta, v, z,
                                                            zf)))
    got = ESTIMATORS[name](estimators, tloss,
                           *map(torch.from_numpy, (theta, v, z, zf)))
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimator_matches_jax(name, seed):
    _check_estimator(name, seed)


def test_pytree_bgrad_matches_jax():
    """The production path: one B per matrix leaf, a dense leaf (V None)
    gets its full gradient."""
    rng = np.random.default_rng(3)
    tree = {"blk": {"w": rng.normal(size=(6, 10)).astype(np.float32),
                    "u": rng.normal(size=(4, 8)).astype(np.float32)},
            "norm": rng.normal(size=(5,)).astype(np.float32)}
    vs = {"blk": {"w": rng.normal(size=(10, 3)).astype(np.float32),
                  "u": rng.normal(size=(8, 2)).astype(np.float32)},
          "norm": None}

    def jloss(p):
        return jnp.sum(jnp.tanh(p["blk"]["w"]) ** 2) + \
            jnp.sum(p["blk"]["u"] ** 3) + jnp.sum(p["norm"] ** 2)

    def tloss(p):
        return (torch.tanh(p["blk"]["w"]) ** 2).sum() + \
            (p["blk"]["u"] ** 3).sum() + (p["norm"] ** 2).sum()

    jl, jg = jest.lowrank_ipa_pytree_bgrad(
        jloss, jax.tree.map(jnp.asarray, tree),
        {"blk": jax.tree.map(jnp.asarray, vs["blk"]), "norm": None})
    tl, tg = estimators.lowrank_ipa_pytree_bgrad(
        tloss, {"blk": {k: torch.from_numpy(x)
                        for k, x in tree["blk"].items()},
                "norm": torch.from_numpy(tree["norm"])},
        {"blk": {k: torch.from_numpy(x) for k, x in vs["blk"].items()},
         "norm": None})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("w", "u"):
        assert tg["blk"][k].shape == (tree["blk"][k].shape[0],
                                      vs["blk"][k].shape[1])
        _close(tg["blk"][k], jg["blk"][k])
    _close(tg["norm"], jg["norm"])


def test_ipa_bgrad_is_the_projected_gradient_and_theta_gets_none():
    """G_B = ∇F(theta) V exactly (the chain rule of Theorem 1's proof);
    theta itself is never differentiated."""
    a, theta, g = _quadratic()
    th = torch.from_numpy(theta).requires_grad_()
    v = samplers.stiefel(torch.Generator().manual_seed(6), 10, 4)
    gb = estimators.lowrank_ipa_bgrad(
        lambda t: 0.5 * ((t - torch.from_numpy(a)) ** 2).sum(), th, v)
    np.testing.assert_allclose(gb.numpy(), g @ v.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert th.grad is None


def _mean_within(samples, want):
    k = samples.shape[0]
    mean, sd = samples.mean(0), samples.std(0)
    assert ((mean - want).abs() <= Z * sd / k ** 0.5 + 1e-9).all(), \
        (mean - want).abs().max()


@pytest.mark.parametrize("name,c", [("stiefel", 1.0), ("coordinate", 1.0),
                                    ("gaussian", 1.0), ("stiefel", 0.5),
                                    ("dependent_diag", 1.0)])
def test_lowrank_ipa_is_weakly_unbiased(name, c):
    """E[ĝ] = c ∇F (Theorem 1) over the sampler's law."""
    a, theta, g = _quadratic()
    n, r, k = 10, 3, 4000
    gen = torch.Generator().manual_seed(5)
    kw = ({"diag_energy": torch.linspace(5.0, 0.1, n).expand(k, n)}
          if name == "dependent_diag" else {})
    vs = samplers.sample_v_batched(name, gen, k, n, r, c=c, **kw).double()
    # the quadratic's estimate is ∇F V Vᵀ for every draw
    est = torch.from_numpy(g).double() @ (vs @ vs.mT)
    _mean_within(est, c * torch.from_numpy(g).double())


def test_lowrank_lr_2pt_is_weakly_unbiased_as_sigma_vanishes():
    """The two-point estimate of a quadratic is exact in sigma: its mean
    over Z and V is c ∇F."""
    a, theta, g = _quadratic(m=4, n=6, seed=1)
    n, r, k, sigma = 6, 3, 4000, 1e-3
    gen = torch.Generator().manual_seed(7)
    vs = samplers.stiefel_batched(gen, k, n, r).double()
    zs = torch.randn((k, 4, r), generator=gen, dtype=torch.float64)
    a64, th64 = torch.from_numpy(a).double(), torch.from_numpy(theta).double()
    est = torch.stack([estimators.lowrank_lr_2pt(
        lambda t: 0.5 * ((t - a64) ** 2).sum(), th64, vs[i], zs[i], sigma)
        for i in range(k)])
    _mean_within(est, torch.from_numpy(g).double())


def test_planted_fault_fails_the_estimator_parity(monkeypatch):
    orig = estimators.lowrank_ipa_bgrad
    monkeypatch.setattr(estimators, "lowrank_ipa_bgrad",
                        lambda loss, th, v: orig(loss, th, v) * 1.0001)
    with pytest.raises(AssertionError):
        _check_estimator("lowrank_ipa_bgrad")
