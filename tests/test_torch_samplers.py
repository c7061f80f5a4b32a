"""The port's samplers and MSE theory (``repro_torch.core.samplers``,
``repro_torch.core.mse``) against the JAX package's, on the CPU.

JAX's threefry and torch's generators cannot agree bit for bit, so each
random sampler's deterministic core is fed the very draws JAX made from
its key (its permutation, its uniforms, its start ``u``) and must return
what the reference returns:

* ``waterfill_inclusion_probs``: within 1e-6 of the largest pi (fp32;
  the two packages sum in other orders).  Where those sums leave a capped
  direction one side of 1.0 in one package and the other side in the
  other (the renormalisation's last bit), the ``pi_floor`` step sees
  another capped set: the test then feeds the reference's unfloored pi
  to the port's floor step instead, as a flip is no fault of the floor;
* the coordinate and systematic selections: equal, index for index;
* ``dependent``, ``dependent_from_sigma`` and ``dependent_diag``: the
  same selection, values within 1e-6;
* the closed forms of ``mse``: within 1e-6 relative.

The laws of ``tests/test_core.py`` are held by Monte Carlo, each limit
at six standard deviations of the mean of the draws it averages (the
standard deviation measured from those draws, or binomial where the law
gives it), with an absolute slack of 1e-6 · c for elements that no draw
moves.  A planted fault fails each parity check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import mse as jmse  # noqa: E402
from repro.core import samplers as js  # noqa: E402
from repro_torch.core import mse, samplers  # noqa: E402

Z = 6.0            # Monte-Carlo limits, in standard deviations


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


# pi of its capped direction renormalised to 1.0 by the reference and
# one step under it by the port (their sums of the other pi differ in
# the last bit): the floor step's capped sets then differ
FLIP = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 5.8231920e-01, 4.8734844e-04,
                 1.0220718e-01, 3.1813552e+00, 2.0849368e-01], np.float32)


def _sigma(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "flip":
        return FLIP
    if kind == "ties":
        s = np.ones(n)
    elif kind == "zeros":
        s = rng.exponential(size=n)
        s[: n // 2] = 0.0
    else:
        s = rng.exponential(size=n) ** 3
    return s.astype(np.float32)


# ---------------------------------------------------------------------------
# Water-filling against the reference
# ---------------------------------------------------------------------------

WATERFILL = [("rand", 40, 8, 0), ("rand", 16, 4, 1), ("ties", 16, 4, 2),
             ("zeros", 10, 3, 0), ("zeros", 40, 8, 3), ("flip", 10, 3, 0),
             ("rand", 6, 6, 4), ("rand", 6, 9, 5)]


def _check_waterfill(kind, n, r, seed, pi_floor):
    s = _sigma(kind, n, seed)
    j_raw = np.asarray(js.waterfill_inclusion_probs(jnp.asarray(s), r))
    p_raw = samplers.waterfill_inclusion_probs(_t(s), r).numpy()
    _rel(p_raw, j_raw, 1e-6)
    assert abs(p_raw.sum() - min(r, n)) <= 1e-5 * r
    if not pi_floor:
        return
    jf = np.asarray(js.waterfill_inclusion_probs(jnp.asarray(s), r,
                                                 pi_floor=pi_floor))
    pf = samplers.waterfill_inclusion_probs(_t(s), r,
                                            pi_floor=pi_floor).numpy()
    # the floor step on the reference's own unfloored pi
    _rel(samplers._apply_floor(_t(j_raw), r, pi_floor).numpy(), jf, 1e-6)
    assert pf.min() >= np.float32(pi_floor) and pf.max() <= 1.0
    if ((j_raw >= 1.0) == (p_raw >= 1.0)).all():
        _rel(pf, jf, 1e-6)
    else:
        # a flip: the capped sets differ only where pi lies at 1.0 to
        # the last bits on both sides
        flip = (j_raw >= 1.0) != (p_raw >= 1.0)
        assert (np.abs(j_raw[flip] - 1.0) <= 4e-7).all()
        assert (np.abs(p_raw[flip] - 1.0) <= 4e-7).all()


@pytest.mark.parametrize("pi_floor", [0.0, 0.05])
@pytest.mark.parametrize("kind,n,r,seed", WATERFILL)
def test_waterfill_matches_jax(kind, n, r, seed, pi_floor):
    _check_waterfill(kind, n, r, seed, pi_floor)


def test_waterfill_batched_rows_are_the_single_rows():
    s = np.stack([_sigma(k, 24, i) for i, k in
                  enumerate(("rand", "ties", "zeros"))])
    both = samplers.waterfill_inclusion_probs(_t(s), 5, pi_floor=0.01)
    for i in range(3):
        np.testing.assert_array_equal(
            both[i].numpy(),
            samplers.waterfill_inclusion_probs(_t(s[i]), 5,
                                               pi_floor=0.01).numpy())


def test_waterfill_kkt_structure():
    """Uncapped pi proportional to sqrt(sigma) (Eq. 17), capped at 1."""
    sig = torch.tensor([100.0, 9.0, 4.0, 1.0, 0.25, 0.0])
    pi = samplers.waterfill_inclusion_probs(sig, 3).numpy()
    s = np.sqrt(sig.numpy())
    uncapped = (pi < 1.0 - 1e-6) & (s > 0)
    ratios = pi[uncapped] / s[uncapped]
    assert pi[0] == 1.0 and np.allclose(ratios, ratios[0], rtol=1e-6)
    assert abs(pi.sum() - 3.0) < 1e-5


def test_waterfill_minimises_the_objective():
    """Phi(pi*) <= Phi(pi) for random feasible pi (Theorem 3)."""
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(rng.uniform(0.1, 10.0, size=12))
    r = 4
    phi_star = float(mse.phi_min_dependent(sig, r, 1.0))
    tried = 0
    for _ in range(200):
        x = rng.uniform(0.05, 1.0, size=12)
        x = np.clip(x / x.sum() * r, 1e-3, 1.0)
        x = x / x.sum() * r
        if np.any(x > 1.0):
            continue
        tried += 1
        assert phi_star <= float(mse.phi_min_dependent(
            sig, r, 1.0, pi=torch.from_numpy(x))) + 1e-9
    assert tried > 50


# ---------------------------------------------------------------------------
# Selections against the reference, from JAX's own draws
# ---------------------------------------------------------------------------

def _jax_systematic_draws(key, n):
    kperm, ku = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.permutation(kperm, n))
                             .astype(np.int64)),
            _t(jax.random.uniform(ku, ())))


def _check_systematic(seed):
    rng = np.random.default_rng(seed)
    n, r = 40, 8
    pi = js.waterfill_inclusion_probs(
        jnp.asarray(rng.exponential(size=n).astype(np.float32) ** 2), r)
    key = jax.random.key(seed)
    perm, u = _jax_systematic_draws(key, n)
    want = np.asarray(js.systematic_sample(key, pi, r))
    got = samplers._systematic_from(perm, u, _t(pi), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_systematic_selection_matches_jax(seed):
    _check_systematic(seed)


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_coordinate_matches_jax_given_its_uniforms(c):
    key, n, r = jax.random.key(11), 30, 7
    keys = jax.random.split(key, 5)
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    want = np.asarray(js.coordinate_batched(key, 5, n, r, c=c))
    np.testing.assert_array_equal(
        samplers._coordinate_from(_t(u), r, c=c).numpy(), want)
    one = samplers._coordinate_from(_t(u[2]), r, c=c)
    np.testing.assert_array_equal(one.numpy(), want[2])


def _check_dependent_diag(seed, c=1.0):
    """The batched diagonal-Sigma draw from the reference's per-row keys
    and energies: same selection, values within 1e-6."""
    rng = np.random.default_rng(seed)
    batch, n, r = 4, 32, 6
    e = (rng.exponential(size=(batch, n)) ** 3).astype(np.float32)
    e[1] = 1.0                                   # the warm-up's ties
    key = jax.random.key(seed + 100)
    want = np.asarray(js.dependent_diagonal_batched(key, jnp.asarray(e), r,
                                                    c=c))
    draws = [_jax_systematic_draws(k, n) for k in jax.random.split(key,
                                                                   batch)]
    perm = torch.stack([d[0] for d in draws])
    u = torch.stack([d[1] for d in draws])
    got = samplers._dependent_diagonal_from(perm, u, _t(e), r, c=c).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    _rel(got, want, 1e-6)
    return perm, u, e, got


@pytest.mark.parametrize("seed,c", [(0, 1.0), (1, 1.0), (2, 0.5)])
def test_dependent_diag_matches_jax_given_its_draws(seed, c):
    perm, u, e, got = _check_dependent_diag(seed, c)
    # batched == per row
    for i in range(e.shape[0]):
        np.testing.assert_array_equal(
            samplers._dependent_diagonal_from(perm[i], u[i], _t(e[i]), 6,
                                              c=c).numpy(), got[i])
    # one nonzero per column, in distinct rows
    nz = got != 0
    assert (nz.sum(-2) == 1).all() and (nz.sum(-1) <= 1).all()


def _sym(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return (a @ a.T / n).astype(np.float32)


def test_dependent_matches_jax_given_the_eigenbasis():
    n, r, c = 8, 3, 1.5
    sigma = jnp.asarray(_sym(n, 3))
    evals, evecs = jnp.linalg.eigh(sigma)
    pi = js.waterfill_inclusion_probs(jnp.maximum(evals, 0.0), r)
    for seed in range(4):
        key = jax.random.key(seed)
        perm, u = _jax_systematic_draws(key, n)
        want = np.asarray(js.dependent(key, evecs, pi, r, c=c))
        got = samplers._dependent_from(perm, u, _t(evecs), _t(pi), r,
                                       c=c).numpy()
        _rel(got, want, 1e-6)


def test_dependent_from_sigma_matches_jax_given_the_eigenbasis(
        monkeypatch):
    """The whole of Algorithm 4, with the reference's eigenbasis and
    draws injected (LAPACK's and XLA's eigenvectors may differ in sign)."""
    n, r = 8, 3
    sigma = _sym(n, 4)
    key = jax.random.key(9)
    want = np.asarray(js.dependent_from_sigma(key, jnp.asarray(sigma), r))
    evals, evecs = jnp.linalg.eigh(jnp.asarray(sigma))
    monkeypatch.setattr(torch.linalg, "eigh",
                        lambda m: (_t(evals), _t(evecs)))
    monkeypatch.setattr(samplers, "_draw_systematic",
                        lambda gen, lead, n, device:
                        _jax_systematic_draws(key, n))
    got = samplers.dependent_from_sigma(torch.Generator(), _t(sigma),
                                        r).numpy()
    _rel(got, want, 1e-6)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_registry_names_and_refusals():
    assert samplers.available() == js.available()
    assert samplers.available_batched() == js.available_batched()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="available: coordinate, dependent, "
                                         "dependent_diag, gaussian"):
        samplers.sample_v("haar", gen, 8, 2)
    with pytest.raises(ValueError, match="unknown batched sampler"):
        samplers.sample_v_batched("dependent", gen, 2, 8, 2)
    for name in samplers.available_batched():
        kw = ({"diag_energy": torch.rand(3, 16, generator=gen)}
              if name == "dependent_diag" else {})
        v = samplers.sample_v_batched(name, gen, 3, 16, 4,
                                      dtype=torch.bfloat16, **kw)
        assert v.shape == (3, 16, 4) and v.dtype == torch.bfloat16
    v = samplers.sample_v("dependent", gen, 8, 3,
                          sigma_mat=torch.from_numpy(_sym(8, 1)))
    assert v.shape == (8, 3)


# ---------------------------------------------------------------------------
# Laws, by Monte Carlo (the port's own generators)
# ---------------------------------------------------------------------------

def _draws(name, k, n, r, c, seed=0, energy=None):
    gen = torch.Generator().manual_seed(seed)
    kw = {}
    if name == "dependent_diag":
        kw["diag_energy"] = energy.expand(k, n)
    return samplers.sample_v_batched(name, gen, k, n, r, c=c, **kw).double()


def _mean_within(samples, want, c):
    """The mean of ``samples`` (k, ...) within Z standard deviations of
    its own mean of ``want``, plus 1e-6 · c."""
    k = samples.shape[0]
    mean, sd = samples.mean(0), samples.std(0)
    bad = (mean - want).abs() > Z * sd / k ** 0.5 + 1e-6 * c
    assert not bad.any(), (mean - want).abs().max()


# non-uniform, with capped directions; no zero (its pi is 1e-12, so no
# feasible draw count ever selects it, while its lift weight is 1e6)
ENERGY = torch.tensor([50.0, 20.0, 9.0, 4.0, 2.0, 1.0, 0.5, 0.25, 0.1,
                       0.05, 0.02, 0.01], dtype=torch.float32)


@pytest.mark.parametrize("name", ["gaussian", "stiefel", "coordinate",
                                  "dependent_diag"])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_sampler_isotropy(name, c):
    """E[V Vᵀ] = c I (Definition 3); dependent_diag on a non-uniform
    energy with capped directions."""
    n, r, k = 12, 4, 6000
    vs = _draws(name, k, n, r, c, energy=ENERGY)
    _mean_within(vs @ vs.mT, c * torch.eye(n, dtype=torch.float64), c)


@pytest.mark.parametrize("name", ["stiefel", "coordinate"])
def test_theorem2_condition_exact(name):
    """Vᵀ V = (c n / r) I_r for every draw."""
    n, r, c = 20, 5, 0.7
    v = _draws(name, 5, n, r, c)
    np.testing.assert_allclose((v.mT @ v).numpy(), np.broadcast_to(
        (c * n / r) * np.eye(r), (5, r, r)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["stiefel", "coordinate"])
def test_theorem2_trace_optimal(name):
    """tr(P²) = n² c² / r for every draw of an optimal sampler."""
    n, r, c = 16, 4, 1.0
    v = _draws(name, 3, n, r, c)
    p = v @ v.mT
    tr = torch.diagonal(p @ p, dim1=-2, dim2=-1).sum(-1)
    np.testing.assert_allclose(tr.numpy(), mse.trace_ep2_optimal(n, r, c),
                               rtol=1e-5)


def test_gaussian_trace_is_strictly_worse():
    """Gaussian: tr E[P²] = c² n (n + r + 1) / r (Remark 1), above the
    optimum by 1.4x here."""
    n, r, c, k = 10, 3, 1.0, 8000
    v = _draws("gaussian", k, n, r, c, seed=1)
    p = v @ v.mT
    tr = torch.diagonal(p @ p, dim1=-2, dim2=-1).sum(-1)
    _mean_within(tr, mse.trace_ep2_gaussian(n, r, c), c)
    assert tr.mean() > 1.2 * mse.trace_ep2_optimal(n, r, c)


def test_systematic_marginals_and_fixed_size():
    """Pr(i in J) = pi_i, r distinct indices each draw (binomial sd)."""
    rng = np.random.default_rng(1)
    n, r, k = 10, 4, 20000
    pi = torch.from_numpy(rng.uniform(0.1, 1.0, size=n)).float()
    pi = samplers.waterfill_inclusion_probs(pi ** 2, r)
    gen = torch.Generator().manual_seed(2)
    idx = samplers.systematic_sample(gen, pi.expand(k, n), r)
    assert idx.shape == (k, r)
    assert (idx.sort(-1).values.diff(dim=-1) > 0).all()
    freq = torch.bincount(idx.reshape(-1), minlength=n).double() / k
    sd = (pi.double() * (1 - pi.double()) / k).sqrt()
    assert ((freq - pi.double()).abs() <= Z * sd + 1e-9).all()


def test_theorem3_optimality_conditions():
    """Algorithm 4: E[P] = c I and diag(Qᵀ E[P²] Q) = c² / pi (Eq. 18)."""
    n, r, c, k = 8, 3, 1.0, 20000
    sigma = torch.from_numpy(_sym(n, 3)).double()
    evals, evecs = torch.linalg.eigh(sigma)
    pi = samplers.waterfill_inclusion_probs(torch.clamp(evals, min=0.0), r)
    gen = torch.Generator().manual_seed(4)
    perm, u = samplers._draw_systematic(gen, (k,), n, "cpu")
    idx = samplers._systematic_from(perm, u, pi.expand(k, n), r)
    w = torch.sqrt(c / pi[idx])
    vs = evecs[:, idx].permute(1, 0, 2) * w[:, None, :]
    p = vs @ vs.mT
    _mean_within(p, c * torch.eye(n, dtype=torch.float64), c)
    q2 = torch.diagonal(evecs.T @ (p @ p) @ evecs, dim1=-2, dim2=-1)
    _mean_within(q2, c ** 2 / pi, c)


# ---------------------------------------------------------------------------
# MSE closed forms against the reference
# ---------------------------------------------------------------------------

def _mse_inputs(n=8, r=3, seed=0):
    rng = np.random.default_rng(seed)
    xi, th = _sym(n, seed), _sym(n, seed + 1) * 0.3
    e_p2 = _sym(n, seed + 2) + n * np.eye(n, dtype=np.float32)
    return xi, th, e_p2, rng


MSE_FORMS = {
    "mse_decomposition": lambda m, xi, th, e, n, r, c, pi: m.mse_decomposition(
        xi, th, e, c)["total"],
    "mse_decomposition_t2": lambda m, xi, th, e, n, r, c, pi:
        m.mse_decomposition(xi, th, e, c)["projection_variance"],
    "trace_ep2_optimal": lambda m, xi, th, e, n, r, c, pi:
        m.trace_ep2_optimal(n, r, c),
    "trace_ep2_gaussian": lambda m, xi, th, e, n, r, c, pi:
        m.trace_ep2_gaussian(n, r, c),
    "mse_full_rank": lambda m, xi, th, e, n, r, c, pi: m.mse_full_rank(xi),
    "mse_gaussian": lambda m, xi, th, e, n, r, c, pi: m.mse_gaussian(
        xi, th, n, r),
    "mse_isotropic_optimal": lambda m, xi, th, e, n, r, c, pi:
        m.mse_isotropic_optimal(xi, th, n, r, c),
    "phi_min_dependent": lambda m, xi, th, e, n, r, c, pi:
        m.phi_min_dependent(np.diag(xi) + 0.0, r, c),
    "phi_min_dependent_pi": lambda m, xi, th, e, n, r, c, pi:
        m.phi_min_dependent(np.diag(xi) + 0.0, r, c, pi=pi),
    "mse_dependent_optimal": lambda m, xi, th, e, n, r, c, pi:
        m.mse_dependent_optimal(xi, th, r, c),
}


def _check_mse(name, c=0.8):
    xi, th, e, rng = _mse_inputs()
    n, r = xi.shape[0], 3
    pi = np.full(n, r / n, np.float32)
    want = float(MSE_FORMS[name](jmse, *map(jnp.asarray, (xi, th, e)), n, r,
                                 c, jnp.asarray(pi)))
    got = MSE_FORMS[name](mse, *map(_t, (xi, th, e)), n, r, c, _t(pi))
    got = float(got)
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize("name", sorted(MSE_FORMS))
def test_mse_closed_forms_match_jax(name):
    _check_mse(name)


def test_empirical_moments_match_jax():
    vs = np.random.default_rng(5).normal(size=(50, 9, 3)).astype(np.float32)
    _rel(mse.empirical_ep(_t(vs)).numpy(),
         np.asarray(jmse.empirical_ep(jnp.asarray(vs))), 1e-6)
    _rel(mse.empirical_ep2(_t(vs)).numpy(),
         np.asarray(jmse.empirical_ep2(jnp.asarray(vs))), 1e-6)


def test_mse_forms_order_the_samplers():
    """Remark 1 and Theorems 2-3 on one instance: full rank < dependent
    optimum < isotropic optimum < Gaussian."""
    xi, th, _, _ = _mse_inputs(n=10, seed=7)
    xi, th = _t(xi), _t(th)
    n, r = 10, 3
    dep = mse.mse_dependent_optimal(xi, th, r, 1.0)
    iso = mse.mse_isotropic_optimal(xi, th, n, r, 1.0)
    gau = mse.mse_gaussian(xi, th, n, r)
    assert mse.mse_full_rank(xi) < dep < iso < gau
    assert dep.dtype == iso.dtype == torch.float64


# ---------------------------------------------------------------------------
# Planted faults: each parity check above fails on a broken port
# ---------------------------------------------------------------------------

def _scaled(fn, by):
    return lambda *a, **k: fn(*a, **k) * by


def test_planted_fault_pi_scaled_fails_waterfill(monkeypatch):
    monkeypatch.setattr(samplers, "waterfill_inclusion_probs", _scaled(
        samplers.waterfill_inclusion_probs, 1.001))
    with pytest.raises(AssertionError):
        _check_waterfill("rand", 40, 8, 0, 0.0)


def test_planted_fault_pi_scaled_fails_dependent_diag(monkeypatch):
    monkeypatch.setattr(samplers, "waterfill_inclusion_probs", _scaled(
        samplers.waterfill_inclusion_probs, 1.001))
    with pytest.raises(AssertionError):
        _check_dependent_diag(0)


def test_planted_fault_start_reflected_fails_systematic(monkeypatch):
    orig = samplers._systematic_from
    monkeypatch.setattr(samplers, "_systematic_from",
                        lambda perm, u, pi, r: orig(perm, 1.0 - u, pi, r))
    with pytest.raises(AssertionError):
        _check_systematic(0)


def test_planted_fault_fails_mse(monkeypatch):
    monkeypatch.setattr(mse, "mse_gaussian",
                        _scaled(mse.mse_gaussian, 1.0 + 1e-5))
    with pytest.raises(AssertionError):
        _check_mse("mse_gaussian")
