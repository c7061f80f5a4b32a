"""Random projection samplers for low-rank gradient estimation.

Counterpart of ``repro.core.samplers``, the paper's Algorithms 2-4:

* :func:`gaussian` - the i.i.d. Gaussian projection, entries N(0, c/r)
  (the suboptimal baseline of Remark 1);
* :func:`stiefel` - the Haar-Stiefel sampler (Algorithm 2): thin QR of
  a Gaussian with the sign fix that makes the law exactly Haar on
  St(n, r), scaled by ``alpha = sqrt(c n / r)``;
* :func:`coordinate` - the coordinate-axis sampler (Algorithm 3): r of
  the n coordinates uniformly without replacement, scaled by alpha;
* :func:`dependent` - the instance-dependent optimal sampler (Algorithm
  4): eigen-directions of Sigma included with the water-filling
  probabilities pi* of Theorem 3 (:func:`waterfill_inclusion_probs`)
  through a fixed-size systematic pi-ps design
  (:func:`systematic_sample`), each lifted by ``sqrt(c / pi*_i)``;
  :func:`dependent_diagonal` is its diagonal-Sigma form, the
  ``dependent_diag`` sampler of training.

Every sampler returns ``V`` (n, r) with ``E[V Vᵀ] = c I_n``; Stiefel and
coordinate also have ``Vᵀ V = (c n / r) I_r`` exactly (Theorem 2).

Draws come from an explicit ``torch.Generator``.  JAX's threefry and
torch's generators give different numbers from the same seed, so each
random sampler is split into its draw (uniforms, a permutation, one
start ``u``, made in fp32 on the generator's device) and a
deterministic core that takes those draws (:func:`_coordinate_from`,
:func:`_systematic_from`, :func:`_dependent_from`,
:func:`_dependent_diagonal_from`): fed the very draws JAX made from its
key, the core returns what the reference returns.  Every result is
cast once to ``dtype``.

Nothing here has a shape that depends on the data and nothing reads a
value back to the host: water-filling is a stable sort, a suffix sum, an
``argmax`` of the feasibility mask and a scatter; the systematic draw a
cumulative sum and ``searchsorted``.  So the card draws ``coordinate``
and ``dependent_diag`` without a host sync.
"""
from __future__ import annotations


import torch


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device)


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                      device=gen.device)


def _as(dt: torch.dtype, x: float) -> float:
    """``x`` rounded to ``dt``, as the reference's weakly typed Python
    constants are: comparisons and clamps then see one value."""
    return float(torch.tensor(x, dtype=dt))


def _alpha(x: float) -> float:
    """``sqrt(x)`` taken in fp32, as the reference's ``jnp.sqrt`` of a
    Python number."""
    return float(torch.sqrt(torch.tensor(x, dtype=torch.float32)))


# ---------------------------------------------------------------------------
# Instance-independent samplers
# ---------------------------------------------------------------------------

def gaussian_batched(gen: torch.Generator, batch: int, n: int, r: int,
                     c: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """(batch, n, r) independent Gaussian projections, entries N(0, c/r):
    ``E[V Vᵀ] = c I``, but ``tr E[P²] = c² n (n + r + 1) / r``, above the
    optimum (Remark 1)."""
    return (_alpha(c / r) * _normal(gen, (batch, n, r))).to(dtype)


def stiefel_batched(gen: torch.Generator, batch: int, n: int, r: int,
                    c: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """(batch, n, r) independent Haar–Stiefel projections (one row per
    group member): one Gaussian draw and one batched thin QR."""
    q, rmat = torch.linalg.qr(_normal(gen, (batch, n, r)), mode="reduced")
    d = torch.sign(torch.diagonal(rmat, dim1=-2, dim2=-1))
    d = torch.where(d == 0, 1.0, d)               # measure-zero guard
    # the QR may hand back column-major factors (it does on CUDA); the
    # kernels read V row-major
    v = _alpha(c * n / r) * (q * d[..., None, :])
    return v.to(dtype).contiguous()


def _coordinate_from(u: torch.Tensor, r: int, c: float = 1.0,
                     dtype=torch.float32) -> torch.Tensor:
    """The coordinate sampler's core: ``u`` (..., n) i.i.d. uniforms; the
    r coordinates first in their stable ascending order are selected
    (a uniform permutation truncated to r), each scaled by alpha."""
    n = u.shape[-1]
    idx = torch.argsort(u, dim=-1, stable=True)[..., :r]
    v = torch.zeros(u.shape[:-1] + (n, r), dtype=dtype, device=u.device)
    alpha = torch.full(idx.shape, _alpha(c * n / r), dtype=dtype,
                       device=u.device)
    return v.scatter_(-2, idx.unsqueeze(-2), alpha.unsqueeze(-2))


def coordinate_batched(gen: torch.Generator, batch: int, n: int, r: int,
                       c: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """(batch, n, r) coordinate-axis projections (Algorithm 3)."""
    return _coordinate_from(_uniform(gen, (batch, n)), r, c, dtype)


def gaussian(gen: torch.Generator, n: int, r: int, c: float = 1.0,
             dtype=torch.float32) -> torch.Tensor:
    """One (n, r) Gaussian projection."""
    return gaussian_batched(gen, 1, n, r, c=c, dtype=dtype)[0]


def stiefel(gen: torch.Generator, n: int, r: int, c: float = 1.0,
            dtype=torch.float32) -> torch.Tensor:
    """One (n, r) Haar–Stiefel projection (Algorithm 2)."""
    return stiefel_batched(gen, 1, n, r, c=c, dtype=dtype)[0]


def coordinate(gen: torch.Generator, n: int, r: int, c: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    """One (n, r) coordinate-axis projection (Algorithm 3)."""
    return coordinate_batched(gen, 1, n, r, c=c, dtype=dtype)[0]


# ---------------------------------------------------------------------------
# Theorem 3: water-filling inclusion probabilities
# ---------------------------------------------------------------------------

def waterfill_inclusion_probs(sigma: torch.Tensor, r: int,
                              pi_floor: float = 0.0) -> torch.Tensor:
    """Eq. (17), ``pi*_i = min{1, (r - t) sqrt(sigma_i) / sum_{pi<1}
    sqrt(sigma_j)}``, for each row of ``sigma`` (..., n) (nonnegative
    eigenvalues of Sigma, any order).  Returns pi* with ``sum = r`` and
    ``0 < pi*_i <= 1``.

    The reference's arithmetic, step for step: fp32 (float64 for a
    float64 ``sigma``, as the reference with x64 on), sqrt(sigma) in a
    *stable* descending order (ties keep their index order), the
    smallest feasible number ``t`` of capped directions as the first
    true of the feasibility mask, zero-sigma directions given the
    residual mass uniformly, a renormalisation to ``sum = r`` and, with
    ``pi_floor > 0``, every pi floored and the uncapped mass shrunk so
    that ``sum = r`` still holds.
    """
    dt = torch.float64 if sigma.dtype == torch.float64 else torch.float32
    sigma = sigma.to(dt)
    n = sigma.shape[-1]
    if r >= n:
        return torch.ones_like(sigma)
    s = torch.sqrt(torch.clamp(sigma, min=0.0))
    s_sorted, order = torch.sort(s, dim=-1, descending=True, stable=True)
    # suffix sums suf[t] = sum_{j >= t} s_sorted[j]
    suf = torch.flip(torch.cumsum(torch.flip(s_sorted, (-1,)), -1), (-1,))
    t_cand = torch.arange(n, device=s.device)
    denom = torch.clamp(suf, min=1e-30)
    largest_uncapped = (r - t_cand) * s_sorted / denom
    feasible = (largest_uncapped <= _as(dt, 1.0 + 1e-12)) & (t_cand <= r)
    t = torch.argmax(feasible.to(torch.int32), dim=-1, keepdim=True)
    scale = (r - t) / torch.clamp(torch.gather(suf, -1, t), min=1e-30)
    pi_sorted = torch.where(t_cand < t, 1.0,
                            torch.clamp(scale * s_sorted, max=1.0))
    resid = r - pi_sorted.sum(-1, keepdim=True)
    zero = s_sorted <= 0.0
    nzero = zero.sum(-1, keepdim=True)
    add = torch.where(zero, resid / torch.clamp(nzero, min=1), 0.0)
    pi_sorted = torch.clamp(pi_sorted + add, 1e-12, 1.0)
    total = pi_sorted.sum(-1, keepdim=True)
    pi_sorted = pi_sorted * (torch.full_like(total, r) / total)
    pi_sorted = torch.clamp(pi_sorted, 1e-12, 1.0)
    if pi_floor > 0.0:
        pi_sorted = _apply_floor(pi_sorted, r, pi_floor)
    return torch.empty_like(pi_sorted).scatter_(-1, order, pi_sorted)


def _apply_floor(pi: torch.Tensor, r: int, pi_floor: float) -> torch.Tensor:
    """The training option of :func:`waterfill_inclusion_probs`: bound the
    lift weights ``c / pi`` at ``c / pi_floor`` by flooring every pi, then
    shrink the uncapped mass above the floor so that ``sum = r`` still
    holds (a slight departure from the optimum, bounded by ``pi_floor
    n``; ``E[P] = c I`` holds regardless, since the lift weight is always
    ``c / pi_used``).  Elementwise but for two sums, so any order of
    ``pi`` (..., n) gives the same result up to their rounding."""
    dt = pi.dtype
    pi_floor = _as(dt, pi_floor)
    pi = torch.clamp(pi, min=pi_floor)
    capped = pi >= _as(dt, 1.0 - 1e-9)
    free = ~capped & (pi > pi_floor)
    excess = pi.sum(-1, keepdim=True) - r
    free_mass = torch.where(free, pi, 0.0).sum(-1, keepdim=True)
    shrink = torch.where(
        free_mass > 0, 1.0 - excess / torch.clamp(free_mass, min=1e-30), 1.0)
    pi = torch.where(free, pi * shrink, pi)
    return torch.clamp(pi, pi_floor, 1.0)


def _systematic_from(perm: torch.Tensor, u: torch.Tensor, pi: torch.Tensor,
                     r: int) -> torch.Tensor:
    """Madow's systematic pi-ps draw, given its draws: ``perm`` (..., n) a
    permutation of the indices, ``u`` (...) one uniform start.  Selects
    the indices whose cumulative interval holds one of the points
    ``u', u' + T/r, ...`` (``T`` the total, ``u' = u T / r``): fixed
    size r, ``Pr(i in J) = pi_i``.  Returns (..., r) int64 indices."""
    n = pi.shape[-1]
    p = torch.gather(pi, -1, perm)
    csum = torch.cumsum(p, -1)
    total = csum[..., -1:]
    step = total / torch.full_like(total, r)      # guards fp drift
    points = u[..., None] * step + step * torch.arange(
        r, device=pi.device)
    sel = torch.searchsorted(csum.contiguous(), points.contiguous(),
                             right=True)
    return torch.gather(perm, -1, torch.clamp(sel, 0, n - 1))


def _draw_systematic(gen: torch.Generator, lead, n: int, device):
    """The systematic design's draws for ``lead`` rows: a uniform
    permutation of n (argsort of uniforms) and one start each, made on the
    generator's device and moved to ``device``."""
    perm = torch.argsort(_uniform(gen, tuple(lead) + (n,)), dim=-1,
                         stable=True)
    u = _uniform(gen, tuple(lead))
    return perm.to(device), u.to(device)


def systematic_sample(gen: torch.Generator, pi: torch.Tensor,
                      r: int) -> torch.Tensor:
    """Fixed-size systematic pi-ps sample of each row of ``pi`` (..., n)
    (``sum = r``): (..., r) int64 indices, ``Pr(i in J) = pi_i``."""
    perm, u = _draw_systematic(gen, pi.shape[:-1], pi.shape[-1], pi.device)
    return _systematic_from(perm, u, pi, r)


def _lift(pi_sel: torch.Tensor, c: float) -> torch.Tensor:
    """The lift weights ``sqrt(c / pi)`` (true divisions: torch takes
    ``c / t`` as ``c * (1 / t)``)."""
    return torch.sqrt(torch.full_like(pi_sel, c)
                      / torch.clamp(pi_sel, min=1e-12))


def _dependent_from(perm, u, eigvecs: torch.Tensor, pi: torch.Tensor,
                    r: int, c: float = 1.0,
                    dtype=torch.float32) -> torch.Tensor:
    """Algorithm 4's core, given the systematic draws: the selected
    eigenvectors (columns of ``eigvecs``), each lifted by ``sqrt(c /
    pi_i)``."""
    idx = _systematic_from(perm, u, pi, r)
    cols = eigvecs[:, idx]
    return (cols * _lift(pi[idx], c)[None, :]).to(dtype)


def dependent(gen: torch.Generator, eigvecs: torch.Tensor, pi: torch.Tensor,
              r: int, c: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Instance-dependent optimal sampler (Algorithm 4) given the
    eigenbasis ``eigvecs`` (n, n; columns the eigenvectors of Sigma) and
    the inclusion probabilities ``pi`` (:func:`waterfill_inclusion_probs`):
    ``E[V Vᵀ] = c I`` and ``E[Qᵀ P² Q] = c² diag(1/pi)``."""
    perm, u = _draw_systematic(gen, (), pi.shape[-1], pi.device)
    return _dependent_from(perm, u, eigvecs, pi, r, c, dtype)


def dependent_from_sigma(gen: torch.Generator, sigma_mat: torch.Tensor,
                         r: int, c: float = 1.0,
                         dtype=torch.float32) -> torch.Tensor:
    """The whole of Algorithm 4: eigendecompose Sigma, water-fill,
    sample."""
    evals, evecs = torch.linalg.eigh(sigma_mat)
    pi = waterfill_inclusion_probs(torch.clamp(evals, min=0.0), r)
    return dependent(gen, evecs, pi, r, c=c, dtype=dtype)


def _dependent_diagonal_from(perm, u, diag_energy: torch.Tensor, r: int,
                             c: float = 1.0,
                             dtype=torch.float32) -> torch.Tensor:
    """The diagonal-Sigma Algorithm 4's core for each row of
    ``diag_energy`` (..., n): water-fill, the systematic selection, and
    ``sqrt(c / pi_i)`` scattered at (selected row, column j)."""
    n = diag_energy.shape[-1]
    pi = waterfill_inclusion_probs(torch.clamp(diag_energy, min=0.0), r)
    idx = _systematic_from(perm, u, pi, r)
    w = _lift(torch.gather(pi, -1, idx), c).to(dtype)
    v = torch.zeros(diag_energy.shape[:-1] + (n, r), dtype=dtype,
                    device=diag_energy.device)
    return v.scatter_(-2, idx.unsqueeze(-2), w.unsqueeze(-2))


def dependent_diagonal_batched(gen: torch.Generator,
                               diag_energy: torch.Tensor, r: int,
                               c: float = 1.0,
                               dtype=torch.float32) -> torch.Tensor:
    """(batch, n, r): one diagonal-Sigma Algorithm 4 draw per row of
    ``diag_energy`` (batch, n), a running estimate of diag(Sigma).  The
    eigenbasis is the coordinate basis, so no n × n eigendecomposition is
    needed: a pi-ps coordinate sampler with lift weights sqrt(c / pi).
    The draws come from ``gen``; the water-filling runs on the energy's
    device."""
    perm, u = _draw_systematic(gen, diag_energy.shape[:-1],
                               diag_energy.shape[-1], diag_energy.device)
    return _dependent_diagonal_from(perm, u, diag_energy, r, c, dtype)


def dependent_diagonal(gen: torch.Generator, diag_energy: torch.Tensor,
                       r: int, c: float = 1.0,
                       dtype=torch.float32) -> torch.Tensor:
    """One (n, r) diagonal-Sigma Algorithm 4 draw from ``diag_energy``
    (n,)."""
    return dependent_diagonal_batched(gen, diag_energy[None], r, c=c,
                                      dtype=dtype)[0]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SAMPLERS = {
    "gaussian": gaussian,
    "stiefel": stiefel,
    "coordinate": coordinate,
}

_BATCHED = {
    "gaussian": gaussian_batched,
    "stiefel": stiefel_batched,
    "coordinate": coordinate_batched,
}


def available() -> tuple:
    """Every sampler name :func:`sample_v` accepts, sorted; unknown names
    raise listing these."""
    return tuple(sorted(tuple(SAMPLERS) + ("dependent", "dependent_diag")))


def available_batched() -> tuple:
    """Sampler names :func:`sample_v_batched` accepts (``dependent``
    needs a full Sigma eigendecomposition and has no batched form)."""
    return tuple(sorted(tuple(SAMPLERS) + ("dependent_diag",)))


def sample_v_batched(name: str, gen: torch.Generator, batch: int, n: int,
                     r: int, c: float = 1.0, dtype=torch.float32,
                     diag_energy=None) -> torch.Tensor:
    """One (batch, n, r) draw for a whole group of same-shape leaves
    (``dependent_diag`` with ``diag_energy`` (batch, n))."""
    if name in _BATCHED:
        return _BATCHED[name](gen, batch, n, r, c=c, dtype=dtype)
    if name == "dependent_diag":
        return dependent_diagonal_batched(gen, diag_energy, r, c=c,
                                          dtype=dtype)
    raise ValueError(
        f"unknown batched sampler {name!r}; available: "
        f"{', '.join(available_batched())}")


def sample_v(name: str, gen: torch.Generator, n: int, r: int,
             c: float = 1.0, dtype=torch.float32, *, sigma_mat=None,
             diag_energy=None) -> torch.Tensor:
    """One (n, r) draw by sampler name (``dependent`` with ``sigma_mat``,
    ``dependent_diag`` with ``diag_energy``)."""
    if name in SAMPLERS:
        return SAMPLERS[name](gen, n, r, c=c, dtype=dtype)
    if name == "dependent":
        return dependent_from_sigma(gen, sigma_mat, r, c=c, dtype=dtype)
    if name == "dependent_diag":
        return dependent_diagonal(gen, diag_energy, r, c=c, dtype=dtype)
    raise ValueError(
        f"unknown sampler {name!r}; available: {', '.join(available())}")
