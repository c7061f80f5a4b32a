"""The port's training kernels against the JAX package.

The plain PyTorch versions (the CPU route of each wrapper) are held to
the reference's XLA-route ``dispatch`` functions and ``repro.kernels.ref``
on the same numpy inputs:

* fp32: max abs error within 1e-5 of the output's largest magnitude —
  the same fp32 arithmetic, summed in another order (at K = 1712 an
  element can differ by ~4e-5 of itself, so the bound is not
  elementwise);
* bf16 inputs: the outputs are rounded to bf16 on both sides, so the
  bound is 1e-2 of the output's largest magnitude (about two bf16
  ulps).  The forward's ``y`` is the exception: the reference's XLA route
  rounds ``p`` to bf16 before ``Bᵀ`` and the port (like the TPU kernel)
  does not, so ``y`` is held at 2e-2 there.

Once each, at one small aligned shape, they are also held to the Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` does.

The ``cuda``-marked tests hold each CUDA kernel to its plain version on
the card (ragged shapes with K = 1712, fp32 and bf16, the mixed-dtype
merge, and the refusals) and skip here with a reason.  They need no
JAX: the reference is imported inside the ``jref`` fixture.  Run them
on a card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_train_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import lowrank_backward as lb  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.kernels import lowrank_update as lu  # noqa: E402
from repro_torch.kernels import subspace_adam as sa  # noqa: E402

FP32_REL = 1e-5
BF16_REL = 1e-2
# (M, K, N, r): ragged on every axis, and one at llama-100m's d_ff
RAGGED = [(5, 37, 19, 3), (16, 128, 130, 8), (33, 1712, 64, 16),
          (70, 64, 1712, 8)]
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.05)


def _rng(seed):
    return np.random.default_rng(seed)


def _fwd_operands(M, K, N, r, seed=0):
    g = _rng(seed)
    return (g.standard_normal((M, K)).astype(np.float32),
            (g.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
            (g.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32),
            (0.1 * g.standard_normal((N, r))).astype(np.float32))


def _bwd_operands(M, K, N, r, seed=0, lead=()):
    g = _rng(seed)
    return ((g.standard_normal(lead + (M, N))).astype(np.float32),
            (g.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
            (g.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32),
            (0.1 * g.standard_normal((N, r))).astype(np.float32),
            g.standard_normal(lead + (M, r)).astype(np.float32))


def _merge_operands(lead, K, N, r, seed=0):
    g = _rng(seed)
    return (g.standard_normal(lead + (K, N)).astype(np.float32),
            (g.standard_normal(lead + (K, r)) / np.sqrt(K)).astype(
                np.float32),
            (0.1 * g.standard_normal(lead + (N, r))).astype(np.float32))


def _adam_operands(shape, seed=0):
    g = _rng(seed)
    return (g.standard_normal(shape).astype(np.float32),
            (0.1 * g.standard_normal(shape)).astype(np.float32),
            (0.01 * g.standard_normal(shape)).astype(np.float32),
            (1e-3 * np.abs(g.standard_normal(shape))).astype(np.float32))


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    from repro.kernels import ref as jkref
    from repro.kernels.lowrank_backward import lowrank_backward
    from repro.kernels.lowrank_forward import lowrank_forward
    from repro.kernels.lowrank_update import lowrank_merge
    from repro.kernels.subspace_adam import subspace_adam
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch, ref=jkref,
                           pallas_forward=lowrank_forward,
                           pallas_backward=lowrank_backward,
                           pallas_merge=lowrank_merge,
                           pallas_adam=subspace_adam)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(jref, dtype, *arrs):
    return [jref.jnp.asarray(a).astype(dtype) for a in arrs]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want, rel=FP32_REL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _close_bf16(got, want, rel=BF16_REL):
    _close(got, want, rel)


# ---------------------------------------------------------------------------
# Forward with p
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_forward_p_matches_jax_xla_fp32(jref, M, K, N, r):
    x, w, v, b = _fwd_operands(M, K, N, r)
    jy, jp = jref.dispatch._xla_forward(*_j(jref, "float32", x, w, v, b),
                                        True)
    y, p = ref.lowrank_forward(*_t(x, w, v, b), return_p=True)
    _close(y.numpy(), np.asarray(jy))
    _close(p.numpy(), np.asarray(jp))
    # the public op folds leading dims and routes a CPU tensor to the
    # same plain version
    y3, p3 = dispatch.lowrank_forward(*_t(x.reshape(1, M, K), w, v, b),
                                      return_p=True)
    assert y3.shape == (1, M, N) and p3.shape == (1, M, r)
    _close(p3.numpy()[0], np.asarray(jp))


def test_forward_p_on_bf16_inputs(jref):
    x, w, v, b = _fwd_operands(33, 1712, 64, 16, seed=1)
    jy, jp = jref.dispatch._xla_forward(*_j(jref, "bfloat16", x, w, v, b),
                                        True)
    y, p = ref.lowrank_forward(*(t.bfloat16() for t in _t(x, w, v, b)),
                               return_p=True)
    assert y.dtype == p.dtype == torch.bfloat16
    _close_bf16(p, jp)
    _close_bf16(y, jy, rel=2 * BF16_REL)


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_backward_matches_jax_xla_fp32(jref, M, K, N, r):
    dy, w, v, b, p = _bwd_operands(M, K, N, r)
    jdx, jdb = jref.dispatch._xla_backward(
        *_j(jref, "float32", dy, w, v, b, p))
    dx, db = ref.lowrank_backward(*_t(dy, w, v, b, p))
    assert dx.dtype == db.dtype == torch.float32
    _close(dx.numpy(), np.asarray(jdx))
    _close(db.numpy(), np.asarray(jdb))


def test_backward_contracts_every_leading_axis(jref):
    dy, w, v, b, p = _bwd_operands(6, 40, 24, 4, seed=2, lead=(2, 3))
    jdx, jdb = jref.dispatch.lowrank_backward(
        *_j(jref, "float32", dy, w, v, b, p))
    dx, db = dispatch.lowrank_backward(*_t(dy, w, v, b, p))
    assert dx.shape == (2, 3, 6, 40) and db.shape == (24, 4)
    _close(dx.numpy(), np.asarray(jdx))
    _close(db.numpy(), np.asarray(jdb))


def test_backward_on_bf16_inputs(jref):
    dy, w, v, b, p = _bwd_operands(33, 1712, 64, 16, seed=3)
    jdx, jdb = jref.dispatch._xla_backward(
        *_j(jref, "bfloat16", dy, w, v, b, p))
    dx, db = ref.lowrank_backward(
        *(t.bfloat16() for t in _t(dy, w, v, b, p)))
    assert dx.dtype == torch.bfloat16 and db.dtype == torch.float32
    _close_bf16(dx, jdx)
    _close(db.numpy(), np.asarray(jdb))


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", [("float32", "float32", "float32"),
                                    ("bfloat16", "bfloat16", "float32"),
                                    ("float32", "bfloat16", "float32")])
def test_merge_over_group_lead_dims_matches_jax(jref, dtypes):
    w, v, b = _merge_operands((3, 2), 40, 70, 8, seed=4)
    jw = jref.dispatch.lowrank_merge(
        *(jref.jnp.asarray(a).astype(d) for a, d in zip((w, v, b), dtypes)))
    tdt = [getattr(torch, d) for d in dtypes]
    tw, tv, tb = (t.to(d) for t, d in zip(_t(w, v, b), tdt))
    got = dispatch.lowrank_merge(tw, tv, tb)
    assert got.dtype == tw.dtype and got.shape == tw.shape
    if dtypes[0] == "float32":
        _close(got.numpy(), np.asarray(jw))
    else:
        _close_bf16(got, jw)
    # in place: out=w writes the same values into w's storage
    inplace = tw.clone()
    assert dispatch.lowrank_merge(inplace, tv, tb, out=inplace) is inplace
    assert torch.equal(inplace, got)


# ---------------------------------------------------------------------------
# Subspace Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_subspace_adam_matches_jax(jref, step, g_dtype):
    b, g, m, v = _adam_operands((2, 3, 20, 8), seed=5 + step)
    jb, jm, jv = jref.dispatch.subspace_adam(
        *_j(jref, "float32", b), jref.jnp.asarray(g).astype(g_dtype),
        *_j(jref, "float32", m, v), lr=3e-3,
        step=jref.jnp.float32(step), **ADAM)
    tb, tg, tm, tv = _t(b, g, m, v)
    nb, nm, nv = dispatch.subspace_adam(
        tb, tg.to(getattr(torch, g_dtype)), tm, tv, lr=3e-3,
        step=torch.tensor(step, dtype=torch.int32), **ADAM)
    assert nb.dtype == nm.dtype == nv.dtype == torch.float32
    for got, want in ((nb, jb), (nm, jm), (nv, jv)):
        _close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The Pallas kernels in interpret mode, at one aligned shape
# ---------------------------------------------------------------------------

def test_plain_versions_match_pallas_kernels_interpret(jref):
    jnp = jref.jnp
    x, w, v, b = _fwd_operands(16, 128, 128, 8, seed=6)
    jy, jp = jref.pallas_forward(*_j(jref, "float32", x, w, v, b),
                                 interpret=True, return_p=True)
    y, p = ref.lowrank_forward(*_t(x, w, v, b), return_p=True)
    _close(y.numpy(), np.asarray(jy))
    _close(p.numpy(), np.asarray(jp))

    dy, w, v, b, p = _bwd_operands(16, 128, 128, 8, seed=7)
    jdx, jdb = jref.pallas_backward(*_j(jref, "float32", dy, w, v, b, p),
                                    interpret=True)
    dx, db = ref.lowrank_backward(*_t(dy, w, v, b, p))
    _close(dx.numpy(), np.asarray(jdx))
    _close(db.numpy(), np.asarray(jdb))

    w, v, b = _merge_operands((), 128, 256, 8, seed=8)
    jw = jref.pallas_merge(*_j(jref, "float32", w, v, b), interpret=True)
    _close(ref.lowrank_merge(*_t(w, v, b)).numpy(),
                               np.asarray(jw))

    b, g, m, v = _adam_operands((64, 8), seed=9)
    outs = jref.pallas_adam(*_j(jref, "float32", b, g, m, v), lr=3e-3,
                            step=jnp.float32(3), interpret=True, **ADAM)
    mine = dispatch.subspace_adam(*_t(b, g, m, v), lr=3e-3, step=3.0,
                                  **ADAM)
    for got, want in zip(mine, outs):
        _close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Routing and counters (CPU)
# ---------------------------------------------------------------------------

def _reset_all():
    for mod in (lf, lb, lu, sa):
        mod.reset_launches()


def test_cpu_calls_never_count_launches():
    _reset_all()
    x, w, v, b = _t(*_fwd_operands(6, 32, 16, 2, seed=10))
    dispatch.lowrank_forward(x, w, v, b, return_p=True)
    dy, w2, v2, b2, p2 = _t(*_bwd_operands(6, 32, 16, 2, seed=10))
    dispatch.lowrank_backward(dy, w2, v2, b2, p2)
    dispatch.lowrank_merge(*_t(*_merge_operands((2,), 8, 8, 2)))
    dispatch.subspace_adam(*_t(*_adam_operands((4, 2))), lr=1e-3, step=1)
    assert lf.launches() == lb.launches() == lu.launches() == \
        sa.launches() == 0


def test_devices_without_a_route_raise():
    dy, w, v, b, p = (t.to("meta")
                      for t in _t(*_bwd_operands(4, 8, 8, 2)))
    with pytest.raises(ValueError, match="lowrank_backward: no route"):
        lb.lowrank_backward(dy, w, v, b, p)
    w, v, b = (t.to("meta") for t in _t(*_merge_operands((), 8, 8, 2)))
    with pytest.raises(ValueError, match="lowrank_merge: no route"):
        lu.lowrank_merge(w, v, b)
    bb, g, m, vv = (t.to("meta") for t in _t(*_adam_operands((4, 2))))
    with pytest.raises(ValueError, match="subspace_adam: no route"):
        sa.subspace_adam(bb, g, m, vv, torch.zeros(3, device="meta"),
                         **ADAM)


@pytest.mark.parametrize("M,N,r", [(16384, 640, 128), (16384, 32256, 128),
                                   (5, 19, 3), (256, 8, 1)])
def test_db_splits_cover_m_with_nonempty_ranges(M, N, r):
    s = lb.db_splits(M, N, r)
    chunk = -(-(-(-M // s)) // 16) * 16          # the kernel's rounding
    assert s >= 1 and (s - 1) * chunk < M <= s * chunk


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

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


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _scale(want):
    return want.float().abs().max().item()


DTYPE_TOL = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _route(dtype, K, N, r, form=None):
    """The route a launch must take: the tensor cores for bf16 with every
    row length a multiple of 8 (the last two RAGGED shapes), 3xTF32 for
    the fp32 forward of r <= 16 (every RAGGED shape), SIMT for the
    rest."""
    if dtype == torch.float32 and form == "p" and r <= lf.SMALL_RANK:
        return "tf32x3"
    aligned = all(d % 8 == 0 for d in (K, N, r))
    return "tc" if dtype == torch.bfloat16 and aligned else "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPE_TOL)
@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_forward_p_kernel_matches_plain_on_card(cuda, dtype, rtol, M, K, N,
                                                r):
    lf.reset_launches()
    x, w, v, b = (t.to(cuda, dtype) for t in _t(*_fwd_operands(M, K, N, r)))
    y, p = lf.lowrank_forward(x, w, v, b, return_p=True)
    torch.cuda.synchronize()
    want_y, want_p = ref.lowrank_forward(x, w, v, b, return_p=True)
    assert y.dtype == p.dtype == dtype
    assert _max_err(y, want_y) <= rtol * _scale(want_y)
    assert _max_err(p, want_p) <= rtol * _scale(want_p)
    assert lf.launches("p") == 1 and lf.launches() == 1
    assert lf.launches("p", _route(dtype, K, N, r, "p")) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPE_TOL)
@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_backward_kernel_matches_plain_on_card(cuda, dtype, rtol, M, K, N,
                                               r):
    lb.reset_launches()
    ops = (t.to(cuda, dtype) for t in _t(*_bwd_operands(M, K, N, r)))
    dy, w, v, b, p = ops
    dx, db = lb.lowrank_backward(dy, w, v, b, p)
    torch.cuda.synchronize()
    want_dx, want_db = ref.lowrank_backward(dy, w, v, b, p)
    assert dx.dtype == dtype and db.dtype == torch.float32
    assert _max_err(dx, want_dx) <= rtol * _scale(want_dx)
    # dB is fp32 from dtype inputs on both sides: only the sum order differs
    assert _max_err(db, want_db) <= 1e-4 * _scale(want_db)
    assert lb.launches() == 1 and lb.launches(_route(dtype, K, N, r)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("lead,K,N,r", [((3, 2), 37, 70, 8),
                                        ((2,), 1712, 64, 16),
                                        ((), 64, 1712, 8)])
def test_merge_kernel_matches_plain_on_card(cuda, dtypes, lead, K, N, r):
    lu.reset_launches()
    w, v, b = (t.to(cuda, d)
               for t, d in zip(_t(*_merge_operands(lead, K, N, r)), dtypes))
    want = ref.lowrank_merge(w, v, b)
    got = lu.lowrank_merge(w, v, b)
    inplace = w.clone()
    lu.lowrank_merge(inplace, v, b, out=inplace)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtypes[0] == torch.float32 else 1e-2
    assert got.dtype == w.dtype
    assert _max_err(got, want) <= rtol * _scale(want)
    assert torch.equal(inplace, got)
    assert lu.launches() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 7, 5), (8003,),
                                   (4, 12, 640, 128), (2, 12, 1712, 128),
                                   (1, 12, 640, 128), (1, 32256, 128)])
def test_adam_kernel_matches_plain_on_card(cuda, b_dtype, g_dtype, shape):
    """Equal to the plain version (every operation rounded as it rounds
    them) at ragged sizes (n = 1, 7, 105, 8003) and llama-100m's four B
    group shapes, in each (b, g) dtype instance; a launch counted for
    each grid queued: the whole tiles' and the ragged last tile's."""
    sa.reset_launches()
    b, g, m, v = (t.to(cuda) for t in _t(*_adam_operands(shape, seed=11)))
    b, g = b.to(b_dtype), g.to(g_dtype)
    step = torch.tensor(5, dtype=torch.int32, device=cuda)
    scalars = dispatch.adam_scalars(3e-3, step, 0.9, 0.999, cuda)
    got = sa.subspace_adam(b, g, m, v, scalars, **ADAM)
    torch.cuda.synchronize()
    lr, bc1, bc2 = scalars
    want = ref.subspace_adam(b, g, m, v, lr=lr, bc1=bc1, bc2=bc2, **ADAM)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        assert torch.equal(x, y), _max_err(x, y)
    n = b.numel()
    assert sa.launches() == int(n >= sa.TILE) + int(n % sa.TILE > 0)


@pytest.mark.cuda
def test_training_kernels_refuse_what_they_do_not_take(cuda):
    dy, w, v, b, p = (t.to(cuda) for t in _t(*_bwd_operands(8, 32, 16, 2)))
    with pytest.raises(TypeError, match="one dtype"):
        lb.lowrank_backward(dy.bfloat16(), w, v, b, p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lb.lowrank_backward(*(t.half() for t in (dy, w, v, b, p)))
    with pytest.raises(ValueError, match="contiguous"):
        lb.lowrank_backward(dy, w.T.contiguous().T, v, b, p)
    with pytest.raises(ValueError, match="on"):
        lb.lowrank_backward(dy, w.cpu(), v, b, p)
    with pytest.raises(ValueError, match="shapes"):
        lb.lowrank_backward(dy, w, v, b, p[:4])

    w, v, b = (t.to(cuda) for t in _t(*_merge_operands((2,), 16, 24, 4)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lu.lowrank_merge(w, v.half(), b)
    with pytest.raises(ValueError, match="contiguous"):
        lu.lowrank_merge(w, v, b.transpose(-1, -2).contiguous()
                         .transpose(-1, -2))
    with pytest.raises(ValueError, match="shapes"):
        lu.lowrank_merge(w, v[:1], b)
    with pytest.raises(ValueError, match="on"):
        lu.lowrank_merge(w, v.cpu(), b)

    bb, g, m, vv = (t.to(cuda) for t in _t(*_adam_operands((6, 4))))
    sc = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sa.subspace_adam(bb, g, m.bfloat16(), vv, sc, **ADAM)
    with pytest.raises(ValueError, match="share one shape"):
        sa.subspace_adam(bb, g[:3], m, vv, sc, **ADAM)
    with pytest.raises(ValueError, match="contiguous"):
        sa.subspace_adam(bb.T, g.T, m.T, vv.T, sc, **ADAM)
    with pytest.raises(ValueError, match="on"):
        sa.subspace_adam(bb, g, m, vv, sc.cpu(), **ADAM)
