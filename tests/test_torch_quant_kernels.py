"""The port's compressed-state kernels against the JAX package.

Covers ``repro_torch.optim.quant``, stochastic rounding (``ref.sr_bf16``)
and the plain versions of ``subspace_lion``, ``subspace_adam_q8``,
``subspace_lion_q8``, ``lowrank_merge_sr`` and ``subspace_adam`` with a
bf16 ``b``, held to the reference's XLA-route ``dispatch`` functions and,
once each at an aligned shape, to its Pallas kernels in interpret mode,
on the same numpy inputs and the same rounding ``bits``.  Tolerances:

* quantize/dequantize, ``sr_bf16`` and Lion (fp32 state): exact — the
  same fp32 operations in the same order;
* the q8 kernels: Lion against the XLA route exact (the dequantized
  moments are identical and the reference runs the same eager fp32
  operations).  Adam's chain holds ``pow`` (the bias corrections) and
  ``sqrt``, which XLA's CPU code computes within an ulp but not always
  correctly rounded, and the interpret-mode Pallas kernels are compiled
  by XLA, which may contract: there the scales are held within 4 fp32
  ulps, every payload within one int8 step with at most 1% of them off,
  and ``b'`` within 1e-6 of its largest magnitude (fp32) or exactly
  (bf16 masters: a last-ulp difference of the fp32 ``b'`` moves its
  bf16 round only with odds of about 2**-16 per element, and none moved
  at these seeds);
* Adam on a bf16 ``b``: as the fp32 kernel's tests, 1e-5 of the output's
  largest magnitude;
* ``lowrank_merge_sr``: exact.  Every stochastic, nearest or truncating
  round lands on one of the two bf16 neighbours of the sum, so a bound
  of one bf16 step could not tell a merge that drops its rounding noise
  from the right one; equality can (such a merge differs at about half
  the elements).

Stochastic rounding is also held to its law: the mean of many draws
recovers the fp32 input within four standard deviations of that mean,
computed from each element's own bf16 spacing.

The ``cuda``-marked tests hold each CUDA kernel to its plain version on
the card at ragged shapes and skip here with a reason; they import no
JAX.  Run them on a card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_quant_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import lowrank_update as lu  # noqa: E402
from repro_torch.kernels import subspace_adam as sa  # noqa: E402
from repro_torch.optim import quant  # noqa: E402

LION = dict(beta1=0.9, beta2=0.99, wd=0.05)
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.05)
# a logical state shape whose size (960) is not a multiple of 128
RAGGED = (2, 3, 20, 8)


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import _mixed
    from repro.kernels import dispatch as jdispatch
    from repro.kernels import lowrank_update as jupdate
    from repro.kernels import subspace_adam as jsa
    from repro.optim import quant as jquant
    return SimpleNamespace(jax=jax, jnp=jnp, dispatch=jdispatch,
                           quant=jquant, sr_bf16=_mixed.sr_bf16,
                           pallas=SimpleNamespace(
                               adam=jsa.subspace_adam, lion=jsa.subspace_lion,
                               adam_q8=jsa.subspace_adam_q8,
                               lion_q8=jsa.subspace_lion_q8,
                               merge_sr=jupdate.lowrank_merge_sr))


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _bits(shape, seed):
    """Rounding noise as the reference draws it (uint32 < 2**16) and as
    the port holds it (int32, the same bit patterns)."""
    u = np.random.default_rng(seed).integers(0, 1 << 16, shape,
                                             dtype=np.uint32)
    return u, u.astype(np.int32)


def _state(shape, seed, jref, b_dtype="float32"):
    """b, g, m, v (fp32 numpy, b rounded to b_dtype's grid) and the int8
    encodings of m (linear) and v (sqrt) the reference makes."""
    g = np.random.default_rng(seed)
    b = (0.02 * g.standard_normal(shape)).astype(np.float32)
    if b_dtype == "bfloat16":
        b = np.asarray(jref.jnp.asarray(b).astype("bfloat16"), np.float32)
    grad = (1e-3 * g.standard_normal(shape)).astype(np.float32)
    m = (1e-3 * g.standard_normal(shape)).astype(np.float32)
    v = (1e-6 * g.standard_normal(shape) ** 2).astype(np.float32)
    mq = jref.quant.quantize(jref.jnp.asarray(m))
    vq = jref.quant.quantize(jref.jnp.asarray(v), codec="sqrt")
    return b, grad, m, v, mq, vq


def _ulp_bf16(x):
    """The bf16 spacing at |x| (2**-7 of its binade; normals only)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _within_one_bf16_ulp(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    ulp = _ulp_bf16(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all()


# ---------------------------------------------------------------------------
# optim.quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["linear", "sqrt"])
@pytest.mark.parametrize("shape", [(1000,), (3, 128), (2, 5, 7)])
def test_quantize_and_dequantize_match_jax(jref, codec, shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x *= 10.0 ** rng.uniform(-8, 2, shape).astype(np.float32)
    if codec == "sqrt":
        x = x * x
    want = jref.quant.quantize(jref.jnp.asarray(x), codec=codec)
    got = quant.quantize(torch.from_numpy(x), codec=codec)
    assert got.q.dtype == torch.int8 and got.q.shape == x.shape
    assert got.scale.shape == (quant.nblocks(x.size),)
    assert (got.block, got.codec) == (want.block, want.codec)
    _eq(got.q, want.q)
    _eq(got.scale, want.scale)
    _eq(quant.dequantize(got), jref.quant.dequantize(want))
    assert got.nbytes == want.nbytes


def test_quantized_zeros_match_jax(jref):
    for shape in ((4, 3, 20, 8), (0, 8), (129,)):
        want = jref.quant.zeros(shape, codec="sqrt")
        got = quant.zeros(shape, codec="sqrt")
        assert got.shape == want.shape and got.codec == "sqrt"
        assert got.scale.shape == want.scale.shape
        assert not got.q.any() and not got.scale.any()
        like = quant.zeros_like(quant.quantize(torch.ones(shape)))
        assert like.scale.shape == got.scale.shape and not like.q.any()
    assert quant.as_f32(torch.ones(2, dtype=torch.bfloat16)).dtype == \
        torch.float32
    with pytest.raises(ValueError, match="codec"):
        quant.quantize(torch.ones(3), codec="log")


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------

def test_sr_bf16_matches_jax(jref):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096)
         * 10.0 ** rng.uniform(-6, 4, 4096)).astype(np.float32)
    ubits, ibits = _bits(x.shape, 4)
    want = jref.sr_bf16(jref.jnp.asarray(x), jref.jnp.asarray(ubits))
    got = ref.sr_bf16(*_t(x, ibits))
    assert got.dtype == torch.bfloat16
    _eq(got, want)
    # the noise only ever moves a value to one of its two bf16 neighbours
    _within_one_bf16_ulp(got, x)


def test_sr_bf16_is_unbiased_within_its_noise():
    """Each element rounds up with probability p = (its fraction of a
    bf16 step), so the mean of n draws has sd ulp·sqrt(p(1−p)/n); the
    bound is four of those plus a hair for the fp64 mean."""
    n = 4096
    gen = torch.Generator().manual_seed(5)
    base = torch.tensor([1.0, -3.0, 2.5e-3, 700.0, -0.07])
    ulp = torch.from_numpy(_ulp_bf16(base.numpy()))
    frac = torch.tensor([0.3, 0.5, 0.01, 0.77, 0.93])
    x = (base.double() + frac * ulp * torch.sign(base)).float()
    bits = torch.randint(0, 1 << 16, (n,) + x.shape, generator=gen,
                         dtype=torch.int32)
    draws = ref.sr_bf16(x.expand(n, -1), bits).double()
    mean = draws.mean(dim=0)
    p = frac.double()
    sd = ulp * torch.sqrt(p * (1 - p) / n)
    err = (mean - x.double()).abs()
    assert (err <= 4 * sd + 1e-9 * ulp).all(), (err / ulp, sd / ulp)
    # round to nearest keeps its bias: at these fractions it is off by
    # min(p, 1 - p) of a step, far beyond the SR mean's noise
    rn = x.to(torch.bfloat16).double()
    assert ((rn - x.double()).abs() >= 0.005 * ulp).all()


# ---------------------------------------------------------------------------
# Plain versions against the reference's XLA route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_subspace_lion_matches_jax(jref, b_dtype, g_dtype):
    b, g, m, _, _, _ = _state(RAGGED, 6, jref, b_dtype)
    jnp = jref.jnp
    jb, jm = jref.dispatch.subspace_lion(
        jnp.asarray(b).astype(b_dtype), jnp.asarray(g).astype(g_dtype),
        jnp.asarray(m), lr=jnp.float32(3e-4), **LION)
    tb, tg, tm = _t(b, g, m)
    nb, nm = dispatch.subspace_lion(
        tb.to(getattr(torch, b_dtype)), tg.to(getattr(torch, g_dtype)), tm,
        lr=torch.tensor(3e-4), **LION)
    assert nb.dtype == nm.dtype == torch.float32 and nb.shape == RAGGED
    _eq(nb, jb)
    _eq(nm, jm)


@pytest.mark.parametrize("step", [1, 5])
def test_subspace_adam_on_a_bf16_master_matches_jax(jref, step):
    b, g, m, v, _, _ = _state(RAGGED, 7 + step, jref, "bfloat16")
    jnp = jref.jnp
    want = jref.dispatch.subspace_adam(
        jnp.asarray(b).astype("bfloat16"), jnp.asarray(g), jnp.asarray(m),
        jnp.asarray(v), lr=3e-3, step=jnp.float32(step), **ADAM)
    tb, tg, tm, tv = _t(b, g, m, v)
    got = dispatch.subspace_adam(tb.bfloat16(), tg, tm, tv, lr=3e-3,
                                 step=torch.tensor(step), **ADAM)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        y = np.asarray(y)
        assert np.abs(_np(x) - y).max() <= 1e-5 * np.abs(y).max()


Q8_CASES = [(algo, b_dtype, sr) for algo in ("adam", "lion")
            for b_dtype in ("float32", "bfloat16") for sr in (False, True)]


def _q8_jax(jref, algo, b, g, mq, vq, bits, step=5):
    jnp = jref.jnp
    jbits = None if bits is None else jnp.asarray(bits)
    if algo == "adam":
        return jref.dispatch.subspace_adam_q8(
            b, g, mq.q, mq.scale, vq.q, vq.scale, lr=jnp.float32(3e-3),
            step=jnp.float32(step), bits=jbits, **ADAM)
    return jref.dispatch.subspace_lion_q8(
        b, g, mq.q, mq.scale, lr=jnp.float32(3e-4), bits=jbits, **LION)


def _q8_port(algo, b, g, mq, ms, vq, vs, bits, step=5):
    if algo == "adam":
        return dispatch.subspace_adam_q8(
            b, g, mq, ms, vq, vs, lr=torch.tensor(3e-3),
            step=torch.tensor(float(step)), bits=bits, **ADAM)
    return dispatch.subspace_lion_q8(b, g, mq, ms, lr=torch.tensor(3e-4),
                                     bits=bits, **LION)


def _q8_close(got, want, b_dtype):
    """Scales within 4 fp32 ulps, payloads within one int8 step (at most
    1% off), b' within 1e-6 of max (fp32) or equal (bf16)."""
    nb = _np(got[0]).reshape(-1)
    wb = _np(want[0]).reshape(-1)
    if b_dtype == "float32":
        assert np.abs(nb - wb).max() <= 1e-6 * np.abs(wb).max()
    else:
        _eq(nb, wb)
    for i in range(1, len(got), 2):
        q, wq = _np(got[i]).reshape(-1), _np(want[i]).reshape(-1)
        s, ws = _np(got[i + 1]).reshape(-1), _np(want[i + 1]).reshape(-1)
        assert np.abs(s - ws).max() <= 4 * np.spacing(np.abs(ws)).max()
        off = q.astype(np.int32) - wq.astype(np.int32)
        assert np.abs(off).max() <= 1 and (off != 0).mean() <= 0.01


@pytest.mark.parametrize("algo,b_dtype,sr", Q8_CASES)
def test_q8_updates_match_jax(jref, algo, b_dtype, sr):
    b, g, _, _, mq, vq = _state(RAGGED, 9, jref, b_dtype)
    ubits, ibits = _bits(RAGGED, 10)
    jb = jref.jnp.asarray(b).astype(b_dtype)
    want = _q8_jax(jref, algo, jb, jref.jnp.asarray(g), mq, vq,
                   ubits if sr else None)
    tb, tg, tmq, tms, tvq, tvs, tbits = _t(
        b, g, np.asarray(mq.q), np.asarray(mq.scale), np.asarray(vq.q),
        np.asarray(vq.scale), ibits)
    got = _q8_port(algo, tb.to(getattr(torch, b_dtype)), tg, tmq, tms, tvq,
                   tvs, tbits if sr else None)
    assert len(got) == len(want) == (5 if algo == "adam" else 3)
    assert got[0].dtype == getattr(torch, b_dtype) and got[0].shape == RAGGED
    assert got[1].dtype == torch.int8 and got[1].shape == RAGGED
    assert got[2].shape == (quant.nblocks(int(np.prod(RAGGED))),)
    if algo == "lion":
        for x, y in zip(got, want):
            _eq(x, y)
    _q8_close(got, want, b_dtype)


def test_lowrank_merge_sr_matches_jax(jref):
    rng = np.random.default_rng(11)
    lead, K, N, r = (3, 2), 40, 70, 8
    w = rng.standard_normal(lead + (K, N)).astype(np.float32)
    v = (rng.standard_normal(lead + (K, r)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(lead + (N, r))).astype(np.float32)
    ubits, ibits = _bits(lead + (K, N), 12)
    jnp = jref.jnp
    for v_dtype, b_dtype in (("bfloat16", "float32"),
                             ("bfloat16", "bfloat16")):
        want = jref.dispatch.lowrank_merge_sr(
            jnp.asarray(w).astype("bfloat16"), jnp.asarray(v).astype(v_dtype),
            jnp.asarray(b).astype(b_dtype), jnp.asarray(ubits))
        tw, tv, tb, tbits = _t(w, v, b, ibits)
        tw = tw.bfloat16()
        tv, tb = tv.to(getattr(torch, v_dtype)), tb.to(getattr(torch, b_dtype))
        got = dispatch.lowrank_merge_sr(tw, tv, tb, tbits)
        assert got.dtype == torch.bfloat16 and got.shape == tw.shape
        _eq(got, want)
        # in place: out=w writes the same values into w's storage
        inplace = tw.clone()
        assert dispatch.lowrank_merge_sr(inplace, tv, tb, tbits,
                                         out=inplace) is inplace
        assert torch.equal(inplace, got)


# ---------------------------------------------------------------------------
# The Pallas kernels in interpret mode, at one aligned shape
# ---------------------------------------------------------------------------

def test_plain_versions_match_pallas_kernels_interpret(jref):
    jnp = jref.jnp
    R = 8
    shape = (R, 128)
    for algo, b_dtype, sr in (("adam", "bfloat16", True),
                              ("adam", "float32", False),
                              ("lion", "bfloat16", True),
                              ("lion", "float32", False)):
        b, g, _, _, mq, vq = _state(shape, 13, jref, b_dtype)
        ubits, ibits = _bits(shape, 14)
        jb = jnp.asarray(b).astype(b_dtype)
        kw = dict(bits=jnp.asarray(ubits) if sr else None, interpret=True)
        if algo == "adam":
            want = jref.pallas.adam_q8(
                jb, jnp.asarray(g), mq.q, mq.scale.reshape(R, 1), vq.q,
                vq.scale.reshape(R, 1), lr=jnp.float32(3e-3),
                step=jnp.float32(5), **ADAM, **kw)
        else:
            want = jref.pallas.lion_q8(
                jb, jnp.asarray(g), mq.q, mq.scale.reshape(R, 1),
                lr=jnp.float32(3e-4), **LION, **kw)
        tb, tg, tmq, tms, tvq, tvs, tbits = _t(
            b, g, np.asarray(mq.q), np.asarray(mq.scale), np.asarray(vq.q),
            np.asarray(vq.scale), ibits)
        got = _q8_port(algo, tb.to(getattr(torch, b_dtype)), tg, tmq, tms,
                       tvq, tvs, tbits if sr else None)
        _q8_close(got, want, b_dtype)

    b, g, m, _, _, _ = _state((64, 8), 15, jref, "bfloat16")
    want = jref.pallas.lion(jnp.asarray(b).astype("bfloat16"),
                            jnp.asarray(g), jnp.asarray(m),
                            lr=jnp.float32(3e-4), interpret=True, **LION)
    tb, tg, tm = _t(b, g, m)
    got = dispatch.subspace_lion(tb.bfloat16(), tg, tm, lr=3e-4, **LION)
    for x, y in zip(got, want):
        y = np.asarray(y)
        assert np.abs(_np(x) - y).max() <= 1e-6 * np.abs(y).max()

    rng = np.random.default_rng(16)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    v = (rng.standard_normal((128, 8)) / 12).astype(np.float32)
    bb = (0.1 * rng.standard_normal((256, 8))).astype(np.float32)
    ubits, ibits = _bits((128, 256), 17)
    want = jref.pallas.merge_sr(jnp.asarray(w).astype("bfloat16"),
                                jnp.asarray(v).astype("bfloat16"),
                                jnp.asarray(bb), jnp.asarray(ubits),
                                interpret=True)
    tw, tv, tbb, tbits = _t(w, v, bb, ibits)
    got = ref.lowrank_merge_sr(tw.bfloat16(), tv.bfloat16(), tbb, tbits)
    _eq(got, want)


# ---------------------------------------------------------------------------
# Routing and counters (CPU)
# ---------------------------------------------------------------------------

def test_cpu_calls_never_count_launches():
    sa.reset_launches()
    lu.reset_launches()
    b, g, m = (torch.randn(RAGGED) for _ in range(3))
    mq = quant.quantize(m)
    vq = quant.quantize(m * m, codec="sqrt")
    bits = torch.randint(0, 1 << 16, RAGGED, dtype=torch.int32)
    dispatch.subspace_lion(b, g, m, lr=1e-3)
    dispatch.subspace_adam_q8(b.bfloat16(), g, mq.q, mq.scale, vq.q,
                              vq.scale, lr=1e-3, step=1, bits=bits)
    dispatch.subspace_lion_q8(b, g, mq.q, mq.scale, lr=1e-3)
    w = torch.randn(2, 8, 6).bfloat16()
    dispatch.lowrank_merge_sr(w, torch.randn(2, 8, 2), torch.randn(2, 6, 2),
                              torch.randint(0, 1 << 16, w.shape,
                                            dtype=torch.int32))
    assert sa.launches() == lu.launches() == 0


def test_devices_without_a_route_raise():
    b, g, m = (torch.zeros((4, 128), device="meta") for _ in range(3))
    s = torch.zeros((4,), device="meta")
    q = torch.zeros((4, 128), dtype=torch.int8, device="meta")
    one = torch.zeros((1,), device="meta")
    with pytest.raises(ValueError, match="subspace_lion: no route"):
        sa.subspace_lion(b, g, m, one, **LION)
    with pytest.raises(ValueError, match="subspace_adam_q8: no route"):
        sa.subspace_adam_q8(b, g, q, s, q, s, torch.zeros(3, device="meta"),
                            **ADAM)
    with pytest.raises(ValueError, match="subspace_lion_q8: no route"):
        sa.subspace_lion_q8(b, g, q, s, one, **LION)
    w = torch.zeros((8, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="lowrank_merge_sr: no route"):
        lu.lowrank_merge(w, b[:, :2][:8], b[:, :2][:8],
                         bits=torch.zeros((8, 8), dtype=torch.int32,
                                          device="meta"))


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


def _card_state(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    m, v = randn(1e-3), randn(1e-3) ** 2
    return (randn(0.02), randn(1e-3), quant.quantize(m),
            quant.quantize(v, codec="sqrt"),
            torch.randint(0, 1 << 16, shape, generator=gen, device=dev,
                          dtype=torch.int32))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["adam", "lion"])
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("shape", [(1, 32256, 128), (4, 12, 640, 128),
                                   (17, 128), RAGGED, (3, 5)])
def test_q8_kernels_match_plain_on_card(cuda, algo, b_dtype, g_dtype, sr,
                                        shape):
    """Exact: the kernel rounds every operation as the plain version's
    torch ops do, on the same device scalars."""
    sa.reset_launches()
    b, g, mq, vq, bits = _card_state(shape, cuda, 20)
    b, g = b.to(b_dtype), g.to(g_dtype)
    size = b.numel()
    R = quant.nblocks(size)
    blocks = [dispatch._to_blocks(t, R, 128)
              for t in (b, g, mq.q, vq.q, bits)]
    b2, g2, mq2, vq2, bits2 = blocks
    kw = dict(bits=bits2 if sr else None)
    if algo == "adam":
        sc = dispatch.adam_scalars(3e-3, torch.tensor(5, device=cuda), 0.9,
                                   0.999, cuda)
        got = sa.subspace_adam_q8(b2, g2, mq2, mq.scale, vq2, vq.scale, sc,
                                  **ADAM, **kw)
        lr, bc1, bc2 = sc
        want = ref.subspace_adam_q8(b2, g2, mq2, mq.scale[:, None], vq2,
                                    vq.scale[:, None], lr=lr, bc1=bc1,
                                    bc2=bc2, **ADAM, **kw)
    else:
        sc = dispatch.lion_scalars(3e-4, cuda)
        got = sa.subspace_lion_q8(b2, g2, mq2, mq.scale, sc, **LION, **kw)
        want = ref.subspace_lion_q8(b2, g2, mq2, mq.scale[:, None],
                                    lr=sc[0], **LION, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        _same(x, y.reshape(x.shape))
    assert sa.launches(f"subspace_{algo}_q8") == 1 and sa.launches() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["adam", "lion"])
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 17, 33, 1000])
def test_q8_kernels_write_over_their_inputs_on_card(cuda, algo, b_dtype,
                                                    rows):
    """Outputs that alias the inputs (the C entry given b, the payloads
    and the scales as its outputs): each half-warp reads its whole row
    before it writes any of it, so the result is the plain version's at
    row counts that leave half-warps and blocks idle."""
    b, g, mq, vq, bits = _card_state((rows, 128), cuda, 24)
    b = b.to(b_dtype)
    mq2, ms, vq2, vs = mq.q.clone(), mq.scale.clone(), vq.q.clone(), \
        vq.scale.clone()
    bits = bits if b_dtype == torch.bfloat16 else None
    code = sa.DTYPE_CODE
    if algo == "adam":
        sc = dispatch.adam_scalars(3e-3, torch.tensor(5, device=cuda), 0.9,
                                   0.999, cuda)
        lr, bc1, bc2 = sc
        want = ref.subspace_adam_q8(b, g, mq2, ms[:, None], vq2, vs[:, None],
                                    lr=lr, bc1=bc1, bc2=bc2, bits=bits,
                                    **ADAM)
        ins = (b, g, mq2, ms, vq2, vs)
        rc = sa._kernel("subspace_q8", "subspace_adam_q8_launch")(
            code[b.dtype], code[g.dtype], *(t.data_ptr() for t in ins),
            sa._ptr(bits), b.data_ptr(), mq2.data_ptr(), ms.data_ptr(),
            vq2.data_ptr(), vs.data_ptr(), sc.data_ptr(), rows, 0.9, 0.1,
            0.999, 1 - 0.999, ADAM["eps"], ADAM["wd"],
            torch.cuda.current_stream().cuda_stream)
        got = (b, mq2, ms, vq2, vs)
    else:
        sc = dispatch.lion_scalars(3e-4, cuda)
        want = ref.subspace_lion_q8(b, g, mq2, ms[:, None], lr=sc[0],
                                    bits=bits, **LION)
        rc = sa._kernel("subspace_q8", "subspace_lion_q8_launch")(
            code[b.dtype], code[g.dtype], b.data_ptr(), g.data_ptr(),
            mq2.data_ptr(), ms.data_ptr(), sa._ptr(bits), b.data_ptr(),
            mq2.data_ptr(), ms.data_ptr(), sc.data_ptr(), rows, 0.9, 0.1,
            0.99, 1 - 0.99, LION["wd"],
            torch.cuda.current_stream().cuda_stream)
        got = (b, mq2, ms)
    assert rc == 0
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        _same(x, y.reshape(x.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 12, 640, 128), RAGGED, (3, 5)])
def test_lion_and_bf16_master_adam_kernels_match_plain_on_card(
        cuda, b_dtype, g_dtype, shape):
    sa.reset_launches()
    b, g, mq, vq, _ = _card_state(shape, cuda, 21)
    b, g = b.to(b_dtype), g.to(g_dtype)
    m, v = quant.dequantize(mq), quant.dequantize(vq)
    sc = dispatch.lion_scalars(3e-4, cuda)
    got = sa.subspace_lion(b, g, m, sc, **LION)
    want = ref.subspace_lion(b, g, m, lr=sc[0], **LION)
    sc3 = dispatch.adam_scalars(3e-3, torch.tensor(5, device=cuda), 0.9,
                                0.999, cuda)
    got += sa.subspace_adam(b, g, m, v, sc3, **ADAM)
    lr, bc1, bc2 = sc3
    want += ref.subspace_adam(b, g, m, v, lr=lr, bc1=bc1, bc2=bc2, **ADAM)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        _same(x, y)
    assert sa.launches("subspace_lion") == sa.launches("subspace_adam") == 1


# (leading dims, K, N, r): ragged edges and ranks that are no multiple of
# a staged round (8, 16, 72), several items, then the four llama-100m
# group shapes the training path merges
SR_SHAPES = [((3, 2), 37, 70, 8), ((2,), 1712, 64, 16),
             ((5,), 130, 200, 72), ((1,), 640, 1712, 128),
             ((4, 12), 640, 640, 128), ((2, 12), 640, 1712, 128),
             ((1, 12), 1712, 640, 128), ((1,), 640, 32256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32)])
@pytest.mark.parametrize("lead,K,N,r", SR_SHAPES)
@pytest.mark.parametrize("noise", ["uniform", "zeros", "ones"])
def test_merge_sr_kernel_matches_plain_on_card(cuda, dtypes, lead, K, N, r,
                                               noise):
    """Equal: a bound of one bf16 step would pass a merge that rounds
    to nearest or truncates instead.  Noise all 0 truncates and all
    0xFFFF rounds every inexact sum up, the two edges of the law; in
    place equals out of place, and a second launch repeats the first
    bit for bit."""
    lu.reset_launches()
    gen = torch.Generator(device=cuda).manual_seed(22)
    w = torch.randn(lead + (K, N), generator=gen, device=cuda).bfloat16()
    v = (torch.randn(lead + (K, r), generator=gen, device=cuda)
         / K ** 0.5).to(dtypes[0])
    b = (0.1 * torch.randn(lead + (N, r), generator=gen, device=cuda)
         ).to(dtypes[1])
    bits = {"uniform": torch.randint(0, 1 << 16, w.shape, generator=gen,
                                     device=cuda, dtype=torch.int32),
            "zeros": torch.zeros(w.shape, dtype=torch.int32, device=cuda),
            "ones": torch.full(w.shape, 0xFFFF, dtype=torch.int32,
                               device=cuda)}[noise]
    want = ref.lowrank_merge_sr(w, v, b, bits)
    got = lu.lowrank_merge(w, v, b, bits=bits)
    again = lu.lowrank_merge(w, v, b, bits=bits)
    inplace = w.clone()
    lu.lowrank_merge(inplace, v, b, out=inplace, bits=bits)
    torch.cuda.synchronize()
    _same(got, want)
    assert torch.equal(again, got) and torch.equal(inplace, got)
    assert lu.launches("lowrank_merge_sr", "simt") == 3 and lu.launches() == 3


@pytest.mark.cuda
def test_compressed_state_kernels_refuse_what_they_do_not_take(cuda):
    b, g, mq, vq, bits = _card_state((4, 128), cuda, 23)
    sc3 = torch.zeros(3, device=cuda)
    sc1 = torch.zeros(1, device=cuda)
    half = [t[:, :64].contiguous() for t in (b, g, mq.q, vq.q)]
    with pytest.raises(ValueError, match="rows"):
        sa.subspace_adam_q8(half[0], half[1], half[2], mq.scale, half[3],
                            vq.scale, sc3, **ADAM)
    with pytest.raises(TypeError, match="int8"):
        sa.subspace_lion_q8(b, g, mq.q.float(), mq.scale, sc1, **LION)
    with pytest.raises(ValueError, match="one per row"):
        sa.subspace_lion_q8(b, g, mq.q, mq.scale[:2], sc1, **LION)
    with pytest.raises(TypeError, match="bits"):
        sa.subspace_lion_q8(b, g, mq.q, mq.scale, sc1, bits=bits.long(),
                            **LION)
    with pytest.raises(ValueError, match=r"\(1,\) float32"):
        sa.subspace_lion_q8(b, g, mq.q, mq.scale, sc3, **LION)
    shifted = torch.empty(b.numel() + 1, device=cuda)[1:].view(b.shape)
    with pytest.raises(ValueError, match="aligned"):
        sa.subspace_lion_q8(shifted.copy_(b), g, mq.q, mq.scale, sc1, **LION)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sa.subspace_lion(b.half(), g, b, sc1, **LION)
    with pytest.raises(ValueError, match="contiguous"):
        sa.subspace_lion(b.T, g.T, b.T, sc1, **LION)
    with pytest.raises(ValueError, match="on"):
        sa.subspace_lion(b, g.cpu(), b, sc1, **LION)
    w = torch.zeros((2, 16, 24), device=cuda)
    v, bb = torch.zeros((2, 16, 4), device=cuda), torch.zeros((2, 24, 4),
                                                              device=cuda)
    wbits = torch.zeros(w.shape, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        lu.lowrank_merge(w, v, bb, bits=wbits)
    with pytest.raises(ValueError, match="shapes"):
        lu.lowrank_merge(w.bfloat16(), v, bb, bits=wbits[:1])
    with pytest.raises(TypeError, match="int32"):
        lu.lowrank_merge(w.bfloat16(), v, bb, bits=wbits.long())
