"""The port's low-rank forward against the JAX package.

* The plain PyTorch version (the CPU route of the wrapper) equals the
  reference's XLA route ``dispatch._xla_forward`` / ``_xla_batch_forward``
  on ragged shapes in fp32 (rtol 1e-5: same fp32 arithmetic, summed in
  another order), and the Pallas TPU kernel in interpret mode at one
  small aligned shape (M=16, K=N=128, r=8).
* A CPU call never touches the launch counter; a device with no route
  raises.
* The CUDA kernel tests (marked ``cuda``) hold the kernel against the
  plain version on the card (the SIMT route: every ragged shape has a
  row length the tensor-core route cannot address; that route's own
  tests are ``tests/test_torch_wgmma.py``) and skip here with a
  reason.  They need no JAX: the reference is imported inside the
  ``jref`` fixture, so on a machine with a card and without JAX only the
  parity tests skip.
  Run them there with ``PYTHONPATH=src python -m pytest -m cuda
  tests/test_torch_lowrank_forward.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6   # fp32 on both sides; only the summation order

RAGGED = [(5, 37, 19, 3), (16, 128, 130, 8), (1, 64, 33, 4), (33, 7, 200, 2)]


def _operands(M, K, N, r, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    xs = (M, K) if batch is None else (batch, M, K)
    bs = (N, r) if batch is None else (batch, N, r)
    return (rng.standard_normal(xs).astype(np.float32),
            (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
            (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32),
            (0.1 * rng.standard_normal(bs)).astype(np.float32))


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    from repro.kernels.lowrank_forward import lowrank_forward
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch,
                           pallas_forward=lowrank_forward)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_plain_matches_jax_xla_forward(jref, M, K, N, r):
    jnp = jref.jnp
    x, w, v, b = _operands(M, K, N, r)
    want = np.asarray(jref.dispatch._xla_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(v), jnp.asarray(b),
        False))
    got = ref.lowrank_forward(*_t(x, w, v, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the public op folds leading dims and routes a CPU tensor to the
    # same plain version
    x3 = x.reshape(1, M, K)
    got3 = dispatch.lowrank_forward(*_t(x3, w, v, b)).numpy()
    np.testing.assert_allclose(got3.reshape(M, N), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_plain_batch_matches_jax_xla_batch_forward(jref, M, K, N, r):
    jnp = jref.jnp
    x, w, v, b = _operands(M, K, N, r, seed=1, batch=3)
    want = np.asarray(jref.dispatch._xla_batch_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(v), jnp.asarray(b)))
    got = dispatch.lowrank_batch_forward(*_t(x, w, v, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got.shape == (3, M, N)


def test_plain_matches_pallas_kernel_interpret(jref):
    jnp = jref.jnp
    x, w, v, b = _operands(16, 128, 128, 8, seed=2)
    want = np.asarray(jref.pallas_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(v), jnp.asarray(b),
        interpret=True))
    got = ref.lowrank_forward(*_t(x, w, v, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_keeps_input_dtype_and_fp32_p():
    x, w, v, b = _t(*_operands(4, 64, 32, 4, seed=3))
    y = ref.lowrank_forward(x.bfloat16(), w.bfloat16(), v.bfloat16(),
                            b.bfloat16())
    assert y.dtype == torch.bfloat16
    # p stays fp32 for the B^T product, as the TPU kernel keeps it
    xf, wf, vf, bf = (t.bfloat16().float() for t in (x, w, v, b))
    want = (xf @ wf + (xf @ vf) @ bf.T).bfloat16()
    assert torch.equal(y, want)


def test_cpu_calls_never_count_launches():
    lf.reset_launches()
    x, w, v, b = _t(*_operands(6, 32, 16, 2, seed=4))
    lf.lowrank_forward(x, w, v, b)
    xb, _, _, bb = _t(*_operands(6, 32, 16, 2, seed=4, batch=2))
    lf.lowrank_batch_forward(xb, w, v, bb)
    dispatch.lowrank_forward(x, w, v, b)
    assert lf.launches() == 0 and not lf.LAUNCHES


def test_device_without_route_raises():
    x, w, v, b = (t.to("meta") for t in _t(*_operands(4, 8, 8, 2)))
    with pytest.raises(ValueError, match="no route"):
        lf.lowrank_forward(x, w, v, b)


def test_batch_forward_shape_checks():
    x, w, v, b = _t(*_operands(4, 8, 8, 2, batch=2))
    with pytest.raises(ValueError, match="batch, seq, k"):
        dispatch.lowrank_batch_forward(x[0], w, v, b)
    with pytest.raises(ValueError, match="batch"):
        dispatch.lowrank_batch_forward(x, w, v, b[:1])


@pytest.mark.parametrize("M,N,K", [(4, 3584, 3584), (128, 512, 3584),
                                   (4, 152064, 3584), (128, 3584, 18944),
                                   (1, 8, 1)])
def test_splits_cover_k_with_nonempty_ranges(M, N, K):
    s = lf.splits(M, N, K)
    chunk = -(-(-(-K // s)) // 16) * 16         # the kernel's rounding
    assert s >= 1 and (s - 1) * chunk < K <= s * chunk


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("M,K,N,r", RAGGED)
def test_kernel_matches_plain_on_card(cuda, dtype, rtol, M, K, N, r):
    lf.reset_launches()
    x, w, v, b = (t.to(cuda, dtype) for t in _t(*_operands(M, K, N, r)))
    y = lf.lowrank_forward(x, w, v, b)
    torch.cuda.synchronize()
    want = ref.lowrank_forward(x, w, v, b)
    tol = rtol * want.float().abs().max().item()
    assert (y.float() - want.float()).abs().max().item() <= tol
    # every RAGGED shape has r <= 16 and a row length TMA cannot address:
    # the fp32 shared-B launch takes the small-rank route, bf16 SIMT
    shared = "tf32x3" if dtype == torch.float32 else "simt"
    assert lf.launches("shared") == lf.launches("shared", shared) == 1
    xb, _, _, bb = (t.to(cuda, dtype)
                    for t in _t(*_operands(M, K, N, r, batch=3)))
    yb = lf.lowrank_batch_forward(xb, w, v, bb)
    wantb = ref.lowrank_batch_forward(xb, w, v, bb)
    tolb = rtol * wantb.float().abs().max().item()
    assert (yb.float() - wantb.float()).abs().max().item() <= tolb
    assert lf.launches("batched") == lf.launches("batched", "simt") == 1


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w, v, b = (t.to(cuda) for t in _t(*_operands(8, 32, 16, 2)))
    with pytest.raises(TypeError, match="one dtype"):
        lf.lowrank_forward(x.bfloat16(), w, v, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lf.lowrank_forward(x.half(), w.half(), v.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        lf.lowrank_forward(x, w.T.contiguous().T, v, b)
    with pytest.raises(ValueError, match="on"):
        lf.lowrank_forward(x, w.cpu(), v, b)
