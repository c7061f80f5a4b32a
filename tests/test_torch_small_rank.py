"""The fp32 small-rank routes of the forward and the merge.

* ``"tf32x3"`` (``csrc/lowrank_forward.cu``, ``small_rank_kernel``): an
  fp32 shared-B or ``return_p`` forward of rank at most 16 in one launch,
  3xTF32 ``mma.sync``, p = x V formed in the tile and kept in fp32, the
  rank term added by fp32 FMAs in the epilogue;
* ``"ew"`` (``csrc/lowrank_merge.cu``, ``small_rank_merge``): the plain
  merge of an fp32 W or V of rank at most 16, an elementwise pass.

On the CPU: the routing (``lowrank_forward.tc_route``, the one place
that picks among the forward's routes, and ``lowrank_update.
merge_route``), the plain versions against the
JAX package's XLA route at encoder-small's shapes (the fine-tuning cell,
M cut to 512), and the forward's arithmetic emulated: 3xTF32 products as
``tf32_mma.cuh`` splits them, summed in fp32 per 8-deep step, p in fp32,
the rank term by fp32 FMAs in c order.  It stays within 1e-5 · max|y| of
a float64 run, and two planted faults fail it: the hi·hi product alone,
and p rounded to TF32.

The ``cuda`` tests (skipped here with a reason) hold both kernels against
their plain versions on the card at ragged shapes and at encoder-small's,
three launches bit-identical, and the merge in place.  Run them there
with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_small_rank.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.kernels import lowrank_update as lu  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from _torch_parity import tf32, trunc_tf32  # noqa: E402

F32, BF = torch.float32, torch.bfloat16
# encoder-small's (K, N) of the low-rank forward and its grouped merges
ENC_SHAPES = [(256, 256), (256, 683), (683, 256)]
ENC_MERGE_SHAPES = [(4, 4, 256, 256), (2, 4, 256, 683), (1, 4, 683, 256)]
ENC_M, ENC_RANK = 512, 4          # M cut from the cell's 8192
# (M, K, N, r): ragged rows, rows that are no multiple of 4, both ranks of
# V's n8 blocks
RAGGED = [(5, 37, 19, 3), (16, 128, 130, 8), (1, 64, 33, 4),
          (33, 7, 200, 2), (300, 100, 70, 16), (129, 683, 257, 9)]


def _operands(M, K, N, r, seed=0):
    """x ~ N(0, 1), W ~ N(0, 1/K), V ~ N(0, 1/r), B ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((M, K)),
        rng.standard_normal((K, N)) / np.sqrt(K),
        rng.standard_normal((K, r)) / np.sqrt(r),
        0.1 * rng.standard_normal((N, r)))]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["shared", "p"])
@pytest.mark.parametrize("r", [1, 3, 4, 8, 16])
def test_fp32_small_rank_forward_takes_tf32x3(form, r):
    for K, N in ENC_SHAPES + [(37, 19), (640, 640)]:
        assert lf.tc_route(F32, K, N, r, (0, 4, 8, 12), form) == "tf32x3"
    assert lf.scratch_plan(form, "tf32x3", 8192, 256, 683, r) == {}


@pytest.mark.parametrize("form", ["shared", "p"])
@pytest.mark.parametrize("r", [17, 128])
def test_fp32_larger_rank_forward_keeps_simt(form, r):
    for K, N in ENC_SHAPES + [(640, 640)]:
        assert lf.tc_route(F32, K, N, r, (), form) == "simt"


@pytest.mark.parametrize("r", [1, 4, 16, 128])
def test_per_row_b_bf16_and_the_other_kernels_keep_their_routes(r):
    # the fp32 per-row-B (decode) form stays on SIMT
    assert lf.tc_route(F32, 256, 256, r, (), "batched") == "simt"
    # bf16 keeps "tc" where rows are multiples of 8, else SIMT
    want = "tc" if r % 8 == 0 else "simt"
    for form in ("shared", "p", "batched", None):
        assert lf.tc_route(BF, 256, 256, r, (0, 256), form) == want
        assert lf.tc_route(BF, 256, 683, r, (0, 256), form) == "simt"
    # without a form (the backward asks): tc or SIMT only
    assert lf.tc_route(F32, 256, 256, r) == "simt"


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("dtypes", [(F32, F32, F32), (F32, BF, F32),
                                    (BF, F32, BF), (F32, F32, BF)])
def test_fp32_small_rank_merge_takes_ew(dtypes, r):
    for K, N in ENC_SHAPES + [(37, 19), (640, 640)]:
        assert lu.merge_route(*dtypes, K, N, r, ptrs=(0, 4)) == "ew"


@pytest.mark.parametrize("r", [17, 128])
def test_larger_rank_rounded_and_bf16_merges_keep_their_routes(r):
    assert lu.merge_route(F32, F32, F32, 256, 683, r) == "simt"
    for small in (4, r):
        # the stochastically rounded merge keeps its own kernel
        assert lu.merge_route(BF, F32, F32, 256, 256, small,
                              bits=True) == "simt"
    # bf16 W and V: the tensor cores, or SIMT where TMA cannot address
    assert lu.merge_route(BF, BF, F32, 256, 256, 8, ptrs=(0, 256)) == "tc"
    assert lu.merge_route(BF, BF, F32, 256, 683, 4) == "simt"
    assert lu.merge_route(BF, BF, F32, 256, 256, 4) == "simt"


# ---------------------------------------------------------------------------
# The plain versions at encoder-small's shapes against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N", ENC_SHAPES)
def test_plain_forward_matches_jax_at_encoder_shapes(jref, K, N):
    jnp = jref.jnp
    x, w, v, b = _operands(ENC_M, K, N, ENC_RANK, seed=K + N)
    want = np.asarray(jref.dispatch._xla_forward(
        *(jnp.asarray(t.numpy()) for t in (x, w, v, b)), False))
    got = ref.lowrank_forward(x, w, v, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ENC_MERGE_SHAPES)
def test_plain_merge_matches_jax_at_encoder_shapes(jref, shape):
    jnp = jref.jnp
    rng = np.random.default_rng(sum(shape))
    lead, (K, N) = shape[:-2], shape[-2:]
    w, v, b = ((s * rng.standard_normal(d)).astype(np.float32) for s, d in (
        (K ** -0.5, shape), (0.5, lead + (K, ENC_RANK)),
        (0.02, lead + (N, ENC_RANK))))
    want = np.asarray(jref.dispatch.lowrank_merge(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(b)))
    got = ref.lowrank_merge(*(torch.from_numpy(a) for a in (w, v, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The forward's arithmetic emulated
# ---------------------------------------------------------------------------

def _mm_steps(a, b, hi_only=False):
    """a @ b as the kernel sums it: per 8-deep step of k, the lo·hi,
    hi·lo and hi·hi products of the 3xTF32 split (``tf32_mma.cuh``: hi
    rounded to TF32, lo = v - hi as the MMA reads it, cut to TF32), each
    summed exactly, added in turn to one fp32 sum; ``hi_only`` keeps the
    hi·hi product alone."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    ah, bh = tf32(a), tf32(b)
    al, bl = trunc_tf32(a - ah), trunc_tf32(b - bh)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        terms = [(ah[:, s], bh[s])] if hi_only else [
            (al[:, s], bh[s]), (ah[:, s], bl[s]), (ah[:, s], bh[s])]
        for u, w in terms:
            acc = (acc.double() + u.double() @ w.double()).float()
    return acc


def _f3_emulated(x, w, v, b, fault=None):
    """y = x W + p Bᵀ as the ``"tf32x3"`` kernel computes it: x W and p =
    x V as :func:`_mm_steps`, p kept in fp32, then the rank term by fp32
    FMAs in c order (each FMA exact in fp64, rounded once).  Faults:
    ``"hi_hi"`` (the cross products dropped), ``"p_tf32"`` (p rounded to
    TF32 before the rank term)."""
    y = _mm_steps(x, w, hi_only=fault == "hi_hi")
    p = _mm_steps(x, v, hi_only=fault == "hi_hi")
    if fault == "p_tf32":
        p = tf32(p)
    for c in range(p.shape[1]):
        y = (p[:, c:c + 1].double() * b[:, c].double()[None]
             + y.double()).float()
    return y


def _float64(x, w, v, b):
    x, w, v, b = (t.double() for t in (x, w, v, b))
    return x @ w + (x @ v) @ b.T


@pytest.mark.parametrize("K,N", ENC_SHAPES)
def test_emulated_tf32x3_forward_keeps_fp32_accuracy(K, N):
    ops = _operands(ENC_M, K, N, ENC_RANK, seed=K * N)
    want = _float64(*ops)
    err = (_f3_emulated(*ops).double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()
    # and within the same limit of the plain version the card compares to
    plain = ref.lowrank_forward(*ops).double()
    assert (plain - want).abs().max().item() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("fault", ["hi_hi", "p_tf32"])
@pytest.mark.parametrize("K,N", ENC_SHAPES)
def test_emulation_catches_planted_faults(K, N, fault):
    ops = _operands(ENC_M, K, N, ENC_RANK, seed=K * N)
    want = _float64(*ops)
    err = (_f3_emulated(*ops, fault=fault).double() - want).abs().max()
    assert err.item() > 1e-5 * want.abs().max().item()


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


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", RAGGED + [
    (8192, K, N, ENC_RANK) for K, N in ENC_SHAPES])
def test_tf32x3_forward_matches_plain_on_card(cuda, M, K, N, r):
    x, w, v, b = (t.to(cuda) for t in _operands(M, K, N, r, seed=M + N))
    want_y, want_p = ref.lowrank_forward(x, w, v, b, return_p=True)
    lf.reset_launches()
    ys = [lf.lowrank_forward(x, w, v, b) for _ in range(3)]
    yps = [lf.lowrank_forward(x, w, v, b, return_p=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert _rel_err(ys[0], want_y) <= 1e-5
    assert _rel_err(yps[0][0], want_y) <= 1e-5
    assert _rel_err(yps[0][1], want_p) <= 1e-5
    assert yps[0][1].dtype == F32 and yps[0][1].shape == (M, r)
    for again in ys[1:]:
        assert torch.equal(again, ys[0])
    for y, p in yps:
        assert torch.equal(y, ys[0]) and torch.equal(p, yps[0][1])
    assert lf.LAUNCHES == {("shared", "tf32x3", K, N): 3,
                           ("p", "tf32x3", K, N): 3}


@pytest.mark.cuda
@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("M,K,N,r", [(129, 683, 257, 9), (64, 256, 683, 4)])
def test_tf32x3_forward_takes_bases_off_16_bytes_on_card(cuda, M, K, N, r,
                                                         off):
    """x and W starting ``off`` floats past a 16-byte boundary (views into
    a larger buffer): the kernel copies them 4 bytes at a time."""
    ops = [t.to(cuda) for t in _operands(M, K, N, r, seed=off)]
    x, w = (torch.empty(t.numel() + off, device=cuda)[off:].view(t.shape)
            .copy_(t) for t in ops[:2])
    v, b = ops[2:]
    want_y, want_p = ref.lowrank_forward(x, w, v, b, return_p=True)
    lf.reset_launches()
    y, p = lf.lowrank_forward(x, w, v, b, return_p=True)
    torch.cuda.synchronize()
    assert _rel_err(y, want_y) <= 1e-5 and _rel_err(p, want_p) <= 1e-5
    assert lf.LAUNCHES == {("p", "tf32x3", K, N): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("shape", ENC_MERGE_SHAPES + [(3, 37, 19),
                                                      (683, 683)])
def test_ew_merge_matches_plain_on_card(cuda, shape, r):
    lead, (K, N) = shape[:-2], shape[-2:]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + r)
    w = K ** -0.5 * torch.randn(shape, generator=gen, device=cuda)
    v = torch.randn(lead + (K, r), generator=gen, device=cuda)
    b = 0.02 * torch.randn(lead + (N, r), generator=gen, device=cuda)
    want = ref.lowrank_merge(w, v, b)
    lu.reset_launches()
    got = [lu.lowrank_merge(w, v, b) for _ in range(3)]
    inplace = w.clone()
    assert lu.lowrank_merge(inplace, v, b, out=inplace) is inplace
    torch.cuda.synchronize()
    assert _rel_err(got[0], want) <= 1e-6
    assert all(torch.equal(g, got[0]) for g in got[1:])
    assert torch.equal(inplace, got[0])
    assert lu.LAUNCHES == {("lowrank_merge", "ew", tuple(shape)): 4}
    # a bf16 W (fp32 V): the fp32 sum rounded once, within a bf16 step
    wb = w.bfloat16()
    assert _rel_err(lu.lowrank_merge(wb, v, b),
                    ref.lowrank_merge(wb, v, b)) <= 1e-2
    assert lu.launches("lowrank_merge", "ew") == 5
