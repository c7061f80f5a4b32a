"""The tensor-core route of the low-rank forward and backward kernels.

On the CPU (no card needed):

* ``lowrank_forward.tc_route`` sends every (K, N, r) that qwen2-7b,
  mamba2-780m and llama-100m give the kernels in bf16 to ``"tc"``, and
  fp32, the unaligned shapes of the ragged kernel tests and a pointer
  off a 16-byte boundary to ``"simt"``.
* ``ref.split_hi_lo`` (how the route feeds the fp32 ``p = x V`` and
  ``q = dy B`` to bf16 ``wgmma`` segments): ``hi + lo`` is within
  2⁻¹⁶·|p| of ``p``.  A plain emulation of the route's passes — bf16
  operands, whose products are exact in fp32, summed in fp32, with ``p``
  and ``q`` carried as ``hi + lo`` — matches the JAX reference's XLA
  route (``dispatch._xla_forward`` / ``_xla_backward``) on fp32 inputs
  that bf16 holds exactly: ``y`` and ``dx`` before their bf16 rounding
  within 1e-5 of max|y| and max|dx| (the rank-r term is off by up to
  2⁻¹⁸ of each ``|p_c B_nc|`` term, and fp32 sums run in another order:
  about 1e-6 at K = 1712), ``dB`` within 1e-5 of max|dB| (both sides sum
  the same exact products in fp32).
* The wrappers' scratch plans: the tensor-core forward allocates p's
  bf16 (hi, lo) pair and a 128 × bn fp32 partial per unit of each pass
  that splits K (a shared-B launch of a few rows: the per-row-B
  kernel's plan); the backward's ``dB`` splits leave no M range empty.

The ``cuda``-marked tests hold the tensor-core route against the plain
versions on the card at aligned edge shapes — M ∈ {1, 70, 200}, K ∈
{64, 1712}, N ∈ {64, 1712, 6448}, r ∈ {8, 128} — in all three forms, at
the limits of ``tests/test_torch_train_kernels.py`` (bf16 outputs 2e-2
of their largest magnitude, fp32 dB 1e-4), and check that each launch
took ``"tc"``.  They skip here with a reason; run them on a card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_wgmma.py``.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import lowrank_backward as lb  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.models import lm  # noqa: E402

RANK = 128
LOWRANK = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
           "out_proj", "unembed")
EMU_REL = 1e-5


def _model_shapes(arch):
    """(K, N) of every low-rank weight of ``arch`` at full size, from the
    parameter specs (nothing is allocated)."""
    out = set()

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in LOWRANK:
                out.add(tuple(val.shape[-2:]))
    walk(lm.param_specs(get_config(arch)))
    return sorted(out)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-780m", "llama-100m",
                                  "zamba2-7b"])
def test_every_full_size_bf16_shape_takes_the_tensor_cores(arch):
    shapes = _model_shapes(arch)
    assert len(shapes) >= 3
    for K, N in shapes:
        r = max(1, min(RANK, min(K, N) // 2))
        # the forward's (K, N, r) and the backward's, from 256-byte
        # aligned allocations
        assert lf.tc_route(torch.bfloat16, K, N, r, (0, 256, 512)) == "tc"


@pytest.mark.parametrize("K,N,r", [(37, 19, 3), (128, 130, 8), (64, 33, 4),
                                   (7, 200, 2)])
def test_unaligned_rows_take_simt(K, N, r):
    assert lf.tc_route(torch.bfloat16, K, N, r) == "simt"


def test_fp32_and_misaligned_pointers_take_simt():
    assert lf.tc_route(torch.float32, 640, 640, 128) == "simt"
    assert lf.tc_route(torch.bfloat16, 640, 640, 128, (0, 8)) == "simt"
    assert lf.tc_route(torch.bfloat16, 640, 640, 128, (0, 16, 32)) == "tc"


# ---------------------------------------------------------------------------
# The hi/lo split and the route's arithmetic against JAX
# ---------------------------------------------------------------------------

def test_hi_lo_split_keeps_sixteen_bits():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(
        (rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096))
        .astype(np.float32))
    hi, lo = ref.split_hi_lo(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, p.bfloat16())
    err = (hi.float() + lo.float() - p).abs()
    assert bool((err <= 2.0 ** -16 * p.abs()).all())
    # bf16 alone keeps 8 bits: the pair is what holds fp32 p's precision
    assert (hi.float() - p).abs().max() > 2.0 ** -16 * p.abs().max()


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch)


def _bf16_exact(rng, *shape, scale=1.0):
    """fp32 values that bf16 holds exactly."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


def _tc_forward(x, w, v, b):
    """The route's passes in plain PyTorch: p = x V, then
    y = x W + p_hi Bᵀ + p_lo Bᵀ, fp32 before y's bf16 rounding."""
    hi, lo = ref.split_hi_lo(x @ v)
    return x @ w + hi.float() @ b.T + lo.float() @ b.T, hi


def _tc_backward(dy, w, v, b, p):
    hi, lo = ref.split_hi_lo(dy @ b)
    return dy @ w.T + hi.float() @ v.T + lo.float() @ v.T, dy.T @ p


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / \
        np.abs(want).max()


@pytest.mark.parametrize("M,K,N,r", [(70, 1712, 64, 8), (33, 64, 1712, 16),
                                     (16, 640, 640, 128)])
def test_route_arithmetic_matches_jax_forward(jref, M, K, N, r):
    rng = np.random.default_rng(M + K)
    x, w = _bf16_exact(rng, M, K), _bf16_exact(rng, K, N, scale=K ** -0.5)
    v = _bf16_exact(rng, K, r, scale=K ** -0.5)
    b = _bf16_exact(rng, N, r, scale=0.1)
    jnp = jref.jnp
    want_y, want_p = jref.dispatch._xla_forward(
        *(jnp.asarray(a) for a in (x, w, v, b)), True)
    y, p_hi = _tc_forward(*(torch.from_numpy(a) for a in (x, w, v, b)))
    assert _rel(y.numpy(), want_y) <= EMU_REL
    # the route's return_p output is p rounded once to bf16
    want_p = torch.from_numpy(np.array(want_p))
    assert bool(((p_hi.float() - want_p).abs()
                 <= 2.0 ** -8 * want_p.abs()).all())


@pytest.mark.parametrize("M,K,N,r", [(70, 1712, 64, 8), (33, 64, 1712, 16),
                                     (16, 640, 640, 128)])
def test_route_arithmetic_matches_jax_backward(jref, M, K, N, r):
    rng = np.random.default_rng(M + N)
    dy = _bf16_exact(rng, M, N, scale=0.1)
    w = _bf16_exact(rng, K, N, scale=K ** -0.5)
    v = _bf16_exact(rng, K, r, scale=K ** -0.5)
    b, p = _bf16_exact(rng, N, r, scale=0.1), _bf16_exact(rng, M, r)
    jnp = jref.jnp
    want_dx, want_db = jref.dispatch._xla_backward(
        *(jnp.asarray(a) for a in (dy, w, v, b, p)))
    dx, db = _tc_backward(*(torch.from_numpy(a) for a in (dy, w, v, b, p)))
    assert _rel(dx.numpy(), want_dx) <= EMU_REL
    assert _rel(db.numpy(), want_db) <= EMU_REL


# ---------------------------------------------------------------------------
# Scratch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["shared", "p"])
@pytest.mark.parametrize("M,K,N", [(8192, 640, 32256), (16384, 1712, 640),
                                   (1, 3584, 152064), (512, 1536, 6448)])
def test_tc_forward_scratch_plan_holds_the_split_partials(form, M, K, N):
    plan = lf.scratch_plan(form, "tc", M, K, N, RANK, M)
    if lf.tc_plan(form, M, K, N, RANK)["route"] == "skinny":
        # a shared-B launch of a few rows runs the per-row-B kernel
        assert plan == lf.scratch_plan("batched", "tc", M, K, N, RANK, M)
        return
    # p as a bf16 (hi, lo) pair: hi is the "p" form's output itself
    bf16 = {"p_hi", "p_lo"} if form == "shared" else {"p_lo"}
    assert all(plan[name] == ((M, RANK), torch.bfloat16) for name in bf16)
    # one 128 x bn fp32 partial per unit of each pass that splits K
    want = set(bf16)
    passes = lf.tc_plan(form, M, K, N, RANK)
    for name, cols, (bn, s, _) in (("part_p", RANK, passes["p"]),
                                ("part_y", N, passes["y"])):
        if s > 1:
            want.add(name)
            assert plan[name] == ((-(-M // 128) * -(-cols // bn) * s
                                   * 128 * bn,), torch.float32)
    assert set(plan) == want


def test_simt_forward_keeps_its_partials_where_it_splits():
    # a decode-sized shared-B forward splits K into fp32 partials
    plan = lf.scratch_plan("shared", "simt", 4, 3584, 3584, RANK)
    assert plan["y_part"][0] == (lf.splits(4, 3584, 3584), 4, 3584)
    # a training-sized one does not: one split, y written directly
    plan = lf.scratch_plan("shared", "simt", 16384, 640, 640, RANK)
    assert "y_part" not in plan and lf.splits(16384, 640, 640) == 1
    # the per-row-B form always reduces its partials in finish
    assert "y_part" in lf.scratch_plan("batched", "simt", 16384, 640, 640,
                                       RANK)


@pytest.mark.parametrize("M,N,r", [(16384, 640, 128), (16384, 1712, 128),
                                   (16384, 32256, 128), (5, 19, 8),
                                   (256, 8, 8), (70, 6448, 128),
                                   (1000, 64, 8)])
def test_tc_db_splits_cover_m_with_nonempty_ranges(M, N, r):
    bn, s, _ = lb.tc_plan(M, 640, N, r)[2]
    chunk = -(-(-(-M // s)) // 64) * 64          # the kernel's rounding
    assert s >= 1 and (s - 1) * chunk < M <= s * chunk
    plan = lb.scratch_plan("tc", M, N, r, 640)
    assert ("part_b" in plan) == (s > 1)
    if s > 1:
        tiles = -(-N // 128) * -(-r // bn)
        assert plan["part_b"] == ((tiles * s * 128 * bn,), torch.float32)


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


EDGE = list(itertools.product((1, 70, 200), (64, 1712), (64, 1712, 6448),
                              (8, 128)))
BF16_TOL = 2e-2


def _operands(dev, M, K, N, r, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(
            torch.bfloat16)
    return (rnd(M, K), rnd(K, N, scale=K ** -0.5), rnd(K, r, scale=K ** -0.5),
            rnd(N, r, scale=0.1), rnd(M, N, scale=0.1))


def _within(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    return err <= rtol * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", EDGE)
def test_tc_forward_matches_plain_on_card(cuda, M, K, N, r):
    x, w, v, b, _ = _operands(cuda, M, K, N, r, seed=M + K + N + r)
    lf.reset_launches()
    y = lf.lowrank_forward(x, w, v, b)
    y_p, p = lf.lowrank_forward(x, w, v, b, return_p=True)
    torch.cuda.synchronize()
    want_y, want_p = ref.lowrank_forward(x, w, v, b, return_p=True)
    assert _within(y, want_y, BF16_TOL) and _within(y_p, want_y, BF16_TOL)
    assert _within(p, want_p, BF16_TOL)
    assert lf.launches("shared", "tc") == 1 and lf.launches("p", "tc") == 1
    assert lf.launches() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", EDGE)
def test_tc_backward_matches_plain_on_card(cuda, M, K, N, r):
    x, w, v, b, dy = _operands(cuda, M, K, N, r, seed=M * K + N * r)
    p = (x.float() @ v.float()).bfloat16()
    lb.reset_launches()
    dx, db = lb.lowrank_backward(dy, w, v, b, p)
    torch.cuda.synchronize()
    want_dx, want_db = ref.lowrank_backward(dy, w, v, b, p)
    assert dx.dtype == torch.bfloat16 and db.dtype == torch.float32
    assert _within(dx, want_dx, BF16_TOL)
    assert _within(db, want_db, 1e-4)
    assert lb.launches("tc") == 1 and lb.launches() == 1
