"""The tensor-core route of the weight merge ``W + V Bᵀ`` and of GaLore's
projection ``Gᵀ V`` (``csrc/lowrank_merge.cu``, ``csrc/lowrank_project.cu``).

On the CPU (no card needed):

* ``lowrank_update.merge_route`` sends every llama-100m group shape in
  the dtypes the training path runs (bf16 W and V; an fp32 or bf16 B) to
  ``"tc"``, and fp32 W or V at rank above 16 (at most 16: ``"ew"``,
  ``tests/test_torch_small_rank.py``), rounding ``bits``, a row length
  that is no multiple of 8 and a pointer off a 16-byte boundary to
  ``"simt"``;
  ``project_route`` likewise for an fp32 or bf16 G with a bf16 V.
* The projection's split plan: its K ranges cover K in whole 64-deep
  stages, none is empty, and the blocks (tiles x ranges) fill one wave of
  the card's 132 SMs wherever K is deep enough for more ranges.
* The route's arithmetic emulated in plain PyTorch, an fp32 B or G
  carried as ``ref.split_hi_lo``'s bf16 (hi, lo) pair and every product
  summed in fp32, against the JAX package's Pallas kernels in interpret
  mode, item by item, at small ragged item-batched shapes.  Merge: every
  element within one bf16 step of the reference, the step taken at
  ``|W'| + d`` and ``d`` added, where ``d = 2⁻¹⁶ (|V| |B|ᵀ)`` bounds how
  far the pair and the fp32 sum move ``V Bᵀ``: near a cancellation
  (``|W'|`` far below ``|V Bᵀ|``) a bf16 step is smaller than the sum's
  own fp32 error.  Measured on the CPU: 125 of 310,432 elements differ,
  each by one step (at most 0.9984 of the allowance); with a bf16 B, 4.
  Projection: within 1e-5 of max|out|, unsplit and split (measured: at
  most 2.9e-6 with an fp32 G, 2.7e-7 with a bf16 one).

The ``cuda``-marked tests hold both kernels against their plain versions
on the card at ragged item edges (K = 1712, N no multiple of 128, r ∈
{8, 64, 128}, several items): the merge with an fp32 and a bf16 B,
within one bf16 step as above, in place equal to out of place; the
projection within 1e-4 of max|out|, split and unsplit, two launches bit
for bit equal; and check which route each launch took.  They skip here
with a reason; run them on a card with ``PYTHONPATH=src python -m pytest
-m cuda tests/test_torch_update_tc.py``.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import lowrank_update as lu  # noqa: E402
from repro_torch.models import lm  # noqa: E402

RANK = 128
BF, F32 = torch.bfloat16, torch.float32
LOWRANK = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "unembed")
ALIGNED = (0, 256, 512, 768)
PROJECT_REL = 1e-5


def _llama_shapes():
    """(K, N) of every low-rank weight of llama-100m at full size, from
    the parameter specs (nothing is allocated)."""
    out = set()

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in LOWRANK:
                out.add(tuple(val.shape[-2:]))
    walk(lm.param_specs(get_config("llama-100m")))
    return sorted(out)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def test_every_llama_group_shape_takes_the_tensor_cores():
    shapes = _llama_shapes()
    assert {(640, 640), (640, 1712), (1712, 640), (640, 32256)} <= set(shapes)
    for K, N in shapes:
        for b_dtype in (F32, BF):
            assert lu.merge_route(BF, BF, b_dtype, K, N, RANK,
                                  ptrs=ALIGNED) == "tc"
        for g_dtype in (F32, BF):
            assert lu.project_route(g_dtype, BF, K, N, RANK,
                                    ptrs=ALIGNED[:3]) == "tc"


@pytest.mark.parametrize("dtypes", [(F32, F32, F32), (F32, BF, F32),
                                    (BF, F32, F32), (BF, BF, torch.float16)])
def test_merge_takes_simt_for_other_dtypes(dtypes):
    assert lu.merge_route(*dtypes, 640, 640, RANK) == "simt"


@pytest.mark.parametrize("K,N,r", [(37, 64, 8), (64, 70, 8), (64, 64, 4),
                                   (1712, 640, 12)])
def test_rows_that_are_no_multiple_of_8_take_simt(K, N, r):
    assert lu.merge_route(BF, BF, F32, K, N, r) == "simt"
    assert lu.project_route(F32, BF, K, N, r) == "simt"


def test_bits_fp32_v_and_misaligned_pointers_take_simt():
    # the stochastically rounded merge keeps its SIMT kernel
    assert lu.merge_route(BF, BF, BF, 640, 640, RANK, bits=True) == "simt"
    assert lu.project_route(F32, F32, 640, 640, RANK) == "simt"
    assert lu.project_route(torch.float16, BF, 640, 640, RANK) == "simt"
    assert lu.merge_route(BF, BF, F32, 640, 640, RANK,
                          ptrs=(0, 256, 8, 512)) == "simt"
    assert lu.project_route(F32, BF, 640, 640, RANK,
                            ptrs=(4, 256, 512)) == "simt"
    assert lu.merge_route(BF, BF, F32, 640, 640, RANK,
                          ptrs=(16, 32, 48, 64)) == "tc"


def test_launch_counts_are_kept_by_route():
    lu.reset_launches()
    lu.LAUNCHES[("lowrank_merge", "tc", (2, 8, 8))] += 2
    lu.LAUNCHES[("lowrank_merge_sr", "simt", (2, 8, 8))] += 1
    lu.LAUNCHES[("lowrank_project", "tc", (8, 8))] += 1
    assert lu.launches() == 4 and lu.launches(route="tc") == 3
    assert lu.launches("lowrank_merge") == lu.launches("lowrank_merge",
                                                       "tc") == 2
    assert lu.launches("lowrank_merge_sr", "tc") == 0
    lu.reset_launches()
    assert lu.launches() == 0


# ---------------------------------------------------------------------------
# The projection's split plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(48, 640, 640, 128), (24, 640, 1712, 128),
               (12, 1712, 640, 128), (1, 640, 32256, 128),
               (1, 1712, 640, 128), (3, 1712, 64, 16), (1, 4096, 64, 16),
               (2, 72, 136, 64), (1, 8, 8, 8), (7, 1000, 200, 136)]


@pytest.mark.parametrize("items,K,N,r", PLAN_SHAPES)
def test_project_ranges_cover_k_in_whole_stages(items, K, N, r):
    s = lu.project_plan(items, K, N, r)
    ranges = lu.project_ranges(K, s)
    assert len(ranges) == s >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for kb, ke in ranges:
        assert kb < ke and kb % lu.PROJECT_BK == 0
        assert ke == K or (ke - kb) % lu.PROJECT_BK == 0
        if s > 1:
            assert ke - kb >= min(K - kb, lu.PROJECT_MIN_STAGES
                                  * lu.PROJECT_BK)


@pytest.mark.parametrize("items,K,N,r", PLAN_SHAPES)
def test_project_plan_fills_one_wave_where_k_allows(items, K, N, r):
    s = lu.project_plan(items, K, N, r)
    tiles = lu.project_tiles(items, N, r)
    stages = -(-K // lu.PROJECT_BK)
    assert tiles * s <= max(tiles, lu.SMS)
    k_limited = s == max(1, stages // lu.PROJECT_MIN_STAGES)
    assert tiles * (s + 1) > lu.SMS or k_limited


def test_project_plan_at_the_llama_groups():
    # 240, 336 and 252 tiles fill the card unsplit; w_down's 60 take two
    # ranges of 13 and 14 stages (120 blocks)
    assert [lu.project_plan(*shape) for shape in PLAN_SHAPES[:4]] == \
        [1, 1, 2, 1]
    assert lu.project_ranges(1712, 2) == [(0, 832), (832, 1712)]


# ---------------------------------------------------------------------------
# The route's arithmetic against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.lowrank_update import lowrank_merge, lowrank_project
    return SimpleNamespace(jnp=jnp, merge=lowrank_merge,
                           project=lowrank_project)


def _tc_merge(w, v, b):
    """The tensor-core merge's arithmetic in plain PyTorch: an fp32 B as
    its bf16 (hi, lo) pair, ``V B_hiᵀ + V B_loᵀ`` summed in fp32 (the
    products of bf16 values are exact), W added in fp32 and the sum
    rounded once to bf16."""
    vf = v.float()
    if b.dtype == F32:
        hi, lo = ref.split_hi_lo(b)
        acc = vf @ hi.float().mT + vf @ lo.float().mT
    else:
        acc = vf @ b.float().mT
    return (w.float() + acc).to(BF)


def _tc_project(g, v, splits):
    """The tensor-core projection's arithmetic in plain PyTorch: each K
    range's partial ``G_hiᵀ V + G_loᵀ V`` (an fp32 G as its bf16 pair) in
    fp32, the partials summed in range order."""
    out = None
    for kb, ke in lu.project_ranges(g.shape[-2], splits):
        gz, vz = g[..., kb:ke, :], v[..., kb:ke, :].float()
        if g.dtype == F32:
            hi, lo = ref.split_hi_lo(gz)
            part = hi.float().mT @ vz + lo.float().mT @ vz
        else:
            part = gz.float().mT @ vz
        out = part if out is None else out + part
    return out


def one_bf16_step(got, want, v, b):
    """``|got - want|`` over the allowance of the module docstring: one
    bf16 step at ``|want| + d``, plus ``d = 2⁻¹⁶ (|V| |B|ᵀ)``; at most 1
    everywhere when every element is within one step."""
    d = 2.0 ** -16 * (v.float().abs() @ b.float().abs().mT)
    mag = (want.float().abs() + d).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want.float()).abs() / (step + d)).max().item()


def _merge_operands(lead, K, N, r, b_dtype, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(
        (rng.standard_normal(lead + (K, N)) / np.sqrt(K)).astype(np.float32))
    v = torch.from_numpy(
        (rng.standard_normal(lead + (K, r)) / np.sqrt(r)).astype(np.float32))
    b = torch.from_numpy(
        (0.02 * rng.standard_normal(lead + (N, r))).astype(np.float32))
    return w.to(BF), v.to(BF), b.to(b_dtype)


def _jax(jref, t):
    return jref.jnp.asarray(t.float().numpy()).astype(
        {F32: jref.jnp.float32, BF: jref.jnp.bfloat16}[t.dtype])


@pytest.mark.parametrize("lead,K,N,r", [((2,), 200, 72, 24),
                                        ((3,), 136, 200, 8),
                                        ((2,), 256, 136, 136)])
@pytest.mark.parametrize("b_dtype", [F32, BF])
def test_merge_route_arithmetic_matches_the_pallas_kernel(jref, lead, K, N,
                                                          r, b_dtype):
    w, v, b = _merge_operands(lead, K, N, r, b_dtype, seed=K + N + r)
    got = _tc_merge(w, v, b)
    want = torch.stack([
        torch.from_numpy(np.asarray(
            jref.merge(_jax(jref, w[i]), _jax(jref, v[i]), _jax(jref, b[i]),
                       interpret=True)).astype(np.float32))
        for i in range(lead[0])]).to(BF)
    assert got.dtype == want.dtype == BF
    assert one_bf16_step(got, want, v, b) <= 1.0
    # the hi/lo pair changes a round only here and there
    assert (got != want).float().mean().item() < 0.05


@pytest.mark.parametrize("lead,K,N,r,splits", [((2,), 200, 72, 24, 1),
                                               ((2,), 512, 136, 8, 1),
                                               ((2,), 512, 136, 8, 3),
                                               ((3,), 200, 200, 136, 2)])
@pytest.mark.parametrize("g_dtype", [F32, BF])
def test_project_route_arithmetic_matches_the_pallas_kernel(
        jref, lead, K, N, r, splits, g_dtype):
    rng = np.random.default_rng(K * N + splits)
    g = torch.from_numpy(
        (1e-3 * rng.standard_normal(lead + (K, N))).astype(np.float32))
    v = torch.from_numpy(
        (rng.standard_normal(lead + (K, r)) / np.sqrt(K)).astype(np.float32))
    g, v = g.to(g_dtype), v.to(BF)
    got = _tc_project(g, v, splits)
    want = np.stack([np.asarray(jref.project(
        _jax(jref, g[i]), _jax(jref, v[i]), interpret=True))
        for i in range(lead[0])])
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= PROJECT_REL * np.abs(want).max()


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


# ragged item edges: K = 1712 = 13 x 128 + 48, N no multiple of 128
# (K >= 1024 walks column strips, fewer k tiles the grouped order; r = 136
# takes two rank rounds)
MERGE_EDGE = [((2,), 1712, 200, 8), ((3,), 1712, 72, 64),
              ((2, 2), 1712, 136, 128), ((4,), 640, 1712, 128),
              ((2,), 1024, 72, 136), ((3,), 256, 200, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("b_dtype", [F32, BF])
@pytest.mark.parametrize("lead,K,N,r", MERGE_EDGE)
def test_tc_merge_matches_plain_on_card(cuda, b_dtype, lead, K, N, r):
    w, v, b = (t.to(cuda) for t in _merge_operands(lead, K, N, r, b_dtype,
                                                    seed=K * N + r))
    lu.reset_launches()
    got = lu.lowrank_merge(w, v, b)
    inplace = w.clone()
    assert lu.lowrank_merge(inplace, v, b, out=inplace) is inplace
    torch.cuda.synchronize()
    want = ref.lowrank_merge(w, v, b)
    assert got.dtype == BF and torch.equal(inplace, got)
    assert one_bf16_step(got, want, v, b) <= 1.0
    assert lu.launches("lowrank_merge", "tc") == 2 and lu.launches() == 2


# (lead, K, N, r, whether the plan splits K)
PROJECT_EDGE = [((3,), 1712, 200, 8, True), ((12,), 1712, 640, 128, True),
                ((1,), 1712, 640, 128, True), ((2, 3), 72, 136, 64, False),
                ((2,), 640, 200, 136, True), ((48,), 640, 640, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [F32, BF])
@pytest.mark.parametrize("lead,K,N,r,split", PROJECT_EDGE)
def test_tc_project_matches_plain_on_card(cuda, g_dtype, lead, K, N, r,
                                          split):
    assert (lu.project_plan(math.prod(lead), K, N, r) > 1) == split
    gen = torch.Generator(device=cuda)
    gen.manual_seed(K + N + r)
    g = (1e-3 * torch.randn(lead + (K, N), generator=gen,
                            device=cuda)).to(g_dtype)
    v = (K ** -0.5 * torch.randn(lead + (K, r), generator=gen,
                                 device=cuda)).to(BF)
    lu.reset_launches()
    got = lu.lowrank_project(g, v)
    again = lu.lowrank_project(g, v)
    torch.cuda.synchronize()
    want = ref.lowrank_project(g, v)
    assert got.dtype == F32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= \
        1e-4 * want.abs().max().item()
    # fixed-order sums, no float atomics
    assert torch.equal(got, again)
    assert lu.launches("lowrank_project", "tc") == 2 and lu.launches() == 2


@pytest.mark.cuda
def test_routes_on_card(cuda):
    w, v, b = (t.to(cuda) for t in _merge_operands((2,), 64, 64, 8, F32, 0))
    bits = torch.randint(0, 1 << 16, w.shape, dtype=torch.int32,
                         device=cuda)
    lu.reset_launches()
    lu.lowrank_merge(w.float(), v, b)                # fp32 W, r = 8
    lu.lowrank_merge(w, v, b.bfloat16(), bits=bits)  # the rounded merge
    lu.lowrank_project(w.float(), v.float())         # fp32 V
    lu.lowrank_project(w.float(), v)
    torch.cuda.synchronize()
    assert lu.LAUNCHES == {("lowrank_merge", "ew", (2, 64, 64)): 1,
                           ("lowrank_merge_sr", "simt", (2, 64, 64)): 1,
                           ("lowrank_project", "simt", (2, 64, 64)): 1,
                           ("lowrank_project", "tc", (2, 64, 64)): 1}
    # a row that TMA cannot address: 2 bytes off a 16-byte boundary
    buf = torch.empty(w.numel() + 1, dtype=BF, device=cuda)
    off = buf[1:].view(w.shape).copy_(w)
    lu.reset_launches()
    lu.lowrank_merge(off, v, b, out=off)
    assert lu.launches("lowrank_merge", "simt") == 1
