"""The launch plan and the split-K arithmetic of the tensor-core mainloop
(``csrc/wgmma_gemm.cuh``) behind the shared-B and ``return_p`` forward
and the backward.

On the CPU (no card needed):

* ``lowrank_forward.gemm_plan`` and ``gemm_units`` (the units in the
  kernel's own order, ``unit_of`` and ``seg_range``): at qwen2-7b's and
  mamba2-780m's eight serving shapes, llama-100m's four training shapes
  (every pass of the forward and the backward) and ragged ones, every
  output tile is owned by one tile index and split into ``splits``
  units; every split is non-empty, starts on a 64-deep stage and the
  splits cover the depth in order; the rank segments run in exactly one
  unit of each tile, the last split; the scratch holds one 128 × bn fp32
  partial per unit and the counters one int per tile.
* An emulation of the kernel's arithmetic: each unit's fp32 sum over its
  depth range (and, in the last split, the rank segments), the splits
  summed in split order, and only then the pass's epilogue (the hi/lo
  split of the whole fp32 sum for p and q).  It matches the JAX
  reference's XLA route (``dispatch._xla_forward`` / ``_xla_backward``)
  at small shapes whose plans split, within the limits of
  ``tests/test_torch_wgmma.py`` (1e-5 of the largest magnitude).  Two
  planted faults — one split dropped, and the hi/lo split taken per
  partial — fail it.

The ``cuda``-marked tests hold the kernels against their plain versions
at split and persistent shapes, M ∈ {1, 8, 128, 512, 16384}, aligned and
ragged, run three launches of each bit for bit alike, check the tile
counters are left zero, and hold the shared-B launches of at most
``SKINNY_ROWS`` rows (the per-row-B kernel with one B) to the plain
shared-B version.  They skip here with a reason; run them on a card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_gemm_plan.py``.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import lowrank_backward as lb  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

RANK = 128
EMU_REL = 1e-5
# (M, K, N): qwen2-7b at a 128-token prefill (the unembedding on one
# row), mamba2-780m at 512 (the unembedding on one row)
SERVING = [(128, 3584, 3584), (128, 3584, 512), (128, 3584, 18944),
           (128, 18944, 3584), (1, 3584, 152064), (512, 1536, 6448),
           (512, 3072, 1536), (1, 1536, 50432)]
# llama-100m at batch 64 x 256
TRAINING = [(16384, 640, 640), (16384, 640, 1712), (16384, 1712, 640),
            (16384, 640, 32256)]
RAGGED = [(1, 64, 8), (70, 1720, 1000), (200, 8, 136), (333, 4104, 24),
          (129, 520, 129 * 8), (5000, 64 * 9 + 8, 8 * 41)]


def _passes(M, K, N, r=RANK):
    """(name, rows, cols, depth, rank segment depths) of every pass of the
    forward (p, y) and the backward (q, dx, dB) at one shape."""
    return [("p", M, r, K, ()), ("y", M, N, K, (r, r)),
            ("q", M, r, N, ()), ("dx", M, K, N, (r, r)),
            ("dB", N, r, M, ())]


def _check_plan(rows, cols, depth, ranks):
    bn, s, cluster = lf.gemm_plan(rows, cols, depth, sum(ranks))
    assert bn in (64, 128, 256) and s >= 1 and cluster in (1, 2)
    units = lf.gemm_units(rows, cols, depth, bn, s, cluster, ranks)
    tiles_m, tiles_n = -(-rows // 128), -(-cols // bn)
    assert len(units) == tiles_m * tiles_n * s
    by_tile = {}
    for tile, z, m0, n0, (kb, ke), rank in units:
        by_tile.setdefault(tile, []).append((z, m0, n0, kb, ke, rank))
    # every output tile owned by one tile index, its splits adjacent
    assert sorted(by_tile) == list(range(tiles_m * tiles_n))
    owners = {(u[1], u[2]) for us in by_tile.values() for u in us}
    assert owners == {(128 * i, bn * j) for i in range(tiles_m)
                      for j in range(tiles_n)}
    for us in by_tile.values():
        assert [u[0] for u in us] == list(range(s))
        assert len({(u[1], u[2]) for u in us}) == 1
        # the splits cover [0, depth) in order, each non-empty and
        # starting on a stage; every split but one is 8 stages deep at
        # least
        assert us[0][3] == 0 and us[-1][4] == depth
        for a, b in zip(us, us[1:]):
            assert a[4] == b[3]
        for _, _, _, kb, ke, _ in us:
            assert kb % 64 == 0 and (kb < ke or depth == 0)
        if s > 1:
            assert all(ke - kb >= 8 * 64 for _, _, _, kb, ke, _ in us[:-1])
        # the rank segments in exactly one unit of the tile: the last
        assert [u[5] for u in us] == \
            [False] * (s - 1) + [bool(ranks)]
    if cluster == 2:
        # two blocks share B: tile rows in pairs, the two tiles of a pair
        # one above the other in one column, at adjacent units
        assert tiles_m % 2 == 0 and bn >= 128 and ranks
        for a, b in zip(units[::2], units[1::2]):
            assert (a[1], a[3], a[4]) == (b[1], b[3], b[4])
            assert b[2] == a[2] + 128 and a[2] % 256 == 0
    part, counters = lf.gemm_scratch(rows, cols, bn, s)
    assert counters == tiles_m * tiles_n
    assert part == (len(units) * 128 * bn if s > 1 else 0)


@pytest.mark.parametrize("M,K,N", SERVING + TRAINING + RAGGED)
def test_plans_own_every_tile_once_and_split_every_depth(M, K, N):
    for _, rows, cols, depth, ranks in _passes(M, K, N):
        _check_plan(rows, cols, depth, ranks)


def test_serving_passes_fit_one_round_and_split_the_deepest():
    # at prefill (M >= 128) every pass takes one round of units, so no
    # SM runs a second unit while others idle
    for M, K, N in SERVING:
        if M <= lf.SKINNY_ROWS:
            continue
        plan = lf.tc_plan("shared", M, K, N, RANK)
        for cols, (bn, s, _) in ((RANK, plan["p"]), (N, plan["y"])):
            assert -(-M // 128) * -(-cols // bn) * s <= lf.SMS
    # qwen2-7b w_down at 128 rows: 28 tiles of 128 over K = 18944; both
    # passes split K
    plan = lf.tc_plan("shared", 128, 18944, 3584, RANK)
    assert plan["p"][1] > 1 and plan["y"][1] > 1
    # the training passes fill the card with whole tiles: y, q and dx
    # unsplit
    for M, K, N in TRAINING:
        assert lf.tc_plan("p", M, K, N, RANK)["y"][1] == 1
        q, dx, _ = lb.tc_plan(M, K, N, RANK)
        assert q[1] == dx[1] == 1


@pytest.mark.parametrize("M", [1, 8, 16, 17, 128])
def test_shared_launches_of_few_rows_take_the_skinny_kernel(M):
    plan = lf.tc_plan("shared", M, 3584, 152064, RANK)
    assert plan["route"] == ("skinny" if M <= lf.SKINNY_ROWS else "gemm")
    # the return_p form always runs the mainloop (its p is bf16 hi)
    assert lf.tc_plan("p", M, 3584, 152064, RANK)["route"] == "gemm"
    scratch = lf.scratch_plan("shared", "tc", M, 3584, 152064, RANK, M)
    if M <= lf.SKINNY_ROWS:
        assert scratch == lf.scratch_plan("batched", "tc", M, 3584, 152064,
                                          RANK, M)


# ---------------------------------------------------------------------------
# The split-K arithmetic, emulated, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch)


def _bf16_exact(rng, *shape, scale=1.0):
    """fp32 values that bf16 holds exactly."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float()


def _emulate(a, b, rank=(), drop=None, per_split=None):
    """out = a @ b (+ the rank segments, each an (a_s, b_s) pair) as the
    kernel sums it: each unit's fp32 partial over its depth range, the
    rank segments in the last split, the splits added in split order.
    ``drop``: a split left out (a planted fault); ``per_split``: a
    function applied to each partial before the sum (another)."""
    rows, depth = a.shape
    cols = b.shape[1]
    _, s, _ = lf.gemm_plan(rows, cols, depth, sum(a_s.shape[1]
                                                  for a_s, _ in rank))
    chunk = -(-(-(-max(depth, 1) // s)) // 64) * 64
    total = torch.zeros(rows, cols)
    for z in range(s):
        kb, ke = z * chunk, min(depth, (z + 1) * chunk)
        part = a[:, kb:ke] @ b[kb:ke]
        if z == s - 1:
            for a_s, b_s in rank:
                part = part + a_s @ b_s
        if per_split is not None:
            part = per_split(part)
        if z != drop:
            total = total + part
    return total, s


def _forward(x, w, v, b, drop=None, per_split=None):
    """The route's p pass (its epilogue the hi/lo split of the whole sum)
    and y pass, fp32 before y's bf16 rounding."""
    p, s_p = _emulate(x, v, drop=drop)
    hi, lo = ref.split_hi_lo(p)
    if per_split is not None:
        # the planted fault: hi and lo taken per partial, then summed
        his, s_p = _emulate(x, v, per_split=lambda t: ref.split_hi_lo(t)[0]
                            .float())
        los, _ = _emulate(x, v, per_split=lambda t: ref.split_hi_lo(t)[1]
                          .float())
        hi, lo = his.bfloat16(), los.bfloat16()
    y, s_y = _emulate(x, w, rank=((hi.float(), b.T), (lo.float(), b.T)),
                      drop=drop)
    return y, hi, (s_p, s_y)


def _backward(dy, w, v, b, p):
    q, s_q = _emulate(dy, b)
    hi, lo = ref.split_hi_lo(q)
    dx, s_x = _emulate(dy, w.T, rank=((hi.float(), v.T), (lo.float(), v.T)))
    db, s_b = _emulate(dy.T.contiguous(), p)
    return dx, db, (s_q, s_x, s_b)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / \
        np.abs(want).max()


# shapes whose plans split every pass of the forward
FWD_SPLIT = [(16, 2048, 64, 8), (40, 1536, 136, 16), (130, 1032, 72, 24)]
# and of the backward (q, dx over N; dB over M)
BWD_SPLIT = [(1100, 64, 1536, 8), (1100, 136, 1032, 16)]


def _forward_operands(M, K, N, r):
    rng = np.random.default_rng(M + K + N + r)
    return (_bf16_exact(rng, M, K), _bf16_exact(rng, K, N, scale=K ** -0.5),
            _bf16_exact(rng, K, r, scale=K ** -0.5),
            _bf16_exact(rng, N, r, scale=0.5))


@pytest.mark.parametrize("M,K,N,r", FWD_SPLIT)
def test_split_forward_arithmetic_matches_jax(jref, M, K, N, r):
    x, w, v, b = _forward_operands(M, K, N, r)
    jnp = jref.jnp
    want_y, want_p = jref.dispatch._xla_forward(
        *(jnp.asarray(t.numpy()) for t in (x, w, v, b)), True)
    y, p_hi, splits = _forward(x, w, v, b)
    assert min(splits) > 1
    assert _rel(y.numpy(), want_y) <= EMU_REL
    # the return_p output is the whole p rounded once to bf16
    want_p = torch.from_numpy(np.array(want_p))
    assert bool(((p_hi.float() - want_p).abs()
                 <= 2.0 ** -8 * want_p.abs()).all())


@pytest.mark.parametrize("M,K,N,r", BWD_SPLIT)
def test_split_backward_arithmetic_matches_jax(jref, M, K, N, r):
    rng = np.random.default_rng(M * N + r)
    dy = _bf16_exact(rng, M, N, scale=0.1)
    w = _bf16_exact(rng, K, N, scale=K ** -0.5)
    v = _bf16_exact(rng, K, r, scale=K ** -0.5)
    b, p = _bf16_exact(rng, N, r, scale=0.5), _bf16_exact(rng, M, r)
    jnp = jref.jnp
    want_dx, want_db = jref.dispatch._xla_backward(
        *(jnp.asarray(t.numpy()) for t in (dy, w, v, b, p)))
    dx, db, splits = _backward(dy, w, v, b, p)
    assert min(splits) > 1
    assert _rel(dx.numpy(), want_dx) <= EMU_REL
    assert _rel(db.numpy(), want_db) <= EMU_REL


@pytest.mark.parametrize("fault", ["drop a split", "hi/lo per partial"])
@pytest.mark.parametrize("M,K,N,r", FWD_SPLIT)
def test_planted_split_faults_fail_the_emulation(jref, fault, M, K, N, r):
    x, w, v, b = _forward_operands(M, K, N, r)
    jnp = jref.jnp
    want_y, want_p = jref.dispatch._xla_forward(
        *(jnp.asarray(t.numpy()) for t in (x, w, v, b)), True)
    if fault == "drop a split":
        y, _, _ = _forward(x, w, v, b, drop=0)
    else:
        y, _, _ = _forward(x, w, v, b, per_split=True)
    assert _rel(y.numpy(), want_y) > EMU_REL


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


# (K, N, r): aligned to the tiles, and ragged (multiples of 8 only)
CARD = list(itertools.product((1, 8, 128, 512, 16384),
                              ((2048, 1024, 128), (1720, 1000, 24))))
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


def _counters_zero(dev):
    """The tile counters of ``dev`` (a tensor's device) are all zero."""
    buf = lf._COUNTERS.get(dev.index)
    return buf is None or int(buf.abs().sum().item()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,shape", CARD)
def test_split_and_persistent_forward_matches_plain_on_card(cuda, M, shape):
    K, N, r = shape
    x, w, v, b, _ = _operands(cuda, M, K, N, r, seed=M + K + N)
    runs = [(lf.lowrank_forward(x, w, v, b),
             *lf.lowrank_forward(x, w, v, b, return_p=True))
            for _ in range(3)]
    torch.cuda.synchronize()
    want_y, want_p = ref.lowrank_forward(x, w, v, b, return_p=True)
    y, y_p, p = runs[0]
    assert _within(y, want_y, BF16_TOL) and _within(y_p, want_y, BF16_TOL)
    assert _within(p, want_p, BF16_TOL)
    assert all(torch.equal(a, c) for run in runs[1:]
               for a, c in zip(runs[0], run))
    assert _counters_zero(x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("M,shape", CARD)
def test_split_and_persistent_backward_matches_plain_on_card(cuda, M, shape):
    K, N, r = shape
    x, w, v, b, dy = _operands(cuda, M, K, N, r, seed=M * 7 + K + N)
    p = (x.float() @ v.float()).bfloat16()
    runs = [lb.lowrank_backward(dy, w, v, b, p) for _ in range(3)]
    torch.cuda.synchronize()
    want_dx, want_db = ref.lowrank_backward(dy, w, v, b, p)
    dx, db = runs[0]
    assert _within(dx, want_dx, BF16_TOL) and _within(db, want_db, 1e-4)
    assert all(torch.equal(a, c) for run in runs[1:]
               for a, c in zip(runs[0], run))
    assert _counters_zero(dy.device)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("K,N", [(3584, 4096), (1536, 50432 // 8)])
def test_skinny_shared_route_matches_plain_on_card(cuda, M, K, N):
    x, w, v, b, _ = _operands(cuda, M, K, N, RANK, seed=M + N)
    lf.reset_launches()
    y = lf.lowrank_forward(x, w, v, b)
    torch.cuda.synchronize()
    assert _within(y, ref.lowrank_forward(x, w, v, b), BF16_TOL)
    assert lf.launches("shared", "tc") == 1 and lf.launches() == 1
    assert _counters_zero(x.device)
