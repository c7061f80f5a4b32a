"""zamba2-7b's kernel shapes and the hybrid's and sampled decoding's card
paths.  This file imports no JAX, so its ``cuda``-marked tests run on a
card host (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_hybrid_kernels.py``); they skip here with a reason.

On the CPU:

* every low-rank (K, N) of zamba2-7b at full size, r = 128, bf16,
  takes the tensor-core route in both forms, and its in_proj (14576
  columns) is no multiple of any tile width the mainloop plans;
* the SSD kernel's split at zamba2-7b's prefill shapes (112 heads, N =
  64): two state tiles and four strip pairs, so chunk parts 2 and 3 own
  y rows and no state rows.

On the card:

* the shared-B forward against its plain version at zamba2-7b's
  prefill shapes (bf16, 2e-2·(max|y| + |y|): bf16 output rounding, fp32
  sums in another order; the per-row-B form's shapes are in
  ``tests/test_torch_decode_forward.py``, the SSD kernel's in
  ``tests/test_torch_ssd.py``);
* a bf16 paged decode step of the reduced hybrid, and a sampled bf16
  decode step of the engine, under ``set_sync_debug_mode("error")``;
* the SSD kernel and its backward at zamba2-7b's training shape (BC 64
  = batch 8 x 1024 in chunks of 128, 112 heads, P 64, N 64, one B/C
  group; the backward on its heads instance with constant bounds at Q
  = 128, N = 64): each output
  and gradient within 1e-4 of its largest magnitude of the plain
  version's, dt and A by the mixer's laws and under a decay far past
  expf's overflow; three backward launches bit-identical; the backward
  equal bit for bit to the ragged instance's (``_build.RAGGED``) at
  that shape and at mamba2-780m's; the bounds-checked builds trap on no
  index and equal the unchecked builds bit for bit.  The split of that
  launch and the instance it takes are checked on the CPU in
  ``tests/test_torch_hybrid_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import (AdapterStore, Engine,  # noqa: E402
                               EngineConfig, Request, batched_pack_tree)

RANK = 128
BF16_TOL = 2e-2
LOWRANK = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
           "out_proj", "unembed")
ZAMBA = get_config("zamba2-7b")
# zamba2-7b's (K, N) at prefill -> rows: a 512-token prompt through the
# projections, the unembedding at the last position
PREFILL_SHAPES = [(3584, 14576, 512), (7168, 3584, 512), (3584, 3584, 512),
                  (3584, 14336, 512), (14336, 3584, 512), (3584, 32000, 1)]
# (BC, Q, H, P, N) of zamba2-7b's prefills of 100, 128, 256, 512 tokens
SSD_SHAPES = [(1, 100, 112, 64, 64), (1, 128, 112, 64, 64),
              (2, 128, 112, 64, 64), (4, 128, 112, 64, 64)]
# (BC, Q, H, P, N) of zamba2-7b's training step at batch 8 x 1024
SSD_TRAIN_SHAPE = (64, 128, 112, 64, 64)
SSD_REL = 1e-4      # fp32 sums in another order, clog up to hundreds


def test_prefill_shapes_are_the_models():
    shapes = set()

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in LOWRANK:
                shapes.add(tuple(val.shape[-2:]))
    walk(lm.param_specs(ZAMBA))
    assert shapes == {(K, N) for K, N, _ in PREFILL_SHAPES}
    assert ZAMBA.ssm_heads == 112 and ZAMBA.ssd_chunk == 128


@pytest.mark.parametrize("K,N,M", PREFILL_SHAPES)
def test_every_zamba2_shape_takes_the_tensor_cores(K, N, M):
    for form in ("shared", "batched"):
        assert lf.tc_route(torch.bfloat16, K, N, RANK, (0, 256, 512),
                           form=form) == "tc"
    if N == 14576:
        assert all(N % w for w in (64, 128, 256))    # a ragged last tile


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_split_at_zamba2_shapes_has_y_only_parts(shape):
    BC, Q, H, P, N = shape
    plan = sc.ssd_plan(BC, Q, H, N, P, True)
    assert (plan.n_tiles, plan.pairs, plan.parts) == (2, 4, 4)
    roles = [sc.ssd_cta(plan, Q, H, N, c)
             for c in range(plan.gram_ctas, plan.ctas)]
    y_only = [r for r in roles if r[3] and not r[4]]
    assert len(y_only) == BC * H * 2
    assert plan.chunk_ctas >= 132


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


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", PREFILL_SHAPES)
def test_shared_b_forward_matches_plain_at_zamba2_shapes(cuda, K, N, M):
    g = torch.Generator(device=cuda)
    g.manual_seed(K + N + M)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=cuda)).to(
            torch.bfloat16)
    x, w = rnd(M, K), rnd(K, N, scale=K ** -0.5)
    v, b = rnd(K, RANK, scale=K ** -0.5), rnd(N, RANK, scale=0.02)
    lf.reset_launches()
    y = lf.lowrank_forward(x, w, v, b)
    torch.cuda.synchronize()
    want = ref.lowrank_forward(x, w, v, b)
    err = (y.float() - want.float()).abs()
    assert bool(torch.isfinite(y).all())
    assert bool((err <= BF16_TOL * (want.float().abs().max()
                                    + want.float().abs())).all())
    assert lf.launches("shared", "tc") == 1 and lf.launches() == 1


def _bf16_reduced():
    return ZAMBA.reduced().replace(num_layers=5, dtype="bfloat16",
                                   param_dtype="bfloat16")


@pytest.mark.cuda
def test_bf16_hybrid_decode_step_makes_no_host_sync(cuda):
    cfg = _bf16_reduced()
    store = AdapterStore(cfg, TrainConfig(rank=8, min_dim_for_lowrank=32),
                         max_tenants=3, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    projs = [0.05 * torch.randn(v.shape, generator=g, device=cuda)
             for v in store.projs]
    for t in range(3):
        store.add_tenant(f"t{t}", [
            0.05 * torch.randn(b.shape[:-3] + b.shape[-2:], generator=g,
                               device=cuda) for b in store.b_full], projs)
    params = lm.init_params(cfg, seed=1, device=cuda)
    packed = batched_pack_tree(params, store.layout, store.b_full,
                               store.projs,
                               torch.tensor([2, 0, 2, 1], device=cuda))
    ps = lm.alloc_paged_state(cfg, 4, 8, 4, 8, device=cuda)
    ps = ps._replace(
        page_table=torch.arange(8, dtype=torch.int32,
                                device=cuda).reshape(4, 2),
        lengths=torch.tensor([1, 3, 5, 7], dtype=torch.int32, device=cuda))
    tok = torch.randint(0, cfg.vocab_size, (4, 1), device=cuda)
    lf.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = lm.decode_step_paged(packed, tok, cfg, ps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
    assert lf.launches("batched", "tc") > 0
    assert lf.launches("batched", "simt") == 0


@pytest.mark.cuda
def test_sampled_bf16_decode_step_makes_no_host_sync(cuda):
    cfg = _bf16_reduced()
    params = lm.init_params(cfg, seed=1, device=cuda)
    eng = Engine(params, cfg, device=cuda, engine_cfg=EngineConfig(
        page_size=4, max_batch=2, max_len=24, max_out=8, temperature=0.8,
        top_k=16, sample_seed=2))
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab_size, 4), 6))
    eng.step()              # admissions and one decode step
    state = eng.state._replace(
        page_table=torch.as_tensor(eng._pt, device=cuda),
        lengths=torch.as_tensor(eng._len, device=cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, tok, *_ = eng._decode(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())


def _ssd_train_operands(dev, strong, seed):
    """x, dt, da, b, c (one B/C group), dy, dstate at the training shape,
    dt and A by the mixer's laws (dt = softplus(z + dt_bias), dt_bias the
    inverse softplus of exp(U[log 1e-3, log 0.1]), A = -U[1, 16]);
    ``strong``: dt = softplus(z), so masked differences reach hundreds."""
    BC, Q, H, P, N = SSD_TRAIN_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def uniform(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(size, generator=g, device=dev)
    dt0 = torch.exp(uniform(np.log(1e-3), np.log(0.1), H))
    bias = 0.0 if strong else dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        torch.randn((BC, Q, H), generator=g, device=dev) + bias)
    da = dt * -uniform(1.0, 16.0, H)
    x, dy = (torch.randn((BC, Q, H, P), generator=g, device=dev)
             for _ in range(2))
    b, c = (torch.randn((BC, Q, 1, N), generator=g, device=dev)
            for _ in range(2))
    ds = torch.randn((BC, H, N, P), generator=g, device=dev)
    return x, dt, da, b, c, dy, ds


def _within(got, want, name):
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
    err = (got - want).abs().max().item()
    assert err <= SSD_REL * want.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True])
def test_ssd_kernel_matches_plain_at_the_zamba2_training_shape(cuda,
                                                               strong):
    x, dt, da, b, c, _, _ = _ssd_train_operands(cuda, strong, seed=1)
    H = x.shape[2]
    bh, ch = (t.expand(-1, -1, H, -1) for t in (b, c))
    sc.reset_launches()
    y, st = sc.ssd_intra_chunk(x, dt, da, bh, ch)
    torch.cuda.synchronize()
    want_y, want_st = ref.ssd_intra_chunk(x, dt, da, bh, ch)
    _within(y, want_y, "y")
    _within(st, want_st, "state")
    assert sc.LAUNCHES == {("ssd_intra_chunk", SSD_TRAIN_SHAPE): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True])
def test_ssd_bwd_kernel_matches_plain_at_the_zamba2_training_shape(cuda,
                                                                   strong):
    """The constant-bound heads instance at 7 slices of 16 heads and 2 column
    blocks: every gradient within SSD_REL of the plain version's, three
    launches bit-identical."""
    ops = _ssd_train_operands(cuda, strong, seed=2)
    if strong:
        clog = torch.cumsum(ops[2], dim=1)
        assert (clog[:, :1] - clog[:, -1:]).max().item() > 4 * 88.7
    sc.reset_launches()
    runs = [sc.ssd_intra_chunk_bwd(*ops) for _ in range(3)]
    torch.cuda.synchronize()
    want = ref.ssd_intra_chunk_bwd(*ops)
    for name, got, w in zip(("dx", "ddt", "dda", "db", "dc"), runs[0], want):
        _within(got, w, name)
    for again in runs[1:]:
        for a, w in zip(runs[0], again):
            assert torch.equal(a, w)
    assert sc.LAUNCHES == {("ssd_intra_chunk_bwd", SSD_TRAIN_SHAPE): 3}


@pytest.mark.cuda
def test_ssd_checked_builds_equal_unchecked_at_the_zamba2_training_shape(
        cuda):
    x, dt, da, b, c, dy, ds = _ssd_train_operands(cuda, False, seed=3)
    H = x.shape[2]
    bh, ch = (t.expand(-1, -1, H, -1) for t in (b, c))
    fwd = [sc.ssd_intra_chunk(x, dt, da, bh, ch, checked=chk)
           for chk in (False, True)]
    bwd = [sc.ssd_intra_chunk_bwd(x, dt, da, b, c, dy, ds, checked=chk)
           for chk in (False, True)]
    torch.cuda.synchronize()
    for u, w in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
        assert torch.equal(u, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SSD_TRAIN_SHAPE, (8, 128, 48, 64, 128)])
def test_ssd_bwd_constant_instances_equal_the_ragged_one(cuda, shape):
    """The constant-bound heads instances (Q = 128 with N = 64 at
    zamba2-7b's shape, N = 128 at mamba2-780m's with 8 chunks) give the
    ragged instance's gradients bit for bit: the same products in the
    same order, fewer bounds read at run time."""
    from repro_torch.kernels import _build
    BC, Q, H, P, N = shape
    g = torch.Generator(device=cuda)
    g.manual_seed(sum(shape))
    ops = [torch.randn(s, generator=g, device=cuda) for s in (
        (BC, Q, H, P), (BC, Q, H), (BC, Q, H), (BC, Q, 1, N), (BC, Q, 1, N),
        (BC, Q, H, P), (BC, H, N, P))]
    ops[1] = torch.nn.functional.softplus(ops[1] - 4.0)
    ops[2] = -ops[1] * 4.0
    want = sc.ssd_intra_chunk_bwd(*ops)
    outs = [torch.empty_like(t) for t in ops[:5]]
    sc._bwd_launch(ops, outs, sc.ssd_bwd_plan(BC, H, N, 1), _build.RAGGED)
    torch.cuda.synchronize()
    for a, w in zip(outs, want):
        assert torch.equal(a, w)
