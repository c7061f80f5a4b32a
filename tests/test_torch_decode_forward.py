"""The per-row-B (decode) form of the low-rank forward, read by tenant
index, and its tensor-core route.

On the CPU (no card needed):

* ``lowrank_forward.tc_route`` sends every bf16 (K, N, r) that the
  decode steps of qwen2-7b, mamba2-780m and zamba2-7b give the batched
  form to
  ``"tc"``, and fp32, unaligned rows and a pointer off a 16-byte boundary
  to ``"simt"``.
* The indexed plain form (``b`` the store's ``(T, N, r)`` stack, ``rows``
  the tenant of each batch row) equals the gathered form bit for bit,
  with rows repeated and out of order, T > batch, batch 1, 4 and 16 and
  seq 1 and 3; and matches the JAX reference ``dispatch.
  _xla_batch_forward`` on the gathered numpy inputs within 1e-5·max|y|
  in fp32 (the same fp32 arithmetic, summed in another order).
* ``batched_pack_tree`` copies no ``B``: every pack holds a view of its
  group's ``AdapterStore.b_full`` and the slot-tenant index, and a decode
  step through it equals one through the gathered packs bit for bit.
* A plain emulation of the route's arithmetic — fp32 split-K partials
  of ``x W`` and of ``p = x V`` summed in split order, then the fp32
  ``p·B[rows]ᵀ`` term — matches ``ref.lowrank_batch_forward`` on fp32
  inputs that bf16 holds exactly within 1e-5·max|y| (fp32 sums in
  another order); the scratch plan allocates no ``(s, M, N)`` buffer
  where the y pass does not split, and otherwise one fp32 buffer of
  ``(s + slots, M, N)`` with M ≤ 16 at decode, the splits' partials and
  one rank partial per distinct tenant a tile can hold (``slots``
  covers every tile's tenants).

The ``cuda``-marked tests hold the kernel against its plain version on
the card (bf16, 2e-2·max|y|: bf16 output rounding, fp32 sums in another
order) at the thirteen decode shapes of the three models, at ragged aligned
N, at batch 1, 3, 4, 16 and seq 1, 2 with repeated tenants and T = 8;
check that two launches agree bit for bit, that an index outside
[0, T) surfaces as a CUDA error, and that a bf16 paged decode step of a
reduced qwen2 and mamba2 makes no host sync and launches every batched
forward on ``"tc"``.  They skip here with a reason; run them on a card
with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_decode_forward.py``.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import (tree_flatten_with_path,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.linear import BatchLRPack  # noqa: E402
from repro_torch.serve import AdapterStore, batched_pack_tree  # noqa: E402

RANK = 128
LOWRANK = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
           "out_proj", "unembed")
EMU_REL = 1e-5
# the decode (K, N) of the served models, r = 128: qwen2-7b's five,
# mamba2-780m's three and zamba2-7b's five new ones (its wq, wk, wv, wo
# are qwen2's (3584, 3584); in_proj's 14576 is no multiple of a tile)
DECODE = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
          (3584, 152064), (1536, 6448), (3072, 1536), (1536, 50432),
          (3584, 14576), (7168, 3584), (3584, 14336), (14336, 3584),
          (3584, 32000)]


def _model_shapes(arch):
    out = set()

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in LOWRANK:
                out.add(tuple(val.shape[-2:]))
    walk(lm.param_specs(get_config(arch)))
    return sorted(out)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-780m", "zamba2-7b"])
def test_every_decode_shape_takes_the_tensor_cores(arch):
    shapes = _model_shapes(arch)
    assert set(shapes) <= set(DECODE) and len(shapes) >= 3
    for K, N in shapes:
        r = max(1, min(RANK, min(K, N) // 2))
        assert lf.tc_route(torch.bfloat16, K, N, r,
                           (0, 256, 512, 768)) == "tc"


def test_fp32_unaligned_and_misaligned_batched_take_simt():
    assert lf.tc_route(torch.float32, 3584, 512, RANK) == "simt"
    assert lf.tc_route(torch.bfloat16, 3584, 500, RANK) == "simt"
    assert lf.tc_route(torch.bfloat16, 37, 512, 4) == "simt"
    assert lf.tc_route(torch.bfloat16, 3584, 512, RANK, (0, 8)) == "simt"


# ---------------------------------------------------------------------------
# The indexed plain form
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch)


def _indexed_operands(batch, S, K, N, r, seed):
    """x, w, v, a (T, N, r) stack with T = batch + 3, and rows: repeated
    and out of order where batch allows."""
    rng = np.random.default_rng(seed)
    T = batch + 3
    rows = rng.permutation(T)[:batch]
    if batch > 1:
        rows[-1] = rows[0]
    return (rng.standard_normal((batch, S, K)).astype(np.float32),
            (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
            (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32),
            (0.1 * rng.standard_normal((T, N, r))).astype(np.float32),
            rows.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("S", [1, 3])
def test_indexed_plain_equals_gathered_bit_for_bit(dtype, batch, S):
    x, w, v, bt, rows = (torch.from_numpy(a) for a in _indexed_operands(
        batch, S, 48, 40, 8, seed=batch * 10 + S))
    x, w, v, bt = (t.to(dtype) for t in (x, w, v, bt))
    want = ref.lowrank_batch_forward(x, w, v, bt[rows])
    got = ref.lowrank_batch_forward(x, w, v, bt, rows)
    assert got.dtype == dtype and got.shape == (batch, S, 40)
    assert torch.equal(got, want)
    # the public op and a packed linear route a CPU tensor the same way
    assert torch.equal(dispatch.lowrank_batch_forward(x, w, v, bt, rows),
                       want)
    from repro_torch.models.linear import linear
    pack = BatchLRPack(w[None], bt[None], v[None], rows=rows)
    assert torch.equal(linear(x, pack[0]), want)


@pytest.mark.parametrize("batch,S", [(1, 1), (4, 1), (16, 3)])
def test_indexed_plain_matches_jax_xla_batch_forward(jref, batch, S):
    x, w, v, bt, rows = _indexed_operands(batch, S, 64, 72, 8, seed=S + 7)
    jnp = jref.jnp
    want = np.asarray(jref.dispatch._xla_batch_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(v),
        jnp.asarray(bt[rows])))
    got = ref.lowrank_batch_forward(
        *(torch.from_numpy(a) for a in (x, w, v, bt, rows))).numpy()
    assert np.abs(got - want).max() <= EMU_REL * np.abs(want).max()


def test_batch_forward_refuses_bad_rows():
    x, w, v, bt, rows = (torch.from_numpy(a) for a in _indexed_operands(
        4, 1, 16, 16, 2, seed=0))
    with pytest.raises(ValueError, match="tenant index per batch row"):
        lf.lowrank_batch_forward(x, w, v, bt, rows[:3])
    with pytest.raises(ValueError, match="tenant index per batch row"):
        lf.lowrank_batch_forward(x, w, v, bt, rows.float())
    with pytest.raises(ValueError, match="batch of x"):
        lf.lowrank_batch_forward(x, w, v, bt)


# ---------------------------------------------------------------------------
# The adapter store is read in place
# ---------------------------------------------------------------------------

def _store(cfg, tcfg, n_tenants, seed=0):
    store = AdapterStore(cfg, tcfg, max_tenants=n_tenants, device="cpu")
    rng = np.random.default_rng(seed)
    projs = [0.05 * rng.standard_normal(v.shape).astype(np.float32)
             for v in store.projs]
    for t in range(n_tenants):
        store.add_tenant(f"t{t}", [
            0.05 * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
            .astype(np.float32) for b in store.b_full], projs)
    return store


def _gathered_pack_tree(params, store, tenants):
    """The per-step gather the decode path no longer makes."""
    flat = tree_flatten_with_path(params)
    out = [leaf for _, leaf in flat]
    for g, spec in enumerate(store.layout.groups):
        full = store.b_full[g]
        bsel = full.index_select(full.ndim - 3, tenants)
        for j, i in enumerate(spec.leaf_idx):
            out[i] = BatchLRPack(out[i], bsel[j], store.projs[g][j])
    return tree_unflatten([p for p, _ in flat], out)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-780m"])
def test_batched_pack_tree_reads_the_store_in_place(arch):
    cfg = get_config(arch).reduced()
    store = _store(cfg, TrainConfig(rank=8, min_dim_for_lowrank=32), 3)
    params = lm.init_params(cfg, seed=0, device="cpu")
    tenants = torch.tensor([2, 0, 2], dtype=torch.long)
    packed = batched_pack_tree(params, store.layout, store.b_full,
                               store.projs, tenants)
    packs = [leaf for _, leaf in tree_flatten_with_path(packed)
             if isinstance(leaf, BatchLRPack)]
    assert len(packs) == sum(len(s.leaf_idx) for s in store.layout.groups)
    stores = {b.untyped_storage().data_ptr() for b in store.b_full}
    for pack in packs:
        assert pack.rows is tenants
        assert pack.b.untyped_storage().data_ptr() in stores
        assert pack.b.shape[-3] == store.max_tenants
        layer = pack[0] if pack.b.ndim == 4 else pack
        assert layer.rows is tenants and layer.b.shape[0] == 3
    # a decode step through the in-place packs equals one through the
    # gathered packs, bit for bit
    state = lm.alloc_paged_state(cfg, 3, 6, 4, 8, device="cpu")
    state = state._replace(
        page_table=torch.arange(6, dtype=torch.int32).reshape(3, 2),
        lengths=torch.tensor([3, 1, 5], dtype=torch.int32))
    tok = torch.tensor([[5], [7], [11]])
    got, _ = lm.decode_step_paged(packed, tok, cfg, state)
    want, _ = lm.decode_step_paged(
        _gathered_pack_tree(params, store, tenants), tok, cfg, state)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The route's arithmetic and scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,seq,want", [(4, 1, 4), (16, 1, 16),
                                            (8, 2, 4), (6, 3, 2),
                                            (16, 3, 6), (32, 4, 5)])
def test_rank_slots_cover_every_tenant_a_tile_can_hold(M, seq, want):
    # the most batch rows any tile of bn rows meets, counted directly
    bn = lf.dec_tile_rows(M)
    most = max(len({m // seq for m in range(m0, min(M, m0 + bn))})
               for m0 in range(0, M, bn))
    _, _, s_y, slots = lf.dec_plan(M, 3584, 512, RANK, seq)
    assert s_y > 1 and slots >= most
    assert most <= want == slots


def _bf16_exact(rng, *shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float()


def _split_sum(a, bmat, s):
    """sum over the kernel's K ranges of a[:, Ks] bmat[Ks], in order."""
    K = a.shape[1]
    chunk = -(-(-(-K // s)) // lf.DEC_BK) * lf.DEC_BK
    out = torch.zeros(a.shape[0], bmat.shape[1])
    for z in range(s):
        out = out + a[:, z * chunk:(z + 1) * chunk] @ \
            bmat[z * chunk:(z + 1) * chunk]
    return out


@pytest.mark.parametrize("batch,S,K,N,r", [
    (4, 1, 3584, 512, 128), (4, 1, 1536, 6448, 128), (3, 2, 640, 1712, 64),
    (20, 1, 256, 64, 16), (1, 1, 576, 200, 8)])
def test_route_emulation_matches_plain(batch, S, K, N, r):
    rng = np.random.default_rng(K + N)
    M, T = batch * S, batch + 2
    x = _bf16_exact(rng, M, K)
    w = _bf16_exact(rng, K, N, scale=K ** -0.5)
    v = _bf16_exact(rng, K, r, scale=K ** -0.5)
    bt = _bf16_exact(rng, T, N, r, scale=0.1)
    rows = torch.from_numpy(rng.integers(0, T, batch))
    _, s_p, s_y, _ = lf.dec_plan(M, K, N, r, S)
    p = _split_sum(x, v, s_p)
    tenant = rows.repeat_interleave(S)
    rank = torch.einsum("mc,mnc->mn", p, bt[tenant])
    y = _split_sum(x, w, s_y) + rank
    want = ref.lowrank_batch_forward(x.reshape(batch, S, K), w, v, bt,
                                     rows).reshape(M, N)
    assert (y - want).abs().max() <= EMU_REL * want.abs().max()


@pytest.mark.parametrize("K,N", DECODE)
@pytest.mark.parametrize("M", [1, 4, 16])
def test_decode_scratch_plan(K, N, M):
    bn, s_p, s_y, slots = lf.dec_plan(M, K, N, RANK)
    assert bn == (8 if M <= 8 else 16)
    for s in (s_p, s_y):
        chunk = -(-(-(-K // s)) // lf.DEC_BK) * lf.DEC_BK
        assert s >= 1 and (s - 1) * chunk < K <= s * chunk
    plan = lf.scratch_plan("batched", "tc", M, K, N, RANK)
    assert all(dt == torch.float32 for _, dt in plan.values())
    assert plan["p"][0] == (M, RANK)
    assert ("y_part" in plan) == (s_y > 1)
    if s_y > 1:
        # a rank slot per row at seq 1: each row may be its own tenant
        assert slots == min(M, bn)
        assert plan["y_part"][0] == (s_y + slots, M, N)
    else:
        assert slots == 0
    # the unembeddings' column tiles fill the card alone: no partials
    if N >= 50432:
        assert s_y == 1 and "y_part" not in plan
    # enough blocks for the card where the depth allows
    tiles = -(-N // lf.DEC_TILE) * -(-M // bn)
    assert tiles * s_y >= min(lf.SMS, tiles * -(-K // (
        lf.DEC_BK * lf.DEC_MIN_STAGES)))


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


BF16_TOL = 2e-2


def _card_operands(dev, batch, S, K, N, r, T, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(
            torch.bfloat16)
    return (rnd(batch, S, K), rnd(K, N, scale=K ** -0.5),
            rnd(K, r, scale=K ** -0.5), rnd(T, N, r, scale=0.1))


def _check_on_card(dev, batch, S, K, N, r, rows):
    rows = torch.tensor(rows, dtype=torch.long, device=dev)
    T = max(int(rows.max().item()) + 1, batch)
    x, w, v, bt = _card_operands(dev, batch, S, K, N, r, T, seed=K + N + S)
    lf.reset_launches()
    y = lf.lowrank_batch_forward(x, w, v, bt, rows)
    torch.cuda.synchronize()
    want = ref.lowrank_batch_forward(x, w, v, bt, rows)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * want.float().abs().max().item()
    assert bool(torch.isfinite(y).all())
    assert lf.launches("batched", "tc") == 1 and lf.launches() == 1
    return x, w, v, bt, rows, y


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", DECODE)
def test_dec_kernel_matches_plain_at_decode_shapes(cuda, K, N):
    _check_on_card(cuda, 4, 1, K, N, RANK, [0, 2, 2, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,r", [(1536, 6448, 128), (640, 1712, 128),
                                   (1536, 50432, 128), (640, 1712, 8),
                                   (64, 200, 16), (3584, 520, 256)])
def test_dec_kernel_matches_plain_at_ragged_shapes(cuda, K, N, r):
    _check_on_card(cuda, 4, 1, K, N, r, [3, 1, 3, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 4, 16])
@pytest.mark.parametrize("S", [1, 2])
def test_dec_kernel_matches_plain_at_batch_and_seq(cuda, batch, S):
    rng = np.random.default_rng(batch * 3 + S)
    rows = rng.integers(0, 8, batch)
    if batch > 1:
        rows[-1] = rows[0]            # a repeated tenant
    rows[0] = 7                       # T = 8 > batch
    _check_on_card(cuda, batch, S, 640, 1712, RANK, rows.tolist())


@pytest.mark.cuda
def test_dec_kernel_without_rows_matches_plain(cuda):
    x, w, v, bt = _card_operands(cuda, 4, 1, 3584, 512, RANK, 4, seed=9)
    lf.reset_launches()
    y = lf.lowrank_batch_forward(x, w, v, bt)
    want = ref.lowrank_batch_forward(x, w, v, bt)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * want.float().abs().max().item()
    assert lf.launches("batched", "tc") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(3584, 512), (3584, 152064)])
def test_dec_kernel_is_deterministic(cuda, K, N):
    x, w, v, bt, rows, y = _check_on_card(cuda, 4, 1, K, N, RANK,
                                          [0, 2, 2, 1])
    for _ in range(2):
        assert torch.equal(lf.lowrank_batch_forward(x, w, v, bt, rows), y)


@pytest.mark.cuda
def test_out_of_range_tenant_surfaces_as_a_cuda_error(cuda):
    # a trap ends the process's CUDA context: run it in a child
    code = (
        "import torch\n"
        "from repro_torch.kernels import lowrank_forward as lf\n"
        "d = torch.device('cuda')\n"
        "x = torch.randn(4, 1, 640, device=d).bfloat16()\n"
        "w = torch.randn(640, 1712, device=d).bfloat16()\n"
        "v = torch.randn(640, 128, device=d).bfloat16()\n"
        "b = torch.randn(4, 1712, 128, device=d).bfloat16()\n"
        "rows = torch.tensor([0, 1, 4, 2], device=d)\n"
        "lf.lowrank_batch_forward(x, w, v, b, rows)\n"
        "torch.cuda.synchronize()\n"
        "print('NO ERROR')\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode != 0 and "NO ERROR" not in res.stdout
    assert "CUDA" in res.stderr or "cuda" in res.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-780m"])
def test_bf16_decode_step_makes_no_host_sync(cuda, arch):
    cfg = get_config(arch).reduced().replace(dtype="bfloat16",
                                             param_dtype="bfloat16")
    tcfg = TrainConfig(rank=8, min_dim_for_lowrank=32)
    store = AdapterStore(cfg, tcfg, max_tenants=3, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    projs = [0.05 * torch.randn(v.shape, generator=g, device=cuda)
             for v in store.projs]
    for t in range(3):
        store.add_tenant(f"t{t}", [
            0.05 * torch.randn(b.shape[:-3] + b.shape[-2:], generator=g,
                               device=cuda) for b in store.b_full], projs)
    params = lm.init_params(cfg, seed=0, device=cuda)
    tenants = torch.tensor([2, 0, 2], dtype=torch.long, device=cuda)
    packed = batched_pack_tree(params, store.layout, store.b_full,
                               store.projs, tenants)
    state = lm.alloc_paged_state(cfg, 3, 6, 4, 8, device=cuda)
    state = state._replace(
        page_table=torch.arange(6, dtype=torch.int32,
                                device=cuda).reshape(3, 2),
        lengths=torch.tensor([3, 1, 5], dtype=torch.int32, device=cuda))
    tok = torch.tensor([[5], [7], [11]], device=cuda)
    lf.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = lm.decode_step_paged(packed, tok, cfg, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(lg[..., :cfg.vocab_size].float()).all())
    assert lf.launches("batched", "tc") > 0
    assert lf.launches(route="simt") == 0
