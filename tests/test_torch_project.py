"""GaLore's projection ``G_B = Gᵀ V`` in the port against the JAX package.

The plain PyTorch version (``ref.lowrank_project``, the CPU route of the
wrapper and of ``dispatch.lowrank_project``) is held to the reference's
Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it,
on the shapes that kernel takes: K and N at most 256 or multiples of
it) and to the reference's ``dispatch.lowrank_project`` (its XLA route)
over aligned, ragged and batched ``(G, L, K, N)`` shapes, with fp32 and
bf16 operands mixed as GaLore mixes them (an fp32 gradient, a bf16
basis).  Both sides cast the operands up exactly and sum in fp32, in
another order: every comparison holds the max abs error within 1e-5 of
the output's largest magnitude (measured on the CPU: at most 6.8e-7
of it).

The ``cuda``-marked tests hold the CUDA kernel to its plain version on
the card (ragged shapes, K split into ranges, the four llama-100m group
shapes, every dtype pair) and check its refusals; they skip here with a
reason and import no JAX.  Run them on a card with ``PYTHONPATH=src
python -m pytest -m cuda tests/test_torch_project.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import lowrank_update as lu  # noqa: E402

REL = 1e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (g dtype, v dtype): GaLore's own pair first
PAIRS = [("f32", "bf16"), ("f32", "f32"), ("bf16", "bf16"),
         ("bf16", "f32")]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import dispatch as jdispatch
    from repro.kernels.lowrank_update import lowrank_project
    return SimpleNamespace(jnp=jnp, dispatch=jdispatch,
                           pallas_project=lowrank_project)


def _operands(lead, K, N, r, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (K, N)).astype(np.float32),
            (rng.standard_normal(lead + (K, r)) / np.sqrt(K))
            .astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DTYPES[dtype])


def _jax(jref, a, dtype):
    return jref.jnp.asarray(a).astype(
        {"f32": jref.jnp.float32, "bf16": jref.jnp.bfloat16}[dtype])


def _close(got, want, rel=REL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("K,N,r", [(256, 256, 8), (512, 256, 32),
                                   (200, 72, 5)])
@pytest.mark.parametrize("dtypes", [("f32", "f32"), ("f32", "bf16")])
def test_plain_matches_the_pallas_kernel_interpret(jref, K, N, r, dtypes):
    g, v = _operands((), K, N, r, seed=K + r)
    want = jref.pallas_project(_jax(jref, g, dtypes[0]),
                               _jax(jref, v, dtypes[1]), interpret=True)
    got = ref.lowrank_project(_torch(g, dtypes[0]), _torch(v, dtypes[1]))
    assert got.dtype == torch.float32
    _close(got, np.asarray(want))


@pytest.mark.parametrize("lead,K,N,r", [
    ((), 64, 64, 8),                 # aligned to the kernel's 64 tile
    ((), 37, 19, 3),                 # ragged on every axis
    ((3,), 1712, 64, 16),            # llama-100m's d_ff as K
    ((4, 2), 128, 96, 8),            # a group's (G, L) lead
    ((2, 3), 70, 130, 64)])
@pytest.mark.parametrize("dtypes", PAIRS)
def test_plain_and_dispatch_match_jax_dispatch(jref, lead, K, N, r, dtypes):
    g, v = _operands(lead, K, N, r, seed=len(lead) + K)
    want = np.asarray(jref.dispatch.lowrank_project(
        _jax(jref, g, dtypes[0]), _jax(jref, v, dtypes[1])))
    tg, tv = _torch(g, dtypes[0]), _torch(v, dtypes[1])
    for got in (ref.lowrank_project(tg, tv),
                dispatch.lowrank_project(tg, tv),
                lu.lowrank_project(tg, tv)):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == lead + (N, r)
        _close(got, want)


def test_cpu_calls_count_no_launch():
    lu.reset_launches()
    g, v = _operands((2,), 16, 8, 2)
    dispatch.lowrank_project(_torch(g, "f32"), _torch(v, "bf16"))
    assert lu.launches("lowrank_project") == 0 and lu.launches() == 0


def test_devices_without_a_route_raise():
    g, v = (t.to("meta") for t in (_torch(a, "f32")
                                   for a in _operands((), 8, 8, 2)))
    with pytest.raises(ValueError, match="lowrank_project: no route"):
        lu.lowrank_project(g, v)
    with pytest.raises(ValueError, match=r"\(\.\., K, N\)"):
        lu.lowrank_project(g[0], v)


@pytest.mark.parametrize("items,K,N,r", [
    (48, 640, 640, 128), (24, 640, 1712, 128), (12, 1712, 640, 128),
    (1, 640, 32256, 128), (1, 4096, 64, 16), (1, 5, 3, 1),
    (70000 // 64, 9000, 8, 2)])
def test_project_splits_cover_k_within_the_grid(items, K, N, r):
    s = lu.project_splits(items, K, N, r)
    chunk = -(-(-(-K // s)) // 16) * 16          # the kernel's rounding
    assert s >= 1 and (s - 1) * chunk < K <= s * chunk
    assert items * s <= lu.MAX_GRID_Z


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


# ragged shapes, one with K split into ranges, and the llama-100m groups
CARD_SHAPES = [((), 37, 19, 3), ((3,), 1712, 64, 16), ((), 4096, 64, 16),
               ((2, 3), 70, 130, 64), ((4, 12), 640, 640, 128),
               ((2, 12), 640, 1712, 128), ((1, 12), 1712, 640, 128),
               ((1,), 640, 32256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", PAIRS)
@pytest.mark.parametrize("lead,K,N,r", CARD_SHAPES)
def test_project_kernel_matches_plain_on_card(cuda, dtypes, lead, K, N, r):
    lu.reset_launches()
    g, v = (_torch(a, d).to(cuda)
            for a, d in zip(_operands(lead, K, N, r, seed=K), dtypes))
    got = lu.lowrank_project(g, v)
    torch.cuda.synchronize()
    want = ref.lowrank_project(g, v)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # fp32 sums of the same (exactly cast) products in another order
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()
    # the tensor cores take a bf16 V with row lengths that are multiples
    # of 8 (an fp32 G as a bf16 hi, lo pair); SIMT takes the rest
    route = "tc" if v.dtype == torch.bfloat16 and not any(
        d % 8 for d in (K, N, r)) else "simt"
    assert lu.LAUNCHES == {("lowrank_project", route, tuple(g.shape)): 1}


@pytest.mark.cuda
def test_project_kernel_refuses_what_it_does_not_take(cuda):
    g, v = (_torch(a, "f32").to(cuda) for a in _operands((2,), 32, 24, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lu.lowrank_project(g.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        lu.lowrank_project(g.mT.contiguous().mT, v)
    with pytest.raises(ValueError, match="contiguous"):
        lu.lowrank_project(g, v.mT.contiguous().mT)
    with pytest.raises(ValueError, match="shapes"):
        lu.lowrank_project(g, v[:, :16].contiguous())
    with pytest.raises(ValueError, match="on"):
        lu.lowrank_project(g, v.cpu())
