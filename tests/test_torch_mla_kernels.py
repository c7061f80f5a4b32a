"""deepseek-v2-236b's kernel shapes and the MLA family's card path.  This
file imports no JAX, so its ``cuda``-marked tests run on a card host
(``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_mla_kernels.py``); they skip here with a reason.

On the CPU:

* every low-rank (K, N) of deepseek-v2-236b at full size, r = 128, bf16,
  takes the tensor-core route in both forms (every row length a
  multiple of 8), and w_dkv's 576 columns leave a ragged last 128-wide
  tile;
* the row-1 launches of the MLA path, counted at the dispatch on the
  reduced model at 4 layers (the leading dense layer and 3 MoE layers):
  a prefill makes 4 × (6 MLA + 3 MLP) + 1 = 37 shared-B forwards, a
  decode step 4 × (4 + 3) + 1 = 29 per-row-B ones (w_uk and w_uv are
  absorbed in decode, torch products outside the kernel); the expert
  products are library calls.

On the card:

* both forms of the forward against their plain version at every
  deepseek (K, N): shared B at a 128-token prefill (the unembedding on
  the last position), per-row B at batch 4 read by tenant index from a
  store of 4 tenants, rows [3, 1, 3, 2] (bf16, 2e-2 · (max|y| + |y|):
  bf16 output rounding, fp32 sums in another order), one launch each on
  ``"tc"``;
* a bf16 paged decode step of the reduced model at 4 layers over 3
  tenants: no host sync under ``set_sync_debug_mode("error")``, every
  forward launch ``"tc"``, and no ``index_select`` of a B stack under
  the profiler.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_flatten_with_path  # noqa: E402
from repro_torch.serve import AdapterStore, batched_pack_tree  # noqa: E402

RANK = 128
BF16_TOL = 2e-2
DEEPSEEK = get_config("deepseek-v2-236b")
# deepseek-v2-236b's (K, N) -> (leaves, rows at a 128-token prefill): the
# unembedding (102400 columns) runs on the last position; in decode w_uk
# and w_uv are absorbed, the rest run per-row B
SHAPES = {(5120, 1536): ("w_dq", 128),
          (1536, 24576): ("w_uq", 128),
          (5120, 576): ("w_dkv", 128),
          (512, 16384): ("w_uk,w_uv", 128),
          (16384, 5120): ("wo", 128),
          (5120, 3072): ("shared w_gate,w_up", 128),
          (3072, 5120): ("shared w_down", 128),
          (5120, 12288): ("dense w_gate,w_up", 128),
          (12288, 5120): ("dense w_down", 128),
          (5120, 102400): ("unembed", 1)}
# the per-row-B rows: a store of 4 tenants read at rows with a repeat
DEC_TENANTS, DEC_ROWS = 4, (3, 1, 3, 2)


def test_the_shapes_are_the_models():
    shapes = set()
    for path, spec in tree_flatten_with_path(lm.param_specs(DEEPSEEK)):
        # the stacked (L, k, n) matmul leaves and the unembedding; the
        # experts' (L, E, k, n) products are library calls
        if (len(spec.shape) == 3 or path == ("unembed",)) \
                and path[-1] != "router":
            shapes.add(tuple(spec.shape[-2:]))
    assert shapes == set(SHAPES)
    assert lm.padded_vocab(DEEPSEEK) == 102400


@pytest.mark.parametrize("K,N", list(SHAPES))
def test_every_deepseek_shape_takes_the_tensor_cores(K, N):
    for form in ("shared", "batched"):
        assert lf.tc_route(torch.bfloat16, K, N, RANK, (0, 128),
                           form=form) == "tc"
    if N == 576:
        assert N % 128 and not N % 8        # a ragged last 128-wide tile


def _reduced(layers=4, dtype="float32"):
    return DEEPSEEK.reduced().replace(num_layers=layers, dtype=dtype,
                                      param_dtype=dtype)


def _store(cfg, dev, n_tenants=3):
    store = AdapterStore(cfg, TrainConfig(rank=8, min_dim_for_lowrank=32),
                         max_tenants=n_tenants, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    projs = [0.05 * torch.randn(v.shape, generator=g, device=dev)
             for v in store.projs]
    for t in range(n_tenants):
        store.add_tenant(f"t{t}", [
            0.05 * torch.randn(b.shape[:-3] + b.shape[-2:], generator=g,
                               device=dev) for b in store.b_full], projs)
    return store


def _decode_args(cfg, dev, store):
    params = lm.init_params(cfg, seed=1, device=dev)
    packed = batched_pack_tree(params, store.layout, store.b_full,
                               store.projs,
                               torch.tensor([2, 0, 2, 1], device=dev))
    ps = lm.alloc_paged_state(cfg, 4, 8, 4, 8, device=dev)
    ps = ps._replace(
        page_table=torch.arange(8, dtype=torch.int32,
                                device=dev).reshape(4, 2),
        lengths=torch.tensor([1, 3, 5, 7], dtype=torch.int32, device=dev))
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=g, device=dev)
    return params, (packed, tok, cfg, ps)


def test_the_mla_path_makes_the_counted_row_1_launches(monkeypatch):
    """The arithmetic of chip_smoke.py's launch check, on the CPU: the
    forward's two forms counted where the model calls them."""
    calls = {"shared": 0, "batched": 0}

    def counted(form, real):
        def fn(*a, **kw):
            calls[form] += 1
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(dispatch, "lowrank_forward",
                        counted("shared", dispatch.lowrank_forward))
    monkeypatch.setattr(dispatch, "lowrank_batch_forward",
                        counted("batched", dispatch.lowrank_batch_forward))
    cfg = _reduced()
    cpu = torch.device("cpu")
    store = _store(cfg, cpu)
    params, args = _decode_args(cfg, cpu, store)
    st = lm.alloc_decode_state(cfg, 1, 16, device=cpu)
    with torch.no_grad():
        lm.prefill(store.lrpack_tree(params, "t1"),
                   torch.zeros((1, 16), dtype=torch.long), cfg, st)
        assert calls == {"shared": 4 * (6 + 3) + 1, "batched": 0}
        lm.decode_step_paged(*args)
    assert calls == {"shared": 37, "batched": 4 * (4 + 3) + 1}


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
@pytest.mark.parametrize("K,N", list(SHAPES))
@pytest.mark.parametrize("form", ["shared", "batched"])
def test_forward_matches_plain_at_deepseek_shapes(cuda, K, N, form):
    g = torch.Generator(device=cuda)
    g.manual_seed(K + N)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=cuda)).to(
            torch.bfloat16)
    w, v = rnd(K, N, scale=K ** -0.5), rnd(K, RANK, scale=K ** -0.5)
    lf.reset_launches()
    if form == "shared":
        x, b = rnd(SHAPES[(K, N)][1], K), rnd(N, RANK, scale=0.02)
        y, want = lf.lowrank_forward(x, w, v, b), ref.lowrank_forward(
            x, w, v, b)
    else:
        x = rnd(len(DEC_ROWS), 1, K)
        b = rnd(DEC_TENANTS, N, RANK, scale=0.02)
        rows = torch.tensor(DEC_ROWS, device=cuda)
        y = lf.lowrank_batch_forward(x, w, v, b, rows)
        want = ref.lowrank_batch_forward(x, w, v, b, rows)
    torch.cuda.synchronize()
    err = (y.float() - want.float()).abs()
    assert bool(torch.isfinite(y).all())
    assert bool((err <= BF16_TOL * (want.float().abs().max()
                                    + want.float().abs())).all())
    assert lf.launches(form, "tc") == 1 and lf.launches() == 1


@pytest.mark.cuda
def test_bf16_mla_decode_step_makes_no_host_sync_and_gathers_no_b(cuda):
    from torch.profiler import ProfilerActivity, profile
    cfg = _reduced(dtype="bfloat16")
    _, args = _decode_args(cfg, cuda, _store(cfg, cuda))
    lf.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = lm.decode_step_paged(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
    assert lf.launches("batched", "tc") == 4 * (4 + 3) + 1
    assert lf.launches(route="simt") == 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        lm.decode_step_paged(*args)
        torch.cuda.synchronize()
    gathers = [e.input_shapes for e in prof.events()
               if e.name == "aten::index_select" and e.input_shapes
               and len(e.input_shapes[0]) >= 3]
    assert not gathers
