"""qwen3-moe-30b-a3b's training shapes on the port's kernels.  This file
imports no JAX, so its ``cuda``-marked tests run on a card host
(``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_moe_train_kernels.py``); they skip here with a reason.

On the CPU:

* the expert groups at 20 layers: the w_gate·w_up group's W holds 8.05 G
  elements, past 2^31, and its merge takes the tensor-core route in one
  launch whose tile count fits the kernel's int32 tile index (the
  w_down group's alike);
* every (K, N) of qwen3-moe's attention and unembedding takes the
  tensor-core route, bf16, r = 128, in the forms training launches.

On the card:

* the merge of 1366 items of 2048 x 768 (2.15 G elements) in one launch,
  the items that span and follow element 2^31 held against the plain
  version (bf16, 2e-2·(max|W'| + |W'|));
* ``subspace_adam`` at the experts' B shapes, in each (b, g) dtype
  instance, equal to its plain version;
* one bf16 training step of a reduced MoE (32 experts, top-8): two
  backward passes from one state give every group's B gradient and the
  router's bit for bit (the dispatch's backward is a gather, not an
  ``index_add_`` of atomics; the embedding's, an ``index_put_`` with
  accumulation, is not asked for).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import lowrank_forward as lf  # noqa: E402
from repro_torch.kernels import lowrank_update as lu  # noqa: E402
from repro_torch.kernels import subspace_adam as sa  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import subspace  # noqa: E402
from repro_torch.train import steps  # noqa: E402

RANK = 128
QWEN3 = get_config("qwen3-moe-30b-a3b")
LAYERS = 20                     # [train qwen3moe]'s depth
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.05)


def _groups(layers=LAYERS):
    cfg = QWEN3.replace(num_layers=layers)
    layout = subspace.build_layout(lm.param_specs(cfg),
                                   TrainConfig(rank=RANK))
    return {(len(s.leaf_idx),) + s.shape: s.rank for s in layout.groups}


def test_the_expert_groups_pass_2_to_the_31_in_one_tc_launch():
    groups = _groups()
    gate_up = (2, LAYERS, 128, 2048, 768)
    down = (1, LAYERS, 128, 768, 2048)
    assert groups[gate_up] == groups[down] == RANK
    n = 1
    for d in gate_up:
        n *= d
    assert n == 8_053_063_680 > 2 ** 31
    for shape in (gate_up, down):
        K, N = shape[-2:]
        assert lu.merge_route(torch.bfloat16, torch.bfloat16, torch.float32,
                              K, N, RANK) == "tc"
        items = n // (2048 * 768) if shape == gate_up else 128 * LAYERS
        tiles = items * -(-N // 64) * -(-K // 128)
        assert tiles < 2 ** 31 - 1


@pytest.mark.parametrize("K,N", [(2048, 4096), (2048, 512), (4096, 2048),
                                 (2048, 152064)])
def test_qwen3_training_gemms_take_the_tensor_cores(K, N):
    assert lf.tc_route(torch.bfloat16, K, N, RANK) == "tc"


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


def _randn(gen, dev, shape, scale, dtype):
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for a in range(0, flat.numel(), 1 << 27):
        z = min(flat.numel(), a + (1 << 27))
        flat[a:z] = (scale * torch.randn(z - a, generator=gen,
                                         device=dev)).to(dtype)
    return out


@pytest.mark.cuda
def test_merge_past_element_2_to_the_31_matches_plain(cuda):
    items, K, N = 1366, 2048, 768
    assert items * K * N > 2 ** 31 > (items - 1) * K * N
    g = torch.Generator(device=cuda)
    g.manual_seed(31)
    w = _randn(g, cuda, (items, K, N), K ** -0.5, torch.bfloat16)
    v = _randn(g, cuda, (items, K, RANK), RANK ** -0.5, torch.bfloat16)
    b = _randn(g, cuda, (items, N, RANK), 0.02, torch.float32)
    lu.reset_launches()
    got = lu.lowrank_merge(w, v, b)
    torch.cuda.synchronize()
    assert dict(lu.LAUNCHES) == {("lowrank_merge", "tc", (items, K, N)): 1}
    first = 2 ** 31 // (K * N) - 2           # items 1363..1365
    for a in (0, first):
        want = ref.lowrank_merge(w[a:a + 3], v[a:a + 3], b[a:a + 3]).float()
        err = (got[a:a + 3].float() - want).abs()
        assert (err <= 2e-2 * (want.abs().max() + want.abs())).all()
    assert torch.isfinite(got[-1]).all() and not torch.equal(got[-1], w[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)],
                         ids=["fp32 b, g", "bf16 g", "bf16 b", "bf16 b, g"])
@pytest.mark.parametrize("shape", [(2, LAYERS, 128, 768, RANK),
                                   (1, LAYERS, 128, 2048, RANK)],
                         ids=["w_gate,w_up", "w_down"])
def test_subspace_adam_at_the_expert_b_shapes(cuda, shape, dtypes):
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    b, grad = (_randn(g, cuda, shape, s, d)
               for s, d in zip((0.02, 1e-3), dtypes))
    m = _randn(g, cuda, shape, 1e-4, torch.float32)
    v = _randn(g, cuda, shape, 1e-4, torch.float32) ** 2
    step = torch.tensor(5, dtype=torch.int32, device=cuda)
    scalars = dispatch.adam_scalars(1e-3, step, ADAM["beta1"], ADAM["beta2"],
                                    cuda)
    sa.reset_launches()
    got = sa.subspace_adam(b, grad, m, v, scalars, **ADAM)
    torch.cuda.synchronize()
    assert sa.launches() == 1
    lr, bc1, bc2 = scalars
    want = ref.subspace_adam(b, grad, m, v, lr=lr, bc1=bc1, bc2=bc2, **ADAM)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_a_bf16_moe_step_b_gradients_repeat_bit_for_bit(cuda):
    cfg = QWEN3.reduced().replace(num_experts=32, top_k=8, moe_d_ff=64,
                                  dtype="bfloat16", param_dtype="bfloat16")
    tcfg = TrainConfig(rank=16, min_dim_for_lowrank=32,
                       compute_dtype="bfloat16")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    gp, st = subspace.init_grouped(lm.init_params(cfg, seed=0, device=cuda),
                                   tcfg, gen)
    st = dataclasses.replace(st, groups=tuple(
        s._replace(b=0.02 * torch.randn(s.b.shape, generator=gen,
                                        device=cuda)) for s in st.groups))
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                           device=cuda)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    loss_fn = steps.build_loss_fn(cfg)

    # the routers' (L, d, E) leaf, and every group's B
    paths = [subspace._path_str(p) for p, _ in
             subspace.tree_flatten_with_path(lm.param_specs(cfg))]
    router = [d for d, i in enumerate(st.layout.dense_idx)
              if paths[i].endswith("/router")]
    assert len(router) == 1

    def grads():
        tr = subspace.trainable_of(gp, st)
        leaves = [tr.dense[router[0]]] + list(tr.groups)
        loss = loss_fn(subspace.packed_params(gp, st, tr,
                                              dtype=torch.bfloat16), batch)
        return torch.autograd.grad(loss, leaves)
    first, second = grads(), grads()
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in first)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
