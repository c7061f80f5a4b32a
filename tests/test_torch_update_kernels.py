"""The fp32-state update kernels' launch (``csrc/subspace_adam.cu``:
``subspace_adam``, ``subspace_lion``), without JAX.

On the CPU:

* the kernel's index map, emulated in numpy
  (``_torch_parity.UpdateIndexMap``, with the tile constants read from
  the CUDA source), launched on the wrappers' grid
  (``subspace_adam.update_grid``: one block a whole tile of 256 lanes x
  4 vector steps x 4 elements, and one block more for a ragged last
  tile), updates every index of [0, n) exactly once, at n from 1 to
  past 2^31 (qwen3-moe's two expert B groups among them), and planted
  off-by-ones in the grid or the map fail that walk;
* the alignment check that the launch runs first refuses an operand
  whose start is not on a 16-byte word, each of the seven, and takes the
  aligned ones.

On the card (``cuda``; run with ``PYTHONPATH=src python -m pytest -m
cuda tests/test_torch_update_kernels.py``): Lion in all four (b, g)
dtype instances equal to its plain version, its launches counted as the
grids the kernel queued (two where the tile does not divide n); a
misaligned view and a grid that is not the kernel's refused; outputs
that alias the inputs give the plain version's values.  Adam's
exactness at the path's shapes is in ``tests/test_torch_train_kernels.py``
and ``tests/test_torch_moe_train_kernels.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import (UpdateIndexMap,  # noqa: E402
                           assert_update_covers_once)
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import subspace_adam as sa  # noqa: E402

ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.05)
LION = dict(beta1=0.9, beta2=0.99, wd=0.05)
ADAM_CONSTS = (0.9, 0.1, 0.999, 1 - 0.999, 1e-8, 0.05)
# qwen3-moe-30b-a3b's expert B groups at 20 layers: w_gate·w_up, w_down
QWEN3_B = (2 * 20 * 128 * 768 * 128, 20 * 128 * 2048 * 128)
SIZES = [1, 7, 8, 105, 8 * 1000 + 3, 3 * 4096, *QWEN3_B, 2 ** 31 + 13]
DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
CSRC = Path(sa.__file__).parent / "csrc" / "subspace_adam.cu"


def _index_map():
    return UpdateIndexMap(sa.THREADS, sa.UNROLL, sa.VEC)


def test_the_plan_is_the_kernels_tile():
    src = CSRC.read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (THREADS|VEC|UNROLL) = (\d+);", src)}
    assert consts == {"THREADS": sa.THREADS, "VEC": sa.VEC,
                      "UNROLL": sa.UNROLL}
    assert sa.TILE == 256 * 4 * 4 == _index_map().tile
    assert QWEN3_B == (503_316_480, 671_088_640)


@pytest.mark.parametrize("n", SIZES)
def test_the_update_plan_covers_every_index_once(n):
    assert_update_covers_once(n, sa.update_grid(n), _index_map())


class _Int32Starts(UpdateIndexMap):
    def tile_start(self, t):          # blockIdx.x * TILE in 32 bits
        return t.astype(np.int32) * np.int32(self.tile)

    def ragged_start(self, n):        # n / TILE * TILE in 32 bits
        with np.errstate(over="ignore"):
            return np.int32(n // self.tile) * np.int32(self.tile)


class _LaneStrideShort(UpdateIndexMap):
    def lane_starts(self):
        return super().lane_starts() // self.vec * (self.vec - 1)


class _StepStrideShort(UpdateIndexMap):
    def lane_starts(self):
        u, lane = np.meshgrid(np.arange(self.unroll),
                              np.arange(self.threads), indexing="ij")
        return ((u * (self.threads - 1) + lane) * self.vec).ravel()


class _RaggedDropped(UpdateIndexMap):
    def ragged(self, n):
        return n % self.tile > self.vec


class _VectorPastN(UpdateIndexMap):
    def vector_fits(self, i, n):
        return i + self.vec <= n + 1


class _TailShort(UpdateIndexMap):
    def tail(self, i, n):
        return np.arange(i, n - 1)


# fault: (n, grid of n, the index map)
FAULTS = {
    "grid one short": (4096 * 3 + 105, lambda n: sa.update_grid(n) - 1,
                       UpdateIndexMap),
    "grid one short, no ragged tile": (4096 * 3,
                                       lambda n: sa.update_grid(n) - 1,
                                       UpdateIndexMap),
    "grid one over": (4096 * 3 + 105, lambda n: sa.update_grid(n) + 1,
                      UpdateIndexMap),
    "indices in 32 bits": (2 ** 31 + 13, sa.update_grid, _Int32Starts),
    "lane stride an element short": (105, sa.update_grid, _LaneStrideShort),
    "step stride a lane short": (4096 * 2, sa.update_grid,
                                 _StepStrideShort),
    "ragged tile dropped": (4096 + 3, sa.update_grid, _RaggedDropped),
    "ragged vector one past n": (8 * 1000 + 3, sa.update_grid,
                                 _VectorPastN),
    "tail one short": (8 * 1000 + 3, sa.update_grid, _TailShort),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_off_by_one_fails_the_walk(fault):
    n, grid, imap = FAULTS[fault]
    assert_update_covers_once(n, sa.update_grid(n), _index_map())
    with pytest.raises(AssertionError):
        assert_update_covers_once(n, grid(n), imap(sa.THREADS, sa.UNROLL,
                                                   sa.VEC))


def _operands(n, dtypes=(torch.float32, torch.float32), device="cpu"):
    rng = np.random.default_rng(n)
    b, g, m = (torch.from_numpy(s * rng.standard_normal(n)
                                .astype(np.float32)).to(device)
               for s in (0.02, 1e-3, 1e-4))
    v = torch.from_numpy((1e-4 * rng.standard_normal(n)).astype(np.float32)
                         ** 2).to(device)
    return b.to(dtypes[0]), g.to(dtypes[1]), m, v


def _offset(t, k):
    """t's values in a view that starts k elements into its storage."""
    base = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    base[k:] = t
    return base[k:]


OPERANDS = ["b", "g", "m", "v", "b'", "m'", "v'"]
# (operand, dtype of b and g, offset in elements): m, v and the outputs
# are fp32 in every instance
OFFSETS = [(i, torch.float32, k) for i in range(7) for k in (1, 2, 3)] + [
    (i, torch.bfloat16, k) for i in range(2) for k in (1, 3, 5)]


@pytest.mark.parametrize("which,dtype,k", OFFSETS, ids=[
    f"{OPERANDS[i]}-{str(d)[6:]}-{k}" for i, d, k in OFFSETS])
def test_the_alignment_check_refuses_an_offset_operand(which, dtype, k):
    n = 105
    ops = list(_operands(n, (dtype, dtype))) + [torch.empty(n)
                                                 for _ in range(3)]
    ops[which] = _offset(ops[which], k)
    # the check the launch runs before anything is built or launched
    with pytest.raises(ValueError, match="not aligned"):
        sa._launch_update("subspace_adam", ops[:4], ops[4:], torch.zeros(3),
                          ADAM_CONSTS)


@pytest.mark.parametrize("dtype,k", [(torch.float32, 0), (torch.float32, 4),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 16)])
def test_the_alignment_check_takes_aligned_operands(dtype, k):
    ins = [_offset(t, k) for t in _operands(105, (dtype, dtype))]
    sa._check_aligned("subspace_adam", dict(zip("bgmv", ins)))


def test_card_tests_skip_with_a_reason():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to skip")
    with pytest.raises(pytest.skip.Exception, match="CUDA device"):
        _require_cuda()


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture
def cuda():
    _require_cuda()
    return torch.device("cuda")


def _grids(n):
    """The grids a call over n elements queues: the whole tiles', where
    there is one, and the ragged tile's, where there is one."""
    return int(n >= sa.TILE) + int(n % sa.TILE > 0)


def _scalars(dev):
    return dispatch.adam_scalars(3e-3, torch.tensor(5, device=dev), 0.9,
                                 0.999, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d))
@pytest.mark.parametrize("shape", [(1,), (7,), (105,), (8003,),
                                   (4, 12, 640, 128), (2, 12, 1712, 128),
                                   (1, 12, 640, 128), (1, 32256, 128)])
def test_lion_kernel_equals_plain_on_card(cuda, dtypes, shape):
    n = int(np.prod(shape))
    b, g, m, _ = (t.reshape(shape) for t in _operands(n, dtypes, cuda))
    sc = dispatch.lion_scalars(3e-4, cuda)
    sa.reset_launches()
    got = sa.subspace_lion(b, g, m, sc, **LION)
    torch.cuda.synchronize()
    want = ref.subspace_lion(b, g, m, lr=sc[0], **LION)
    assert sa.launches() == _grids(n)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["subspace_adam", "subspace_lion"])
def test_a_misaligned_view_is_refused_on_card(cuda, kernel):
    b, g, m, v = _operands(1001, device=cuda)
    fn = getattr(sa, kernel)
    args = ((b, g, m, v, _scalars(cuda), ADAM) if kernel == "subspace_adam"
            else (b, g, m, dispatch.lion_scalars(3e-4, cuda), LION))
    *ops, sc, hyper = args
    for i in range(len(ops)):
        bad = list(ops)
        bad[i] = _offset(bad[i], 1 + i % 3)
        with pytest.raises(ValueError, match="not aligned"):
            fn(*bad, sc, **hyper)


@pytest.mark.cuda
def test_a_grid_that_is_not_the_kernels_is_refused_on_card(cuda,
                                                             monkeypatch):
    b, g, m, v = _operands(8003, device=cuda)
    monkeypatch.setattr(sa, "update_grid", lambda n: n // sa.TILE + 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sa.subspace_adam(b, g, m, v, _scalars(cuda), **ADAM)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 105, 8003, 12 * 640 * 128 + 5])
def test_outputs_over_their_inputs_give_the_plain_values_on_card(cuda, n):
    b, g, m, v = _operands(n, device=cuda)
    sc = _scalars(cuda)
    lr, bc1, bc2 = sc
    want = ref.subspace_adam(b, g, m, v, lr=lr, bc1=bc1, bc2=bc2, **ADAM)
    sa._launch_update("subspace_adam", (b, g, m, v), (b, m, v), sc,
                      ADAM_CONSTS)
    torch.cuda.synchronize()
    for x, y in zip((b, m, v), want):
        assert torch.equal(x, y)
    b, g, m, _ = _operands(n, device=cuda)
    sc = dispatch.lion_scalars(3e-4, cuda)
    want = ref.subspace_lion(b, g, m, lr=sc[0], **LION)
    sa._launch_update("subspace_lion", (b, g, m), (b, m), sc,
                      (0.9, 0.1, 0.99, 1 - 0.99, 0.05))
    torch.cuda.synchronize()
    for x, y in zip((b, m), want):
        assert torch.equal(x, y)
