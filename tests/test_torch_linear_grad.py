"""The port's differentiable low-rank linear against ``jax.vjp`` of the
reference's ``repro.models.linear.lowrank_matmul``.

* fp32: ``y``, ``dx`` and ``dB`` agree within 1e-5 of each output's
  largest magnitude (the same fp32 arithmetic, summed in another order).
* bf16 pack cast, as the training step packs it: x, W and V in bf16 and
  a bf16 view of the fp32 B master.  Both packages return ``dB`` rounded
  to bf16 (``db.astype(b.dtype)``), so the master's gradient is a
  bf16-rounded value cast back up; it is held within 1e-2 of its largest
  magnitude (about two bf16 ulps: the fp32 sums before the rounding are
  taken in another order).  ``y`` is held within 2e-2: the reference's
  XLA route rounds ``p`` to bf16 before ``Bᵀ``, the port does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import linear as jlinear  # noqa: E402
from repro_torch.models import linear  # noqa: E402
from repro_torch.models.linear import LowRankMatmul, LRPack  # noqa: E402


def _operands(lead, K, N, r, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal(lead + (K,)).astype(np.float32),
            (g.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
            (0.1 * g.standard_normal((N, r))).astype(np.float32),
            (g.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32),
            g.standard_normal(lead + (N,)).astype(np.float32))


def _close(got, want, rel):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _port(x, w, b, v, dy, cast=None):
    """y, dx and the gradient of the fp32 B master through the port."""
    xt = torch.from_numpy(x).requires_grad_()
    b32 = torch.from_numpy(b).requires_grad_()
    wt, vt = torch.from_numpy(w), torch.from_numpy(v)
    xin, bin_ = xt, b32
    if cast is not None:
        xin, wt, vt, bin_ = (t.to(cast) for t in (xt, wt, vt, b32))
    y = LowRankMatmul.apply(xin, wt, bin_, vt)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    return y, xt.grad, b32.grad


def _jax(x, w, b, v, dy, cast=None):
    def f(xx, bb):
        if cast is not None:
            xx, bb = xx.astype(cast), bb.astype(cast)
            ww, vv = jnp.asarray(w).astype(cast), jnp.asarray(v).astype(cast)
        else:
            ww, vv = jnp.asarray(w), jnp.asarray(v)
        return jlinear.lowrank_matmul(xx, ww, bb, vv)
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(b))
    dx, db = vjp(jnp.asarray(dy).astype(y.dtype))
    return y, dx, db


@pytest.mark.parametrize("lead,K,N,r", [((7,), 40, 24, 4),
                                        ((2, 5), 64, 130, 8),
                                        ((3, 11), 128, 96, 16)])
def test_lowrank_matmul_matches_jax_vjp_fp32(lead, K, N, r):
    ops = _operands(lead, K, N, r)
    y, dx, db = _port(*ops)
    jy, jdx, jdb = _jax(*ops)
    assert dx.dtype == db.dtype == torch.float32
    _close(y, jy, 1e-5)
    _close(dx, jdx, 1e-5)
    _close(db, jdb, 1e-5)


@pytest.mark.parametrize("lead,K,N,r", [((2, 9), 64, 130, 8),
                                        ((33,), 96, 40, 16)])
def test_lowrank_matmul_with_the_bf16_pack_cast(lead, K, N, r):
    ops = _operands(lead, K, N, r, seed=1)
    y, dx, db = _port(*ops, cast=torch.bfloat16)
    jy, jdx, jdb = _jax(*ops, cast=jnp.bfloat16)
    assert y.dtype == torch.bfloat16
    assert dx.dtype == db.dtype == torch.float32
    # the master's gradient is dB rounded to bf16, then cast back up
    assert torch.equal(db, db.bfloat16().float())
    _close(y, jy, 2e-2)
    _close(dx, jdx, 1e-2)
    _close(db, jdb, 1e-2)


def test_linear_takes_the_autograd_path_only_when_a_gradient_is_wanted():
    x, w, b, v, _ = (torch.from_numpy(a) for a in _operands((4,), 8, 6, 2))
    pack = LRPack(w, b.clone().requires_grad_(), v)
    y = linear.linear(x, pack)
    assert y.grad_fn is not None and "LowRankMatmul" in type(
        y.grad_fn).__name__
    with torch.no_grad():
        y0 = linear.linear(x, pack)
    assert y0.grad_fn is None
    assert torch.equal(y0, y.detach())
    # W and V get no gradient
    wg = w.clone().requires_grad_()
    y = linear.linear(x, LRPack(wg, pack.b, v))
    y.sum().backward()
    assert wg.grad is None and pack.b.grad is not None


def test_pack_tree_matches_the_reference_structure():
    g = np.random.default_rng(3)
    w1 = g.standard_normal((8, 6)).astype(np.float32)
    w2 = g.standard_normal((6,)).astype(np.float32)
    lr = {"b": g.standard_normal((6, 2)).astype(np.float32),
          "v": g.standard_normal((8, 2)).astype(np.float32)}
    jtree = jlinear.pack_tree({"a": {"w": w1}, "n": w2},
                              {"a": {"w": lr}, "n": None})
    ttree = linear.pack_tree(
        {"a": {"w": torch.from_numpy(w1)}, "n": torch.from_numpy(w2)},
        {"a": {"w": {k: torch.from_numpy(a) for k, a in lr.items()}},
         "n": None})
    assert isinstance(jtree["a"]["w"], jlinear.LRPack)
    assert isinstance(ttree["a"]["w"], LRPack)
    for f in ("w", "b", "v"):
        np.testing.assert_array_equal(
            getattr(ttree["a"]["w"], f).numpy(),
            np.asarray(getattr(jtree["a"]["w"], f)))
    np.testing.assert_array_equal(ttree["n"].numpy(), np.asarray(jtree["n"]))
