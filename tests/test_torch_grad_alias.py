"""Gradients that share their bytes, through the in-place clip and the
accumulation of microbatches, against the JAX package.

Autograd gives two leaves one tensor where their gradients are one
(``x + y``), and a view's gradient may lie inside another's.  The
reference's clip scales each leaf once, whatever aliases it
(``repro.optim.adamw.clip_by_global_norm``); the port scales fp32
gradients where they lie (``repro_torch.optim.adamw``), so:

* ``clip_by_global_norm(..., inplace=True)`` equals the reference's clip
  of the same numpy values, entry by entry (within 1e-6 of the largest
  magnitude: the norm's fp32 sum in another order), for one tensor given
  twice, one storage seen in two layouts, views that overlap in part,
  disjoint views of one storage, an expanded (stride 0) gradient and a
  bf16 one;
* an fp32 gradient that shares no byte with another is still scaled in
  place (the clipped entry is the input, same ``data_ptr()``), and so is
  the first of several views of the very same bytes;
* ``train.steps.accumulate``, the loop of ``grad_accum`` microbatches,
  sums aliased microbatch gradients once (1 and 2 make 3, not 5), keeps
  an unaliased first gradient as its sum (no copy), and copies a later
  gradient that lies in a sum's storage before adding it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

MAX_NORM = 1.0


def _t(seed, *shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _cases():
    g, h = _t(0, 4, 6), _t(1, 5)
    w = _t(2, 12)
    m = _t(3, 3, 4)
    return {
        "one tensor twice": [g, g, h],
        "one storage in two layouts": [m, m.T, h],
        "views overlapping in part": [w[:8], w[4:], h],
        "disjoint views": [w[:5], w[5:], g],
        "expanded": [_t(4, 6).expand(3, 6), g],
        "bf16 beside its fp32 twin": [g.bfloat16(), g, g],
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_the_in_place_clip_scales_each_entry_once(case):
    tensors = _cases()[case]
    leaves = [jnp.asarray(t.float().numpy().copy()) for t in tensors]
    want, want_gn = jadamw.clip_by_global_norm(leaves, MAX_NORM)
    got, gn = adamw.clip_by_global_norm(tensors, MAX_NORM, inplace=True)
    assert float(want_gn) > 2 * MAX_NORM          # the clip scales
    np.testing.assert_allclose(gn.item(), float(want_gn), rtol=1e-6)
    for x, y in zip(got, want):
        y = np.asarray(y)
        assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
        assert np.abs(x.numpy() - y).max() <= 1e-6 * np.abs(y).max()


def test_unaliased_fp32_gradients_are_scaled_in_place():
    g, h, w = _t(0, 4, 6), _t(1, 5), _t(2, 12)
    tensors = [g, h, w[:5], w[5:], g, h.bfloat16()]
    assert adamw.writable_once(tensors) == ["own", "own", "own", "own",
                                            "alias", "copy"]
    ptrs = [t.data_ptr() for t in tensors]
    got, _ = adamw.clip_by_global_norm(tensors, MAX_NORM, inplace=True)
    assert [x.data_ptr() for x in got[:5]] == ptrs[:5]
    assert got[5].data_ptr() != ptrs[5]
    # out of place, nothing is written
    g2 = _t(0, 4, 6)
    got2, _ = adamw.clip_by_global_norm([g2, g2], MAX_NORM)
    assert torch.equal(g2, _t(0, 4, 6))
    assert got2[0].data_ptr() != g2.data_ptr()


def test_partly_overlapping_and_non_dense_entries_are_copied():
    w = _t(2, 12)
    assert adamw.writable_once([w[:8], w[4:], w[:8]]) == ["copy"] * 3
    assert adamw.writable_once([_t(4, 6).expand(3, 6), w.view(3, 4).T,
                                w.view(3, 4)]) == ["copy", "own", "alias"]


def test_accumulation_sums_aliased_microbatch_gradients_once():
    one, two = torch.ones(3), torch.full((3,), 2.0)
    gsum = steps.accumulate(None, [one, one])
    gsum = steps.accumulate(gsum, [two, two])
    for a in gsum:
        assert torch.equal(a, torch.full((3,), 3.0))


def test_accumulation_keeps_an_unaliased_first_gradient_as_its_sum():
    g, h = _t(0, 4, 6), _t(1, 5, dtype=torch.bfloat16)
    w = _t(2, 12)
    first = [g, h, w[:8], w[4:]]
    gsum = steps.accumulate(None, first)
    assert gsum[0] is g                       # fp32, unaliased: no copy
    assert gsum[1].dtype == torch.float32     # bf16: widened
    assert gsum[2].data_ptr() != w.data_ptr()  # overlapping views: copied
    later = [_t(5, 4, 6), _t(6, 5), _t(7, 8), _t(8, 8)]
    want = [x.float() + y for x, y in zip(first, later)]
    gsum = steps.accumulate(gsum, later)
    for a, b in zip(gsum, want):
        assert torch.equal(a, b)


def test_accumulation_copies_a_gradient_that_lies_in_a_sum():
    g = _t(0, 6)
    gsum = steps.accumulate(None, [g, _t(1, 6)])
    # a later microbatch whose first gradient is the first sum's storage
    later = [gsum[0], gsum[0][:6]]
    want = [gsum[0] * 2, gsum[1] + gsum[0]]
    gsum = steps.accumulate(gsum, later)
    for a, b in zip(gsum, want):
        assert torch.equal(a, b)
