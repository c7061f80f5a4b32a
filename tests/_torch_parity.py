"""Helpers of the port's training parity tests (not a test module).

The port's plain path in float64, the yardstick that tells a fault of
the port from an fp32 sum that the port and the JAX package take in
other orders:

* :func:`float64_plain_path`: inside, ``.float()`` widens to float64,
  the packed views are float64 and the stochastic round is
  :func:`sr_bf16_f64`;
* :func:`widened`: a ``(params, state)`` of the port with every fp32
  tensor and int8 scale in float64;
* :func:`assert_float64`: after a run, every float tensor it left is
  float64 (bf16 only where a master is stored in bf16), so a path that
  widens some other way than ``.float()`` fails here instead of leaving
  fp32 inside the yardstick.

The criteria for state that went through a bf16 or int8 round, where
an fp32 difference in the last bits moves a round only at an edge:
:func:`bf16_steps_close` and :func:`quant_close`.

The reference's SSD decay with the port's masked exp,
:func:`overflow_free_decay`, to monkeypatch into a JAX run where the
stock ``_segsum_decay`` turns a masked difference past exp's range into
a NaN gradient.

A training checkpoint that crosses between the packages, written at
step :data:`SAVED`: :func:`assert_same_format` (the port's records are
the reference's, byte for byte) and :func:`assert_reference_restores`
(the reference restores the port's unquarantined).

MoE routing, recorded on both sides and held equal before any value
is compared (a top-k choice that flips at a near-tie moves an output by
far more than rounding does): :func:`port_routing_recorder`,
:func:`jax_routing_recorder` (the reference's routing, re-derived beside
each ``moe_ffn`` call and read out by ``jax.debug.callback``),
:func:`assert_same_routing` (equal ``top_idx`` and keep masks, and the
smallest gap between the k-th and (k+1)-th probability above the
comparison's error scale) and, for training runs whose later steps
start from weights an update apart, :func:`assert_same_masks`.

The kernels' 3xTF32 arithmetic (``csrc/tf32_mma.cuh``), for emulating
them on the CPU: :func:`tf32` (the split's rounding), :func:`trunc_tf32`
(what the MMA reads of an fp32 operand) and :func:`mm3` (one 3xTF32
product).

The fp32-state updates' index map (``csrc/subspace_adam.cu``'s
``update_kernel``) in numpy, :class:`UpdateIndexMap`, and the walk of a
launch of it over n elements, :func:`assert_update_covers_once`.
"""
import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.kernels import ref as kref
from repro_torch.optim import quant
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps

SAVED = 2          # a crossing checkpoint's step; the next resample is at 4
PORT_ONLY = {"opt||gen"}


def sr_bf16_f64(x, bits):
    """``ref.sr_bf16``'s law taken of the exact value: ``x`` rounds away
    from zero to the next bf16 iff ``bits >= 2**16 · (1 − frac)``, where
    ``frac`` is the part of a bf16 step that truncation drops."""
    x = x.double()
    mant, exp = torch.frexp(x.abs())
    step = torch.ldexp(torch.ones_like(x), exp - 8)
    low = torch.floor(x.abs() / step) * step
    up = bits.double() >= 65536.0 * (1.0 - (x.abs() - low) / step)
    return (torch.where(up, low + step, low) * torch.sign(x)).to(
        torch.bfloat16)


def overflow_free_decay(da):
    """The reference's ``_segsum_decay`` with the port's masked exp: the
    masked differences are never exponentiated (JAX is imported here, so
    the card's JAX-free tests can import this module)."""
    import jax.numpy as jnp
    Q = da.shape[-1]
    clog = jnp.cumsum(da, axis=-1)
    diff = clog[..., :, None] - clog[..., None, :]
    return jnp.exp(jnp.where(jnp.tril(jnp.ones((Q, Q), bool)), diff,
                             -jnp.inf))


def _npz(wd, step=SAVED):
    return np.load(os.path.join(wd, f"step_{step:08d}", "arrays.npz"))


def assert_same_format(jwd, pwd):
    """The port's step ``SAVED`` in ``pwd`` has the JAX one's records:
    names (but the port's own), shapes, dtypes, CRCs (but ``opt||key``),
    quant tags, and bytes."""
    from repro.train import checkpoint as jckpt
    jm, pm = jckpt.read_manifest(jwd, SAVED), ckpt.read_manifest(pwd, SAVED)
    assert set(pm["crc"]) - PORT_ONLY == set(jm["crc"])
    assert pm["quant"] == jm["quant"]
    jz, pz = _npz(jwd), _npz(pwd)
    for k in jm["crc"]:
        assert pm["shapes"][k] == jm["shapes"][k], k
        assert pm["dtypes"][k] == jm["dtypes"][k], k
        assert pz[k].dtype == jz[k].dtype, k
        if k.endswith("||key"):
            assert pz[k].shape == (2,) and pz[k].dtype == np.uint32
            continue
        assert pm["crc"][k] == jm["crc"][k], k
        assert pz[k].tobytes() == jz[k].tobytes(), k


def assert_reference_restores(pwd, jtemplate, method):
    """``repro.train.checkpoint.restore_latest`` takes the port's
    checkpoint without a quarantine, and what it reads back is the
    port's records byte for byte."""
    from repro.train import checkpoint as jckpt
    restored, man = jckpt.restore_latest(pwd, jtemplate,
                                         expect_method=method)
    assert restored is not None, "the reference quarantined the step"
    assert man["step"] == SAVED
    assert not [n for n in os.listdir(pwd) if n.endswith(".corrupt")]
    flat, pz = jckpt._flatten(restored), _npz(pwd)
    for k, arr in flat.items():
        assert arr.shape == pz[k].shape, k
        assert arr.tobytes() == pz[k].tobytes(), k


@contextlib.contextmanager
def float64_plain_path():
    """Inside, the port's plain path computes in float64.  Stored bf16
    masters and int8 payloads keep their types; :func:`widened` makes the
    rest of a state float64."""
    saved = torch.Tensor.float, steps.pack_dtype, kref.sr_bf16
    torch.Tensor.float = lambda t: t.double()
    steps.pack_dtype = lambda *a: torch.float64
    kref.sr_bf16 = sr_bf16_f64
    try:
        yield
    finally:
        torch.Tensor.float, steps.pack_dtype, kref.sr_bf16 = saved


def widened(params, state, master_dtype=None):
    """``(params, state)`` with every fp32 tensor and int8 scale in
    float64; with ``master_dtype="float32"`` the bf16 B masters widen too
    and the layout stops rounding them (the exact step before its round)."""
    kinds = (torch.float32,) if master_dtype is None else (
        torch.float32, torch.bfloat16)

    def dbl(x):
        if isinstance(x, quant.QuantizedTensor):
            return dataclasses.replace(x, scale=x.scale.double())
        return x.double() if x.dtype == torch.float32 else x

    def dbl_b(x):
        return x.double() if x.dtype in kinds else x
    layout = state.layout if master_dtype is None else \
        state.layout._replace(master_dtype=master_dtype)
    params = dataclasses.replace(params, dense=tuple(map(dbl, params.dense)),
                                 groups=tuple(map(dbl, params.groups)))
    state = dataclasses.replace(
        state, layout=layout,
        dense=tuple(d._replace(m=dbl(d.m), v=dbl(d.v)) for d in state.dense),
        groups=tuple(g._replace(proj=dbl(g.proj), b=dbl_b(g.b), m=dbl(g.m),
                                v=dbl(g.v), energy=dbl(g.energy))
                     for g in state.groups))
    return params, state


def assert_float64(params, state):
    """Every float tensor of a float64 run's ``(params, state)`` is
    float64, but for the stored bf16 masters: the grouped weights, and
    ``B`` where the layout keeps it in bf16."""
    def check(x, may_bf16=False):
        t = x.scale if isinstance(x, quant.QuantizedTensor) else x
        if not t.is_floating_point():
            return
        allowed = (torch.float64, torch.bfloat16) if may_bf16 else \
            (torch.float64,)
        assert t.dtype in allowed, t.dtype

    b_bf16 = state.layout.master_dtype == "bfloat16"
    for w in params.dense:
        check(w)
    for w in params.groups:
        check(w, may_bf16=True)
    for d in state.dense:
        check(d.m)
        check(d.v)
    for g in state.groups:
        check(g.proj)
        check(g.b, may_bf16=b_bf16)
        check(g.m)
        check(g.v)
        check(g.energy)


def _f64(x):
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def bf16_step(mag):
    """The bf16 step (ulp) at magnitude ``mag``."""
    mag = np.maximum(mag, 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def bf16_steps_close(got, want, before=None, atol=0.0):
    """Every element within one bf16 step (or ``atol``), at most 1% off.
    With ``before`` (B before an inner step) the step is counted at the
    largest magnitude that entered the sum ``b + update``: where the
    update cancels ``b``, the result is far smaller than either, and the
    fp32 difference its round inherits is one of theirs."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(got), np.abs(want))
    if before is not None:
        b0 = _f64(before)
        mag = np.maximum.reduce([mag, np.abs(b0), np.abs(got - b0),
                                 np.abs(want - b0)])
    off = got != want
    assert (np.abs(got - want) <= np.maximum(bf16_step(mag), atol)).all(), \
        np.abs(got - want).max()
    assert off.mean() <= 0.01, off.mean()


def quant_close(got, want, bf16_grad=False):
    """A port int8 moment against the reference's: the scales within 1e-4
    of the largest, the payloads within one step, at most 1% off.  With
    ``bf16_grad`` (B's gradient rounded to bf16, as under bf16 masters) a
    scale may also move by one bf16 step of its own size, ``2**-7`` of
    it: a last-bit difference of the fp32 gradient moves its bf16 round,
    and so a block's absmax, by one step."""
    assert isinstance(got, quant.QuantizedTensor)
    assert (got.block, got.codec) == (want.block, want.codec)
    scale, ref_scale = _f64(got.scale), _f64(want.scale)
    tol = 1e-4 * max(np.abs(ref_scale).max(), 1e-30)
    if bf16_grad:
        tol = np.maximum(tol, 2.0 ** -7 * np.abs(ref_scale))
    assert (np.abs(scale - ref_scale) <= tol).all()
    dq = got.q.numpy().astype(np.int32) - np.asarray(want.q).astype(np.int32)
    assert np.abs(dq).max() <= 1 and (dq != 0).mean() <= 0.01


def tf32(a):
    """fp32 rounded to 10 mantissa bits, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``)."""
    i = a.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1fff).view(torch.float32)


def trunc_tf32(a):
    """fp32 cut to 10 mantissa bits (toward zero): what the MMA reads of
    an fp32 operand."""
    i = a.float().contiguous().view(torch.int32)
    return (i & ~0x1fff).view(torch.float32)


def mm3(a, b, eq):
    """The 3xTF32 product: hi = tf32(a) rounded, lo = a - hi as the MMA
    reads it (cut to tf32), b likewise; lo*hi + hi*lo + hi*hi summed
    exactly (fp64), rounded to fp32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = trunc_tf32(a - ah), trunc_tf32(b - bh)

    def f(u, v):
        return torch.einsum(eq, u.double(), v.double())
    return (f(al, bh) + f(ah, bl) + f(ah, bh)).float()


# the k-th/(k+1)-th probability gap must exceed this many times the
# largest probability difference between the two sides: a flip needs the
# two probabilities to cross, each moving by at most that difference
GAP_FACTOR = 2.0


def kth_gap(probs, k):
    """Per token, the k-th largest probability minus the (k+1)-th."""
    top = torch.topk(torch.from_numpy(np.array(probs, np.float64)), k + 1,
                     dim=-1).values
    return top[:, k - 1] - top[:, k]


def port_routing_recorder(record):
    """A stand-in for ``repro_torch.models.moe.route`` that appends each
    call's ``(probs, top_idx, keep)`` (numpy) to ``record``."""
    from repro_torch.models import moe
    real = moe.route

    def route(*a, **kw):
        r = real(*a, **kw)
        record.append(tuple(t.detach().cpu().numpy()
                            for t in (r.probs, r.top_idx, r.keep)))
        return r
    return route


def jax_routing(xf, router_w, k, capacity):
    """The reference's routing of ``xf`` (T, d), as
    ``repro.models.moe.moe_ffn`` derives it: fp32 softmax, top-k, the
    position of each pair in its expert's queue by a stable sort."""
    import jax
    import jax.numpy as jnp
    T, E = xf.shape[0], router_w.shape[-1]
    probs = jax.nn.softmax(xf.astype(jnp.float32)
                           @ router_w.astype(jnp.float32), axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    flat_e = top_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    grp_start = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_sorted = jnp.arange(T * k, dtype=jnp.int32) - grp_start[sorted_e]
    pos = jnp.zeros((T * k,), jnp.int32).at[order].set(pos_sorted)
    return probs, top_idx, pos < capacity


def jax_routing_recorder(record):
    """A stand-in for ``repro.models.lm.moe_ffn`` that calls it and
    appends each call's routing (:func:`jax_routing`) to ``record``,
    in program order, also inside ``jit`` and ``lax.scan``."""
    import jax
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    real = jlm.moe_ffn

    def moe_ffn(x, router_w, *w, top_k, capacity_factor=1.25, **kw):
        B, S, d = x.shape
        C = jmoe._capacity(B * S, top_k, router_w.shape[-1],
                           capacity_factor)
        jax.debug.callback(
            lambda *a: record.append(tuple(np.asarray(t) for t in a)),
            *jax_routing(x.reshape(B * S, d), router_w, top_k, C),
            ordered=True)
        return real(x, router_w, *w, top_k=top_k,
                    capacity_factor=capacity_factor, **kw)
    return moe_ffn


def assert_same_routing(got, want, k):
    """Equal ``top_idx`` and keep masks call by call, and each call's
    smallest k-th/(k+1)-th probability gap above ``GAP_FACTOR`` times
    its largest probability difference.  Returns the smallest gap."""
    assert len(got) == len(want) and got, (len(got), len(want))
    gaps = []
    for (gp, gi, gk), (wp, wi, wk) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gk, wk)
        dprob = float(np.abs(np.asarray(gp, np.float64)
                             - np.asarray(wp, np.float64)).max())
        gap = float(kth_gap(wp, k).min())
        assert gap > GAP_FACTOR * dprob, (gap, dprob)
        gaps.append(gap)
    print(f"routing equal over {len(got)} calls; smallest k-th gap "
          f"{min(gaps):.3g}")
    return min(gaps)


def assert_same_masks(got, want, k, first):
    """Equal top-k and keep masks in every call, and the first ``first``
    calls (a run's first step, from the same weights on both sides) also
    under :func:`assert_same_routing`'s gap rule.  Training runs start
    their later steps from weights an update apart: a first Adam or
    GaLore step is sign-like, so an element whose gradient lies at fp32's
    rounding noise moves by lr either way, and the probabilities part by
    more than rounding (up to 5e-5 in the MoE training tests).  Equal
    masks are what keeps the values comparable; the later calls' gaps
    are printed."""
    assert len(got) == len(want) and len(got) >= first, (len(got),
                                                         len(want))
    assert_same_routing(got[:first], want[:first], k)
    for (gp, gi, gk), (wp, wi, wk) in zip(got[first:], want[first:]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gk, wk)
        gap = float(kth_gap(wp, k).min())
        print(f"later step: smallest k-th gap {gap:.3g}, largest "
              f"probability difference "
              f"{np.abs(np.asarray(gp, np.float64) - wp).max():.3g}")


class UpdateIndexMap:
    """The index expressions of ``csrc/subspace_adam.cu``'s
    ``update_kernel`` in numpy.  The whole tiles' launch: block t takes
    the tile from :meth:`tile_start` (t·tile, 64-bit); in vector step u,
    lane l owns the ``vec`` elements from there + :meth:`lane_starts`
    ((u·threads + l)·vec), all of them.  Where :meth:`ragged` (tile does
    not divide n), one block more takes the tile from
    :meth:`ragged_start` ((n // tile)·tile) the same way, but updates a
    vector that ends by n (:meth:`vector_fits`) whole and, of the one
    that does not, the elements :meth:`tail` one at a time.  A planted
    fault overrides one expression."""

    def __init__(self, threads, unroll, vec):
        self.threads, self.unroll, self.vec = threads, unroll, vec
        self.tile = threads * unroll * vec

    def tile_start(self, t):
        return t.astype(np.int64) * np.int64(self.tile)

    def ragged_start(self, n):
        return np.int64(n) // self.tile * self.tile

    def lane_starts(self):
        u, lane = np.meshgrid(np.arange(self.unroll),
                              np.arange(self.threads), indexing="ij")
        return ((u * self.threads + lane) * self.vec).ravel()

    def ragged(self, n):
        return n % self.tile > 0

    def vector_fits(self, i, n):
        return i + self.vec <= n

    def tail(self, i, n):
        return np.arange(i, n)


def assert_update_covers_once(n, grid, imap) -> None:
    """Assert that a call of ``imap`` over n elements, ``grid`` blocks
    over the whole tiles and the ragged tile's block, updates every index
    of [0, n) exactly once.  The whole tiles must lie back to back from
    0 and end by n, each updated once; the ragged tile is walked element
    by element."""
    starts = imap.tile_start(np.arange(grid))
    assert (starts == np.arange(grid, dtype=np.int64) * imap.tile).all(), \
        "whole tiles not back to back from 0"
    lanes = imap.lane_starts()
    one = (lanes[:, None] + np.arange(imap.vec)).ravel()
    assert one.min() >= 0 and one.max() < imap.tile and (
        np.bincount(one, minlength=imap.tile) == 1).all(), \
        "a whole tile's vectors miss or repeat an element"
    done = grid * imap.tile
    assert done <= n, "a whole tile runs past n"
    writes = [np.zeros(0, np.int64)]
    if imap.ragged(n):
        i = imap.ragged_start(n) + lanes
        fits = imap.vector_fits(i, n)
        writes.append((i[fits][:, None] + np.arange(imap.vec)).ravel())
        writes += [imap.tail(j, n) for j in i[~fits]]
    idx = np.concatenate(writes)
    assert idx.size == 0 or (idx.min() >= done and idx.max() < n), \
        "the ragged tile writes outside the whole tiles' end and n"
    assert (np.bincount(idx - done, minlength=n - done) == 1).all(), \
        "the ragged tile misses or repeats an element"
