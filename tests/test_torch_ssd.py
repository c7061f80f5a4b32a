"""The port's SSM modules against the JAX package, on the CPU.

* The plain ``ssd_intra_chunk`` (the CPU route of the wrapper, and what
  the CUDA kernel is held to on the card) against the reference's Pallas
  kernel in interpret mode, at ``tests/test_kernels.py``'s shapes, a
  chunk of 20 tokens and a strongly negative ``da`` (``dt A`` with A
  down to -16), where the output must stay finite.
* ``ssd_chunked`` (with and without ``init_state``, one group and two),
  ``ssd_decode_step``, ``causal_conv1d`` and ``causal_conv1d_step``
  against their JAX counterparts, and ``mamba2_mixer`` over an
  ``LRPack`` in prefill (with and without its state) and in decode.
* The wrapper's refusals, which both routes make.
* The kernel's launch split (``ssd_plan``, ``ssd_cta``): a full card at
  mamba2-780m's and zamba2-7b's prefill shapes (zamba2's N = 64 leaves
  chunk parts with y rows and no state rows), every output element owned
  by exactly
  one chunk CTA, every causal entry of G by exactly one Gram CTA (one
  Gram per shared B/C group, not one per head).
* The kernel's arithmetic emulated on the CPU: the 3xTF32 split of its
  three contractions (hi rounded to 10 mantissa bits, ties away, lo = a
  - hi cut to 10 bits as the MMA reads it; lo*hi + hi*lo + hi*hi summed
  in fp64) and its fp64 warp-shuffle scan for ``cumsum(da)``, against
  the plain version at the four prefill shapes of each model.
* The backward kernel's split (``ssd_bwd_plan``, ``ssd_bwd_cta``,
  ``ssd_bwd_tiles``): every head's dx, ddt, dda and every group's db,
  dc owned by one CTA, a slice's heads in order, the warps' datt tiles
  covering the causal pairs once; and its arithmetic emulated
  (``_bwd_emulated``: 3xTF32 in two sums, 64-column passes, head- and
  slice-order sums, fp64 scans) against the plain version and a float64
  run, with two planted faults it must catch.

Every comparison is fp32 against fp32 with sums in another order: the
max abs error within ``REL`` = 1e-5 of the output's largest magnitude
(measured on the CPU: at most 1.3e-6 of it).  The strongly negative
``da`` case is held within ``REL_STRONG`` = 1e-4: its cumsum reaches
777 in magnitude, where one fp32 step is 6e-5, so each decay factor
carries the two cumsums' last-bit differences (measured: 2.2e-5).

The ``cuda``-marked tests hold the CUDA kernel to its plain version on
the card (ragged and path shapes, the plan's split for both b/c layouts
at both models' prefill shapes
and the launcher's refusal of any other, repeated launches, a decay far
past expf's overflow, bf16), and its backward kernel
(``csrc/ssd_chunk_bwd.cu``) to ``ref.ssd_intra_chunk_bwd`` (ragged
shapes and mamba2-780m's training shape, b and c one group or one per
head, two groups with slices starting inside a group, a decay far past
expf's overflow with every gradient finite, three launches
bit-identical, the launcher's refusal of any other split, the gradient
through the wrapper and ``ssd_chunked``, and the refusal of a bf16 input
that requires a gradient); they skip here with a reason and import no
JAX.  Run them on a card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_ssd.py``.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.linear import LRPack  # noqa: E402
from _torch_parity import float64_plain_path  # noqa: E402
from _torch_parity import mm3 as _mm3  # noqa: E402
from _torch_parity import tf32 as _tf32  # noqa: E402
from _torch_parity import trunc_tf32 as _trunc_tf32  # noqa: E402

REL = 1e-5
REL_STRONG = 1e-4
SSD_TOL = 1e-4      # chip_smoke.py's [kernel] limit, ·max|y| and ·max|state|
# (BC, Q, H, P, N) of mamba2-780m's prefills (prompts of 100, 128, 256
# and 512 tokens)
PATH_SHAPES = [(1, 100, 48, 64, 128), (1, 128, 48, 64, 128),
               (2, 128, 48, 64, 128), (4, 128, 48, 64, 128)]
# zamba2-7b's prefills (the same prompts; 112 heads, N = 64): two state
# tiles but four strip pairs, so chunk parts 2 and 3 own y rows and no
# state rows
ZAMBA_SHAPES = [(1, 100, 112, 64, 64), (1, 128, 112, 64, 64),
                (2, 128, 112, 64, 64), (4, 128, 112, 64, 64)]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk import ssd_intra_chunk
    from repro.models import ssm as jssm
    from repro.models.linear import LRPack as JLRPack
    return SimpleNamespace(jnp=jnp, pallas=ssd_intra_chunk, ssm=jssm,
                           LRPack=JLRPack)


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.array(a))


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _chunk_operands(bc, q, h, p, n, seed, strong=False):
    """x, dt, da, b, c as numpy fp32.  ``strong``: dt = softplus(N(0, 1))
    and A = -U[1, 16] per head (the top of Mamba2's ranges), so
    clog_i - clog_j of a masked pair reaches hundreds."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((bc, q, h, p))
    b = 0.5 * rng.standard_normal((bc, q, h, n))
    c = 0.5 * rng.standard_normal((bc, q, h, n))
    if strong:
        dt = _softplus(rng.standard_normal((bc, q, h)))
        da = dt * -rng.uniform(1.0, 16.0, h)
    else:
        dt = np.abs(0.3 * rng.standard_normal((bc, q, h))) + 0.01
        da = -np.abs(0.3 * rng.standard_normal((bc, q, h)))
    return tuple(a.astype(np.float32) for a in (x, dt, da, b, c))


# (bc, q, h, p, n, head_block): tests/test_kernels.py's sweep, a chunk of
# 20 tokens, and two chunks at Mamba2's dt * A
CHUNK_CASES = {
    "kernels-sweep-0": ((2, 32, 8, 16, 16, 8), False),
    "kernels-sweep-1": ((1, 64, 4, 32, 64, 2), False),
    "kernels-sweep-2": ((3, 16, 16, 64, 32, 8), False),
    "q20": ((2, 20, 4, 16, 8, 4), False),
    "strong-da": ((2, 64, 4, 16, 16, 4), True),
}


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_plain_matches_the_pallas_kernel_interpret(jref, case):
    (bc, q, h, p, n, hb), strong = CHUNK_CASES[case]
    ops = _chunk_operands(bc, q, h, p, n, seed=q + h, strong=strong)
    if strong:   # the masked pairs really would overflow expf
        clog = np.cumsum(ops[2], axis=1)
        assert (clog[:, :1] - clog[:, -1:]).max() > 88.7
    wy, ws = jref.pallas(*(jref.jnp.asarray(a) for a in ops),
                         head_block=hb, interpret=True)
    y, st = sc.ssd_intra_chunk(*(_t(a) for a in ops))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, wy, REL_STRONG if strong else REL)
    _close(st, ws, REL_STRONG if strong else REL)


def test_plain_takes_a_head_broadcast_of_one_group():
    x, dt, da, b, c = (_t(a) for a in _chunk_operands(2, 16, 4, 8, 8, 3))
    b1, c1 = b[:, :, :1].contiguous(), c[:, :, :1].contiguous()
    got = sc.ssd_intra_chunk(x, dt, da, b1.expand(-1, -1, 4, -1),
                             c1.expand(-1, -1, 4, -1))
    want = ref.ssd_intra_chunk(x, dt, da, b1.repeat(1, 1, 4, 1),
                               c1.repeat(1, 1, 4, 1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, da, b, c = (_t(a) for a in _chunk_operands(1, 16, 4, 8, 8, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sc.ssd_intra_chunk(*(t.half() for t in (x, dt, da, b, c)))
    with pytest.raises(TypeError, match="one dtype"):
        sc.ssd_intra_chunk(x, dt.double(), da, b, c)
    with pytest.raises(ValueError, match="shapes"):
        sc.ssd_intra_chunk(x, dt[:, :8], da, b, c)
    with pytest.raises(ValueError, match="shapes"):
        sc.ssd_intra_chunk(x, dt, da, b, c[..., :4])
    with pytest.raises(ValueError, match="BC, Q, H, P"):
        sc.ssd_intra_chunk(x[0], dt, da, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        sc.ssd_intra_chunk(x.transpose(2, 3).contiguous().transpose(2, 3),
                           dt, da, b, c)
    with pytest.raises(ValueError, match="head broadcast"):
        sc.ssd_intra_chunk(x, dt, da, b.mT.contiguous().mT, c)
    big = _chunk_operands(1, 160, 1, 4, 4, 5)       # Q = 160 > 128
    with pytest.raises(ValueError, match="chunks of 1..128"):
        sc.ssd_intra_chunk(*(_t(a) for a in big))


# (s, h, g, n, chunk): tests/test_models.py's recurrence sweep
SCAN_CASES = [(32, 4, 1, 8, 8), (64, 4, 2, 8, 16), (48, 2, 1, 4, 16)]


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,h,g,n,chunk", SCAN_CASES)
def test_ssd_chunked_matches_jax(jref, s, h, g, n, chunk, with_init):
    rng = np.random.default_rng(s + h + g)
    B, P = 2, 8
    f = np.float32
    x = rng.standard_normal((B, s, h, P)).astype(f)
    dt = _softplus(rng.standard_normal((B, s, h)))
    a_log = (0.5 * rng.standard_normal((h,))).astype(f)
    b = (0.5 * rng.standard_normal((B, s, g, n))).astype(f)
    c = (0.5 * rng.standard_normal((B, s, g, n))).astype(f)
    d_skip = rng.standard_normal((h,)).astype(f)
    init = (0.3 * rng.standard_normal((B, h, n, P))).astype(f) \
        if with_init else None
    jnp = jref.jnp
    wy, ws = jref.ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, a_log, b, c, d_skip)),
        chunk=chunk, init_state=None if init is None else jnp.asarray(init),
        return_state=True)
    y, st = ssm.ssd_chunked(*(_t(a) for a in (x, dt, a_log, b, c, d_skip)),
                            chunk=chunk,
                            init_state=None if init is None else _t(init),
                            return_state=True)
    _close(y, wy)
    _close(st, ws)
    assert torch.equal(ssm.ssd_chunked(
        *(_t(a) for a in (x, dt, a_log, b, c, d_skip)), chunk=chunk,
        init_state=None if init is None else _t(init)), y)


def test_ssd_chunked_refuses_a_ragged_last_chunk():
    x = torch.zeros((1, 40, 2, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(x, torch.ones((1, 40, 2)), torch.zeros(2),
                        torch.zeros((1, 40, 1, 4)), torch.zeros((1, 40, 1, 4)),
                        torch.ones(2), chunk=32)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_jax(jref, g):
    rng = np.random.default_rng(g)
    B, H, P, N = 3, 4, 8, 6
    f = np.float32
    x = rng.standard_normal((B, H, P)).astype(f)
    dt = _softplus(rng.standard_normal((B, H)))
    a_log = (0.5 * rng.standard_normal((H,))).astype(f)
    b, c = (rng.standard_normal((B, g, N)).astype(f) for _ in range(2))
    d_skip = rng.standard_normal((H,)).astype(f)
    state = rng.standard_normal((B, H, N, P)).astype(f)
    ops = (x, dt, a_log, b, c, d_skip, state)
    wy, ws = jref.ssm.ssd_decode_step(*(jref.jnp.asarray(a) for a in ops))
    y, st = ssm.ssd_decode_step(*(_t(a) for a in ops))
    _close(y, wy)
    _close(st, ws)


def test_causal_conv_and_its_step_match_jax(jref):
    rng = np.random.default_rng(7)
    B, S, Ch, K = 2, 9, 12, 4
    f = np.float32
    x = rng.standard_normal((B, S, Ch)).astype(f)
    w = rng.standard_normal((K, Ch)).astype(f)
    b = rng.standard_normal((Ch,)).astype(f)
    jnp = jref.jnp
    _close(ssm.causal_conv1d(_t(x), _t(w), _t(b)),
           jref.ssm.causal_conv1d(*(jnp.asarray(a) for a in (x, w, b))))
    state = rng.standard_normal((B, K - 1, Ch)).astype(f)
    new = rng.standard_normal((B, Ch)).astype(f)
    out, st = ssm.causal_conv1d_step(_t(new), _t(state), _t(w), _t(b))
    wout, wst = jref.ssm.causal_conv1d_step(
        *(jnp.asarray(a) for a in (new, state, w, b)))
    _close(out, wout)
    assert np.array_equal(st.numpy(), np.asarray(wst))


def _mixer_params(jref, seed=0):
    """One reduced mamba2 layer's parameters with in_proj and out_proj
    packed with random adapters, for both packages."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    jcfg = jget_config("mamba2-780m").reduced()
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jlm.init_params(jcfg, jax.random.key(seed))
                      ["layers"]["ssm"])
    rng = np.random.default_rng(seed)
    r = 4
    for name in ("in_proj", "out_proj"):
        k, n = jp[name].shape
        jp[name] = (jp[name], (0.05 * rng.standard_normal((n, r)))
                    .astype(np.float32),
                    (rng.standard_normal((k, r)) / np.sqrt(k))
                    .astype(np.float32))
    jnp = jref.jnp
    jparams = {k: jref.LRPack(*(jnp.asarray(a) for a in v))
               if isinstance(v, tuple) else jnp.asarray(v)
               for k, v in jp.items()}
    tparams = {k: LRPack(*(_t(a) for a in v)) if isinstance(v, tuple)
               else _t(v) for k, v in jp.items()}
    return jcfg, jparams, tparams


@pytest.mark.parametrize("want_state", [False, True])
def test_mamba2_mixer_prefill_matches_jax(jref, want_state):
    jcfg, jparams, tparams = _mixer_params(jref)
    cfg = get_config("mamba2-780m").reduced()
    h = np.random.default_rng(8).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)     # two chunks of 32
    wout, (wssm, wconv) = jref.ssm.mamba2_mixer(
        jref.jnp.asarray(h), jparams, jcfg, want_state=want_state)
    out, (st, conv) = ssm.mamba2_mixer(_t(h), tparams, cfg,
                                       want_state=want_state)
    _close(out, wout)
    if want_state:
        _close(st, wssm)
        _close(conv, wconv)
    else:
        assert st is None and conv is None


def test_mamba2_mixer_decode_matches_jax(jref):
    jcfg, jparams, tparams = _mixer_params(jref, seed=1)
    cfg = get_config("mamba2-780m").reduced()
    rng = np.random.default_rng(9)
    B = 3
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    h = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    s0 = (0.3 * rng.standard_normal(
        (B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))) \
        .astype(np.float32)
    c0 = rng.standard_normal((B, cfg.ssm_conv_dim - 1, conv_ch)) \
        .astype(np.float32)
    jnp = jref.jnp
    wout, (ws, wc) = jref.ssm.mamba2_mixer(
        jnp.asarray(h), jparams, jcfg, ssm_state=jnp.asarray(s0),
        conv_state=jnp.asarray(c0), decode=True)
    out, (st, conv) = ssm.mamba2_mixer(_t(h), tparams, cfg,
                                       ssm_state=_t(s0), conv_state=_t(c0),
                                       decode=True)
    _close(out, wout)
    _close(st, ws)
    _close(conv, wc)


# ---------------------------------------------------------------------------
# The kernel's launch split and arithmetic, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("shape", PATH_SHAPES + ZAMBA_SHAPES)
def test_ssd_plan_fills_the_card_at_the_path_shapes(shape, shared):
    BC, Q, H, P, N = shape
    plan = sc.ssd_plan(BC, Q, H, N, P, shared)
    assert plan.chunk_ctas >= 132 and plan.ctas >= 132   # the H100's SMs
    assert plan.groups == (1 if shared else H)


# the path shapes, the ragged card shapes and edge cases
PLAN_SHAPES = PATH_SHAPES + ZAMBA_SHAPES + [
    (1, 1, 1, 1, 1), (3, 20, 5, 16, 8), (2, 45, 3, 70, 33),
    (1, 128, 2, 128, 128),
                             (2, 17, 9, 8, 100), (1, 113, 7, 4, 31)]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_ssd_plan_covers_every_output_once(shape, shared):
    """Every (bc, head, row) of y and every (bc, head, n) of the state
    belongs to exactly one chunk CTA (each covers every column p); every
    causal (i, j <= i) entry of each group's G, and none above a strip's
    causal columns, to exactly one Gram CTA: one Gram per B/C group, not
    one per head, when b and c are shared."""
    BC, Q, H, P, N = shape
    plan = sc.ssd_plan(BC, Q, H, N, P, shared)
    y_own = np.zeros((BC, H, Q), np.int64)
    s_own = np.zeros((BC, H, N), np.int64)
    g_own = np.zeros((BC, plan.groups, Q, Q), np.int64)
    for cta in range(plan.ctas):
        role = sc.ssd_cta(plan, Q, H, N, cta)
        if role[0] == "gram":
            _, bc, grp, cells = role
            assert cta < plan.gram_ctas
            for i, j in cells:
                g_own[bc, grp, i, j] += 1
        else:
            _, bc, h, y_rows, n_rows = role
            assert cta >= plan.gram_ctas
            assert len(y_rows) <= 2 * sc.STRIP
            assert len(n_rows) <= sc.STATE_TILE
            y_own[bc, h, list(y_rows)] += 1
            s_own[bc, h, list(n_rows)] += 1
    assert (y_own == 1).all() and (s_own == 1).all()
    assert g_own.max() == 1
    causal = np.tril(np.ones((Q, Q), np.int64))
    assert ((g_own * causal) == causal).all()     # every j <= i once
    # at most the diagonal strip's 16-row block above the diagonal
    assert (g_own * (1 - causal)).sum() <= BC * plan.groups * Q * 8
    assert plan.groups == (1 if shared else H)


def _warp_cumsum(da):
    """cumsum over dim 1 (Q <= 128) in the kernel's order and precision:
    each of 32 lanes sums its four tokens in turn, the lanes' totals are
    scanned by shuffles (Hillis-Steele), a lane adds the total before it;
    all in fp64, each prefix rounded once to fp32."""
    BC, Q, H = da.shape
    v = torch.zeros((BC, 128, H), dtype=torch.float64)
    v[:, :Q] = da
    v = v.reshape(BC, 32, 4, H)
    s = torch.cumsum(v, dim=2)          # a lane's four tokens in order
    incl, off = s[:, :, 3], 1
    while off < 32:
        nxt = incl.clone()
        nxt[:, off:] = incl[:, off:] + incl[:, :-off]
        incl, off = nxt, 2 * off
    out = s.clone()
    out[:, 1:] = incl[:, :-1, None] + s[:, 1:]
    return out.reshape(BC, 128, H)[:, :Q].float()


def _ssd_emulated(x, dt, da, b1, c1):
    """The kernel's arithmetic for one B/C group (b1, c1 (BC, Q, N)):
    the cumsum in its order, the Gram, y and the state as 3xTF32
    products, the decay in fp32."""
    Q = x.shape[1]
    clog = _warp_cumsum(da)
    gram = _mm3(c1, b1, "bin,bjn->bij")[..., None]
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()
    decay = torch.where(mask[:, :, None],
                        torch.exp(clog[:, :, None] - clog[:, None]), 0.0)
    y = _mm3(gram * decay * dt[:, None], x, "bijh,bjhp->bihp")
    w = torch.exp(clog[:, -1:] - clog) * dt
    state = _mm3(b1[:, :, None] * w[..., None], x, "bjhn,bjhp->bhnp")
    return y, state


def _mixer_draw(shape, seed):
    """x, dt, da, one B/C group (b1, c1) by the mixer's laws, as
    chip_smoke.py draws them: dt = softplus(z + dt_bias), dt_bias the
    inverse softplus of exp(U[log 1e-3, log 0.1]), A = -U[1, 16]."""
    BC, Q, H, P, N = shape
    rng = np.random.default_rng(seed)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), H))
    dt = np.logaddexp(rng.standard_normal((BC, Q, H))
                      + dt0 + np.log(-np.expm1(-dt0)), 0.0)
    da = dt * -rng.uniform(1.0, 16.0, H)
    x = rng.standard_normal((BC, Q, H, P))
    b1, c1 = (rng.standard_normal((BC, Q, N)) for _ in range(2))
    return tuple(_t(a.astype(np.float32)) for a in (x, dt, da, b1, c1))


@pytest.mark.parametrize("shape", PATH_SHAPES + ZAMBA_SHAPES)
def test_3xtf32_split_keeps_fp32_accuracy(shape):
    """The kernel's arithmetic against the plain version: max err /
    max|out| measured on the CPU at most 5.4e-7 (y) and 2.1e-7 (state),
    within REL, the fp32 sums' own limit, and a 185th of SSD_TOL.  The
    fp64 scan gives torch.cumsum's fp32 values here (the CPU's
    accumulator is a double), so all of that is the split's."""
    H = shape[2]
    x, dt, da, b1, c1 = _mixer_draw(shape, seed=shape[0] + shape[1])
    clog = torch.cumsum(da, dim=1)
    assert (clog[:, :1] - clog[:, -1:]).max() > 88.7  # masked pairs overflow
    assert torch.equal(_warp_cumsum(da), clog)
    want = ref.ssd_intra_chunk(x, dt, da, *(
        t[:, :, None].expand(-1, -1, H, -1) for t in (b1, c1)))
    for got, w in zip(_ssd_emulated(x, dt, da, b1, c1), want):
        _close(got, w, REL)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                        # a tf32 value
    half = 2.0 ** -11                             # half a tf32 step at 1
    a = torch.tensor([1.0, one, 1.0 + half, -(1.0 + half),
                      1.0 + half - 2.0 ** -23, 3.0 ** 0.5])
    got = _tf32(a)
    assert got[:5].tolist() == [1.0, one, one, -one, 1.0]
    assert abs(got[5].item() - 3.0 ** 0.5) <= 2.0 ** -11 * 3.0 ** 0.5
    assert (_tf32(got) == got).all()
    cut = _trunc_tf32(a)
    assert cut[:5].tolist() == [1.0, one, 1.0, -1.0, 1.0]
    assert (_trunc_tf32(got) == got).all()


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


# (BC, Q, H, P, N): ragged and small shapes, then mamba2-780m's three
# prefill shapes (prompts of 100, 128 and 512 tokens)
CARD_SHAPES = [(1, 1, 1, 1, 1), (3, 20, 5, 16, 8), (2, 45, 3, 70, 33),
               (1, 128, 2, 128, 128), (1, 100, 48, 64, 128),
               (1, 128, 48, 64, 128), (4, 128, 48, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_ssd_kernel_matches_plain_on_card(cuda, shape, broadcast):
    sc.reset_launches()
    BC, Q, H, P, N = shape
    x, dt, da, b, c = (_t(a).to(cuda) for a in _chunk_operands(
        BC, Q, H, P, N, seed=Q + H, strong=True))
    if broadcast:
        b, c = (t[:, :, :1].contiguous().expand(-1, -1, H, -1)
                for t in (b, c))
    y, st = sc.ssd_intra_chunk(x, dt, da, b, c)
    torch.cuda.synchronize()
    wy, ws = ref.ssd_intra_chunk(x, dt, da, b, c)
    # fp32 sums in another order, expf against torch.exp, and a sequential
    # cumsum against torch's scan (clog reaches hundreds: REL_STRONG)
    for got, want in ((y, wy), (st, ws)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= REL_STRONG * want.abs().max().item()
    assert sc.LAUNCHES == {("ssd_intra_chunk", shape): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("shape", PATH_SHAPES + ZAMBA_SHAPES)
def test_ssd_kernel_every_split_on_card(cuda, shape, broadcast):
    """The plan's split for each b/c layout against the plain version,
    launched twice (no launch leaves state for the next); the launcher
    refuses any other split: the other layout's, or a wrong count of
    strip pairs, parts or Gram column blocks."""
    BC, Q, H, P, N = shape
    x, dt, da, b, c = (_t(a).to(cuda) for a in _chunk_operands(
        BC, Q, H, P, N, seed=Q + BC, strong=True))
    if broadcast:
        b, c = (t[:, :, :1].contiguous().expand(-1, -1, H, -1)
                for t in (b, c))
    strides = [(t.stride(0), t.stride(1), t.stride(2)) for t in (b, c)]
    wy, ws = ref.ssd_intra_chunk(x, dt, da, b, c)
    plan = sc.ssd_plan(BC, Q, H, N, P, broadcast)
    assert plan.groups == (1 if broadcast else H)
    for _ in range(2):
        y, st = sc._launch(x, dt, da, b, c, plan, *strides)
        torch.cuda.synchronize()
        for got, want in ((y, wy), (st, ws)):
            assert torch.isfinite(got).all()
            assert (got - want).abs().max().item() <= \
                REL_STRONG * want.abs().max().item()
    for wrong in (sc.ssd_plan(BC, Q, H, N, P, not broadcast),
                  dataclasses.replace(plan, pairs=plan.pairs + 1),
                  dataclasses.replace(plan, parts=plan.parts - 1),
                  dataclasses.replace(plan, gram_cols=plan.gram_cols + 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            sc._launch(x, dt, da, b, c, wrong, *strides)


@pytest.mark.cuda
def test_ssd_kernel_strong_decay_stays_finite_on_card(cuda):
    """clog_i - clog_j of masked pairs far past expf's overflow (88.7):
    no inf * 0 reaches the outputs."""
    BC, Q, H, P, N = 2, 128, 48, 64, 128
    x, dt, da, b, c = (_t(a).to(cuda) for a in _chunk_operands(
        BC, Q, H, P, N, seed=11, strong=True))
    clog = torch.cumsum(da, dim=1)
    assert (clog[:, :1] - clog[:, -1:]).max().item() > 4 * 88.7
    b, c = (t[:, :, :1].contiguous().expand(-1, -1, H, -1) for t in (b, c))
    y, st = sc.ssd_intra_chunk(x, dt, da, b, c)
    torch.cuda.synchronize()
    wy, ws = ref.ssd_intra_chunk(x, dt, da, b, c)
    for got, want in ((y, wy), (st, ws)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= \
            REL_STRONG * want.abs().max().item()


@pytest.mark.cuda
def test_ssd_kernel_bf16_matches_plain_on_card(cuda):
    ops = [_t(a).to(cuda).bfloat16()
           for a in _chunk_operands(2, 128, 4, 64, 128, seed=1, strong=True)]
    y, st = sc.ssd_intra_chunk(*ops)
    torch.cuda.synchronize()
    wy, ws = ref.ssd_intra_chunk(*ops)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    # the same fp32 sums of exactly cast inputs; y rounds to bf16
    assert (y.float() - wy.float()).abs().max().item() <= \
        1e-2 * wy.float().abs().max().item()
    assert (st - ws).abs().max().item() <= \
        REL_STRONG * ws.abs().max().item()


@pytest.mark.cuda
def test_ssd_kernel_refuses_a_gradient_on_card(cuda):
    """A gradient through the wrapper and ``ssd_chunked`` on the card takes
    the backward kernel and equals the plain version's; a bf16 input that
    requires a gradient is refused (the backward takes fp32 alone)."""
    ops = [_t(a).to(cuda) for a in _chunk_operands(1, 16, 2, 8, 8, seed=2)]
    bf = [t.bfloat16() for t in ops]
    bf[0].requires_grad_(True)
    with pytest.raises(TypeError, match="float32 alone"):
        sc.ssd_intra_chunk(*bf)
    with torch.no_grad():
        sc.ssd_intra_chunk(*bf)
    sc.reset_launches()
    x = ops[0].detach().requires_grad_(True)
    y, st = sc.ssd_intra_chunk(x, *ops[1:])
    (gx,) = torch.autograd.grad((y * y).sum() + st.sum(), x)
    xp = ops[0].detach().requires_grad_(True)
    wy, ws = ref.ssd_intra_chunk(xp, *ops[1:])
    (wx,) = torch.autograd.grad((wy * wy).sum() + ws.sum(), xp)
    assert (gx - wx).abs().max().item() <= REL_STRONG * wx.abs().max().item()
    assert sc.LAUNCHES[("ssd_intra_chunk_bwd", (1, 16, 2, 8, 8))] == 1
    args = (ops[0].reshape(1, 16, 2, 8), ops[1].reshape(1, 16, 2),
            torch.zeros(2, device=cuda), ops[3][:, :, :1], ops[4][:, :, :1],
            torch.ones(2, device=cuda))
    grads = []
    for a in (args, tuple(t.cpu() for t in args)):
        leaves = [t.detach().requires_grad_(True) for t in a]
        y = ssm.ssd_chunked(*leaves, chunk=8)
        grads.append(torch.autograd.grad(y.square().sum(), leaves))
    for got, want in zip(*grads):
        assert (got.cpu() - want).abs().max().item() <= \
            REL_STRONG * want.abs().max().item()
    with pytest.raises(ValueError, match="on"):
        sc.ssd_intra_chunk(x, ops[1].cpu(), *ops[2:])


# (BC, Q, H, P, N): ragged shapes, P past 64 (the wide head tile), and
# mamba2-780m's training shape (batch 16 x 8 chunks of 128 tokens)
BWD_CARD_SHAPES = [(1, 1, 1, 1, 1), (3, 20, 5, 16, 8), (2, 45, 3, 70, 33),
                   (1, 128, 2, 128, 128), (128, 128, 48, 64, 128)]


def _bwd_operands(shape, groups, seed, strong=True):
    """x, dt, da, b, c (per group), dy, dstate as numpy fp32."""
    BC, Q, H, P, N = shape
    x, dt, da, b, c = _chunk_operands(BC, Q, H, P, N, seed, strong)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((BC, Q, H, P)).astype(np.float32)
    ds = rng.standard_normal((BC, H, N, P)).astype(np.float32)
    return x, dt, da, b[:, :, :groups], c[:, :, :groups], dy, ds


def test_ssd_bwd_plan_slices_the_heads_of_a_group():
    """The heads of a group in slices of at most SLICE_HEADS (16), in
    order; at mamba2-780m's training shape 384 heads CTAs (2.9 an SM)."""
    assert sc.ssd_bwd_plan(128, 48, 128, 1)[:2] == (16, 3)
    assert sc.ssd_bwd_plan(1, 6, 8, 2)[:2] == (3, 1)
    assert sc.ssd_bwd_plan(1, 20, 8, 1)[:2] == (16, 2)
    assert sc.ssd_bwd_plan(1, 1, 1, 1)[:2] == (1, 1)
    assert sc.ssd_bwd_plan(128, 48, 128, 1).heads_ctas >= 2 * 132


# (BC, Q, H, P, N, G): the training shape, the card shapes for one group
# and one a head, mid-size G (a slice starting inside a group: H 40, G 2
# gives slices of heads 0-15 and 16-19 in group 0), and the old plan cases
BWD_PLAN_CASES = (
    [(128, 128, 48, 64, 128, 1), (128, 128, 48, 64, 128, 48)]
    + [s + (g,) for s in [(1, 1, 1, 1, 1), (3, 20, 5, 16, 8),
                          (2, 45, 3, 70, 33), (1, 128, 2, 128, 128)]
       for g in (1, s[2])]
    + [(2, 64, 8, 32, 48, 2), (2, 64, 40, 32, 48, 2), (1, 100, 34, 64, 40, 1),
       (1, 32, 48, 16, 16, 1), (1, 16, 6, 8, 8, 2), (1, 16, 20, 8, 8, 1)])


@pytest.mark.parametrize("case", BWD_PLAN_CASES)
def test_ssd_bwd_plan_owns_every_gradient_once(case):
    """Every (bc, head) -- its dx, ddt and dda -- is walked by exactly one
    heads CTA, a slice's heads consecutive, in head order and in its
    group; every (bc, group, n) of db and dc belongs to exactly one group
    CTA; and the eight warps' datt tiles cover every causal (i, j >= i)
    pair exactly once, none above the diagonal, at most 9 a warp (9 each
    at Q = 128)."""
    BC, Q, H, P, N, G = case
    rep = H // G
    plan = sc.ssd_bwd_plan(BC, H, N, G)
    assert plan.heads_per_slice == min(rep, sc.SLICE_HEADS)
    heads = np.zeros((BC, H), np.int64)
    cols = np.zeros((BC, G, N), np.int64)
    starts = set()
    for cta in range(plan.heads_ctas + plan.group_ctas):
        role = sc.ssd_bwd_cta(plan, H, N, G, cta)
        if role[0] == "heads":
            _, bc, grp, hs = role
            assert cta < plan.heads_ctas and 0 < len(hs) <= \
                plan.heads_per_slice
            assert list(hs) == list(range(hs[0], hs[0] + len(hs)))
            assert all(h // rep == grp for h in hs)
            heads[bc, list(hs)] += 1
            starts.add(hs[0] % rep)
        else:
            _, bc, grp, ns = role
            assert cta >= plan.heads_ctas and len(ns) <= sc.GROUP_COLS
            cols[bc, grp, list(ns)] += 1
    assert (heads == 1).all() and (cols == 1).all()
    if rep > sc.SLICE_HEADS:          # a slice that starts inside a group
        assert max(starts) > 0
    cover = np.zeros((Q, Q), np.int64)
    for w in range(sc.BWD_WARPS):
        tiles = sc.ssd_bwd_tiles(Q, w)
        assert len(tiles) <= 9 and (Q < 128 or len(tiles) == 9)
        for i0, j0 in tiles:
            assert i0 < Q and j0 < Q and j0 <= i0 + sc.STRIP - 1
            cover[i0:i0 + sc.STRIP, j0:j0 + 8] += 1
    causal = np.tril(np.ones((Q, Q), np.int64))
    assert ((cover * causal) == causal).all() and cover.max() == 1
    # above the diagonal only inside the diagonal 16 x 16 blocks
    assert all(j // sc.STRIP == i // sc.STRIP
               for i, j in zip(*np.nonzero(cover * (1 - causal))))


def _mm3_chains(a, b, eq, drop_lo_hi=False):
    """The kernel's 3xTF32 product: hi.hi in one fp32 sum, lo.hi + hi.lo
    in another (each exact here, fp64, rounded once), then added."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _trunc_tf32(a - ah), _trunc_tf32(b - bh)

    def f(u, v):
        return torch.einsum(eq, u.double(), v.double())
    cross = f(ah, bl) if drop_lo_hi else f(al, bh) + f(ah, bl)
    return f(ah, bh).float(), cross.float()


def _fma(a, b, c):
    """fmaf: a b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _bwd_emulated(x, dt, da, b, c, dy, dstate, drop_lo_hi=False,
                  leak=False):
    """The backward kernel's arithmetic on the CPU: the fp64 scans of
    clog and dda, every product as 3xTF32 (two fp32 chains), the head dim
    in 64-column passes, D and E summed over heads in head order (fmaf)
    and over slices in slice order, dx as w (B dS) carried into attᵀ dY's
    hi.hi sum, the row sums of M by column-block parity, the column sums
    of K and M by 16-row strip, dw as Σ_n B (X dSᵀ).  ``drop_lo_hi`` and
    ``leak`` plant faults: the lo.hi term dropped; the tile (i 0..15, j
    8..15), above the diagonal, let in unmasked."""
    BC, Q, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep, S = H // G, -(-Q // sc.STRIP)
    plan = sc.ssd_bwd_plan(BC, H, N, G)
    mm = functools.partial(_mm3_chains, drop_lo_hi=drop_lo_hi)
    clog = _warp_cumsum(da)                                  # (BC, Q, H)
    e = torch.exp(clog[:, -1:] - clog)
    w = e * dt
    bh, ch = (t.repeat_interleave(rep, dim=2) for t in (b, c))
    hh, cr = mm(ch, bh, "bihn,bjhn->bhij")
    s = hh + cr                                              # (BC,H,Q,Q)
    cl = clog.permute(0, 2, 1)                               # (BC,H,Q)
    diff = cl[..., :, None] - cl[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool).tril()
    if leak:
        keep = keep.clone()
        keep[:16, 8:16] = True
    L = torch.exp(diff.masked_fill(~keep, float("-inf")))
    dtj = dt.permute(0, 2, 1)[..., None, :]                  # (BC,H,1,Q)
    wj = w.permute(0, 2, 1)                                  # (BC,H,Q)
    sl = s * L
    att = sl * dtj
    dx = torch.empty_like(x)
    dl, fs = [], []                   # per pass: datt ⊙ L and X dSᵀ
    rows = torch.zeros((2, BC, H, Q))
    colk = torch.zeros((BC, H, S, Q))
    colm = torch.zeros((BC, H, S, Q))
    dw = torch.zeros((BC, H, Q))
    par = (torch.arange(Q) // 8) % 2
    for p0 in range(0, P, 64):
        cs = slice(p0, min(p0 + 64, P))
        hh, cr = mm(dy[..., cs], x[..., cs], "bihp,bjhp->bhij")
        datt = hh + cr
        K = datt * sl
        M = K * dtj
        dl.append(datt * L)
        for q in (0, 1):
            rows[q] += (M * (par == q)).sum(-1)
        pad = S * sc.STRIP - Q
        colk += torch.nn.functional.pad(K, (0, 0, 0, pad)).reshape(
            BC, H, S, sc.STRIP, Q).sum(3)
        colm += torch.nn.functional.pad(M, (0, 0, 0, pad)).reshape(
            BC, H, S, sc.STRIP, Q).sum(3)
        hh, cr = mm(x[..., cs], dstate[..., cs], "bjhp,bhnp->bhjn")
        F = hh + cr
        fs.append(F)
        dw += (bh.permute(0, 2, 1, 3) * F).sum(-1)
        hh, cr = mm(bh, dstate[..., cs], "bjhn,bhnp->bjhp")
        wu = w[..., None] * (hh + cr)
        hh, cr = mm(att, dy[..., cs], "bhij,bihp->bjhp")
        dx[..., cs] = (wu.double() + hh.double()).float() + cr
    colK = torch.zeros((BC, H, Q))
    colM = torch.zeros((BC, H, Q))
    for si in range(S):               # strips j // 16 .. S - 1, in order
        on = torch.arange(Q) // sc.STRIP <= si
        colK = torch.where(on, colK + colk[:, :, si], colK)
        colM = torch.where(on, colM + colm[:, :, si], colM)
    ew = e.permute(0, 2, 1)
    ddt = _fma(dw, ew, colK)
    dcl = rows[0] + rows[1] - colM - dw * wj
    dcl[..., -1] += (dw * wj).sum(-1)
    dda = _warp_cumsum(dcl.flip(-1).permute(0, 2, 1)).flip(1)
    # D and E: fmaf over a slice's heads in order (each head's passes in
    # order), then the slices summed in order
    Dg = torch.zeros((BC, G, Q, Q))
    Eg = torch.zeros((BC, G, Q, N))
    for grp in range(G):
        for s0 in range(0, rep, plan.heads_per_slice):
            dpart = torch.zeros((BC, Q, Q))
            epart = torch.zeros((BC, Q, N))
            for h in range(grp * rep + s0,
                           grp * rep + min(s0 + plan.heads_per_slice, rep)):
                for t, F in zip(dl, fs):
                    dpart = _fma(t[:, h], dtj[:, h].expand(BC, Q, Q), dpart)
                    epart = _fma(wj[:, h, :, None].expand(BC, Q, N), F[:, h],
                                 epart)
            Dg[:, grp] += dpart
            Eg[:, grp] += epart
    hh, cr = mm(Dg, b, "bgij,bjgn->bign")
    dc = hh + cr
    hh, cr = mm(Dg, c, "bgij,bign->bjgn")
    db = (hh + cr) + Eg.permute(0, 2, 1, 3)
    return dx, ddt.permute(0, 2, 1), dda, db, dc


def _bwd_cpu_operands(shape, groups, seed):
    return [_t(a) for a in _bwd_operands(shape, groups, seed)]


# (BC, Q, H, P, N, G): ragged shapes (two head-dim passes at P 70),
# several slices of a group, and mamba2-780m's training shape reduced to
# BC 2 and H 8
BWD_EMU_CASES = [(3, 20, 5, 16, 8, 1), (2, 45, 3, 70, 33, 3),
                 (1, 100, 34, 64, 40, 2), (2, 128, 8, 64, 128, 1)]


@pytest.mark.parametrize("case", BWD_EMU_CASES)
def test_bwd_3xtf32_emulation_keeps_fp32_accuracy(case):
    """The backward kernel's arithmetic, emulated, against the plain
    version within REL of each gradient's largest magnitude (measured on
    the CPU: at most 6e-7), with a decay whose masked differences pass
    expf's range (every gradient finite); and against a float64 run no
    farther than the plain fp32 version is, within a quarter and REL / 10:
    fp32's own clog steps put the plain version itself 1.0e-5 of max|dda|
    off float64 at the reduced training shape (measured), so REL alone
    cannot be the float64 limit there."""
    *shape, G = case
    ops = _bwd_cpu_operands(tuple(shape), G, seed=sum(case))
    clog = torch.cumsum(ops[2], dim=1)
    assert (clog[:, :1] - clog[:, -1:]).max() > 88.7
    got = _bwd_emulated(*ops)
    want = ref.ssd_intra_chunk_bwd(*ops)
    with float64_plain_path():
        f64 = ref.ssd_intra_chunk_bwd(*(t.double() for t in ops))
    for g, w, d in zip(got, want, f64):
        assert d.dtype == torch.float64
        _close(g, w, REL)
        top = d.abs().max().item()
        plain_err = (w.double() - d).abs().max().item()
        assert (g.double() - d).abs().max().item() <= \
            1.25 * plain_err + REL / 10 * top


@pytest.mark.parametrize("fault", ["drop_lo_hi", "leak"])
def test_bwd_emulation_catches_planted_faults(fault):
    """Dropping the lo.hi term of the split, or letting a tile above the
    diagonal in, moves some gradient past REL (or makes it non-finite)."""
    ops = _bwd_cpu_operands((2, 128, 8, 64, 128), 1, seed=7)
    want = ref.ssd_intra_chunk_bwd(*ops)
    got = _bwd_emulated(*ops, **{fault: True})
    worst = max(
        float("inf") if not torch.isfinite(g).all() else
        ((g - w).abs().max() / w.abs().max()).item()
        for g, w in zip(got, want))
    assert worst > REL, (fault, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("shape", BWD_CARD_SHAPES)
def test_ssd_bwd_kernel_matches_plain_on_card(cuda, shape, per_head):
    """Every gradient within 1e-4 of its largest magnitude (fp32 sums in
    another order, expf against torch.exp, and clog up to hundreds as in
    the forward's REL_STRONG); three launches bit-identical."""
    H = shape[2]
    ops = [_t(a).to(cuda) for a in _bwd_operands(
        shape, H if per_head else 1, seed=sum(shape))]
    sc.reset_launches()
    runs = [sc.ssd_intra_chunk_bwd(*ops) for _ in range(3)]
    torch.cuda.synchronize()
    want = ref.ssd_intra_chunk_bwd(*ops)
    for name, got, w in zip(("dx", "ddt", "dda", "db", "dc"), runs[0], want):
        assert got.shape == w.shape and torch.isfinite(got).all(), name
        err = (got - w).abs().max().item()
        assert err <= REL_STRONG * w.abs().max().item(), (name, err)
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(a, b)
    assert sc.LAUNCHES == {("ssd_intra_chunk_bwd", shape): 3}


@pytest.mark.cuda
def test_ssd_bwd_kernel_strong_decay_stays_finite_on_card(cuda):
    """Masked differences far past expf's overflow: every gradient finite
    and equal to the plain version's (which forms no inf either)."""
    shape = (2, 128, 48, 64, 128)
    ops = [_t(a).to(cuda) for a in _bwd_operands(shape, 1, seed=11)]
    clog = torch.cumsum(ops[2], dim=1)
    assert (clog[:, :1] - clog[:, -1:]).max().item() > 4 * 88.7
    got = sc.ssd_intra_chunk_bwd(*ops)
    torch.cuda.synchronize()
    want = ref.ssd_intra_chunk_bwd(*ops)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        assert (g - w).abs().max().item() <= \
            REL_STRONG * w.abs().max().item()


@pytest.mark.cuda
def test_ssd_bwd_kernel_refuses_another_split_on_card(cuda):
    """The launcher takes ssd_bwd_plan's split alone: another slice width
    or slice count is refused before anything runs."""
    shape, G = (2, 64, 40, 32, 48), 2
    ops = [_t(a).to(cuda) for a in _bwd_operands(shape, G, seed=5)]
    want = sc.ssd_intra_chunk_bwd(*ops)
    BC, Q, H, P, N = shape
    plan = sc.ssd_bwd_plan(BC, H, N, G)
    outs = [torch.empty_like(t) for t in want]
    sc._bwd_launch(ops, outs, plan)
    torch.cuda.synchronize()
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    for wrong in (plan._replace(heads_per_slice=plan.heads_per_slice - 1),
                  plan._replace(heads_per_slice=plan.heads_per_slice + 1),
                  plan._replace(slices=plan.slices + 1),
                  sc.ssd_bwd_plan(BC, H, N, 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            sc._bwd_launch(ops, outs, wrong)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 8, 32, 48), (2, 64, 40, 32, 48),
                                   (3, 100, 34, 64, 40)])
def test_ssd_bwd_kernel_mid_groups_on_card(cuda, shape):
    """Two B/C groups, slices that start inside a group (H 40: heads 16-19
    of group 0 and 36-39 of group 1 form slices of their own; H 34: 17
    heads a group), every gradient within REL_STRONG of the plain
    version, repeats bit-identical."""
    ops = [_t(a).to(cuda) for a in _bwd_operands(shape, 2, seed=sum(shape))]
    runs = [sc.ssd_intra_chunk_bwd(*ops) for _ in range(2)]
    torch.cuda.synchronize()
    want = ref.ssd_intra_chunk_bwd(*ops)
    for name, got, w in zip(("dx", "ddt", "dda", "db", "dc"), runs[0], want):
        assert torch.isfinite(got).all(), name
        err = (got - w).abs().max().item()
        assert err <= REL_STRONG * w.abs().max().item(), (name, err)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The bounds-checked build (kernels/_build.py CHECKED)
# ---------------------------------------------------------------------------

def test_checked_build_is_a_library_of_its_own():
    from repro_torch.kernels import _build
    plain = _build.library_path("ssd_chunk")
    checked = _build.library_path("ssd_chunk", _build.CHECKED)
    assert plain != checked and ".lrk_checked." in checked.name
    assert "-DLRK_CHECKED" in _build.flags(_build.CHECKED)
    assert _build.flags() == _build.NVCC_FLAGS
    # the checked build is a launch on the card: a CPU tensor is refused
    ops = [_t(a) for a in _bwd_operands((1, 4, 1, 2, 2), 1, seed=0)]
    with pytest.raises(ValueError, match="checked build"):
        sc.ssd_intra_chunk(*ops[:5], checked=True)
    with pytest.raises(ValueError, match="checked build"):
        sc.ssd_intra_chunk_bwd(*ops, checked=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_CARD_SHAPES + [(1, 100, 48, 64, 128)])
def test_ssd_checked_build_equals_unchecked_on_card(cuda, shape):
    """The checked build (every shared-memory and global index asserted;
    a printf and a trap on the first outside its array) traps on no index
    at the ragged shapes and the training shape, and its outputs equal the
    unchecked build's bit for bit: the forward with one group broadcast
    over the heads and with a group per head, the backward with one
    group and with one per head."""
    BC, Q, H, P, N = shape
    x, dt, da, b, c, dy, ds = (_t(a).to(cuda) for a in _bwd_operands(
        shape, H, seed=sum(shape) + 7))
    one = [t[:, :, :1].contiguous() for t in (b, c)]
    for bb, cc in ((b, c), tuple(t.expand(-1, -1, H, -1) for t in one)):
        runs = [sc.ssd_intra_chunk(x, dt, da, bb, cc, checked=chk)
                for chk in (False, True)]
        torch.cuda.synchronize()
        for a, w in zip(*runs):
            assert torch.equal(a, w)
    for bb, cc in ((b, c), one):
        runs = [sc.ssd_intra_chunk_bwd(x, dt, da, bb, cc, dy, ds,
                                       checked=chk) for chk in (False, True)]
        torch.cuda.synchronize()
        for a, w in zip(*runs):
            assert torch.isfinite(a).all() and torch.equal(a, w)
