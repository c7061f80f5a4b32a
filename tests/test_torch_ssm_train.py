"""SSM training in the port (mamba2) against the JAX package, on the CPU.

* ``ref.ssd_intra_chunk_bwd`` (the backward's plain version, what the
  CUDA kernel is held to on the card) against ``jax.vjp`` of
  ``repro.kernels.ref.ssd_intra_chunk`` vmapped over the chunks, with b
  and c one group and two, and against torch autograd of the port's
  plain forward.
* The gradients of ``ssd_chunked`` (several chunks, ``init_state``, one
  group and two) and of ``mamba2_mixer`` (through ``LRPack``s, as
  training packs in_proj and out_proj) against ``jax.grad`` of the
  reference's.
* The deliberate departure: at Q = 128 with a decay whose masked
  differences pass ``exp``'s range, the port's gradients are finite and
  equal a float64 evaluation of the same formulas, where ``jax.grad`` of
  the reference's ``ssd_chunked`` is NaN.
* The gate: the port's ``Trainer`` on ``mamba2-780m.reduced()`` against
  the JAX ``Trainer`` over two outer cycles (``lowrank_adam``, rank 16,
  ``min_dim_for_lowrank`` 32, batch 8 x 64: the reference's
  ``test_ssm_reduced_arch_trains``), the reference's V injected after
  each merge; a planted fault in the backward must fail it.  At these
  settings the reference's own gradient is NaN at step 5 (a masked decay
  difference passes exp's range; its guard skips the step): the port is
  held to it up to that step, and at every step to the reference run
  with its ``_segsum_decay`` made overflow-free for the run (a monkeypatch
  in the test; the package is not changed), which then matches.
* A mamba2 training checkpoint crosses to and from the reference's
  format.

Tolerances, fp32 against fp32 with sums in other orders: gradients
within ``REL`` = 1e-5 of each one's largest magnitude (``dda``, a
reverse cumsum of terms that cancel, and ``a_log``'s, a sum of it, within
``REL_DA`` = 1e-4); the strong-decay case against float64 within
``REL_STRONG`` = 1e-4 (clog reaches 203, where one fp32 step is 1.5e-5;
measured at most 1.8e-6, and ``a_log``'s 8e-6 of the magnitudes its
terms sum).
The gate's limit is set against a float64 run of the port's plain path
(see :data:`GATE_REL`).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import StatelessLoader as JLoader  # noqa: E402
from repro.kernels import ref as jkref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.linear import LRPack as JLRPack  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.linear import LRPack  # noqa: E402
from repro_torch.optim import subspace  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_parity import (SAVED, assert_float64,  # noqa: E402
                           assert_reference_restores, assert_same_format,
                           float64_plain_path, overflow_free_decay, widened)

REL = 1e-5
REL_DA = 1e-4
REL_STRONG = 1e-4
ARCH = "mamba2-780m"
CFG, JCFG = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
KW = dict(optimizer="lowrank_adam", sampler="stiefel", rank=16, lazy_k=3,
          lr=5e-3, warmup_steps=0, total_steps=100, min_dim_for_lowrank=32,
          weight_decay=0.0, schedule="constant", seed=0)
TCFG, JTCFG = TrainConfig(**KW), JTrainConfig(**KW)
BATCH = dict(batch=8, seq_len=64, vocab=CFG.vocab_size)
STEPS = 7           # two merges (lazy_k 3), then one inner step


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _chunks(bc, q, h, p, n, g, seed):
    """x, dt, da, b, c (per group), dy, dstate as numpy fp32, with dt and
    da in mamba2's ranges at the mild end (no masked overflow)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((bc, q, h, p)).astype(f)
    dt = (np.abs(0.3 * rng.standard_normal((bc, q, h))) + 0.01).astype(f)
    da = (dt * -rng.uniform(0.5, 2.0, h)).astype(f)
    b = (0.5 * rng.standard_normal((bc, q, g, n))).astype(f)
    c = (0.5 * rng.standard_normal((bc, q, g, n))).astype(f)
    dy = rng.standard_normal((bc, q, h, p)).astype(f)
    ds = rng.standard_normal((bc, h, n, p)).astype(f)
    return x, dt, da, b, c, dy, ds


def _jax_intra_vjp(x, dt, da, b, c, dy, ds):
    rep = x.shape[2] // b.shape[2]

    def f(x, dt, da, b, c):
        return jax.vmap(jkref.ssd_intra_chunk)(
            x, dt, da, jnp.repeat(b, rep, axis=2), jnp.repeat(c, rep, axis=2))
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, da, b, c)))
    return vjp((jnp.asarray(dy), jnp.asarray(ds)))


NAMES = ("dx", "ddt", "dda", "db", "dc")


def _tol(name):
    return REL_DA if name in ("dda", "a_log") else REL


# (BC, Q, H, P, N, G)
BWD_CASES = [(3, 16, 4, 8, 8, 1), (2, 32, 4, 16, 16, 2), (2, 20, 6, 8, 4, 3)]


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_bwd_matches_jax_vjp(case):
    ops = _chunks(*case, seed=sum(case))
    got = kref.ssd_intra_chunk_bwd(*(_t(a) for a in ops))
    want = _jax_intra_vjp(*ops)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _close(g, w, _tol(name))


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_bwd_matches_torch_autograd(case):
    x, dt, da, b, c, dy, ds = (_t(a) for a in _chunks(*case, seed=7))
    rep = x.shape[2] // b.shape[2]
    leaves = [t.requires_grad_(True) for t in (x, dt, da, b, c)]
    y, st = kref.ssd_intra_chunk(*leaves[:3],
                                 *(t.repeat_interleave(rep, 2)
                                   for t in leaves[3:]))
    want = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), leaves)
    got = kref.ssd_intra_chunk_bwd(*(t.detach() for t in leaves), dy, ds)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, _tol(name))


def test_function_takes_the_plain_backward_on_the_cpu():
    """The autograd Function on CPU tensors: its gradients are the plain
    backward's, db and dc per group; it counts no launch."""
    x, dt, da, b, c, dy, ds = (_t(a) for a in _chunks(2, 16, 4, 8, 8, 2, 3))
    sc.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, da, b, c)]
    y, st = sc.ssd_intra_chunk_grouped(*leaves)
    got = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), leaves)
    want = kref.ssd_intra_chunk_bwd(x, dt, da, b, c, dy, ds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not sc.LAUNCHES
    with pytest.raises(TypeError, match="float32 alone"):
        sc.ssd_intra_chunk_grouped(*(t.bfloat16().requires_grad_(True)
                                     for t in (x, dt, da, b, c)))
    with pytest.raises(ValueError, match="do not divide"):
        sc.ssd_intra_chunk_grouped(x, dt, da, b[:, :, :1].expand(
            -1, -1, 3, -1), c[:, :, :1].expand(-1, -1, 3, -1))


# (s, h, g, n, chunk): tests/test_torch_ssd.py's recurrence sweep
SCAN_CASES = [(32, 4, 1, 8, 8), (64, 4, 2, 8, 16), (48, 2, 1, 4, 16)]
SCAN_ARGS = ("x", "dt", "a_log", "b", "c", "d_skip", "init")


def _scan_operands(s, h, g, n, seed, with_init):
    rng = np.random.default_rng(seed)
    B, P = 2, 8
    f = np.float32
    ops = [rng.standard_normal((B, s, h, P)).astype(f),
           _softplus(rng.standard_normal((B, s, h))),
           (0.5 * rng.standard_normal((h,))).astype(f),
           (0.5 * rng.standard_normal((B, s, g, n))).astype(f),
           (0.5 * rng.standard_normal((B, s, g, n))).astype(f),
           rng.standard_normal((h,)).astype(f)]
    if with_init:
        ops.append((0.3 * rng.standard_normal((B, h, n, P))).astype(f))
    cot = (rng.standard_normal((B, s, h, P)).astype(f),
           rng.standard_normal((B, h, n, P)).astype(f))
    return ops, cot


def _jax_scan_grad(ops, cot, chunk):
    def loss(*a):
        y, st = jssm.ssd_chunked(*a[:6], chunk=chunk,
                                 init_state=a[6] if len(a) > 6 else None,
                                 return_state=True)
        return (y * cot[0]).sum() + (st * cot[1]).sum()
    return jax.grad(loss, argnums=tuple(range(len(ops))))(
        *(jnp.asarray(a) for a in ops))


def _port_scan_grad(ops, cot, chunk, dtype=torch.float32):
    leaves = [_t(a).to(dtype).requires_grad_(True) for a in ops]
    y, st = ssm.ssd_chunked(*leaves[:6], chunk=chunk,
                            init_state=leaves[6] if len(ops) > 6 else None,
                            return_state=True)
    loss = (y * _t(cot[0]).to(dtype)).sum() + \
        (st * _t(cot[1]).to(dtype)).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,h,g,n,chunk", SCAN_CASES)
def test_ssd_chunked_grad_matches_jax(s, h, g, n, chunk, with_init):
    ops, cot = _scan_operands(s, h, g, n, s + h + g, with_init)
    want = _jax_scan_grad(ops, cot, chunk)
    got = _port_scan_grad(ops, cot, chunk)
    for name, gr, w in zip(SCAN_ARGS, got, want):
        _close(gr, w, _tol(name))


def _mixer_params(seed=0, r=4):
    """One reduced mamba2 layer with in_proj and out_proj packed with
    random adapters, as numpy (w, b, v) triples and arrays."""
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jlm.init_params(JCFG, jax.random.key(seed))
                      ["layers"]["ssm"])
    rng = np.random.default_rng(seed)
    for name in ("in_proj", "out_proj"):
        k, n = jp[name].shape
        jp[name] = (jp[name], (0.05 * rng.standard_normal((n, r)))
                    .astype(np.float32),
                    (rng.standard_normal((k, r)) / np.sqrt(k))
                    .astype(np.float32))
    return jp


def test_mamba2_mixer_grad_matches_jax():
    """Gradients of h, both adapters' B and the mixer's dense leaves, over
    two chunks of 32."""
    jp = _mixer_params()
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 64, CFG.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 64, CFG.d_model)).astype(np.float32)

    def jloss(h, p):
        packed = {k: JLRPack(*v) if isinstance(v, tuple) else v
                  for k, v in p.items()}
        return (jssm.mamba2_mixer(h, packed, JCFG)[0] * cot).sum()
    jparams = {k: tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
               else jnp.asarray(v) for k, v in jp.items()}
    wh, wp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jparams)

    th = _t(h).requires_grad_(True)
    tp, leaves, names = {}, [th], ["h"]
    for k, v in jp.items():
        if isinstance(v, tuple):
            w, b, vv = (_t(a) for a in v)
            b.requires_grad_(True)
            tp[k] = LRPack(w, b, vv)
            leaves.append(b)
            names.append(k)
        else:
            tp[k] = _t(v).requires_grad_(True)
            leaves.append(tp[k])
            names.append(k)
    out = ssm.mamba2_mixer(th, tp, CFG)[0]
    got = torch.autograd.grad((out * _t(cot)).sum(), leaves)
    for name, g in zip(names, got):
        w = wh if name == "h" else wp[name]
        if isinstance(w, tuple):
            w = w[1]                    # the adapter's B
        _close(g, w, _tol(name))


def test_strong_decay_gradient_is_finite_where_the_reference_is_nan():
    """One head, dt = 0.1 and A = -16 over a chunk of 128 tokens: clog
    falls by 1.6 a token, so a masked pair's difference reaches 203, past
    exp's range.  ``jax.grad`` of the reference's ``ssd_chunked`` is NaN
    there (0 · inf in its ``where``); the port's gradients are finite and
    equal those of a float64 run of the same masked formulas."""
    rng = np.random.default_rng(3)
    B, S, H, P, G, N = 1, 128, 1, 16, 1, 16
    f = np.float32
    ops = [rng.standard_normal((B, S, H, P)).astype(f),
           np.full((B, S, H), 0.1, f),
           np.full((H,), np.log(16.0), f),
           (0.5 * rng.standard_normal((B, S, G, N))).astype(f),
           (0.5 * rng.standard_normal((B, S, G, N))).astype(f),
           np.ones((H,), f)]
    cot = (rng.standard_normal((B, S, H, P)).astype(f),
           rng.standard_normal((B, H, N, P)).astype(f))
    want_nan = _jax_scan_grad(ops, cot, 128)
    assert not all(np.isfinite(np.asarray(g)).all() for g in want_nan)
    got = _port_scan_grad(ops, cot, 128)
    with float64_plain_path(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sc, "DTYPE_CODE", {**sc.DTYPE_CODE, torch.float64: -1})
        mp.setattr(sc, "_require_fp32", lambda *ts: None)
        f64 = _port_scan_grad(ops, cot, 128, torch.float64)
        # a_log's gradient is Σ_t dda_t da_t over the one chunk, whose
        # terms cancel (their magnitudes sum to 15x the result): it is held
        # within REL_STRONG of that sum of magnitudes
        x, dt, a_log, b, c, _ = (_t(a).double() for a in ops)
        da = dt * -torch.exp(a_log)
        dda = kref.ssd_intra_chunk_bwd(x, dt, da, b, c, _t(cot[0]).double(),
                                       _t(cot[1]).double())[2]
        a_log_scale = (dda * da).abs().sum().item()
    for name, g, w in zip(SCAN_ARGS, got, f64):
        assert w.dtype == torch.float64
        assert torch.isfinite(g).all(), name
        if name == "a_log":
            assert (g - w).abs().max().item() <= REL_STRONG * a_log_scale
        else:
            _close(g, w, REL_STRONG)


# ---------------------------------------------------------------------------
# The gate: the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

# Per-step relative loss gap allowed between any two of the port, the JAX
# Trainer and a float64 run of the port's plain path.  Measured on an
# 8-core host: the port against the reference at most 2.1e-7 with XLA
# threaded and 1.1e-6 single-threaded; each fp32 run against float64 at
# most 3.2e-6 (fp32 sums in other orders, no fault).  The limit is 5x the
# larger; the planted fault below is 3.2e-4 off from the second step.
GATE_REL = 1.6e-5
SKIPPED = [5]       # the stock reference's NaN step (see below)


def _jax_run(segsum_decay=None):
    """Seven steps of the JAX Trainer: its start, losses, each step's V
    draws (the ones after a merge are injected into the port) and the
    steps its guard skipped.  ``segsum_decay`` replaces the reference's
    ``_segsum_decay`` for the run (its module attribute, restored after)."""
    with pytest.MonkeyPatch.context() as mp:
        if segsum_decay is not None:
            mp.setattr(jssm, "_segsum_decay", segsum_decay)
        jt = JTrainer(JCFG, JTCFG, JLoader("lm", 0, **BATCH))
        start = (_np(jsub.params_of(jt.params)), _np(jt.opt_state.groups),
                 _np(jt.opt_state.dense))
        losses, projs, skipped = [], [], []
        for s in range(STEPS):
            rep = jt.run(1)
            losses += rep.losses
            skipped += [s] * rep.skipped_steps
            projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])
    return start, np.array(losses, np.float64), projs, skipped


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


@pytest.fixture(scope="module")
def jax_run_safe():
    return _jax_run(overflow_free_decay)


def _port_run(jax_run, f64=False):
    """The same steps of the port's Trainer from the reference's start,
    its V draws injected; under ``f64`` the state widened and the plain
    path in float64 (the SSD wrapper let through float64)."""
    (params0, groups0, dense0), _, projs, _ = jax_run
    jloader = JLoader("lm", 0, **BATCH)
    tr = Trainer(CFG, TCFG,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, TCFG, groups=groups0, dense=dense0, device="cpu")
    if f64:
        tr.params, tr.opt_state = widened(tr.params, tr.opt_state)
    queue, losses, outer = [], [], 0
    with pytest.MonkeyPatch.context() as mp, \
            float64_plain_path() if f64 else contextlib.nullcontext():
        mp.setattr(subspace, "_sample_proj_group",
                   lambda name, gen, spec, n, c, dtype, device,
                   energy=None: _t(queue.pop(0)).to(device, dtype))
        if f64:
            mp.setattr(sc, "DTYPE_CODE", {**sc.DTYPE_CODE,
                                          torch.float64: -1})
            mp.setattr(sc, "_require_fp32", lambda *ts: None)
        for s in range(STEPS):
            if tr.outer_due():
                queue[:] = projs[s]
            rep = tr.run(1)
            losses += rep.losses
            outer += rep.outer_steps
            assert not queue and not rep.skipped_steps
    if f64:
        assert_float64(tr.params, tr.opt_state)
    assert outer == 2 and int(tr.opt_state.outer_step) == 2
    return np.array(losses, np.float64)


def _gate(losses, jlosses, f64):
    """The port, the JAX Trainer and the float64 run pairwise within
    GATE_REL at every step."""
    assert np.isfinite(losses).all()
    for a, b in ((losses, jlosses), (losses, f64), (jlosses, f64)):
        assert (np.abs(a - b) <= GATE_REL * np.abs(b)).all(), \
            np.abs(a - b).max()


@pytest.fixture(scope="module")
def f64_losses(jax_run_safe):
    return _port_run(jax_run_safe, f64=True)


def test_trainer_tracks_the_jax_trainer_over_two_outer_cycles(
        jax_run, jax_run_safe, f64_losses):
    """Against the reference with its decay made overflow-free, every
    step.  Against the stock reference, every step up to its first NaN
    gradient: at step 5 a masked difference passes exp's range, its
    gradient is NaN (0 · inf) and its guard skips the update, where the
    port's stays finite (the deliberate departure); its losses up to that
    step are the same run's."""
    losses = _port_run(jax_run_safe)
    _gate(losses, jax_run_safe[1], f64_losses)
    assert losses[-1] < losses[0]
    for a, b in zip(jax_run[2], jax_run_safe[2]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert jax_run_safe[3] == [] and jax_run[3] == SKIPPED
    upto = SKIPPED[0] + 1
    _gate(losses[:upto], jax_run[1][:upto], f64_losses[:upto])


def test_a_planted_fault_in_the_backward_fails_the_gate(jax_run_safe,
                                                        f64_losses,
                                                        monkeypatch):
    """db without its end-state term ``Σ_h w_h ⊙ (X_h dS_hᵀ)`` (the
    gradient that reaches B through the chunk's local end state): the
    gate must catch it."""
    bwd = kref.ssd_intra_chunk_bwd

    def faulty(x, dt, da, b, c, dy, dstate):
        dx, ddt, dda, db, dc = bwd(x, dt, da, b, c, dy, dstate)
        state_term = bwd(x, dt, da, b, c, torch.zeros_like(dy), dstate)[3]
        return dx, ddt, dda, db - state_term, dc
    monkeypatch.setattr(kref, "ssd_intra_chunk_bwd", faulty)
    losses = _port_run(jax_run_safe)
    with pytest.raises(AssertionError):
        _gate(losses, jax_run_safe[1], f64_losses)


# ---------------------------------------------------------------------------
# Checkpoints cross both ways
# ---------------------------------------------------------------------------

CKPT_KW = dict(KW, lazy_k=4)


def test_mamba2_checkpoint_crosses_to_and_from_the_reference(tmp_path):
    """A JAX mamba2 Trainer's checkpoint restores in the port and is
    written back record for record; the port's restores through the
    reference unquarantined, byte for byte."""
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    loader = JLoader("lm", 0, batch=2, seq_len=64, vocab=CFG.vocab_size)
    jt = JTrainer(JCFG, JTrainConfig(**CKPT_KW), loader, workdir=jwd,
                  checkpoint_every=SAVED)
    jt.run(SAVED)

    def port_loader(s):
        return {k: _t(v) for k, v in loader(s).items()}
    Trainer(CFG, TrainConfig(**CKPT_KW), port_loader, pwd,
            checkpoint_every=SAVED, device="cpu").run(SAVED)
    tr = Trainer(CFG, TrainConfig(**CKPT_KW), port_loader, jwd,
                 device="cpu")
    assert tr.maybe_resume() == SAVED
    out = str(tmp_path / "again")
    ckpt.save(out, SAVED, tr._template())
    assert_same_format(jwd, out)
    assert_reference_restores(pwd, {"params": jt.params,
                                     "opt": jt.opt_state}, "lowrank_adam")
