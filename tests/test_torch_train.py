"""The port's training path (``lowrank_adam``, Algorithm 1) against the
JAX package, on llama-tiny in fp32.

Parameters, projections ``V``, subspace state and batches come from the
reference and are carried across as numpy arrays
(``repro_torch.convert``): threefry and torch's generators cannot agree
bit for bit, so after each outer merge the reference's own ``V`` draw is
injected into the port.  Tolerances, all fp32 with sums taken in
another order:

* loss values: 1e-5 relative;
* one inner step (B, m, v, dense leaves and their moments): 1e-4 of each
  buffer's largest magnitude — Adam divides by ``sqrt(v)``, which lifts
  the gradient's last-bit differences;
* the outer merge: merged weights within 1e-5 of their largest
  magnitude, ``V`` equal to the injected draw, ``B`` and the moments
  zero;
* the gate, seven steps over two outer cycles (``lazy_k`` = 3): every
  per-step loss within 1e-5 relative of the reference ``Trainer``'s
  (under bf16 masters and int8 Adam state, 1e-5 up to the first merge
  and then, over five seeds, the port, the reference and a float64 run
  of the port's plain path pairwise within 1e-3, and the port's W no
  farther from float64's rounds than the reference's; see
  ``test_compressed_trainers_track_the_jax_trainer_over_two_outer_cycles``).

The samplers and the data stream are held to the reference by law.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import StatelessLoader as JLoader  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert, methods  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import samplers  # noqa: E402
from repro_torch.data.synthetic import StatelessLoader, lm_batch  # noqa
from repro_torch.models.linear import LRPack  # noqa: E402
from repro_torch.optim import adamw, quant, schedule, subspace  # noqa
from repro_torch.train import loss as tloss  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_parity import (assert_float64, bf16_steps_close,  # noqa
                           float64_plain_path, quant_close, widened)

CFG, JCFG = get_config("llama-tiny"), jget_config("llama-tiny")
KW = dict(lazy_k=3, warmup_steps=2, total_steps=7, lr=3e-3, seed=0)
TCFG, JTCFG = TrainConfig(**KW), JTrainConfig(**KW)
BATCH = dict(batch=2, seq_len=64, vocab=CFG.vocab_size)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def start():
    """A reference training state mid-run: params from the reference
    init, random B and moments (so one step moves everything), step 2;
    and the same state in the port."""
    key = jax.random.key(5)
    jparams = jlm.init_params(JCFG, key)
    jgp, jst = jsub.init_grouped(jparams, JTCFG, jax.random.key(6))
    rng = np.random.default_rng(7)

    def rnd(shape, scale, positive=False):
        a = scale * rng.standard_normal(shape)
        return (np.abs(a) if positive else a).astype(np.float32)

    groups = tuple(s._replace(b=rnd(s.b.shape, 0.02),
                              m=rnd(s.m.shape, 1e-3),
                              v=rnd(s.v.shape, 1e-6, positive=True))
                   for s in jst.groups)
    dense = tuple(d._replace(m=rnd(d.m.shape, 1e-3),
                             v=rnd(d.v.shape, 1e-6, positive=True))
                  for d in jst.dense)
    jst = dataclasses.replace(jst, groups=jax.tree.map(jax.numpy.asarray,
                                                       groups),
                              dense=jax.tree.map(jax.numpy.asarray, dense),
                              step=jax.numpy.asarray(2, jax.numpy.int32))
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(jgp)), TCFG, groups=_np(jst.groups),
        dense=_np(jst.dense), step=2, device="cpu")
    jbatch = jlm_batch(0, 3, **BATCH)
    batch = {k: _t(v) for k, v in jbatch.items()}
    return dict(jgp=jgp, jst=jst, gp=gp, st=st, jbatch=jbatch, batch=batch)


def test_layout_and_state_carry_across(start):
    jst, st = start["jst"], start["st"]
    assert [tuple(g.shape) for g in start["gp"].groups] == \
        [tuple(g.shape) for g in start["jgp"].groups]
    assert [(s.shape, s.rank, s.leaf_idx) for s in st.layout.groups] == \
        [(s.shape, s.rank, s.leaf_idx) for s in jst.layout.groups]
    assert st.layout.dense_idx == jst.layout.dense_idx
    assert st.layout.compute_dtype == "float32"
    for mine, ref in zip(st.groups, jst.groups):
        for f in ("proj", "b", "m", "v"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(getattr(ref, f)))
    assert int(st.step) == 2


# ---------------------------------------------------------------------------
# (a) chunked CE on the same hidden state, (b) forward_hidden + loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_ce_matches_jax(chunk):
    rng = np.random.default_rng(8)
    B, S, d, vp, r = 2, 64, 32, 256, 4
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, vp)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((vp, r))).astype(np.float32)
    v = (rng.standard_normal((d, r)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, 200, (B, S)).astype(np.int32)
    mask = (rng.uniform(size=(B, S)) < 0.8).astype(np.float32)
    from repro.models.linear import LRPack as JLRPack
    want = jloss.chunked_ce(jax.numpy.asarray(h),
                            JLRPack(*(jax.numpy.asarray(a)
                                      for a in (w, b, v))),
                            jax.numpy.asarray(labels), true_vocab=200,
                            chunk=chunk, label_mask=jax.numpy.asarray(mask))
    got = tloss.chunked_ce(_t(h), LRPack(_t(w), _t(b), _t(v)), _t(labels),
                           true_vocab=200, chunk=chunk, label_mask=_t(mask))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


def test_forward_hidden_and_loss_match_jax(start):
    jgp, jst, gp, st = start["jgp"], start["jst"], start["gp"], start["st"]
    jpacked = jsub.packed_params(jgp, jst, jsub.trainable_of(jgp, jst))
    want = jsteps.build_loss_fn(JCFG)(jpacked, start["jbatch"])
    packed = subspace.packed_params(gp, st, subspace.trainable_of(gp, st))
    got = steps.build_loss_fn(CFG)(packed, start["batch"])
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


# ---------------------------------------------------------------------------
# (c) one inner step, (d) one outer merge + resample
# ---------------------------------------------------------------------------

def test_one_inner_step_matches_jax(start):
    jp2, js2, jm = jax.jit(jsteps.make_train_step(JCFG, JTCFG))(
        start["jgp"], start["jst"], start["jbatch"])
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(start["jgp"])), TCFG,
        groups=_np(start["jst"].groups), dense=_np(start["jst"].dense),
        step=2, device="cpu")
    p2, s2, m = steps.make_train_step(CFG, TCFG)(gp, st, start["batch"])
    assert abs(m["loss"].item() - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    _rel_close(m["grad_norm"], jm["grad_norm"], 1e-4)
    _rel_close(m["lr"], jm["lr"], 1e-6)
    assert int(s2.step) == int(js2.step) == 3
    for mine, ref in zip(s2.groups, js2.groups):
        for f in ("b", "m", "v"):
            _rel_close(getattr(mine, f), getattr(ref, f), 1e-4)
    for mine, ref in zip(p2.dense, jp2.dense):
        _rel_close(mine, ref, 1e-4)
    for mine, ref in zip(s2.dense, js2.dense):
        _rel_close(mine.m, ref.m, 1e-4)
        _rel_close(mine.v, ref.v, 1e-4)
    # the grouped master weights do not move in an inner step
    for mine, ref in zip(p2.groups, jp2.groups):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_one_outer_merge_matches_jax_with_its_v_injected(start,
                                                         monkeypatch):
    jp2, js2 = jsub.outer_merge_resample(start["jgp"], start["jst"], JTCFG)
    new_v = [np.asarray(s.proj) for s in js2.groups]
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(start["jgp"])), TCFG,
        groups=_np(start["jst"].groups), dense=_np(start["jst"].dense),
        step=2, device="cpu")
    drawn = []

    def injected(name, gen, spec, n_members, c, dtype, device,
                 energy=None):
        drawn.append((name, spec.shape, n_members))
        return _t(new_v[len(drawn) - 1]).to(device, dtype)

    monkeypatch.setattr(subspace, "_sample_proj_group", injected)
    p2, s2 = subspace.outer_merge_resample(gp, st, TCFG)
    assert [d[1] for d in drawn] == [s.shape for s in st.layout.groups]
    assert int(s2.outer_step) == int(js2.outer_step) == 1
    for mine, ref in zip(p2.groups, jp2.groups):
        _rel_close(mine, ref, 1e-5)
    for mine, ref in zip(s2.groups, js2.groups):
        np.testing.assert_array_equal(mine.proj.numpy(),
                                      np.asarray(ref.proj))
        for f in ("b", "m", "v"):
            assert not getattr(mine, f).any()
            assert not np.asarray(getattr(ref, f)).any()
    # the merge updates the grouped master buffer where it lies
    assert all(a is b for a, b in zip(p2.groups, gp.groups))


def test_every_buffer_the_kernels_read_is_contiguous():
    loader = StatelessLoader("lm", 0, device="cpu", **BATCH)
    tr = Trainer(CFG, TCFG, loader, device="cpu")
    for _ in range(2):
        tensors = list(tr.params.groups) + [
            t for s in tr.opt_state.groups for t in (s.proj, s.b, s.m, s.v)]
        assert all(t.is_contiguous() for t in tensors)
        packed = subspace.packed_params(
            tr.params, tr.opt_state,
            subspace.trainable_of(tr.params, tr.opt_state), torch.bfloat16)
        for _, leaf in subspace.tree_flatten_with_path(packed):
            if isinstance(leaf, LRPack):
                for i in range(leaf.w.shape[0] if leaf.w.ndim == 3 else 1):
                    one = leaf[i] if leaf.w.ndim == 3 else leaf
                    assert one.w.is_contiguous() and one.b.is_contiguous() \
                        and one.v.is_contiguous()
        tr.params, tr.opt_state = subspace.outer_merge_resample(
            tr.params, tr.opt_state, TCFG)


@pytest.mark.parametrize("batch", [1, 5])
def test_stiefel_draws_are_row_major(batch):
    gen = torch.Generator().manual_seed(2)
    v = samplers.stiefel_batched(gen, batch, 24, 6, dtype=torch.bfloat16)
    assert v.is_contiguous() and v.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (e) the gate: the Trainer over two outer cycles
# ---------------------------------------------------------------------------

def test_trainer_tracks_the_jax_trainer_over_two_outer_cycles(monkeypatch):
    jloader = JLoader("lm", 0, **BATCH)
    jt = JTrainer(JCFG, JTCFG, jloader)
    params0 = _np(jsub.params_of(jt.params))
    groups0, dense0 = _np(jt.opt_state.groups), _np(jt.opt_state.dense)
    jlosses, projs = [], []
    for _ in range(7):
        jlosses += jt.run(1).losses
        projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])

    tr = Trainer(CFG, TCFG,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, TCFG, groups=groups0, dense=dense0, device="cpu")
    queue = []
    monkeypatch.setattr(
        subspace, "_sample_proj_group",
        lambda name, gen, spec, n, c, dtype, device, energy=None:
        _t(queue.pop(0)).to(device, dtype))
    losses, outer = [], 0
    for s in range(7):
        if tr.outer_due():
            queue[:] = projs[s]       # the reference's V after this outer
        report = tr.run(1)
        losses += report.losses
        outer += report.outer_steps
        assert not queue
    assert outer == 2 and int(tr.opt_state.outer_step) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert all(np.isfinite(losses))


# (optimizer, state_dtype, master_dtype) -> the relative per-step loss
# gap allowed against the JAX Trainer; the int8 + bf16 Adam case holds it
# up to the first merge and is then held to a float64 run (F64_*)
COMPRESSED = {("lowrank_lion", "float32", "float32"): 1e-5,
              ("lowrank_adam", "int8", "bfloat16"): 1e-5,
              ("lowrank_lion", "int8", "bfloat16"): 1e-5}
F64_SEEDS = (0, 1, 2, 3, 4)   # model, state and data seeds of that case
F64_LOSS = 1e-3     # relative loss gap from the first merge on
FLIPS = 1.25        # median over seeds: the port's W off float64's
#                     rounds, over the reference's


def _jax_trainer_run(kw, seed):
    """Seven steps of the JAX Trainer under ``TrainConfig(**kw)`` with
    model, state and data from ``seed``; bf16 grouped masters when
    ``kw["master_dtype"]`` is bf16.  Returns the start (params, groups,
    dense), the losses, each step's ``V`` draws and rounding ``bits`` in
    the order the port asks for them, the W snapshots and the state
    before each step."""
    jtcfg = JTrainConfig(**dict(kw, seed=seed))
    sr = kw["master_dtype"] == "bfloat16"
    jt = JTrainer(JCFG, jtcfg, JLoader("lm", seed, **BATCH))
    if sr:
        jt.params = dataclasses.replace(jt.params, groups=tuple(
            w.astype(jax.numpy.bfloat16) for w in jt.params.groups))
    start = (_np(jsub.params_of(jt.params)), _np(jt.opt_state.groups),
             _np(jt.opt_state.dense))
    losses, projs, bits, snap, states = [], [], [], {}, []
    for s in range(7):
        states.append((jt.params, jt.opt_state))
        st, step_bits = jt.opt_state, []
        if sr:      # the reference's draws, in the order the port asks
            key = st.key
            if s > 0 and s % jtcfg.lazy_k == 0:
                key, skey = jax.random.split(key)
                step_bits += [jsub._sr_bits(skey, st.outer_step, g, w.shape)
                              for g, w in enumerate(jt.params.groups)]
            step_bits += [jsub._sr_bits(key, st.step, g, slot.b.shape)
                          for g, slot in enumerate(st.groups)]
        bits.append([np.asarray(b).astype(np.int32) for b in step_bits])
        losses += jt.run(1).losses
        projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])
        snap.update(_snapshot(s, jtcfg.lazy_k, jt.params))
    return (start, np.array(losses, np.float64), projs, bits, snap,
            states)


def _port_trainer_run(tcfg, seed, start, projs, bits, f64=False,
                      states=None):
    """The same seven steps of the port's Trainer from the reference's
    start, its ``V`` draws and rounding ``bits`` injected; under ``f64``
    the state widened and the plain path in float64.  Returns ``(losses,
    outer steps, trainer, W snapshots)``; a list ``states`` gets a copy of
    the state before each step."""
    params0, groups0, dense0 = start
    jloader = JLoader("lm", seed, **BATCH)
    tr = Trainer(CFG, tcfg,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, tcfg, groups=groups0, dense=dense0, device="cpu")
    if f64:
        tr.params, tr.opt_state = widened(tr.params, tr.opt_state)
    v_queue, bits_queue = [], []

    def injected_bits(gen, shape, device):
        b = bits_queue.pop(0)
        assert tuple(shape) == b.shape
        return _t(b).to(device)

    losses, outer, snap = [], 0, {}
    with pytest.MonkeyPatch.context() as mp, \
            float64_plain_path() if f64 else contextlib.nullcontext():
        mp.setattr(subspace, "_sample_proj_group",
                   lambda name, gen, spec, n, c, dtype, device,
                   energy=None:
                   _t(v_queue.pop(0)).to(device, dtype))
        mp.setattr(subspace, "_sr_bits", injected_bits)
        for s in range(7):
            if tr.outer_due():
                v_queue[:] = projs[s]
            bits_queue[:] = bits[s]
            if states is not None:
                states.append(_copy_state(tr.params, tr.opt_state))
            report = tr.run(1)
            losses += report.losses
            outer += report.outer_steps
            assert not v_queue and not bits_queue
            snap.update(_snapshot(s, tcfg.lazy_k, tr.params))
    if f64:
        assert_float64(tr.params, tr.opt_state)
    return np.array(losses, np.float64), outer, tr, snap


def _copy_state(params, state):
    """A copy of the port's ``(params, state)`` that later in-place
    updates (the merge writes W where it lies) leave as it is."""
    def cp(x):
        if isinstance(x, quant.QuantizedTensor):
            return dataclasses.replace(x, q=x.q.clone(),
                                       scale=x.scale.clone())
        return x.clone()
    params = dataclasses.replace(params, dense=tuple(map(cp, params.dense)),
                                 groups=tuple(map(cp, params.groups)))
    return params, dataclasses.replace(
        state, step=state.step.clone(), outer_step=state.outer_step.clone(),
        dense=tuple(d._replace(m=cp(d.m), v=cp(d.v)) for d in state.dense),
        groups=tuple(g._replace(proj=cp(g.proj), b=cp(g.b), m=cp(g.m),
                                v=cp(g.v)) for g in state.groups))


def _to_jax(params, state, jparams, jstate):
    """The port's ``(params, state)`` in the reference's containers (its
    own state at the same step supplies the key and the layout)."""
    def arr(x, like):
        if isinstance(x, quant.QuantizedTensor):
            return dataclasses.replace(like, q=jax.numpy.asarray(x.q.numpy()),
                                       scale=jax.numpy.asarray(
                                           x.scale.numpy()))
        return jax.numpy.asarray(x.float().numpy()).astype(like.dtype)
    assert int(state.step) == int(jstate.step)
    assert int(state.outer_step) == int(jstate.outer_step)
    jparams = dataclasses.replace(
        jparams, dense=tuple(map(arr, params.dense, jparams.dense)),
        groups=tuple(map(arr, params.groups, jparams.groups)))
    return jparams, dataclasses.replace(
        jstate,
        dense=tuple(j._replace(m=arr(d.m, j.m), v=arr(d.v, j.v))
                    for d, j in zip(state.dense, jstate.dense)),
        groups=tuple(j._replace(proj=arr(g.proj, j.proj), b=arr(g.b, j.b),
                                m=arr(g.m, j.m), v=arr(g.v, j.v))
                     for g, j in zip(state.groups, jstate.groups)))


def _replay(jtcfg, seed, states, jstates, losses):
    """The reference's merge and inner step taken from the port's own
    state before each step, each result held to the port's: the merged W
    and the new B in bf16 steps (``bf16_steps_close``), the int8 moments
    (``quant_close``, the gradient in bf16) and the loss within 1e-5.
    From one state the two agree up to fp32 sums in another order,
    however far apart the free runs have drifted, so a fault of the
    port's merge or update at any step shows here.  A B element whose
    gradient sits at fp32's noise takes an Adam step ``m / sqrt(v)``
    that fp32 fixes only to a part of ``lr``: such elements may differ
    by up to ``0.1 lr``.  Measured at seeds 0-4: B at most 0.025 lr
    apart, beyond one bf16 step at 0.024% of the elements or fewer; the
    scales at most 0.69% of their own size apart, under ``2**-7``; the
    merged W equal everywhere."""
    jstep = jax.jit(jsteps.make_train_step(JCFG, jtcfg))
    jloader = JLoader("lm", seed, **BATCH)
    for s in range(7):
        jp, js = _to_jax(*states[s], *jstates[s])
        after = states[s + 1] if s + 1 < len(states) else None
        if s > 0 and s % jtcfg.lazy_k == 0:
            jp, js = jsub.outer_merge_resample(jp, js, jtcfg)
        _, js2, jm = jstep(jp, js, jloader(s))
        assert abs(losses[s] - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        if after is None:
            continue
        for mine, ref in zip(after[0].groups, jp.groups):
            bf16_steps_close(mine, ref)
        for mine, ref, before in zip(after[1].groups, js2.groups,
                                     js.groups):
            bf16_steps_close(mine.b, ref.b, before=before.b,
                             atol=0.1 * float(jm["lr"]))
            quant_close(mine.m, ref.m, bf16_grad=True)
            quant_close(mine.v, ref.v, bf16_grad=True)


def _f64(x):
    return x.double().numpy() if torch.is_tensor(x) else np.asarray(
        x.astype(np.float32), np.float64)


def _snapshot(s, lazy_k, params):
    """The grouped W, as float64 numpy, after each of the two merges
    (steps ``lazy_k`` and ``2 lazy_k``)."""
    if s in (lazy_k, 2 * lazy_k):
        return {s: [_f64(w) for w in params.groups]}
    return {}


@pytest.mark.parametrize("optimizer,state_dtype,master_dtype",
                         list(COMPRESSED))
def test_compressed_trainers_track_the_jax_trainer_over_two_outer_cycles(
        optimizer, state_dtype, master_dtype):
    """The gate above for Lion and for int8 moments with bf16 masters
    (the grouped weights stored in bf16 too, so the merge is the
    stochastically rounded one).  The reference's ``V`` and rounding
    ``bits`` are injected.  Lion on fp32 state and on int8 + bf16 keeps
    the gate's 1e-5 at every step (measured 2.9e-7 and 1.4e-7: the sign
    update absorbs a last-bit difference).

    int8 + bf16 Adam keeps 1e-5 up to the first merge, at each of
    ``F64_SEEDS`` (measured at most 1.7e-6 over 24 seeds).  From the
    first merge on, the first Adam step after a moment reset is nearly
    sign-like, so an element whose exact gradient lies under fp32's
    rounding noise moves by about ``lr`` one way or the other in either
    package, and bf16 and int8 rounds compound it.  So the port, the
    reference and a float64 run of the port's plain path on the same
    inputs and draws (``_torch_parity``) are held pairwise within
    ``F64_LOSS`` relative, and the grouped W after each merge is counted
    off float64's rounds in each package: the median over the seeds of
    the port's count over the reference's at most ``FLIPS``.  A median,
    because one such element can double one seed's count in either
    package (seed 0: the port 137,315 and the reference 70,941 after two
    cycles, from an embedding entry whose exact first gradient, 2.3e-7,
    the port takes as -2.1e-7 and the reference as 4.4e-8; seed 8: the
    reference 64,220, the port 46,280).  Measured over 24 seeds, with
    XLA's CPU dot threaded and not: the median ratio 1.005 and 1.020
    after two cycles, 1.020 and 1.032 after one; losses from the first
    merge on at most 4.2e-4 from float64 in the port and 1.6e-4 and
    2.7e-4 in the reference (medians 9.0e-5 against 7.7e-5 and 6.6e-5),
    the two at most 4.6e-4 apart.  From one shared state the port's
    gradient and update are as close to float64 as the reference's."""
    kw = dict(KW, optimizer=optimizer, state_dtype=state_dtype,
              master_dtype=master_dtype)
    if optimizer == "lowrank_lion":       # the reference tests' Lion recipe
        kw.update(lr=3e-4, beta2=0.99)
    f64 = (optimizer, state_dtype, master_dtype) == (
        "lowrank_adam", "int8", "bfloat16")
    ratios = {}
    for seed in F64_SEEDS if f64 else (KW["seed"],):
        tcfg = TrainConfig(**dict(kw, seed=seed))
        run = _jax_trainer_run(kw, seed)
        start, jlosses, jsnap = run[0], run[1], run[4]
        states = [] if f64 and seed == F64_SEEDS[0] else None
        losses, outer, tr, snap = _port_trainer_run(
            tcfg, seed, start, *run[2:4], states=states)
        if states is not None:
            _replay(JTrainConfig(**dict(kw, seed=seed)), seed, states,
                    run[5], losses)
        assert outer == 2 and int(tr.opt_state.outer_step) == 2
        assert tr.opt_state.layout.algo == optimizer.removeprefix("lowrank_")
        assert all(np.isfinite(losses))
        if master_dtype == "bfloat16":
            assert all(w.dtype == torch.bfloat16 for w in tr.params.groups)
            assert all(s.b.dtype == torch.bfloat16
                       for s in tr.opt_state.groups)
        rtol = COMPRESSED[optimizer, state_dtype, master_dtype]
        if not f64:
            np.testing.assert_allclose(losses, jlosses, rtol=rtol)
            continue
        first = tcfg.lazy_k       # the first step after the first merge
        np.testing.assert_allclose(losses[:first], jlosses[:first],
                                   rtol=rtol)
        l64, _, _, snap64 = _port_trainer_run(tcfg, seed, start, *run[2:4],
                                              f64=True)
        for a, b in ((losses, jlosses), (losses, l64), (jlosses, l64)):
            np.testing.assert_allclose(a[first:], b[first:], rtol=F64_LOSS)
        for s, exact in snap64.items():
            port_off = sum(int((a != x).sum())
                           for a, x in zip(snap[s], exact))
            ref_off = sum(int((b != x).sum())
                          for b, x in zip(jsnap[s], exact))
            ratios.setdefault(s, []).append(port_off / max(ref_off, 1))
    for s, r in ratios.items():
        assert np.median(r) <= FLIPS, (s, r)


# ---------------------------------------------------------------------------
# (f) the Stiefel law, (g) the synthetic stream's law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,r,c", [(16, 4, 1.0), (40, 8, 2.0)])
def test_stiefel_gram_is_exactly_scaled_identity(n, r, c):
    gen = torch.Generator().manual_seed(0)
    v = samplers.stiefel_batched(gen, 16, n, r, c=c)
    gram = v.transpose(-1, -2) @ v
    want = (c * n / r) * torch.eye(r).expand(16, r, r)
    assert (gram - want).abs().max().item() <= 1e-5 * c * n / r
    one = samplers.stiefel(gen, n, r, c=c)
    assert one.shape == (n, r)
    assert (one.T @ one - want[0]).abs().max().item() <= 1e-5 * c * n / r


def test_stiefel_is_unbiased_in_expectation():
    n, r, draws = 16, 4, 4000
    gen = torch.Generator().manual_seed(1)
    v = samplers.stiefel_batched(gen, draws, n, r).double()
    mean = (v @ v.transpose(-1, -2)).mean(dim=0)
    # each entry of V Vᵀ has sd <= 0.58 here, so the mean of 4000 draws
    # has sd <= 0.0092: 0.05 is over five of them
    assert (mean - torch.eye(n, dtype=torch.float64)).abs().max() < 0.05


def test_stiefel_matches_the_reference_law_not_its_bits():
    from repro.core import samplers as jsamplers
    jv = np.asarray(jsamplers.stiefel_batched(jax.random.key(0), 4, 32, 8))
    gen = torch.Generator().manual_seed(0)
    v = samplers.stiefel_batched(gen, 4, 32, 8).numpy()
    for a in (jv, v):
        gram = np.swapaxes(a, -1, -2) @ a
        np.testing.assert_allclose(gram, np.broadcast_to(
            4.0 * np.eye(8), gram.shape), atol=2e-5)
    with pytest.raises(ValueError, match="available: coordinate, "
                                         "dependent_diag, gaussian, "
                                         "stiefel"):
        samplers.sample_v_batched("haar", gen, 1, 8, 2)


def _mode_stats(tokens, vocab, n_modes=8):
    width = max(vocab // n_modes, 2)
    mode = np.asarray(tokens) // width
    step = (np.diff(mode, axis=1)) % n_modes
    return mode, step


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 11)])
def test_lm_batch_follows_the_reference_law(seed, step):
    kw = dict(batch=64, seq_len=256, vocab=512)
    mine = lm_batch(seed, step, device="cpu", **kw)
    ref = _np(jlm_batch(seed, step, **kw))
    for b in (mine, ref):
        toks, labels = np.asarray(b["tokens"]), np.asarray(b["labels"])
        assert toks.shape == labels.shape == (64, 256)
        assert toks.min() >= 0 and toks.max() < 512
        np.testing.assert_array_equal(labels[:, :-1], toks[:, 1:])
        mode, moves = _mode_stats(np.concatenate(
            [toks, labels[:, -1:]], axis=1), 512)
        assert mode.min() >= 0 and mode.max() < 8
        # the mode walks one step with probability 0.05 and never jumps:
        # 16384 transitions put the rate's sd at 0.0017
        assert set(np.unique(moves)) <= {0, 1}
        assert abs(moves.mean() - 0.05) < 0.01
    assert mine["tokens"].dtype == torch.int32


def test_lm_batch_is_a_pure_function_of_seed_and_step():
    kw = dict(batch=4, seq_len=16, vocab=64, device="cpu")
    a, b, c = lm_batch(1, 5, **kw), lm_batch(1, 5, **kw), lm_batch(1, 6, **kw)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    loader = StatelessLoader("lm", 1, device="cpu", batch=4, seq_len=16,
                             vocab=64)
    assert torch.equal(loader(5)["labels"], a["labels"])
    with pytest.raises(ValueError, match="cls, lm"):
        StatelessLoader("encdec", 1, device="cpu")


# ---------------------------------------------------------------------------
# Schedule, clipping, registry and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cosine", "constant"])
def test_schedules_match_jax(name):
    kw = dict(base_lr=3e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 9, 10, 55, 100, 150):
        got = schedule.SCHEDULES[name](torch.tensor(s), **kw)
        want = jschedule.SCHEDULES[name](s, **kw)
        assert abs(got.item() - float(want)) <= 1e-7


@pytest.mark.parametrize("max_norm", [0.0, 0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(9)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 4), (5,), (2, 2, 2))]
    want, jgn = jadamw.clip_by_global_norm(
        [jax.numpy.asarray(a) for a in arrs], max_norm)
    got, gn = adamw.clip_by_global_norm([_t(a) for a in arrs], max_norm)
    assert abs(gn.item() - float(jgn)) <= 1e-6 * max(float(jgn), 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_clip_promotes_a_bf16_gradient_to_fp32_as_jax_does():
    """A bf16 B master has a bf16 gradient; the reference scales it by an
    fp32 array, which promotes it to fp32 unrounded."""
    rng = np.random.default_rng(10)
    a = rng.standard_normal((6, 5)).astype(np.float32)
    jg = jax.numpy.asarray(a).astype(jax.numpy.bfloat16)
    (want,), jgn = jadamw.clip_by_global_norm([jg], 0.5)
    (got,), gn = adamw.clip_by_global_norm([_t(a).bfloat16()], 0.5)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == \
        np.float32
    assert abs(gn.item() - float(jgn)) <= 1e-6 * float(jgn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_packs_reach_the_kernels_in_one_dtype():
    """Under fp32 compute, bf16 stored weights and bf16 B masters are cast
    up in the pack (fp32 members are not copied); under bf16 compute
    everything is bf16."""
    cfg = CFG.replace(param_dtype="bfloat16")
    tcfg = TrainConfig(**dict(KW, master_dtype="bfloat16",
                              compute_dtype="float32"))
    loader = StatelessLoader("lm", 0, device="cpu", **BATCH)
    tr = Trainer(cfg, tcfg, loader, device="cpu")
    assert tr.params.groups[0].dtype == torch.bfloat16
    assert tr.opt_state.groups[0].b.dtype == torch.bfloat16
    for compute, want in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
        tc = TrainConfig(**dict(KW, master_dtype="bfloat16",
                                compute_dtype=compute))
        pdt = steps.pack_dtype(cfg.replace(dtype="float32"), tc, "cpu")
        assert pdt == want
        tb = subspace.trainable_of(tr.params, tr.opt_state)
        packed = subspace.packed_params(tr.params, tr.opt_state, tb, pdt)
        packs = [leaf for _, leaf in subspace.tree_flatten_with_path(packed)
                 if isinstance(leaf, LRPack)]
        assert packs and all(p.w.dtype == p.b.dtype == p.v.dtype == want
                             for p in packs)
    fp32_tr = Trainer(CFG, TCFG, loader, device="cpu")
    tb = subspace.trainable_of(fp32_tr.params, fp32_tr.opt_state)
    packed = subspace.packed_params(fp32_tr.params, fp32_tr.opt_state, tb,
                                    steps.pack_dtype(CFG, TCFG, "cpu"))
    assert packed["unembed"].b.data_ptr() == tb.groups[-1].data_ptr()


def test_only_the_ported_method_and_state_are_accepted():
    assert methods.available() == ("adamw", "galore", "lowrank_adam",
                                   "lowrank_lion", "lowrank_lr")
    with pytest.raises(ValueError,
                       match="available: adamw, galore, lowrank_adam, "
                             "lowrank_lion, lowrank_lr"):
        methods.get("vanilla_lr")
    loader = StatelessLoader("lm", 0, device="cpu", **BATCH)
    with pytest.raises(ValueError, match="unknown method"):
        Trainer(CFG, TrainConfig(optimizer="sgd"), loader, device="cpu")
    for ok in (dict(state_dtype="int8"), dict(master_dtype="bfloat16"),
               dict(optimizer="lowrank_lion", state_dtype="int8",
                    master_dtype="bfloat16")):
        tr = Trainer(CFG, TrainConfig(**ok), loader, device="cpu")
        layout = tr.opt_state.layout
        assert (layout.state_dtype, layout.master_dtype) == (
            ok.get("state_dtype", "float32"),
            ok.get("master_dtype", "float32"))
    for bad in (dict(state_dtype="int4"), dict(master_dtype="float16")):
        with pytest.raises(ValueError, match="expected one of"):
            Trainer(CFG, TrainConfig(**bad), loader, device="cpu")
    tr = Trainer(CFG, TrainConfig(grad_accum=3), loader, device="cpu")
    with pytest.raises(ValueError, match="grad_accum=3 does not divide"):
        tr.run(1)
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(CFG, TrainConfig(compute_dtype="int4"), loader,
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(CFG, TCFG, loader)


def _seed_sweep(n_seeds):
    """The int8 + bf16 Adam gate's free runs at seeds ``0 .. n_seeds - 1``
    (``python tests/test_torch_train.py N``, with ``PYTHONPATH=src``):
    per seed, the largest relative loss gap from the first merge on of
    the port and of the reference to the port's float64 plain run, and
    the grouped W's rounds off float64's after each merge, the port's
    count over the reference's; then the medians over the seeds."""
    kw = dict(KW, optimizer="lowrank_adam", state_dtype="int8",
              master_dtype="bfloat16")
    first = KW["lazy_k"]
    rows = []
    for seed in range(n_seeds):
        tcfg = TrainConfig(**dict(kw, seed=seed))
        run = _jax_trainer_run(kw, seed)
        start, jlosses, jsnap = run[0], run[1], run[4]
        losses, _, _, snap = _port_trainer_run(tcfg, seed, start, *run[2:4])
        l64, _, _, snap64 = _port_trainer_run(tcfg, seed, start, *run[2:4],
                                              f64=True)
        port = float(np.max(np.abs(losses[first:] - l64[first:])
                            / np.abs(l64[first:])))
        ref = float(np.max(np.abs(jlosses[first:] - l64[first:])
                           / np.abs(l64[first:])))
        flips = {s: sum(int((a != x).sum()) for a, x in zip(snap[s], ex))
                 / max(sum(int((b != x).sum())
                           for b, x in zip(jsnap[s], ex)), 1)
                 for s, ex in snap64.items()}
        rows.append((port, ref, flips))
        print(f"seed {seed:2d}: loss gap to float64 port {port:.3g} "
              f"reference {ref:.3g}; W rounds port/reference " + ", ".join(
                  f"after step {s}: {r:.3f}" for s, r in flips.items()),
              flush=True)
    port, ref = np.array([r[0] for r in rows]), np.array([r[1] for r in rows])
    print(f"{n_seeds} seeds: loss gap port max {port.max():.3g} median "
          f"{np.median(port):.3g}; reference max {ref.max():.3g} median "
          f"{np.median(ref):.3g}; port farther at {(port > ref).sum()} "
          f"seeds")
    for s in rows[0][2]:
        print(f"W rounds after step {s}: median port/reference "
              f"{np.median([r[2][s] for r in rows]):.3f}")


if __name__ == "__main__":
    import sys
    _seed_sweep(int(sys.argv[1]) if len(sys.argv) > 1 else 24)
