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
  per-step loss within 1e-5 relative of the reference ``Trainer``'s.

The samplers and the data stream are held to the reference by law.
"""
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
from repro_torch.optim import adamw, schedule, subspace  # noqa: E402
from repro_torch.train import loss as tloss  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

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

    def injected(name, gen, spec, n_members, c, dtype, device):
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
        lambda name, gen, spec, n, c, dtype, device:
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
# gap allowed against the JAX Trainer; see the test's docstring
COMPRESSED = {("lowrank_lion", "float32", "float32"): 1e-5,
              ("lowrank_adam", "int8", "bfloat16"): 2e-4,
              ("lowrank_lion", "int8", "bfloat16"): 1e-5}


@pytest.mark.parametrize("optimizer,state_dtype,master_dtype",
                         list(COMPRESSED))
def test_compressed_trainers_track_the_jax_trainer_over_two_outer_cycles(
        monkeypatch, optimizer, state_dtype, master_dtype):
    """The gate above for Lion and for int8 moments with bf16 masters
    (the grouped weights stored in bf16 too, so the merge is the
    stochastically rounded one).  The reference's ``V`` and rounding
    ``bits`` are injected.  Lion on fp32 state keeps the gate's 1e-5.
    Under bf16 masters the B gradient is bf16, and a last-bit difference
    of the fp32 gradient moves its bf16 rounding at a few elements per
    thousand by one part in 2**8; SR rounds of B and W and int8 payloads
    move by one step the same way, and Adam's steps after a moment reset
    are nearly sign-like, so the gap grows after the first merge.
    Measured per-step worst (CPU): ``lowrank_adam`` int8 + bf16 4.5e-5
    relative (1.4e-7 before the first merge), held at 2e-4;
    ``lowrank_lion`` int8 + bf16 1.4e-7 (the sign update absorbs it),
    held at Lion on fp32 state's 1e-5."""
    kw = dict(KW, optimizer=optimizer, state_dtype=state_dtype,
              master_dtype=master_dtype)
    if optimizer == "lowrank_lion":       # the reference tests' Lion recipe
        kw.update(lr=3e-4, beta2=0.99)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    sr = master_dtype == "bfloat16"
    jloader = JLoader("lm", 0, **BATCH)
    jt = JTrainer(JCFG, jtcfg, jloader)
    if sr:
        jt.params = dataclasses.replace(jt.params, groups=tuple(
            w.astype(jax.numpy.bfloat16) for w in jt.params.groups))
    params0 = _np(jsub.params_of(jt.params))
    groups0, dense0 = _np(jt.opt_state.groups), _np(jt.opt_state.dense)
    jlosses, projs, bits = [], [], []
    for s in range(7):
        st, step_bits = jt.opt_state, []
        if sr:      # the reference's draws, in the order the port asks
            key = st.key
            if s > 0 and s % tcfg.lazy_k == 0:
                key, skey = jax.random.split(key)
                step_bits += [jsub._sr_bits(skey, st.outer_step, g, w.shape)
                              for g, w in enumerate(jt.params.groups)]
            step_bits += [jsub._sr_bits(key, st.step, g, slot.b.shape)
                          for g, slot in enumerate(st.groups)]
        bits.append([np.asarray(b).astype(np.int32) for b in step_bits])
        jlosses += jt.run(1).losses
        projs.append([np.asarray(g.proj) for g in jt.opt_state.groups])

    tr = Trainer(CFG, tcfg,
                 lambda s: {k: _t(v) for k, v in jloader(s).items()},
                 device="cpu", params=convert.params_from_numpy(params0,
                                                                "cpu"))
    tr.params, tr.opt_state = convert.subspace_from_numpy(
        params0, tcfg, groups=groups0, dense=dense0, device="cpu")
    v_queue, bits_queue = [], []

    def injected_bits(gen, shape, device):
        b = bits_queue.pop(0)
        assert tuple(shape) == b.shape
        return _t(b).to(device)

    monkeypatch.setattr(
        subspace, "_sample_proj_group",
        lambda name, gen, spec, n, c, dtype, device:
        _t(v_queue.pop(0)).to(device, dtype))
    monkeypatch.setattr(subspace, "_sr_bits", injected_bits)
    losses, outer = [], 0
    for s in range(7):
        if tr.outer_due():
            v_queue[:] = projs[s]
        bits_queue[:] = bits[s]
        report = tr.run(1)
        losses += report.losses
        outer += report.outer_steps
        assert not v_queue and not bits_queue
    assert outer == 2 and int(tr.opt_state.outer_step) == 2
    assert tr.opt_state.layout.algo == optimizer.removeprefix("lowrank_")
    if sr:
        assert all(w.dtype == torch.bfloat16 for w in tr.params.groups)
        assert all(s.b.dtype == torch.bfloat16 for s in tr.opt_state.groups)
    np.testing.assert_allclose(
        losses, jlosses, rtol=COMPRESSED[optimizer, state_dtype, master_dtype])
    assert all(np.isfinite(losses))


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
    with pytest.raises(NotImplementedError, match="gaussian"):
        samplers.sample_v_batched("gaussian", gen, 1, 8, 2)


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
    with pytest.raises(NotImplementedError, match="cls"):
        StatelessLoader("cls", 1, device="cpu")


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
    with pytest.raises(NotImplementedError, match="grad_accum"):
        Trainer(CFG, TrainConfig(grad_accum=2), loader, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(CFG, TrainConfig(compute_dtype="int4"), loader,
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(CFG, TCFG, loader)
