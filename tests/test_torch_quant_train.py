"""One inner step and one outer merge of the port against the JAX package
for every update rule and storage precision: ``algo`` in {adam, lion}
(``lowrank_adam``, ``lowrank_lion``) × ``state_dtype`` in {float32, int8}
× ``master_dtype`` in {float32, bfloat16}, on llama-tiny in fp32.

Each case starts from the same mid-run state on both sides: the
reference's init, random B (in the master dtype) and moments (quantized
by the reference under int8), step 2.  Under bf16 masters the grouped
low-rank weights are stored in bf16 too, so the outer step takes the
stochastically rounded merge.  The rounding noise (``bits``) and the new
``V`` are the reference's own draws, injected into the port.
Tolerances (the gradient itself is fp32 summed in another order, 1e-5
of its size):

* loss 1e-5 relative; fp32 B, moments and dense leaves 1e-4 of each
  buffer's largest magnitude (Adam divides by ``sqrt(v)``).  Under bf16
  masters the B gradient is bf16 (the reference's cotangent of a bf16
  primal), and an fp32 gradient that differs in its last bits can round
  to the neighbouring bf16 value, one part in 2**8 of that element: fp32
  moments are then held to 1e-3 of their largest magnitude;
* a bf16 B master after its stochastic round: every element within one
  bf16 step of the reference's, at most 1% of them off — an fp32 update
  that differs in its last bits moves a round only when it sits within
  that difference of a rounding edge.  The step is counted at the
  largest magnitude in the sum (``b`` before the step, the update, the
  result): an update that nearly cancels ``b`` leaves a result whose own
  step is far finer than the fp32 difference it inherits (measured: one
  element 16 steps of its own size apart, 0.25 of ``|b|``'s, where
  XLA's CPU dot splits its sums across threads).  Both packages are held
  to a float64 run of the port's plain path by
  ``test_bf16_step_is_as_close_to_float64_as_jax``;
* int8 moments: the per-row scales within 1e-4 of the largest scale, the
  payloads within one int8 step, at most 1% of them off (a scale that
  moves by its last bits moves a value by one step only at a half-way
  point);
* the outer merge: fp32 weights 1e-5 of their largest magnitude, bf16
  weights one bf16 step per element (at most 1% off); ``V`` equal to the
  injected draw; ``B`` and the moments zero, quantized moments keeping
  their codec.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import quant as jquant  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.optim import quant, subspace  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from _torch_parity import (assert_float64, bf16_step, bf16_steps_close,  # noqa
                           float64_plain_path, quant_close, widened)

CFG, JCFG = get_config("llama-tiny"), jget_config("llama-tiny")
BATCH = dict(batch=2, seq_len=64, vocab=CFG.vocab_size)
CASES = [(algo, sd, md) for algo in ("adam", "lion")
         for sd in ("float32", "int8") for md in ("float32", "bfloat16")]


def configs(algo, state_dtype, master_dtype):
    kw = dict(lazy_k=3, warmup_steps=2, total_steps=7, lr=3e-3, seed=0,
              optimizer=f"lowrank_{algo}", state_dtype=state_dtype,
              master_dtype=master_dtype)
    if algo == "lion":          # the reference tests' Lion recipe
        kw.update(lr=3e-4, beta2=0.99)
    return TrainConfig(**kw), JTrainConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f64(x):
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _rel_close(got, want, rel):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _moment_close(got, want, master_dtype):
    if isinstance(want, jquant.QuantizedTensor):
        quant_close(got, want)
    else:
        _rel_close(got, want, 1e-4 if master_dtype == "float32" else 1e-3)


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def start(request):
    """A reference state mid-run for one case, as numpy, and its configs."""
    return _make_start(request.param)


def _make_start(case):
    algo, sd, md = case
    tcfg, jtcfg = configs(algo, sd, md)
    jparams = jlm.init_params(JCFG, jax.random.key(5))
    jgp, jst = jsub.init_grouped(jparams, jtcfg, jax.random.key(6),
                                 algo=algo)
    if md == "bfloat16":       # bf16 stored weights under bf16 masters
        jgp = dataclasses.replace(jgp, groups=tuple(
            w.astype(jnp.bfloat16) for w in jgp.groups))
    rng = np.random.default_rng(7)

    def rnd(shape, scale, positive=False):
        a = scale * rng.standard_normal(shape)
        return (np.abs(a) if positive else a).astype(np.float32)

    def moment(like, scale, positive=False):
        x = jnp.asarray(rnd(like.shape, scale, positive))
        if isinstance(like, jquant.QuantizedTensor):
            return jquant.quantize(x, like.block, like.codec)
        return x

    groups = tuple(s._replace(
        b=jnp.asarray(rnd(s.b.shape, 0.02)).astype(s.b.dtype),
        m=moment(s.m, 1e-3),
        v=s.v if algo == "lion" else moment(s.v, 1e-6, positive=True))
        for s in jst.groups)
    dense = tuple(d._replace(m=jnp.asarray(rnd(d.m.shape, 1e-3)),
                             v=jnp.asarray(rnd(d.v.shape, 1e-6, True)))
                  for d in jst.dense)
    jst = dataclasses.replace(jst, groups=groups, dense=dense,
                              step=jnp.asarray(2, jnp.int32))
    return dict(case=(algo, sd, md), tcfg=tcfg, jtcfg=jtcfg, jgp=jgp,
                jst=jst, jbatch=jlm_batch(0, 3, **BATCH))


def _port_state(start):
    jgp, jst = start["jgp"], start["jst"]
    return convert.subspace_from_numpy(
        _np(jsub.params_of(jgp)), start["tcfg"], groups=_np(jst.groups),
        dense=_np(jst.dense), step=int(jst.step),
        outer_step=int(jst.outer_step), device="cpu")


def _inject_bits(monkeypatch, queue):
    """The port's rounding noise becomes the reference's, in call order."""
    def injected(gen, shape, device):
        bits = queue.pop(0)
        assert tuple(shape) == bits.shape
        return torch.from_numpy(bits).to(device)
    monkeypatch.setattr(subspace, "_sr_bits", injected)


def test_state_carries_across(start):
    _, st = _port_state(start)
    algo, sd, md = start["case"]
    lay = st.layout
    assert (lay.algo, lay.state_dtype, lay.master_dtype, lay.qblock) == (
        algo, sd, md, quant.QBLOCK)
    for mine, ref in zip(st.groups, start["jst"].groups):
        assert mine.b.dtype == getattr(torch, md)
        np.testing.assert_array_equal(_f64(mine.b), _f64(ref.b))
        for f in ("m", "v"):
            got, want = getattr(mine, f), getattr(ref, f)
            if sd == "int8" and not (algo == "lion" and f == "v"):
                np.testing.assert_array_equal(got.q.numpy(),
                                              np.asarray(want.q))
                np.testing.assert_array_equal(got.scale.numpy(),
                                              np.asarray(want.scale))
            else:
                assert got.shape == want.shape
                np.testing.assert_array_equal(_f64(got), _f64(want))
        if algo == "lion":
            assert mine.v.shape[-2] == 0


def test_one_inner_step_matches_jax(start, monkeypatch):
    jgp, jst = start["jgp"], start["jst"]
    jp2, js2, jm = jax.jit(jsteps.make_train_step(JCFG, start["jtcfg"]))(
        jgp, jst, start["jbatch"])
    gp, st = _port_state(start)
    queue = []
    if start["case"][2] == "bfloat16":
        queue = [np.asarray(jsub._sr_bits(jst.key, jst.step, gi, s.b.shape)
                            ).astype(np.int32)
                 for gi, s in enumerate(jst.groups)]
    _inject_bits(monkeypatch, queue)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in start["jbatch"].items()}
    p2, s2, m = steps.make_train_step(CFG, start["tcfg"])(gp, st, batch)
    assert not queue
    assert abs(m["loss"].item() - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    _rel_close(m["grad_norm"], jm["grad_norm"], 1e-4)
    assert int(s2.step) == int(js2.step) == 3
    for mine, ref, before in zip(s2.groups, js2.groups, jst.groups):
        assert mine.b.dtype == getattr(torch, start["case"][2])
        if start["case"][2] == "bfloat16":
            bf16_steps_close(mine.b, ref.b, before=before.b)
        else:
            _rel_close(mine.b, ref.b, 1e-4)
        _moment_close(mine.m, ref.m, start["case"][2])
        if start["case"][0] == "adam":
            _moment_close(mine.v, ref.v, start["case"][2])
        else:
            assert mine.v.shape == ref.v.shape and mine.v.shape[-2] == 0
    for mine, ref in zip(p2.dense, jp2.dense):
        _rel_close(mine, ref, 1e-4)
    for mine, ref in zip(s2.dense, js2.dense):
        _rel_close(mine.m, ref.m, 1e-4)
        _rel_close(mine.v, ref.v, 1e-4)
    # the grouped master weights do not move in an inner step
    for mine, ref in zip(p2.groups, jp2.groups):
        np.testing.assert_array_equal(_f64(mine), _f64(ref))


BF16_CASES = [c for c in CASES if c[2] == "bfloat16"]


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=["-".join(c) for c in BF16_CASES])
def test_bf16_step_is_as_close_to_float64_as_jax(case, monkeypatch):
    """The yardstick behind ``bf16_steps_close``'s ``before``: the same
    inner step taken by the port's plain path in float64 (B and every
    fp32 tensor widened, the update left unrounded), and each package's
    bf16 B measured against it in bf16 steps of the magnitudes that
    entered the sum.  The port is held to be no farther than the
    reference: its worst element within one such step of the
    reference's worst, its mean within 10%.  Measured, with XLA's CPU
    dot threaded and not: equal worst elements in every group (0.99 to
    79 steps; the large ones Lion's sign flips where the bf16 gradient
    and the exact one straddle zero)."""
    start = _make_start(case)
    jgp, jst = start["jgp"], start["jst"]
    _, js2, _ = jax.jit(jsteps.make_train_step(JCFG, start["jtcfg"]))(
        jgp, jst, start["jbatch"])
    queue = [np.asarray(jsub._sr_bits(jst.key, jst.step, gi, s.b.shape)
                        ).astype(np.int32)
             for gi, s in enumerate(jst.groups)]
    _inject_bits(monkeypatch, queue)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in start["jbatch"].items()}
    _, s2, _ = steps.make_train_step(CFG, start["tcfg"])(
        *_port_state(start), batch)
    tcfg64, _ = configs(case[0], case[1], "float32")
    gp64, st64 = widened(*_port_state(start), master_dtype="float32")
    with float64_plain_path():
        p64, s64, _ = steps.make_train_step(CFG, tcfg64)(gp64, st64, batch)
    assert_float64(p64, s64)
    for mine, ref, exact, before in zip(s2.groups, js2.groups, s64.groups,
                                        jst.groups):
        x, b0 = exact.b.numpy(), _f64(before.b)
        assert exact.b.dtype == torch.float64
        ulp = bf16_step(np.maximum.reduce([np.abs(x), np.abs(b0),
                                            np.abs(x - b0)]))
        port_off = np.abs(_f64(mine.b) - x) / ulp
        ref_off = np.abs(_f64(ref.b) - x) / ulp
        assert port_off.max() <= ref_off.max() + 1
        assert port_off.mean() <= 1.1 * ref_off.mean() + 1e-3


def test_one_outer_merge_matches_jax(start, monkeypatch):
    jgp, jst = start["jgp"], start["jst"]
    jp2, js2 = jsub.outer_merge_resample(jgp, jst, start["jtcfg"])
    new_v = [np.asarray(s.proj) for s in js2.groups]
    queue = []
    if start["case"][2] == "bfloat16":
        _, skey = jax.random.split(jst.key)
        queue = [np.asarray(jsub._sr_bits(skey, jst.outer_step, g, w.shape)
                            ).astype(np.int32)
                 for g, w in enumerate(jgp.groups)]
    gp, st = _port_state(start)
    _inject_bits(monkeypatch, queue)
    monkeypatch.setattr(
        subspace, "_sample_proj_group",
        lambda name, gen, spec, n, c, dtype, device, energy=None:
        torch.from_numpy(np.array(new_v.pop(0))).to(device, dtype))
    p2, s2 = subspace.outer_merge_resample(gp, st, start["tcfg"])
    assert not queue and not new_v
    assert int(s2.outer_step) == int(js2.outer_step) == 1
    for mine, ref in zip(p2.groups, jp2.groups):
        assert mine.dtype == getattr(torch, np.asarray(ref).dtype.name)
        if mine.dtype == torch.bfloat16:
            bf16_steps_close(mine, ref)
        else:
            _rel_close(mine, ref, 1e-5)
    for mine, ref in zip(s2.groups, js2.groups):
        np.testing.assert_array_equal(mine.proj.numpy(),
                                      np.asarray(ref.proj))
        assert mine.b.dtype == getattr(torch, start["case"][2])
        assert not mine.b.any()
        for f in ("m", "v"):
            got = getattr(mine, f)
            if isinstance(got, quant.QuantizedTensor):
                assert got.codec == getattr(ref, f).codec
                assert not got.q.any() and not got.scale.any()
            else:
                assert not got.any()
    assert all(a is b for a, b in zip(p2.groups, gp.groups))
