"""Training checkpoints cross between the port and the JAX package.

For every method, and ``lowrank_adam``/``lowrank_lion`` at every state
and master dtype, on llama-tiny reduced to one layer:

* a checkpoint the JAX ``Trainer`` wrote (for the five dtype
  combinations of :data:`CASES` outside :data:`TRAINED`, the
  reference's re-save of a port checkpoint) restores in the port's, and
  the port writes it back with the same record names, shapes, dtypes,
  CRCs and ``quant`` tags (the port's generator record ``opt||gen`` aside,
  and ``opt||key``, which the port derives from its generator);
* a checkpoint the port's ``Trainer`` wrote restores through
  ``repro.train.checkpoint.restore_latest`` without a quarantine, and
  every record the reference reads back equals the port's byte for byte;
* a port resume from a JAX checkpoint tracks the JAX ``Trainer`` to the
  next resample within 1e-5 relative per loss (the reference's
  stochastic-rounding bits and ZO noise injected, as the training
  parity tests do: the generators cannot agree bit for bit);
* the fp32 <-> int8 state migration gives the reference's arrays (the
  int8 direction within ``quant_close``, the int8 state parity
  criterion: XLA's CPU division by 127 may round a scale's last bit
  otherwise);
* ``convert``'s ``*_to_numpy`` inverts ``*_from_numpy``.

Planted faults (bf16 written as uint16, ``opt||key`` left out) must
fail the cross checks.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import StatelessLoader as JLoader  # noqa: E402
from repro.optim import quant as jquant  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.optim import zo as jzo  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.optim import quant, subspace, zo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_parity import (SAVED, _npz, assert_reference_restores,  # noqa
                           assert_same_format, quant_close)

CFG = get_config("llama-tiny").reduced().replace(num_layers=1)
JCFG = jget_config("llama-tiny").reduced().replace(num_layers=1)
BASE = dict(rank=4, min_dim_for_lowrank=32, lazy_k=4, lr=3e-3,
            warmup_steps=0, total_steps=100, schedule="constant")
BATCH = dict(batch=2, seq_len=32, vocab=CFG.vocab_size)
CASES = {
    "adam": dict(optimizer="lowrank_adam"),
    "adam_int8": dict(optimizer="lowrank_adam", state_dtype="int8"),
    "adam_bf16": dict(optimizer="lowrank_adam", master_dtype="bfloat16"),
    "adam_int8_bf16": dict(optimizer="lowrank_adam", state_dtype="int8",
                           master_dtype="bfloat16"),
    "lion": dict(optimizer="lowrank_lion", beta2=0.99),
    "lion_int8": dict(optimizer="lowrank_lion", beta2=0.99,
                      state_dtype="int8"),
    "lion_bf16": dict(optimizer="lowrank_lion", beta2=0.99,
                      master_dtype="bfloat16"),
    "lion_int8_bf16": dict(optimizer="lowrank_lion", beta2=0.99,
                           state_dtype="int8", master_dtype="bfloat16"),
    "dependent_diag": dict(optimizer="lowrank_adam",
                           sampler="dependent_diag"),
    "galore": dict(optimizer="galore"),
    "adamw": dict(optimizer="adamw"),
    "lowrank_lr": dict(optimizer="lowrank_lr"),
}
# the cases a JAX Trainer trains (the others' JAX checkpoints are the
# reference's re-saves of the port's)
TRAINED = ("adam", "adam_int8_bf16", "lion_int8_bf16", "dependent_diag",
           "galore", "adamw", "lowrank_lr")


def _t(a):
    return torch.from_numpy(np.array(a))


def _kw(case):
    return dict(BASE, **CASES[case])


def _jloader():
    return JLoader("lm", 0, **BATCH)


def _port_loader(jloader):
    return lambda s: {k: _t(v) for k, v in jloader(s).items()}


def _injections(st, kw):
    """What the port's step at JAX state ``st`` must be fed: the
    reference's stochastic-rounding bits (bf16 masters) and ZO noise."""
    bits = noise = None
    if kw.get("master_dtype") == "bfloat16":
        bits = [np.asarray(jsub._sr_bits(st.key, st.step, g, s.b.shape))
                .astype(np.int32) for g, s in enumerate(st.groups)]
    if kw["optimizer"] == "lowrank_lr":
        z = jzo._sample_noise(st, jax.random.fold_in(st.key, st.step))
        noise = ([np.asarray(d) for d in z.dense],
                 [np.asarray(g) for g in z.groups])
    return bits, noise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case, built once: a port checkpoint at step 2 and a JAX one.
    For the cases of :data:`TRAINED` the JAX one is the JAX Trainer's,
    with its losses and injections from there to the next resample; for
    the other dtype combinations it is the reference's re-save of what
    it restored from the port's checkpoint."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        kw = _kw(case)
        root = tmp_path_factory.mktemp(case)
        jwd, pwd = str(root / "jax"), str(root / "port")
        Trainer(CFG, TrainConfig(**kw), _port_loader(_jloader()), pwd,
                checkpoint_every=SAVED, device="cpu").run(SAVED)
        jt = JTrainer(JCFG, JTrainConfig(**kw), _jloader(), workdir=jwd,
                      checkpoint_every=SAVED)
        losses, feed = [], []
        if case in TRAINED:
            jt.run(SAVED)
            jt.workdir = None
            for _ in range(BASE["lazy_k"] - SAVED):
                feed.append(_injections(jt.opt_state, kw))
                losses += jt.run(1).losses
        else:
            tree, man = jckpt.restore(pwd, SAVED, {"params": jt.params,
                                                   "opt": jt.opt_state})
            jckpt.save(jwd, SAVED, tree, extra=man["extra"])
        cache[case] = dict(kw=kw, jwd=jwd, pwd=pwd, losses=losses,
                           feed=feed, jtemplate={"params": jt.params,
                                                 "opt": jt.opt_state})
        return cache[case]

    return get


def _copy(src, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def _port_trainer(kw, wd):
    return Trainer(CFG, TrainConfig(**kw), _port_loader(_jloader()), wd,
                   device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_restores_in_the_port(case, runs, tmp_path):
    run = runs(case)
    jwd = _copy(run["jwd"], tmp_path, "jax")
    tr = _port_trainer(run["kw"], jwd)
    assert tr.maybe_resume() == SAVED and tr.step == SAVED
    assert not [n for n in os.listdir(jwd) if n.endswith(".corrupt")]
    assert all(t.device.type == "cpu" for t in ckpt.tensors(tr._template()))
    out = str(tmp_path / "again")
    ckpt.save(out, SAVED, tr._template())
    assert_same_format(jwd, out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_restores_through_the_reference(case, runs,
                                                        tmp_path):
    run = runs(case)
    pwd = _copy(run["pwd"], tmp_path, "port")
    assert_reference_restores(pwd, run["jtemplate"],
                              run["kw"]["optimizer"])
    # and the port reads its own back bit for bit, generator included
    tr = _port_trainer(run["kw"], pwd)
    assert tr.maybe_resume() == SAVED
    out = str(tmp_path / "again")
    ckpt.save(out, SAVED, tr._template())
    pm, om = ckpt.read_manifest(pwd, SAVED), ckpt.read_manifest(out, SAVED)
    assert pm["crc"] == om["crc"] and pm["dtypes"] == om["dtypes"]


@pytest.mark.parametrize("case", TRAINED)
def test_resume_tracks_the_jax_trainer_to_the_next_resample(
        case, runs, tmp_path, monkeypatch):
    run = runs(case)
    feed = list(run["feed"])
    bits_q, noise_q = [], []

    def injected_bits(gen, shape, device):
        b = bits_q.pop(0)
        assert tuple(shape) == b.shape
        return _t(b).to(device)

    def injected_noise(state):
        dense, groups = noise_q.pop(0)
        return subspace.Trainable(dense=tuple(map(_t, dense)),
                                  groups=tuple(map(_t, groups)))

    monkeypatch.setattr(subspace, "_sr_bits", injected_bits)
    monkeypatch.setattr(zo, "_sample_noise", injected_noise)
    tr = _port_trainer(run["kw"], _copy(run["jwd"], tmp_path, "jax"))
    losses = []
    for s in range(len(feed)):
        bits, noise = feed[s]
        bits_q[:] = bits or []
        noise_q[:] = [noise] if noise is not None else []
        rep = tr.run(1)
        tr.workdir = None            # resume once, then keep going
        assert s or rep.resumed_from == SAVED
        losses += rep.losses
        assert not bits_q and not noise_q
    assert tr.step == BASE["lazy_k"] and rep.outer_steps == 0
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)


@pytest.mark.parametrize("src,dst", [("adam_int8_bf16", "adam"),
                                     ("adam", "adam_int8"),
                                     ("lion_int8_bf16", "lion")])
def test_state_dtype_migration_gives_the_reference_arrays(src, dst, runs,
                                                          tmp_path):
    """A checkpoint of one state dtype restored into a template of the
    other: the port's moments equal the reference's migration."""
    run, target = runs(src), runs(dst)
    jwd = run["jwd"]
    want, _ = jckpt.restore(jwd, SAVED, target["jtemplate"])
    tr = _port_trainer(target["kw"], _copy(jwd, tmp_path, "jax"))
    got, _ = ckpt.restore(jwd, SAVED, tr._template())
    for mine, ref in zip(got["opt"].groups, want["opt"].groups):
        for f in ("m", "v"):
            a, b = getattr(mine, f), getattr(ref, f)
            if quant.is_quantized(a):
                # XLA's CPU division by 127 can round the last bit of a
                # scale otherwise: the int8 state parity criterion
                assert isinstance(b, jquant.QuantizedTensor)
                quant_close(a, b)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_masters_are_void_records_tagged_bfloat16(runs):
    run = runs("adam_int8_bf16")
    man = ckpt.read_manifest(run["pwd"], SAVED)
    rec = _npz(run["pwd"])["opt||groups||0||b"]
    assert rec.dtype == np.dtype("V2")
    assert man["dtypes"]["opt||groups||0||b"] == "bfloat16"
    assert _npz(run["jwd"])["opt||groups||0||b"].dtype == np.dtype("V2")
    b = ckpt.from_record(rec, "bfloat16")
    assert b.dtype == torch.bfloat16
    assert convert.to_numpy(b).tobytes() == rec.tobytes()
    with pytest.raises(IOError):
        ckpt.from_record(rec, None)


def test_planted_faults_fail_the_cross_checks(runs, tmp_path,
                                              monkeypatch):
    """bf16 written as uint16, or ``opt||key`` left out, must fail the
    checks above (the reference would read wrong values, or quarantine
    a good checkpoint)."""
    run = runs("adam_int8_bf16")
    tr = _port_trainer(run["kw"], _copy(run["pwd"], tmp_path, "port"))
    tr.maybe_resume()
    real = ckpt.to_numpy
    with monkeypatch.context() as mp:
        mp.setattr(ckpt, "to_numpy", lambda t: real(t).view(np.uint16)
                   if t.dtype == torch.bfloat16 else real(t))
        bad = str(tmp_path / "uint16")
        ckpt.save(bad, SAVED, tr._template(),
                  extra={"method": "lowrank_adam"})
    with pytest.raises(AssertionError):
        assert_reference_restores(bad, run["jtemplate"], "lowrank_adam")
    real_flatten = ckpt._flatten

    def without_key(tree):
        flat, names, qtags = real_flatten(tree)
        del flat["opt||key"], names["opt||key"]
        return flat, names, qtags

    with monkeypatch.context() as mp:
        mp.setattr(ckpt, "_flatten", without_key)
        nokey = str(tmp_path / "nokey")
        ckpt.save(nokey, SAVED, tr._template())
    with pytest.raises(AssertionError):
        assert_reference_restores(nokey, run["jtemplate"], "lowrank_adam")


@pytest.mark.parametrize("case", ["adam_int8_bf16", "galore", "adamw"])
def test_convert_to_numpy_inverts_from_numpy(case):
    kw = _kw(case)
    tcfg = TrainConfig(**kw)
    tr = Trainer(CFG, tcfg, _port_loader(_jloader()), device="cpu")
    tr.run(2)
    if case == "adamw":
        rec = convert.adamw_to_numpy(tr.params, tr.opt_state)
        p2, s2 = convert.adamw_from_numpy(device="cpu", **rec)
    elif case == "galore":
        rec = convert.galore_to_numpy(tr.params, tr.opt_state)
        p2, s2 = convert.galore_from_numpy(tcfg=tcfg, device="cpu", **rec)
        assert s2.host_step == tr.opt_state.host_step == 2
    else:
        rec = convert.subspace_to_numpy(tr.params, tr.opt_state)
        p2, s2 = convert.subspace_from_numpy(tcfg=tcfg, device="cpu", **rec)
    a = ckpt.records({"params": tr.params, "opt": tr.opt_state})
    b = ckpt.records({"params": p2, "opt": s2})
    assert set(a) == set(b)
    for k in a:
        if not k.endswith(("||key", "||gen")):
            assert a[k].tobytes() == b[k].tobytes(), k
