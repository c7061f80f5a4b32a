"""The port's encoder classifier and fine-tuning pieces against the JAX
package, on the CPU: ``models/encoder_cls.py`` (at a reduced size, 2
layers, d 128, weights carried by ``convert``), bidirectional
``blockwise_attention``, ``cls_ce`` and ``cls_accuracy``, the ``cls``
data source (by its law: threefry and torch's generators differ) and one
``lowrank_lr`` fine-tuning step with the reference's noise injected.

Tolerances, fp32 with sums in other orders: logits and attention
outputs within 1e-5 of their largest magnitude; the loss and accuracy
within 1e-6 relative; the step's loss within 1e-5 relative, its B,
moments and dense leaves within 1e-5 of each buffer's largest magnitude
(a two-point step scales the noise by one number). Planted faults fail
the forward's and the step's checks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import classification_batch as jcls  # noqa
from repro.models import attention as jattn  # noqa: E402
from repro.models import encoder_cls as jenc  # noqa: E402
from repro.optim import subspace as jsub  # noqa: E402
from repro.optim import zo as jzo  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import (StatelessLoader,  # noqa: E402
                                        classification_batch)
from repro_torch.models import attention, encoder_cls  # noqa: E402
from repro_torch.optim import subspace, zo  # noqa: E402
from repro_torch.train import loss as tloss  # noqa: E402

SMALL = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512)
CFG = get_config("encoder-small").replace(**SMALL)
JCFG = jget_config("encoder-small").replace(**SMALL)
N_CLASSES = 4
# the fine-tuning recipe of the reference's table (rank 4, min dim 64)
FT = dict(optimizer="lowrank_lr", sampler="stiefel", rank=4, lazy_k=50,
          lr=2e-4, zo_sigma=1e-2, schedule="constant", warmup_steps=0,
          total_steps=200, min_dim_for_lowrank=64, weight_decay=0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = got.detach().double().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


@pytest.fixture(scope="module")
def weights():
    jp = jenc.init_params(JCFG, N_CLASSES, jax.random.key(0))
    return jp, convert.encoder_params_from_numpy(_np(jp), CFG, N_CLASSES,
                                                 device="cpu")


def _check_forward(weights):
    jp, p = weights
    b = jcls(3, 1, batch=4, seq_len=96, vocab=CFG.vocab_size,
             n_classes=N_CLASSES)
    want = jax.jit(lambda pp, t: jenc.forward(pp, t, JCFG))(jp, b["tokens"])
    got = encoder_cls.forward(p, _t(b["tokens"]), CFG)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_encoder_forward_matches_jax(weights):
    _check_forward(weights)


def test_encoder_tree_is_checked_against_the_specs(weights):
    jp, p = weights
    specs = encoder_cls.param_specs(CFG, N_CLASSES)
    assert set(p) == set(specs) == {"embed", "layers", "final_norm",
                                    "head"}
    assert p["head"].dtype == torch.float32 and p["embed"]["pos"].shape == (
        encoder_cls.POS_LEN, 128)
    with pytest.raises(ValueError, match="does not fit"):
        convert.encoder_params_from_numpy(_np(jp), CFG, N_CLASSES + 1,
                                          device="cpu")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,skv", [(48, 48), (40, 72)])
def test_blockwise_attention_matches_jax(causal, sq, skv):
    """Bidirectional and causal, with lengths off the chunks (padded
    queries sliced off, padded keys masked)."""
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=32, kv_chunk=32)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention.blockwise_attention(*map(_t, (q, k, v)), **kw)
    _close(got, want, 1e-5)


def test_bidirectional_attention_sees_later_keys():
    """Changing the last key moves the first query's output only when
    the attention is bidirectional."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 4), generator=gen) for _ in range(3))
    k2 = k.clone()
    k2[:, -1] += 1.0
    for causal, moves in ((False, True), (True, False)):
        a = attention.blockwise_attention(q, k, v, causal=causal)
        b = attention.blockwise_attention(q, k2, v, causal=causal)
        assert (not torch.equal(a[:, 0], b[:, 0])) == moves


def test_cls_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(16, N_CLASSES)).astype(np.float32) * 3
    labels = rng.integers(0, N_CLASSES, size=16).astype(np.int32)
    for f, jf in ((tloss.cls_ce, jloss.cls_ce),
                  (tloss.cls_accuracy, jloss.cls_accuracy)):
        want = float(jf(jnp.asarray(logits), jnp.asarray(labels)))
        got = float(f(_t(logits), _t(labels)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30)


@pytest.mark.parametrize("seed,step", [(0, 0), (5, 9)])
def test_classification_batch_follows_the_reference_law(seed, step):
    """Labels in range; a token lies in its class's slice with
    probability 0.7 + 0.3 / n_classes (0.775), held within six binomial
    standard deviations in both packages."""
    kw = dict(batch=64, seq_len=256, vocab=1024, n_classes=N_CLASSES)
    p = 0.7 + 0.3 / N_CLASSES
    for b in (_np(jcls(seed, step, **kw)),
              classification_batch(seed, step, device="cpu", **kw)):
        toks, y = np.asarray(b["tokens"]), np.asarray(b["labels"])
        assert toks.shape == (64, 256) and y.shape == (64,)
        assert toks.dtype == y.dtype == np.int32
        assert toks.min() >= 0 and toks.max() < 1024
        assert y.min() >= 0 and y.max() < N_CLASSES
        share = (toks // (1024 // N_CLASSES) == y[:, None]).mean()
        assert abs(share - p) <= 6 * (p * (1 - p) / toks.size) ** 0.5
    loader = StatelessLoader("cls", seed, device="cpu", **kw)
    assert torch.equal(loader(step)["tokens"],
                       classification_batch(seed, step, device="cpu",
                                            **kw)["tokens"])


def _loss_fn(packed, b):
    return tloss.cls_ce(encoder_cls.forward(packed, b["tokens"], CFG),
                        b["labels"])


@pytest.fixture(scope="module")
def jax_ft_step(weights):
    """One reference ``lowrank_lr`` step on the encoder from its init: the
    state before, the batch, the noise it drew and its results."""
    jp, _ = weights
    jtcfg = JTrainConfig(**FT)
    jgp, jst = jsub.init_grouped(jp, jtcfg, jax.random.key(8))
    jbatch = jcls(0, 2, batch=4, seq_len=64, vocab=CFG.vocab_size,
                  n_classes=N_CLASSES)

    def jloss_fn(packed, b):
        return jloss.cls_ce(jenc.forward(packed, b["tokens"], JCFG),
                            b["labels"])

    key = jax.random.fold_in(jst.key, jst.step)
    out = jax.jit(lambda p, st, b, k: jzo.zo_inner_step(
        jloss_fn, p, st, b, k, lr=FT["lr"], tcfg=jtcfg))(
        jgp, jst, jbatch, key)
    return jgp, jst, jbatch, jzo._sample_noise(jst, key), out


def _check_ft_step(jax_ft_step, monkeypatch):
    jgp, jst, jbatch, noise, (jl, jp2, js2, _) = jax_ft_step
    tcfg = TrainConfig(**FT)
    queue = [noise]
    monkeypatch.setattr(zo, "_sample_noise", lambda state: subspace.Trainable(
        dense=tuple(map(_t, queue[0].dense)),
        groups=tuple(map(_t, queue.pop(0).groups))))
    gp, st = convert.subspace_from_numpy(
        _np(jsub.params_of(jgp)), tcfg, groups=_np(jst.groups),
        dense=_np(jst.dense), device="cpu")
    assert [g.shape for g in st.layout.groups] == [
        g.shape for g in jst.layout.groups]
    loss, p2, s2, _ = zo.zo_inner_step(
        _loss_fn, gp, st, {k: _t(v) for k, v in jbatch.items()},
        lr=FT["lr"], tcfg=tcfg)
    assert not queue
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for mine, ref in zip(s2.groups, js2.groups):
        for f in ("b", "m", "v"):
            _close(getattr(mine, f), getattr(ref, f), 1e-5)
    for mine, ref in zip(p2.dense, jp2.dense):
        _close(mine, ref, 1e-5)


def test_one_lowrank_lr_finetune_step_matches_jax(jax_ft_step,
                                                  monkeypatch):
    _check_ft_step(jax_ft_step, monkeypatch)


def test_planted_fault_causal_encoder_fails_the_forward(weights,
                                                        monkeypatch):
    orig = encoder_cls.dense_block
    monkeypatch.setattr(encoder_cls, "dense_block",
                        lambda h, p, cfg, causal: orig(h, p, cfg,
                                                       causal=True))
    with pytest.raises(AssertionError):
        _check_forward(weights)


def test_planted_fault_scaled_logits_fail_the_step(jax_ft_step,
                                                   monkeypatch):
    orig = encoder_cls.forward
    monkeypatch.setattr(encoder_cls, "forward",
                        lambda p, t, cfg: orig(p, t, cfg) * 1.01)
    with pytest.raises(AssertionError):
        _check_ft_step(jax_ft_step, monkeypatch)
