"""Temperature / top-k sampled decoding in the port's serving engine
(``repro_torch.serve.sampling``, ``EngineConfig.temperature``,
``top_k``, ``sample_seed``), on llama-tiny reduced, fp32, on the CPU.

* ``select_tokens`` with the reference's Gumbel noise injected (drawn by
  ``jax.random.gumbel`` under the key the JAX engine splits each step)
  picks ``jax.random.categorical``'s token; the port's engine fed that
  noise gives the JAX engine's sampled tokens.
* The support of a draw is exactly the kept set, ties with the k-th
  largest included; over many draws each token's frequency is within
  ``Z`` = 5 standard deviations of ``softmax(logits / T)`` restricted to
  the kept set.
* The same seed gives the same tokens; ``top_k = 1`` gives the greedy
  tokens; a snapshot taken mid-sampling restores into an engine that
  continues the same draws; greedy decoding (``temperature = 0``, the
  default) draws no noise and gives the argmax of the teacher-forced
  logits.

The card test of a sampled decode step, which imports no JAX, is in
``tests/test_torch_hybrid_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.sampling import gumbel_noise, select_tokens  # noqa

Z = 5.0
MIN_GAP = 1e-4


def _model():
    jcfg = jget_config("llama-tiny").reduced()
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    return SimpleNamespace(
        cfg=get_config("llama-tiny").reduced(), jcfg=jcfg, jparams=jparams,
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu"))


M = _model()


def _ecfg(**over):
    base = dict(page_size=4, max_batch=2, max_len=24, max_out=8)
    base.update(over)
    return base


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, M.cfg.vocab_size, (n,)).astype(np.int32)


REQS = (("a", 5, 6), ("b", 3, 7), ("c", 4, 5))


def _run(eng, R=Request):
    for i, (rid, n, new) in enumerate(REQS):
        eng.submit(R(rid, _prompt(n, 40 + i), new))
    return eng.run()


def _engine(**over):
    return Engine(M.params, M.cfg, engine_cfg=EngineConfig(**_ecfg(**over)),
                  device="cpu")


def _reference_scaled(logits, temperature, top_k):
    """The reference engine's scaled, masked logits (jnp)."""
    scaled = jnp.asarray(logits, jnp.float32) / temperature
    if 0 < top_k < scaled.shape[-1]:
        kth = jax.lax.top_k(scaled, top_k)[0][:, -1:]
        scaled = jnp.where(scaled >= kth, scaled, -jnp.inf)
    return scaled


# (temperature, top_k)
CASES = [(1.0, 0), (0.7, 0), (1.3, 5), (0.5, 1), (2.0, 50)]


@pytest.mark.parametrize("temperature,top_k", CASES)
def test_selection_with_the_reference_noise_picks_its_token(temperature,
                                                            top_k):
    rng = np.random.default_rng(int(10 * temperature) + top_k)
    logits = (3.0 * rng.standard_normal((4, 512))).astype(np.float32)
    key = jax.random.key(7)
    for _ in range(5):
        key, sub = jax.random.split(key)
        noise = jax.random.gumbel(sub, logits.shape, jnp.float32)
        scaled = _reference_scaled(logits, temperature, top_k)
        want = np.asarray(jax.random.categorical(sub, scaled, axis=-1))
        # categorical is Gumbel-max under the same key
        np.testing.assert_array_equal(
            np.asarray(jnp.argmax(scaled + noise, axis=-1)), want)
        got = select_tokens(torch.tensor(logits), temperature, top_k,
                            torch.tensor(np.asarray(noise)))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_engine_fed_the_reference_noise_gives_its_sampled_tokens(
        monkeypatch):
    """The JAX engine samples with ``jax.random.categorical`` under its
    split key; the port's engine, its Gumbel draws replaced by the
    reference's noise under the same keys, gives the same tokens."""
    ecfg = _ecfg(temperature=0.9, top_k=40, sample_seed=11)
    jout = _run(JEngine(M.jparams, M.jcfg, engine_cfg=JEngineConfig(**ecfg)),
                JRequest)
    key = [jax.random.key(11)]
    gaps = []

    def reference_noise(gen, shape):
        key[0], sub = jax.random.split(key[0])
        return torch.tensor(np.asarray(
            jax.random.gumbel(sub, tuple(shape), jnp.float32)))

    def select(logits, temperature, top_k, noise):
        scaled = logits.float() / temperature
        kth = torch.topk(scaled, top_k).values[:, -1:]
        score = torch.where(scaled >= kth, scaled, float("-inf")) + noise
        top = torch.topk(score, 2).values
        gaps.append((top[:, 0] - top[:, 1]).min().item())
        return select_tokens(logits, temperature, top_k, noise)
    monkeypatch.setattr(engine_mod, "gumbel_noise", reference_noise)
    monkeypatch.setattr(engine_mod, "select_tokens", select)
    tout = _run(Engine(M.params, M.cfg, engine_cfg=EngineConfig(**ecfg),
                       device="cpu"))
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    # no sampled step was a near tie (the two packages' fp32 logits differ
    # in their last bits)
    assert gaps and min(gaps) > MIN_GAP


def test_support_is_exactly_the_kept_set_ties_included():
    row = torch.full((64,), -2.0)
    row[:6] = torch.tensor([3.0, 2.5, 2.5, 2.5, 1.0, 0.5])
    gen = torch.Generator()
    gen.manual_seed(0)
    for top_k, kept in ((2, {0, 1, 2, 3}), (4, {0, 1, 2, 3}),
                        (5, {0, 1, 2, 3, 4}), (1, {0})):
        rows = row.expand(4000, -1)
        got = select_tokens(rows, 1.0, top_k,
                            gumbel_noise(gen, rows.shape))
        assert set(got.tolist()) == kept, top_k


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.6, 8),
                                               (1.7, 3)])
def test_frequencies_match_the_tempered_softmax(temperature, top_k):
    rng = np.random.default_rng(3)
    row = torch.tensor(rng.standard_normal(32).astype(np.float32))
    n = 40000
    gen = torch.Generator()
    gen.manual_seed(int(100 * temperature) + top_k)
    rows = row.expand(n, -1)
    got = select_tokens(rows, temperature, top_k,
                        gumbel_noise(gen, rows.shape))
    freq = torch.bincount(got, minlength=32).double() / n
    scaled = row.double() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k).values[-1]
        scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    p = torch.softmax(scaled, dim=0)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert (freq[p == 0] == 0).all()
    assert ((freq - p).abs() <= Z * sigma + 1e-12).all()


def test_same_seed_same_tokens_and_top_k_one_is_greedy():
    a = _run(_engine(temperature=1.0, sample_seed=5))
    b = _run(_engine(temperature=1.0, sample_seed=5))
    c = _run(_engine(temperature=1.0, sample_seed=6))
    greedy = _run(_engine())
    top1 = _run(_engine(temperature=1.0, top_k=1, sample_seed=5))
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
        np.testing.assert_array_equal(top1[rid], greedy[rid])
    # sampling at T = 1 on a random model's logits leaves the greedy path,
    # and another seed draws other tokens
    assert any(not np.array_equal(a[r], greedy[r]) for r in a)
    assert any(not np.array_equal(a[r], c[r]) for r in a)


def test_snapshot_mid_sampling_continues_the_same_draws(tmp_path):
    over = dict(temperature=0.8, top_k=20, sample_seed=9)
    base = _run(_engine(**over))
    eng = _engine(**over)
    for i, (rid, n, new) in enumerate(REQS):
        eng.submit(Request(rid, _prompt(n, 40 + i), new))
    for _ in range(3):
        eng.step()
    snap = str(tmp_path / "snap")
    eng.snapshot(snap)
    eng2 = Engine.restore(snap, M.params, M.cfg, device="cpu")
    assert eng2.ecfg == eng.ecfg
    assert torch.equal(eng2._gen.get_state(), eng._gen.get_state())
    out = eng2.run()
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])


def test_greedy_draws_no_noise_and_takes_the_argmax():
    eng = _engine()
    before = eng._gen.get_state()
    out = _run(eng)
    assert torch.equal(eng._gen.get_state(), before)
    for i, (rid, n, new) in enumerate(REQS):
        seq = _prompt(n, 40 + i)
        for t in range(new):
            st = lm.alloc_decode_state(M.cfg, 1, len(seq), device="cpu")
            lg, _ = lm.prefill(M.params, torch.as_tensor(seq[None]), M.cfg,
                               st)
            nxt = int(torch.argmax(lg[0, -1]))
            assert out[rid][t] == nxt
            seq = np.append(seq, np.int32(nxt))
