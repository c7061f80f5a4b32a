"""The port's resilient training loop, driven by its chaos hooks.

Mirrors the reference's suite (``tests/test_resilience.py`` and the
checkpoint tests of ``tests/test_train.py``) on llama-tiny reduced:

* the health guard: an injected NaN or inf step is skipped with params,
  state and the state's generator bit-identical, for every method and
  for the compressed-state paths whose steps draw rounding bits; the
  guard is transparent when healthy (on and off bit for bit); its carry
  matches the reference's ``guard_inner_step`` to 1e-6 on one loss and
  grad-norm sequence; the spike detector skips a finite outlier;
* escalation: consecutive skips roll back (restore, LR backoff, reseed),
  and a spent budget stops the run with its last good state saved;
* checkpoints: a kill at every save site, torn writes, a truncation
  sweep, a flipped bit, a corrupt CRC entry, all steps corrupt, a
  method mismatch (raised, nothing quarantined), ``keep=0``, stale tmp
  directories, a crash while re-saving a step, a resume past a corrupt
  newest step and a bit-exact resume;
* SIGTERM drains and puts the handlers back, health counters carry
  across a resume, the ``REPRO_CHAOS`` grammar round-trips.

A planted fault (the generator not rewound on a skip) must fail the
skip check.  The ``cuda`` tests repeat the skip and resume checks on the
card and skip here; the module imports JAX only inside the one test that
holds the guard to the reference's, so the card runs the rest.
"""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import methods  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import StatelessLoader  # noqa: E402
from repro_torch.train import chaos, health  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import Trainer, rollback_seed  # noqa: E402

CFG = get_config("llama-tiny").reduced()
TEST_TIMEOUT_S = 300
# every registered method, and the compressed-state paths whose steps
# draw stochastic-rounding bits from the state's generator
PATHS = {name: dict(optimizer=name) for name in methods.available()}
PATHS.update({
    "lowrank_adam int8 bf16": dict(optimizer="lowrank_adam",
                                   state_dtype="int8",
                                   master_dtype="bfloat16"),
    "lowrank_lion int8 bf16": dict(optimizer="lowrank_lion",
                                   state_dtype="int8",
                                   master_dtype="bfloat16", beta2=0.99)})


def _tcfg(**kw):
    base = dict(optimizer="lowrank_adam", rank=4, lazy_k=5, lr=1e-3,
                warmup_steps=0, total_steps=100, min_dim_for_lowrank=32,
                weight_decay=0.0, schedule="constant", spike_warmup=1000)
    base.update(kw)
    return TrainConfig(**base)


def _loader(device="cpu"):
    return StatelessLoader("lm", 0, device=device, batch=2, seq_len=32,
                           vocab=CFG.vocab_size)


def _trainer(tcfg, workdir=None, device="cpu", **kw):
    return Trainer(CFG, tcfg, _loader(device), workdir, device=device, **kw)


def _records(tr) -> dict:
    """Every tensor of the trainer's params and state as bytes, the
    generator's state included (``opt||gen``)."""
    flat = ckpt.records({"params": tr.params, "opt": tr.opt_state})
    return {k: v.tobytes() for k, v in flat.items()}


@pytest.fixture(autouse=True)
def _timeout_and_chaos_hygiene():
    def boom(signum, frame):
        raise TimeoutError(f"resilience test exceeded {TEST_TIMEOUT_S}s")
    prev = signal.signal(signal.SIGALRM, boom)
    signal.alarm(TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
        chaos.uninstall()


# ---------------------------------------------------------------------------
# The guard: skip-step semantics, per method
# ---------------------------------------------------------------------------

def skip_leaves_state_bit_identical(tcfg, device="cpu", mode="nan"):
    """Step 0 accepted, step 1 poisoned: params, state and generator
    after step 1 equal those after step 0; step 2 is accepted again."""
    with chaos.injected(chaos.ChaosHook(grad_nan_steps=(1,),
                                        grad_mode=mode)):
        tr = _trainer(tcfg, device=device)
        assert tr.run(1).skipped_steps == 0
        before = _records(tr)
        rep = tr.run(1)
        assert rep.skipped_steps == 1 and rep.last_anomaly_step == 1
        assert not np.isfinite(rep.losses[0])
        after = _records(tr)
        assert after.keys() == before.keys()
        for k in before:
            assert after[k] == before[k], k
        assert bool(health.tree_all_finite((tr.params, tr.opt_state)))
        assert int(tr.health.total_skips) == 1
        assert int(tr.health.last_anomaly) == 1
        rep = tr.run(1)
        assert rep.skipped_steps == 0 and np.isfinite(rep.losses[0])
        assert int(tr.health.consec_skips) == 0
        assert _records(tr) != before


@pytest.mark.parametrize("path", sorted(PATHS))
def test_injected_nan_is_skipped_bit_identically(path):
    skip_leaves_state_bit_identical(_tcfg(**PATHS[path]))


def test_injected_inf_is_skipped_too():
    skip_leaves_state_bit_identical(_tcfg(), mode="inf")


def test_planted_fault_generator_not_rewound_fails_the_skip_check(
        monkeypatch):
    """Without the generator rewind a skipped bf16-master step leaves the
    generator advanced: the skip check must see it."""
    def no_rewind(self, batch, report):
        cand_p, cand_s, self.health, metrics = self._inner(
            self.params, self.opt_state, self.health, batch,
            self.guard_steps)
        self.guard_steps += 1
        hr = health.read_health(metrics)
        if hr.ok:
            self.params, self.opt_state = cand_p, cand_s
        else:
            report.skipped_steps += 1
            report.last_anomaly_step = self.step
        return hr.loss, hr.consec_skips

    monkeypatch.setattr(Trainer, "_guarded_step", no_rewind)
    with pytest.raises(AssertionError):
        skip_leaves_state_bit_identical(
            _tcfg(**PATHS["lowrank_adam int8 bf16"]))


@pytest.mark.parametrize("path", ["lowrank_adam", "lowrank_lr",
                                  "lowrank_adam int8 bf16"])
def test_guard_is_transparent_when_healthy(path):
    """With no anomaly a guarded run equals an unguarded one bit for
    bit: the guard only ever keeps or drops the candidate step."""
    on = _trainer(_tcfg(**PATHS[path], lazy_k=2))
    off = _trainer(_tcfg(**PATHS[path], lazy_k=2, health_guard=False))
    rep_on, rep_off = on.run(5), off.run(5)
    assert rep_on.losses == rep_off.losses
    assert rep_on.outer_steps == rep_off.outer_steps == 2
    assert _records(on) == _records(off)


def test_health_state_matches_the_reference_guard():
    """The same loss and grad-norm sequence through both guards: the
    carry and the packed readout agree to 1e-6, step by step."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import TrainConfig as JTrainConfig
    from repro.train import health as jhealth
    kw = dict(spike_warmup=3, spike_zscore=4.0)
    seq = [(2.0, 1.0), (1.9, 1.1), (1.95, 0.9), (1.8, 1.0), (1.85, 1.2),
           (40.0, 1.0), (1.7, float("nan")), (float("inf"), 1.0),
           (1.75, 0.8), (1.6, 1.0), (30.0, 2.0), (1.55, 0.7)]

    def step(p, s, batch):
        return p, s, {"loss": batch[0], "grad_norm": batch[1]}

    jguard = jax.jit(jhealth.guard_inner_step(step, JTrainConfig(**kw)))
    tguard = health.guard_inner_step(step, TrainConfig(**kw))
    jh, th = jhealth.init_health(), health.init_health("cpu")
    for i, (loss, gn) in enumerate(seq):
        _, _, jh, jm = jguard(0, 0, jh, (jnp.float32(loss), jnp.float32(gn)))
        _, _, th, tm = tguard(0, 0, th, (torch.tensor(loss),
                                         torch.tensor(gn)), i)
        jr, tr = jhealth.read_health(jm), health.read_health(tm)
        assert tr.ok == jr.ok and tr.consec_skips == jr.consec_skips, i
        for f in jhealth.HealthState._fields:
            a, b = float(getattr(th, f)), float(np.asarray(getattr(jh, f)))
            assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (i, f, a, b)
    assert int(th.total_skips) == 4 and int(th.seen) == len(seq)


def test_spike_detector_skips_finite_outlier():
    tcfg = _tcfg(spike_warmup=5, spike_zscore=4.0)
    with chaos.injected(chaos.ChaosHook(spike_scale_steps=(8,),
                                        spike_scale=50.0)):
        rep = _trainer(tcfg).run(12)
    assert rep.skipped_steps == 1
    assert rep.last_anomaly_step == 8
    assert rep.rollbacks == 0


# ---------------------------------------------------------------------------
# Escalation: rollback, LR backoff, reseed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", methods.available())
def test_consecutive_anomalies_rollback_backoff_reseed(tmp_path, name,
                                                       monkeypatch):
    tcfg = _tcfg(optimizer=name, max_consecutive_skips=2, max_rollbacks=3)
    wd = str(tmp_path / f"rb_{name}")
    reseeds = []
    method = methods.get(name)
    real = type(method).reseed

    def spy(self, params, opt_state, seed, tc):
        reseeds.append(seed)
        return real(self, params, opt_state, seed, tc)

    monkeypatch.setattr(type(method), "reseed", spy)
    with chaos.injected(chaos.ChaosHook(grad_nan_steps=(4, 5, 6))):
        tr = _trainer(tcfg, wd, checkpoint_every=2)
        rep = tr.run(12)
    assert rep.rollbacks == 1 and not rep.health_exhausted
    assert rep.skipped_steps >= 2
    assert reseeds == [rollback_seed(tcfg.seed, 1)]
    assert tr.tcfg.lr == pytest.approx(tcfg.lr * tcfg.rollback_backoff)
    assert rep.lr_backoffs == [pytest.approx(tcfg.lr *
                                             tcfg.rollback_backoff)]
    if hasattr(tr.opt_state, "gen"):
        assert tr.opt_state.gen.initial_seed() == rollback_seed(tcfg.seed, 1)
    assert rep.steps_run > 0 and np.isfinite(rep.losses[-1])
    man = ckpt.read_manifest(wd, ckpt.latest_step(wd))
    assert man["extra"]["health"]["rollbacks"] == 1
    assert man["extra"]["health"]["skips"] >= 2


def test_lowrank_reseed_runs_one_merge_and_draws_a_new_v():
    """The subspace reseed is an outer merge + resample from the fresh
    generator: W absorbs V Bᵀ, B is zeroed, V is redrawn."""
    tcfg = _tcfg()
    tr = _trainer(tcfg)
    tr.run(3)
    w0 = [w.clone() for w in tr.params.groups]
    v0 = [g.proj.clone() for g in tr.opt_state.groups]
    want = [w + g.proj @ g.b.mT for w, g in zip(w0, tr.opt_state.groups)]
    outer = int(tr.opt_state.outer_step)
    p, s = tr.method.reseed(tr.params, tr.opt_state, 7, tcfg)
    assert int(s.outer_step) == outer + 1
    for w, ref, g, v in zip(p.groups, want, s.groups, v0):
        torch.testing.assert_close(w, ref, rtol=1e-5, atol=1e-6)
        assert not g.b.any() and not torch.equal(g.proj, v)


def test_rollback_budget_exhausts_cleanly(tmp_path):
    tcfg = _tcfg(max_consecutive_skips=2, max_rollbacks=2)
    wd = str(tmp_path / "exhaust")
    with chaos.injected(chaos.ChaosHook(grad_nan_steps=tuple(range(2, 60)))):
        tr = _trainer(tcfg, wd, checkpoint_every=2)
        rep = tr.run(20)
    assert rep.health_exhausted and rep.rollbacks == 2
    assert rep.steps_run < 20
    assert bool(health.tree_all_finite((tr.params, tr.opt_state)))
    restored, _ = ckpt.restore_latest(wd, tr._template())
    assert restored is not None
    assert bool(health.tree_all_finite(restored))


def test_guard_disabled_runs_the_plain_path():
    rep = _trainer(_tcfg(health_guard=False)).run(3)
    assert len(rep.losses) == 3 and np.all(np.isfinite(rep.losses))
    assert rep.skipped_steps == 0


# ---------------------------------------------------------------------------
# Checkpoint durability
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(64, generator=g),
            "b": torch.randn(16, 16, generator=g).to(torch.bfloat16)}


def _equal(got, want):
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("site", chaos.SAVE_SITES)
def test_kill_during_save_never_loses_restorable_checkpoint(tmp_path, site):
    wd = str(tmp_path / "kill")
    t1, t2, t3 = _tree(1), _tree(2), _tree(3)
    ckpt.save(wd, 1, t1)
    with chaos.injected(chaos.ChaosHook(raise_in_save=site)):
        with pytest.raises(chaos.ChaosError):
            ckpt.save(wd, 2, t2)
    restored, man = ckpt.restore_latest(wd, t1)
    published = site == "save:post_rename"
    assert man["step"] == (2 if published else 1)
    _equal(restored, t2 if published else t1)
    ckpt.save(wd, 3, t3)
    assert ckpt.latest_step(wd) == 3
    assert not [n for n in os.listdir(wd) if n.endswith(".tmp")]


def test_torn_arrays_write_is_quarantined_not_fatal(tmp_path):
    wd = str(tmp_path / "torn")
    ckpt.save(wd, 1, _tree(1))
    with chaos.injected(chaos.ChaosHook(truncate_npz_at=10)):
        ckpt.save(wd, 2, _tree(2))
    restored, man = ckpt.restore_latest(wd, _tree(0))
    assert man["step"] == 1
    assert os.path.isdir(os.path.join(wd, "step_00000002.corrupt"))
    assert ckpt.all_steps(wd) == [1]


@pytest.mark.parametrize("offset_frac", [0.0, 0.01, 0.33, 0.66, 0.999])
def test_truncation_sweep_lands_on_newest_intact(tmp_path, offset_frac):
    wd = str(tmp_path / f"tr{offset_frac}")
    trees = {s: _tree(s) for s in (1, 2, 3)}
    for s, t in trees.items():
        ckpt.save(wd, s, t)
    path = os.path.join(wd, "step_00000003", "arrays.npz")
    os.truncate(path, int(os.path.getsize(path) * offset_frac))
    restored, man = ckpt.restore_latest(wd, _tree(0))
    assert man["step"] == 2
    _equal(restored, trees[2])
    assert os.path.isdir(os.path.join(wd, "step_00000003.corrupt"))


def test_single_bitflip_detected_and_walked_back(tmp_path):
    wd = str(tmp_path / "flip")
    ckpt.save(wd, 1, _tree(1))
    ckpt.save(wd, 2, _tree(2))
    path = os.path.join(wd, "step_00000002", "arrays.npz")
    chaos.flip_bit(path, os.path.getsize(path) // 2, bit=3)
    restored, man = ckpt.restore_latest(wd, _tree(0))
    assert man["step"] == 1
    assert os.path.isdir(os.path.join(wd, "step_00000002.corrupt"))


def test_corrupt_crc_entry_walks_back(tmp_path):
    wd = str(tmp_path / "crc")
    ckpt.save(wd, 1, _tree(1))
    ckpt.save(wd, 2, _tree(2))
    man_path = os.path.join(wd, "step_00000002", "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["crc"][sorted(man["crc"])[0]] ^= 0xDEADBEEF
    with open(man_path, "w") as f:
        json.dump(man, f)
    _, got = ckpt.restore_latest(wd, _tree(0))
    assert got["step"] == 1


def test_integrity_check_detects_rewritten_arrays(tmp_path):
    wd = str(tmp_path / "c2")
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    ckpt.save(wd, 1, tree)
    path = os.path.join(wd, "step_00000001", "arrays.npz")
    data = dict(np.load(path))
    data["a"] = data["a"] + 1
    np.savez(path, **data)
    with pytest.raises(IOError):
        ckpt.restore(wd, 1, tree)


def test_all_corrupt_returns_fresh_start(tmp_path):
    wd = str(tmp_path / "allbad")
    for s in (1, 2):
        ckpt.save(wd, s, _tree(1))
        os.truncate(os.path.join(wd, f"step_{s:08d}", "arrays.npz"), 8)
    restored, man = ckpt.restore_latest(wd, _tree(1))
    assert restored is None and man is None
    assert sorted(n for n in os.listdir(wd) if n.endswith(".corrupt")) == \
        ["step_00000001.corrupt", "step_00000002.corrupt"]


def test_cross_method_refusal_raises_and_quarantines_nothing(tmp_path):
    wd = str(tmp_path / "xmethod")
    ckpt.save(wd, 1, _tree(1), extra={"method": "lowrank_adam"})
    with pytest.raises(ckpt.MethodMismatchError):
        ckpt.restore_latest(wd, _tree(1), expect_method="adamw")
    assert ckpt.all_steps(wd) == [1]


def test_trainer_refuses_another_methods_checkpoint(tmp_path):
    wd = str(tmp_path / "xtrainer")
    _trainer(_tcfg(), wd, checkpoint_every=2).run(2)
    with pytest.raises(ckpt.MethodMismatchError):
        _trainer(_tcfg(optimizer="adamw"), wd).run(1)
    assert ckpt.all_steps(wd) == [2]


def test_keep_zero_keeps_all_and_keep_k_collects(tmp_path):
    wd = str(tmp_path / "keep0")
    for s in range(5):
        ckpt.save(wd, s, _tree(s), keep=0)
    assert ckpt.all_steps(wd) == [0, 1, 2, 3, 4]
    wd2 = str(tmp_path / "keep2")
    for s in range(6):
        ckpt.save(wd2, s, _tree(s), keep=2)
    assert ckpt.all_steps(wd2) == [4, 5]


def test_all_steps_ignores_corrupt_and_tmp(tmp_path):
    wd = str(tmp_path / "ignore")
    ckpt.save(wd, 1, _tree(1))
    ckpt.save(wd, 2, _tree(2))
    ckpt.quarantine(wd, 2)
    stale = os.path.join(wd, "step_00000009.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "manifest.json"), "w") as f:
        f.write("{}")
    assert ckpt.all_steps(wd) == [1] and ckpt.latest_step(wd) == 1


def test_stale_tmp_dirs_reaped_on_restore(tmp_path):
    wd = str(tmp_path / "stale")
    ckpt.save(wd, 1, _tree(1))
    for name in ("step_00000007.tmp", "step_00000003.replaced.tmp"):
        os.makedirs(os.path.join(wd, name))
    _, man = ckpt.restore_latest(wd, _tree(1))
    assert man["step"] == 1
    assert not [n for n in os.listdir(wd) if n.endswith(".tmp")]


def test_resave_same_step_crash_keeps_published(tmp_path):
    wd = str(tmp_path / "resave")
    t1 = _tree(1)
    ckpt.save(wd, 1, t1)
    with chaos.injected(chaos.ChaosHook(raise_in_save="save:pre_rename")):
        with pytest.raises(chaos.ChaosError):
            ckpt.save(wd, 1, _tree(2))
    restored, man = ckpt.restore_latest(wd, _tree(0))
    assert man["step"] == 1
    _equal(restored, t1)


def test_trainer_resumes_past_corrupt_newest(tmp_path):
    wd = str(tmp_path / "resume")
    _trainer(_tcfg(), wd, checkpoint_every=2, keep=0).run(6)
    path = os.path.join(wd, "step_00000006", "arrays.npz")
    os.truncate(path, os.path.getsize(path) // 3)
    rep2 = _trainer(_tcfg(), wd).run(2)
    assert rep2.resumed_from == 4
    assert np.all(np.isfinite(rep2.losses))
    assert os.path.isdir(os.path.join(wd, "step_00000006.corrupt"))


def resume_is_bit_exact(tcfg, wd, device="cpu"):
    """12 uninterrupted steps against 8 with checkpoints every 4 and a
    fresh trainer's 4 more: losses, params, state and generator equal."""
    tr1 = _trainer(tcfg, wd, device=device, checkpoint_every=4)
    rep1 = tr1.run(8)
    assert rep1.save_times and all(t > 0 for t in rep1.save_times)
    tr2 = _trainer(tcfg, wd, device=device)
    rep2 = tr2.run(4)
    assert rep2.resumed_from == 8 and rep2.resume_seconds > 0
    tr3 = _trainer(tcfg, device=device)
    rep3 = tr3.run(12)
    assert rep1.losses + rep2.losses == rep3.losses
    assert _records(tr2) == _records(tr3)


@pytest.mark.parametrize("path", ["lowrank_adam", "lowrank_adam int8 bf16",
                                  "lowrank_lr", "galore", "adamw"])
def test_checkpoint_resume_is_bit_exact(tmp_path, path):
    resume_is_bit_exact(_tcfg(**PATHS[path], lazy_k=3),
                        str(tmp_path / "ckpt"))


# ---------------------------------------------------------------------------
# Preemption, stragglers, handler hygiene, counters, the chaos grammar
# ---------------------------------------------------------------------------

def test_sigterm_drains_saves_tagged_and_restores_handlers(tmp_path):
    seen = []

    def sentinel(signum, frame):
        seen.append(signum)
    prev = signal.signal(signal.SIGTERM, sentinel)
    try:
        wd = str(tmp_path / "pre")
        with chaos.injected(chaos.ChaosHook(sigterm_at_step=3)):
            rep = _trainer(_tcfg(), wd).run(10)
        assert rep.preempted and rep.steps_run == 4
        assert ckpt.latest_step(wd) == 4
        assert ckpt.read_manifest(wd, 4)["extra"]["preempted"] is True
        assert signal.getsignal(signal.SIGTERM) is sentinel
        assert not seen
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_request_preemption_checkpoints_and_stops(tmp_path):
    wd = str(tmp_path / "c4")
    tr = _trainer(_tcfg(), wd)
    tr.request_preemption()
    rep = tr.run(10)
    assert rep.preempted and rep.steps_run == 1
    assert ckpt.latest_step(wd) == 1


def test_straggler_watchdog_fires():
    events = []
    _trainer(_tcfg(), straggler_factor=0.0,
             on_straggler=lambda *a: events.append(a)).run(10)
    assert len(events) == 3       # steps 8..10 are past the warm-up


def test_health_counters_roundtrip_across_resume(tmp_path):
    tcfg = _tcfg(max_consecutive_skips=10)
    wd = str(tmp_path / "counters")
    with chaos.injected(chaos.ChaosHook(grad_nan_steps=(1, 3))):
        rep = _trainer(tcfg, wd, checkpoint_every=5).run(5)
    assert rep.skipped_steps == 2
    man = ckpt.read_manifest(wd, ckpt.latest_step(wd))
    assert man["extra"]["health"]["skips"] == 2
    assert man["extra"]["health"]["rollbacks"] == 0
    assert man["extra"]["method"] == "lowrank_adam"
    assert man["extra"]["arch"] == CFG.name
    tr2 = _trainer(tcfg, wd, checkpoint_every=2)
    rep2 = tr2.run(2)
    assert rep2.resumed_health["skips"] == 2
    assert tr2._health_extra()["skips"] == 2


def test_chaos_env_spec_roundtrip(monkeypatch):
    hook = chaos.from_env("nan@3,4 ; sigterm@9; truncate@128")
    assert hook.grad_nan_steps == (3, 4) and hook.grad_mode == "nan"
    assert hook.sigterm_at_step == 9 and hook.truncate_npz_at == 128
    hook = chaos.from_env("inf@2;spike@5;raise@swap:pre_commit;"
                          "rownan@3:1;rowzero@2:0,5:1;pools@4,7;storm@5")
    assert hook.grad_mode == "inf" and hook.spike_scale_steps == (5,)
    assert hook.raise_in_swap == "swap:pre_commit"
    assert hook.logit_rows == ((3, 1, "nan"), (2, 0, "zero"),
                               (5, 1, "zero"))
    assert hook.pool_spike_steps == (4, 7)
    assert hook.deadline_storm_steps == (5,)
    assert chaos.from_env("") is None
    monkeypatch.setenv("REPRO_CHAOS", "raise@save:pre_rename")
    assert chaos.from_env().raise_in_save == "save:pre_rename"
    with pytest.raises(ValueError):
        chaos.from_env("frobnicate@2")
    with pytest.raises(ValueError):
        chaos.from_env("raise@save:nowhere")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# llama-tiny is an fp32 model: on the card it trains at fp32 compute
# (the kernels' SIMT route), as the 2-layer cuts of chip_smoke.py do
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["lowrank_adam", "lowrank_adam int8 bf16",
                                  "lowrank_lion int8 bf16", "lowrank_lr"])
def test_cuda_skip_leaves_state_bit_identical(cuda, path):
    skip_leaves_state_bit_identical(
        _tcfg(**PATHS[path], compute_dtype="float32"), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["lowrank_adam", "lowrank_adam int8 bf16"])
def test_cuda_checkpoint_resume_is_bit_exact(cuda, tmp_path, path):
    resume_is_bit_exact(
        _tcfg(**PATHS[path], lazy_k=3, compute_dtype="float32"),
        str(tmp_path / "ckpt"), device=cuda)
