"""The port's serving resilience: trained tenants, guarded swaps, the
serving chaos hooks, draining and snapshot/restore.

Mirrors the reference's suite (``tests/test_serving_resilience.py``) on
llama-tiny and mamba2-780m reduced, fp32 on the CPU:

* ``AdapterStore.load_tenant`` from a checkpoint the JAX package wrote
  and from one the port's ``Trainer`` wrote serves the tokens
  ``add_tenant`` gives with the same arrays; its refusals (a method
  without adapters, another arch, group drift, a flipped bit) leave the
  store byte-identical, and so does a crash at every swap site before
  the commit;
* a snapshot mid-decode restores into a fresh engine (and store) that
  finishes with the tokens of an uninterrupted engine, for both
  families; a chaos SIGTERM drains the engine into a snapshot, with the
  signal handlers put back; restore refuses another arch or a missing
  snapshot;
* the pool spike and the deadline storm drain without deadlock (the
  spike's greedy outputs equal the spike-free run's), a poisoned decode
  row quarantines only its tenant, ``EngineConfig.from_env`` reads the
  documented ``REPRO_SERVE_*`` knobs.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.serve import AdapterStore as JStore  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import StatelessLoader  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import (AdapterMismatchError, AdapterStore,  # noqa
                               Engine, EngineConfig, Request,
                               TenantQuarantinedError)
from repro_torch.train import chaos  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

CFG = get_config("llama-tiny").reduced()
MAMBA = get_config("mamba2-780m").reduced()
TCFG = TrainConfig(optimizer="lowrank_adam", rank=4, min_dim_for_lowrank=32,
                   total_steps=10, warmup_steps=0)
PARAMS = lm.init_params(CFG, seed=0, device="cpu")
TEST_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _timeout_and_chaos_hygiene():
    def boom(signum, frame):
        raise TimeoutError(f"serving resilience test exceeded "
                           f"{TEST_TIMEOUT_S}s (a deadlocked engine loop?)")
    prev = signal.signal(signal.SIGALRM, boom)
    signal.alarm(TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
        chaos.uninstall()


def _store(cfg=CFG, n=2):
    return AdapterStore(cfg, TCFG, max_tenants=n, device="cpu")


def _bs(store, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(b.shape[:-3] + b.shape[-2:])
            .astype(np.float32) for b in store.b_full]


def _projs(store, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(v.shape).astype(np.float32)
            for v in store.projs]


def _mk_store(cfg=CFG, n=2):
    store = _store(cfg, n)
    projs = _projs(store)
    for t in range(n):
        store.add_tenant(f"t{t}", _bs(store, 10 + t), projs)
    return store


def _ecfg(**over):
    return EngineConfig(**dict(dict(page_size=4, max_batch=2, max_len=24,
                                    max_out=8), **over))


def _prompt(n, seed, cfg=CFG):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n,)).astype(np.int32)


def _engine(store=None, cfg=CFG, params=PARAMS, **kw):
    return Engine(params, cfg, adapters=store,
                  engine_cfg=kw.pop("engine_cfg", _ecfg()), device="cpu",
                  **kw)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return eng.run()


def _store_bytes(store):
    return ([b.numpy().tobytes() for b in store.b_full],
            [v.numpy().tobytes() for v in store.projs],
            dict(store._tenants), store._proj_loaded)


def _save_adapter_ckpt(save, store, workdir, bs, projs, step=1,
                       method="lowrank_adam", arch=None, extra_group=False):
    """A checkpoint holding only (B, V) adapter groups, written by
    ``save`` (either package's ``checkpoint.save``)."""
    groups = {str(g): {"b": np.asarray(bs[g], np.float32),
                       "proj": np.asarray(projs[g], np.float32)}
              for g in range(len(store.layout.groups))}
    if extra_group:
        groups[str(len(groups))] = groups["0"]
    if save is ckpt.save:
        groups = {g: {k: torch.from_numpy(a) for k, a in d.items()}
                  for g, d in groups.items()}
    save(workdir, step, {"opt": {"groups": groups}},
         extra={"method": method, "arch": arch or store.cfg.name})


def _tokens(store, tenant="t1"):
    eng = _engine(store)
    return _run(eng, [Request("a", _prompt(4, 21), 6, tenant=tenant),
                      Request("b", _prompt(5, 22), 6, tenant="t0")])


# ---------------------------------------------------------------------------
# Trained tenants into the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_tenant_serves_what_add_tenant_serves(tmp_path, writer):
    store = _mk_store()
    bs, projs = _bs(store, 60), _projs(store)
    wd = str(tmp_path / writer)
    _save_adapter_ckpt(jckpt.save if writer == "jax" else ckpt.save, store,
                       wd, bs, projs)
    assert store.load_tenant("t1", wd) == store.tenant_index("t1")
    direct = _mk_store()
    direct.add_tenant("t1", bs, projs)
    assert _store_bytes(store) == _store_bytes(direct)
    loaded, want = _tokens(store), _tokens(direct)
    for rid in want:
        np.testing.assert_array_equal(loaded[rid], want[rid])


def test_load_tenant_from_a_port_training_checkpoint(tmp_path):
    """A tenant trained by the port's Trainer serves from its checkpoint
    with the tokens of ``add_tenant`` given its B and V."""
    wd = str(tmp_path / "trained")
    loader = StatelessLoader("lm", 0, device="cpu", batch=2, seq_len=16,
                             vocab=CFG.vocab_size)
    tr = Trainer(CFG, TCFG, loader, wd, checkpoint_every=3, device="cpu",
                 params=PARAMS)
    tr.run(3)
    store = _store(n=1)
    store.load_tenant("t0", wd)
    direct = _store(n=1)
    direct.add_tenant("t0", [g.b for g in tr.opt_state.groups],
                      [g.proj for g in tr.opt_state.groups])
    assert any(b.any() for b in store.b_full)
    assert _store_bytes(store) == _store_bytes(direct)
    a = _run(_engine(store), [Request("a", _prompt(4, 23), 6, tenant="t0")])
    b = _run(_engine(direct), [Request("a", _prompt(4, 23), 6, tenant="t0")])
    np.testing.assert_array_equal(a["a"], b["a"])


def test_the_reference_loads_a_port_training_checkpoint(tmp_path):
    """The reference's ``load_tenant`` takes the same port checkpoint and
    installs the same (B, V)."""
    wd = str(tmp_path / "trained")
    loader = StatelessLoader("lm", 0, device="cpu", batch=2, seq_len=16,
                             vocab=CFG.vocab_size)
    Trainer(CFG, TCFG, loader, wd, checkpoint_every=2, device="cpu",
            params=PARAMS).run(2)
    jstore = JStore(jget_config("llama-tiny").reduced(),
                    JTrainConfig(rank=4, min_dim_for_lowrank=32),
                    max_tenants=1)
    jstore.load_tenant("t0", wd)
    store = _store(n=1)
    store.load_tenant("t0", wd)
    for mine, ref in zip(store.b_full + store.projs,
                         jstore.b_full + jstore.projs):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["adamw", "galore", "arch", "drift",
                                  "bitflip", "missing"])
def test_load_tenant_refusals_leave_the_store_byte_identical(tmp_path, case):
    store = _mk_store()
    bs, projs = _bs(store, 70), _projs(store)
    wd = str(tmp_path / case)
    if case != "missing":
        _save_adapter_ckpt(
            ckpt.save, store, wd, bs, projs,
            method=case if case in ("adamw", "galore") else "lowrank_adam",
            arch="mamba2-780m" if case == "arch" else None,
            extra_group=case == "drift")
    if case == "bitflip":
        npz = os.path.join(wd, "step_00000001", "arrays.npz")
        chaos.flip_bit(npz, os.path.getsize(npz) // 2, 3)
    before = _store_bytes(store)
    errors = ckpt.CORRUPTION_ERRORS if case == "bitflip" \
        else AdapterMismatchError
    with pytest.raises(errors):
        store.load_tenant("t1", wd)
    assert _store_bytes(store) == before
    # negative control: a good checkpoint does change the bytes
    good = str(tmp_path / "good")
    _save_adapter_ckpt(ckpt.save, store, good, bs, projs)
    store.load_tenant("t1", good)
    assert _store_bytes(store) != before


@pytest.mark.parametrize("site", chaos.SWAP_SITES)
def test_swap_crash_sites_never_tear_the_store(site, tmp_path):
    store = _mk_store()
    before = _store_bytes(store)
    new_bs = _bs(store, 99)
    wd = str(tmp_path / "swap")
    _save_adapter_ckpt(ckpt.save, store, wd, new_bs, _projs(store))
    with chaos.injected(chaos.ChaosHook(raise_in_swap=site)):
        with pytest.raises(chaos.ChaosError):
            store.load_tenant("t1", wd)
    if site == "swap:post_commit":
        got = store.b_full[0][..., 1, :, :].numpy()
        np.testing.assert_array_equal(got, new_bs[0])
        assert store._tenants == before[2]
    else:
        assert _store_bytes(store) == before


# ---------------------------------------------------------------------------
# Snapshot / drain / warm restart
# ---------------------------------------------------------------------------

def _resume_requests(cfg):
    return [Request("a", _prompt(4, 51, cfg), 8, tenant="t0"),
            Request("b", _prompt(4, 52, cfg), 8, tenant="t1"),
            Request("c", _prompt(4, 53, cfg), 4, tenant="t0")]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_snapshot_restore_resumes_outputs_exactly(tmp_path, family):
    cfg = CFG if family == "dense" else MAMBA
    params = PARAMS if family == "dense" else \
        lm.init_params(MAMBA, seed=1, device="cpu")
    base = _run(_engine(_mk_store(cfg), cfg, params), _resume_requests(cfg))

    eng = _engine(_mk_store(cfg), cfg, params)
    for r in _resume_requests(cfg):
        eng.submit(r)
    for _ in range(3):
        eng.step()     # mid-flight: some done, some in flight, some queued
    snap = str(tmp_path / "snap")
    assert eng.snapshot(snap) == eng.step_count
    held = sum(1 for m in eng._slots if m is not None)
    assert held and eng._queue
    eng2 = Engine.restore(snap, params, cfg, adapters=_store(cfg),
                          device="cpu")
    assert eng2.step_count == eng.step_count
    assert eng2.pool.outstanding == eng.pool.outstanding
    if family == "ssm":
        for a, b in zip(eng2.state.ssm, eng.state.ssm):
            assert torch.equal(a, b)
    out = eng2.run()
    assert set(out) == set(base)
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])
    assert eng2.pool.outstanding == 0


def test_sigterm_drains_snapshots_and_resumes(tmp_path):
    snap = str(tmp_path / "drain")
    reqs = [("a", _prompt(4, 61), 8), ("b", _prompt(4, 62), 6)]
    base = _run(_engine(), [Request(*r) for r in reqs])
    eng = _engine(snapshot_dir=snap)
    prev = signal.getsignal(signal.SIGTERM)
    with chaos.injected(chaos.ChaosHook(sigterm_at_step=2)):
        out1 = _run(eng, [Request(*r) for r in reqs])
    assert signal.getsignal(signal.SIGTERM) is prev
    assert ckpt.latest_step(snap) == 3
    eng2 = Engine.restore(snap, PARAMS, CFG, device="cpu")
    merged = dict(out1)
    merged.update(eng2.run())
    assert set(merged) == {"a", "b"}
    for rid in ("a", "b"):
        np.testing.assert_array_equal(merged[rid], base[rid])


def test_restore_refuses_wrong_arch_or_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        Engine.restore(str(tmp_path / "nope"), PARAMS, CFG, device="cpu")
    snap = str(tmp_path / "s")
    _engine().snapshot(snap)
    with pytest.raises(ValueError, match="arch"):
        Engine.restore(snap, lm.init_params(MAMBA, seed=2, device="cpu"),
                       MAMBA, device="cpu")
    with pytest.raises(ValueError, match="adapter store"):
        Engine.restore(snap, PARAMS, CFG, adapters=_store(), device="cpu")


# ---------------------------------------------------------------------------
# Serving chaos: pool spikes, deadline storms, poisoned rows; knobs
# ---------------------------------------------------------------------------

def test_pool_spike_chaos_outputs_bit_identical():
    ecfg = _ecfg(page_size=2, num_pages=10, max_len=16)
    reqs = [("a", _prompt(4, 31), 8), ("b", _prompt(4, 32), 8)]
    base = _run(_engine(engine_cfg=ecfg), [Request(*r) for r in reqs])
    eng = _engine(engine_cfg=ecfg)
    with chaos.injected(chaos.ChaosHook(pool_spike_steps=(2,))):
        out = _run(eng, [Request(*r) for r in reqs])
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])
    assert eng.pool.outstanding == 0 and not eng._chaos_pages


def test_deadline_storm_drains_without_deadlock():
    eng = _engine()
    with chaos.injected(chaos.ChaosHook(deadline_storm_steps=(2,))):
        out = _run(eng, [Request(r, _prompt(4, s), 8, ttl=100)
                         for r, s in (("a", 3), ("b", 5), ("c", 6))])
    assert set(out) == {"a", "b", "c"}
    assert all(eng.reasons[r] == "deadline" for r in ("a", "b", "c"))
    assert all(len(v) < 8 for v in out.values())
    assert eng.pool.outstanding == 0 and not eng._chaos_pages


@pytest.mark.parametrize("mode,family", [("rownan", "dense"),
                                         ("rowzero", "dense"),
                                         ("rownan", "ssm")])
def test_row_fault_quarantines_only_the_offending_tenant(mode, family):
    cfg = CFG if family == "dense" else MAMBA
    params = PARAMS if family == "dense" else \
        lm.init_params(MAMBA, seed=1, device="cpu")

    def reqs():
        return [Request("r0", _prompt(4, 11, cfg), 6, tenant="t0"),
                Request("r1", _prompt(4, 12, cfg), 6, tenant="t1")]

    base = _run(_engine(_mk_store(cfg), cfg, params), reqs())
    eng = _engine(_mk_store(cfg), cfg, params)
    with chaos.injected(chaos.from_env(f"{mode}@2:1")):
        out = _run(eng, reqs())
    assert "r1" not in out and eng.reasons["r1"] == "quarantined"
    assert isinstance(eng.errors["r1"], TenantQuarantinedError)
    assert eng.strikes("t1") == 1
    np.testing.assert_array_equal(out["r0"], base["r0"])
    assert eng.pool.outstanding == 0


def test_engine_config_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_MAX_QUEUE", "7")
    monkeypatch.setenv("REPRO_SERVE_GUARD", "0")
    monkeypatch.setenv("REPRO_SERVE_STRIKES", "5")
    monkeypatch.setenv("REPRO_SERVE_PAGE_SIZE", "8")
    ec = EngineConfig.from_env(max_batch=3)
    assert ec.max_queue == 7 and ec.guard is False and ec.max_strikes == 5
    assert ec.page_size == 8 and ec.max_batch == 3
    eng = Engine(PARAMS, CFG, device="cpu")
    assert eng.ecfg.max_queue == 7 and eng.ecfg.page_size == 8
