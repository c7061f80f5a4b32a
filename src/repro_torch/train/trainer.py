"""The training loop with its fault tolerance.

Counterpart of ``repro.train.trainer.Trainer``:

  * every ``tcfg.lazy_k`` steps the outer merge + resample runs before
    the inner step (at ``step > 0 and step % lazy_k == 0``);
  * auto-resume from the newest intact checkpoint in ``workdir``
    (:mod:`.checkpoint`, the reference's format: walking back past and
    quarantining damaged steps), with the health counters carried over;
  * periodic checkpoints every ``checkpoint_every`` steps (keep ``keep``);
  * SIGTERM/SIGINT drain: the in-flight step finishes, a checkpoint
    tagged ``extra.preempted`` is written and the run stops; the
    previous handlers are put back when ``run`` returns;
  * the health guard (:mod:`.health`, ``tcfg.health_guard``): a step
    whose loss or grad norm is non-finite, or whose loss spikes, is
    skipped — params, state and the state's generator stay as they were
    before it.  The guard's readout rides the loop's one host fetch per
    step.  ``max_consecutive_skips`` skips in a row roll back: restore
    the last checkpoint, reseed the method's draws, back the LR off by
    ``rollback_backoff`` and re-arm the detector, at most
    ``max_rollbacks`` times, after which the run stops with its last
    good state saved;
  * a straggler watchdog: a step slower than ``straggler_factor`` times
    the running median (of the last 64, from the 8th step on) is counted
    and reported to ``on_straggler(step, seconds, median)``;
  * ``chaos.maybe_sigterm`` in the loop (fault injection for tests).

The trainer runs on ``cuda`` unless the caller names another device.
Parameters come from ``lm.init_params`` with ``tcfg.seed``, or from the
caller (``params=``, e.g. weights carried over from the JAX package).
The projections are drawn from a generator on ``sample_device`` (the
training device unless named), seeded with ``tcfg.seed + 1``; two
trainers given the same seed and the same ``sample_device`` draw the
same ``V``.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import methods, resolve_device
from ..models import lm
from ..models.common import (resolve_compute_dtype, resolve_master_dtype,
                             resolve_state_dtype)
from . import chaos
from . import checkpoint as ckpt
from . import health


@dataclass
class TrainerReport:
    steps_run: int = 0
    outer_steps: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    resumed_from: Optional[int] = None
    straggler_events: int = 0
    preempted: bool = False
    # resilience counters (mirrored into the manifest's extra.health)
    skipped_steps: int = 0
    rollbacks: int = 0
    lr_backoffs: List[float] = field(default_factory=list)
    last_anomaly_step: Optional[int] = None
    health_exhausted: bool = False
    resumed_health: Optional[dict] = None
    # seconds of each checkpoint written, and of the resume's restore
    save_times: List[float] = field(default_factory=list)
    resume_seconds: Optional[float] = None


def rollback_seed(seed: int, rollbacks: int) -> int:
    """The generator seed of the ``rollbacks``-th reseed: a fixed
    function of ``seed ^ 0x5EED`` and the count (the reference folds the
    count into ``key(seed ^ 0x5EED)``)."""
    return ((seed ^ 0x5EED) << 20) + rollbacks


class Trainer:
    def __init__(self, cfg, tcfg, loader: Callable[[int], Dict],
                 workdir: Optional[str] = None, *,
                 loss_fn: Optional[Callable] = None,
                 checkpoint_every: int = 0, keep: int = 3,
                 straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable] = None,
                 device=None, params=None, sample_device=None):
        self.cfg, self.tcfg, self.loader = cfg, tcfg, loader
        self.workdir = workdir
        self.loss_fn = loss_fn
        self.checkpoint_every = checkpoint_every
        self.keep = keep
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self._preempt = False
        self._prev_handlers: dict = {}
        # an unknown tcfg.optimizer raises here, before the model init
        self.method = methods.get(tcfg.optimizer)
        self.device = resolve_device(device)
        # recorded in every checkpoint manifest, as the reference does
        self.compute_dtype = str(resolve_compute_dtype(
            tcfg, self.device)).removeprefix("torch.")
        self.state_dtype = resolve_state_dtype(tcfg)
        self.master_dtype = resolve_master_dtype(tcfg)
        made = params is None
        if made:
            params = lm.init_params(cfg, seed=tcfg.seed, device=self.device)
        gen = torch.Generator(device=torch.device(
            sample_device if sample_device is not None else self.device))
        gen.manual_seed(tcfg.seed + 1)
        # weights made here are handed over: the grouping frees each leaf
        # as it copies it
        self.params, self.opt_state = self.method.init(params, tcfg, gen,
                                                       donate=made)
        del params
        self.health = health.init_health(self.device)
        self.guard_steps = 0          # host mirror of health.seen
        self.rollbacks = 0            # lifetime (carried via the manifest)
        self.total_skips_offset = 0   # skips of earlier runs
        self._build_steps()
        self.step = 0

    def _build_steps(self):
        """The inner and outer steps of the CURRENT ``self.tcfg`` (at init
        and after a rollback's LR backoff)."""
        inner = self.method.make_inner_step(self.cfg, self.tcfg,
                                            self.loss_fn)
        self._guarded = bool(getattr(self.tcfg, "health_guard", True))
        self._inner = (health.guard_inner_step(inner, self.tcfg)
                       if self._guarded else inner)
        self._outer = self.method.make_outer_step(self.cfg, self.tcfg)

    def outer_due(self) -> bool:
        return (self._outer is not None and self.step > 0
                and self.step % self.tcfg.lazy_k == 0)

    # -- fault tolerance ---------------------------------------------------

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempt = True
        self._prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread

    def _restore_signal_handlers(self):
        """Put back what handled SIGTERM/SIGINT before this run."""
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}

    def request_preemption(self):
        """Programmatic preemption (tests, controllers)."""
        self._preempt = True

    def _template(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def maybe_resume(self, report: Optional[TrainerReport] = None
                     ) -> Optional[int]:
        if not self.workdir:
            return None
        t0 = time.perf_counter()
        restored, manifest = ckpt.restore_latest(
            self.workdir, self._template(),
            expect_method=self.method.checkpoint_tag)
        if restored is None:
            return None
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = manifest["step"]
        if report is not None:
            report.resume_seconds = time.perf_counter() - t0
        carried = (manifest.get("extra") or {}).get("health")
        if carried:
            # lifetime counters continue across restarts
            self.rollbacks = int(carried.get("rollbacks", 0))
            self.total_skips_offset = int(carried.get("skips", 0))
            if report is not None:
                report.resumed_health = dict(carried)
        return self.step

    def _health_extra(self) -> dict:
        h = health.counters(self.health, self.rollbacks)
        h["skips"] += self.total_skips_offset
        return h

    def save(self, preempted: bool = False,
             report: Optional[TrainerReport] = None):
        if not self.workdir:
            return
        t0 = time.perf_counter()
        extra = {"arch": self.cfg.name,
                 "method": self.method.checkpoint_tag,
                 "compute_dtype": self.compute_dtype,
                 "state_dtype": self.state_dtype,
                 "master_dtype": self.master_dtype,
                 "health": self._health_extra()}
        if preempted:
            extra["preempted"] = True
        ckpt.save(self.workdir, self.step, self._template(), keep=self.keep,
                  extra=extra)
        if report is not None:
            report.save_times.append(time.perf_counter() - t0)

    def _rollback(self, report: TrainerReport):
        """After ``max_consecutive_skips`` skips in a row: restore the last
        checkpoint (the guard never lets a bad step into one), reseed the
        method's draws, back the LR off and re-arm the detector."""
        self.rollbacks += 1
        report.rollbacks += 1
        if self.workdir:
            restored, manifest = ckpt.restore_latest(
                self.workdir, self._template(),
                expect_method=self.method.checkpoint_tag)
            if restored is not None:
                self.params = restored["params"]
                self.opt_state = restored["opt"]
                self.step = manifest["step"]
        # else: the skips already left the state at its last good value,
        # and the rollback is the backoff and the reseed
        self.params, self.opt_state = self.method.reseed(
            self.params, self.opt_state,
            rollback_seed(self.tcfg.seed, self.rollbacks), self.tcfg)
        self.tcfg = dataclasses.replace(
            self.tcfg, lr=self.tcfg.lr * self.tcfg.rollback_backoff)
        report.lr_backoffs.append(self.tcfg.lr)
        self._build_steps()
        self.health = health.after_rollback(self.health)

    # -- main loop ----------------------------------------------------------

    def run(self, num_steps: int, log: Optional[Callable] = None
            ) -> TrainerReport:
        """Run ``num_steps`` steps (after resuming from ``workdir``);
        ``log(step, loss, seconds)`` is called after each."""
        self._install_signal_handlers()
        report = TrainerReport()
        try:
            report.resumed_from = self.maybe_resume(report)
            return self._run(num_steps, log, report)
        finally:
            self._restore_signal_handlers()

    def _guarded_step(self, batch, report: TrainerReport):
        """One guarded inner step; returns ``(loss, consecutive skips)``.
        A skipped step keeps the pre-step objects and rewinds the state's
        generator."""
        gen = getattr(self.opt_state, "gen", None)
        gen_state = None if gen is None else gen.get_state()
        cand_p, cand_s, self.health, metrics = self._inner(
            self.params, self.opt_state, self.health, batch,
            self.guard_steps)
        self.guard_steps += 1
        hr = health.read_health(metrics)    # the step's one host fetch
        if hr.ok:
            self.params, self.opt_state = cand_p, cand_s
        else:
            if gen_state is not None:
                gen.set_state(gen_state)
            report.skipped_steps += 1
            report.last_anomaly_step = self.step
        return hr.loss, hr.consec_skips

    def _run(self, num_steps: int, log: Optional[Callable],
             report: TrainerReport) -> TrainerReport:
        target = self.step + num_steps
        while self.step < target:
            t0 = time.perf_counter()
            if self.outer_due():
                self.params, self.opt_state = self._outer(self.params,
                                                          self.opt_state)
                report.outer_steps += 1
            chaos.maybe_sigterm(self.step)   # fault injection (tests)
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in self.loader(self.step).items()}
            if self._guarded:
                loss, consec = self._guarded_step(batch, report)
                if consec >= self.tcfg.max_consecutive_skips:
                    if self.rollbacks >= self.tcfg.max_rollbacks:
                        # the budget is spent: stop with the last good
                        # state (the skips kept it) rather than spin
                        report.health_exhausted = True
                        self.save(report=report)
                        break
                    self._rollback(report)
                    continue   # re-run from the restored step
            else:
                self.params, self.opt_state, metrics = self._inner(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report.losses.append(loss)
            report.step_times.append(dt)
            times = report.step_times
            if len(times) >= 8:
                med = float(np.median(times[-64:]))
                if dt > self.straggler_factor * med:
                    report.straggler_events += 1
                    if self.on_straggler:
                        self.on_straggler(self.step, dt, med)
            self.step += 1
            report.steps_run += 1
            if log is not None:
                log(self.step, loss, dt)
            if self.checkpoint_every and \
                    self.step % self.checkpoint_every == 0:
                self.save(report=report)
            if self._preempt:
                # the in-flight step completed above: save it, tag it, stop
                self.save(preempted=True, report=report)
                report.preempted = True
                break
        return report
