"""The training loop.

Counterpart of the core loop of ``repro.train.trainer.Trainer._run``:
every ``tcfg.lazy_k`` steps the outer merge + resample runs before the
inner step (at ``step > 0 and step % lazy_k == 0``), the loss is fetched
once per step (the loop's one host sync, as the reference's
``float(metrics["loss"])``), and the step times are recorded.
Checkpoints, the health guard, chaos hooks and the straggler watchdog
wait for the resilience slice (ROADMAP.md Queue 1 item 4).

The trainer runs on ``cuda`` unless the caller names another device.
Parameters come from ``lm.init_params`` with ``tcfg.seed``, or from the
caller (``params=``, e.g. weights carried over from the JAX package).
The projections are drawn from a generator on ``sample_device`` (the
training device unless named), seeded with ``tcfg.seed + 1``; two
trainers given the same seed and the same ``sample_device`` draw the
same ``V``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from .. import methods, resolve_device
from ..models import lm


@dataclass
class TrainerReport:
    steps_run: int = 0
    outer_steps: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)


class Trainer:
    def __init__(self, cfg, tcfg, loader: Callable[[int], Dict], *,
                 device=None, params=None, sample_device=None):
        self.cfg, self.tcfg, self.loader = cfg, tcfg, loader
        # an unknown tcfg.optimizer raises here, before the model init
        self.method = methods.get(tcfg.optimizer)
        self.device = resolve_device(device)
        if params is None:
            params = lm.init_params(cfg, seed=tcfg.seed, device=self.device)
        gen = torch.Generator(device=torch.device(
            sample_device if sample_device is not None else self.device))
        gen.manual_seed(tcfg.seed + 1)
        self.params, self.opt_state = self.method.init(params, tcfg, gen)
        self._inner = self.method.make_inner_step(cfg, tcfg)
        self._outer = self.method.make_outer_step(cfg, tcfg)
        self.step = 0

    def outer_due(self) -> bool:
        return (self._outer is not None and self.step > 0
                and self.step % self.tcfg.lazy_k == 0)

    def run(self, num_steps: int, log: Optional[Callable] = None
            ) -> TrainerReport:
        """Run ``num_steps`` steps; ``log(step, loss, seconds)`` is called
        after each."""
        report = TrainerReport()
        target = self.step + num_steps
        while self.step < target:
            t0 = time.perf_counter()
            if self.outer_due():
                self.params, self.opt_state = self._outer(self.params,
                                                          self.opt_state)
                report.outer_steps += 1
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in self.loader(self.step).items()}
            self.params, self.opt_state, metrics = self._inner(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report.losses.append(loss)
            report.step_times.append(dt)
            self.step += 1
            report.steps_run += 1
            if log is not None:
                log(self.step, loss, dt)
        return report
