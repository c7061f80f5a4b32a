"""Quickstart of the port: train a tiny LLaMA with the paper's optimal
low-rank estimator (Stiefel LowRank-IPA with lazy merges) and print the
loss trajectory.  Counterpart of the JAX package's
``examples/quickstart.py``, with the same configuration.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
        [--steps 60]

It runs on ``cuda`` unless ``--device cpu`` is given (the plain PyTorch
path).  The reference's loss falls from about 6.7 to about 5.3 over its
60 steps.
"""
from __future__ import annotations

import argparse
import sys

import torch

from . import methods
from .configs import TrainConfig, get_config
from .data.synthetic import StatelessLoader
from .train.trainer import Trainer

TCFG = TrainConfig(
    optimizer="lowrank_adam",   # Algorithm 1 (IPA family)
    sampler="stiefel",          # Theorem-2-optimal Haar-Stiefel projector
    rank=16,                    # r
    c=1.0,                      # strong unbiasedness
    lazy_k=20,                  # inner steps per projection resample
    lr=3e-3, warmup_steps=10, total_steps=100,
    min_dim_for_lowrank=64, weight_decay=0.0, seed=0)


def train(device="cuda", steps: int = 60, log_every: int = 10, out=print):
    """Train llama-tiny for ``steps`` steps (batch 8 x 64); returns the
    trainer's report."""
    cfg = get_config("llama-tiny")
    dev = torch.device(device)
    out(f"registered methods: {', '.join(methods.available())}")
    loader = StatelessLoader("lm", seed=0, batch=8, seq_len=64,
                             vocab=cfg.vocab_size, device=dev)
    trainer = Trainer(cfg, TCFG, loader, device=dev)
    n_groups = len(trainer.params.groups)
    out(f"llama-tiny on {dev}: {n_groups} stacked low-rank groups, r = "
        f"{TCFG.rank}, lazy_k = {TCFG.lazy_k}, {TCFG.sampler} V")

    def log(step, loss, seconds):
        if step % log_every == 0 or step == steps:
            out(f"step {step:4d}  loss {loss:.4f}  {1e3 * seconds:.0f} ms")
    report = trainer.run(steps, log=log)
    times = report.step_times
    out(f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f} over "
        f"{report.steps_run} steps ({1e3 * sum(times) / len(times):.0f} "
        f"ms/step); {report.skipped_steps} skipped steps, "
        f"{report.rollbacks} rollbacks")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain path)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    report = train(args.device, args.steps)
    ok = report.losses[-1] < report.losses[0] and not report.skipped_steps
    print("quickstart OK" if ok else "quickstart FAILED: the loss did not "
          "fall")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
