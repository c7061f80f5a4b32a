"""Per-step health guard: non-finite detection and loss-spike skip.

Counterpart of ``repro.train.health``.  The guard wraps any method's
inner step:

  * the candidate step runs unconditionally;
  * ``ok`` = loss and grad norm finite AND no EMA z-score loss spike,
    with the reference's arithmetic: armed after ``tcfg.spike_warmup``
    accepted steps, a z denominator floored at 5% of the running mean,
    the EMA fed by accepted losses only (the first one seeds the mean);
  * ``ok`` and the carry (:class:`HealthState`, 0-d tensors on the
    training device) are computed on the device, and the step's
    observables are packed into one ``metrics["health"]`` vector
    ``[loss, ok, consec_skips, grad_norm]``, so the trainer's one fetch
    per step reads them all (:func:`read_health`).

The skip itself is host policy: the port's inner steps are functional
(they return new tensors and leave their inputs as they are), so on
``ok == 0`` the trainer keeps the pre-step params and state objects and
rewinds the state's generator to where it was before the step (the
candidate drew stochastic-rounding bits or ZO noise from it).  Nothing
in the guarded step waits on the host.

Chaos: an installed :mod:`repro_torch.train.chaos` hook (read when the
guard is built) poisons the guard steps it names.  The step index is the
caller's host count of guard steps (the reference's
``HealthState.seen``), so deciding costs no device read; at a poisoned
step the loss, the grad norm and every floating candidate tensor are
multiplied by NaN or inf, or the loss by the spike factor.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from . import chaos
from .checkpoint import map_tensors, tensors

# metrics["health"] layout (one fp32 vector => one host fetch per step)
H_LOSS, H_OK, H_CONSEC, H_GNORM = 0, 1, 2, 3


class HealthState(NamedTuple):
    """Device-side carry of the guard (0-d tensors)."""
    ema_mean: torch.Tensor      # fp32 EMA of accepted losses
    ema_var: torch.Tensor       # fp32 EMA variance of accepted losses
    good_steps: torch.Tensor    # int32 accepted steps since (re)arm
    consec_skips: torch.Tensor  # int32 consecutive skipped steps
    total_skips: torch.Tensor   # int32 lifetime skips
    last_anomaly: torch.Tensor  # int32 guard step of the last skip (-1)
    seen: torch.Tensor          # int32 guard steps (accepted + skipped)


def init_health(device) -> HealthState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return HealthState(
        ema_mean=torch.zeros((), **f32), ema_var=torch.zeros((), **f32),
        good_steps=torch.zeros((), **i32), consec_skips=torch.zeros((), **i32),
        total_skips=torch.zeros((), **i32),
        last_anomaly=torch.full((), -1, **i32), seen=torch.zeros((), **i32))


def after_rollback(h: HealthState) -> HealthState:
    """Re-arm after a restore and LR backoff: the detector's statistics
    and the warm-up gate reset; the lifetime counters persist."""
    return h._replace(ema_mean=torch.zeros_like(h.ema_mean),
                      ema_var=torch.zeros_like(h.ema_var),
                      good_steps=torch.zeros_like(h.good_steps),
                      consec_skips=torch.zeros_like(h.consec_skips))


def _poison(tree, factor: float):
    """Every floating tensor of ``tree`` times ``factor``; integer
    tensors (int8 payloads, counters) pass through."""
    return map_tensors(
        lambda t: t * factor if t.is_floating_point() else t, tree)


def guard_inner_step(step_fn: Callable, tcfg) -> Callable:
    """Wrap a method's inner step with the guard.

    ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` becomes ``guarded(params, opt_state, health, batch,
    seen) -> (cand_params, cand_state, health, metrics)``: the candidate
    step, the new carry and ``metrics["health"]``.  ``seen`` is the
    caller's host count of guard steps so far (the chaos schedule's
    index).  The caller keeps the candidates when the packed ``ok`` is
    1 and its pre-step objects otherwise.
    """
    hook = chaos.get()
    z_thresh = float(getattr(tcfg, "spike_zscore", 6.0))
    rho = float(getattr(tcfg, "spike_ema", 0.99))
    warmup = int(getattr(tcfg, "spike_warmup", 20))

    def guarded(params, opt_state, health: HealthState, batch, seen: int):
        cand_p, cand_s, metrics = step_fn(params, opt_state, batch)
        loss = metrics["loss"].float()
        gn = metrics.get("grad_norm")
        gn = torch.zeros_like(loss) if gn is None else gn.float()
        if hook is not None:
            if seen in hook.grad_nan_steps:
                f = hook.poison()
                loss, gn = loss * f, gn * f
                cand_p, cand_s = _poison(cand_p, f), _poison(cand_s, f)
            if seen in hook.spike_scale_steps:
                loss = loss * hook.spike_scale

        finite = torch.isfinite(loss) & torch.isfinite(gn)
        delta = loss - health.ema_mean
        armed = (health.good_steps >= warmup) & (health.good_steps > 0)
        # a non-finite z never arms `spike` (the comparison is False)
        z = delta * torch.rsqrt(
            health.ema_var + (0.05 * health.ema_mean) ** 2 + 1e-12)
        spike = armed & (z > z_thresh)
        ok = finite & ~spike

        seeded = ok & (health.good_steps == 0)
        zero = torch.zeros_like(delta)
        safe_delta = torch.where(ok, delta, zero)
        consec = torch.where(ok, torch.zeros_like(health.consec_skips),
                             health.consec_skips + 1)
        new_health = HealthState(
            ema_mean=torch.where(
                seeded, loss, health.ema_mean + (1.0 - rho) * safe_delta),
            ema_var=torch.where(
                seeded, zero,
                torch.where(ok, rho * (health.ema_var
                                       + (1.0 - rho) * delta * delta),
                            health.ema_var)),
            good_steps=health.good_steps + ok.to(torch.int32),
            consec_skips=consec,
            total_skips=health.total_skips + (~ok).to(torch.int32),
            last_anomaly=torch.where(ok, health.last_anomaly, health.seen),
            seen=health.seen + 1)
        metrics = dict(metrics)
        metrics["health"] = torch.stack(
            [loss, ok.float(), consec.float(), gn])
        return cand_p, cand_s, new_health, metrics

    return guarded


class HealthRead(NamedTuple):
    """Host-side view of one step's packed health vector."""
    loss: float
    ok: bool
    consec_skips: int
    grad_norm: float


def read_health(metrics: dict) -> HealthRead:
    """The one device-to-host fetch: the packed vector, unpacked."""
    vec = metrics["health"].cpu().tolist()
    return HealthRead(loss=vec[H_LOSS], ok=vec[H_OK] > 0.5,
                      consec_skips=int(vec[H_CONSEC]),
                      grad_norm=vec[H_GNORM])


def counters(h: HealthState, rollbacks: int) -> dict:
    """JSON-able health counters for the checkpoint manifest's
    ``extra`` (reads the device)."""
    return {"skips": int(h.total_skips), "rollbacks": int(rollbacks),
            "last_anomaly_step": int(h.last_anomaly)}


def tree_all_finite(tree: Any) -> torch.Tensor:
    """AND of ``isfinite`` over every floating tensor (a device bool)."""
    ok = None
    for t in tensors(tree):
        if t.is_floating_point():
            f = torch.isfinite(t).all()
            ok = f if ok is None else ok & f
    return torch.ones((), dtype=torch.bool) if ok is None else ok
