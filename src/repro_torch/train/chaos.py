"""Deterministic fault injection for the resilience tests of both loops.

Counterpart of ``repro.train.chaos``, copied (the port imports nothing
of the JAX package), with the same fields, sites and ``REPRO_CHAOS``
grammar.  Every failure mode the training loop and the serving engine
must survive is injectable, deterministically:

  * ``grad_nan_steps`` — poison the gradient estimate (NaN or inf) at
    given guard steps.  :func:`repro_torch.train.health.guard_inner_step`
    checks the step index on the host (its guard-step counter, the
    reference's ``HealthState.seen``) and, at a poisoned step, multiplies
    the loss, the grad norm and every floating candidate buffer by the
    poison: the same tensors a real overflow would corrupt, with no
    device-to-host read.
  * ``spike_scale_steps`` — multiply the (finite) loss by ``spike_scale``
    at given guard steps: a loss spike for the EMA z-score detector.
  * ``truncate_npz_at`` — truncate ``arrays.npz`` at a byte offset during
    :func:`repro_torch.train.checkpoint.save` (a torn write).
  * ``raise_in_save`` — raise :class:`ChaosError` at a labeled point of
    ``save`` (:data:`SAVE_SITES`): a crash mid-save.
  * ``sigterm_at_step`` — deliver a real ``SIGTERM`` to this process at a
    given trainer (or engine) step, through the real signal handlers.

Serving faults ride the same hook:

  * ``logit_rows`` — poison one decode row's logits (NaN, or zero for a
    collapse) at a given engine step; the engine decides the step on the
    host and multiplies that row on the device.
  * ``raise_in_swap`` — crash the two-phase adapter swap at a labeled
    point (:data:`SWAP_SITES`).
  * ``pool_spike_steps`` — hold every free page for one engine step.
  * ``deadline_storm_steps`` — expire every TTL'd request at one
    eviction boundary.

The hook is module-global: ``install(ChaosHook(...))`` / ``uninstall()``
or the :func:`injected` context manager.  ``REPRO_CHAOS`` installs one at
import time (e.g. ``REPRO_CHAOS="nan@3,4,5;sigterm@9"``); it is a test
hook, and with it unset every injection point is a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
from typing import Optional, Tuple

SAVE_SITES = (
    "save:pre_arrays",    # before arrays.npz is written
    "save:post_arrays",   # arrays.npz written (and fsynced), no manifest yet
    "save:pre_rename",    # tmp dir complete, publish rename not yet issued
    "save:post_rename",   # published, GC not yet run
)

SWAP_SITES = (
    "swap:pre_stage",     # validated, staging buffers not yet built
    "swap:pre_commit",    # staged, atomic flip not yet issued
    "swap:post_commit",   # flipped, tenant map updated
)


class ChaosError(RuntimeError):
    """The injected mid-save crash (stands in for SIGKILL/power loss)."""


@dataclasses.dataclass(frozen=True)
class ChaosHook:
    """One deterministic fault schedule.  All fields default to inert."""
    grad_nan_steps: Tuple[int, ...] = ()   # guard steps to poison
    grad_mode: str = "nan"                 # 'nan' | 'inf'
    spike_scale_steps: Tuple[int, ...] = ()  # guard steps to spike the loss
    spike_scale: float = 1e4               # finite loss multiplier
    truncate_npz_at: Optional[int] = None  # byte offset into arrays.npz
    raise_in_save: Optional[str] = None    # one of SAVE_SITES
    sigterm_at_step: Optional[int] = None  # trainer step to SIGTERM at
    seed: int = 0                          # reserved for randomized modes
    # serving faults: ((engine_step, decode_row, 'nan'|'zero'), ...)
    logit_rows: Tuple[Tuple[int, int, str], ...] = ()
    raise_in_swap: Optional[str] = None    # one of SWAP_SITES
    pool_spike_steps: Tuple[int, ...] = ()  # engine steps to drain the pool
    deadline_storm_steps: Tuple[int, ...] = ()  # boundaries to storm

    def poison(self) -> float:
        return float("inf") if self.grad_mode == "inf" else float("nan")


_HOOK: Optional[ChaosHook] = None


def install(hook: ChaosHook) -> ChaosHook:
    """Install ``hook`` as the process-wide fault schedule (tests)."""
    global _HOOK
    _HOOK = hook
    return hook


def uninstall() -> None:
    global _HOOK
    _HOOK = None


def get() -> Optional[ChaosHook]:
    """The installed hook, or None (the production answer)."""
    return _HOOK


@contextlib.contextmanager
def injected(hook: ChaosHook):
    """``with chaos.injected(ChaosHook(...)):`` — install for the block."""
    install(hook)
    try:
        yield hook
    finally:
        uninstall()


def from_env(spec: Optional[str] = None) -> Optional[ChaosHook]:
    """Parse a ``REPRO_CHAOS`` spec: ``;``-separated ``kind@args`` terms.

    ``nan@3,4`` / ``inf@7`` (poison grads), ``spike@5`` (finite loss
    spike), ``truncate@128`` (byte offset), ``raise@save:pre_rename`` /
    ``raise@swap:pre_commit``, ``sigterm@9``.  Serving terms:
    ``rownan@3:1`` / ``rowzero@2:0,5:1`` (poison row R's logits at engine
    step S, NaN or collapse-to-constant), ``pools@4,7`` (pool-exhaustion
    spikes), ``storm@5`` (deadline storm).  Unknown terms raise — a
    typo'd chaos spec silently doing nothing would defeat the whole
    point of the leg.
    """
    spec = os.environ.get("REPRO_CHAOS", "") if spec is None else spec
    spec = spec.strip()
    if not spec:
        return None
    kw: dict = {}
    for term in spec.split(";"):
        term = term.strip()
        if not term:
            continue
        kind, _, arg = term.partition("@")
        if kind in ("nan", "inf"):
            kw["grad_nan_steps"] = tuple(int(s) for s in arg.split(","))
            kw["grad_mode"] = kind
        elif kind == "spike":
            kw["spike_scale_steps"] = tuple(int(s) for s in arg.split(","))
        elif kind == "truncate":
            kw["truncate_npz_at"] = int(arg)
        elif kind == "raise":
            if arg in SAVE_SITES:
                kw["raise_in_save"] = arg
            elif arg in SWAP_SITES:
                kw["raise_in_swap"] = arg
            else:
                raise ValueError(
                    f"REPRO_CHAOS raise site {arg!r} unknown; sites: "
                    f"{', '.join(SAVE_SITES + SWAP_SITES)}")
        elif kind == "sigterm":
            kw["sigterm_at_step"] = int(arg)
        elif kind in ("rownan", "rowzero"):
            mode = "nan" if kind == "rownan" else "zero"
            rows = list(kw.get("logit_rows", ()))
            for pair in arg.split(","):
                s, _, r = pair.partition(":")
                rows.append((int(s), int(r), mode))
            kw["logit_rows"] = tuple(rows)
        elif kind == "pools":
            kw["pool_spike_steps"] = tuple(int(s) for s in arg.split(","))
        elif kind == "storm":
            kw["deadline_storm_steps"] = tuple(
                int(s) for s in arg.split(","))
        else:
            raise ValueError(f"REPRO_CHAOS term {term!r} not understood")
    return ChaosHook(**kw)


# -- host-side injection points (all no-ops without a hook) -----------------

def maybe_raise(site: str) -> None:
    """Crash point inside ``checkpoint.save`` (SAVE_SITES) or the
    two-phase adapter swap (SWAP_SITES)."""
    if _HOOK is not None and site in (_HOOK.raise_in_save,
                                      _HOOK.raise_in_swap):
        raise ChaosError(f"chaos: injected crash at {site}")


def pool_spike(step: int) -> bool:
    """True when the engine must drain its page pool at ``step``."""
    return _HOOK is not None and step in _HOOK.pool_spike_steps


def deadline_storm(step: int) -> bool:
    """True when every TTL'd request expires at this eviction boundary."""
    return _HOOK is not None and step in _HOOK.deadline_storm_steps


def maybe_truncate(path: str) -> None:
    """Torn-write point: truncate ``path`` at the hook's byte offset."""
    if _HOOK is not None and _HOOK.truncate_npz_at is not None:
        size = os.path.getsize(path)
        os.truncate(path, max(0, min(_HOOK.truncate_npz_at, size)))


def maybe_sigterm(step: int) -> None:
    """Preemption point in the trainer loop: real SIGTERM to this pid."""
    if _HOOK is not None and _HOOK.sigterm_at_step == step:
        os.kill(os.getpid(), signal.SIGTERM)


def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit of the file at ``path`` in place (silent media
    corruption — the CRC manifest, not the guard, must catch this)."""
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)
        f.seek(byte_offset)
        f.write(bytes([b[0] ^ (1 << bit)]))
        f.flush()
        os.fsync(f.fileno())


# REPRO_CHAOS is a test/CI hook: installs a schedule for the whole process
# at import time.  Production runs never set it.
_env_hook = from_env()
if _env_hook is not None:
    install(_env_hook)
