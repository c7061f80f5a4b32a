"""Step builders of the training methods.

Counterpart of ``repro.train.steps`` for the dense, SSM, hybrid and MoE
LMs: ``build_loss_fn`` (the MoE family adds the router's aux terms),
``make_train_step`` (Algorithm 1's inner step,
``lowrank_adam`` and ``lowrank_lion``, with gradient accumulation),
``make_outer_step`` (merge + resample), ``make_adamw_train_step`` (the
dense AdamW baseline) and ``make_zo_train_step`` (the forward-only
LowRank-LR step).  GaLore's steps live in :mod:`repro_torch.optim.
galore`.  The steps run eagerly; the LR, the step counter and the bias
corrections stay on the device, so an inner step makes no host round
trip.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import lm
from ..models.common import act_dtype, resolve_compute_dtype
from ..optim import adamw, galore, subspace, zo
from ..optim.schedule import SCHEDULES
from .loss import chunked_ce

LB_COEFF = 0.01
ZLOSS_COEFF = 1e-3


def build_loss_fn(cfg) -> Callable:
    """loss_fn(packed_params, batch) -> scalar: the batch-mean token CE,
    plus ``LB_COEFF * lb_loss + ZLOSS_COEFF * router_z`` for the MoE
    family (the router's aux terms, summed over the layers by
    ``lm.forward_hidden``)."""
    if cfg.is_encoder_decoder or cfg.family not in ("dense", "ssm",
                                                    "hybrid", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the dense, SSM, hybrid and MoE families train "
            f"in repro_torch; see ROADMAP.md Queue 1 item 9")
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA serves in repro_torch but does not train yet "
            f"(MLA training, ROADMAP.md Queue 1 item 9)")

    def loss_fn(packed, batch):
        h, aux = lm.forward_hidden(packed, batch["tokens"], cfg)
        loss = chunked_ce(h, packed["unembed"], batch["labels"],
                          true_vocab=cfg.vocab_size, chunk=cfg.loss_chunk)
        if cfg.family == "moe":
            loss = loss + LB_COEFF * aux["lb_loss"] + \
                ZLOSS_COEFF * aux["router_z"]
        return loss

    return loss_fn


def lr_at(tcfg, step):
    sched = SCHEDULES.get(getattr(tcfg, "schedule", "cosine"),
                          SCHEDULES["cosine"])
    return sched(step, base_lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
                 total_steps=tcfg.total_steps)


def pack_dtype(cfg, tcfg, device) -> torch.dtype:
    """Dtype the packed (W, B, V) views are cast to: the run's compute
    dtype when reduced, else the model's activation dtype.  With both
    fp32 the stored members that are narrower (bf16 weights, bf16 B
    masters) are cast up, as the reference's mixed-dtype dots promote
    them, so the fused forward and backward see one dtype; fp32 members
    are not copied."""
    cdt = resolve_compute_dtype(tcfg, device)
    return cdt if cdt != torch.float32 else act_dtype(cfg)


def _microbatches(batch: dict, n: int) -> list:
    """``n`` contiguous microbatches of every batch entry (the reference's
    ``_microbatch``); ``n`` must divide the batch."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"grad_accum={n} does not divide the batch of "
                         f"{rows} rows")
    size = rows // n
    return [{k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            for i in range(n)]


def accumulate(gsum: Optional[list], grads) -> list:
    """``gsum`` plus a microbatch's ``grads``, in fp32, in place where
    that is safe.  The first microbatch's fp32 gradients become the sums
    themselves, but for one whose bytes another entry shares (autograd
    gives ``x + y``'s leaves one tensor): that one is copied, so each sum
    owns its bytes.  A later gradient whose storage is a sum's is copied
    before any sum is added to."""
    if gsum is None:
        return [g if h == "own" else g.to(torch.float32, copy=True)
                for g, h in zip(grads, adamw.writable_once(grads))]
    stores = {a.untyped_storage().data_ptr() for a in gsum}
    grads = [g.clone() if g.untyped_storage().data_ptr() in stores else g
             for g in grads]
    return [a.add_(g) for a, g in zip(gsum, grads)]


def make_train_step(cfg, tcfg, loss_fn: Optional[Callable] = None):
    """Inner step: one backward through the packed model, then the
    method's update (subspace-Adam or -Lion on B, AdamW or Lion on the
    dense leaves; see ``subspace.inner_update``).

    ``tcfg.grad_accum = A > 1`` runs the batch as A contiguous
    microbatches, one forward and backward each (activation memory / A):
    the fp32 gradients are summed in microbatch order and divided by A,
    and the loss is the mean, exactly the one-batch step for a mean loss
    over equal splits.

    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d device
    tensors.
    """
    loss_fn = loss_fn or build_loss_fn(cfg)
    accum = max(1, getattr(tcfg, "grad_accum", 1))

    def value_and_grads(params, opt_state, trainable, pdt, batch):
        packed = subspace.packed_params(params, opt_state, trainable,
                                        dtype=pdt)
        loss = loss_fn(packed, batch)
        leaves = list(trainable.dense) + list(trainable.groups)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state: subspace.SubspaceState, batch):
        lr = lr_at(tcfg, opt_state.step)
        trainable = subspace.trainable_of(params, opt_state)
        pdt = pack_dtype(cfg, tcfg, opt_state.step.device)
        if accum == 1:
            loss, grads = value_and_grads(params, opt_state, trainable, pdt,
                                          batch)
        else:
            lsum, gsum = 0.0, None
            for mb in _microbatches(batch, accum):
                loss, grads = value_and_grads(params, opt_state, trainable,
                                              pdt, mb)
                gsum = accumulate(gsum, grads)
                lsum = lsum + loss
            # true divisions (a CUDA tensor divided by a Python number is
            # multiplied by its reciprocal)
            a = torch.full((), float(accum), device=lsum.device)
            grads = [g / a for g in gsum]
            loss = lsum / a
        nd = len(trainable.dense)
        grads = subspace.Trainable(dense=tuple(grads[:nd]),
                                   groups=tuple(grads[nd:]))
        new_params, _, new_state, gn = subspace.inner_update(
            grads, trainable, params, opt_state, lr=lr, tcfg=tcfg)
        return new_params, new_state, {"loss": loss, "grad_norm": gn,
                                       "lr": lr}

    return train_step


def make_outer_step(cfg, tcfg):
    def outer_step(params, opt_state):
        return subspace.outer_merge_resample(params, opt_state, tcfg)
    return outer_step


# ---------------------------------------------------------------------------
# Vanilla IPA (dense AdamW) baseline
# ---------------------------------------------------------------------------

def make_adamw_train_step(cfg, tcfg, loss_fn: Optional[Callable] = None):
    """Full backprop through the compute-dtype view of the weights, then
    AdamW on the masters (fp32 moments, each master in its own dtype)."""
    loss_fn = loss_fn or build_loss_fn(cfg)

    def train_step(params, opt_state: adamw.AdamWState, batch):
        lr = lr_at(tcfg, opt_state.step)
        loss, grads = galore.value_and_full_grads(
            galore.view_loss(loss_fn, tcfg, opt_state.step.device), params,
            batch)
        new_params, new_state, gn = adamw.update(
            grads, opt_state, params, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip)
        return new_params, new_state, {"loss": loss, "grad_norm": gn,
                                       "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# LowRank-LR (forward-only) step
# ---------------------------------------------------------------------------

def make_zo_train_step(cfg, tcfg, loss_fn: Optional[Callable] = None):
    """Two forwards at ``B ± σ Z`` (no autograd), then the subspace update
    of :func:`make_train_step`'s methods on the estimate."""
    loss_fn = loss_fn or build_loss_fn(cfg)

    def train_step(params, opt_state: subspace.SubspaceState, batch):
        lr = lr_at(tcfg, opt_state.step)
        pdt = pack_dtype(cfg, tcfg, opt_state.step.device)
        loss, new_params, new_state, gn = zo.zo_inner_step(
            loss_fn, params, opt_state, batch, lr=lr, tcfg=tcfg, dtype=pdt)
        return new_params, new_state, {"loss": loss, "grad_norm": gn,
                                       "lr": lr}

    return train_step
