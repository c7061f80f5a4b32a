"""Continuous-batching serving engine over the paged decode cache.

Counterpart of ``repro.serve.engine``.  One decode
batch of ``max_batch`` slots is stepped in lock-step; sequences join
(prefill + page-chain allocation) and leave (evict, pages freed) between
steps.  The per-step loop is:

  1. evict finished / expired slots (one output-row fetch per finished
     sequence);
  2. admit queued requests while a slot AND their whole page chain are
     available (all-or-nothing admission — the backpressure signal);
  3. grow page chains for slots whose next token starts a fresh page,
     preempting the youngest other sequence (recompute-on-readmit) when
     the pool runs dry;
  4. run one batched decode step: every active slot advances one token,
     all tenants answered by one low-rank forward per projection —
     ``W + V Bᵀ`` is never materialised, token selection stays on the
     device: greedy (``temperature == 0``, the default and the exactness
     reference), or sampled from ``softmax(logits / temperature)`` over
     the ``top_k`` largest (:mod:`.sampling`, Gumbel noise from a
     generator on the device seeded with ``sample_seed``, drawn for the
     whole ``(max_batch, vocab)`` block every step).  The prefill's
     first token is greedy, as in the reference.

The dense and MoE families page their KV cache; the SSM family (Mamba2)
keeps one fixed-size recurrent state per slot, which prefill writes into
the request's slot; the hybrid (zamba2) does both: its shared attention
block's KV pages (one arena per application) beside the per-slot SSM
state.  A pure-SSM sequence holds no page chain: nothing of it lives in
the page pool, so pool pressure never preempts it, and its admission is
bounded by ``max_batch`` and ``max_len`` alone.  (The reference keeps
page chains for SSM sequences too, and a preempted one re-enters with a
prompt off the SSD chunk and fails; a deliberate departure.)  A hybrid
sequence holds pages and can be preempted: it re-enters by prefilling
the longest prefix the chunked scan takes (a multiple of ``ssd_chunk``,
or the whole sequence when shorter than one chunk) and teacher-forcing
the rest through one-row paged decode steps, the last of which gives
the next token (the reference fails there; a deliberate departure).
An MoE decode step routes all ``max_batch`` rows, inactive ones included,
so the rows share each expert's capacity as in the reference: a
sequence's tokens can depend on its batch neighbours, and a preempted
MoE sequence re-prefilled whole can route otherwise than the decode
steps that first produced its tokens.

A per-row logit health check (non-finite / collapsed) quarantines only
the offending rows: a faulted row's length does not advance, so its
cache write sits past ``length`` where attention never reads it, and its
SSM state is selected back to its value before the step; its
co-tenants keep decoding.  The one per-step device-to-host fetch is the
fault vector.

Resilience, as the reference's: the serving fault sites of
:mod:`repro_torch.train.chaos` (a poisoned decode row at a given step,
decided on the host and multiplied into that row on the device; a
page-pool spike; a deadline storm; a real SIGTERM at a given step),
SIGTERM/SIGINT draining in :meth:`Engine.run` (the current step
completes, the engine snapshots to ``snapshot_dir`` and the finished
outputs are returned; the previous handlers are put back), and
:meth:`Engine.snapshot` / :meth:`Engine.restore` through the checkpoint
layer (atomic fsynced publish, CRC manifest): the KV arenas, the page
tables, the slot map, the output rings, the adapter buffers, every piece
of host bookkeeping, the sampling generator's state and, for the SSM
and hybrid families, the per-slot recurrent state.  Since the port keeps
that state per slot with no page chain, an engine snapshot is the port's
own and is restored by the port (a training checkpoint is what crosses
between the packages).
``EngineConfig.from_env`` reads the reference's documented
``REPRO_SERVE_*`` knobs (the reference reads none for sampling).
"""
from __future__ import annotations

import dataclasses
import os
import signal
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..train import chaos, checkpoint
from ..models.lm import (alloc_decode_state, alloc_paged_state,
                         decode_step_paged, prefill)
from .adapters import AdapterStore, batched_pack_tree
from .health import logits_row_ok
from .pages import PagePool
from .sampling import gumbel_noise, select_tokens


class EngineBusy(RuntimeError):
    """Bounded admission queue is full — explicit backpressure to the
    caller (resubmit later), never a deadlock."""


class TenantQuarantinedError(RuntimeError):
    """A tenant's adapter produced unhealthy decode rows and was
    quarantined; surfaced to that tenant's caller, never to co-tenants."""


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine geometry and policy."""

    page_size: int = 16  # tokens per cache page
    max_batch: int = 4  # decode slots stepped in lock-step
    num_pages: int = 0  # 0 -> max_batch * ceil(max_len / page_size)
    max_len: int = 256  # per-sequence cap (page-table width)
    max_out: int = 128  # widest max_new a request may ask for
    max_queue: int = 0  # admission-queue bound; 0 -> unbounded
    guard: bool = True  # per-row logit health guard
    max_strikes: int = 3  # row faults before a tenant is disabled
    temperature: float = 0.0  # 0 -> greedy (the exactness reference)
    top_k: int = 0  # sampling keeps the top_k logits; 0 -> full vocab
    sample_seed: int = 0  # seed of the sampling generator

    @classmethod
    def from_env(cls, **over) -> "EngineConfig":
        """The defaults overridden by the reference's documented
        ``REPRO_SERVE_*`` knobs, then by ``over``."""
        base = dict(
            page_size=_env_int("REPRO_SERVE_PAGE_SIZE", cls.page_size),
            max_batch=_env_int("REPRO_SERVE_MAX_BATCH", cls.max_batch),
            num_pages=_env_int("REPRO_SERVE_NUM_PAGES", cls.num_pages),
            max_len=_env_int("REPRO_SERVE_MAX_LEN", cls.max_len),
            max_queue=_env_int("REPRO_SERVE_MAX_QUEUE", cls.max_queue),
            guard=bool(_env_int("REPRO_SERVE_GUARD", int(cls.guard))),
            max_strikes=_env_int("REPRO_SERVE_STRIKES", cls.max_strikes),
        )
        base.update(over)
        return cls(**base)

    def resolved_num_pages(self) -> int:
        if self.num_pages:
            return self.num_pages
        return self.max_batch * (-(-self.max_len // self.page_size))


class Request:
    """One generation request.

    ``prompt``: 1-D token ids; ``max_new``: tokens to generate (includes
    the one produced by prefill); ``tenant``: adapter name in the
    engine's store (``None`` -> base weights); ``ttl``: optional deadline
    in engine steps from submission, enforced at eviction boundaries.
    ``_seq``/``_born`` are engine-internal: admission seniority
    (preserved across preemption) and the submission step.
    """

    __slots__ = ("rid", "prompt", "max_new", "tenant", "ttl", "_seq",
                 "_born")

    def __init__(self, rid, prompt, max_new: int,
                 tenant: Optional[str] = None, ttl: Optional[int] = None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.tenant = tenant
        self.ttl = None if ttl is None else int(ttl)
        self._seq: Optional[int] = None
        self._born: Optional[int] = None
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.ttl is not None and self.ttl < 1:
            raise ValueError("ttl must be >= 1 (engine steps)")


class Engine:
    """Multi-tenant continuous-batching engine for one model config.

    ``params`` must live on ``device`` (cuda unless the caller names
    another), as must the adapter store.  ``engine_cfg`` defaults to
    :meth:`EngineConfig.from_env`; a drain snapshots to
    ``snapshot_dir`` when one is given.
    """

    def __init__(self, params, cfg, *,
                 adapters: Optional[AdapterStore] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 snapshot_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        if adapters is not None and adapters.device != self.device:
            raise ValueError(
                f"adapter store lives on {adapters.device}, engine on "
                f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.adapters = adapters
        self.ecfg = engine_cfg or EngineConfig.from_env()
        self.snapshot_dir = snapshot_dir
        ec = self.ecfg
        self.num_pages = ec.resolved_num_pages()
        # pure-SSM sequences keep their state per slot, not in pages
        self._paged = cfg.family != "ssm"
        self.max_pages = -(-ec.max_len // ec.page_size)
        self.pool = PagePool(self.num_pages, ec.page_size)
        self.state = alloc_paged_state(cfg, ec.max_batch, self.num_pages,
                                       ec.page_size, ec.max_len,
                                       device=self.device)
        # host mirrors (authoritative for page_table / lengths)
        self._pt = np.full((ec.max_batch, self.max_pages), -1, np.int32)
        self._len = np.zeros((ec.max_batch,), np.int32)
        self._slot_tenant = np.zeros((ec.max_batch,), np.int64)
        self._slots: List[Optional[dict]] = [None] * ec.max_batch
        self._queue: deque = deque()
        self._outputs: Dict = {}
        self._partial: Dict = {}
        self.errors: Dict = {}
        self.reasons: Dict = {}
        self._strikes: Dict[str, int] = {}
        self._disabled: set = set()
        self._admit_seq = 0
        self._step_count = 0
        self._chaos_pages: List[int] = []
        self._draining = False
        self._prev_handlers: Optional[dict] = None
        # device-resident decode ring: current token, output ring, counts
        dev = dict(dtype=torch.long, device=self.device)
        self._tok = torch.zeros((ec.max_batch, 1), **dev)
        self._out = torch.zeros((ec.max_batch, ec.max_out), **dev)
        self._counts = torch.zeros((ec.max_batch,), **dev)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.sample_seed)

    @property
    def step_count(self) -> int:
        return self._step_count

    def strikes(self, tenant: str) -> int:
        return self._strikes.get(tenant, 0)

    def disabled_tenants(self) -> tuple:
        return tuple(sorted(self._disabled))

    # -- device programs ---------------------------------------------------

    def _decode(self, state):
        """One batched decode step with the row-health guard.  Returns
        (state, tok, out, counts, fault)."""
        active = state.lengths > 0
        packed = self.params
        if self.adapters is not None:
            tenants = torch.as_tensor(self._slot_tenant, device=self.device)
            packed = batched_pack_tree(self.params, self.adapters.layout,
                                       self.adapters.b_full,
                                       self.adapters.projs, tenants)
        lg, nstate = decode_step_paged(packed, self._tok, self.cfg, state)
        row = lg[:, -1, :]
        hook = chaos.get()
        poison = [(r, mode) for s, r, mode in
                  (hook.logit_rows if hook is not None else ())
                  if s == self._step_count]
        if poison:      # chaos: a bf16 adapter overflow's signature
            row = row.clone()
            for r, mode in poison:
                row[r] = row[r] * (float("nan") if mode == "nan" else 0.0)
        # health looks at the REAL vocab lanes only: the -1e30 padding
        # fill would mask an all-mass collapse
        if self.ecfg.guard:
            row_ok = logits_row_ok(row[:, : self.cfg.vocab_size])
        else:
            row_ok = torch.ones_like(active)
        eff = active & row_ok
        ec = self.ecfg
        if ec.temperature > 0.0:
            vr = row[:, : self.cfg.vocab_size]
            nxt = select_tokens(vr, ec.temperature, ec.top_k,
                                gumbel_noise(self._gen, vr.shape))
        else:
            nxt = torch.argmax(row, dim=-1)
        out, counts = self._out, self._counts
        col = torch.arange(out.shape[1], device=self.device)
        write = (col[None, :] == counts[:, None]) & eff[:, None]
        out = torch.where(write, nxt[:, None], out)
        counts = counts + eff.long()
        tok = torch.where(eff[:, None], nxt[:, None], self._tok)
        # masked write-back: a faulted row's length does not advance, and
        # its slot-indexed SSM state keeps its pre-step value (the decode
        # step returned the new state beside the old one)
        nstate = nstate._replace(
            lengths=torch.where(row_ok, nstate.lengths, state.lengths))
        if nstate.ssm is not None:
            nstate = nstate._replace(ssm=type(nstate.ssm)(*(
                torch.where(row_ok.reshape((1, -1) + (1,) * (new.ndim - 2)),
                            new, old)
                for new, old in zip(nstate.ssm, state.ssm))))
        fault = active & ~row_ok
        return nstate, tok, out, counts, fault

    def _prefill_len(self, n: int) -> int:
        """Tokens of an ``n``-token sequence that prefill takes: all of
        them, but for the SSM and hybrid families the longest prefix the
        chunked scan takes (a multiple of ``ssd_chunk``, or all ``n``
        when shorter than one chunk).  Only a readmitted hybrid sequence
        leaves a tail: a submitted prompt off the chunk is refused."""
        q = self.cfg.ssd_chunk
        if self.cfg.family not in ("ssm", "hybrid") or n <= q:
            return n
        return n - n % q

    def _prefill(self, req: Request, pages: List[int], slot: int):
        """Prefill one request into its page chain (the dense family's
        KV, the hybrid's shared-block KV) and its slot's recurrent state
        (SSM, hybrid); a tail past :meth:`_prefill_len` is teacher-forced
        (:meth:`_teacher_force`).  Returns the first generated token, a
        device scalar (greedy)."""
        packed = self.params
        if self.adapters is not None:
            packed = self.adapters.lrpack_tree(self.params, req.tenant)
        page = self.ecfg.page_size
        n = len(pages)
        head = self._prefill_len(len(req.prompt))
        tmp = alloc_decode_state(self.cfg, 1, n * page, device=self.device)
        tokens = torch.as_tensor(req.prompt[None, :head], device=self.device)
        lg, tmp = prefill(packed, tokens, self.cfg, tmp)
        if tmp.ssm is not None:
            for arena, cache in zip(self.state.ssm, tmp.ssm):
                arena[:, slot] = cache[:, 0].to(arena.dtype)
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for cache, arenas in ((tmp.kv, (self.state.kv_k, self.state.kv_v)),
                              (tmp.shared_kv, (self.state.shared_k,
                                               self.state.shared_v))):
            if cache is None:
                continue
            for arena, c in zip(arenas, cache):
                # (L, 1, cap, H, D) -> (L, nP, page, H, D) -> arena pages
                blocks = c[:, 0].reshape((c.shape[0], n, page) + c.shape[3:])
                arena[:, idx] = blocks.to(arena.dtype)
        if head < len(req.prompt):
            lg = self._teacher_force(req, pages, slot, head)
        return torch.argmax(lg[0, -1])

    def _teacher_force(self, req: Request, pages: List[int], slot: int,
                       head: int):
        """Feed the prompt's tokens from ``head`` on through one-row paged
        decode steps of ``slot``: each writes its page chain and advances
        its recurrent state, as the decode steps that first produced them
        did.  Returns the last step's logits."""
        dev = self.device
        packed = self.params
        if self.adapters is not None:
            tenant = torch.tensor([self.adapters.tenant_index(req.tenant)],
                                  device=dev)
            packed = batched_pack_tree(self.params, self.adapters.layout,
                                       self.adapters.b_full,
                                       self.adapters.projs, tenant)
        pt = np.full((1, self.max_pages), -1, np.int32)
        pt[0, :len(pages)] = pages
        ssm = self.state.ssm
        st = self.state._replace(
            ssm=type(ssm)(*(x[:, slot:slot + 1] for x in ssm)),
            page_table=torch.as_tensor(pt, device=dev),
            lengths=torch.tensor([head], dtype=torch.int32, device=dev))
        tail = torch.as_tensor(req.prompt[head:], dtype=torch.long,
                               device=dev)
        for t in range(tail.shape[0]):
            lg, st = decode_step_paged(packed, tail[t].reshape(1, 1),
                                       self.cfg, st)
        for arena, new in zip(ssm, st.ssm):
            arena[:, slot] = new[:, 0]
        return lg

    # -- host-side bookkeeping ---------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_new > self.ecfg.max_out:
            raise ValueError(
                f"request {req.rid!r}: max_new={req.max_new} exceeds the "
                f"engine's max_out={self.ecfg.max_out}")
        if len(req.prompt) + req.max_new - 1 > self.ecfg.max_len:
            raise ValueError(
                f"request {req.rid!r}: prompt+max_new "
                f"{len(req.prompt) + req.max_new} exceeds "
                f"max_len={self.ecfg.max_len}")
        n = len(req.prompt)
        if self.cfg.family in ("ssm", "hybrid") and n and \
                n % min(self.cfg.ssd_chunk, n):
            # the chunked scan takes whole chunks (models/ssm.py); refused
            # here, before admission holds pages, not padded
            raise ValueError(
                f"request {req.rid!r}: a {n}-token prompt is no multiple "
                f"of the SSD chunk {self.cfg.ssd_chunk}")
        if self.adapters is not None:
            if req.tenant is None:
                raise ValueError(
                    f"request {req.rid!r}: engine has an adapter store — "
                    f"requests must name a tenant")
            if not self.adapters.has_tenant(req.tenant):
                raise KeyError(f"unknown tenant {req.tenant!r}")
        if req.tenant is not None and req.tenant in self._disabled:
            raise TenantQuarantinedError(
                f"request {req.rid!r}: tenant {req.tenant!r} is disabled "
                f"after {self._strikes.get(req.tenant, 0)} decode faults")
        if 0 < self.ecfg.max_queue <= len(self._queue):
            raise EngineBusy(
                f"admission queue is full ({self.ecfg.max_queue} "
                f"requests); resubmit {req.rid!r} later")
        req._born = self._step_count
        self._queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _fetch_row(self, slot: int) -> np.ndarray:
        n = self._slots[slot]["generated"]
        return self._out[slot, :n].cpu().numpy().astype(np.int32)

    def _release(self, slot: int) -> None:
        meta = self._slots[slot]
        self.pool.release(meta["pages"])
        self._pt[slot, :] = -1
        self._len[slot] = 0
        self._slot_tenant[slot] = 0
        self._slots[slot] = None

    def _finish(self, slot: int, reason: str) -> None:
        meta = self._slots[slot]
        row = self._fetch_row(slot)
        prior = self._partial.pop(meta["rid"], None)
        if prior is not None:
            row = np.concatenate([prior, row])
        self._outputs[meta["rid"]] = row
        self.reasons[meta["rid"]] = reason
        self._release(slot)

    def _quarantine(self, slot: int) -> None:
        """Row fault: fail the request, strike the tenant, free the slot.
        Co-tenants' device state was never touched (masked write-back)."""
        meta = self._slots[slot]
        rid, tenant = meta["rid"], meta["tenant"]
        self.errors[rid] = TenantQuarantinedError(
            f"request {rid!r}: decode row {slot} produced non-finite or "
            f"collapsed logits (tenant {tenant!r}); row quarantined")
        self.reasons[rid] = "quarantined"
        self._partial.pop(rid, None)
        self._release(slot)
        if tenant is not None:
            self._strikes[tenant] = self._strikes.get(tenant, 0) + 1
            if self._strikes[tenant] >= self.ecfg.max_strikes:
                self._disabled.add(tenant)

    def _evict_finished(self) -> None:
        """The eviction boundary: done, capped, expired (TTL or deadline
        storm) and disabled-tenant slots leave the batch here."""
        storm = chaos.deadline_storm(self._step_count)
        for slot in self._active_slots():
            meta = self._slots[slot]
            tenant = meta["tenant"]
            if tenant is not None and tenant in self._disabled:
                rid = meta["rid"]
                self.errors[rid] = TenantQuarantinedError(
                    f"request {rid!r}: tenant {tenant!r} was disabled "
                    f"while this request was in flight")
                self.reasons[rid] = "quarantined"
                self._partial.pop(rid, None)
                self._release(slot)
                continue
            done = meta["generated"] >= meta["max_new"]
            capped = int(self._len[slot]) >= self.ecfg.max_len
            ttl = meta["ttl"]
            expired = ttl is not None and (
                storm or self._step_count - meta["born"] >= ttl)
            if done or capped or expired:
                self._finish(
                    slot, "deadline" if expired and not done else "completed")

    def _expire_queued(self) -> None:
        """Deadlines and quarantines apply to queued requests too."""
        storm = chaos.deadline_storm(self._step_count)
        keep: deque = deque()
        while self._queue:
            req = self._queue.popleft()
            if req.tenant is not None and req.tenant in self._disabled:
                self.errors[req.rid] = TenantQuarantinedError(
                    f"request {req.rid!r}: tenant {req.tenant!r} is "
                    f"disabled")
                self.reasons[req.rid] = "quarantined"
                self._partial.pop(req.rid, None)
                continue
            if req.ttl is not None and (
                    storm or self._step_count - req._born >= req.ttl):
                prior = self._partial.pop(req.rid, None)
                self._outputs[req.rid] = (
                    prior if prior is not None else np.zeros((0,), np.int32))
                self.reasons[req.rid] = "deadline"
                continue
            keep.append(req)
        self._queue = keep

    def _preempt(self, slot: int) -> None:
        meta = self._slots[slot]
        row = self._fetch_row(slot)
        prior = self._partial.pop(meta["rid"], None)
        full = row if prior is None else np.concatenate([prior, row])
        if meta["generated"] >= meta["max_new"]:
            # already done — finishing beats recomputing
            self._outputs[meta["rid"]] = full
            self.reasons[meta["rid"]] = "completed"
            self._release(slot)
            return
        self._partial[meta["rid"]] = full
        # recompute-on-readmit: the prompt grows by what this residency
        # generated, the remaining budget shrinks by the same amount
        req = Request(meta["rid"], np.concatenate([meta["prompt"], row]),
                      meta["max_new"] - meta["generated"],
                      tenant=meta["tenant"], ttl=meta["ttl"])
        # seniority and deadline survive preemption (starvation guard)
        req._seq = meta["seq"]
        req._born = meta["born"]
        self._release(slot)
        self._queue.appendleft(req)

    def _admit(self) -> None:
        while self._queue:
            req = self._queue[0]
            slot = self._free_slot()
            if slot is None:
                return
            s_total = len(req.prompt)
            need = self.pool.pages_for(s_total) if self._paged else 0
            pages = self.pool.alloc(need)
            if pages is None:
                if not self._active_slots() and not self._chaos_pages \
                        and self.pool.available == self.num_pages:
                    raise RuntimeError(
                        f"request {req.rid!r} needs {need} pages but the "
                        f"pool only has {self.num_pages}; raise "
                        f"EngineConfig.num_pages")
                return  # backpressure: wait for evictions
            self._queue.popleft()
            try:
                nxt = self._prefill(req, pages, slot)
            except Exception:
                # leak-proof admission: a failed prefill returns the
                # whole chain before the error propagates
                self.pool.release(pages)
                raise
            tenant_idx = 0
            if self.adapters is not None:
                tenant_idx = self.adapters.tenant_index(req.tenant)
            if req._seq is None:
                req._seq = self._admit_seq
                self._admit_seq += 1
            self._pt[slot, :] = -1
            self._pt[slot, :need] = pages
            self._len[slot] = s_total
            self._slot_tenant[slot] = tenant_idx
            self._tok[slot, 0] = nxt
            self._out[slot] = 0
            self._out[slot, 0] = nxt
            self._counts[slot] = 1
            self._slots[slot] = {
                "rid": req.rid, "prompt": req.prompt,
                "max_new": req.max_new, "generated": 1,
                "tenant": req.tenant, "pages": list(pages),
                "seq": req._seq, "born": req._born, "ttl": req.ttl,
            }

    def _ensure_pages(self) -> None:
        if not self._paged:
            return      # no page chain grows, so nothing is preempted
        for slot in sorted(self._active_slots(),
                           key=lambda s: self._slots[s]["seq"]):
            meta = self._slots[slot]
            if meta is None:
                continue    # preempted earlier in this pass
            pos = int(self._len[slot])
            if pos % self.ecfg.page_size != 0:
                continue  # current page still has room
            pidx = pos // self.ecfg.page_size
            if pidx >= self.max_pages:
                continue  # at max_len; evicted next cycle
            got = self.pool.alloc(1)
            while got is None:
                victims = [s for s in self._active_slots() if s != slot]
                if victims:
                    self._preempt(max(victims,
                                      key=lambda s: self._slots[s]["seq"]))
                elif self._chaos_pages:
                    # a pool spike degrades to preemption, never to a
                    # crash of the last sequence
                    self.pool.release(self._chaos_pages)
                    self._chaos_pages = []
                else:
                    raise RuntimeError(
                        "page pool exhausted with a single active "
                        "sequence; raise EngineConfig.num_pages")
                got = self.pool.alloc(1)
            self._pt[slot, pidx] = got[0]
            meta["pages"].append(got[0])

    def _chaos_pool_tick(self) -> None:
        """Pool-exhaustion chaos: hold every free page for one step."""
        if self._chaos_pages:
            self.pool.release(self._chaos_pages)
            self._chaos_pages = []
        if chaos.pool_spike(self._step_count) and self.pool.available:
            got = self.pool.alloc(self.pool.available)
            if got is not None:
                self._chaos_pages = list(got)

    # -- the engine loop ---------------------------------------------------

    def step(self) -> bool:
        """One engine iteration.  Returns True if any work remains."""
        chaos.maybe_sigterm(self._step_count)
        self._chaos_pool_tick()
        self._evict_finished()
        self._expire_queued()
        self._admit()
        if not self._active_slots() and self._queue and self._chaos_pages:
            # everything waits behind a chaos spike: give the pages back
            self.pool.release(self._chaos_pages)
            self._chaos_pages = []
            self._admit()
        if not self._active_slots():
            if self._queue:
                raise RuntimeError(
                    "queued requests cannot be admitted (page pool or "
                    "batch too small) and nothing is running")
            return False
        self._ensure_pages()
        # _ensure_pages may have preempted; re-check who is still active
        active = self._active_slots()
        state = self.state._replace(
            page_table=torch.as_tensor(self._pt, device=self.device),
            lengths=torch.as_tensor(self._len, device=self.device))
        (self.state, self._tok, self._out, self._counts,
         fault) = self._decode(state)
        faulted: List[int] = []
        if self.ecfg.guard:
            host_fault = fault.cpu().numpy()   # the one fetch per step
            faulted = [s for s in active if host_fault[s]]
        for slot in active:
            if slot in faulted:
                continue
            self._slots[slot]["generated"] += 1
            self._len[slot] += 1
        for slot in faulted:
            self._quarantine(slot)
        self._step_count += 1
        return True

    def run(self) -> Dict:
        """Drain the queue; returns {rid: np.int32 generated tokens}.
        Failed requests surface in ``self.errors``; ``self.reasons``
        records why each request left the engine.  A SIGTERM/SIGINT
        during the loop drains: the current step completes, the engine
        snapshots to ``snapshot_dir`` (when set) and the finished
        outputs are returned."""
        self._install_handlers()
        try:
            while self._queue or self._active_slots():
                self.step()
                if self._draining:
                    if self.snapshot_dir is not None:
                        self.snapshot(self.snapshot_dir)
                    break
        finally:
            self._restore_handlers()
        self._evict_finished()
        out, self._outputs = self._outputs, {}
        return out

    # -- drain / snapshot / warm restart -----------------------------------

    def _on_signal(self, signum, frame) -> None:
        self._draining = True

    def _install_handlers(self) -> None:
        if self._prev_handlers is not None:
            return
        try:
            self._prev_handlers = {s: signal.signal(s, self._on_signal)
                                   for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:          # not the main thread: no drain
            self._prev_handlers = None

    def _restore_handlers(self) -> None:
        if self._prev_handlers:
            for s, h in self._prev_handlers.items():
                signal.signal(s, h)
        self._prev_handlers = None

    def _snapshot_tree(self) -> dict:
        dev = self.device
        tree = {"arena": self.state._replace(
                    page_table=torch.as_tensor(self._pt, device=dev),
                    lengths=torch.as_tensor(self._len, device=dev)),
                "tok": self._tok, "out": self._out, "counts": self._counts,
                "sample_gen": self._gen.get_state()}
        if self.adapters is not None:
            tree["adapter_b"] = tuple(self.adapters.b_full)
            tree["adapter_v"] = tuple(self.adapters.projs)
        return tree

    @staticmethod
    def _req_json(req: Request) -> dict:
        return {"rid": req.rid, "prompt": [int(t) for t in req.prompt],
                "max_new": req.max_new, "tenant": req.tenant,
                "ttl": req.ttl, "seq": req._seq, "born": req._born}

    def _snapshot_extra(self) -> dict:
        slots = []
        for meta in self._slots:
            if meta is None:
                slots.append(None)
                continue
            m = dict(meta)
            m["prompt"] = [int(t) for t in meta["prompt"]]
            slots.append(m)

        def rows(d):
            return {str(k): np.asarray(v).tolist() for k, v in d.items()}

        return {
            "engine_cfg": dataclasses.asdict(self.ecfg),
            "arch": self.cfg.name,
            "step_count": self._step_count,
            "admit_seq": self._admit_seq,
            "pt": self._pt.tolist(),
            "len": self._len.tolist(),
            "slot_tenant": self._slot_tenant.tolist(),
            "slots": slots,
            "queue": [self._req_json(r) for r in self._queue],
            "outputs": rows(self._outputs),
            "partial": rows(self._partial),
            "reasons": {str(k): v for k, v in self.reasons.items()},
            "errors": {str(k): str(v) for k, v in self.errors.items()},
            "strikes": dict(self._strikes),
            "disabled": sorted(self._disabled),
            "tenants": (dict(self.adapters._tenants)
                        if self.adapters is not None else None),
        }

    def snapshot(self, workdir: str, *, keep: int = 3) -> int:
        """Serialize the whole engine through the checkpoint layer (the
        arenas, page tables, slot map, output rings, adapter buffers, the
        sampling generator's state and host bookkeeping).  Request ids
        must be strings (they key the JSON manifest).  Returns the
        snapshot's step."""
        checkpoint.save(workdir, self._step_count, self._snapshot_tree(),
                        keep=keep, extra={"serve": self._snapshot_extra()})
        return self._step_count

    @classmethod
    def restore(cls, workdir: str, params, cfg, *,
                adapters: Optional[AdapterStore] = None,
                step: Optional[int] = None,
                snapshot_dir: Optional[str] = None,
                device=None) -> "Engine":
        """Warm-restart an engine from :meth:`snapshot` on ``device``.

        In-flight sequences resume mid-decode with the outputs an
        uninterrupted engine gives; queued requests, partial outputs,
        strikes and disabled tenants carry over.  ``adapters`` must be a
        store built for the same config and rank: its buffers and tenant
        map are overwritten from the snapshot."""
        if step is None:
            step = checkpoint.latest_step(workdir)
            if step is None:
                raise FileNotFoundError(
                    f"no engine snapshot found in {workdir!r}")
        ex = (checkpoint.read_manifest(workdir, step).get("extra")
              or {}).get("serve")
        if ex is None:
            raise IOError(f"checkpoint at step {step} in {workdir!r} is "
                          f"not an engine snapshot")
        if ex.get("arch") != cfg.name:
            raise ValueError(f"snapshot arch {ex.get('arch')!r} != engine "
                             f"config {cfg.name!r}")
        if (ex.get("tenants") is not None) != (adapters is not None):
            raise ValueError(
                "snapshot and restore disagree about the adapter store")
        eng = cls(params, cfg, adapters=adapters,
                  engine_cfg=EngineConfig(**ex["engine_cfg"]),
                  snapshot_dir=snapshot_dir, device=device)
        tree, _ = checkpoint.restore(workdir, step, eng._snapshot_tree())
        eng.state = tree["arena"]
        eng._tok, eng._out = tree["tok"], tree["out"]
        eng._counts = tree["counts"]
        eng._gen.set_state(tree["sample_gen"])
        if adapters is not None:
            adapters.b_full = list(tree["adapter_b"])
            adapters.projs = list(tree["adapter_v"])
            adapters._tenants = dict(ex["tenants"])
            adapters._proj_loaded = True
        eng._pt = np.asarray(ex["pt"], np.int32)
        eng._len = np.asarray(ex["len"], np.int32)
        eng._slot_tenant = np.asarray(ex["slot_tenant"], np.int64)
        eng._step_count = int(ex["step_count"])
        eng._admit_seq = int(ex["admit_seq"])
        eng.reasons = dict(ex["reasons"])
        eng._strikes = dict(ex["strikes"])
        eng._disabled = set(ex["disabled"])
        eng._outputs = {k: np.asarray(v, np.int32)
                        for k, v in ex["outputs"].items()}
        eng._partial = {k: np.asarray(v, np.int32)
                        for k, v in ex["partial"].items()}
        eng.errors = {k: TenantQuarantinedError(v)
                      for k, v in ex["errors"].items()}
        held: List[int] = []
        for slot, m in enumerate(ex["slots"]):
            if m is None:
                continue
            meta = dict(m)
            meta["prompt"] = np.asarray(m["prompt"], np.int32)
            meta["pages"] = [int(p) for p in m["pages"]]
            eng._slots[slot] = meta
            held.extend(meta["pages"])
        for r in ex["queue"]:
            req = Request(r["rid"], np.asarray(r["prompt"], np.int32),
                          r["max_new"], tenant=r["tenant"], ttl=r["ttl"])
            req._seq, req._born = r["seq"], r["born"]
            eng._queue.append(req)
        eng.pool.reserve(held)
        return eng
