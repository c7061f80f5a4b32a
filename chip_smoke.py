"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together, and the bounds-checked
   builds of the two SSD sources beside them), and counts the
   tensor-core instructions in the SASS: ``HGMMA`` (wgmma) in the
   forward's, the backward's, the merge's and the projection's
   libraries, ``HMMA`` (mma.sync) in the SSD kernel's, its backward's
   and the forward's (the fp32 small-rank route); none is a failure.
2. Holds both forms of the low-rank forward kernel (shared B at prefill,
   M = 128, or 1 for the unembedding; one B per row at decode, batch 4 x
   seq 1, read by tenant index from a store of 4 tenants with rows
   [0, 2, 2, 1]) against their plain PyTorch version at the five (K, N)
   shapes of qwen2-7b, at mamba2-780m's three and zamba2-7b's six
   (shared B at M = 512, or 1 for the unembedding), at
   mistral-nemo-12b's six, qwen3-moe-30b-a3b's four and
   deepseek-v2-236b's ten (M = 128, or 1 for the unembedding; deepseek's
   w_uk·w_uv in the shared-B form only: a decode step absorbs them), in
   bf16, and times kernel, plain version and a cuBLAS yardstick (the per-row-B form's three with the stream
   held while the host queues the calls, which leaves the host's time
   out, beside the eager time per call).  Holds the SSD intra-chunk
   kernel against its plain version at mamba2-780m's and zamba2-7b's
   four prefill shapes each (prompts of 100, 128, 256 and 512 tokens;
   zamba2's 112 heads at N = 64), fp32, with dt and
   A drawn by the mixer's laws, logs the launch split its plan chose,
   and times both the same way; then at mamba2-780m's training shape
   (BC 128 = batch 16 x 8 chunks), the forward and the backward kernel
   (``ssd_intra_chunk_bwd``), the backward also with a decay whose
   masked differences pass 4 x 88.7 (every gradient finite) and three
   launches bit-identical, timed queued and eager; the same at
   zamba2-7b's training shape (BC 64 = batch 8 x 1024, 112 heads, N =
   64; the backward's split logged: 7 slices of 16 heads, 448 heads
   CTAs, 2 column blocks, 128 group CTAs); then ``[ssd checked]``: both SSD
   kernels' bounds-checked builds at mamba2-780m's training shape,
   bit-identical to the unchecked builds, no index trapped.  Each
   forward row logs its launch plan
   (per pass of the mainloop: tile width, splits of K, cluster size,
   units, persistent or not; or the per-row-B kernel's), and a shared-B
   row of at most ``SKINNY_ROWS`` rows, which takes the per-row-B kernel,
   also the mainloop's time.  Then, at shapes whose passes split K
   (qwen2-7b w_down at 128 rows, both forms; llama-100m's backward),
   three launches queued back to back give bit-identical outputs and
   leave the tile counters zero.
3. Holds the training kernels against their plain versions at the
   llama-100m shapes, and times them the same way: the forward with its
   ``p`` residual and the backward at M = 16384 (batch 64 x seq 256) for
   the four (K, N) of the model (timed eager, and also with the stream
   held while the host queues them, kernel and cuBLAS yardstick alike),
   the merge at its four group shapes (bf16 W and V, fp32 B: the
   tensor-core route), subspace-Adam at the four group B shapes
   (against fused ``torch.optim.AdamW``; equal to its plain version in
   all four (b, g) dtype instances, route ``"vec16"``); and the
   compressed-state kernels at the same shapes: subspace-Lion (fp32
   state; equal in all four instances), the int8-moment Adam and Lion
   (bf16 b with rounding bits, and fp32 b without) and the
   stochastically rounded merge (bf16 W, V, B);
   the forward in its shared-B form (no ``p``) at M = 16384, as the
   forward-only ``lowrank_lr`` runs it; and GaLore's projection
   ``Gᵀ V`` at the four group shapes (fp32 G, bf16 V: the tensor-core
   route; its bound the larger of G's, V's and the output's bytes and
   the two bf16 products of G's hi and lo parts at the tensor-core
   peak).
4. Serves qwen2-7b at full width and 14 of its 28 layers in bf16 with 4
   tenants: 8 requests of 128 prompt tokens and 32 new tokens through
   the continuous-batching engine, and checks that the main path
   launched the forward kernel in both forms; profiles one 128-token
   prefill (device ms) and two decode steps, which must show no SIMT
   ``gemm_partial`` or ``finish`` row and no ``index_select`` of the
   adapters' B.
5. Checks lazy adapter serving against merged weights on a 2-layer
   full-width cut in fp32, and that a paged decode step makes no host
   sync, in fp32 and in bf16 (every bf16 launch on the tensor cores).
   Then the same two phases for mamba2-780m (48 layers, bf16, 4
   tenants, 8 requests of 100, 128, 256 and 512 prompt tokens, two of
   each, and 32 new tokens), which also checks that every prefill
   launched the SSD kernel once per layer, prints prefill time by prompt
   length and the peak memory, and profiles a 512-token prefill (with
   the SSD kernel's device time); its
   lazy == merged check prefills 256 tokens (two chunks).  Then a
   2-layer full-width fp32 cut of mamba2-780m serves two tenants
   (prefill of 256 tokens each, 4 decode steps at batch 2) through the
   kernels on the card and through the plain versions on the CPU, from
   the same weights and adapters, and holds the logits together.  Then
   the same for zamba2-7b, the hybrid (Mamba2 layers, one shared
   attention + MLP block after every 6th: its KV pages beside the
   per-slot SSM state), at full width and 27 of its 81 layers (the
   shared block 4 times, a 3-layer tail), one SSD launch a layer per
   prefill; its lazy == merged and card == plain checks on a 3-layer
   fp32 cut with ``attn_every`` 2 (a group, the shared block, a tail
   layer); ``[serve preempt zamba2]`` on that cut, where a pool of 26
   pages preempts one sequence, which re-enters (256 tokens prefilled,
   17 teacher-forced) and gives the tokens it gives alone; and
   ``[sampled decode]``: temperature / top-k sampling, the same seed
   twice, ``top_k = 1`` against greedy, every token in its step's kept
   set, frequencies from two fixed rows against the tempered softmax,
   and a sampled bf16 decode step under ``set_sync_debug_mode("error")``.
   ``[time]`` lines mark each phase's end.  Then
   mistral-nemo-12b at full width and 10 of its 40 layers (bf16, 4
   tenants, 4 requests of 128 prompt and 16 new tokens), every launch
   ``"tc"``.
   Then qwen3-moe-30b-a3b, the MoE family (128 experts, top-8, capacity
   dispatch), at full width and 6 of its 48 layers (4 tenants' B beside
   the weights do not fit the card at full depth, and 6 keep the run's
   time),
   bf16, 4 tenants, qwen2-7b's 8 requests: every low-rank forward
   launch (the attention projections and the unembedding; the expert
   products, adapters included, are library calls, as the reference's
   are einsums) on ``"tc"``, the share of routed pairs dropped by
   capacity at prefill and at decode, and the decode profile, which
   must show no gather of B; ``[lazy==merged qwen3moe]`` (a 2-layer
   fp32 cut, every expert merged as W_e + V_e B_eᵀ, prefill of 128
   tokens) and ``[serve==plain qwen3moe]`` (that cut, 2 tenants, 128
   tokens each and 4 decode steps, card against the CPU), each run
   routed alike (equal top-k experts and keep masks, the smallest
   k-th/(k+1)-th probability gap logged and above twice the largest
   probability difference, which rules out a flip); ``[bf16 decode qwen3moe]`` (no host
   sync, no gather of B under the profiler).  Then deepseek-v2-236b, the
   MLA family (latent KV attention with the absorbed paged decode, 160
   experts top-6 beside 2 shared ones, a leading dense layer), at full
   width and 4 of its 60 layers (the dense layer and 3 MoE layers), bf16,
   4 tenants, qwen2-7b's 8 requests: every row-1 launch ``"tc"`` and in
   the path's count (37 shared-B a prefill, 29 per-row-B a decode step),
   the capacity drops, the profiles; then ``[lazy==merged deepseek]``,
   ``[serve==plain deepseek]`` (its weights and adapters drawn on the
   card and copied to the CPU; the host's ``MemAvailable`` logged first)
   and ``[bf16 decode deepseek]`` on its 2-layer cut (the dense layer and
   one MoE layer), as qwen3-moe's.
6. Trains llama-100m at full width and depth (12 layers) with
   ``lowrank_adam``: bf16 compute over fp32 B masters and moments,
   Stiefel V at r = 128, batch 64 x seq 256, lazy_k = 4, 14 steps
   (three outer merges), and checks that the losses are finite and fall
   and that the path launched all four training kernels at every shape;
   then profiles two more steps.  Then three more runs at full width and
   depth, each printing its subspace-state bytes beside the fp32 run's:
   6b ``lowrank_adam`` on int8 moments with bf16 B masters (14 steps,
   lazy_k = 4), 6c ``lowrank_lion`` on int8 moments with bf16 masters
   and 6d ``lowrank_lion`` on fp32 state (8 steps, lazy_k = 3, lr 3e-4,
   beta2 0.99); each checks that its losses are finite and fall and that
   its kernels launched at every group shape.  Then the paper's
   comparison methods at full width and depth, each printing ms/step,
   tok/s, peak memory and optimizer-state bytes: 6e ``galore`` (8 steps,
   lazy_k = 4: two basis refreshes, whose step times print apart), 6f
   ``adamw`` (8 steps), both with falling losses, and 6g ``lowrank_lr``
   (9 steps, lazy_k = 4: two outer merges; finite losses, reported
   only: nine forward-only steps at 100M parameters move the loss by
   less than its noise).
7. Trains a 2-layer full-width cut of llama-100m in fp32 (TF32 off) for
   5 steps with lazy_k = 2 twice, from the same weights, V draws and
   batches: through the kernels on the card and through the plain
   versions on the CPU, and holds the per-step losses together; then the
   same with int8 moments and bf16 B masters over bf16 stored weights,
   once with ``lowrank_adam`` and once with ``lowrank_lion`` (V and the
   rounding bits drawn on the CPU for both sides); then ``galore``,
   ``adamw`` and ``lowrank_lr`` (its noise drawn on the CPU for both
   sides) in fp32; each logs its forward launches by route and fails
   unless every one took ``"simt"`` (fp32 at r = 128).  After phase 8's
   runs: ``[train mamba2]``,
   mamba2-780m at full width and depth (48 layers, bf16 compute over fp32
   B, m, v, r = 128), batch 16 x 1024, ``lazy_k`` 4, lr 1e-3, 10 steps:
   finite, falling losses, 96 SSD forward launches a step (48 and 48
   under remat) and 48 backward, every bf16 GEMM ``"tc"``, and a profile
   of two steps with the SSD backward's device time; then
   ``[train==plain mamba2]``, its 2-layer fp32 cut through the kernels
   against the CPU, as above.  Then ``[train zamba2]``: zamba2-7b, the
   hybrid, at full width and depth (81 Mamba2 layers, the shared
   attention + MLP block applied 13 times, 6,751,130,832 parameters;
   bf16 compute over fp32 B, m, v, r = 128), batch 8 x 1024, ``lazy_k``
   3, lr 5e-4, 10 steps: finite, falling losses, 162 SSD forward
   launches a step (81 and 81 under remat) and 81 backward at (64, 128,
   112, 64, 64), every bf16 GEMM ``"tc"``, ms/step, tok/s, peak and
   state bytes, and a profile of two inner steps; ``[train==plain
   zamba2]``, its 3-layer fp32 cut (``attn_every`` 2: a group, the
   shared block, a tail layer) at batch 1 x 256 through the kernels
   against the CPU; and ``[serve trained tenant zamba2 lazy==merged]``:
   that cut trained 2 steps on the card, its checkpoint loaded by
   ``load_tenant`` and served lazy == merged.  Then ``[train qwen3moe]``:
   qwen3-moe-30b-a3b at full width and 20 of its 48 layers (bf16 over
   fp32 B, m, v, Stiefel V at r = 128), batch 8 x 1024 (C = 640),
   ``lazy_k`` 3, lr 1e-3, 10 steps: finite, falling losses; the first
   step's remat recompute routed as its forward in every layer; the
   pairs dropped by capacity each step; peak GiB by init, inner step and
   outer step; ms per merge + resample and per resample; optimizer and
   subspace state against arithmetic; every launch of rows 1, 2, 3 and 6
   in the path's count, on ``"tc"``; a profile of two inner steps.
   ``[train==plain qwen3moe]``: its 2-layer fp32 cut at batch 1 x 256,
   lazy_k 2, 5 steps, each replayed on the CPU from the card's state,
   routed alike, the loss, every gradient and the merged W held
   together; and ``[serve trained tenant qwen3moe lazy==merged]``: that
   run's B and V installed as a tenant and served lazy == merged.
   ``python3 chip_smoke.py --qwen3moe-study`` runs only ``[train
   qwen3moe]`` at five lrs under one warm-up, 12 steps each.  To run
   these alone,
   import ``chip_smoke`` in a scratch script, build with
   ``_build.build_all`` and call ``train_zamba2(dev, mods, smi,
   configs)``, ``train_equals_plain(dev, mods, configs, "lowrank_adam
   fp32", (), ZAMBA_TRAIN_PLAIN_TOL, arch="zamba2-7b", batch=1)`` and
   ``serve_trained_zamba2(dev, mods, configs)``.
   ``python3 chip_smoke.py --zamba2-study`` runs only the measurements
   behind two choices of this path: the SSD backward's ragged heads
   instance (the ``_build.RAGGED`` build) timed against the
   constant-bound instance at both training shapes, and ``[train
   zamba2]`` at five lrs under one warm-up, 12 steps each (no result
   line).  Every phase takes about 900 s on an H100 80GB HBM3 at 700 W,
   the zamba2 training phases about 150 s of it; their CPU
   counterparts, against the JAX package at the reduced hybrid, are
   ``tests/test_torch_hybrid_train.py``.
8. The paper's samplers and the paths that use them: every sampler
   (Gaussian, Stiefel, coordinate, ``dependent_diag``) batched at the
   llama-100m group shapes, held to its laws on the card (``Vᵀ V``, one
   nonzero per column, ``sum(pi) = r``, ``E[V Vᵀ] = c I`` by Monte Carlo)
   with the coordinate and ``dependent_diag`` draws under
   ``set_sync_debug_mode("error")``; then 6a again with each other
   sampler (6h ``dependent_diag``, logging before each merge the pi it
   water-fills and after it the lift weights drawn, and the energy EMA's
   device time; 6i coordinate; 6j Gaussian); 6a at the paper's 512
   sequences as 8 accumulated microbatches (its peak within 1 GiB of
   6a's); and ``dependent_diag`` through the kernels against the plain
   route, as phase 7, the energy buffers held too.
9. Encoder fine-tuning (the paper's section 6.2.1): the forward and the
   merge at encoder-small's shapes, fp32, r = 4 (the small-rank routes:
   ``"tf32x3"``, 3xTF32 ``mma.sync`` with p formed in the tile, and
   ``"ew"``, an elementwise merge), against their plain versions, each
   timed queued and eager beside its library call; then encoder-small
   at its full size fine-tuned 200 steps by ``lowrank_lr`` under three
   samplers and by ``adamw``, with accuracy, ms/step and peaks (every
   ``lowrank_lr`` peak below ``adamw``'s; every r = 4 forward and merge
   on its small-rank route, none on SIMT).
10. Checkpoints and resilience, at llama-100m's full width and depth
   for 6a and 6b: two uninterrupted 8-step runs, with the health guard
   on and off (ms/step, device ms/step from a profiled step, peak),
   equal bit for bit; a run stopped by a chaos SIGTERM at step 4 after
   a checkpoint, resumed by a fresh Trainer and equal to them in every
   record, generator included (archive MB, save and restore seconds);
   a NaN step and a loss-spike step skipped with every record
   unchanged, and one guarded inner step under
   ``set_sync_debug_mode("error")``.  6a's checkpoint loaded by
   ``AdapterStore.load_tenant`` into a llama-100m engine and served,
   and a 2-layer fp32 cut's held lazy == merged; a flipped bit in the
   newest archive quarantined and walked back; one rollback (restore,
   the reseed's merges, the LR halved).  qwen2-7b and mamba2-780m
   engines (2 tenants, 6 requests) snapshot at step 3 and drained by a
   chaos SIGTERM at step 6, each snapshot restored into a fresh engine
   that finishes with an uninterrupted engine's tokens (MB, seconds).

Each ``[kernel]`` row and JSON entry names the route its launch took,
``"tc"`` (the tensor cores: TMA + ``wgmma``, or ``mma.sync`` for the SSD
kernel), ``"tf32x3"`` (the fp32 small-rank forward on ``mma.sync``),
``"ew"`` (the small-rank merge) or ``"simt"`` (JSON ``"path"``).  Rows
whose kernel takes about as long as the wrapper's host time (the
decode-shaped forward, the merges, the projection, the optimizer
updates, the SSD kernel) are
timed on the device alone: the stream is held while the host queues the
calls (JSON ``"timing": "queued"``, the eager time per call beside as
``"eager_ms"``).  The optimizer updates and the stochastically rounded
merge are also timed with the L2 cache flushed before each call, each
call by its own events: their smaller shapes fit in L2, and in training
their state was last read a step before.  After every
bf16 serving and training run the launch counters must show no forward
(any form), backward, plain merge or projection launch on the SIMT
route (the stochastically rounded merge of 6b and 6c runs on SIMT and
is reported so); the training profiles
print the forward's ``finish`` rows (the SIMT per-row-B epilogue, which
no bf16 step should run).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the
per-kernel JSON.  Any failed check exits non-zero.  Without CUDA the
script exits non-zero before printing any result.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
REPLACES = "src/repro/kernels/lowrank_forward.py:72"
# the per-row-B form: the reference's vmap of that kernel
BATCH_REPLACES = "src/repro/kernels/dispatch.py:450"
SOURCE = "src/repro_torch/kernels/csrc/lowrank_forward.cu"
# the per-row-B rows: a store of DEC_TENANTS adapters, batch rows reading
# DEC_ROWS (a repeated tenant and one never read)
DEC_TENANTS, DEC_ROWS = 4, (0, 2, 2, 1)
# (K, N) the low-rank forward sees in qwen2-7b -> (leaves, rows at
# prefill): a 128-token prefill runs the projections at M = 128 and the
# unembedding on the last position only
SHAPES = {(3584, 3584): ("wq,wo", 128), (3584, 512): ("wk,wv", 128),
          (3584, 18944): ("w_gate,w_up", 128),
          (18944, 3584): ("w_down", 128), (3584, 152064): ("unembed", 1)}
# qwen3-moe-30b-a3b (the MoE family; 128 experts, top-8) -> the (K, N)
# of its low-rank forward: wq, wk and wv, wo at a 128-token prefill, the
# unembedding on the last position.  The expert products are library
# calls, as the reference's are einsums outside any Pallas kernel.
MOE = "qwen3-moe-30b-a3b"
QWEN3_SHAPES = {(2048, 4096): ("wq", 128), (2048, 512): ("wk,wv", 128),
                (4096, 2048): ("wo", 128), (2048, 152064): ("unembed", 1)}
# deepseek-v2-236b (the MLA family: latent KV attention, 160 experts top-6
# beside 2 shared ones, a leading dense layer) -> the (K, N) of its
# low-rank forward at a 128-token prefill (the unembedding on the last
# position).  A decode step absorbs w_uk and w_uv into torch products
# (the reference's einsums), so their per-row-B form never launches on
# the path and their rows are shared-B only (DEEPSEEK_PREFILL_ONLY); the
# card tests hold that form at their shape too.
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_SHAPES = {(5120, 1536): ("w_dq", 128), (1536, 24576): ("w_uq", 128),
                   (5120, 576): ("w_dkv", 128),
                   (512, 16384): ("w_uk,w_uv", 128),
                   (16384, 5120): ("wo", 128),
                   (5120, 3072): ("shared w_gate,w_up", 128),
                   (3072, 5120): ("shared w_down", 128),
                   (5120, 12288): ("dense w_gate,w_up", 128),
                   (12288, 5120): ("dense w_down", 128),
                   (5120, 102400): ("unembed", 1)}
DEEPSEEK_PREFILL_ONLY = ((512, 16384),)
RANK = 128
RTOL = 2e-2        # bf16 output rounding, plus fp32 sums in another order
# times ``queued_ms`` may double its hold for a host too slow to queue
HOLD_DOUBLINGS = 4


def log(*a):
    print(*a, flush=True)


def short(arch):
    """A model's name in the phase tags: ``qwen3moe`` for
    qwen3-moe-30b-a3b, else the part before the first dash."""
    return arch.split("-")[0] + ("moe" if "-moe-" in arch else "")


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_L2_FLUSH = {}


def _l2_flush():
    """A buffer of twice the card's L2 cache: reading it evicts what the
    calls before left there."""
    dev = torch.cuda.current_device()
    if dev not in _L2_FLUSH:
        props = torch.cuda.get_device_properties(dev)
        l2 = getattr(props, "L2_cache_size", 0) or 50 << 20  # H100: 50 MB
        _L2_FLUSH[dev] = torch.zeros(2 * l2 // 4, device=dev)
    return _L2_FLUSH[dev]


def queued_ms(fn, calls=20, hold_s=0.05, cold=False):
    """Device ms per call of ``calls`` calls run back to back: the stream
    is held by a sleep kernel while the host queues them, so the host's
    time per call (longer than a decode-sized kernel's) is left out, as
    it is once a decode step runs as a CUDA graph.  ``cold``: each call
    instead gets a hold of its own (``hold_s / 5``), during which the
    host queues an L2 flush (a read of twice the cache) and the call
    between its own pair of events, so that the call's inputs come from
    HBM even where they would fit in L2; the device drains before the
    next call."""
    fn()
    if not cold:
        return _fitted_ms(fn, calls, hold_s)[0]
    flush = _l2_flush()
    flush.sum()         # its kernel loaded before the host is timed
    hold_s, ms = hold_s / 5, 0.0
    for _ in range(calls):
        one, hold_s = _fitted_ms(fn, 1, hold_s, before=flush.sum)
        ms += one / calls
    return ms


def _fitted_ms(fn, calls, hold_s, before=None):
    """``_held_ms`` under a hold the host queues within: a run the host
    queued in more than half its hold is run again with the hold doubled,
    at most ``HOLD_DOUBLINGS`` times, so that a busy host still finishes
    queueing before the stream starts.  Returns (device ms per call, the
    hold used); fails if no hold fitted."""
    for _ in range(HOLD_DOUBLINGS + 1):
        ms, queued = _held_ms(fn, calls, hold_s, before)
        if queued <= hold_s / 2:
            return ms, hold_s
        hold_s *= 2
    raise SystemExit(f"queued_ms: the host took {queued:.4f} s to queue "
                     f"{calls} calls, the stream was held {hold_s / 2} s")


def _held_ms(fn, calls, hold_s, before=None):
    """(device ms per call, host seconds to queue them) of ``calls``
    calls of ``fn`` queued while a sleep kernel holds the stream for
    ``hold_s``, ``before`` queued ahead of them, untimed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # at most 2 GHz on an H100: the stream is held at least hold_s
    torch.cuda._sleep(int(hold_s * 2e9))
    t0 = time.perf_counter()
    if before is not None:
        before()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, queued


def launch_path(mod, at=-3):
    """The route ("tc" or "simt") of the launches a wrapper module counted
    since its counters were reset (the route at place ``at`` of each
    counter's key): one, or the check fails."""
    paths = {k[at] for k in mod.LAUNCHES}
    if len(paths) != 1:
        raise SystemExit(f"expected launches by one route, counted "
                         f"{dict(mod.LAUNCHES)}")
    return paths.pop()


def require_tc(mods, tag, updates=False):
    """Fail when a launch that a bf16 main path must run on the tensor
    cores (the forward in every form, the backward; with ``updates``, a
    training run's plain merge and GaLore's projection) took the SIMT
    route; the stochastically rounded merge runs on SIMT and is reported
    so."""
    lf, lb, lu = mods["lf"], mods["lb"], mods.get("lu") if updates else None
    slow = {("lowrank_forward",) + k: n for k, n in lf.LAUNCHES.items()
            if k[1] == "simt"}
    slow.update({("lowrank_backward",) + k: n
                 for k, n in lb.LAUNCHES.items() if k[0] == "simt"})
    log(f"[{tag}] launches by route: forward tc={lf.launches(route='tc')} "
        f"simt={lf.launches(route='simt')} (batched "
        f"{lf.launches('batched')}), backward tc={lb.launches('tc')} "
        f"simt={lb.launches('simt')}")
    if lu is not None and lu.launches():
        slow.update({k: n for k, n in lu.LAUNCHES.items()
                     if k[0] != "lowrank_merge_sr" and k[1] == "simt"})
        log(f"[{tag}] update launches by route: " + ", ".join(
            f"{kernel} tc={lu.launches(kernel, 'tc')} "
            f"simt={lu.launches(kernel, 'simt')}"
            for kernel in ("lowrank_merge", "lowrank_merge_sr",
                           "lowrank_project") if lu.launches(kernel)))
    if slow:
        raise SystemExit(f"{tag}: bf16 launches took the SIMT route: {slow}")


def bound(M, K, N, r, n_b, itemsize):
    """Least time for the work: each input read once, y written once;
    operations at the bf16 tensor-core peak."""
    nbytes = (M * K + K * N + K * r + n_b * N * r + M * N) * itemsize
    ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def plan_of(lf, kind, M, K, N, r=RANK, seq=1, lb=None):
    """The launch plan of a ``[kernel]`` row, as the wrappers compute it
    from the shapes: for each pass of the mainloop its tile width, splits
    of K, units and whether the grid is persistent (more units than the
    SMs, each block walking several); for the per-row-B kernel (and a
    shared-B launch of at most ``lf.SKINNY_ROWS`` rows) its rows per
    tile, splits and rank slots."""
    def one(rows, cols, plan):
        bn, s, cluster = plan
        units = -(-rows // 128) * -(-cols // bn) * s
        return {"bn": bn, "splits": s, "cluster": cluster, "units": units,
                "persistent": units > lf.SMS}
    if kind == "backward":
        q, dx, db = lb.tc_plan(M, K, N, r)
        return {"route": "gemm", "q": one(M, r, q), "dx": one(M, K, dx),
                "dB": one(N, r, db)}
    plan = lf.tc_plan("shared" if kind == "batched" else kind, M, K, N, r)
    if kind == "batched" or plan["route"] == "skinny":
        bn, s_p, s_y, slots = lf.dec_plan(M, K, N, r,
                                          seq if kind == "batched" else M)
        return {"route": "skinny", "rows_per_tile": bn, "p_splits": s_p,
                "y_splits": s_y, "rank_slots": slots}
    return {"route": "gemm", "p": one(M, r, plan["p"]),
            "y": one(M, N, plan["y"])}


def gemm_route_ms(lf, fn):
    """``queued_ms`` of a shared-B call of at most ``lf.SKINNY_ROWS`` rows
    run on the mainloop instead of the per-row-B kernel (the threshold
    set to 0 for the call): the planner's other choice, timed beside."""
    rows = lf.SKINNY_ROWS
    lf.SKINNY_ROWS = 0
    try:
        return queued_ms(fn)
    finally:
        lf.SKINNY_ROWS = rows


def split_determinism(mods, dev, repeats=3):
    """Phase 2b: at shapes whose passes split K — qwen2-7b w_down at a
    128-token prefill (both forward forms), llama-100m (wq, wk, wv, wo)
    at M = 16384 (the backward's dB) — ``repeats`` launches queued back
    to back behind a held stream give bit-identical outputs, and leave
    the tile counters zero."""
    lf, lb = mods["lf"], mods["lb"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
    cases = []
    M, K, N = 128, 18944, 3584
    x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
    v, b = randn(K, RANK, scale=K ** -0.5), randn(N, RANK, scale=0.02)
    plan = plan_of(lf, "p", M, K, N)
    cases.append((f"forward (M={M}, K={K}, N={N}) {plan}",
                  plan["p"]["splits"] > 1 and plan["y"]["splits"] > 1,
                  lambda: (lf.lowrank_forward(x, w, v, b),
                           *lf.lowrank_forward(x, w, v, b, return_p=True))))
    Mt, Kt, Nt = TRAIN_M, 640, 640
    dy, wt = randn(Mt, Nt, scale=1e-2), randn(Kt, Nt, scale=Kt ** -0.5)
    vt, bt = randn(Kt, RANK, scale=RANK ** -0.5), randn(Nt, RANK, scale=0.02)
    pt = randn(Mt, RANK)
    plan = plan_of(lf, "backward", Mt, Kt, Nt, lb=lb)
    cases.append((f"backward (M={Mt}, K={Kt}, N={Nt}) {plan}",
                  plan["dB"]["splits"] > 1,
                  lambda: lb.lowrank_backward(dy, wt, vt, bt, pt)))
    for name, splits, fn in cases:
        if not splits:
            raise SystemExit(f"[determinism] {name}: no pass splits K")
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.02 * 2e9))
        outs = [fn() for _ in range(repeats)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for o in outs[1:]
                   for a, c in zip(outs[0], o))
        buf = lf._COUNTERS.get(x.device.index)
        zero = buf is not None and int(buf.abs().sum().item()) == 0
        log(f"[determinism] {name}: {repeats} queued launches bit-identical "
            f"{same}, tile counters left zero {zero}")
        if not (same and zero):
            raise SystemExit(f"[determinism] {name} failed")


def compare_kernels(lf, ref, dev, shapes=SHAPES, prefill_only=()):
    """Phase 2: kernel vs plain version and yardstick, both forms (the
    shared-B form alone at the (K, N) of ``prefill_only``), at the
    (K, N) -> (leaves, prefill rows) of ``shapes``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for (K, N), (leaves, prefill_rows) in shapes.items():
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        v = torch.randn((K, RANK), generator=gen, device=dev) / K ** 0.5
        forms = (("shared", prefill_rows, None), ("batched", 4, 4))
        for form, M, batch in forms[:1 if (K, N) in prefill_only else 2]:
            extra = ()
            if batch is None:
                x = torch.randn((M, K), generator=gen, device=dev)
                b = 0.02 * torch.randn((N, RANK), generator=gen, device=dev)
            else:
                x = torch.randn((batch, 1, K), generator=gen, device=dev)
                b = 0.02 * torch.randn((DEC_TENANTS, N, RANK), generator=gen,
                                       device=dev)
                extra = (torch.tensor(DEC_ROWS, device=dev),)
            x, wb, vb, b = (t.bfloat16() for t in (x, w, v, b))
            kern = lf.lowrank_forward if batch is None \
                else lf.lowrank_batch_forward
            plain = ref.lowrank_forward if batch is None \
                else ref.lowrank_batch_forward
            lf.reset_launches()
            y = kern(x, wb, vb, b, *extra)
            torch.cuda.synchronize()
            path = launch_path(lf)
            want = plain(x, wb, vb, b, *extra)
            err = (y.float() - want.float()).abs()
            scale = want.float().abs().max().item()
            ok = bool((err <= RTOL * scale + RTOL * want.float().abs())
                      .all().item())
            if not ok or not torch.isfinite(y).all().item():
                raise SystemExit(
                    f"kernel disagrees with its plain version: {form} "
                    f"K={K} N={N} max_abs_err={err.max().item():.4g}")

            if batch is None:
                def library():
                    return torch.matmul(x, wb) + torch.matmul(
                        torch.matmul(x, vb), b.mT)
            else:
                def library():
                    return torch.matmul(x, wb) + torch.matmul(
                        torch.matmul(x, vb), b[extra[0]].mT)
            # both forms on the device alone (the stream held while the
            # host queues the calls), the eager time per call beside
            host_ms = time_ms(lambda: kern(x, wb, vb, b, *extra), iters=50)
            ms = queued_ms(lambda: kern(x, wb, vb, b, *extra))
            plain_ms = queued_ms(lambda: plain(x, wb, vb, b, *extra))
            library_ms = queued_ms(library)
            rows_m = M if batch is None else batch
            plan = plan_of(lf, form, rows_m, K, N)
            # a shared-B row the per-row-B kernel takes: the mainloop's
            # time beside it
            other_ms = gemm_route_ms(lf, lambda: kern(x, wb, vb, b)) \
                if form == "shared" and plan["route"] == "skinny" else None
            # the per-row-B form reads each distinct tenant's B once
            bms, by = bound(rows_m, K, N, RANK, 1 if batch is None
                            else len(set(DEC_ROWS)), 2)
            rows.append(dict(form=form, K=K, N=N, M=rows_m, leaves=leaves,
                             path=path, max_abs_err=err.max().item(), ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bms, bound_by=by, host_ms=host_ms,
                             plan=plan, gemm_route_ms=other_ms))
            log(f"[kernel] {form:7s} M={rows_m:3d} K={K:5d} N={N:6d} "
                f"({leaves}) route={path} max_abs_err={err.max().item():.4g} "
                f"(tol {RTOL}*(max|y|+|y|), max|y|={scale:.3g}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} bound_ms={bms:.4f} ({by}) "
                f"[queued; eager {host_ms:.4f} ms/call] plan={plan}" + (
                    "" if other_ms is None else
                    f" mainloop_route_ms={other_ms:.4f}"))
            del x, b, y, want
        del w, v, wb, vb
    torch.cuda.empty_cache()
    return rows


def make_store(cfg, tcfg, n_tenants, dev, AdapterStore, scale=0.02):
    """A store with ``n_tenants`` random adapters over one shared V, each
    drawn in fp32 and rounded to the store's dtype as it is drawn (what
    the store would round it to), so no fp32 copy of a whole group is
    held (qwen3-moe's expert V is 6.4 GB in fp32)."""
    store = AdapterStore(cfg, tcfg, max_tenants=n_tenants, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    dt = store.projs[0].dtype
    projs = [(scale * torch.randn(v.shape, generator=gen, device=dev))
             .to(dt) for v in store.projs]
    for t in range(n_tenants):
        bs = [(scale * torch.randn(b.shape[:-3] + b.shape[-2:],
                                   generator=gen, device=dev)).to(dt)
              for b in store.b_full]
        store.add_tenant(f"tenant{t}", bs, projs)
        del bs
    return store


# (model, prompt lengths of its requests, max_len, new tokens a request):
# qwen2-7b's one prompt length; mamba2-780m's four, two requests each,
# give the SSD a chunk shorter than 128 (Q = 100), one chunk, and 2 or 4
# chunks, and zamba2-7b (81 Mamba2 layers at d 3584, 112 heads of 64,
# N 64, and one shared attention + MLP block applied 13 times) the
# same; mistral-nemo-12b (40 layers at d 5120, heads of 128 against
# 5120 / 32) four requests
SERVE_RUNS = {"qwen2-7b": ((128,) * 8, 160, 32),
              "mamba2-780m": ((100, 128, 256, 512) * 2, 544, 32),
              "zamba2-7b": ((100, 128, 256, 512) * 2, 544, 32),
              "mistral-nemo-12b": ((128,) * 4, 160, 16),
              MOE: ((128,) * 8, 160, 32), DEEPSEEK: ((128,) * 8, 160, 32)}
# depth cuts, the one cut of each such run: qwen3-moe-30b-a3b's 48 layers
# hold 61 GB of bf16 weights, its expert V 7.7 GB and each tenant's B
# 5.7 GB, 91 GB with 4 tenants against the card's 80 (24 layers hold 46).
# To keep every phase inside the run's time (the shapes, held at every
# depth, are unchanged): mistral-nemo-12b serves 10 of its 40 layers,
# qwen3-moe-30b-a3b 6 of 48, zamba2-7b 27 of 81 (the shared block 4 times
# and the 3-layer tail) and qwen2-7b 14 of 28: with the MoE training
# phases every phase took 1090 s at fuller depths on an H100, and 1214 s
# on a slower host.  deepseek-v2-236b serves 4 of its 60 layers (the
# dense layer and 3 MoE layers, so that the stacked layers run deeper
# than the leading one): 60 hold 471 GB of bf16 weights, 4 with 4
# tenants 30.5 GiB.  With its phases (about 30 s) every phase took 780 s
# on an H100 80GB HBM3 (700 W)
SERVE_LAYERS = {MOE: 6, "mistral-nemo-12b": 10, "zamba2-7b": 27,
                "qwen2-7b": 14, DEEPSEEK: 4}


class RouteTap:
    """Stands in for ``moe.route`` while entered and hands each routing
    to :meth:`seen`, which keeps what it needs on the device (no host
    sync: the counts and masks are read after the run)."""

    def __init__(self, moe_mod):
        self.moe, self.real = moe_mod, moe_mod.route

    def route(self, *a, **kw):
        r = self.real(*a, **kw)
        self.seen(r)
        return r

    def __enter__(self):
        self.moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


class DropShares(RouteTap):
    """The routed (token, expert) pairs that MoE capacity dropped, apart
    for prefill and decode (set ``phase`` before each)."""

    def __init__(self, moe_mod, dev):
        super().__init__(moe_mod)
        self.phase = "prefill"
        self.n = {k: [torch.zeros((), dtype=torch.long, device=dev), 0]
                  for k in ("prefill", "decode")}

    def seen(self, r):
        acc = self.n[self.phase]
        acc[0] += (~r.keep).sum()
        acc[1] += r.keep.numel()

    def shares(self):
        return {k: (int(d.item()), n) for k, (d, n) in self.n.items()}


class RoutingLog(RouteTap):
    """Each routing's top-k experts, keep mask, probabilities and
    smallest k-th/(k+1)-th probability gap."""

    def __init__(self, moe_mod):
        super().__init__(moe_mod)
        self.calls = []

    def seen(self, r):
        k = r.top_idx.shape[-1]
        top = torch.topk(r.probs, k + 1, dim=-1).values
        self.calls.append((r.top_idx, r.keep, r.probs,
                           (top[:, k - 1] - top[:, k]).min()))


def same_routing(tag, a, b, gap_rule=True):
    """Two runs routed alike: equal top-k and keep masks call by call, and
    (``gap_rule``) the smallest gap above twice the largest probability
    difference; both are logged."""
    if len(a.calls) != len(b.calls) or not a.calls:
        raise SystemExit(f"[{tag}] {len(a.calls)} routings against "
                         f"{len(b.calls)}")
    gap, dprob, dropped, pairs = math.inf, 0.0, 0, 0
    for n, ((ia, ka, pa, ga), (ib, kb, pb, gb)) in enumerate(
            zip(a.calls, b.calls)):
        if not (torch.equal(ia.cpu(), ib.cpu())
                and torch.equal(ka.cpu(), kb.cpu())):
            rows = (ia.cpu() != ib.cpu()).any(-1)
            d = (pa.double().cpu() - pb.double().cpu()).abs().max().item()
            raise SystemExit(
                f"[{tag}] the two runs routed differently in call {n} of "
                f"{len(a.calls)}: top-k of {int(rows.sum())} tokens, keep "
                f"of {int((ka.cpu() != kb.cpu()).sum())} pairs; smallest "
                f"gaps {ga.item():.3g} / {gb.item():.3g}, largest "
                f"probability difference {d:.3g}")
        gap = min(gap, ga.item(), gb.item())
        dprob = max(dprob, (pa.double().cpu() - pb.double().cpu()).abs()
                    .max().item())
        dropped += int((~ka).sum().item())
        pairs += ka.numel()
    log(f"[{tag}] routing equal over {len(a.calls)} calls: smallest "
        f"k-th/(k+1)-th probability gap {gap:.3g}, largest probability "
        f"difference {dprob:.3g}; {dropped} of {pairs} pairs dropped by "
        f"capacity")
    # a flip needs the k-th and (k+1)-th probabilities to cross, each
    # moving by at most dprob: a gap over 2 dprob rules it out
    if gap_rule and not gap > 2 * dprob:
        raise SystemExit(f"[{tag}] a routing gap {gap} within twice the "
                         f"largest probability difference {dprob}")


def serve(dev, mods, smi, arch="qwen2-7b"):
    """Phase 4: one model at full width and depth (or the depth of
    ``SERVE_LAYERS``), 4 tenants, the requests of ``SERVE_RUNS`` through
    the engine.  Returns the forward's launch counts and, for the SSM and
    hybrid families, the SSD kernel's; logs MoE's capacity drops."""
    import numpy as np
    lf, sc, lm, configs, serve_mod = (mods["lf"], mods["sc"], mods["lm"],
                                      mods["configs"], mods["serve"])
    tag = "serve" if arch == "qwen2-7b" else f"serve {short(arch)}"
    prompts, max_len, new = SERVE_RUNS[arch]
    cfg = configs.get_config(arch)
    full_depth = cfg.num_layers
    cfg = cfg.replace(num_layers=SERVE_LAYERS.get(arch, full_depth))
    log(f"[{tag}] {arch} d_model={cfg.d_model} layers={cfg.num_layers} "
        f"of {full_depth} vocab={cfg.vocab_size} dtype={cfg.dtype}" + (
            f" experts={cfg.num_experts} top_k={cfg.top_k} "
            f"moe_d_ff={cfg.moe_d_ff}" if cfg.family == "moe" else ""))
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.empty_cache()        # the init's fp32 draws, cached
    tcfg = configs.TrainConfig(rank=RANK)
    store = make_store(cfg, tcfg, 4, dev, serve_mod.AdapterStore)
    torch.cuda.synchronize()
    log(f"[{tag}] weights + 4 tenants made in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    ecfg = serve_mod.EngineConfig(page_size=16, max_batch=4, max_len=max_len,
                                  max_out=32)
    eng = serve_mod.Engine(params, cfg, adapters=store, engine_cfg=ecfg,
                           device=dev)
    # the peak above counts the weights' random init (each leaf drawn in
    # fp32); the serving peak counts what serving holds and allocates
    init_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    prefill_s, decode_s = [], []
    drops = DropShares(mods["moe"], dev) if cfg.family == "moe" else None

    def timed(fn, bucket, key=None, phase=None):
        def wrapper(*a, **kw):
            if drops is not None:
                drops.phase = phase
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            bucket.append(dt if key is None else (key(*a), dt))
            return out
        return wrapper

    eng._prefill = timed(eng._prefill, prefill_s,
                         key=lambda req, *_: len(req.prompt),
                         phase="prefill")
    eng._decode = timed(eng._decode, decode_s, phase="decode")
    rng = np.random.default_rng(0)
    for i, n in enumerate(prompts):
        eng.submit(serve_mod.Request(
            f"req{i}", rng.integers(0, cfg.vocab_size, n), new,
            tenant=f"tenant{i % 4}"))
    for mod in (lf, sc, mods["lb"]):
        mod.reset_launches()
    t0 = time.perf_counter()
    with drops or contextlib.nullcontext():
        out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, ssd_counts = dict(lf.LAUNCHES), dict(sc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_req = len(prompts)
    bad = [r for r, v in out.items()
           if len(v) != new or v.min() < 0 or v.max() >= cfg.vocab_size]
    if len(out) != n_req or bad or eng.errors or \
            set(eng.reasons.values()) != {"completed"}:
        raise SystemExit(f"serving failed: outputs {len(out)}/{n_req}, "
                         f"bad {bad}, errors {eng.errors}, "
                         f"reasons {eng.reasons}")
    if lf.launches("shared") == 0 or lf.launches("batched") == 0:
        raise SystemExit(f"the main path missed a kernel form: {counts}")
    require_tc(mods, tag)
    if cfg.family in ("ssm", "hybrid"):
        # one launch per layer and prefill, at the prompt's chunking
        want = {}
        for n in prompts:
            q = min(cfg.ssd_chunk, n)
            key = ("ssd_intra_chunk", (n // q, q, cfg.ssm_heads,
                                       cfg.ssm_head_dim, cfg.ssm_state))
            want[key] = want.get(key, 0) + cfg.num_layers
        log(f"[{tag}] launches ssd_intra_chunk " + ", ".join(
            f"{list(k[1])}={v}" for k, v in ssd_counts.items())
            + f"; {sc.launches() / len(prefill_s):.0f} per prefill")
        if ssd_counts != want:
            raise SystemExit(f"ssd_intra_chunk launches {ssd_counts}, the "
                             f"path should make {want}")
    n_tok = sum(len(v) for v in out.values())
    by_len = {}
    for n, dt in prefill_s:
        by_len.setdefault(n, []).append(dt)
    log(f"[{tag}] {n_req} requests x {new} tokens over 4 tenants: "
        f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s; "
        f"prefill ms/request by prompt length " + ", ".join(
            f"{n}: {1e3 * sum(v) / len(v):.1f}" for n, v in
            sorted(by_len.items()))
        + f" ({len(prefill_s)} prefills), decode "
        f"{1e3 * sum(decode_s) / len(decode_s):.1f} ms/step "
        f"({len(decode_s)} steps, batch 4); peak {peak / 2**30:.2f} GiB "
        f"allocated serving ({init_peak / 2**30:.2f} while the weights "
        f"and tenants were made) on {smi}")
    log(f"[{tag}] launches shared={lf.launches('shared')} "
        f"batched={lf.launches('batched')}; per step "
        f"{lf.launches('batched') / len(decode_s):.0f}, per prefill "
        f"{lf.launches('shared') / len(prefill_s):.0f}")
    if cfg.use_mla:
        # every leaf of the path carries an adapter at full width: a layer
        # makes 6 MLA (w_dq, w_uq, w_dkv, w_uk, w_uv, wo) + 3 MLP (the
        # leading layer's dense MLP, the shared experts') shared-B
        # launches a prefill and 4 + 3 per-row-B a decode step (w_uk and
        # w_uv absorbed), the unembedding one more each
        per = (9 * cfg.num_layers + 1, 7 * cfg.num_layers + 1)
        want = (per[0] * len(prefill_s), per[1] * len(decode_s))
        got = (lf.launches("shared", "tc"), lf.launches("batched", "tc"))
        log(f"[{tag}] row-1 launches on \"tc\": shared {got[0]}, batched "
            f"{got[1]}; the path's count {per[0]} a prefill x "
            f"{len(prefill_s)}, {per[1]} a decode step x {len(decode_s)} = "
            f"{want[0]}, {want[1]}; all routes {lf.launches()}")
        if got != want or lf.launches() != sum(want):
            raise SystemExit(f"{tag}: row-1 launches {dict(lf.LAUNCHES)} "
                             f"against the path's count {want}")
    if drops is not None:
        log(f"[{tag}] launches by (form, route, K, N): " + ", ".join(
            f"{k}={n}" for k, n in sorted(counts.items())))
        for phase, (n, pairs) in drops.shares().items():
            log(f"[{tag}] {phase}: {n} of {pairs} routed pairs dropped by "
                f"capacity ({100 * n / pairs:.2f}%)")
    log(f"[{tag}] first tokens req0: {out['req0'][:8].tolist()}")
    profile_prefill(params, store, cfg, lm, max(prompts), tag, rng)
    profile_decode(eng, cfg, serve_mod, rng, tag=tag,
                   steps=1 if cfg.family == "moe" else 2)
    del eng, store, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, ssd_counts


def device_rows(prof):
    """The profiler's device-side rows (a CPU op's row repeats its
    kernels' time) and their total device microseconds, aggregated once
    a profile: the aggregation walks every event in Python, 10-15 s for
    two serving decode steps on the card's host."""
    from torch.autograd import DeviceType
    if not hasattr(prof, "device_rows"):
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_us = sum(e.self_device_time_total for e in rows)
        if dev_us <= 0:
            raise SystemExit("the profiler saw no device time")
        rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
        prof.device_rows = rows, dev_us
    return prof.device_rows


def log_profile(tag, what, prof, wall, steps, top=8):
    rows, dev_us = device_rows(prof)
    log(f"[{tag}] {steps} {what}: host {1e3 * wall / steps:.1f} "
        f"ms each, device busy {dev_us / 1e3 / steps:.1f} ms each "
        f"({100 * dev_us / 1e6 / wall:.1f}% busy)")
    for e in rows[:top]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / steps:8.2f} "
            f"ms  x{e.count // steps:5d}  {e.key[:90]}")


def profile_prefill(params, store, cfg, lm, n, tag, rng):
    """Where one ``n``-token prefill's time goes (tenant 0's adapter)."""
    from torch.profiler import ProfilerActivity, profile
    dev = params["unembed"].device
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                             device=dev)
    packed = store.lrpack_tree(params, "tenant0")
    st = lm.alloc_decode_state(cfg, 1, n, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.prefill(packed, tokens, cfg, st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_profile(f"profile {tag}", f"prefill of {n} tokens", prof, wall, 1)
    if cfg.family in ("ssm", "hybrid"):
        rows, _ = device_rows(prof)
        # the chunk grid starts while the Gram grid runs: the sum of the
        # two counts their overlap twice
        ms, n = {}, {}
        for grid in ("gram", "chunk"):
            ssd = [e for e in rows if f"ssd_{grid}_kernel" in e.key]
            ms[grid] = sum(e.self_device_time_total for e in ssd) / 1e3
            n[grid] = sum(e.count for e in ssd)
        log(f"[profile {tag}] ssd_intra_chunk: {ms['gram'] + ms['chunk']:.2f} "
            f"device ms (Gram grids {ms['gram']:.2f} in {n['gram']}, chunk "
            f"grids {ms['chunk']:.2f} in {n['chunk']}; they overlap)")


def profile_decode(eng, cfg, serve_mod, rng, steps=2, tag="serve"):
    """Where a decode step's time goes: the device time by kernel over
    ``steps`` decode steps at batch 4 (torch.profiler), against the host
    clock.  The profiler slows the host, so the idle share it shows is
    an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(4):
        eng.submit(serve_mod.Request(
            f"prof{i}", rng.integers(0, cfg.vocab_size, 128), steps + 2,
            tenant=f"tenant{i}"))
    eng.step()                      # admissions (prefills) + one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    ptag = "profile" if tag == "serve" else f"profile {tag}"
    log_profile(ptag, "decode steps", prof, wall, steps)
    rows, _ = device_rows(prof)
    simt = [e.key for e in rows
            if "gemm_partial" in e.key or "finish" in e.key]
    gathers = b_gathers(prof)
    dec = sum(e.self_device_time_total for e in rows
              if "skinny_kernel" in e.key) / 1e3 / steps
    log(f"[{ptag}] the per-row-B forward's kernels {dec:.2f} ms/step; "
        f"SIMT rows {simt or 'none'}; index_select of a B stack "
        f"{gathers or 'none'}")
    if simt or gathers or dec <= 0:
        raise SystemExit(f"{tag}: the bf16 decode step ran the SIMT "
                         f"per-row-B path or gathered B: {simt}, {gathers}")


def b_gathers(prof):
    """The input shapes of a profile's gathers of the adapters' B: an
    ``index_select`` of a stack of 3 or more dims (read from the events
    themselves, not from a second aggregation by shape)."""
    return sorted({str(e.input_shapes) for e in prof.events()
                   if e.name == "aten::index_select" and e.input_shapes
                   and len(e.input_shapes[0]) >= 3})


def write_slot(ps, st, slot, pages, page):
    """Copy what a one-sequence prefill left in ``st`` into the paged
    state ``ps``: its recurrent state into slot ``slot``, its K/V (the
    dense layers', the hybrid's shared block's) into ``pages``, which
    hold the prefill cache's length."""
    if st.ssm is not None:
        for arena, cache in zip(ps.ssm, st.ssm):
            arena[:, slot] = cache[:, 0]
    for arenas, cache in (((ps.kv_k, ps.kv_v), st.kv),
                          ((ps.shared_k, ps.shared_v), st.shared_kv)):
        if cache is not None:
            for arena, c in zip(arenas, cache):
                arena[:, pages] = c[:, 0].reshape(
                    (c.shape[0], len(pages), page) + c.shape[3:])


def cut_config(configs, arch, dtype="float32"):
    """A full-width cut of ``arch`` (2 layers; zamba2-7b 3 layers with
    ``attn_every`` 2: one group, the shared block, one tail layer), in
    ``dtype`` (None keeps the model's)."""
    cfg = configs.get_config(arch)
    cut = dict(num_layers=3, attn_every=2) if cfg.family == "hybrid" \
        else dict(num_layers=2)
    if dtype is not None:
        cut.update(dtype=dtype, param_dtype=dtype)
    return cfg.replace(**cut)


def paged_from_prefill(lm, cfg, st, S, page, dev):
    """A one-slot paged state holding what a prefill of ``S`` tokens left
    in ``st`` (a cache of ``(S // page + 1) * page``), with room for one
    more token."""
    n_pages = S // page + 1
    ps = lm.alloc_paged_state(cfg, 1, n_pages, page, n_pages * page,
                              device=dev)
    write_slot(ps, st, 0, torch.arange(n_pages, device=dev), page)
    return ps._replace(
        page_table=torch.arange(n_pages, dtype=torch.int32,
                                device=dev)[None],
        lengths=torch.tensor([S], dtype=torch.int32, device=dev))


def lazy_equals_merged(dev, mods, arch="qwen2-7b", S=24, store=None,
                       tenant="tenant0", tag=None, gap_rule=True):
    """Phase 5: lazy (B, V) serving == merged W + V B^T, fp32, on the
    full-width cut of :func:`cut_config`: prefill of ``S`` tokens and one
    paged decode step.  ``store`` (of that cut) serves ``tenant`` in
    place of a random one.  MoE (every expert merged as W_e + V_e B_eᵀ)
    must route both runs alike (``gap_rule``: see :func:`same_routing`)."""
    lm, configs, serve_mod = mods["lm"], mods["configs"], mods["serve"]
    from repro_torch.models.common import tree_map
    from repro_torch.models.linear import effective_weight
    tag = tag or ("lazy==merged" if arch == "qwen2-7b"
                  else f"lazy==merged {short(arch)}")
    cfg = cut_config(configs, arch)
    params = lm.init_params(cfg, seed=3, device=dev)
    if store is None:
        store = make_store(cfg, configs.TrainConfig(rank=RANK), 1, dev,
                           serve_mod.AdapterStore)
    merged = tree_map(effective_weight, store.lrpack_tree(params, tenant))
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    page = 16
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device=dev)
    tenants = torch.zeros((1,), dtype=torch.long, device=dev)
    tenants = tenants + store.tenant_index(tenant)
    lazy_pre = store.lrpack_tree(params, tenant)
    lazy_dec = serve_mod.batched_pack_tree(params, store.layout,
                                           store.b_full, store.projs,
                                           tenants)
    logits, routes = [], []
    for pre_p, dec_p in ((lazy_pre, lazy_dec), (merged, merged)):
        routes.append(RoutingLog(mods["moe"]) if cfg.family == "moe"
                      else contextlib.nullcontext())
        with routes[-1]:
            st = lm.alloc_decode_state(cfg, 1, (S // page + 1) * page,
                                       device=dev)
            lg_pre, st = lm.prefill(pre_p, prompt, cfg, st)
            ps = paged_from_prefill(lm, cfg, st, S, page, dev)
            # the decode step must stay on the device (a host sync would
            # stall every layer and rule out graph capture): any sync
            # raises
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                lg_dec, _ = lm.decode_step_paged(dec_p, nxt, cfg, ps)
            finally:
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
        # the real vocab lanes: the padding's -1e30 would set the scale
        logits.append((lg_pre[..., :cfg.vocab_size].float(),
                       lg_dec[..., :cfg.vocab_size].float()))
    if cfg.family == "moe":
        same_routing(tag, *routes, gap_rule=gap_rule)
    tol = 1e-4     # relative to max|logit|: fp32 sums in another order
    for name, a, b in (("prefill", logits[0][0], logits[1][0]),
                       ("decode", logits[0][1], logits[1][1])):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        log(f"[{tag}] {name} logits max_abs_err={err:.3g} "
            f"max|logit|={scale:.3g} tol={tol}*max")
        if not torch.isfinite(a).all().item() or err > tol * scale:
            raise SystemExit(f"lazy serving disagrees with merged weights "
                             f"({name}: {err} > {tol * scale})")
    del params, store, merged, lazy_pre, lazy_dec
    torch.cuda.empty_cache()


def bf16_decode_without_sync(dev, mods, arch="qwen2-7b"):
    """Phase 5c: a bf16 paged decode step of a 2-layer full-width cut,
    batch 4 over a store of 4 tenants read in place, under
    ``set_sync_debug_mode("error")`` (any host sync raises), with every
    forward launch on the tensor cores; for MoE (whose expert products
    read each tenant's B stack outside the kernels) a second step under
    the profiler, which must gather no B."""
    lf, lm, configs, serve_mod = (mods["lf"], mods["lm"], mods["configs"],
                                  mods["serve"])
    cfg = configs.get_config(arch).replace(num_layers=2)
    params = lm.init_params(cfg, seed=3, device=dev)
    store = make_store(cfg, configs.TrainConfig(rank=RANK), DEC_TENANTS,
                       dev, serve_mod.AdapterStore)
    tenants = torch.tensor(DEC_ROWS, device=dev)
    packed = serve_mod.batched_pack_tree(params, store.layout, store.b_full,
                                         store.projs, tenants)
    page = 16
    ps = lm.alloc_paged_state(cfg, 4, 8, page, 2 * page, device=dev)
    ps = ps._replace(
        page_table=torch.arange(8, dtype=torch.int32,
                                device=dev).reshape(4, 2),
        lengths=torch.tensor([3, 9, 17, 30], dtype=torch.int32, device=dev))
    tok = torch.randint(0, cfg.vocab_size, (4, 1), device=dev)
    lf.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = lm.decode_step_paged(packed, tok, cfg, ps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tag = f"bf16 decode {short(arch)}"
    finite = bool(torch.isfinite(lg[..., :cfg.vocab_size]).all().item())
    log(f"[{tag}] 2 layers, batch 4 over {DEC_TENANTS} tenants: no host "
        f"sync; launches {dict(lf.LAUNCHES)}; logits finite {finite}")
    if not finite or lf.launches("batched", "tc") == 0:
        raise SystemExit(f"{tag}: non-finite logits or no tensor-core "
                         f"per-row-B launch")
    require_tc(mods, tag)
    if cfg.family == "moe":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            lm.decode_step_paged(packed, tok, cfg, ps)
            torch.cuda.synchronize()
        gathers = b_gathers(prof)
        log(f"[{tag}] index_select of a B stack "
            f"{gathers or 'none'} (the expert products read each tenant's "
            f"(E, n, r) view of the store)")
        if gathers:
            raise SystemExit(f"{tag}: the decode step gathered B: {gathers}")
    del params, store, packed
    torch.cuda.empty_cache()


# [serve==plain mamba2]: relative to max|logit| over the real vocab
# lanes; fp32 sums in another order.  About five times the gap measured
# on an H100 80GB HBM3 (700 W): 2.98e-6.
SERVE_PLAIN_TOL = 1.5e-5
# [serve==plain zamba2]: about five times the gap measured on an H100
# 80GB HBM3 (700 W), 4.86e-6: its cut adds a shared attention + MLP
# block and a third Mamba2 layer to mamba2's two
ZAMBA_PLAIN_TOL = 2.5e-5
# [serve==plain qwen3moe]: about five times the gap measured on an H100
# 80GB HBM3 (700 W), 2.49e-6: 2 full-width layers, 128 experts, a
# 128-token prefill whose capacity drops 41% of the pairs, routed alike
QWEN3_PLAIN_TOL = 1.25e-5
# [serve==plain deepseek]: about five times the gap measured on an H100
# 80GB HBM3 (700 W), 5.19e-6 (4.25e-6 to 5.34e-6 at five seeds): 2
# full-width layers, the dense one and an MoE layer of 160 experts
DEEPSEEK_PLAIN_TOL = 2.5e-5
# its weights' seed.  The cut routes 1 584 pairs over 160 experts, so a
# token's 6th and 7th probabilities can lie within the card's and the
# CPU's fp32 rounding of each other, where the two runs may pick
# different experts and no comparison of values holds: at seed 5 one
# token's pair crossed (gap 4.1e-8 against a largest probability
# difference of 8.9e-7), at seed 6 the gap rule failed (4.9e-7 against
# 6.3e-7).  At seed 11 the smallest gap is 3.72e-5, 59 times the
# difference (seeds 7 and 8: 42 and 55 times; 9 and 10: 3.5 times).
DEEPSEEK_PLAIN_SEED = 11


def mem_available_gib():
    """The host's ``MemAvailable`` (``/proc/meminfo``), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def serve_equals_plain(dev, mods, arch="mamba2-780m", S=256, steps=4,
                       tol=SERVE_PLAIN_TOL, draw_on_card=False, seed=5):
    """Phase 5b: the full-width fp32 cut of :func:`cut_config`, two
    tenants: prefill of ``S`` tokens per tenant, then ``steps`` batched
    paged decode steps on fixed tokens, through the kernels on the card
    and through the plain versions on the CPU, from the same weights and
    adapters (drawn on the CPU, or with ``draw_on_card`` on the card and
    copied over: deepseek's cut holds 5.4 G parameters, a minute of the
    CPU's generator; from ``seed``); the logits within ``tol`` ·
    max|logit|, and MoE routed alike on both."""
    lm, configs, serve_mod = mods["lm"], mods["configs"], mods["serve"]
    from repro_torch.models.common import tree_map
    cfg = cut_config(configs, arch)
    cpu = torch.device("cpu")
    log(f"[serve==plain {short(arch)}] host MemAvailable "
        f"{mem_available_gib():.1f} GiB before the phase")
    tcfg = configs.TrainConfig(rank=RANK)
    src = dev if draw_on_card else cpu
    params = lm.init_params(cfg, seed=seed, device=src)
    src_store = make_store(cfg, tcfg, 2, src, serve_mod.AdapterStore)
    gen = torch.Generator()
    gen.manual_seed(6)
    prompts = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (steps, 2, 1), generator=gen)
    page = 16
    mods["sc"].reset_launches()
    mods["lf"].reset_launches()
    runs, routes = [], []
    for where in (dev, cpu):
        routes.append(RoutingLog(mods["moe"]) if cfg.family == "moe"
                      else contextlib.nullcontext())
        with routes[-1]:
            if where == src:
                p, store = params, src_store
            else:
                p = tree_map(lambda t: t.to(where), params)
                store = serve_mod.AdapterStore(cfg, tcfg, max_tenants=2,
                                               device=where)
                for t in range(2):
                    store.add_tenant(
                        f"tenant{t}",
                        [b[..., t, :, :] for b in src_store.b_full],
                        src_store.projs)
            lgs = []
            # the recurrent state is per slot; the hybrid's shared block
            # reads slot t's K/V from pages [t P, (t + 1) P)
            n_pg = S // page + 1
            pages = torch.arange(2 * n_pg, dtype=torch.int32,
                                 device=where).reshape(2, n_pg)
            ps = lm.alloc_paged_state(cfg, 2, 2 * n_pg, page, n_pg * page,
                                      device=where)
            ps = ps._replace(page_table=pages,
                             lengths=torch.full((2,), S, dtype=torch.int32,
                                                device=where))
            for t in range(2):  # prefill each tenant's prompt into slot t
                st = lm.alloc_decode_state(cfg, 1, n_pg * page,
                                           device=where)
                lg, st = lm.prefill(store.lrpack_tree(p, f"tenant{t}"),
                                    prompts[t:t + 1].to(where), cfg, st)
                lgs.append(lg)
                write_slot(ps, st, t, pages[t].long(), page)
            packed = serve_mod.batched_pack_tree(
                p, store.layout, store.b_full, store.projs,
                torch.arange(2, device=where))
            for k in range(steps):
                lg, ps = lm.decode_step_paged(packed, toks[k].to(where),
                                              cfg, ps)
                lgs.append(lg)
        runs.append([g[..., :cfg.vocab_size].float().cpu() for g in lgs])
    if cfg.family == "moe":
        same_routing(f"serve==plain {short(arch)}", *routes)
    worst = 0.0
    for a, b in zip(*runs):
        err = (a - b).abs().max().item() / b.abs().max().item()
        if not torch.isfinite(a).all().item():
            raise SystemExit("serving through the kernels gave non-finite "
                             "logits")
        worst = max(worst, err)
    lf = mods["lf"]
    log(f"[serve==plain {short(arch)}] {arch} {cfg.num_layers} "
        f"layers fp32, 2 tenants: prefill of {S} tokens each + {steps} "
        f"decode steps at batch 2, card against cpu: max abs err / "
        f"max|logit| {worst:.3g} (tol {tol}); card launches "
        f"ssd_intra_chunk={mods['sc'].launches()}, lowrank_forward "
        f"shared={lf.launches('shared')} batched={lf.launches('batched')}")
    if cfg.family in ("ssm", "hybrid") and not mods["sc"].launches():
        raise SystemExit("the card run missed ssd_intra_chunk")
    if not (lf.launches("shared") and lf.launches("batched")):
        raise SystemExit("the card run missed a form of lowrank_forward")
    if worst > tol:
        raise SystemExit(f"serving through the kernels disagrees with the "
                         f"plain route: {worst} > {tol}")
    torch.cuda.empty_cache()


# [serve preempt zamba2]: (request, prompt tokens, new tokens) on the
# fp32 cut, pages of 16.  "old" and "young" hold 8 + 16 pages at
# admission and each take a page every 16 steps; with a pool of 26 the
# pool is dry when "old" needs its tenth page, 17 tokens into "young",
# which is preempted and re-enters with 273 tokens (256 prefilled, 17
# teacher-forced) once "old" has finished
PREEMPT_REQS = (("old", 128, 24), ("young", 256, 32))
PREEMPT_POOL, PREEMPT_MAX_LEN = 26, 304


def serve_preempt(dev, mods, smi, arch="zamba2-7b"):
    """[serve preempt zamba2]: on the full-width fp32 cut, two tenants, a
    page pool small enough that one sequence is preempted: the preempted
    request re-enters and gives the tokens the same request gives when
    served alone."""
    import numpy as np
    lm, configs, serve_mod = mods["lm"], mods["configs"], mods["serve"]
    tag = f"serve preempt {arch.split('-')[0]}"
    cfg = cut_config(configs, arch)
    params = lm.init_params(cfg, seed=7, device=dev)
    store = make_store(cfg, configs.TrainConfig(rank=RANK), 2, dev,
                       serve_mod.AdapterStore)
    rng = np.random.default_rng(9)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n)
               for rid, n, _ in PREEMPT_REQS}

    def engine(num_pages=0):
        return serve_mod.Engine(params, cfg, adapters=store, device=dev,
                                engine_cfg=serve_mod.EngineConfig(
                                    page_size=16, max_batch=2,
                                    num_pages=num_pages,
                                    max_len=PREEMPT_MAX_LEN, max_out=32))

    def submit(eng, reqs):
        for i, (rid, _, new) in enumerate(PREEMPT_REQS):
            if rid in reqs:
                eng.submit(serve_mod.Request(rid, prompts[rid], new,
                                             tenant=f"tenant{i}"))
    eng = engine(PREEMPT_POOL)
    seen = []
    preempt, teacher = eng._preempt, eng._teacher_force

    def record_preempt(slot):
        seen.append(("preempt", eng._slots[slot]["rid"],
                     eng._slots[slot]["generated"]))
        preempt(slot)

    def record_teacher(req, pages, slot, head):
        seen.append(("tail", req.rid, head, len(req.prompt) - head))
        return teacher(req, pages, slot, head)
    eng._preempt, eng._teacher_force = record_preempt, record_teacher
    submit(eng, prompts)
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = {}
    for rid in prompts:
        solo = engine()
        submit(solo, (rid,))
        want = solo.run()[rid]
        same[rid] = bool(np.array_equal(out.get(rid), want))
    log(f"[{tag}] {arch} {cfg.num_layers} layers fp32, pool of "
        f"{PREEMPT_POOL} pages of 16: {seen}; run in {wall:.2f} s; the "
        f"tokens == each request served alone {same}; reasons "
        f"{eng.reasons}; on {smi}")
    if not any(e[0] == "preempt" for e in seen) or \
            not any(e[0] == "tail" and e[3] > 0 for e in seen):
        raise SystemExit(f"{tag}: no sequence was preempted and "
                         f"teacher-forced back in: {seen}")
    if not all(same.values()) or set(eng.reasons.values()) != {"completed"}:
        raise SystemExit(f"{tag}: a preempted sequence gave other tokens "
                         f"than its unpreempted run: {same}")
    del eng, store, params
    free()


SAMPLE_Z = 6.0          # frequency limits in standard deviations
SAMPLE_DRAWS = 200_000  # draws per fixed logit row


def sampled_decode(dev, mods, smi, arch="zamba2-7b"):
    """[sampled decode]: temperature / top-k sampling on the card.  On
    the full-width fp32 cut (4 requests of 128 tokens, 16 new): the same
    seed gives the same tokens twice, ``top_k = 1`` the greedy tokens,
    and every sampled token lies in its step's kept set (the logits at or
    above the k-th largest).  Over ``SAMPLE_DRAWS`` draws from each of
    two fixed logit rows the frequencies are within ``SAMPLE_Z`` standard
    deviations of ``softmax(logits / T)`` restricted to the top k.  A
    sampled bf16 decode step (the bf16 cut) makes no host sync."""
    import numpy as np
    lm, configs, serve_mod = mods["lm"], mods["configs"], mods["serve"]
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.sampling import gumbel_noise, select_tokens
    tag = "sampled decode"
    cfg = cut_config(configs, arch)
    params = lm.init_params(cfg, seed=11, device=dev)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, 128) for _ in range(4)]
    picks = []

    def recording(logits, temperature, top_k, noise):
        tok = select_tokens(logits, temperature, top_k, noise)
        picks.append((logits, top_k, tok))
        return tok

    def run(params=params, cfg=cfg, **over):
        eng = serve_mod.Engine(params, cfg, device=dev,
                               engine_cfg=serve_mod.EngineConfig(
                                   page_size=16, max_batch=4, max_len=160,
                                   max_out=16, **over))
        for i, p in enumerate(prompts):
            eng.submit(serve_mod.Request(f"r{i}", p, 16))
        return eng, eng.run()
    engine_mod.select_tokens = recording
    try:
        _, a = run(temperature=0.8, top_k=50, sample_seed=3)
        _, b = run(temperature=0.8, top_k=50, sample_seed=3)
        outside = 0
        for logits, k, tok in picks:
            kth = torch.topk(logits.float(), k).values[:, -1]
            got = logits.float().gather(1, tok[:, None])[:, 0]
            outside += int((got < kth).sum().item())
        n_steps = len(picks)
        _, greedy = run()
        _, top1 = run(temperature=0.8, top_k=1, sample_seed=3)
    finally:
        engine_mod.select_tokens = select_tokens
    same_seed = all(np.array_equal(a[r], b[r]) for r in a)
    top1_greedy = all(np.array_equal(top1[r], greedy[r]) for r in greedy)
    left_greedy = sum(int((a[r] != greedy[r]).sum()) for r in a)
    log(f"[{tag}] {arch} {cfg.num_layers} layers fp32, T 0.8, top_k 50: "
        f"same seed -> same tokens {same_seed}; {n_steps} sampled steps, "
        f"{outside} tokens outside their step's kept set; top_k 1 == "
        f"greedy {top1_greedy}; {left_greedy} of "
        f"{sum(len(v) for v in a.values())} tokens off the greedy path")
    if not (same_seed and top1_greedy) or outside or not n_steps:
        raise SystemExit(f"{tag}: sampled decoding broke a law")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rows = 2.0 * torch.randn((2, 512), generator=gen, device=dev)
    worst = 0.0
    for temperature, top_k in ((1.0, 0), (0.7, 8)):
        for row in rows:
            draws = row.expand(SAMPLE_DRAWS, -1)
            tok = select_tokens(draws, temperature, top_k,
                                gumbel_noise(gen, draws.shape))
            freq = torch.bincount(tok, minlength=512).double() / SAMPLE_DRAWS
            scaled = row.double() / temperature
            if top_k:
                kth = torch.topk(scaled, top_k).values[-1]
                scaled = torch.where(scaled >= kth, scaled, float("-inf"))
            p = torch.softmax(scaled, dim=0)
            sigma = torch.sqrt(p * (1 - p) / SAMPLE_DRAWS)
            if (freq[p == 0] > 0).any().item():
                raise SystemExit(f"{tag}: a draw outside the top {top_k}")
            z = ((freq - p).abs() / sigma.clamp_min(1e-300))[p > 0]
            worst = max(worst, z.max().item())
    log(f"[{tag}] {SAMPLE_DRAWS} draws from each of 2 fixed rows of 512 "
        f"logits at (T, top_k) = (1.0, 0), (0.7, 8): largest "
        f"|freq - p| / sigma {worst:.2f} (limit {SAMPLE_Z})")
    if worst > SAMPLE_Z:
        raise SystemExit(f"{tag}: sampled frequencies off softmax(l / T)")
    del params
    free()
    # a sampled bf16 decode step: any host sync raises
    bcfg = cut_config(configs, arch, dtype=None)
    bparams = lm.init_params(bcfg, seed=11, device=dev)
    eng = serve_mod.Engine(bparams, bcfg, device=dev,
                           engine_cfg=serve_mod.EngineConfig(
                               page_size=16, max_batch=4, max_len=160,
                               max_out=16, temperature=0.8, top_k=50,
                               sample_seed=3))
    for i, p in enumerate(prompts):
        eng.submit(serve_mod.Request(f"r{i}", p, 16))
    eng.step()
    state = eng.state._replace(
        page_table=torch.as_tensor(eng._pt, device=dev),
        lengths=torch.as_tensor(eng._len, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, tok, *_ = eng._decode(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ok = bool(((tok >= 0) & (tok < bcfg.vocab_size)).all().item())
    log(f"[{tag}] a sampled bf16 decode step of the {bcfg.num_layers}-layer "
        f"cut at batch 4: no host sync; tokens in vocab {ok}; on {smi}")
    if not ok:
        raise SystemExit(f"{tag}: a sampled bf16 token outside the vocab")
    del eng, bparams
    free()


# ---------------------------------------------------------------------------
# The SSD intra-chunk kernel (mamba2-780m)
# ---------------------------------------------------------------------------

SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
SSD_REPLACES = "src/repro/kernels/ssd_chunk.py:63"
# (BC, Q, H, P, N) of mamba2-780m's prefills -> prompt tokens
SSD_SHAPES = {(1, 100, 48, 64, 128): "100-token prompt",
              (1, 128, 48, 64, 128): "128-token prompt",
              (2, 128, 48, 64, 128): "256-token prompt",
              (4, 128, 48, 64, 128): "512-token prompt"}
# the training shape: mamba2-780m at batch 16 x seq 1024 (8 chunks each)
SSD_TRAIN_SHAPE = (128, 128, 48, 64, 128)
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu"
# no Pallas kernel: the reference autodiffs its jnp ssd_chunked
SSD_BWD_REPLACES = "src/repro/models/ssm.py:82"
# relative to max|y| and max|state|.  The SIMT kernel this one replaced
# measured 0 at all four shapes on an H100 80GB HBM3 (700 W): it summed in
# the order of cuBLAS's unsplit FFMA GEMM and of torch's outer-dim scan.  The
# tensor-core kernel sums in another order (3xTF32 products, fp64 scan);
# the limit covers that and torch's fp32 scan on the card, under which
# clog (up to 317 in magnitude here, one fp32 step 3e-5) moves each decay
# factor by up to about 3e-5.
SSD_TOL = 1e-4
TF32_FLOP_PER_S = 495e12        # dense TF32 tensor-core peak
# mamba2-780m's projections (K, N) -> (leaves, prefill rows): the
# projections at the longest prompt, the unembedding at one position
MAMBA_SHAPES = {(1536, 6448): ("in_proj", 512),
                (3072, 1536): ("out_proj", 512),
                (1536, 50432): ("unembed", 1)}


# zamba2-7b's projections (K, N) -> (leaves, prefill rows): in_proj
# (z, x, B, C, dt: 2 x 7168 + 2 x 64 + 112 = 14576, no multiple of a
# tile), out_proj, the shared block's four attention projections (32
# heads of 112) and its MLP, at the longest prompt; the unembedding at
# one position
ZAMBA_SHAPES = {(3584, 14576): ("in_proj", 512),
                (7168, 3584): ("out_proj", 512),
                (3584, 3584): ("wq,wk,wv,wo", 512),
                (3584, 14336): ("w_gate,w_up", 512),
                (14336, 3584): ("w_down", 512),
                (3584, 32000): ("unembed", 1)}
# (BC, Q, H, P, N) of zamba2-7b's training step at batch 8 x 1024: 64
# chunks, 112 heads, N = 64 (the backward's heads instance with constant
# bounds at Q = 128, N = 64)
ZAMBA_TRAIN_SSD_SHAPE = (64, 128, 112, 64, 64)
# (BC, Q, H, P, N) of zamba2-7b's prefills: 112 heads, N = 64 (two state
# tiles against four strip pairs: chunk parts 2 and 3 own y rows alone)
ZAMBA_SSD_SHAPES = {(1, 100, 112, 64, 64): "100-token prompt",
                    (1, 128, 112, 64, 64): "128-token prompt",
                    (2, 128, 112, 64, 64): "256-token prompt",
                    (4, 128, 112, 64, 64): "512-token prompt"}


# mistral-nemo-12b's projections (K, N) -> (leaves, prefill rows): q is
# 32 heads of 128 (4096) against d 5120, k and v 8 of 128
NEMO_SHAPES = {(5120, 4096): ("wq", 128), (5120, 1024): ("wk,wv", 128),
               (4096, 5120): ("wo", 128), (5120, 14336): ("w_gate,w_up", 128),
               (14336, 5120): ("w_down", 128),
               (5120, 131072): ("unembed", 1)}


def _ssd_operands(gen, dev, shape, groups=1, strong=False):
    """x, dt, da, b, c (b and c (BC, Q, groups, N)) for the SSD kernels,
    dt and A by the mixer's laws (dt = softplus(z + dt_bias), z ~ N(0,
    1), dt_bias the inverse softplus of exp(U[log 1e-3, log 0.1]), A =
    -U[1, 16]); ``strong``: dt = softplus(z), the top of the range, so a
    masked clog_i - clog_j reaches hundreds."""
    BC, Q, H, P, N = shape

    def uniform(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev)
    dt0 = torch.exp(uniform(math.log(1e-3), math.log(0.1), H))
    dt_bias = 0.0 if strong else dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        torch.randn((BC, Q, H), generator=gen, device=dev) + dt_bias)
    da = dt * -uniform(1.0, 16.0, H)
    x = torch.randn((BC, Q, H, P), generator=gen, device=dev)
    b, c = (torch.randn((BC, Q, groups, N), generator=gen, device=dev)
            for _ in range(2))
    return x, dt, da, b, c


def compare_ssd_kernel(mods, dev, shapes=SSD_SHAPES):
    """Phase 3b: the SSD intra-chunk kernel against its plain version at
    the prefill shapes, in fp32 as the mixer calls it, with B and C one
    group broadcast over the heads (head stride 0, as the path passes
    them) and dt, A drawn by the mixer's laws: dt = softplus(z +
    dt_bias), z ~ N(0, 1), dt_bias the inverse softplus of exp(U[log
    1e-3, log 0.1]), A = -U[1, 16].  Kernel and plain version are timed
    on the device alone (the stream held while the host queues the
    calls), the wrapper's eager time beside.  The bound is the larger of
    the bytes and the 3xTF32 products (three TF32 products per
    multiply-add, the Gram once per B/C group) at the TF32 peak; the fp32
    SIMT bound beside it in the log.  The chunk's inputs stay in L2 across
    the calls, as in the path, where the causal conv has just written
    them.  No single PyTorch call computes this function: library_ms is
    null."""
    ref, sc = mods["ref"], mods["sc"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows = []
    for shape, tokens in shapes.items():
        BC, Q, H, P, N = shape
        x, dt, da, b, c = _ssd_operands(gen, dev, shape)
        b, c = (t.expand(-1, -1, H, -1) for t in (b, c))
        plan = sc.ssd_plan(BC, Q, H, N, P, True)
        log(f"[kernel] ssd_intra_chunk {list(shape)}: plan {plan.groups} "
            f"Gram group, {plan.pairs} strip pairs x {plan.gram_cols} "
            f"column blocks, {plan.parts} parts a head: {plan.gram_ctas} "
            f"Gram CTAs, then {plan.chunk_ctas} chunk CTAs (a programmatic "
            f"dependent launch) on 132 SMs")
        y, st = sc.ssd_intra_chunk(x, dt, da, b, c)
        torch.cuda.synchronize()
        want_y, want_st = ref.ssd_intra_chunk(x, dt, da, b, c)
        err = max(_agree(f"ssd y {shape}", y, want_y, SSD_TOL),
                  _agree(f"ssd state {shape}", st, want_st, SSD_TOL))
        rel = max((y - want_y).abs().max().item()
                  / want_y.abs().max().item(),
                  (st - want_st).abs().max().item()
                  / want_st.abs().max().item())
        clog = torch.cumsum(da, dim=1)
        overflow = (clog[:, :1] - clog[:, -1:]).max().item()
        # b and c count once per B/C group: a head broadcast (stride 0)
        # is one group read by every head, and its Gram is computed once
        groups = 1 if b.stride(2) == 0 else H
        ops = BC * (groups * Q * (Q + 1) * N
                    + H * (Q * (Q + 1) * P + 2 * Q * N * P))
        nbytes = 4 * (2 * BC * Q * H * P + 2 * BC * Q * H
                      + 2 * BC * Q * groups * N + BC * H * N * P)
        bms, by = bound_of(nbytes, 3 * ops, TF32_FLOP_PER_S)
        fp32_bms, fp32_by = bound_of(nbytes, ops, FP32_FLOP_PER_S)
        r = dict(shape=shape, tokens=tokens, max_abs_err=err,
                 ms=queued_ms(lambda: sc.ssd_intra_chunk(x, dt, da, b, c)),
                 plain_ms=queued_ms(lambda: ref.ssd_intra_chunk(x, dt, da,
                                                                b, c)),
                 library_ms=None, bound_ms=bms, bound_by=by,
                 eager_ms=time_ms(lambda: sc.ssd_intra_chunk(x, dt, da, b,
                                                             c), iters=50))
        rows.append(r)
        log(f"[kernel] ssd_intra_chunk {list(shape)} ({tokens}) route=tc max_abs_err={err:.4g} (max rel {rel:.3g}, "
            f"tol {SSD_TOL}*max; the largest masked clog_i - clog_j "
            f"{overflow:.1f}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms=null bound_ms={bms:.4f} ({by}; fp32 SIMT "
            f"{fp32_bms:.4f}, {fp32_by}) [queued; eager "
            f"{r['eager_ms']:.4f} ms/call]")
        del x, dt, da, b, c, y, st, want_y, want_st
    torch.cuda.empty_cache()
    return rows


def compare_ssd_bwd_kernel(mods, dev, shape=SSD_TRAIN_SHAPE):
    """Phase 3b: the SSD backward kernel against its plain version at the
    training shape, fp32, one B/C group (as the mixer passes it), dt and A
    by the mixer's laws, then again with a decay whose masked clog
    differences pass 4 x 88.7 (every gradient finite); three launches
    queued back to back bit-identical.  The kernel timed queued (the
    stream held while the host queues the calls) and eager, the plain
    version eager, with events; the bound is the larger of the bytes (each
    input read once, each output written once) and the causal half's
    multiply-adds as 3xTF32 products at the TF32 peak (the fp32 SIMT bound
    beside it in the log).  No PyTorch call computes it: library_ms is
    null."""
    ref, sc = mods["ref"], mods["sc"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    BC, Q, H, P, N = shape
    out = None
    for strong in (False, True):
        x, dt, da, b, c = _ssd_operands(gen, dev, shape, strong=strong)
        dy = torch.randn_like(x)
        ds = torch.randn((BC, H, N, P), generator=gen, device=dev)
        ops = (x, dt, da, b, c, dy, ds)
        runs = [sc.ssd_intra_chunk_bwd(*ops) for _ in range(3)]
        torch.cuda.synchronize()
        want = ref.ssd_intra_chunk_bwd(*ops)
        clog = torch.cumsum(da, dim=1)
        reach = (clog[:, :1] - clog[:, -1:]).max().item()
        if strong and not reach > 4 * 88.7:
            raise SystemExit(f"the strong-decay case reaches only {reach}")
        err, rel = 0.0, 0.0
        for name, got, w in zip(("dx", "ddt", "dda", "db", "dc"), runs[0],
                                want):
            if not torch.isfinite(w).all().item():
                raise SystemExit(f"ssd bwd plain {name} is not finite")
            err = max(err, _agree(f"ssd bwd {name} {shape}", got, w,
                                  SSD_TOL))
            rel = max(rel, (got - w).abs().max().item()
                      / w.abs().max().item())
        same = all(torch.equal(a, b) for again in runs[1:]
                   for a, b in zip(runs[0], again))
        if not same:
            raise SystemExit("ssd_intra_chunk_bwd: three launches differ")
        log(f"[kernel] ssd_intra_chunk_bwd {list(shape)} "
            f"({'strong decay' if strong else 'mixer laws'}) route=tc "
            f"max_abs_err={err:.4g} (max rel {rel:.3g}, tol {SSD_TOL}*max "
            f"per output; the largest masked clog_i - clog_j {reach:.1f}); "
            f"every gradient finite; 3 launches bit-identical")
        if not strong:
            groups = 1
            tri = Q * (Q + 1) // 2
            ops_n = 2 * (BC * H * (2 * tri * P + 2 * Q * N * P)
                         + BC * groups * 3 * tri * N)
            # x, dy, dx; ds (BC, H, N, P); dt, da, ddt, dda; b, c, db, dc
            nbytes = 4 * (3 * BC * Q * H * P + BC * H * N * P
                          + 4 * BC * Q * H + 4 * BC * Q * groups * N)
            bms, by = bound_of(nbytes, 3 * ops_n, TF32_FLOP_PER_S)
            fp32_bms, fp32_by = bound_of(nbytes, ops_n, FP32_FLOP_PER_S)
            ms = queued_ms(lambda: sc.ssd_intra_chunk_bwd(*ops), calls=10)
            eager_ms = time_ms(lambda: sc.ssd_intra_chunk_bwd(*ops), iters=10)
            plain_ms = time_ms(lambda: ref.ssd_intra_chunk_bwd(*ops),
                               iters=3, warmup=1)
            plan = sc.ssd_bwd_plan(BC, H, N, 1)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    sc.ssd_intra_chunk_bwd(*ops)
                torch.cuda.synchronize()
            rows, _ = device_rows(prof)
            grids = {grid: sum(e.self_device_time_total for e in rows
                               if f"ssd_bwd_{grid}_kernel" in e.key) / 5e3
                     for grid in ("heads", "groups")}
            out = dict(shape=shape, max_abs_err=err, ms=ms,
                       eager_ms=eager_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bms, bound_by=by,
                       grids_ms=grids)
            log(f"[kernel] ssd_intra_chunk_bwd {list(shape)} route=tc: plan "
                f"{plan.slices} slices of {plan.heads_per_slice} heads, "
                f"{plan.heads_ctas} heads CTAs, then {plan.n_blocks} column "
                f"blocks of {sc.GROUP_COLS}, {plan.group_ctas} group CTAs; "
                f"ms={ms:.4f} [queued; eager {eager_ms:.4f} ms/call] "
                f"plain_ms={plain_ms:.4f} library_ms=null bound_ms="
                f"{bms:.4f} ({by}; fp32 SIMT {fp32_bms:.4f}, {fp32_by}; "
                f"{nbytes / 1e6:.0f} MB, {ops_n / 1e9:.1f} GFLOP); device ms "
                f"a call: heads grid {grids['heads']:.4f}, group grid "
                f"{grids['groups']:.4f}")
        else:
            out["max_abs_err"] = max(out["max_abs_err"], err)
        del x, dt, da, b, c, dy, ds, ops, runs, want
    torch.cuda.empty_cache()
    return out


def ragged_bwd_ms(mods, dev, shape):
    """The backward's ragged heads instance (``_build.RAGGED``, the
    instance every shape but the training shapes takes) against the
    constant-bound instance ``shape`` takes (Q = 128, P a multiple of 64,
    N = 128 or 64) on the same inputs, dt and A by the mixer's laws, each
    timed queued: what the ragged instance's runtime loop bounds cost.
    The two must give the same outputs bit for bit."""
    from repro_torch.kernels import _build
    sc = mods["sc"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    BC, Q, H, P, N = shape
    x, dt, da, b, c = _ssd_operands(gen, dev, shape)
    dy = torch.randn_like(x)
    ds = torch.randn((BC, H, N, P), generator=gen, device=dev)
    ts = [x, dt, da, b, c, dy, ds]
    plan = sc.ssd_bwd_plan(BC, H, N, 1)
    outs = {d: [torch.empty_like(t) for t in ts[:5]]
            for d in ((), _build.RAGGED)}
    for d, o in outs.items():
        sc._bwd_launch(ts, o, plan, d)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
        raise SystemExit(f"ssd_intra_chunk_bwd {list(shape)}: the ragged "
                         f"instance's outputs differ from the constant-bound "
                         f"instance's")
    ms = {d: queued_ms(lambda d=d: sc._bwd_launch(ts, outs[d], plan, d),
                       calls=10) for d in outs}
    log(f"[zamba2 study] ssd_intra_chunk_bwd {list(shape)}: the ragged "
        f"heads instance {ms[_build.RAGGED]:.4f} ms queued against the "
        f"constant-bound instance's {ms[()]:.4f} "
        f"({ms[_build.RAGGED] / ms[()]:.3f}x), outputs bit-identical")


def ssd_checked(mods, dev, shape=SSD_TRAIN_SHAPE):
    """[ssd checked]: the bounds-checked build of both SSD kernels
    (``_build.CHECKED``: every shared-memory and global index asserted,
    a printf and a trap on the first outside its array) at the training
    shape, the forward with B/C broadcast over the heads (as the mixer
    passes them) and the backward with one group; each output must equal
    the unchecked build's bit for bit, and the device must raise no error
    (a trap surfaces at the synchronisation)."""
    sc = mods["sc"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    BC, Q, H, P, N = shape
    x, dt, da, b, c = _ssd_operands(gen, dev, shape)
    bh, ch = (t.expand(-1, -1, H, -1) for t in (b, c))
    dy = torch.randn(x.shape, generator=gen, device=dev)
    ds = torch.randn((BC, H, N, P), generator=gen, device=dev)
    t0 = time.perf_counter()
    fwd = [sc.ssd_intra_chunk(x, dt, da, bh, ch, checked=chk)
           for chk in (False, True)]
    bwd = [sc.ssd_intra_chunk_bwd(x, dt, da, b, c, dy, ds, checked=chk)
           for chk in (False, True)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = [torch.equal(u, w) for u, w in zip(fwd[0] + bwd[0],
                                               fwd[1] + bwd[1])]
    log(f"[ssd checked] {list(shape)}: forward (y, state) and backward "
        f"(dx, ddt, dda, db, dc) of the checked build bit-identical to the "
        f"unchecked build's: {same}; no index trapped ({secs:.2f} s for "
        f"both builds' calls)")
    if not all(same):
        raise SystemExit("[ssd checked] the checked build's outputs differ")
    del x, dt, da, b, c, bh, ch, dy, ds, fwd, bwd
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training (llama-100m)
# ---------------------------------------------------------------------------

FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TRAIN_ARCH = "llama-100m"
TRAIN_BATCH, TRAIN_SEQ = 64, 256
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
# (K, N) the low-rank forward and backward see in llama-100m -> leaves
TRAIN_SHAPES = {(640, 640): "wq,wk,wv,wo", (640, 1712): "w_gate,w_up",
                (1712, 640): "w_down", (640, 32256): "unembed"}
# the grouped weight buffers the merge sees -> leaves
MERGE_SHAPES = {(4, 12, 640, 640): "wq,wk,wv,wo",
                (2, 12, 640, 1712): "w_gate,w_up",
                (1, 12, 1712, 640): "w_down", (1, 640, 32256): "unembed"}
TRAIN_REPLACES = {
    "lowrank_forward[p]": "src/repro/kernels/lowrank_forward.py:72",
    "lowrank_backward": "src/repro/kernels/lowrank_backward.py:64",
    "lowrank_merge": "src/repro/kernels/lowrank_update.py:38",
    "subspace_adam": "src/repro/kernels/subspace_adam.py:80",
    "lowrank_merge_sr": "src/repro/kernels/lowrank_update.py:69",
    "subspace_lion": "src/repro/kernels/subspace_adam.py:123",
    "subspace_adam_q8": "src/repro/kernels/subspace_adam.py:179",
    "subspace_lion_q8": "src/repro/kernels/subspace_adam.py:246",
    "lowrank_forward[shared]": "src/repro/kernels/lowrank_forward.py:72",
    "lowrank_project": "src/repro/kernels/lowrank_update.py:113"}
TRAIN_SOURCES = {
    "lowrank_forward[p]": "src/repro_torch/kernels/csrc/lowrank_forward.cu",
    "lowrank_backward": "src/repro_torch/kernels/csrc/lowrank_backward.cu",
    "lowrank_merge": "src/repro_torch/kernels/csrc/lowrank_merge.cu",
    "subspace_adam": "src/repro_torch/kernels/csrc/subspace_adam.cu",
    "lowrank_merge_sr": "src/repro_torch/kernels/csrc/lowrank_merge.cu",
    "subspace_lion": "src/repro_torch/kernels/csrc/subspace_adam.cu",
    "subspace_adam_q8": "src/repro_torch/kernels/csrc/subspace_q8.cu",
    "subspace_lion_q8": "src/repro_torch/kernels/csrc/subspace_q8.cu",
    "lowrank_forward[shared]":
        "src/repro_torch/kernels/csrc/lowrank_forward.cu",
    "lowrank_project": "src/repro_torch/kernels/csrc/lowrank_project.cu"}
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.05)
LION = dict(beta1=0.9, beta2=0.99, wd=0.05)
QROW = 128                      # elements per int8 scale (optim.quant)


def time_auto(fn, budget_s=0.3):
    """ms per call: one warm-up call, one timed call, then as many calls
    (3 to 20) as fit in ``budget_s``."""
    fn()
    once = time_ms(fn, iters=1, warmup=0)
    iters = int(max(3, min(20, budget_s * 1e3 / max(once, 1e-3))))
    return time_ms(fn, iters=iters, warmup=0)


def bound_of(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _agree(name, got, want, tol_max, tol_elt=0.0):
    """max |got - want| within tol_max * max|want| + tol_elt * |want|
    everywhere; returns the max abs error."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    ok = bool((err <= tol_max * scale + tol_elt * want.float().abs())
              .all().item())
    if not ok or not torch.isfinite(got).all().item():
        raise SystemExit(f"kernel disagrees with its plain version: {name} "
                         f"max_abs_err={err.max().item():.4g} "
                         f"(max|want|={scale:.4g})")
    return err.max().item()


# the route of the fp32-state updates (subspace_adam, subspace_lion): 16-byte
# streaming accesses, one tile a block (csrc/subspace_adam.cu)
UPDATE_PATH = "vec16"
# what the profiler's name of each update kernel holds: the fp32-state
# kernels are update_kernel<Rule, b, g>, the q8 ones q8_kernel<b, g, adam>
PROFILE_KEYS = {"subspace_adam": "::AdamRule,",
                "subspace_lion": "::LionRule,",
                "subspace_adam_q8": "q8_kernel<",
                "subspace_lion_q8": "q8_kernel<"}
UPDATE_DTYPES = ((torch.float32, torch.float32),
                 (torch.float32, torch.bfloat16),
                 (torch.bfloat16, torch.float32),
                 (torch.bfloat16, torch.bfloat16))


def update_exact(mods, kernel, b, g, moments, scalars):
    """``kernel`` ("subspace_adam", moments (m, v), or "subspace_lion",
    moments (m,)) against its plain version on the same inputs in each of
    the four (b, g) dtype instances (b and g cast to them): every output
    equal (``torch.equal``), or the run fails.  Returns the max abs
    error, 0."""
    ref, sa = mods["ref"], mods["sa"]
    if kernel == "subspace_adam":
        lr, bc1, bc2 = scalars
        plain = functools.partial(ref.subspace_adam, lr=lr, bc1=bc1, bc2=bc2,
                                  **ADAM)
        kern = functools.partial(sa.subspace_adam, **ADAM)
    else:
        plain = functools.partial(ref.subspace_lion, lr=scalars[0], **LION)
        kern = functools.partial(sa.subspace_lion, **LION)
    err = 0.0
    for bd, gd in UPDATE_DTYPES:
        bb, gg = b.to(bd), g.to(gd)
        got = kern(bb, gg, *moments, scalars)
        want = plain(bb, gg, *moments)
        for name, x, y in zip("bmv", got, want):
            e = (x - y).abs().max().item()
            err = max(err, e)
            if not torch.equal(x, y):
                raise SystemExit(
                    f"kernel disagrees with its plain version: {kernel} "
                    f"{tuple(b.shape)} b {bd} g {gd} {name}' "
                    f"max_abs_err={e:.4g} (exact expected)")
        del bb, gg, got, want
    return err


def compare_train_kernels(mods, dev, shapes=None, merge_shapes=None,
                          M=TRAIN_M, shared=True):
    """Phase 3: the training kernels at the llama-100m shapes (or
    ``shapes``, which maps (K, N) to its leaves or to (leaves, M) where a
    shape has rows of its own, and ``merge_shapes``; ``shared``: the
    forward-only form too)."""
    shapes = TRAIN_SHAPES if shapes is None else shapes
    merge_shapes = MERGE_SHAPES if merge_shapes is None else merge_shapes
    ref, dispatch = mods["ref"], mods["dispatch"]
    lf, lb, lu, sa = mods["lf"], mods["lb"], mods["lu"], mods["sa"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bf = torch.bfloat16
    rows = []

    def row(kernel, shape, leaves, err, tol, ms, plain_ms, library_ms,
            bound, path="simt", eager_ms=None, cold=False, plan=None,
            queued=None):
        bms, by = bound
        rows.append(dict(kernel=kernel, shape=shape, leaves=leaves,
                         path=path, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by, eager_ms=eager_ms,
                         plan=plan, queued=queued))
        log(f"[kernel] {kernel:18s} {str(shape):22s} ({leaves}) "
            f"route={path} max_abs_err={err:.4g} (tol {tol}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bms:.4f} ({by}; {bms / ms:.1%} of it)" + (
                "" if eager_ms is None else
                f" [queued{', L2 flushed' if cold else ''}; eager "
                f"{eager_ms:.4f} ms/call]") + (
                "" if queued is None else
                f" [queued: kernel {queued[0]:.4f} library {queued[1]:.4f}]")
            + ("" if plan is None else f" plan={plan}"))

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    r, M0 = RANK, M
    for (K, N), leaves in shapes.items():
        leaves, M = leaves if isinstance(leaves, tuple) else (leaves, M0)
        x = randn(M, K).to(bf)
        w = randn(K, N, scale=K ** -0.5).to(bf)
        v = randn(K, r, scale=r ** -0.5).to(bf)
        b = randn(N, r, scale=0.02).to(bf)
        # forward with p
        lf.reset_launches()
        y, p = lf.lowrank_forward(x, w, v, b, return_p=True)
        torch.cuda.synchronize()
        path = launch_path(lf)
        want_y, want_p = ref.lowrank_forward(x, w, v, b, return_p=True)
        err = max(_agree(f"forward[p] y K={K} N={N}", y, want_y, RTOL, RTOL),
                  _agree(f"forward[p] p K={K} N={N}", p, want_p, RTOL, RTOL))
        del y, want_y, want_p
        nbytes = 2 * (M * K + K * N + K * r + N * r + M * N + M * r)
        ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N

        def lib_fwd():
            pp = x @ v
            return x @ w + pp @ b.T, pp
        row("lowrank_forward[p]", (M, K, N), leaves, err,
            f"{RTOL}*(max|y|+|y|)",
            time_auto(lambda: lf.lowrank_forward(x, w, v, b, return_p=True)),
            time_auto(lambda: ref.lowrank_forward(x, w, v, b,
                                                  return_p=True)),
            time_auto(lib_fwd), bound_of(nbytes, ops, BF16_FLOP_PER_S),
            path, plan=plan_of(lf, "p", M, K, N),
            queued=(queued_ms(lambda: lf.lowrank_forward(x, w, v, b,
                                                         return_p=True)),
                    queued_ms(lib_fwd)))
        # forward, shared B and no p: the forward-only lowrank_lr's form
        if shared:
            lf.reset_launches()
            y = lf.lowrank_forward(x, w, v, b)
            torch.cuda.synchronize()
            path = launch_path(lf)
            err = _agree(f"forward[shared] y K={K} N={N}", y,
                         ref.lowrank_forward(x, w, v, b), RTOL, RTOL)
            del y
            row("lowrank_forward[shared]", (M, K, N), leaves, err,
                f"{RTOL}*(max|y|+|y|)",
                time_auto(lambda: lf.lowrank_forward(x, w, v, b)),
                time_auto(lambda: ref.lowrank_forward(x, w, v, b)),
                time_auto(lambda: x @ w + (x @ v) @ b.T),
                bound_of(nbytes - 2 * M * r, ops, BF16_FLOP_PER_S), path,
                plan=plan_of(lf, "shared", M, K, N),
                queued=(queued_ms(lambda: lf.lowrank_forward(x, w, v, b)),
                        queued_ms(lambda: x @ w + (x @ v) @ b.T)))
        # backward
        dy = randn(M, N, scale=1e-2).to(bf)
        lb.reset_launches()
        dx, db = lb.lowrank_backward(dy, w, v, b, p)
        torch.cuda.synchronize()
        path = launch_path(lb)
        want_dx, want_db = ref.lowrank_backward(dy, w, v, b, p)
        err = max(_agree(f"backward dx K={K} N={N}", dx, want_dx, RTOL,
                         RTOL),
                  _agree(f"backward dB K={K} N={N}", db, want_db, 1e-4))
        del dx, db, want_dx, want_db
        nbytes = 2 * (M * N + K * N + K * r + N * r + M * r + M * K) \
            + 4 * N * r
        ops = 2 * M * N * K + 4 * M * N * r + 2 * M * r * K

        def lib_bwd():
            return dy @ w.T + (dy @ b) @ v.T, dy.T @ p
        row("lowrank_backward", (M, K, N), leaves, err,
            f"{RTOL}*(max|dx|+|dx|), 1e-4*max|dB|",
            time_auto(lambda: lb.lowrank_backward(dy, w, v, b, p)),
            time_auto(lambda: ref.lowrank_backward(dy, w, v, b, p)),
            time_auto(lib_bwd), bound_of(nbytes, ops, BF16_FLOP_PER_S),
            path, plan=plan_of(lf, "backward", M, K, N, lb=lb),
            queued=(queued_ms(lambda: lb.lowrank_backward(dy, w, v, b, p)),
                    queued_ms(lib_bwd)))
        del x, w, v, b, p, dy
        torch.cuda.empty_cache()

    for shape, leaves in merge_shapes.items():
        lead, (K, N) = shape[:-2], shape[-2:]
        w = randn(*shape, scale=K ** -0.5).to(bf)
        v = randn(*lead, K, r, scale=r ** -0.5).to(bf)
        b = randn(*lead, N, r, scale=0.02)
        lu.reset_launches()
        got = lu.lowrank_merge(w, v, b)
        torch.cuda.synchronize()
        path = launch_path(lu, at=1)
        want = ref.lowrank_merge(w, v, b)
        err = _agree(f"merge {shape}", got, want, RTOL, RTOL)
        items = w.numel() // (K * N)
        nbytes = 2 * (2 * K * N + K * r) * items + 4 * N * r * items
        ops = 2 * K * N * r * items
        w3, v3 = w.reshape(-1, K, N), v.reshape(-1, K, r)
        b3t = b.reshape(-1, N, r).to(bf).transpose(1, 2)
        # device time: the stream is held while the host queues the calls
        # (the wrapper's host time per call is near the kernel's)
        row("lowrank_merge", shape, leaves, err, f"{RTOL}*(max|W'|+|W'|)",
            queued_ms(lambda: lu.lowrank_merge(w, v, b, out=got)),
            queued_ms(lambda: ref.lowrank_merge(w, v, b)),
            queued_ms(lambda: torch.baddbmm(w3, v3, b3t)),
            bound_of(nbytes, ops, BF16_FLOP_PER_S), path,
            time_ms(lambda: lu.lowrank_merge(w, v, b, out=got), iters=50))
        del w, v, b, got, want, w3, v3, b3t
        torch.cuda.empty_cache()

    for shape, leaves in merge_shapes.items():
        bshape = shape[:-2] + (shape[-1], r)
        b, g = randn(*bshape, scale=0.02), randn(*bshape, scale=1e-3)
        m, v = randn(*bshape, scale=1e-4), randn(*bshape, scale=1e-4) ** 2
        step = torch.tensor(5, dtype=torch.int32, device=dev)
        scalars = dispatch.adam_scalars(1e-3, step, ADAM["beta1"],
                                        ADAM["beta2"], dev)
        err = update_exact(mods, "subspace_adam", b, g, (m, v), scalars)
        lr, bc1, bc2 = scalars
        n = b.numel()
        pb = b.clone()
        pb.grad = g
        opt = torch.optim.AdamW([pb], lr=1e-3, betas=(ADAM["beta1"],
                                                      ADAM["beta2"]),
                                eps=ADAM["eps"], weight_decay=ADAM["wd"],
                                fused=True)
        # device time: the stream is held while the host queues the calls
        # (an eager call's host time is near the kernel's), the L2 flushed
        # before each (w_down's 27.5 MB would stay there; in training the
        # state was last read a step before)
        row("subspace_adam", bshape, leaves, err,
            "exact, 4 (b, g) dtypes",
            queued_ms(lambda: sa.subspace_adam(b, g, m, v, scalars, **ADAM),
                      cold=True),
            queued_ms(lambda: ref.subspace_adam(b, g, m, v, lr=lr, bc1=bc1,
                                                bc2=bc2, **ADAM), cold=True),
            queued_ms(opt.step, cold=True),
            bound_of(28 * n, 15 * n, FP32_FLOP_PER_S), UPDATE_PATH,
            eager_ms=time_ms(lambda: sa.subspace_adam(b, g, m, v, scalars,
                                                      **ADAM), iters=50),
            cold=True)
        del b, g, m, v, pb, opt
    torch.cuda.empty_cache()
    return rows


def compare_state_kernels(mods, dev):
    """Phase 3, compressed state: subspace-Lion on fp32 state, the int8
    Adam and Lion updates in both forms (bf16 b with rounding bits, as
    the bf16-master runs launch them, and fp32 b without) and the
    stochastically rounded merge, at the llama-100m group shapes.  The
    kernels round every operation as the plain version's torch ops do, and
    all must agree exactly: the merge too, since any round of its sum
    lies within one bf16 step of it and only equality shows that the
    stochastic one ran.  No single PyTorch call computes these functions:
    library_ms is null."""
    from repro_torch.optim import quant
    ref, dispatch, sa, lu = mods["ref"], mods["dispatch"], mods["sa"], \
        mods["lu"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    bf = torch.bfloat16
    rows = []

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def bits_like(t):
        return torch.randint(0, 1 << 16, t.shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def exact(name, got, want):
        err = 0.0
        for x, y in zip(got, want):
            y = y.reshape(x.shape)
            e = (x.float() - y.float()).abs().max().item()
            err = max(err, e)
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise SystemExit(f"kernel disagrees with its plain version: "
                                 f"{name} max_abs_err={e:.4g} (exact "
                                 f"expected)")
        return err

    def row(kernel, form, shape, leaves, err, tol, kern, plain, n_bytes,
            ops, peak, note=""):
        """Kernel and plain version timed on the device alone (the stream
        held while the host queues the calls, the L2 flushed before each:
        the smaller shapes' operands would stay there, and in training the
        state was last read a step before), the eager time beside."""
        bms, by = bound_of(n_bytes, ops, peak)
        ms = queued_ms(kern, cold=True)
        plain_ms = queued_ms(plain, cold=True)
        eager_ms = time_ms(kern, iters=50)
        rows.append(dict(kernel=kernel, form=form, shape=shape,
                         leaves=leaves, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                         bound_by=by, eager_ms=eager_ms))
        log(f"[kernel] {kernel:18s} {form:13s} {str(shape):22s} ({leaves}) "
            f"max_abs_err={err:.4g} (tol {tol}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms=null bound_ms={bms:.4f} "
            f"({by}){note} [queued, L2 flushed; eager {eager_ms:.4f} "
            f"ms/call]")

    step = torch.tensor(5, dtype=torch.int32, device=dev)
    sc3 = dispatch.adam_scalars(3e-3, step, ADAM["beta1"], ADAM["beta2"],
                                dev)
    lr3, bc1, bc2 = sc3
    sc1 = dispatch.lion_scalars(3e-4, dev)
    for shape, leaves in MERGE_SHAPES.items():
        bshape = shape[:-2] + (shape[-1], RANK)
        n = math.prod(bshape)
        b, g, m = randn(*bshape, scale=0.02), randn(*bshape, scale=1e-3), \
            randn(*bshape, scale=1e-3)
        # Lion, fp32 state (run 6d's form, fp32 b and g, timed; all four
        # (b, g) dtype instances held exact)
        err = update_exact(mods, "subspace_lion", b, g, (m,), sc1)
        row("subspace_lion", "fp32 state", bshape, leaves, err,
            "exact, 4 (b, g) dtypes",
            lambda: sa.subspace_lion(b, g, m, sc1, **LION),
            lambda: ref.subspace_lion(b, g, m, lr=sc1[0], **LION),
            nbytes(b, g, m) + 8 * n, 8 * n, FP32_FLOP_PER_S,
            note=f" route={UPDATE_PATH}")
        # int8 moments, (R, 128) rows
        R = n // QROW
        mq = quant.quantize(m)
        vq = quant.quantize(randn(*bshape, scale=1e-3) ** 2, codec="sqrt")
        g2, mq2, vq2 = (t.reshape(R, QROW) for t in (g, mq.q, vq.q))
        for form, b2, bits in (
                ("bf16 b, bits", b.to(bf).reshape(R, QROW),
                 bits_like(g2)),
                ("fp32 b", b.reshape(R, QROW), None)):
            def k_adam():
                return sa.subspace_adam_q8(b2, g2, mq2, mq.scale, vq2,
                                           vq.scale, sc3, bits=bits, **ADAM)

            def p_adam():
                return ref.subspace_adam_q8(
                    b2, g2, mq2, mq.scale[:, None], vq2, vq.scale[:, None],
                    lr=lr3, bc1=bc1, bc2=bc2, bits=bits, **ADAM)

            def k_lion():
                return sa.subspace_lion_q8(b2, g2, mq2, mq.scale, sc1,
                                           bits=bits, **LION)

            def p_lion():
                return ref.subspace_lion_q8(b2, g2, mq2, mq.scale[:, None],
                                            lr=sc1[0], bits=bits, **LION)

            extra = () if bits is None else (bits,)
            for kernel, kern, plain, ins, ops in (
                    ("subspace_adam_q8", k_adam, p_adam,
                     (b2, g2, mq2, mq.scale, vq2, vq.scale), 40 * n),
                    ("subspace_lion_q8", k_lion, p_lion,
                     (b2, g2, mq2, mq.scale), 20 * n)):
                got = kern()
                torch.cuda.synchronize()
                err = exact(f"{kernel} {form} {bshape}", got, plain())
                row(kernel, form, bshape, leaves, err, "exact", kern, plain,
                    nbytes(*ins, *extra, *got), ops, FP32_FLOP_PER_S)
            del got
        del b, g, m, mq, vq, g2, mq2, vq2
        torch.cuda.empty_cache()

    for shape, leaves in MERGE_SHAPES.items():
        lead, (K, N) = shape[:-2], shape[-2:]
        w = randn(*shape, scale=K ** -0.5).to(bf)
        v = randn(*lead, K, RANK, scale=RANK ** -0.5).to(bf)
        b = randn(*lead, N, RANK, scale=0.02).to(bf)
        bits = bits_like(w)
        lu.reset_launches()
        got = lu.lowrank_merge(w, v, b, bits=bits)
        torch.cuda.synchronize()
        if launch_path(lu, at=1) != "simt":
            raise SystemExit("the stochastically rounded merge left SIMT")
        # exact: any round of the sum (stochastic, nearest, truncating)
        # lands within one bf16 step of it, so only equality tells the
        # stochastic round from the others
        err = exact(f"merge_sr {shape}", (got,),
                    (ref.lowrank_merge_sr(w, v, b, bits),))
        items = w.numel() // (K * N)
        flop = 2 * K * N * RANK * items
        # the kernel runs on the fp32 FMA pipes (exactness): its floor
        fma_ms = flop / FP32_FLOP_PER_S * 1e3
        row("lowrank_merge_sr", "bf16 W, V, B", shape, leaves, err, "exact",
            lambda: lu.lowrank_merge(w, v, b, out=got, bits=bits),
            lambda: ref.lowrank_merge_sr(w, v, b, bits),
            nbytes(w, v, b, bits, got), flop, BF16_FLOP_PER_S,
            note=f" fp32_fma_floor_ms={fma_ms:.4f}")
        del w, v, b, bits, got
        torch.cuda.empty_cache()
    return rows


def project_splits_ms(lu, g, v, out, most):
    """ms per tensor-core projection launch with K cut into 1 .. ``most``
    ranges, the plan's choice among them: how its one-wave rule is
    checked.  Each launch is held to the first."""
    lead, (K, N), r = g.shape[:-2], g.shape[-2:], v.shape[-1]
    items = math.prod(lead)
    tiles = lu.project_tiles(items, N, r)
    stream = torch.cuda.current_stream().cuda_stream
    out_ms, first = {}, None
    for s in range(1, most + 1):
        part = torch.empty(max(1, s * tiles * lu.PROJECT_TILE ** 2),
                           device=g.device)
        counters = torch.zeros(tiles, dtype=torch.int32, device=g.device)

        def launch():
            rc = lu._project_tc_kernel()(
                lu.DTYPE_CODE[g.dtype], g.data_ptr(), v.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(), s,
                items, K, N, r, stream)
            if rc != 0:
                raise SystemExit(f"lowrank_project tc launch, {s} ranges: "
                                 f"error {rc}")
        launch()
        torch.cuda.synchronize()
        if first is None:
            first = out.clone()
        _agree(f"project {tuple(g.shape)} in {s} ranges", out, first, 1e-4)
        out_ms[s] = queued_ms(launch)
    return out_ms


def compare_project_kernel(mods, dev):
    """Phase 3, GaLore: the projection ``Gᵀ V`` at the four llama-100m
    group shapes, in the form the path runs it (the clipped fp32
    gradient, the basis stored in bf16), within 1e-4 of max|out| (the
    tensor-core route carries G as a bf16 hi, lo pair: 16 of its bits,
    and fp32 sums in another order).  The bound is the larger of the
    bytes (G, V, the output) and the two bf16 products, G's hi and lo
    parts against V, at the tensor-core peak.  library_ms times
    ``torch.matmul(g.mT, v.float())`` (cuBLAS, TF32 off).  Kernel, plain
    version and library are timed on the device alone (the stream held
    while the host queues the calls), the wrapper's eager time beside."""
    ref, lu = mods["ref"], mods["lu"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []
    for shape, leaves in MERGE_SHAPES.items():
        lead, (K, N) = shape[:-2], shape[-2:]
        g = 1e-3 * torch.randn(shape, generator=gen, device=dev)
        v = (K ** -0.5 * torch.randn(lead + (K, RANK), generator=gen,
                                     device=dev)).bfloat16()
        lu.reset_launches()
        got = lu.lowrank_project(g, v)
        torch.cuda.synchronize()
        path = launch_path(lu, at=1)
        err = _agree(f"project {shape}", got, ref.lowrank_project(g, v),
                     1e-4)
        n_bytes = 4 * g.numel() + 2 * v.numel() + 4 * got.numel()
        ops = 2 * 2 * K * N * RANK * math.prod(lead)
        bms, by = bound_of(n_bytes, ops, BF16_FLOP_PER_S)
        r = dict(kernel="lowrank_project", shape=shape, leaves=leaves,
                 path=path, max_abs_err=err,
                 ms=queued_ms(lambda: lu.lowrank_project(g, v)),
                 plain_ms=queued_ms(lambda: ref.lowrank_project(g, v)),
                 library_ms=queued_ms(lambda: torch.matmul(g.mT,
                                                           v.float())),
                 bound_ms=bms, bound_by=by,
                 eager_ms=time_ms(lambda: lu.lowrank_project(g, v),
                                  iters=50))
        s_plan = lu.project_plan(math.prod(lead), K, N, RANK)
        if s_plan > 1:
            r["splits_ms"] = project_splits_ms(lu, g, v, got, s_plan + 1)
            log(f"[kernel] lowrank_project {shape}: ms by K ranges "
                f"{r['splits_ms']} (the plan takes {s_plan})")
        rows.append(r)
        log(f"[kernel] {'lowrank_project':18s} {str(shape):22s} ({leaves}) "
            f"route={path} max_abs_err={err:.4g} (tol 1e-4*max|out|) "
            f"ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={bms:.4f} ({by}) "
            f"[queued; eager {r['eager_ms']:.4f} ms/call]")
        del g, v, got
        torch.cuda.empty_cache()
    return rows


def train_config(configs, layers=None, dtype=None, arch=TRAIN_ARCH, **tkw):
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    return cfg, configs.TrainConfig(rank=RANK, **tkw)


def state_bytes(tr) -> int:
    """Bytes of the subspace state: B, m and v of every group (int8
    moments with their fp32 scales)."""
    return sum(t.nbytes for s in tr.opt_state.groups for t in (s.b, s.m, s.v))


def opt_state_bytes(state) -> int:
    """Bytes of every tensor an optimizer state holds: moments, B, the
    bases V or U, int8 scales, dense leaves' moments (not the weights)."""
    if torch.is_tensor(state):
        return state.nbytes
    if isinstance(state, dict):
        return sum(map(opt_state_bytes, state.values()))
    if isinstance(state, (tuple, list)):
        return sum(map(opt_state_bytes, state))
    if dataclasses.is_dataclass(state):
        return sum(opt_state_bytes(getattr(state, f.name))
                   for f in dataclasses.fields(state))
    return 0


def train(dev, mods, smi, cfg, tcfg, batch, seq, steps, tag="train",
          cadence="merges", falling=True, hook=None):
    """Phase 6: the training path through the Trainer; returns the
    trainer and the per-step losses.  Every launch counter is zero when
    the run starts.  The run must show at least two of its ``cadence``
    (``"merges"``: outer merges, ``"refreshes"``: GaLore bases, None: no
    check) and, when ``falling``, a falling loss.  ``hook(tr, s)`` runs
    after step ``s`` is logged (outside its time)."""
    from repro_torch.data.synthetic import StatelessLoader
    from repro_torch.train.trainer import Trainer
    log(f"[{tag}] {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype} "
        f"rank={tcfg.rank} sampler={tcfg.sampler} batch={batch}x{seq} "
        f"lazy_k={tcfg.lazy_k} lr={tcfg.lr} optimizer={tcfg.optimizer} "
        f"state_dtype={tcfg.state_dtype} master_dtype={tcfg.master_dtype} "
        f"grad_accum={tcfg.grad_accum}")
    loader = StatelessLoader("lm", 0, device=dev, batch=batch, seq_len=seq,
                             vocab=cfg.vocab_size)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_made = time.perf_counter()
    tr = Trainer(cfg, tcfg, loader, device=dev)
    t_made = time.perf_counter() - t_made
    if dev.type == "cuda":
        torch.cuda.synchronize()
        init_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[{tag}] init peak {init_gib:.2f} GiB while the trainer was "
            f"made")
        # free what earlier phases left in reference cycles (the serving
        # engine's timing wrappers hold its weights) before the peak is
        # reset, so the peak is this run's own
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log(f"[{tag}] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated when the run starts (the trainer made in "
            f"{t_made:.1f} s)")
    def step_note(s):
        if (s - 1) % tcfg.lazy_k:
            return ""
        if cadence == "refreshes":
            return " (a basis refresh)"
        return " (after an outer merge)" if cadence == "merges" and s > 1 \
            else ""

    for mod in mods["counters"]:
        mod.reset_launches()
    t0 = time.perf_counter()
    def step_log(s, loss, dt):
        log(f"[{tag}] step {s:3d} loss {loss:.4f} {1e3 * dt:.1f} ms"
            + step_note(s))
        if hook is not None:
            hook(tr, s)

    report = tr.run(steps, log=step_log)
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        require_tc(mods, tag, updates=True)
    losses = report.losses
    tokens = batch * seq
    steady = report.step_times[1:] or report.step_times
    log(f"[{tag}] {steps} steps, {report.outer_steps} outer merges, "
        f"{tokens * steps / wall:.0f} tok/s over all steps, "
        f"{tokens * len(steady) / sum(steady):.0f} tok/s over steps "
        f"2..{steps}, {1e3 * sum(steady) / len(steady):.1f} ms/step there"
        + (f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
           f"allocated on {smi}" if dev.type == "cuda" else ""))
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise SystemExit(f"training produced a non-finite loss: {losses}")
    if cadence == "refreshes":
        due = [i for i in range(steps) if i % tcfg.lazy_k == 0]
        rest = [t for i, t in enumerate(report.step_times) if i not in due]
        log(f"[{tag}] {tr.opt_state.refreshes} basis refreshes; refresh "
            f"steps {[i + 1 for i in due]}: " + ", ".join(
                f"{1e3 * report.step_times[i]:.1f}" for i in due)
            + f" ms; the other steps {1e3 * sum(rest) / len(rest):.1f} "
            f"ms/step")
    ran = {"merges": report.outer_steps,
           "refreshes": getattr(tr.opt_state, "refreshes", 0)}.get(cadence)
    if ran is not None and ran < 2:
        raise SystemExit(f"only {ran} {cadence} ran")
    last3 = sum(losses[-3:]) / 3
    sub = (f"; subspace state {state_bytes(tr)} bytes"
           if tcfg.optimizer.startswith("lowrank_") else "")
    log(f"[{tag}] first loss {losses[0]:.4f}, mean of the last 3 "
        f"{last3:.4f}; optimizer state {opt_state_bytes(tr.opt_state)} "
        f"bytes{sub}")
    if falling and not last3 < losses[0]:
        raise SystemExit(f"training loss did not fall: first {losses[0]}, "
                         f"mean of the last 3 {last3}")
    return tr, losses


def shape_launches(launches, *key):
    """Launches counted under ``key`` (a form and (K, N), or (K, N)),
    summed over the routes."""
    return sum(n for k, n in launches.items()
               if k[:-3] + k[-2:] == key)


def update_launches(lu, kernel, shape):
    """Launches of a merge or projection kernel at one shape, summed over
    the routes."""
    return sum(n for (k, _, s), n in lu.LAUNCHES.items()
               if k == kernel and s == shape)


MAMBA_TRAIN = dict(batch=16, seq=1024, steps=10)   # 16 384 tokens a step


def train_mamba2(dev, mods, smi, configs):
    """[train mamba2]: mamba2-780m at full width and depth (48 layers,
    bf16 compute over fp32 B, m and v, Stiefel V at r = 128), batch 16 x
    seq 1024 (8 SSD chunks a sequence), lazy_k 4, lr 1e-3, 10 steps (two
    merges): finite, falling losses (at 6a's lr 3e-3 the 48-layer model
    diverges after the first merge, through the kernels and through the
    plain SSD alike, measured on an H100); per step 96 SSD forward launches (48
    and 48 recomputed under remat) and 48 backward launches at the
    training shape; every bf16 GEMM on the tensor cores; then a profile
    of two steps with the SSD backward's device time.  Returns the SSD
    launch counts of the 10 steps."""
    sc = mods["sc"]
    cfg, tcfg = train_config(configs, arch="mamba2-780m", lazy_k=4, lr=1e-3,
                             warmup_steps=2, total_steps=1000)
    steps = MAMBA_TRAIN["steps"]
    run_mods = dict(mods, counters=tuple(mods["counters"]) + (sc,))
    tr, _ = train(dev, run_mods, smi, cfg, tcfg, MAMBA_TRAIN["batch"],
                  MAMBA_TRAIN["seq"], steps, tag="train mamba2")
    counts = dict(sc.LAUNCHES)
    want = {("ssd_intra_chunk", SSD_TRAIN_SHAPE): 2 * cfg.num_layers * steps,
            ("ssd_intra_chunk_bwd", SSD_TRAIN_SHAPE): cfg.num_layers * steps}
    log("[train mamba2] launches " + ", ".join(
        f"{k}{list(sh)}={n} ({n / steps:.0f} a step)"
        for (k, sh), n in counts.items()))
    if counts != want:
        raise SystemExit(f"SSD launches {counts}, the path should make "
                         f"{want}")
    profile_train(tr, tag="profile-train mamba2", match=("ssd_",))
    torch.cuda.synchronize()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts


ZAMBA_TRAIN = dict(batch=8, seq=1024, steps=10)    # 8 192 tokens a step
ZAMBA_LR = 5e-4


def zamba2_train_config(configs, lr=ZAMBA_LR):
    """zamba2-7b at full width and depth and ``[train zamba2]``'s
    ``lowrank_adam`` settings (lazy_k 3, a 2-step warm-up) at ``lr``."""
    return train_config(configs, arch="zamba2-7b", lazy_k=3, lr=lr,
                        warmup_steps=2, total_steps=1000)


def train_zamba2(dev, mods, smi, configs):
    """[train zamba2]: zamba2-7b at full width and depth (81 Mamba2
    layers, the shared attention + MLP block applied 13 times, a 3-layer
    tail; bf16 compute over fp32 B, m and v, Stiefel V at r = 128), batch
    8 x seq 1024 (8 SSD chunks a sequence), lazy_k 3, lr 5e-4, 10 steps
    (three merges): finite, falling losses (the lr and the steps from
    ``--zamba2-study`` on an H100: after 10 steps the mean of the last 3
    is 0.064 below the first at 5e-4, at most 0.013 below it at 1e-3 and
    3e-4, whose losses swing, and none below it at 2e-4 and 1e-4; after
    8 steps 5e-4's margin was 0.016); per step 162 SSD
    forward launches (81 and 81 recomputed under remat) and 81 backward
    launches at (64, 128, 112, 64, 64); every bf16 GEMM on the tensor
    cores; then a profile of two inner steps with the SSD kernels'
    device time.  Returns the SSD launch counts of the 10 steps."""
    sc = mods["sc"]
    cfg, tcfg = zamba2_train_config(configs)
    steps = ZAMBA_TRAIN["steps"]
    run_mods = dict(mods, counters=tuple(mods["counters"]) + (sc,))
    tr, _ = train(dev, run_mods, smi, cfg, tcfg, ZAMBA_TRAIN["batch"],
                  ZAMBA_TRAIN["seq"], steps, tag="train zamba2")
    counts = dict(sc.LAUNCHES)
    n_mamba = cfg.num_layers
    want = {("ssd_intra_chunk", ZAMBA_TRAIN_SSD_SHAPE): 2 * n_mamba * steps,
            ("ssd_intra_chunk_bwd", ZAMBA_TRAIN_SSD_SHAPE): n_mamba * steps}
    log("[train zamba2] launches " + ", ".join(
        f"{k}{list(sh)}={n} ({n / steps:.0f} a step)"
        for (k, sh), n in counts.items()))
    if counts != want:
        raise SystemExit(f"SSD launches {counts}, the path should make "
                         f"{want}")
    t0 = time.perf_counter()
    profile_train(tr, tag="profile-train zamba2", match=("ssd_",))
    log(f"[train zamba2] the profile took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# --zamba2-study: the lrs tried, all under the same warm-up, and the steps
STUDY_LRS = (1e-3, 5e-4, 3e-4, 2e-4, 1e-4)
STUDY_STEPS = 12


def zamba2_study(dev, mods, smi, configs):
    """``python3 chip_smoke.py --zamba2-study``: the measurements behind
    two choices of ``[train zamba2]``'s path, and nothing else.  First the
    SSD backward's ragged heads instance against the constant-bound
    instance at both training shapes (:func:`ragged_bwd_ms`; why Q = 128,
    N = 64 has an instance of its own).  Then zamba2-7b as ``[train
    zamba2]`` trains it, at each lr of ``STUDY_LRS``, every run with the
    same 2-step warm-up, weights and batches, ``STUDY_STEPS`` steps: each
    step's loss, and after 8, 10 and 12 steps the mean of the last 3
    against the first (the margin the phase's gate has at each lr)."""
    for shape in (SSD_TRAIN_SHAPE, ZAMBA_TRAIN_SSD_SHAPE):
        ragged_bwd_ms(mods, dev, shape)
    for lr in STUDY_LRS:
        cfg, tcfg = zamba2_train_config(configs, lr)
        tag = f"zamba2 study lr={lr:g}"
        try:
            tr, losses = train(dev, mods, smi, cfg, tcfg,
                               ZAMBA_TRAIN["batch"], ZAMBA_TRAIN["seq"],
                               STUDY_STEPS, tag=tag, falling=False)
        except SystemExit as e:     # a diverged run is a result here
            log(f"[{tag}] stopped: {e}")
            continue
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{tag}] first loss {losses[0]:.4f}; mean of the last 3 "
            + ", ".join(f"after {n} steps {sum(losses[n - 3:n]) / 3:.4f} "
                        f"(margin {losses[0] - sum(losses[n - 3:n]) / 3:+.4f})"
                        for n in (8, 10, 12)))


# ---------------------------------------------------------------------------
# MoE training: qwen3-moe-30b-a3b through Algorithm 1
# ---------------------------------------------------------------------------

# [train qwen3moe]: full width, 20 of the 48 layers (at 24 the weights,
# B, m, v, V and the step's transients come to 76-78 GB by arithmetic),
# batch 8 x 1024, lazy_k 3, 10 steps (three merges)
QWEN3_TRAIN = dict(layers=20, batch=8, seq=1024, steps=10)
QWEN3_LR = 1e-3
QWEN3_TRAIN_M = QWEN3_TRAIN["batch"] * QWEN3_TRAIN["seq"]
# the chunked CE's rows a launch: the batch times its chunk of 512 tokens
QWEN3_CE_M = QWEN3_TRAIN["batch"] * 512
# (K, N) the low-rank forward and backward see -> (leaves, rows)
QWEN3_TRAIN_SHAPES = {(2048, 4096): ("wq", QWEN3_TRAIN_M),
                      (2048, 512): ("wk,wv", QWEN3_TRAIN_M),
                      (4096, 2048): ("wo", QWEN3_TRAIN_M),
                      (2048, 152064): ("unembed", QWEN3_CE_M)}
# the expert groups the merge and the update see at 20 layers -> leaves
QWEN3_EXPERT_GROUPS = {(2, 20, 128, 2048, 768): "w_gate,w_up",
                       (1, 20, 128, 768, 2048): "w_down"}
# the merge's [kernel] rows check the plain version over this many items
# at a time (fp32, 256 x 2048 x 768 a piece: 1.6 GB)
MERGE_PIECE = 256


def qwen3_train_config(configs, lr=QWEN3_LR):
    """qwen3-moe-30b-a3b at full width and ``QWEN3_TRAIN``'s depth and
    ``[train qwen3moe]``'s ``lowrank_adam`` settings (lazy_k 3, a 2-step
    warm-up) at ``lr``."""
    return train_config(configs, arch=MOE, layers=QWEN3_TRAIN["layers"],
                        lazy_k=3, lr=lr, warmup_steps=2, total_steps=1000)


def qwen3_want_launches(cfg, tcfg, steps, merges, ce_chunks):
    """The launches ``steps`` steps of ``[train qwen3moe]`` should make,
    by counter key: each attention projection forward twice a layer (the
    block and its recompute under remat) and backward once; the
    unembedding the same for each CE chunk; one merge and one
    ``subspace_adam`` per group at each outer step and each step; every
    GEMM and merge on the tensor cores (the update on its one route)."""
    from repro_torch.models import lm
    from repro_torch.optim import subspace
    L, d = cfg.num_layers, cfg.d_model
    q = cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    lf, lb = {}, {}
    for (K, N), n in (((d, q), L), ((d, kv), 2 * L), ((q, d), L),
                      ((d, lm.padded_vocab(cfg)), ce_chunks)):
        lf[("p", "tc", K, N)] = lf.get(("p", "tc", K, N), 0) + 2 * n * steps
        lb[("tc", K, N)] = lb.get(("tc", K, N), 0) + n * steps
    lu, sa = {}, {}
    for spec in subspace.build_layout(lm.param_specs(cfg), tcfg).groups:
        shape = (len(spec.leaf_idx),) + spec.shape
        lu[("lowrank_merge", "tc", shape)] = merges
        sa[("subspace_adam", shape[:-2] + (shape[-1], spec.rank))] = steps
    return lf, lb, lu, sa


class MoETrainTap(RouteTap):
    """``[train qwen3moe]``'s routings: the pairs dropped by capacity,
    counted on the device and read once a step; while ``record``, each
    call's top-k experts and keep mask (the first step's forward and its
    recompute under remat)."""

    def __init__(self, moe_mod, dev):
        super().__init__(moe_mod)
        self.record, self.calls = True, []
        self.dropped = torch.zeros((), dtype=torch.long, device=dev)
        self.pairs = 0

    def seen(self, r):
        if self.record:
            self.calls.append((r.top_idx, r.keep))
        self.dropped += (~r.keep).sum()
        self.pairs += r.keep.numel()

    def share(self):
        d, n = int(self.dropped.item()), self.pairs
        self.dropped.zero_()
        self.pairs = 0
        return d, n


def state_against_arithmetic(tr, tag):
    """The subspace state (B, m, v fp32 per group) and the optimizer
    state (also V in the compute dtype per group, fp32 m and v per dense
    leaf, two int32 step counters) measured against their arithmetic.
    (A function of its own: no local keeps the state alive afterwards.)"""
    lay = tr.opt_state.layout
    sub = sum(12 * math.prod((len(spec.leaf_idx),) + spec.shape[:-2])
              * spec.shape[-1] * spec.rank for spec in lay.groups)
    vsize = torch.empty((), dtype=getattr(
        torch, lay.compute_dtype)).element_size()
    proj = sum(vsize * math.prod((len(spec.leaf_idx),) + spec.shape[:-1])
               * spec.rank for spec in lay.groups)
    dense = sum(8 * w.numel() for w in tr.params.dense)
    want = sub + proj + dense + 8
    got_sub, got = state_bytes(tr), opt_state_bytes(tr.opt_state)
    log(f"[{tag}] subspace state (B, m, v) {got_sub} bytes, arithmetic "
        f"{sub}; optimizer state {got} bytes, arithmetic {want} (V {proj}, "
        f"dense moments {dense})")
    if (got_sub, got) != (sub, want):
        raise SystemExit(f"[{tag}] state bytes off their arithmetic")


def remat_routes_alike(tag, calls, layers):
    """The first step's routings: each layer's forward (calls 0..L-1) and
    its recompute in the backward (calls L..2L-1, last layer first) chose
    the same experts and kept the same pairs.  ``torch.utils.checkpoint``
    checks shapes only, so a flip would give wrong gradients silently."""
    if len(calls) != 2 * layers:
        raise SystemExit(f"[{tag}] {len(calls)} routings in the first step, "
                         f"not {layers} and {layers} recomputed")
    for i in range(layers):
        (fi, fk), (ri, rk) = calls[i], calls[2 * layers - 1 - i]
        if not (torch.equal(fi, ri) and torch.equal(fk, rk)):
            raise SystemExit(f"[{tag}] layer {i}'s recompute routed unlike "
                             f"its forward")
    log(f"[{tag}] remat: the recompute of each of the {layers} layers "
        f"routed as its forward in the first step (top-k and keep equal)")


def train_qwen3moe(dev, mods, smi, configs, lr=QWEN3_LR, steps=None,
                   tag="train qwen3moe", falling=True, profile=True):
    """[train qwen3moe]: qwen3-moe-30b-a3b at full width, 20 of its 48
    layers (d 2048, 32/4 heads x 128, qk-norm, 128 experts top-8,
    moe_d_ff 768, vocab 152064 padded; bf16 compute over fp32 B, m and v,
    Stiefel V at r = 128), batch 8 x 1024 (T = 8192, C = 640), lazy_k 3,
    10 steps (three merges): finite, falling losses; the first step's
    recompute routed as its forward; the pairs dropped each step; peak
    GiB by init, step and merge; ms per merge + resample and per
    resample; optimizer and subspace state against arithmetic; every
    launch of rows 1, 2, 3 and 6 in the count the path should make, the
    GEMMs and merges on the tensor cores; then a profile of two inner
    steps.  Returns the launch counters of the run."""
    from repro_torch.optim import subspace
    lf, lb, lu, sa = mods["lf"], mods["lb"], mods["lu"], mods["sa"]
    cfg, tcfg = qwen3_train_config(configs, lr)
    steps = steps or QWEN3_TRAIN["steps"]
    batch, seq = QWEN3_TRAIN["batch"], QWEN3_TRAIN["seq"]
    tap = MoETrainTap(mods["moe"], dev)
    peaks = {"step": 0.0, "merge": 0.0}
    outer_ms, draw_ms, drops = [], [], []
    cuda = dev.type == "cuda"

    def gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0

    def mark_peak(kind):
        if cuda:
            torch.cuda.synchronize()
            peaks[kind] = max(peaks[kind], gib())
            torch.cuda.reset_peak_memory_stats()

    def timed_outer(real):
        def outer(params, state):
            mark_peak("step")
            draw = subspace._sample_proj_group

            def timed_draw(*a, **kw):
                if cuda:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                v = draw(*a, **kw)
                if cuda:
                    torch.cuda.synchronize()
                draw_ms[-1] += 1e3 * (time.perf_counter() - t)
                return v
            draw_ms.append(0.0)
            subspace._sample_proj_group = timed_draw
            t0 = time.perf_counter()
            try:
                out = real(params, state)
            finally:
                subspace._sample_proj_group = draw
            if cuda:
                torch.cuda.synchronize()
            outer_ms.append(1e3 * (time.perf_counter() - t0))
            mark_peak("merge")
            return out
        return outer

    def hook(tr, s):
        mark_peak("step")
        d, n = tap.share()
        drops.append(d / max(n, 1))
        log(f"[{tag}] step {s}: {d} of {n} routed pairs dropped by "
            f"capacity ({100 * d / max(n, 1):.2f}%, the forward and its "
            f"recompute)")
        if s == 1:
            remat_routes_alike(tag, tap.calls, cfg.num_layers)
            tap.record, tap.calls = False, []
            tr._outer = timed_outer(tr._outer)

    with tap:
        tr, losses = train(dev, mods, smi, cfg, tcfg, batch, seq, steps,
                           tag=tag, falling=falling, hook=hook)
    counts = {"lf": dict(lf.LAUNCHES), "lb": dict(lb.LAUNCHES),
              "lu": dict(lu.LAUNCHES), "sa": dict(sa.LAUNCHES)}
    log(f"[{tag}] peak {peaks['step']:.2f} GiB in an inner step, "
        f"{peaks['merge']:.2f} GiB in an outer step, on {smi}")
    log(f"[{tag}] outer steps (merge + resample) " + ", ".join(
        f"{ms:.1f}" for ms in outer_ms) + " ms; the resample's draws "
        + ", ".join(f"{ms:.1f}" for ms in draw_ms) + " ms")
    log(f"[{tag}] dropped share by step: " + ", ".join(
        f"{100 * x:.2f}%" for x in drops))
    state_against_arithmetic(tr, tag)
    if cuda:
        want_lf, want_lb, want_lu, want_sa = qwen3_want_launches(
            cfg, tcfg, steps, len(outer_ms),
            ce_chunks=seq // min(cfg.loss_chunk, seq))
        for name, got_c, want_c in (("lowrank_forward", counts["lf"],
                                     want_lf),
                                    ("lowrank_backward", counts["lb"],
                                     want_lb),
                                    ("lowrank_merge", counts["lu"], want_lu),
                                    ("subspace_adam", counts["sa"], want_sa)):
            log(f"[{tag}] launches {name}: " + ", ".join(
                f"{list(k)}={n}" for k, n in got_c.items()))
            if got_c != want_c:
                raise SystemExit(f"[{tag}] {name} launches {got_c}, the path "
                                 f"should make {want_c}")
    if profile:
        t0 = time.perf_counter()
        profile_train(tr, tag=f"profile-{tag}",
                      match=("tc::", PROFILE_KEYS["subspace_adam"]))
        log(f"[{tag}] the profile took {time.perf_counter() - t0:.1f} s")
    if cuda:
        torch.cuda.synchronize()
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return counts, losses


QWEN3_STUDY_LRS = (1e-3, 5e-4, 3e-4, 2e-4, 1e-4)
QWEN3_STUDY_STEPS = 12


def qwen3moe_study(dev, mods, smi, configs):
    """``python3 chip_smoke.py --qwen3moe-study``: the lr of ``[train
    qwen3moe]`` and nothing else.  qwen3-moe-30b-a3b as that phase trains
    it, at each lr of ``QWEN3_STUDY_LRS``, every run with the same 2-step
    warm-up, weights and batches, ``QWEN3_STUDY_STEPS`` steps: each
    step's loss, and after 8, 10 and 12 steps the mean of the last 3
    against the first."""
    for lr in QWEN3_STUDY_LRS:
        tag = f"qwen3moe study lr={lr:g}"
        try:
            _, losses = train_qwen3moe(dev, mods, smi, configs, lr=lr,
                                       steps=QWEN3_STUDY_STEPS, tag=tag,
                                       falling=False, profile=False)
        except SystemExit as e:     # a diverged run is a result here
            log(f"[{tag}] stopped: {e}")
            continue
        log(f"[{tag}] first loss {losses[0]:.4f}; mean of the last 3 "
            + ", ".join(f"after {n} steps {sum(losses[n - 3:n]) / 3:.4f} "
                        f"(margin {losses[0] - sum(losses[n - 3:n]) / 3:+.4f})"
                        for n in (8, 10, 12)))


def compare_moe_update_kernels(mods, dev):
    """Rows 3 and 6 at qwen3-moe-30b-a3b's expert groups (20 layers): the
    merge over a group's whole (G, L, E, k, n) buffer in one launch (the
    w_gate,w_up group holds 8.05 G elements, past 2^31: every item, those
    past element 2^31 among them, is held against the plain version, in
    pieces of ``MERGE_PIECE`` items), and ``subspace_adam`` on the
    groups' B.  The plain merge is timed over the same pieces (its fp32
    whole would not fit), the library call is ``torch.baddbmm`` in place
    on a bf16 copy of B."""
    ref, dispatch = mods["ref"], mods["dispatch"]
    lu, sa = mods["lu"], mods["sa"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bf, r = torch.bfloat16, RANK
    rows = []

    def randn(*shape, scale=1.0, dtype=torch.float32):
        # drawn in pieces of 2^27 elements (a w_gate,w_up group in fp32
        # whole would take 32 GB)
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat, piece = out.view(-1), 1 << 27
        for a in range(0, flat.numel(), piece):
            z = min(flat.numel(), a + piece)
            flat[a:z] = (scale * torch.randn(z - a, generator=gen,
                                             device=dev)).to(dtype)
        return out

    for shape, leaves in QWEN3_EXPERT_GROUPS.items():
        lead, (K, N) = shape[:-2], shape[-2:]
        items = math.prod(lead)
        w = randn(*shape, scale=K ** -0.5, dtype=bf)
        v = randn(*lead, K, r, scale=r ** -0.5, dtype=bf)
        b = randn(*lead, N, r, scale=0.02)
        lu.reset_launches()
        got = lu.lowrank_merge(w, v, b)
        torch.cuda.synchronize()
        path = launch_path(lu, at=1)
        w3, v3, b3 = (t.reshape(items, *t.shape[-2:]) for t in (w, v, b))
        got3 = got.reshape(items, K, N)
        err, past = 0.0, 0
        for a in range(0, items, MERGE_PIECE):
            z = min(items, a + MERGE_PIECE)
            want = ref.lowrank_merge(w3[a:z], v3[a:z], b3[a:z])
            err = max(err, _agree(f"merge {shape} items {a}..{z - 1}",
                                  got3[a:z], want, RTOL, RTOL))
            past += sum(1 for i in range(a, z) if (i + 1) * K * N > 2 ** 31)
            del want
        log(f"[kernel] lowrank_merge {list(shape)}: {w.numel()} elements "
            f"in one launch; all {items} items held against the plain "
            f"version, {past} of them past element 2^31")

        def plain():
            for a in range(0, items, MERGE_PIECE):
                z = min(items, a + MERGE_PIECE)
                got3[a:z] = ref.lowrank_merge(w3[a:z], v3[a:z], b3[a:z])
        b3t = b3.to(bf).transpose(1, 2)
        nbytes = 2 * (2 * K * N + K * r) * items + 4 * N * r * items
        bms, by = bound_of(nbytes, 2 * K * N * r * items, BF16_FLOP_PER_S)
        ms = queued_ms(lambda: lu.lowrank_merge(w, v, b, out=got), calls=5)
        plain_ms = queued_ms(plain, calls=2)
        lib_ms = queued_ms(lambda: torch.baddbmm(w3, v3, b3t, out=got3),
                           calls=5)
        rows.append(dict(kernel="lowrank_merge", shape=shape, leaves=leaves,
                         path=path, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by))
        log(f"[kernel] lowrank_merge      {str(shape):22s} ({leaves}) "
            f"route={path} max_abs_err={err:.4g} (tol {RTOL}*(max|W'|+|W'|)"
            f") ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bms:.4f} ({by}) [queued]")
        del w, v, b, got, w3, v3, b3, got3, b3t
        free()

    for shape, leaves in QWEN3_EXPERT_GROUPS.items():
        bshape = shape[:-2] + (shape[-1], r)
        b, g = randn(*bshape, scale=0.02), randn(*bshape, scale=1e-3)
        m = randn(*bshape, scale=1e-4)
        v = randn(*bshape, scale=1e-4) ** 2
        step = torch.tensor(5, dtype=torch.int32, device=dev)
        scalars = dispatch.adam_scalars(1e-3, step, ADAM["beta1"],
                                        ADAM["beta2"], dev)
        sa.reset_launches()
        err = update_exact(mods, "subspace_adam", b, g, (m, v), scalars)
        if sa.launches() != len(UPDATE_DTYPES):
            raise SystemExit(f"subspace_adam {bshape} launched "
                             f"{sa.launches()} kernels, not "
                             f"{len(UPDATE_DTYPES)}")
        lr, bc1, bc2 = scalars
        n = b.numel()
        pb = b.clone()
        pb.grad = g
        opt = torch.optim.AdamW([pb], lr=1e-3, betas=(ADAM["beta1"],
                                                      ADAM["beta2"]),
                                eps=ADAM["eps"], weight_decay=ADAM["wd"],
                                fused=True)
        ms = queued_ms(lambda: sa.subspace_adam(b, g, m, v, scalars, **ADAM),
                       calls=10)
        plain_ms = queued_ms(lambda: ref.subspace_adam(
            b, g, m, v, lr=lr, bc1=bc1, bc2=bc2, **ADAM), calls=5)
        lib_ms = queued_ms(opt.step, calls=10)
        bms, by = bound_of(28 * n, 15 * n, FP32_FLOP_PER_S)
        rows.append(dict(kernel="subspace_adam", shape=bshape, leaves=leaves,
                         path=UPDATE_PATH, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by))
        log(f"[kernel] subspace_adam      {str(bshape):22s} ({leaves}) "
            f"route={UPDATE_PATH} max_abs_err={err:.4g} (tol exact, 4 (b, "
            f"g) dtypes) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}; "
            f"{bms / ms:.1%} of it) [queued]")
        del b, g, m, v, pb, opt
        free()
    return rows


def qwen3_train_rows(train_rows, update_rows, counts):
    """The JSON rows of rows 1, 2, 3 and 6 at qwen3-moe's training shapes,
    with their launches from ``[train qwen3moe]``."""
    out = []
    for row in train_rows + update_rows:
        kernel, shape = row["kernel"], row["shape"]
        if kernel == "lowrank_forward[p]":
            n = shape_launches(counts["lf"], "p", *shape[1:])
        elif kernel == "lowrank_backward":
            n = sum(c for k, c in counts["lb"].items() if k[1:] == shape[1:])
        elif kernel == "lowrank_merge":
            n = sum(c for k, c in counts["lu"].items()
                    if k[0] == kernel and k[2] == shape)
        else:
            n = counts["sa"].get((kernel, shape), 0)
        out.append({
            "name": f"{kernel} {list(shape)} ({MOE} {row['leaves']})",
            "route": "cuda", "path": row["path"],
            "source": TRAIN_SOURCES[kernel],
            "replaces": TRAIN_REPLACES[kernel], "launches": n,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_share": row["bound_ms"] / row["ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({} if row.get("plan") is None else {"plan": row["plan"]}),
            **({} if row.get("queued") is None else
               {"queued_ms": row["queued"][0],
                "library_queued_ms": row["queued"][1]}),
            **({"timing": "queued"} if kernel in ("lowrank_merge",
                                                  "subspace_adam") else {})})
    return out


# [train==plain qwen3moe]: qwen3-moe-30b-a3b's 2-layer fp32 cut at batch
# 1 x 256, every step replayed on the CPU from the card's state; limits
# relative to each quantity's largest magnitude: the step's loss, every
# gradient of the step (each group's B, the router and the other dense
# leaves), and the merged W of each group after an outer step.  About 5x
# the gaps measured on an H100 80GB HBM3 (700 W; the same to the last
# digit in every run): loss 7.57e-8, gradients 1.22e-5 (fp32
# sums in other orders through 128 experts' products); the merged W
# equal bit for bit (fp32 W: the SIMT merge sums in the plain order), so
# its limit is fp32 rounding
QWEN3_TRAIN_PLAIN_TOL = dict(loss=4e-7, grad=6e-5, merged=1e-6)


def copy_into(dst, src):
    """Copy ``src`` (a trainer's params or optimizer state) into ``dst``,
    a structure of the same shapes on another device: tensors with
    ``copy_`` (no new allocation), a generator by its state where both
    are of one device type (else it is left: a CUDA generator's state
    is no CPU generator's); returns ``dst``."""
    if torch.is_tensor(src):
        return dst.copy_(src)
    if isinstance(src, torch.Generator):
        if src.device.type == dst.device.type:
            dst.set_state(src.get_state())
        return dst
    if isinstance(src, (tuple, list)):
        for d, x in zip(dst, src):
            copy_into(d, x)
    elif isinstance(src, dict):
        for k in src:
            copy_into(dst[k], src[k])
    elif dataclasses.is_dataclass(src) and not isinstance(src, type):
        for f in dataclasses.fields(src):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
    return dst


def _rel(a, b):
    """max |a - b| / max |b| in float64, on ``a``'s device."""
    a, b = a.detach().double(), b.detach().to(a.device).double()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def train_equals_plain_replayed(dev, mods, configs, tol=None, steps=5,
                                batch=1):
    """[train==plain qwen3moe]: the kernel route on the card against the
    plain route on the CPU, qwen3-moe-30b-a3b's 2-layer full-width fp32
    cut, batch ``batch`` x 256, ``lowrank_adam``, lazy_k 2, ``steps``
    steps.  Each step is replayed on the CPU from the card's state
    (weights, B, m, v, V, the step; at an outer step the CPU merges and
    takes the card's fresh V, whose draw is no kernel): a
    trajectory run on its own parts by more than rounding after a few
    steps (a first Adam step after each merge is sign-like, so an
    element whose gradient lies at fp32's rounding noise moves by lr
    either way), and at 5 steps the card's and the CPU's routing then
    differed in one token of 256.  From equal states each
    step must route alike in every call (forward and remat recompute;
    the smallest k-th/(k+1)-th gap and the largest probability
    difference logged), and give the loss, every gradient and, after an
    outer step, every merged W within ``tol``.  Returns the card's
    trained B and V, one of each per group (the tenant of
    :func:`serve_trained_qwen3moe`)."""
    from repro_torch.data.synthetic import StatelessLoader
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.optim import subspace
    from repro_torch.train.trainer import Trainer
    tol = tol or QWEN3_TRAIN_PLAIN_TOL
    tag = f"train==plain {short(MOE)}"
    cfg = cut_config(configs, MOE)
    tcfg = configs.TrainConfig(rank=RANK, compute_dtype="float32", lazy_k=2,
                               warmup_steps=1, total_steps=steps, lr=1e-3)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=7, device=dev)
    loader = StatelessLoader("lm", 3, device=cpu, batch=batch, seq_len=256,
                             vocab=cfg.vocab_size)
    plain_params = tree_map(lambda t: t.cpu(), params)
    card = Trainer(cfg, tcfg, loader, device=dev, params=params)
    real_draw = subspace._sample_proj_group
    draws = []

    def recorded_draw(*a, **kw):
        draws.append(real_draw(*a, **kw))
        return draws[-1]

    def injected_draw(name, gen, spec, n, c, dtype, device, energy=None):
        return draws.pop(0).to(device, dtype)
    # the CPU trainer's own start is overwritten before its first step
    subspace._sample_proj_group = \
        lambda name, gen, spec, n, c, dtype, device, energy=None: \
        torch.zeros((n,) + spec.shape[:-1] + (spec.rank,), dtype=dtype,
                    device=device)
    try:
        plain = Trainer(cfg, tcfg, loader, device=cpu, params=plain_params,
                        sample_device=cpu)
    finally:
        subspace._sample_proj_group = real_draw
    del params, plain_params
    log(f"[{tag}] the weights and both trainers made in "
        f"{time.perf_counter() - t0:.1f} s")
    for mod in mods.get("counters", ()):
        mod.reset_launches()
    real_update = subspace.inner_update
    grads = []

    def recorded_update(g, *a, **kw):
        # copies: the update clips the gradients in place
        grads.append([t.detach().clone()
                      for t in list(g.dense) + list(g.groups)])
        return real_update(g, *a, **kw)
    worst = dict(loss=0.0, grad=0.0, merged=0.0)
    subspace.inner_update = recorded_update
    try:
        merged = False
        for s in range(steps):
            # the grouped W changes at an outer step only
            copy_into(plain.params.dense, card.params.dense)
            if merged:
                copy_into(plain.params.groups, card.params.groups)
            copy_into(plain.opt_state, card.opt_state)
            plain.step = card.step
            merged = merging = card.outer_due()
            grads.clear()
            routes, losses, secs = [], [], []
            for tr, draw in ((card, recorded_draw), (plain, injected_draw)):
                routes.append(RoutingLog(mods["moe"]))
                subspace._sample_proj_group = draw
                t1 = time.perf_counter()
                try:
                    with routes[-1]:
                        losses.append(tr.run(1).losses[0])
                finally:
                    subspace._sample_proj_group = real_draw
                secs.append(time.perf_counter() - t1)
            if draws:
                raise SystemExit(f"[{tag}] the CPU took {len(draws)} fewer "
                                 f"draws than the card")
            same_routing(f"{tag} step {s + 1}", *routes, gap_rule=False)
            got = dict(loss=abs(losses[0] - losses[1]) / abs(losses[1]),
                       grad=max(_rel(a, b) for a, b in zip(*grads)))
            if merging:
                got["merged"] = max(_rel(a, b) for a, b in zip(
                    card.params.groups, plain.params.groups))
            log(f"[{tag}] step {s + 1}"
                + (" (after an outer merge)" if merging else "")
                + f" ({secs[0]:.1f} s on the card, {secs[1]:.1f} s on the "
                f"CPU): loss card {losses[0]:.7f} cpu {losses[1]:.7f}; "
                + ", ".join(f"{k} max rel diff {v:.3g}"
                            for k, v in got.items()))
            for k, v in got.items():
                worst[k] = max(worst[k], v)
    finally:
        subspace.inner_update = real_update
    log(f"[{tag}] {cfg.name} {cfg.num_layers} layers, fp32 compute, batch "
        f"{batch}x256 lazy_k=2, {steps} steps each replayed from the card's "
        f"state: max rel diff " + ", ".join(
            f"{k} {v:.3g} (tol {tol[k]})" for k, v in worst.items()))
    if "lf" in mods:
        by_route = {}
        for (_, route, _, _), n in mods["lf"].LAUNCHES.items():
            by_route[route] = by_route.get(route, 0) + n
        log(f"[{tag}] card launches: forward by route {by_route}, "
            f"backward {mods['lb'].launches()}, merge "
            f"{mods['lu'].launches('lowrank_merge')}, subspace_adam "
            f"{mods['sa'].launches('subspace_adam')} (fp32, r = {RANK})")
        if set(by_route) - {"simt"} or not (
                mods["lb"].launches() and mods["lu"].launches("lowrank_merge")
                and mods["sa"].launches("subspace_adam")):
            raise SystemExit(f"[{tag}] the card run missed a training kernel "
                             f"or left the SIMT route: {by_route}")
    bad = {k: v for k, v in worst.items() if not v <= tol[k]}
    if bad:
        raise SystemExit(f"[{tag}] training through the kernels disagrees "
                         f"with the plain route: {bad} over {tol}")
    trained = ([g.b for g in card.opt_state.groups],
               [g.proj for g in card.opt_state.groups])
    del card, plain
    free()
    return trained


def serve_trained_qwen3moe(dev, mods, configs, trained):
    """[serve trained tenant qwen3moe lazy==merged]: the B and V that
    ``[train==plain qwen3moe]``'s card trainer left (qwen3-moe's 2-layer
    fp32 cut, 5 steps; every expert's), installed as a tenant of a store
    of that cut, lazy == merged within phase 5's limit, routed alike.
    (They are installed by ``add_tenant``: the cut's checkpoint, 7.5 GB
    of fp32, takes 32 s to write; ``load_tenant`` reads a trained MoE
    checkpoint in ``tests/test_torch_moe_train_methods.py``.)"""
    serve_mod = mods["serve"]
    cfg = cut_config(configs, MOE)
    store = serve_mod.AdapterStore(cfg, configs.TrainConfig(rank=RANK), 1,
                                   device=dev)
    store.add_tenant("trained", *trained)
    # equal masks are asked for; the gap rule is not: a trained router has
    # pairs nearer a tie than the random init's (2.79e-7 against a
    # probability difference of 2.68e-7 between the lazy and merged runs
    # on an H100), which the two runs still route alike
    lazy_equals_merged(dev, mods, MOE, S=128, store=store, tenant="trained",
                       tag="serve trained tenant qwen3moe lazy==merged",
                       gap_rule=False)
    free()


def train_launches(mods):
    """The launch counters of the training kernels, by JSON row key."""
    lf, lb, lu, sa = mods["lf"], mods["lb"], mods["lu"], mods["sa"]
    out = {}
    for (K, N) in TRAIN_SHAPES:
        out[("lowrank_forward[p]", (TRAIN_M, K, N))] = \
            shape_launches(lf.LAUNCHES, "p", K, N)
        out[("lowrank_backward", (TRAIN_M, K, N))] = \
            shape_launches(lb.LAUNCHES, K, N)
    for shape in MERGE_SHAPES:
        out[("lowrank_merge", shape)] = update_launches(lu, "lowrank_merge",
                                                        shape)
        bshape = shape[:-2] + (shape[-1], RANK)
        out[("subspace_adam", bshape)] = sa.LAUNCHES.get(
            ("subspace_adam", bshape), 0)
    log("[train] launches " + ", ".join(
        f"{k}{list(s)}={n}" for (k, s), n in out.items()))
    return out


# the compressed-state runs: (tag, TrainConfig fields, steps, kernels the
# run must launch at every group shape)
STATE_RUNS = (
    ("train 6b", dict(optimizer="lowrank_adam", state_dtype="int8",
                      master_dtype="bfloat16", lazy_k=4, lr=3e-3), 14,
     ("subspace_adam_q8", "lowrank_merge_sr")),
    ("train 6c", dict(optimizer="lowrank_lion", state_dtype="int8",
                      master_dtype="bfloat16", lazy_k=3, lr=3e-4,
                      beta2=0.99), 8,
     ("subspace_lion_q8", "lowrank_merge_sr")),
    ("train 6d", dict(optimizer="lowrank_lion", lazy_k=3, lr=3e-4,
                      beta2=0.99), 8,
     ("subspace_lion", "lowrank_merge")),
)


def state_launches(mods, kernel):
    """{group shape: launches} of one update or merge kernel, keyed by the
    group's B shape (updates) or W shape (merges).  The q8 wrappers see a
    group as (R, 128) rows and count it so."""
    sa, lu = mods["sa"], mods["lu"]
    out = {}
    for shape in MERGE_SHAPES:
        bshape = shape[:-2] + (shape[-1], RANK)
        if kernel.startswith("lowrank_merge"):
            out[shape] = update_launches(lu, kernel, shape)
        elif kernel.endswith("_q8"):
            out[bshape] = sa.LAUNCHES.get(
                (kernel, (math.prod(bshape) // QROW, QROW)), 0)
        else:
            out[bshape] = sa.LAUNCHES.get((kernel, bshape), 0)
    return out


def train_state_runs(dev, mods, smi, configs, fp32_bytes):
    """Phase 6b-6d; returns {(kernel, group shape): launches} summed over
    the runs."""
    counts = {}
    for tag, fields, steps, kernels in STATE_RUNS:
        cfg, tcfg = train_config(configs, warmup_steps=2, total_steps=1000,
                                 **fields)
        tr, _ = train(dev, mods, smi, cfg, tcfg, TRAIN_BATCH, TRAIN_SEQ,
                      steps, tag=tag)
        nb = state_bytes(tr)
        log(f"[{tag}] subspace state {nb} bytes = {nb / 1e6:.1f} MB, "
            f"{100 * nb / fp32_bytes:.1f}% of lowrank_adam on fp32 state "
            f"({fp32_bytes / 1e6:.1f} MB)")
        for kernel in kernels:
            got = state_launches(mods, kernel)
            log(f"[{tag}] launches {kernel} " + ", ".join(
                f"{list(s)}={n}" for s, n in got.items()))
            if not all(got.values()):
                raise SystemExit(f"{tag} missed {kernel} at a group shape: "
                                 f"{got}")
            for shape, n in got.items():
                counts[(kernel, shape)] = counts.get((kernel, shape), 0) + n
        profile_train(tr, steps=1, tag=f"profile {tag}",
                      match=(PROFILE_KEYS[kernels[0]],), top=0)
        del tr
        torch.cuda.empty_cache()
    return counts


# the comparison methods' runs: (tag, TrainConfig fields, steps, the
# cadence the run must show twice, whether its loss must fall)
METHOD_RUNS = (
    ("train 6e", dict(optimizer="galore", lazy_k=4, lr=3e-3), 8,
     "refreshes", True),
    ("train 6f", dict(optimizer="adamw", lr=3e-3), 8, None, True),
    ("train 6g", dict(optimizer="lowrank_lr", lazy_k=4, lr=3e-3), 9,
     "merges", False),
)


def method_runs(dev, mods, smi, configs):
    """Phase 6e-6g; returns {(JSON row key): launches} of the kernels
    these paths add: GaLore's projection (6e) and the shared-B forward of
    the forward-only estimator (6g)."""
    lf, lu = mods["lf"], mods["lu"]
    counts = {}
    for tag, fields, steps, cadence, falling in METHOD_RUNS:
        cfg, tcfg = train_config(configs, warmup_steps=2, total_steps=1000,
                                 **fields)
        tr, _ = train(dev, mods, smi, cfg, tcfg, TRAIN_BATCH, TRAIN_SEQ,
                      steps, tag=tag, cadence=cadence, falling=falling)
        new, also = {}, {}       # this path's new rows; earlier rows
        if tcfg.optimizer == "galore":
            new = {("lowrank_project", shape):
                   update_launches(lu, "lowrank_project", shape)
                   for shape in MERGE_SHAPES}
        elif tcfg.optimizer == "lowrank_lr":
            new = {("lowrank_forward[shared]", (TRAIN_M, K, N)):
                   shape_launches(lf.LAUNCHES, "shared", K, N)
                   for K, N in TRAIN_SHAPES}
            for kernel in ("subspace_adam", "lowrank_merge"):
                also.update({(kernel, shape): n for shape, n in
                             state_launches(mods, kernel).items()})
        got = {**new, **also}
        total = sum(mod.launches() for mod in mods["counters"])
        log(f"[{tag}] launches " + (", ".join(
            f"{k}{list(s)}={n}" for (k, s), n in got.items())
            or f"of the port's kernels: {total} (dense GEMMs only)"))
        if not all(got.values()):
            raise SystemExit(f"{tag} missed a kernel at a shape: {got}")
        counts.update(new)
        profile_train(tr, steps=2 if cadence == "refreshes" else 1,
                      tag=f"profile {tag}", match=("tc::",) if total else (),
                      top=8)
        del tr
        torch.cuda.empty_cache()
    return counts


def profile_train(tr, steps=2, tag="profile-train", match=(), top=12):
    """Where a training step's time goes: device time by kernel over
    ``steps`` inner steps (no outer merge among them; a GaLore window
    may hold a basis refresh), against the host clock, and the device
    time of the kernels whose names hold one of ``match``.  Only the
    device is traced (the host's ops would cost the trace tens of
    thousands of events a step at zamba2-7b); the profiler still slows
    the host, so the idle share is an upper bound.  A string of ``match``
    that names no kernel of the window fails the run."""
    from torch.profiler import ProfilerActivity, profile
    if tr.method.make_outer_step(tr.cfg, tr.tcfg) is not None and any(
            (tr.step + i) % tr.tcfg.lazy_k == 0 for i in range(steps)):
        raise SystemExit("profile window would include an outer merge")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, dev_us = device_rows(prof)
    log(f"[{tag}] {steps} inner steps: host {1e3 * wall / steps:.1f} "
        f"ms/step, device busy {dev_us / 1e3 / steps:.1f} ms/step "
        f"({100 * dev_us / 1e6 / wall:.1f}% busy)")
    for e in rows[:top]:
        log(f"[{tag}] {e.self_device_time_total / 1e3 / steps:8.2f} "
            f"ms/step  x{e.count // steps:5d}  {e.key[:90]}")
    missing = [m for m in match if not any(m in e.key for e in rows)]
    if missing:
        raise SystemExit(f"[{tag}] no kernel of the window is named by "
                         f"{missing}")
    for e in rows:
        if any(m in e.key for m in match):
            name = e.key.replace("(anonymous namespace)::", "")
            log(f"[{tag}] {name[:60]}: {e.count // steps} calls/step, "
                f"{e.self_device_time_total / e.count / 1e3:.4f} ms device "
                f"time per call")
    bwd = [e for e in rows if "ssd_bwd_" in e.key]
    if bwd:
        log(f"[{tag}] ssd_intra_chunk_bwd: "
            f"{sum(e.self_device_time_total for e in bwd) / 1e3 / steps:.2f}"
            f" device ms/step in its two grids")
    fin = [e for e in rows if "finish" in e.key]
    log(f"[{tag}] the forward's finish epilogue: " + (", ".join(
        f"{e.self_device_time_total / 1e3 / steps:.2f} ms/step" for e in fin)
        or "no rows"))
    return 1e3 * wall / steps, dev_us / 1e3 / steps


# Phase 7's runs: (label, TrainConfig fields, relative per-step loss gap
# allowed between the card's kernel route and the CPU's plain route).
# fp32 state: the same fp32 arithmetic, sums in another order.  int8
# moments + bf16 masters (bf16 stored weights): the B gradient is bf16, so
# a last-bit difference of the fp32 gradient moves its bf16 rounding, a
# stochastic round of B or W, or an int8 payload by one step at a few
# elements per thousand, and the next steps carry it.  GaLore: cuSOLVER's
# and LAPACK's eigenvectors differ in their last bits, more where two
# eigenvalues lie close, and the basis carries that into every step of
# its interval.  AdamW and LowRank-LR: fp32 sums in another order.  Each
# limit is about five times its own gap as measured on an H100 80GB HBM3
# (700 W; the same to the last digit in every run): Adam int8 + bf16
# 3.06e-6, Lion int8 + bf16 6.08e-6, GaLore 8.1e-6, AdamW 1.76e-7,
# LowRank-LR 8.8e-8.
PLAIN_RUNS = (
    ("fp32", dict(), 1e-4),
    ("lowrank_adam int8+bf16", dict(optimizer="lowrank_adam",
                                    state_dtype="int8",
                                    master_dtype="bfloat16"), 1.5e-5),
    ("lowrank_lion int8+bf16", dict(optimizer="lowrank_lion",
                                    state_dtype="int8",
                                    master_dtype="bfloat16", lr=3e-4,
                                    beta2=0.99), 3e-5),
    ("galore", dict(optimizer="galore"), 4e-5),
    ("adamw", dict(optimizer="adamw"), 1e-6),
    ("lowrank_lr", dict(optimizer="lowrank_lr"), 5e-7),
)
# [train==plain mamba2]: mamba2-780m cut to 2 layers at full width, fp32,
# lowrank_adam; the same fp32 arithmetic with sums in other orders (the
# SSD kernels' 3xTF32 products and fp32 FMAs, cuBLAS's, against the
# CPU's).  About six times its gap as measured on an H100 80GB HBM3 (700
# W; 1.68e-7, the same to the last digit in five runs)
MAMBA_PLAIN_TOL = 1e-6
# [train==plain zamba2]: zamba2-7b's 3-layer fp32 cut (a group of two
# Mamba2 layers, the shared block, a tail layer), batch 1 x 256, as above;
# about 5.7 times its gap as measured on an H100 80GB HBM3 (700 W),
# 1.76e-7
ZAMBA_TRAIN_PLAIN_TOL = 1e-6


def train_equals_plain(dev, mods, configs, label="fp32", fields=(),
                       tol=1e-4, steps=5, arch=TRAIN_ARCH, batch=4):
    """Phase 7: the kernel route on the card against the plain route on
    the CPU, fp32 compute, from the same weights, V draws, rounding bits
    (drawn on the CPU for both) and batches of ``batch`` x 256, on the
    full-width cut (2 layers; the hybrid 3 with ``attn_every`` 2, as
    :func:`cut_config`).  Under bf16 masters the low-rank weights are
    stored in bf16, so the merge is the stochastically rounded one."""
    from repro_torch.data.synthetic import StatelessLoader
    from repro_torch.models import lm
    from repro_torch.models.common import (tree_flatten_with_path,
                                           tree_map, tree_unflatten)
    from repro_torch.optim import subspace
    from repro_torch.train.trainer import Trainer
    fields = dict(dict(lr=1e-3), **dict(fields))
    cfg = cut_config(configs, arch)
    tcfg = configs.TrainConfig(rank=RANK, compute_dtype="float32", lazy_k=2,
                               warmup_steps=1, total_steps=steps, **fields)
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, seed=7, device=cpu)
    if tcfg.master_dtype == "bfloat16":
        low = {i for spec in subspace.build_layout(params, tcfg).groups
               for i in spec.leaf_idx}
        flat = tree_flatten_with_path(params)
        params = tree_unflatten(
            [p for p, _ in flat],
            [x.bfloat16() if i in low else x for i, (_, x) in
             enumerate(flat)])
    loader = StatelessLoader("lm", 3, device=cpu, batch=batch, seq_len=256,
                             vocab=cfg.vocab_size)
    for mod in mods.get("counters", ()) + ((mods["sc"],) if "sc" in mods
                                           else ()):
        mod.reset_launches()
    card, plain = (
        Trainer(cfg, tcfg, loader, device=where,
                params=tree_map(lambda t: t.to(where), params),
                sample_device=cpu).run(steps).losses
        for where in (dev, cpu))
    worst = max(abs(a - b) / abs(b) for a, b in zip(card, plain))
    tag = "train==plain" + ("" if arch == TRAIN_ARCH
                            else f" {arch.split('-')[0]}")
    log(f"[{tag}] {cfg.name} {cfg.num_layers} layers, {label}, fp32 "
        f"compute, batch {batch}x256 lazy_k=2, {steps} steps: card {card}, "
        f"cpu {plain}, max rel diff {worst:.3g} (tol {tol})")
    if "lf" in mods:
        # fp32 at r = 128: every forward launch on the SIMT route (the
        # small-rank route takes r <= lf.SMALL_RANK only)
        by_route = {}
        for (_, route, _, _), n in mods["lf"].LAUNCHES.items():
            by_route[route] = by_route.get(route, 0) + n
        log(f"[{tag}] forward launches by route: {by_route} (fp32, r = "
            f"{tcfg.rank})")
        if set(by_route) - {"simt"}:
            raise SystemExit(f"[{tag}] an fp32 r = {tcfg.rank} forward left "
                             f"the SIMT route: {by_route}")
    if cfg.family in ("ssm", "hybrid"):
        sc = mods["sc"]
        fwd, bwd = (sum(n for k, n in sc.LAUNCHES.items() if k[0] == kernel)
                    for kernel in ("ssd_intra_chunk", "ssd_intra_chunk_bwd"))
        log(f"[{tag}] card launches ssd_intra_chunk={fwd} "
            f"ssd_intra_chunk_bwd={bwd} lowrank_forward="
            f"{mods['lf'].launches()} lowrank_backward="
            f"{mods['lb'].launches()}")
        if not (fwd and bwd and mods["lf"].launches()
                and mods["lb"].launches()):
            raise SystemExit("the card run missed an SSM training kernel")
    if "lu" in mods and tcfg.optimizer == "galore":
        n = mods["lu"].launches("lowrank_project")
        log(f"[train==plain] card launches lowrank_project={n}")
        if not n:
            raise SystemExit("the card run missed lowrank_project")
    if "lf" in mods and tcfg.optimizer == "lowrank_lr":
        n = mods["lf"].launches("shared")
        log(f"[train==plain] card launches lowrank_forward[shared]={n}")
        if not n:
            raise SystemExit("the card run missed lowrank_forward[shared]")
    if "sa" in mods and tcfg.state_dtype == "int8":
        kernel = f"subspace_{tcfg.optimizer.removeprefix('lowrank_')}_q8"
        n_upd, n_sr = (mods["sa"].launches(kernel),
                       mods["lu"].launches("lowrank_merge_sr"))
        log(f"[train==plain] card launches {kernel}={n_upd} "
            f"lowrank_merge_sr={n_sr}")
        if not (n_upd and n_sr):
            raise SystemExit(f"the card run missed a kernel: {kernel}="
                             f"{n_upd}, lowrank_merge_sr={n_sr}")
    if not worst <= tol:
        raise SystemExit(f"training through the kernels disagrees with the "
                         f"plain route ({label}): {worst} > {tol}")


# ---------------------------------------------------------------------------
# Phase 8: the paper's samplers, the instance-dependent draw in training,
# gradient accumulation and encoder fine-tuning
# ---------------------------------------------------------------------------

# (rows, k) of the llama-100m groups' V draws at r = RANK: (wq,wk,wv,wo)
# 4 members x 12 layers, (w_gate,w_up) 2 x 12, (w_down) 12, the unembedding
SAMPLER_SHAPES = ((48, 640), (24, 640), (12, 1712), (1, 640))
SAMPLER_DRAWS = 960         # Monte-Carlo draws per shape (at least)
SAMPLER_Z = 7.0             # limits in standard deviations of the mean


def _sampler_energy(gen, rows, k, dev):
    """A non-uniform energy row per draw row: sqrt(e) spread 1..20 with
    five directions at 200 (capped, pi = 1), so every other pi is at
    least about 0.03 and each coordinate is drawn tens of times."""
    u = torch.rand((rows, k), generator=gen, device=dev)
    s = 1.0 + 19.0 * u ** 3
    s[:, :5] = 200.0
    return s ** 2


def sampler_laws(dev, mods):
    """Phase 8a: each sampler batched at the llama-100m group shapes on
    the card.  Stiefel and coordinate: ``Vᵀ V = (k/r) I`` (fp32: Stiefel
    within 1e-4 of k/r, coordinate 1e-6); coordinate and dependent_diag:
    one nonzero per column, in distinct rows; dependent_diag on a
    non-uniform energy: ``sum(pi) = r`` within 1e-5 r and each nonzero
    ``sqrt(c / pi_i)``; every sampler: ``E[V Vᵀ] = c I`` over at least
    ``SAMPLER_DRAWS`` draws (and 30 / min pi, so the rarest coordinate
    is drawn about 30 times), each element within ``SAMPLER_Z`` standard
    deviations of its mean (measured from the draws) plus 1e-5 c.  The
    coordinate and dependent_diag draws (and a group resample through
    the optimizer's warm-up) run under ``set_sync_debug_mode("error")``.
    Logs ms per draw, queued."""
    from repro_torch.core import samplers
    from repro_torch.optim import subspace
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    r, c = RANK, 1.0
    for rows, k in SAMPLER_SHAPES:
        energy = _sampler_energy(gen, rows, k, dev)
        pi = samplers.waterfill_inclusion_probs(energy, r)
        for name in ("gaussian", "stiefel", "coordinate", "dependent_diag"):
            kw = {"diag_energy": energy} if name == "dependent_diag" else {}

            def draw():
                return samplers.sample_v_batched(name, gen, rows, k, r, c=c,
                                                 **kw)
            if name in ("coordinate", "dependent_diag"):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    v = draw()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                v = draw()
            notes = []
            if name in ("stiefel", "coordinate"):
                gram = v.mT @ v
                err = (gram - (c * k / r) * torch.eye(r, device=dev)).abs() \
                    .max().item() / (c * k / r)
                lim = 1e-4 if name == "stiefel" else 1e-6
                notes.append(f"|VᵀV − (ck/r)I| {err:.3g}·(ck/r) (≤ {lim})")
                if not err <= lim:
                    raise SystemExit(f"[samplers] {name} {rows}x{k}: VᵀV is "
                                     f"not (ck/r) I: {err}")
            if name in ("coordinate", "dependent_diag"):
                nz = v != 0
                ok = bool(((nz.sum(-2) == 1).all() & (nz.sum(-1) <= 1).all())
                          .item())
                notes.append(f"one nonzero per column in distinct rows: {ok}")
                if not ok:
                    raise SystemExit(f"[samplers] {name} {rows}x{k}: a "
                                     f"column or row holds two nonzeros")
            if name == "dependent_diag":
                gap = (pi.sum(-1) - r).abs().max().item()
                sel = (v != 0).int().argmax(-2)
                lift = torch.sqrt(c / torch.gather(pi, -1, sel))
                got = torch.gather(v, -2, sel[:, None, :])[:, 0]
                werr = ((got - lift).abs() / lift).max().item()
                capped = int((pi >= 1.0).sum(-1).min().item())
                notes.append(f"|sum(pi) − r| {gap:.3g}, capped ≥ {capped} a "
                             f"row, min pi {pi.min().item():.4f}, lift "
                             f"weights within {werr:.2g} of sqrt(c/pi)")
                if not (gap <= 1e-5 * r and werr <= 1e-6):
                    raise SystemExit(f"[samplers] dependent_diag {rows}x{k}: "
                                     f"sum(pi) off r by {gap} or lift "
                                     f"weights off by {werr}")
            # E[V Vᵀ] = c I by Monte Carlo, with draws enough that the
            # rarest coordinate is drawn about 30 times (its mean then has
            # a measured spread)
            draws = max(SAMPLER_DRAWS, math.ceil(30 / pi.min().item()))
            calls = -(-draws // rows)
            s1 = torch.zeros((k, k), dtype=torch.float64, device=dev)
            s2 = torch.zeros_like(s1)
            for _ in range(calls):
                p = (lambda vv: vv @ vv.mT)(draw())
                s1 += p.sum(0).double()
                s2 += (p * p).sum(0).double()
            n = calls * rows
            mean = s1 / n
            sd = torch.sqrt(torch.clamp(s2 / n - mean * mean, min=0.0))
            dev_ = (mean - c * torch.eye(k, dtype=torch.float64, device=dev))
            z = (dev_.abs() / (sd / n ** 0.5 + 1e-30)).max().item()
            bad = (dev_.abs() > SAMPLER_Z * sd / n ** 0.5 + 1e-5 * c) \
                .sum().item()
            # the QR's solver reads its status back to the host, so the
            # Stiefel draw is timed eager; the others queued
            ms = time_ms(draw, iters=10) if name == "stiefel" else \
                queued_ms(draw, calls=10)
            log(f"[samplers] {name:14s} {rows:2d} x ({k}, {r}): {ms:.4f} ms "
                f"per draw ({'eager' if name == 'stiefel' else 'queued'}); "
                f"E[VVᵀ] over {n} draws: max |mean − "
                f"cI| {dev_.abs().max().item():.3g}, largest z {z:.2f}, "
                f"{bad} of {k * k} elements beyond {SAMPLER_Z}σ; "
                + "; ".join(notes))
            if bad:
                raise SystemExit(f"[samplers] {name} {rows}x{k}: E[VVᵀ] "
                                 f"departs from cI at {bad} elements")
            del s1, s2, mean, sd, dev_
    # the optimizer's group resample (warm-up rows and the repeat across
    # a member's layers) under the same sync check
    spec = subspace.GroupSpec(shape=(12, 640, 640), rank=RANK,
                              leaf_idx=(0, 1, 2, 3))
    energy = _sampler_energy(gen, 4, 640, dev)
    energy[0] = 0.0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v = subspace._sample_proj_group("dependent_diag", gen, spec, 4, 1.0,
                                        torch.bfloat16, dev, energy=energy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[samplers] subspace._sample_proj_group dependent_diag "
        f"{tuple(v.shape)} bf16 (member 0 warming up): no host sync")


def pi_stats(tr, tag):
    """Per group, the pi the next resample water-fills (after the
    per-member warm-up): capped directions t per member, min and max pi,
    and whether every member's pi is non-uniform."""
    from repro_torch.core import samplers
    out = []
    for spec, slot in zip(tr.opt_state.layout.groups, tr.opt_state.groups):
        e = slot.energy
        e = torch.where(e.sum(-1, keepdim=True) > 0, e, torch.ones_like(e))
        pi = samplers.waterfill_inclusion_probs(e, spec.rank)
        t = (pi >= 1.0).sum(-1)
        spread = (pi.amax(-1) - pi.amin(-1)).min().item()
        out.append(spread > 1e-6)
        log(f"[{tag}] group {spec.shape} r={spec.rank}: capped t per member "
            f"{t.tolist()}, min pi {pi.min().item():.3g}, max pi "
            f"{pi.max().item():.4f}, energy sum {e.sum().item():.4g}")
    return all(out)


def lift_stats(tr, tag):
    """Per group, the largest lift weight sqrt(c/pi) the resample drew: the
    largest |V| entry."""
    log(f"[{tag}] largest lift weight sqrt(c/pi) drawn per group: "
        + ", ".join(f"{spec.shape}: {slot.proj.float().abs().max().item():.4g}"
        for spec, slot in zip(tr.opt_state.layout.groups,
                              tr.opt_state.groups)))


def profile_energy(tr, tag, steps=2):
    """Device ms per inner step of the energy EMA: the profiler's device
    time under a range around each group's update."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.optim import subspace
    orig = subspace._group_energy_update

    def ranged(slot, g32):
        with record_function("energy_ema"):
            return orig(slot, g32)
    subspace._group_energy_update = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.run(steps)
            torch.cuda.synchronize()
    finally:
        subspace._group_energy_update = orig
    # the host-side ranges: each one's device time is that of the kernels
    # launched inside it (the trace also holds a device-side copy of each
    # range, which would count them twice)
    rows = [e for e in prof.events() if e.name == "energy_ema"
            and e.device_type == torch.autograd.DeviceType.CPU]
    dev_us = sum(e.device_time_total for e in rows)
    calls = len(rows)
    log(f"[{tag}] energy EMA: {dev_us / 1e3 / steps:.4f} device ms per "
        f"inner step ({calls // steps} group updates per step, profiler)")
    if not calls:
        raise SystemExit(f"[{tag}] the energy EMA never ran")


# the sampler runs: 6a's settings with another V law
SAMPLER_RUNS = (("train 6h", "dependent_diag"), ("train 6i", "coordinate"),
                ("train 6j", "gaussian"))


def sampler_runs(dev, mods, smi, configs):
    """Phase 8b: llama-100m ``lowrank_adam`` as 6a with each of the other
    samplers; 6h (``dependent_diag``) logs before each merge the pi it
    water-fills (failing unless every member's pi is non-uniform at the
    first merge) and after it the lift weights drawn, then profiles the
    energy EMA.  Returns the runs' launches by JSON row key."""
    counts = {}
    for tag, sampler in SAMPLER_RUNS:
        cfg, tcfg = train_config(configs, lazy_k=4, lr=3e-3, warmup_steps=2,
                                 total_steps=1000, sampler=sampler)
        checks = []

        def hook(tr, s):
            if sampler != "dependent_diag":
                return
            if tr.outer_due():
                checks.append(pi_stats(tr, tag))
            elif s > 1 and (s - 1) % tcfg.lazy_k == 0:
                lift_stats(tr, tag)
        tr, _ = train(dev, mods, smi, cfg, tcfg, TRAIN_BATCH, TRAIN_SEQ,
                      steps=14, tag=tag, hook=hook)
        for key, n in train_launches(mods).items():
            counts[key] = counts.get(key, 0) + n
        if sampler == "dependent_diag":
            if not (checks and checks[0]):
                raise SystemExit(f"[{tag}] pi is uniform in a group at the "
                                 f"first merge: the draw ignored the "
                                 f"gradients")
            profile_energy(tr, tag)
        del tr
        torch.cuda.empty_cache()
    return counts


def accum_run(dev, mods, smi, configs, peak_6a):
    """Phase 8c: 6a at the paper's 512 sequences as 8 microbatches of 64 x
    256; its peak must stay within 1 GiB of 6a's."""
    cfg, tcfg = train_config(configs, lazy_k=4, lr=3e-3, warmup_steps=2,
                             total_steps=1000, grad_accum=8)
    tr, _ = train(dev, mods, smi, cfg, tcfg, 8 * TRAIN_BATCH, TRAIN_SEQ,
                  steps=8, tag="train 6a accum", cadence=None)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train 6a accum] peak {peak:.2f} GiB against 6a's {peak_6a:.2f} "
        f"GiB at one eighth of the batch; {tr.opt_state.outer_step.item()} "
        f"outer merge(s)")
    if not abs(peak - peak_6a) <= 1.0:
        raise SystemExit(f"accumulation peak {peak:.2f} GiB is not within 1 "
                         f"GiB of 6a's {peak_6a:.2f}")
    if tr.opt_state.outer_step.item() < 1:
        raise SystemExit("the accumulation run merged no time")
    counts = train_launches(mods)
    del tr
    torch.cuda.empty_cache()
    return counts


def train_equals_plain_dependent(dev, mods, configs, tol=1e-4, steps=5):
    """Phase 8d: ``dependent_diag`` through the kernels on the card against
    the plain route on the CPU (the 2-layer full-width cut, fp32 compute,
    5 steps, lazy_k 2, V drawn from a CPU generator on both sides): losses
    within ``tol`` relative per step, and the energy each resample
    water-fills and the energy at the end within ``tol`` of its largest
    entry.  A resample whose systematic selection differs between the
    sides (an energy off by its last bits moves a point across an
    interval's edge) is logged, and drawn again from the CPU's energy,
    then, if it still differs, given the CPU's V."""
    from repro_torch.data.synthetic import StatelessLoader
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.optim import subspace
    from repro_torch.train.trainer import Trainer
    cfg, tcfg = train_config(configs, layers=2, dtype="float32",
                             compute_dtype="float32", lazy_k=2,
                             warmup_steps=1, total_steps=steps, lr=1e-3,
                             sampler="dependent_diag")
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, seed=7, device=cpu)
    loader = StatelessLoader("lm", 3, device=cpu, batch=4, seq_len=256,
                             vocab=cfg.vocab_size)
    orig = subspace._sample_proj_group
    drawn = []

    def record(name, gen, spec, n, c, dtype, device, energy=None):
        v = orig(name, gen, spec, n, c, dtype, device, energy=energy)
        drawn.append((energy.clone(), v))
        return v

    def run(where, sampler):
        subspace._sample_proj_group = sampler
        try:
            tr = Trainer(cfg, tcfg, loader, device=where,
                         params=tree_map(lambda t: t.to(where), params),
                         sample_device=cpu)
            return tr, tr.run(steps).losses
        finally:
            subspace._sample_proj_group = orig

    plain, plain_losses = run(cpu, record)
    calls, gaps, flips = iter(drawn), [0.0], []

    def rel(a, b):
        return ((a.cpu() - b).abs().max() /
                b.abs().max().clamp(min=1e-30)).item()

    def compare(name, gen, spec, n, c, dtype, device, energy=None):
        e_cpu, v_cpu = next(calls)
        state = gen.get_state()
        v = orig(name, gen, spec, n, c, dtype, device, energy=energy)
        gaps.append(rel(energy, e_cpu))
        if not torch.equal((v != 0).cpu(), v_cpu != 0):
            gen.set_state(state)
            v = orig(name, gen, spec, n, c, dtype, device,
                     energy=e_cpu.to(device))
            injected = "energy"
            if not torch.equal((v != 0).cpu(), v_cpu != 0):
                v, injected = v_cpu.to(device, dtype), "V"
            flips.append((spec.shape, injected))
        return v

    for mod in mods.get("counters", ()):
        mod.reset_launches()
    card, card_losses = run(dev, compare)
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                    plain_losses))
    end = max(rel(a.energy, b.energy)
              for a, b in zip(card.opt_state.groups, plain.opt_state.groups))
    log(f"[train==plain dependent_diag] {cfg.name} 2 layers, fp32 compute, "
        f"batch 4x256 lazy_k=2, {steps} steps: card {card_losses}, cpu "
        f"{plain_losses}, max rel diff {worst:.3g} (tol {tol}); energy at "
        f"the resamples within {max(gaps):.3g}, at the end {end:.3g} of its "
        f"largest entry (tol {tol}); selections that flipped: "
        f"{flips or 'none'}; card launches forward={mods['lf'].launches()} "
        f"backward={mods['lb'].launches()} "
        f"merge={mods['lu'].launches('lowrank_merge')}")
    if not (worst <= tol and max(gaps) <= tol and end <= tol):
        raise SystemExit("dependent_diag training through the kernels "
                         "disagrees with the plain route")


# ---------------------------------------------------------------------------
# Phase 9: encoder fine-tuning (the paper's section 6.2.1)
# ---------------------------------------------------------------------------

FT_ARCH, FT_CLASSES = "encoder-small", 4
FT_BATCH, FT_SEQ, FT_STEPS = 32, 256, 200
FT_M = FT_BATCH * FT_SEQ
FT_RANK = 4
# (K, N) of the encoder's low-rank forward -> leaves; its grouped weights
ENC_SHAPES = {(256, 256): "wq,wk,wv,wo", (256, 683): "w_gate,w_up",
              (683, 256): "w_down"}
ENC_MERGE_SHAPES = {(4, 4, 256, 256): "wq,wk,wv,wo",
                    (2, 4, 256, 683): "w_gate,w_up",
                    (1, 4, 683, 256): "w_down"}
# the reference's table settings (benchmarks/finetune_table.py): rank 4,
# lazy_k 50, lr 2e-4, zo_sigma 1e-2, constant lr, low rank from dim 64;
# compute in fp32, as the model
FT_COMMON = dict(rank=FT_RANK, lazy_k=50, schedule="constant",
                 warmup_steps=0, total_steps=FT_STEPS,
                 min_dim_for_lowrank=64, weight_decay=0.0,
                 compute_dtype="float32")
FT_RUNS = tuple((f"lowrank_lr {s}", dict(optimizer="lowrank_lr", sampler=s,
                                         lr=2e-4, zo_sigma=1e-2))
                for s in ("gaussian", "stiefel", "coordinate")) + (
    ("adamw", dict(optimizer="adamw", lr=1e-3)),)


def finetune(dev, mods, smi, configs):
    """Phase 9: ``encoder-small`` at its full size (4 layers, d 256, vocab
    1024, fp32), 4 classes, batch 32 x 256, driven through
    ``methods.get(...).make_inner_step(cfg, tcfg, loss_fn=...)`` as the
    reference's fine-tuning table drives it: ``lowrank_lr`` under the
    Gaussian, Stiefel and coordinate samplers and ``adamw`` backprop, 200
    steps each.  Logs the accuracy before and after (8 batches of
    ``classification_batch(99, i)``), ms/step, the peak and the SIMT
    launches.  Every ``lowrank_lr`` peak must lie below ``adamw``'s (the
    paper's Table 2 ordering), and ``adamw``'s accuracy above chance by
    six binomial standard deviations.  Returns the launches by JSON row
    key."""
    from repro_torch import methods
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.models import encoder_cls
    from repro_torch.optim import subspace
    from repro_torch.train.loss import cls_accuracy, cls_ce
    lf, lu = mods["lf"], mods["lu"]
    cfg = configs.get_config(FT_ARCH)
    log(f"[finetune] {cfg.name} layers={cfg.num_layers} d_model="
        f"{cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype="
        f"{cfg.dtype}, {FT_CLASSES} classes, batch {FT_BATCH}x{FT_SEQ}, "
        f"{FT_STEPS} steps, rank {FT_RANK}")

    def loss_fn(packed, batch):
        return cls_ce(encoder_cls.forward(packed, batch["tokens"], cfg),
                      batch["labels"])

    @torch.no_grad()
    def accuracy(params):
        p = subspace.params_of(params)
        return sum(cls_accuracy(encoder_cls.forward(
            p, b["tokens"], cfg), b["labels"]).item()
            for b in (classification_batch(
                99, i, batch=FT_BATCH, seq_len=FT_SEQ,
                vocab=cfg.vocab_size, n_classes=FT_CLASSES, device=dev)
                for i in range(8))) / 8

    counts, peaks, accs = {}, {}, {}
    for tag, fields in FT_RUNS:
        tcfg = configs.TrainConfig(**FT_COMMON, **fields)
        method = methods.get(tcfg.optimizer)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        params, state = method.init(
            encoder_cls.init_params(cfg, FT_CLASSES, seed=0, device=dev),
            tcfg, gen)
        inner = method.make_inner_step(cfg, tcfg, loss_fn=loss_fn)
        outer = method.make_outer_step(cfg, tcfg)
        acc0 = accuracy(params)
        batches = [classification_batch(0, i, batch=FT_BATCH,
                                         seq_len=FT_SEQ,
                                         vocab=cfg.vocab_size,
                                         n_classes=FT_CLASSES, device=dev)
                   for i in range(FT_STEPS)]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        for mod in mods["counters"]:
            mod.reset_launches()
        t0 = time.perf_counter()
        losses = []
        for i in range(FT_STEPS):
            if outer is not None and i and i % tcfg.lazy_k == 0:
                params, state = outer(params, state)
            params, state, metrics = inner(params, state, batches[i])
            losses.append(metrics["loss"])
        if outer is not None:       # merge what the last cycle learned
            params, state = outer(params, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = torch.stack(losses).tolist()
        acc = accuracy(params)
        f3_f = lf.launches(route="tf32x3")
        ew_m = lu.launches("lowrank_merge", "ew")
        simt_f = sum(n for (_, rt, K, N), n in lf.LAUNCHES.items()
                     if rt == "simt" and (K, N) in ENC_SHAPES)
        simt_m = sum(n for (k, rt, sh), n in lu.LAUNCHES.items()
                     if k == "lowrank_merge" and rt == "simt"
                     and sh in ENC_MERGE_SHAPES)
        log(f"[finetune] {tag}: accuracy {acc0:.3f} -> {acc:.3f}, loss "
            f"{losses[0]:.4f} -> mean of the last 10 "
            f"{sum(losses[-10:]) / 10:.4f}, {1e3 * wall / FT_STEPS:.2f} "
            f"ms/step, peak {peak:.3f} GiB allocated ({held:.3f} when the "
            f"run started) on {smi}; launches by route: forward "
            f"tf32x3={f3_f} simt={simt_f} at the encoder shapes, merge "
            f"ew={ew_m} simt={simt_m}, tensor-core "
            f"{lf.launches(route='tc') + lu.launches(route='tc')}")
        if not all(x == x and abs(x) < float("inf") for x in losses):
            raise SystemExit(f"[finetune] {tag}: a non-finite loss")
        if tcfg.optimizer == "lowrank_lr":
            if not (f3_f and ew_m) or simt_f or simt_m:
                raise SystemExit(
                    f"[finetune] {tag}: the r = 4 forward and merge must "
                    f"all take the small-rank routes (tf32x3 {f3_f}, ew "
                    f"{ew_m}; simt forward {simt_f}, merge {simt_m})")
            for K, N in ENC_SHAPES:
                key = ("lowrank_forward[shared] r=4", (FT_M, K, N))
                counts[key] = counts.get(key, 0) + shape_launches(
                    lf.LAUNCHES, "shared", K, N)
            for shape in ENC_MERGE_SHAPES:
                key = ("lowrank_merge r=4", shape)
                counts[key] = counts.get(key, 0) + update_launches(
                    lu, "lowrank_merge", shape)
        peaks[tag], accs[tag] = peak, acc
        del params, state, inner, outer, batches
        torch.cuda.empty_cache()
    chance = 1.0 / FT_CLASSES
    floor = chance + 6 * (chance * (1 - chance) / (8 * FT_BATCH)) ** 0.5
    log(f"[finetune] peak GiB: " + ", ".join(
        f"{t} {p:.3f}" for t, p in peaks.items()) + f"; adamw accuracy "
        f"{accs['adamw']:.3f} (must exceed {floor:.3f})")
    if not all(p < peaks["adamw"] for t, p in peaks.items()
               if t != "adamw"):
        raise SystemExit("[finetune] a lowrank_lr peak is not below "
                         "adamw's")
    if not accs["adamw"] > floor:
        raise SystemExit("[finetune] adamw's accuracy is not above chance")
    return counts


def compare_encoder_kernels(mods, dev):
    """Phase 9b: the forward (shared B) and the merge at the encoder's
    shapes, fp32, r = 4, against their plain versions: the forward
    (``"tf32x3"``: 3xTF32 ``mma.sync``, p formed in the tile, one launch)
    within 1e-5 of max|y| (3xTF32 products and fp32 sums in another
    order), the merge (``"ew"``: an elementwise pass) within 1e-6 of
    max|W'|.  Each launch must take its small-rank route.  Kernel and
    library call (``x @ w + (x @ v) @ b.T``; ``torch.baddbmm``) are timed
    queued (the stream held while the host queues the calls) and eager.
    The forward's bound: bytes (each input read once, y written once) or
    the multiply-adds as three TF32 products each at the TF32 peak; the
    fp32 SIMT bound (fp32 FMAs at 67 TFLOP/s) beside it.  The merge's:
    bytes (W read and written, V and B read) or its FMAs at the fp32
    peak."""
    ref, lf, lu = mods["ref"], mods["lf"], mods["lu"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = []

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    M, r = FT_M, FT_RANK
    for (K, N), leaves in ENC_SHAPES.items():
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        v, b = randn(K, r, scale=r ** -0.5), randn(N, r, scale=0.02)
        lf.reset_launches()
        y = lf.lowrank_forward(x, w, v, b)
        torch.cuda.synchronize()
        path = launch_path(lf)
        if path != "tf32x3":
            raise SystemExit(f"the fp32 r = 4 forward took {path}")
        err = _agree(f"forward r=4 K={K} N={N}", y,
                     ref.lowrank_forward(x, w, v, b), 1e-5)
        nbytes = 4 * (M * K + K * N + K * r + N * r + M * N)
        ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
        bms, by = bound_of(nbytes, 3 * ops, TF32_FLOP_PER_S)
        simt_bms, simt_by = bound_of(nbytes, ops, FP32_FLOP_PER_S)

        def kernel():
            return lf.lowrank_forward(x, w, v, b)

        def library():
            return x @ w + (x @ v) @ b.T
        row = dict(kernel="lowrank_forward[shared] r=4", shape=(M, K, N),
                   leaves=leaves, path=path, max_abs_err=err,
                   ms=queued_ms(kernel), eager_ms=time_ms(kernel, iters=50),
                   plain_ms=time_auto(lambda: ref.lowrank_forward(x, w, v,
                                                                  b)),
                   library_ms=queued_ms(library),
                   library_eager_ms=time_ms(library, iters=50),
                   bound_ms=bms, bound_by=by, fp32_simt_bound_ms=simt_bms)
        rows.append(row)
        log(f"[kernel] lowrank_forward[shared] fp32 r=4 ({M}, {K}, {N}) "
            f"({leaves}) route={path} max_abs_err={err:.4g} "
            f"(tol 1e-5*max|y|) ms={row['ms']:.4f} [queued; eager "
            f"{row['eager_ms']:.4f}] plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} [queued; eager "
            f"{row['library_eager_ms']:.4f}] bound_ms={bms:.4f} ({by}, "
            f"3xTF32; fp32 SIMT {simt_bms:.4f}, {simt_by}); kernel/library "
            f"queued {row['ms'] / row['library_ms']:.3f}")
        del x, w, v, b, y
    for shape, leaves in ENC_MERGE_SHAPES.items():
        lead, (K, N) = shape[:-2], shape[-2:]
        w = randn(*shape, scale=K ** -0.5)
        v = randn(*lead, K, r, scale=r ** -0.5)
        b = randn(*lead, N, r, scale=0.02)
        lu.reset_launches()
        got = lu.lowrank_merge(w, v, b)
        torch.cuda.synchronize()
        path = launch_path(lu, at=1)
        if path != "ew":
            raise SystemExit(f"the fp32 r = 4 merge took {path}")
        err = _agree(f"merge r=4 {shape}", got, ref.lowrank_merge(w, v, b),
                     1e-6)
        items = w.numel() // (K * N)
        bms, by = bound_of(4 * (2 * K * N + K * r + N * r) * items,
                           2 * K * N * r * items, FP32_FLOP_PER_S)
        w3, v3 = w.reshape(-1, K, N), v.reshape(-1, K, r)
        b3t = b.reshape(-1, N, r).transpose(1, 2)
        row = dict(kernel="lowrank_merge r=4", shape=shape, leaves=leaves,
                   path=path, max_abs_err=err,
                   ms=queued_ms(lambda: lu.lowrank_merge(w, v, b, out=got)),
                   plain_ms=queued_ms(lambda: ref.lowrank_merge(w, v, b)),
                   library_ms=queued_ms(lambda: torch.baddbmm(w3, v3, b3t)),
                   bound_ms=bms, bound_by=by,
                   eager_ms=time_ms(lambda: lu.lowrank_merge(w, v, b,
                                                             out=got),
                                    iters=50))
        rows.append(row)
        log(f"[kernel] lowrank_merge fp32 r=4 {shape} ({leaves}) route="
            f"{path} max_abs_err={err:.4g} (tol 1e-6*max|W'|) ms="
            f"{row['ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms="
            f"{row['library_ms']:.4f} bound_ms={bms:.4f} ({by}) [queued; "
            f"eager {row['eager_ms']:.4f} ms/call]; kernel/library "
            f"{row['ms'] / row['library_ms']:.3f}")
        del w, v, b, got, w3, v3, b3t
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 10: checkpoints and resilience
# ---------------------------------------------------------------------------

# the configurations [resume] and [guard] run at llama-100m's full width
# and depth: 6a (fp32 state) and 6b (int8 moments, bf16 B masters)
RESIL_RUNS = (("6a", dict(lazy_k=4, lr=3e-3)),
              ("6b", dict(optimizer="lowrank_adam", state_dtype="int8",
                          master_dtype="bfloat16", lazy_k=4, lr=3e-3)))
RESUME_STEPS, RESUME_EVERY, RESUME_KILL = 8, 4, 4   # SIGTERM at step 4
GUARD_NAN, GUARD_SPIKE = 3, 6   # the guard steps poisoned (of 8)
GUARD_WARMUP = 3          # tcfg.spike_warmup: armed by the spike step
ROLLBACK_NAN = (3, 4, 5)  # three skips in a row: one rollback


def resil_trainer(dev, cfg, tcfg, workdir=None, batch=None, seq=None,
                  **kw):
    from repro_torch.data.synthetic import StatelessLoader
    from repro_torch.train.trainer import Trainer
    loader = StatelessLoader("lm", 0, device=dev, batch=batch or TRAIN_BATCH,
                             seq_len=seq or TRAIN_SEQ, vocab=cfg.vocab_size)
    return Trainer(cfg, tcfg, loader, workdir, device=dev, **kw)


def snapshot_state(tr):
    """A device copy of every tensor of the trainer's params and state,
    and its generator's state: what a checkpoint would hold."""
    from repro_torch.train import checkpoint as ckpt
    tree = {"params": tr.params, "opt": tr.opt_state}
    return [t.clone() for t in ckpt.tensors(tree)], \
        tr.opt_state.gen.get_state()


def differ(tr, snap) -> list:
    """Names of the records of ``tr`` that differ from ``snap`` bit for
    bit (``opt||gen`` for the generator)."""
    from repro_torch.train import checkpoint as ckpt
    tree = {"params": tr.params, "opt": tr.opt_state}
    tensors, gen = snap
    idx = [i for i, (a, b) in enumerate(zip(ckpt.tensors(tree), tensors))
           if not torch.equal(a, b)]
    names = []
    if idx:
        keys = [k for k in ckpt.records(tree)
                if not k.endswith(("||key", "||gen"))]
        names = [keys[i] for i in idx]
    if not torch.equal(tr.opt_state.gen.get_state(), gen):
        names.append("opt||gen")
    return names


def reset_counters(mods):
    for mod in mods["counters"] + (mods["sc"],):
        mod.reset_launches()


def free():
    gc.collect()
    torch.cuda.empty_cache()


def resume_and_guard(dev, mods, smi, configs, tag, fields, workdir):
    """[guard] and [resume] of one configuration.  The run uninterrupted
    twice, guard on and off (timed; the last step profiled): bit for bit
    equal shows the card deterministic and the guard transparent at
    once.  The run stopped by a chaos SIGTERM after a checkpoint and
    resumed in a fresh Trainer must equal it wherever the two agree,
    generator included.  A NaN step and a loss-spike step (the detector
    armed after ``GUARD_WARMUP`` accepted steps) leave every record
    unchanged and the run goes on with finite losses, and one guarded
    inner step runs under ``set_sync_debug_mode("error")``.  Returns the
    training kernels' launches."""
    from repro_torch.train import chaos
    cfg, tcfg = train_config(configs, warmup_steps=2, total_steps=1000,
                             spike_warmup=GUARD_WARMUP, **fields)
    reset_counters(mods)
    runs = {}
    for on in (True, False):
        tr = resil_trainer(dev, cfg, dataclasses.replace(tcfg,
                                                         health_guard=on))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rep = tr.run(RESUME_STEPS - 1)
        _, device = profile_train(tr, steps=1, top=0, tag=f"profile guard "
                                  f"{tag} {'on' if on else 'off'}")
        inner = [t for i, t in enumerate(rep.step_times) if i % tcfg.lazy_k]
        # the guard-on run's device copy stays held through the other's
        held = 0 if on else sum(t.nbytes for t in base[0])
        runs[on] = dict(losses=rep.losses, device=device,
                        ms=1e3 * sum(inner[1:]) / len(inner[1:]),
                        peak=(torch.cuda.max_memory_allocated() - held)
                        / 2 ** 30)
        if on:
            base = snapshot_state(tr)
        else:
            off = set(differ(tr, base))
        del tr
        free()
    total = len(base[0]) + 1
    on, no = runs[True], runs[False]
    log(f"[guard {tag}] guard on: {on['ms']:.1f} ms/step (steps 3, 4, 6, "
        f"7: no merge, no first step), device {on['device']:.1f} ms/step, "
        f"peak "
        f"{on['peak']:.2f} GiB; guard off: {no['ms']:.1f} ms/step, device "
        f"{no['device']:.1f} ms/step, peak {no['peak']:.2f} GiB; on {smi}")
    log(f"[resume {tag}] the two uninterrupted runs of {RESUME_STEPS} steps "
        f"(guard on, off): {total - len(off)}/{total} records bit-identical, "
        f"losses " + ("equal" if on["losses"] == no["losses"] else
                      f"differ: {on['losses']} vs {no['losses']}")
        + ("" if not off else f"; records that differ: {sorted(off)}"))
    with chaos.injected(chaos.ChaosHook(sigterm_at_step=RESUME_KILL)):
        tr = resil_trainer(dev, cfg, tcfg, workdir,
                           checkpoint_every=RESUME_EVERY)
        rep1 = tr.run(RESUME_STEPS)
    stop = tr.step
    del tr
    free()
    if not rep1.preempted or stop != RESUME_KILL + 1:
        raise SystemExit(f"resume {tag}: the SIGTERM at step {RESUME_KILL} "
                         f"did not drain the run (preempted "
                         f"{rep1.preempted}, stopped at step {stop})")
    mb = (Path(workdir) / f"step_{stop:08d}" / "arrays.npz").stat(
    ).st_size / 1e6
    tr = resil_trainer(dev, cfg, tcfg, workdir)
    rep2 = tr.run(RESUME_STEPS - stop)
    bad = [k for k in differ(tr, base) if k not in off]
    del tr
    free()
    log(f"[resume {tag}] SIGTERM at step {RESUME_KILL}: {rep1.steps_run} "
        f"steps run, checkpoints at steps {RESUME_EVERY} and {stop} "
        f"(preempted); archive {mb:.1f} MB; save " + ", ".join(
            f"{t:.2f}" for t in rep1.save_times)
        + f" s (fsync included); a fresh Trainer resumed from step "
        f"{rep2.resumed_from} in {rep2.resume_seconds:.2f} s; on {smi}")
    agree = total - len(off)
    log(f"[resume {tag}] resumed == uninterrupted: {agree - len(bad)}/"
        f"{agree} of the records the uninterrupted runs agree on")
    if rep2.resumed_from != stop or bad:
        raise SystemExit(f"resume {tag}: the resumed run differs from the "
                         f"uninterrupted one at {bad[:8]}")
    hook = chaos.ChaosHook(grad_nan_steps=(GUARD_NAN,),
                           spike_scale_steps=(GUARD_SPIKE,))
    with chaos.injected(hook):
        tr = resil_trainer(dev, cfg, tcfg)
        losses = []
        for s in range(RESUME_STEPS):
            before = snapshot_state(tr) if s in (GUARD_NAN, GUARD_SPIKE) \
                else None
            rep = tr.run(1)
            if before is None:
                losses += rep.losses
                if rep.skipped_steps:
                    raise SystemExit(f"guard {tag}: healthy step {s} "
                                     f"skipped")
                continue
            changed = differ(tr, before)
            what = "NaN" if s == GUARD_NAN else "spike"
            log(f"[guard {tag}] step {s} ({what}): skipped "
                f"{rep.skipped_steps == 1}, loss read "
                f"{rep.losses[0]:.4g}, records changed {len(changed)}")
            if rep.skipped_steps != 1 or changed:
                raise SystemExit(f"guard {tag}: step {s} not skipped bit-"
                                 f"identically: {changed[:8]}")
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"guard {tag}: non-finite accepted losses {losses}")
    log(f"[guard {tag}] accepted losses " + ", ".join(
        f"{x:.4f}" for x in losses) + f"; skips {int(tr.health.total_skips)}")
    counts = train_launches(mods)
    # one guarded inner step, the trainer's fetch left out, syncs nothing
    batch = tr.loader(tr.step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen_state = tr.opt_state.gen.get_state()
        _, _, h, met = tr._inner(tr.params, tr.opt_state, tr.health, batch,
                                 tr.guard_steps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tr.opt_state.gen.set_state(gen_state)
    log(f"[guard {tag}] one guarded inner step under set_sync_debug_mode"
        f"(\"error\"): no host sync; health vector "
        f"{[round(x, 4) for x in met['health'].tolist()]}")
    del tr, h, met, base
    free()
    return counts


def rollback_run(dev, mods, smi, configs, workdir):
    """[rollback]: three NaN steps in a row roll back once: restore the
    last checkpoint, halve the LR, reseed (an outer merge, which must
    launch the merge kernel); the run goes on with finite losses."""
    from repro_torch.train import chaos
    tag = "rollback"
    cfg, tcfg = train_config(configs, warmup_steps=2, total_steps=1000,
                             lazy_k=4, lr=3e-3)
    reset_counters(mods)
    lu = mods["lu"]
    times, merges = [], []
    with chaos.injected(chaos.ChaosHook(grad_nan_steps=ROLLBACK_NAN)):
        tr = resil_trainer(dev, cfg, tcfg, workdir, checkpoint_every=2)
        real = tr._rollback

        def timed(report):
            n0 = lu.launches("lowrank_merge")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(report)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            merges.append(lu.launches("lowrank_merge") - n0)

        tr._rollback = timed
        rep = tr.run(8)
    log(f"[{tag}] NaN at guard steps {list(ROLLBACK_NAN)}: {rep.skipped_steps}"
        f" skipped, {rep.rollbacks} rollback in " + ", ".join(
            f"{t:.2f}" for t in times)
        + f" s (restore, reseed with {merges} merge launches, LR "
        f"{tcfg.lr} -> {tr.tcfg.lr}); then {rep.steps_run} steps, losses "
        + ", ".join(f"{x:.4f}" for x in rep.losses[-4:]) + f"; on {smi}")
    if rep.rollbacks != 1 or not merges or not merges[0] or \
            tr.tcfg.lr != tcfg.lr * tcfg.rollback_backoff or \
            not all(map(math.isfinite, rep.losses[-4:])):
        raise SystemExit(f"{tag}: the rollback did not restore, reseed "
                         f"and go on")
    del tr
    free()
    return train_launches(mods)


def walkback(dev, configs, workdir, fields):
    """[walkback]: one flipped bit in the newest archive; the resume
    quarantines it as ``step_*.corrupt`` and lands on the step before."""
    from repro_torch.train import chaos
    from repro_torch.train import checkpoint as ckpt
    cfg, tcfg = train_config(configs, warmup_steps=2, total_steps=1000,
                             **fields)
    steps = ckpt.all_steps(workdir)
    npz = Path(workdir) / f"step_{steps[-1]:08d}" / "arrays.npz"
    chaos.flip_bit(str(npz), npz.stat().st_size // 2, 3)
    tr = resil_trainer(dev, cfg, tcfg, workdir)
    rep = tr.run(0)
    corrupt = (Path(workdir) / f"step_{steps[-1]:08d}.corrupt").is_dir()
    log(f"[walkback] a bit flipped in step {steps[-1]}'s archive: resumed "
        f"from step {rep.resumed_from} in {rep.resume_seconds:.2f} s, step "
        f"{steps[-1]} quarantined {corrupt}")
    if rep.resumed_from != steps[-2] or not corrupt:
        raise SystemExit("walkback: the resume did not quarantine the "
                         "damaged step and land on the one before")
    del tr
    free()


def serve_trained_tenant(dev, mods, smi, configs, workdir, root):
    """[serve trained tenant]: the [resume] run's llama-100m checkpoint
    loaded by ``load_tenant`` into a llama-100m store and served; then a
    2-layer fp32 cut trained 2 steps, loaded the same way, lazy ==
    merged within phase 5's limit."""
    lf, lm, serve_mod = mods["lf"], mods["lm"], mods["serve"]
    tag = "serve trained tenant"
    cfg = configs.get_config(TRAIN_ARCH)
    params = lm.init_params(cfg, seed=0, device=dev)
    store = serve_mod.AdapterStore(cfg, configs.TrainConfig(rank=RANK), 2,
                                   device=dev)
    t0 = time.perf_counter()
    store.load_tenant("trained", workdir)
    load_s = time.perf_counter() - t0
    eng = serve_mod.Engine(params, cfg, adapters=store,
                           engine_cfg=serve_mod.EngineConfig(
                               page_size=16, max_batch=4, max_len=96,
                               max_out=16), device=dev)
    gen = torch.Generator().manual_seed(5)
    reset_counters(mods)
    for i in range(4):
        eng.submit(serve_mod.Request(
            f"r{i}", torch.randint(0, cfg.vocab_size, (64,),
                                   generator=gen).numpy(), 16,
            tenant="trained"))
    out = eng.run()
    bad = [r for r, v in out.items() if len(v) != 16 or v.min() < 0
           or v.max() >= cfg.vocab_size]
    log(f"[{tag}] {TRAIN_ARCH} tenant loaded in {load_s:.2f} s; 4 requests "
        f"x 16 tokens: launches shared={lf.launches('shared')} batched="
        f"{lf.launches('batched')}; r0 {out['r0'][:8].tolist()}")
    if len(out) != 4 or bad or eng.errors or not lf.launches("shared") \
            or not lf.launches("batched"):
        raise SystemExit(f"{tag}: serving the trained tenant failed")
    del eng, store, params
    free()
    cfg2, tcfg2 = train_config(configs, layers=2, dtype="float32",
                               compute_dtype="float32", warmup_steps=2,
                               total_steps=1000, lazy_k=4, lr=3e-3)
    wd2 = str(Path(root) / "cut")
    resil_trainer(dev, cfg2, tcfg2, wd2, batch=2, seq=64,
                  checkpoint_every=2).run(2)
    store2 = serve_mod.AdapterStore(cfg2, configs.TrainConfig(rank=RANK), 1,
                                    device=dev)
    store2.load_tenant("trained", wd2)
    lazy_equals_merged(dev, mods, TRAIN_ARCH, store=store2,
                       tenant="trained", tag=f"{tag} lazy==merged")


def serve_trained_zamba2(dev, mods, configs):
    """[serve trained tenant zamba2 lazy==merged]: zamba2-7b's 3-layer
    fp32 cut trained 2 steps on the card, its checkpoint loaded by
    ``load_tenant`` into a store of that cut, lazy == merged within
    phase 5's limit."""
    import tempfile
    serve_mod = mods["serve"]
    cfg = cut_config(configs, "zamba2-7b")
    tcfg = configs.TrainConfig(rank=RANK, compute_dtype="float32",
                               warmup_steps=2, total_steps=1000, lazy_k=4,
                               lr=1e-3)
    with tempfile.TemporaryDirectory() as wd:
        resil_trainer(dev, cfg, tcfg, wd, batch=1, seq=256,
                      checkpoint_every=2).run(2)
        store = serve_mod.AdapterStore(cfg, configs.TrainConfig(rank=RANK),
                                       1, device=dev)
        store.load_tenant("trained", wd)
    lazy_equals_merged(dev, mods, "zamba2-7b", S=256, store=store,
                       tenant="trained",
                       tag="serve trained tenant zamba2 lazy==merged")
    free()


SNAP_TOKENS = 16          # new tokens per request
SNAP_AT, SNAP_KILL = 3, 6  # engine steps of the snapshot and the SIGTERM


def serve_snapshot(dev, mods, smi, arch, root):
    """[serve snapshot]: 6 requests over 2 tenants (4 slots: 2 queued).
    An engine snapshots at step ``SNAP_AT``, goes on, and a chaos SIGTERM
    at step ``SNAP_KILL`` drains it into a second snapshot; each restores
    (``Engine.restore``) into a fresh engine and store that finishes with
    the tokens of an uninterrupted engine."""
    import numpy as np
    from repro_torch.train import chaos
    lm, configs, serve_mod = mods["lm"], mods["configs"], mods["serve"]
    tag = f"serve snapshot {arch.split('-')[0]}"
    cfg = configs.get_config(arch)
    tcfg = configs.TrainConfig(rank=RANK)
    params = lm.init_params(cfg, seed=0, device=dev)
    ecfg = serve_mod.EngineConfig(page_size=16, max_batch=4, max_len=160,
                                  max_out=SNAP_TOKENS)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 128) for _ in range(6)]

    def engine(**kw):
        eng = serve_mod.Engine(params, cfg, adapters=make_store(
            cfg, tcfg, 2, dev, serve_mod.AdapterStore), engine_cfg=ecfg,
            device=dev, **kw)
        for i, p in enumerate(prompts):
            eng.submit(serve_mod.Request(f"r{i}", p, SNAP_TOKENS,
                                         tenant=f"tenant{i % 2}"))
        return eng

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def size_mb(wd):
        return sum(f.stat().st_size for f in Path(wd).rglob("*")
                   if f.is_file()) / 1e6

    base = engine().run()
    free()
    wd, wd2 = (str(Path(root) / arch / d) for d in ("snap", "drain"))
    eng = engine(snapshot_dir=wd2)
    for _ in range(SNAP_AT):
        eng.step()
    queued = len(eng._queue)
    _, snap_s = timed(lambda: eng.snapshot(wd))
    with chaos.injected(chaos.ChaosHook(sigterm_at_step=SNAP_KILL)):
        out1 = eng.run()
    del eng
    free()
    for name, d, done in (("snapshot", wd, {}), ("drain", wd2, out1)):
        eng, rest_s = timed(lambda: serve_mod.Engine.restore(
            d, params, cfg, adapters=serve_mod.AdapterStore(
                cfg, tcfg, 2, device=dev), device=dev))
        step = eng.step_count
        reset_counters(mods)
        merged = dict(done)
        merged.update(eng.run())
        ssd = mods["sc"].launches()
        del eng
        free()
        same = set(merged) == set(base) and all(
            np.array_equal(merged[r], base[r]) for r in base)
        log(f"[{tag}] {arch} {name} at engine step {step}"
            + (f" ({queued} queued), written in {snap_s:.2f} s"
               if name == "snapshot" else
               f" (SIGTERM; {len(done)} finished before it)")
            + f": {size_mb(d):.1f} MB, restored in {rest_s:.2f} s; the "
            f"tokens == an uninterrupted engine's {same}"
            + (f"; ssd_intra_chunk launches after the restore {ssd}"
               if cfg.family == "ssm" and name == "snapshot" else "")
            + f"; on {smi}")
        if not same or (cfg.family == "ssm" and name == "snapshot"
                        and not ssd):
            raise SystemExit(f"{tag}: the engine restored from the {name} "
                             f"gave other tokens")
    del params
    free()


def resilience(dev, mods, smi, configs):
    """Phase 10; returns the training kernels' launches of its runs."""
    import tempfile
    counts = {}

    def add(more):
        for key, n in more.items():
            counts[key] = counts.get(key, 0) + n

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        for tag, fields in RESIL_RUNS:
            wd = str(Path(root) / f"resume {tag}")
            add(resume_and_guard(dev, mods, smi, configs, tag, fields,
                                 wd))
            if tag == "6a":
                serve_trained_tenant(dev, mods, smi, configs, wd, root)
                walkback(dev, configs, wd, fields)
            shutil.rmtree(wd)
        add(rollback_run(dev, mods, smi, configs,
                         str(Path(root) / "rollback")))
        for arch in ("qwen2-7b", "mamba2-780m"):
            serve_snapshot(dev, mods, smi, arch, root)
    log(f"[resilience] phase 10 in {time.perf_counter() - t0:.0f} s")
    return counts


def gemm_rows(src):
    """``python3 chip_smoke.py --gemm-rows SRC``: the forward (both forms)
    and the backward of the package under ``SRC`` (a checkout's ``src``)
    at the llama-100m training shapes, timed eager (``time_auto``) and
    queued, one JSON line a row and nothing else, so that two trees can
    be timed in turns on one card in one call."""
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import lowrank_backward as lb
    from repro_torch.kernels import lowrank_forward as lf
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
    M, r = TRAIN_M, RANK
    for (K, N), leaves in TRAIN_SHAPES.items():
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        v, b = randn(K, r, scale=r ** -0.5), randn(N, r, scale=0.02)
        dy = randn(M, N, scale=1e-2)
        _, p = lf.lowrank_forward(x, w, v, b, return_p=True)
        for kernel, fn in (
                ("lowrank_forward[p]",
                 lambda: lf.lowrank_forward(x, w, v, b, return_p=True)),
                ("lowrank_forward[shared]",
                 lambda: lf.lowrank_forward(x, w, v, b)),
                ("lowrank_backward",
                 lambda: lb.lowrank_backward(dy, w, v, b, p))):
            row = {"src": src, "kernel": kernel, "shape": [M, K, N],
                   "leaves": leaves, "ms": time_auto(fn),
                   "queued_ms": queued_ms(fn)}
            print(json.dumps(row), flush=True)
        del x, w, v, b, dy, p
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--gemm-rows"]:
        gemm_rows(sys.argv[2])
        return
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import configs
    from repro_torch.kernels import _build, dispatch, ref
    from repro_torch.kernels import lowrank_backward as lb
    from repro_torch.kernels import lowrank_forward as lf
    from repro_torch.kernels import lowrank_update as lu
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import subspace_adam as sa
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch import serve as serve_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    sources = ("lowrank_forward", "lowrank_backward", "lowrank_merge",
               "subspace_adam", "subspace_q8", "lowrank_project", "ssd_chunk",
               "ssd_chunk_bwd")
    built = _build.build_all(sources, force=True,
                             checked=("ssd_chunk", "ssd_chunk_bwd"))
    log(f"[build] {len(built)} builds ({len(sources)} sources and the "
        f"checked builds of the SSD kernels) in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in built.items():
        log(f"[build] {name}: nvcc {rep['seconds']:.1f} s")
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in ("lowrank_forward", "lowrank_backward", "lowrank_merge",
                 "lowrank_project"):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(built[name]["path"])], capture_output=True,
                              text=True, check=True).stdout
        n = sum("HGMMA" in line for line in sass.splitlines())
        log(f"[build] lib{name}: {n} HGMMA (wgmma) instructions in its SASS")
        if n == 0:
            raise SystemExit(f"lib{name} holds no tensor-core instruction")
    # the SSD kernels and the fp32 small-rank forward run mma.sync (TF32),
    # which is HMMA in the SASS
    for name in ("ssd_chunk", "ssd_chunk_bwd", "lowrank_forward"):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(built[name]["path"])],
                              capture_output=True, text=True,
                              check=True).stdout
        n = sum("HMMA" in line for line in sass.splitlines())
        log(f"[build] lib{name}: {n} HMMA (mma.sync) instructions in its "
            f"SASS")
        if n == 0:
            raise SystemExit(f"lib{name} holds no tensor-core instruction")

    mods = dict(lf=lf, lb=lb, lu=lu, sa=sa, sc=sc, ref=ref,
                dispatch=dispatch, lm=lm, moe=moe_mod, configs=configs,
                serve=serve_mod, counters=(lf, lb, lu, sa))
    if sys.argv[1:2] == ["--zamba2-study"]:
        zamba2_study(dev, mods, smi, configs)
        return
    if sys.argv[1:2] == ["--qwen3moe-study"]:
        qwen3moe_study(dev, mods, smi, configs)
        return
    def mark(label):
        log(f"[time] {label} done at {time.perf_counter() - t0:.0f} s")
    rows = compare_kernels(lf, ref, dev)
    mamba_rows = compare_kernels(lf, ref, dev, MAMBA_SHAPES)
    zamba_rows = compare_kernels(lf, ref, dev, ZAMBA_SHAPES)
    nemo_rows = compare_kernels(lf, ref, dev, NEMO_SHAPES)
    qwen3_rows = compare_kernels(lf, ref, dev, QWEN3_SHAPES)
    ds_rows = compare_kernels(lf, ref, dev, DEEPSEEK_SHAPES,
                              DEEPSEEK_PREFILL_ONLY)
    split_determinism(mods, dev)
    ssd_rows = compare_ssd_kernel(mods, dev)
    zamba_ssd_rows = compare_ssd_kernel(mods, dev, ZAMBA_SSD_SHAPES)
    ssd_train_row = compare_ssd_kernel(
        mods, dev, {SSD_TRAIN_SHAPE: "training, batch 16 x 1024"})[0]
    ssd_bwd_row = compare_ssd_bwd_kernel(mods, dev)
    zamba_train_ssd_row = compare_ssd_kernel(
        mods, dev, {ZAMBA_TRAIN_SSD_SHAPE: "training, batch 8 x 1024"})[0]
    zamba_ssd_bwd_row = compare_ssd_bwd_kernel(mods, dev,
                                               ZAMBA_TRAIN_SSD_SHAPE)
    ssd_checked(mods, dev)
    train_rows = compare_train_kernels(mods, dev)
    state_rows = compare_state_kernels(mods, dev)
    project_rows = compare_project_kernel(mods, dev)
    q3_gemm_rows = compare_train_kernels(mods, dev, QWEN3_TRAIN_SHAPES, {},
                                         shared=False)
    q3_update_rows = compare_moe_update_kernels(mods, dev)
    mark("[kernel] rows")
    counts, _ = serve(dev, mods, smi)
    lazy_equals_merged(dev, mods)
    bf16_decode_without_sync(dev, mods)
    mamba_counts, ssd_counts = serve(dev, mods, smi, "mamba2-780m")
    lazy_equals_merged(dev, mods, "mamba2-780m", S=256)
    bf16_decode_without_sync(dev, mods, "mamba2-780m")
    serve_equals_plain(dev, mods)
    mark("qwen2-7b and mamba2-780m serving")
    zamba_counts, zamba_ssd_counts = serve(dev, mods, smi, "zamba2-7b")
    lazy_equals_merged(dev, mods, "zamba2-7b", S=256)
    serve_equals_plain(dev, mods, "zamba2-7b", tol=ZAMBA_PLAIN_TOL)
    serve_preempt(dev, mods, smi)
    sampled_decode(dev, mods, smi)
    mark("zamba2-7b serving and sampled decoding")
    nemo_counts, _ = serve(dev, mods, smi, "mistral-nemo-12b")
    mark("mistral-nemo-12b serving")
    qwen3_counts, _ = serve(dev, mods, smi, MOE)
    lazy_equals_merged(dev, mods, MOE, S=128)
    serve_equals_plain(dev, mods, MOE, S=128, tol=QWEN3_PLAIN_TOL)
    bf16_decode_without_sync(dev, mods, MOE)
    mark("qwen3-moe-30b-a3b serving")
    ds_counts, _ = serve(dev, mods, smi, DEEPSEEK)
    lazy_equals_merged(dev, mods, DEEPSEEK, S=128)
    serve_equals_plain(dev, mods, DEEPSEEK, S=128, tol=DEEPSEEK_PLAIN_TOL,
                       draw_on_card=True, seed=DEEPSEEK_PLAIN_SEED)
    bf16_decode_without_sync(dev, mods, DEEPSEEK)
    mark("deepseek-v2-236b serving")

    sampler_laws(dev, mods)
    cfg, tcfg = train_config(configs, lazy_k=4, lr=3e-3, warmup_steps=2,
                             total_steps=1000)
    tr, _ = train(dev, mods, smi, cfg, tcfg, TRAIN_BATCH, TRAIN_SEQ,
                  steps=14)
    peak_6a = torch.cuda.max_memory_allocated() / 2 ** 30
    train_counts = train_launches(mods)
    profile_train(tr, match=(PROFILE_KEYS["subspace_adam"], "tc::"))
    fp32_bytes = state_bytes(tr)
    del tr
    torch.cuda.empty_cache()
    state_counts = train_state_runs(dev, mods, smi, configs, fp32_bytes)
    train_counts.update(method_runs(dev, mods, smi, configs))
    # the new paths add to the launches of rows 1 (return_p), 2, 3 and 6
    for more in (sampler_runs(dev, mods, smi, configs),
                 accum_run(dev, mods, smi, configs, peak_6a)):
        for key, n in more.items():
            train_counts[key] = train_counts.get(key, 0) + n
    for label, fields, tol in PLAIN_RUNS:
        train_equals_plain(dev, mods, configs, label, fields, tol)
    train_equals_plain_dependent(dev, mods, configs)
    mark("llama-100m training")
    mamba_train_counts = train_mamba2(dev, mods, smi, configs)
    train_equals_plain(dev, mods, configs, "lowrank_adam fp32", (),
                       MAMBA_PLAIN_TOL, arch="mamba2-780m")
    mark("mamba2-780m training")
    zamba_train_counts = train_zamba2(dev, mods, smi, configs)
    train_equals_plain(dev, mods, configs, "lowrank_adam fp32", (),
                       ZAMBA_TRAIN_PLAIN_TOL, arch="zamba2-7b", batch=1)
    serve_trained_zamba2(dev, mods, configs)
    mark("zamba2-7b training")
    q3_train_counts, _ = train_qwen3moe(dev, mods, smi, configs)
    serve_trained_qwen3moe(dev, mods, configs,
                           train_equals_plain_replayed(dev, mods, configs))
    mark("qwen3-moe-30b-a3b training")
    enc_rows = compare_encoder_kernels(mods, dev)
    enc_counts = finetune(dev, mods, smi, configs)
    mark("encoder fine-tuning")
    for key, n in resilience(dev, mods, smi, configs).items():
        train_counts[key] = train_counts.get(key, 0) + n

    kernels = []
    for model, rws, cnt in (("", rows, counts),
                            ("mamba2-780m ", mamba_rows, mamba_counts),
                            ("zamba2-7b ", zamba_rows, zamba_counts),
                            ("mistral-nemo-12b ", nemo_rows, nemo_counts),
                            (f"{MOE} ", qwen3_rows, qwen3_counts),
                            (f"{DEEPSEEK} ", ds_rows, ds_counts)):
        for row in rws:
            kernels.append({
                "name": f"lowrank_forward[{row['form']} B] K={row['K']} "
                        f"N={row['N']} ({model}{row['leaves']})",
                "route": "cuda", "path": row["path"], "source": SOURCE,
                "replaces": REPLACES if row["form"] == "shared"
                else BATCH_REPLACES,
                "launches": shape_launches(cnt, row["form"], row["K"],
                                           row["N"]),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "plan": row["plan"],
                **({} if row["gemm_route_ms"] is None else
                   {"mainloop_route_ms": row["gemm_route_ms"]}),
                **({} if row["host_ms"] is None else
                   {"timing": "queued", "eager_ms": row["host_ms"]})})
    for model, row, cnt in (
            [("mamba2-780m", r, ssd_counts) for r in ssd_rows]
            + [("zamba2-7b", r, zamba_ssd_counts) for r in zamba_ssd_rows]):
        kernels.append({
            "name": f"ssd_intra_chunk [fp32, B/C head stride 0] "
                    f"{list(row['shape'])} ({model}, {row['tokens']})",
            "route": "cuda", "path": "tc", "source": SSD_SOURCE,
            "replaces": SSD_REPLACES,
            "launches": cnt.get(("ssd_intra_chunk", row["shape"]), 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "timing": "queued", "eager_ms": row["eager_ms"]})
    row = ssd_train_row
    kernels.append({
        "name": f"ssd_intra_chunk [fp32, B/C head stride 0] "
                f"{list(row['shape'])} (mamba2-780m {row['tokens']})",
        "route": "cuda", "path": "tc", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "launches": mamba_train_counts[("ssd_intra_chunk", row["shape"])],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "timing": "queued", "eager_ms": row["eager_ms"]})
    row = ssd_bwd_row
    kernels.append({
        "name": f"ssd_intra_chunk_bwd [fp32, one B/C group] "
                f"{list(row['shape'])} (mamba2-780m training, batch 16 x "
                f"1024)",
        "route": "cuda", "path": "tc", "source": SSD_BWD_SOURCE,
        "replaces": SSD_BWD_REPLACES,
        "launches": mamba_train_counts[("ssd_intra_chunk_bwd",
                                        row["shape"])],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "timing": "queued", "eager_ms": row["eager_ms"],
        "grids_ms": row["grids_ms"]})
    row = zamba_train_ssd_row
    kernels.append({
        "name": f"ssd_intra_chunk [fp32, B/C head stride 0] "
                f"{list(row['shape'])} (zamba2-7b {row['tokens']})",
        "route": "cuda", "path": "tc", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "launches": zamba_train_counts[("ssd_intra_chunk", row["shape"])],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "timing": "queued", "eager_ms": row["eager_ms"]})
    row = zamba_ssd_bwd_row
    kernels.append({
        "name": f"ssd_intra_chunk_bwd [fp32, one B/C group] "
                f"{list(row['shape'])} (zamba2-7b training, batch 8 x "
                f"1024)",
        "route": "cuda", "path": "tc", "source": SSD_BWD_SOURCE,
        "replaces": SSD_BWD_REPLACES,
        "launches": zamba_train_counts[("ssd_intra_chunk_bwd",
                                        row["shape"])],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "timing": "queued", "eager_ms": row["eager_ms"],
        "grids_ms": row["grids_ms"]})
    for row in train_rows:
        kernels.append({
            "name": f"{row['kernel']} {list(row['shape'])} "
                    f"({row['leaves']})",
            "route": "cuda", "path": row["path"],
            "source": TRAIN_SOURCES[row["kernel"]],
            "replaces": TRAIN_REPLACES[row["kernel"]],
            "launches": train_counts[(row["kernel"], row["shape"])],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_share": row["bound_ms"] / row["ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({} if row["plan"] is None else {"plan": row["plan"]}),
            **({} if row["queued"] is None else
               {"queued_ms": row["queued"][0],
                "library_queued_ms": row["queued"][1]}),
            **({} if row["eager_ms"] is None else
               {"timing": "queued", "eager_ms": row["eager_ms"]})})
    kernels.extend(qwen3_train_rows(q3_gemm_rows, q3_update_rows,
                                    q3_train_counts))
    # compressed state: one row per kernel and group shape, in the form the
    # training runs launch (the q8 updates on a bf16 b with rounding
    # bits); the q8 updates' fp32-b form, which no run launches, rides in
    # the same row under "fp32_b"
    by_key = {}
    for row in state_rows:
        key = (row["kernel"], row["shape"])
        if row["form"] == "fp32 b":
            by_key[key]["fp32_b"] = {k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "eager_ms")}
            continue
        by_key[key] = {
            "name": f"{row['kernel']} [{row['form']}] {list(row['shape'])} "
                    f"({row['leaves']})",
            "route": "cuda",
            "path": UPDATE_PATH if row["kernel"] == "subspace_lion"
            else "simt",
            "source": TRAIN_SOURCES[row["kernel"]],
            "replaces": TRAIN_REPLACES[row["kernel"]],
            "launches": state_counts.get(key, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "timing": "queued", "eager_ms": row["eager_ms"]}
    kernels.extend(by_key.values())
    for row in project_rows:
        kernels.append({
            "name": f"lowrank_project [fp32 G, bf16 V] "
                    f"{list(row['shape'])} ({row['leaves']})",
            "route": "cuda", "path": row["path"],
            "source": TRAIN_SOURCES["lowrank_project"],
            "replaces": TRAIN_REPLACES["lowrank_project"],
            "launches": train_counts[("lowrank_project", row["shape"])],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "timing": "queued", "eager_ms": row["eager_ms"],
            **({"splits_ms": row["splits_ms"]} if "splits_ms" in row
               else {})})
    for row in enc_rows:
        kernels.append({
            "name": f"{row['kernel'].split()[0]} [fp32, r=4] "
                    f"{list(row['shape'])} (encoder-small {row['leaves']})",
            "route": "cuda", "path": row["path"],
            "source": TRAIN_SOURCES[row["kernel"].split()[0]],
            "replaces": TRAIN_REPLACES[row["kernel"].split()[0]],
            "launches": enc_counts.get((row["kernel"], row["shape"]), 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "timing": "queued", "eager_ms": row["eager_ms"],
            **{k: row[k] for k in ("library_eager_ms", "fp32_simt_bound_ms")
               if k in row}})
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: "
                         f"{missing}")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
