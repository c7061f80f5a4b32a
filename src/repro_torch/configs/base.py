"""Model and serving configuration dataclasses.

A copy of ``repro.configs.base``: the whole of ``ModelConfig`` (with
``reduced()``), and the ``TrainConfig`` fields that serving and training
read.  The port keeps its own copy so that it never imports the JAX
package; ``tests/test_torch_isolation.py`` holds the two field by
field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config. One instance per assigned architecture."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False          # qwen3: per-head RMSNorm on q/k
    rope_theta: float = 1e6        # 0 -> no RoPE (whisper)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # routed-expert hidden width
    moe_dense_ff: int = 0          # width of the leading dense layers
    first_dense_layers: int = 0    # leading dense-MLP layers (deepseek style)
    capacity_factor: float = 1.25
    norm_topk: bool = True         # renormalise top-k router weights
    moe_groups: int = 1            # dispatch groups (= DP shards at scale)

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_dim: int = 4
    ssm_groups: int = 1            # B/C groups (mamba2 ngroups)
    ssd_chunk: int = 128           # SSD intra-chunk length
    attn_every: int = 0            # hybrid: shared attn every N ssm blocks

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0           # whisper: 1500 frames
    max_decode_len: int = 0        # whisper: 448
    frontend_dim: int = 0          # stub frontend embedding dim (== d_model)

    # --- vlm ---
    vision_prefix_len: int = 0     # patch-embedding prefix length (stub)

    # --- numerics / impl ---
    dtype: str = "bfloat16"        # activation / weight compute dtype
    param_dtype: str = "bfloat16"  # stored params
    attn_chunk: int = 1024         # blockwise-attention KV chunk
    loss_chunk: int = 512          # chunked-CE sequence chunk
    remat: bool = True
    scan_layers: bool = True

    # --- source provenance ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True iff decode state is sub-linear in context (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke-test size (CPU: one fwd/train step)."""
        kw = dict(
            num_layers=max(2, min(self.num_layers, 4 if self.family ==
                                  "hybrid" else 2)),
            d_model=64, num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if
            self.num_kv_heads < self.num_heads else 4,
            head_dim=16, d_ff=128 if self.d_ff else 0,
            vocab_size=512, attn_chunk=64, loss_chunk=64,
            dtype="float32", param_dtype="float32",
        )
        if self.family == "moe":
            kw.update(num_experts=8, top_k=min(self.top_k, 2), moe_d_ff=32,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1),
                      moe_dense_ff=128 if self.first_dense_layers else 0)
            if self.use_mla:
                kw.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16,
                          qk_rope_dim=8, v_head_dim=16)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=32,
                      d_ff=128 if self.family == "hybrid" else 0)
            if self.family == "hybrid":
                kw.update(attn_every=2, num_layers=4)
        if self.is_encoder_decoder:
            kw.update(num_encoder_layers=2, encoder_seq=32, max_decode_len=32)
        if self.vision_prefix_len:
            kw.update(vision_prefix_len=8)
        return self.replace(**kw)



@dataclass(frozen=True)
class TrainConfig:
    """The fields of the reference ``TrainConfig`` that the port reads:
    which leaves carry a low-rank adapter and at what rank (serving), and
    the knobs of every registered training method (Algorithm 1 as
    ``lowrank_adam`` or ``lowrank_lion`` on fp32 or int8 moments and fp32
    or bf16 B masters, the forward-only ``lowrank_lr``, and the
    ``galore`` and ``adamw`` baselines), and the resilience knobs of the
    trainer's health guard and rollback.  Defaults equal the
    reference's.  Every sampler and gradient accumulation
    (``make_train_step``) are ported."""
    optimizer: str = "lowrank_adam"   # any repro_torch.methods registry
                                      # name: 'adamw' | 'galore' |
                                      # 'lowrank_adam' | 'lowrank_lion' |
                                      # 'lowrank_lr'
    sampler: str = "stiefel"          # projection law of V: 'gaussian' |
                                      # 'stiefel' | 'coordinate' |
                                      # 'dependent_diag'
    rank: int = 128                   # projection rank r
    c: float = 1.0                    # weak-unbiasedness scale
    lazy_k: int = 200                 # inner steps per projection
    lr: float = 1e-3
    schedule: str = "cosine"          # 'cosine' | 'constant'
    lowrank_exclude: str = r"(/embed/|/tok$|/pos$|router|conv_w)"
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.05
    grad_clip: float = 1.0
    grad_accum: int = 1               # microbatches per step (activation
                                      # memory / A; lowrank_adam and
                                      # lowrank_lion)
    warmup_steps: int = 1000
    total_steps: int = 100_000
    zo_sigma: float = 1e-3            # LowRank-LR perturbation scale
    reset_moments: bool = True        # reset Adam moments at resample
    min_dim_for_lowrank: int = 128    # matrices with n below this stay dense
    compute_dtype: str = "auto"       # hot-path compute: 'auto' (bf16 on
                                      # CUDA, fp32 on the CPU) | 'bfloat16'
                                      # | 'float32'
    state_dtype: str = "float32"      # subspace m/v storage: 'float32' |
                                      # 'int8' (block-quantized, 128 per
                                      # fp32 scale, v in the sqrt codec)
    master_dtype: str = "float32"     # subspace B master storage:
                                      # 'float32' | 'bfloat16' (updates
                                      # and the merge into a bf16 W
                                      # stochastically rounded)

    # --- resilience (train/health.py + the Trainer's escalation) ---
    health_guard: bool = True         # non-finite/spike skip guard
    spike_zscore: float = 6.0         # EMA z-score that flags a loss spike
    spike_ema: float = 0.99           # EMA decay of the loss mean/variance
    spike_warmup: int = 20            # accepted steps before it arms
    max_consecutive_skips: int = 3    # N consecutive skips -> rollback
    rollback_backoff: float = 0.5     # LR multiplier per rollback
    max_rollbacks: int = 3            # bounded retries; then the run stops
    seed: int = 0
