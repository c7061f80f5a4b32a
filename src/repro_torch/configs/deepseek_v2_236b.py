"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

moe_d_ff=1536 per the assignment; first layer is a dense MLP (width 12288),
q_lora=1536, qk dims (nope 128 + rope 64), v_head 128 per the paper/HF cfg.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab_size=102400, rope_theta=1e4,
    num_experts=160, num_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense_layers=1, moe_dense_ff=12288, norm_topk=False,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    source="arXiv:2405.04434; hf",
)
