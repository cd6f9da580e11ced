"""qwen2-moe-a2.7b — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts do not divide the 16-wide model axis: EP pads to 64 with
router-masked dummies (see parallel/sharding.pad_experts).
A copy of ``repro.configs.qwen2_moe_a27b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, num_shared=4, top_k=4, d_ff_expert=1408),
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256,
    qkv_bias=True,
    moe=MoEConfig(num_experts=6, num_shared=1, top_k=2, d_ff_expert=96),
)
