"""deepseek-moe-16b — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared (fine-grained experts)
[arXiv:2401.06066; hf].
A copy of ``repro.configs.deepseek_moe_16b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=102400,
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_ff_expert=1408),
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256,
    moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_ff_expert=96),
)
