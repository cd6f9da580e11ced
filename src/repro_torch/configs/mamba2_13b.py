"""mamba2-1.3b — 48L d_model=2048 attention-free, ssm_state=128 (SSD)
[arXiv:2405.21060]. vocab=50280 (padded to model-axis multiple for sharding).

A copy of ``repro.configs.mamba2_13b``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
    attention_free=True, ssm=SSMConfig(d_state=128),
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=256,
    attention_free=True,
    ssm=SSMConfig(d_state=16, head_dim=16, chunk=32),
)
