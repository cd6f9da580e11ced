"""gemma-7b — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256, tied embeddings [arXiv:2403.08295; hf].
A copy of ``repro.configs.gemma_7b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", num_layers=28, d_model=3072,
    num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
    vocab_size=256000, mlp_activation="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
    mlp_activation="geglu", tie_embeddings=True,
)
