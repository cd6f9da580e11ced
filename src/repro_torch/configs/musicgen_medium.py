"""musicgen-medium — 48L d_model=1536 24H d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens (4 codebooks) [arXiv:2306.05284; hf].

The EnCodec frontend is a STUB: input_specs() provides codebook token ids
(or precomputed frame embeddings); the backbone sums codebook embeddings
and predicts all 4 codebooks with a factored LM head.
A copy of ``repro.configs.musicgen_medium``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense", modality="audio", num_layers=48,
    d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64, d_ff=6144,
    vocab_size=2048, num_codebooks=4, mlp_activation="geglu",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="dense", modality="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, num_codebooks=4, mlp_activation="geglu",
)
