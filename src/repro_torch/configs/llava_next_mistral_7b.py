"""llava-next-mistral-7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision frontend is a STUB: input_specs() provides 2880 precomputed
patch embeddings (4 anyres tiles + base image, 576 patches each at 336px/
CLIP-L-14) prepended to the token sequence; loss is computed on text
positions only.
A copy of ``repro.configs.llava_next_mistral_7b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="dense", modality="vision_text",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, num_patches=2880,
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke", family="dense",
    modality="vision_text", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, num_patches=16,
)
