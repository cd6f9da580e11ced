"""command-r-plus-104b — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, no-bias [hf:CohereForAI/c4ai-command-r-plus]. The pool's
worst-case memory cell.
A copy of ``repro.configs.command_r_plus_104b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", num_layers=64, d_model=12288,
    num_heads=96, num_kv_heads=8, head_dim=128, d_ff=33792, vocab_size=256000,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense", num_layers=2,
    d_model=128, num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256,
    vocab_size=512,
)
