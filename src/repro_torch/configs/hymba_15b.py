"""hymba-1.5b — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16, parallel attention+mamba heads [arXiv:2411.13676; hf].

SWA window 2048 with 3 global-attention layers (first/middle/last, as in
the paper). The layer stack is scanned with the per-layer window passed as
*data* (global layers get window = seq+1), which keeps the stack
scan-uniform — masked-flash flops are window-invariant, so this changes no
costs while keeping GSPMD compile tractable. Decode carries full-length
absolute-slot caches for every layer (memory is dominated by the 3 global
layers anyway once sharded). SSM state is what makes long_500k servable.
Meta-tokens are omitted (noted in DESIGN.md).
A copy of ``repro.configs.hymba_15b``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
    sliding_window=2048, global_attn_layers=(0, 15, 31), scan_layers=True,
    cp_attention=True,  # 25 q / 5 kv heads don't divide the model axis
    ssm=SSMConfig(d_state=16, head_dim=64, p_major=True),
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    sliding_window=32, global_attn_layers=(0,), scan_layers=True,
    ssm=SSMConfig(d_state=8, head_dim=16, chunk=32, p_major=True),
)
