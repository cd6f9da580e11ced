"""Config dataclasses (copy of ``repro.configs.base``).

The port does not import the reference package, so the dataclasses of
models, shapes, optimizers and runs are repeated here field for field with
the reference's defaults. Every assigned architecture gets a
``configs/<id>.py`` exporting ``CONFIG`` (the exact published config) and
``SMOKE`` (a reduced same-family config for CPU tests); ``registry.py``
resolves ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "ModelConfig",
    "ShapeConfig",
    "OptimizerConfig",
    "RunConfig",
    "SHAPES",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int          # routed experts
    num_shared: int           # always-on shared experts
    top_k: int
    d_ff_expert: int          # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # experts padded up to a multiple of the model axis for EP when needed
    # (qwen2-moe: 60 → 64; dummies are router-masked) — see parallel/sharding.
    sharding: str = "ep"      # 'ep' (expert dim) or 'tp' (ff dim inside expert)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256          # SSD chunk length (training/prefill)
    # P-major head layout: reshape d_inner as (head_dim, n_heads) so a
    # model-axis shard covers whole rows of the head grid even when the
    # SSD head count (e.g. hymba's 50) does not divide the axis.
    p_major: bool = False

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # 'dense' | 'moe' | 'ssm' | 'hybrid'
    modality: str = "text"    # 'text' | 'audio' | 'vision_text'
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    qkv_bias: bool = False
    mlp_activation: str = "swiglu"   # 'swiglu' | 'geglu'
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # sliding-window attention: None = full causal. Per-layer override via
    # global_attn_layers (hymba keeps a few global layers).
    sliding_window: Optional[int] = None
    global_attn_layers: Tuple[int, ...] = ()
    attention_free: bool = False     # mamba2
    scan_layers: bool = True         # lax.scan over stacked layer params
    # context-parallel attention: shard the query sequence over 'model'
    # inside shard_map when head counts do not divide the model axis
    # (hymba: 25 q heads / 5 kv heads) — compute scales 1/16 instead of
    # being model-replicated, at the cost of one output all-gather.
    cp_attention: bool = False
    # audio frontend (musicgen): number of EnCodec codebooks
    num_codebooks: int = 0
    # vision frontend (llava): patches provided by the stub frontend
    num_patches: int = 0
    dtype: str = "bfloat16"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM / hybrid-with-SWA)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.sliding_window is not None:
            return True
        return False

    def num_params(self) -> int:
        """Analytic parameter count (used for 6·N·D model-flops)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for layer in range(self.num_layers):
            n += self._layer_params(layer)
        n += d                                        # final norm
        return n

    def _layer_params(self, layer_idx: int) -> int:
        d = self.d_model
        n = 0
        if self.family != "ssm":  # attention block
            h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
            n += d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qkv_bias:
                n += h * hd + 2 * kv * hd
            n += d  # attn norm
        if self.family in ("ssm", "hybrid") and self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            ns = self.ssm.d_state
            n += d * di * 2            # x, z projections
            n += d * (2 * ns + nh)     # B, C, dt projections
            n += di * self.ssm.d_conv  # depthwise conv
            n += nh * 2 + di           # A, D, gated-norm weight
            n += di * d                # out projection
            n += d                     # ssm norm
        if self.moe is not None:
            e = self.moe.num_experts + self.moe.num_shared
            n += e * 3 * d * self.moe.d_ff_expert   # gate/up/down per expert
            n += d * self.moe.num_experts           # router
            n += d                                   # mlp norm
        elif self.d_ff:
            n += 3 * d * self.d_ff                   # swiglu/geglu
            n += d
        return n

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.num_params()
        full = self.num_params()
        e_total = self.moe.num_experts + self.moe.num_shared
        e_active = self.moe.top_k + self.moe.num_shared
        expert_params = self.num_layers * e_total * 3 * self.d_model * self.moe.d_ff_expert
        active_expert = self.num_layers * e_active * 3 * self.d_model * self.moe.d_ff_expert
        return full - expert_params + active_expert


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The assigned input-shape set (identical across the LM pool).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"       # 'adamw' | 'shampoo'
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    # Shampoo (ATA-powered)
    shampoo_block: int = 1024
    shampoo_update_every: int = 10
    shampoo_grafting: str = "adam"
    # ATA recursion cutoff for the gram statistics. None (default) defers
    # to the repro.tune planner per gram shape; >= shampoo_block disables
    # Strassen entirely (classical-gram baseline)
    shampoo_n_base: Optional[int] = None
    # ZeRO-1 optimizer-state sharding over the data axis
    zero1: bool = True
    # PowerSGD gradient compression (rank 0 = off)
    powersgd_rank: int = 0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    remat: str = "dots"       # 'none' | 'dots' | 'full'
    microbatch: int = 1       # gradient-accumulation microbatches
    seed: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
