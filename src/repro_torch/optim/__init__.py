"""Optimizers (port of ``repro.optim``): AdamW baseline, ATA-powered
blocked Shampoo, PowerSGD gradient compression, LR schedules.

The reference's functional interface, over trees of tensors
(``optim._tree``): ``state = opt.init(params)``, ``updates, state =
opt.update(grads, state, params)``. The step counter stays on the CPU.
"""

from repro_torch.optim.adamw import (Optimizer, adamw, apply_updates, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.optim.shampoo import inverse_pth_root, shampoo

__all__ = [
    "Optimizer",
    "adamw",
    "shampoo",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "constant",
    "warmup_cosine",
    "inverse_pth_root",
    "build",
]


def build(opt_cfg, total_steps: int = 10_000):
    """Build an optimizer from an ``OptimizerConfig``
    (``repro_torch.configs.base``)."""
    sched = warmup_cosine(opt_cfg.lr, opt_cfg.warmup_steps, total_steps)
    if opt_cfg.name == "adamw":
        return adamw(
            sched, opt_cfg.beta1, opt_cfg.beta2, opt_cfg.eps, opt_cfg.weight_decay
        )
    if opt_cfg.name == "shampoo":
        return shampoo(
            sched,
            block=opt_cfg.shampoo_block,
            beta1=opt_cfg.beta1,
            beta2=opt_cfg.beta2,
            eps=opt_cfg.eps,
            weight_decay=opt_cfg.weight_decay,
            update_every=opt_cfg.shampoo_update_every,
            n_base=opt_cfg.shampoo_n_base,
        )
    raise ValueError(f"unknown optimizer {opt_cfg.name!r}")
