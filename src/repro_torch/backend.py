"""Device resolution for the port.

The counterpart of ``repro.kernels.ops.interpret_default``: where the
reference chooses compiled Mosaic or Pallas interpret mode from the JAX
backend, the port chooses from the device a tensor lives on. A CUDA tensor
goes to the hand-written kernel; a CPU tensor goes to the kernel's plain
PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "on_cuda"]

# Tensors made from nothing (zeros, converters, chip_smoke data) land here
# unless the caller asks for another device.
DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :data:`DEFAULT_DEVICE`."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


def on_cuda(*tensors) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; raises on a mix (a kernel cannot take both)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on mixed or unsupported devices: {sorted(kinds)}")
