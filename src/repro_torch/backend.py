"""Device resolution for the port.

The counterpart of ``repro.kernels.ops.interpret_default``: where the
reference chooses compiled Mosaic or Pallas interpret mode from the JAX
backend, the port chooses from the device a tensor lives on. A CUDA tensor
goes to the hand-written kernel; a CPU tensor goes to the kernel's plain
PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch
from torch._C import _get_dispatch_mode
from torch._C import _TorchDispatchModeKey as _ModeKey

__all__ = ["DEFAULT_DEVICE", "resolve_device", "on_cuda", "kernel_dtypes", "planner_key",
           "tracing", "device_cached", "device_table", "holding_tables"]

# Tensors made from nothing (zeros, converters, chip_smoke data) land here
# unless the caller asks for another device.
DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :data:`DEFAULT_DEVICE`."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


# key -> a static value kept on a device (index tables, masks, launch
# tables), most recently used last; the oldest goes beyond _TABLES_MAX
_TABLES: OrderedDict = OrderedDict()
_TABLES_MAX = 256
_TABLES_LOCK = threading.Lock()
# lists open in holding_tables(): each collects every value handed out
_HOLDERS: list = []


def tracing() -> bool:
    """True while a fake-tensor or proxy mode is active (``make_fx``,
    ``torch.export``, ``torch.compile``): a value made then is a fake or a
    graph constant of that trace, never a tensor a later run may read."""
    return (_get_dispatch_mode(_ModeKey.FAKE) is not None
            or _get_dispatch_mode(_ModeKey.PROXY) is not None
            or torch.compiler.is_compiling())


def device_cached(key, make):
    """``make()``, made once per ``key`` and kept while it is among the
    :data:`_TABLES_MAX` most recently used values. ``key`` must name
    everything the value depends on, its device included; callers must not
    write to what it holds. A copy from pageable host memory waits for the
    device, so the packed paths and the fused launches take their static
    tables from here and, after the first call at a shape, copy nothing to
    the card. While :func:`tracing`, the cache is neither read nor written:
    ``make()`` runs, so the trace records the table as its own constant (a
    kept real tensor may not enter a fake-tensor trace, and a value made in
    one is a fake)."""
    if tracing():
        return make()
    with _TABLES_LOCK:
        if key in _TABLES:
            _TABLES.move_to_end(key)
            value = _TABLES[key]
            for held in _HOLDERS:
                held.append(value)
            return value
    value = make()
    with _TABLES_LOCK:
        value = _TABLES.setdefault(key, value)
        _TABLES.move_to_end(key)
        while len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
        for held in _HOLDERS:
            held.append(value)
    return value


@contextlib.contextmanager
def holding_tables():
    """Yield a list that collects every value :func:`device_cached` hands
    out inside the block. Whoever keeps the list keeps those values alive
    after the LRU drops them: a captured CUDA graph reads a table's memory
    with no Python object watching it (``repro_torch.serve.engine``)."""
    held: list = []
    with _TABLES_LOCK:
        _HOLDERS.append(held)
    try:
        yield held
    finally:
        with _TABLES_LOCK:
            _HOLDERS.remove(held)


def device_table(key, device, make) -> torch.Tensor:
    """The static table ``make()`` (a numpy array or CPU tensor) as a tensor
    on ``device``, kept per ``(key, device)`` by :func:`device_cached`.
    ``key`` must name everything the table depends on (its geometry and
    dtype)."""
    return device_cached((key, str(torch.device(device))),
                         lambda: torch.as_tensor(make(), device=device))


def planner_key(x: torch.Tensor):
    """``(backend, dtype)`` of a tensor as the planner's key and cost model
    take them: the device type (``"cuda"`` or ``"cpu"``) and the dtype's
    bare name (``"float32"``, ``"bfloat16"``, ``"float64"``), as the
    reference's ``str(jnp.dtype)`` gives it — ``str(torch.bfloat16)`` is
    ``"torch.bfloat16"``, which the model would price as float32."""
    return x.device.type, str(x.dtype).removeprefix("torch.")


def on_cuda(*tensors) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; raises on a mix (a kernel cannot take both)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands on mixed or unsupported devices: {sorted(kinds)}")


def kernel_dtypes(*tensors, out_dtype, what: str):
    """The operands of one CUDA launch in a common load type, and the
    launch's ``dtypes`` code (bit 0: bfloat16 operands, bit 1: bfloat16
    output; ``csrc/dtype.cuh``). The kernels load and store float32 or
    bfloat16 and sum in float32, as the reference's Pallas kernels do;
    float64 is not among them, as it is not among the reference's, and
    raises ``TypeError``. Operands load as bfloat16 only if all are
    bfloat16; a bfloat16 operand beside a float32 one is widened first,
    which is exact."""
    n16 = 0
    for x in tensors:
        if x.dtype is torch.bfloat16:
            n16 += 1
        elif x.dtype is not torch.float32:
            raise TypeError(f"{what} kernel takes float32 or bfloat16 operands, got {x.dtype}")
    if out_dtype is not torch.float32 and out_dtype is not torch.bfloat16:
        raise TypeError(f"{what} kernel writes float32 or bfloat16, got out_dtype={out_dtype}")
    load16 = n16 == len(tensors)
    if n16 and not load16:
        tensors = tuple(x.float() for x in tensors)
    return tensors, int(load16) | (int(out_dtype is torch.bfloat16) << 1)

