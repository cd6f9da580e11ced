"""Carry state between the reference and the port as numpy arrays.

The reference's packed objects (``repro.core.symmetric.SymmetricMatrix``,
``repro.solve.cholesky.CholeskyFactor``) are a ``(..., T, bn, bn)`` block
array plus ``(n, bn)``; so are the port's. These converters move the block
array across unchanged, so one stage's reference output can feed the
port's next stage (for example, the JAX packed gram into the port's
``cholesky``) and back. :func:`tree_from_numpy` carries a whole tree
across — parameters, gradients, or an optimizer's state with its packed
stats and factors, its step counter and its ``PowerSGDState``.
:func:`params_from_reference` carries a model's parameter tree (the
reference's ``models.transformer.init`` output) after checking it against
the port's own ``init``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.symmetric import SymmetricMatrix
from repro_torch.solve.cholesky import CholeskyFactor

__all__ = ["symmetric_from_numpy", "factor_from_numpy", "to_numpy", "tree_from_numpy",
           "params_from_reference"]


def _blocks(blocks, n, bn, device):
    arr = np.asarray(blocks)
    nb = -(-int(n) // int(bn))
    if arr.ndim < 3 or arr.shape[-3:] != (nb * (nb + 1) // 2, bn, bn):
        raise ValueError(
            f"blocks of shape {arr.shape} do not hold a packed grid with n={n}, bn={bn}"
        )
    return torch.tensor(arr, device=resolve_device(device))  # a copy: arr may be read-only


def symmetric_from_numpy(blocks, n: int, bn: int, *, device="cuda") -> SymmetricMatrix:
    """A port :class:`SymmetricMatrix` from packed blocks given as an array."""
    return SymmetricMatrix(_blocks(blocks, n, bn, device), n, bn)


def factor_from_numpy(blocks, n: int, bn: int, *, device="cuda") -> CholeskyFactor:
    """A port :class:`CholeskyFactor` from packed factor blocks."""
    return CholeskyFactor(_blocks(blocks, n, bn, device), n, bn)


def to_numpy(x):
    """A tensor as a numpy array; a packed object as ``(blocks, n, bn)``."""
    if isinstance(x, (SymmetricMatrix, CholeskyFactor)):
        return x.blocks.detach().cpu().numpy(), x.n, x.bn
    return x.detach().cpu().numpy()


def tree_from_numpy(tree, *, device="cuda", named_tuples=()):
    """The port's counterpart of a reference tree, for example
    ``opt.init(params)`` or ``opt.update(...)`` output, with arrays given as
    numpy (or anything ``np.asarray`` takes). The reference's classes are
    recognised by name, since the port imports none of them:

    * ``SymmetricMatrix`` / ``CholeskyFactor`` → the port's, blocks copied;
    * a named tuple → the class of ``named_tuples`` with its name and
      fields (for example ``optim.powersgd.PowerSGDState``, whose ``q`` is
      carried, as JAX's random stream cannot be reproduced), or a plain
      tuple where none matches;
    * dicts, lists and tuples → the same containers;
    * a 0-d array (a step counter) → a 0-d tensor **on the CPU**, where the
      port's optimizers keep their step; any other array → a tensor on
      ``device``; Python numbers and ``None`` stay as they are.
    """
    classes = {(cls.__name__, tuple(cls._fields)): cls for cls in named_tuples}

    def conv(x):
        name = type(x).__name__
        if name in ("SymmetricMatrix", "CholeskyFactor") and hasattr(x, "blocks"):
            make = symmetric_from_numpy if name == "SymmetricMatrix" else factor_from_numpy
            return make(x.blocks, x.n, x.bn, device=device)
        cls = classes.get((name, getattr(x, "_fields", None)))
        if isinstance(x, tuple) and cls is not None:
            return cls(*(conv(v) for v in x))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        if x is None or isinstance(x, (bool, int, float)):
            return x
        arr = np.array(x)   # a copy: the source may be read-only
        return torch.from_numpy(arr) if arr.ndim == 0 else torch.from_numpy(arr).to(
            resolve_device(device))

    return conv(tree)


def params_from_reference(cfg, tree, *, device="cuda"):
    """The port's parameter tree for ``cfg`` holding the arrays of ``tree``
    (the reference's ``transformer.init(key, cfg)`` output, or any tree of
    that structure as numpy). Every leaf's key path and shape is checked
    against the port's ``transformer.init`` on the ``meta`` device before
    anything is copied, so a tree of another config or layout raises
    instead of loading."""
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_flatten_with_path

    want, _ = tree_flatten_with_path(init(None, cfg, device="meta"))
    got, _ = tree_flatten_with_path(tree)
    want_shapes = [(k, tuple(x.shape)) for k, x in want]
    got_shapes = [(k, tuple(np.shape(x))) for k, x in got]
    if got_shapes != want_shapes:
        bad = sorted(set(got_shapes) ^ set(want_shapes))
        raise ValueError(f"the tree does not match {cfg.name}'s parameters: {bad[:6]}")
    return tree_from_numpy(tree, device=device)
