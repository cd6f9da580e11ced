"""Checkpointing: atomic, async-capable, keep-N, resumable (port of
``repro.checkpoint.manager``).

Layout (one directory per step), the reference's::

    <dir>/step_000123/
        meta.json                  # step, tree structure, leaf count, extra
        shard_00000.npz            # flat leaves, leaf_0 … leaf_{N-1}
        _COMMITTED                 # written last — presence marks validity

* **Atomicity** — writers stage into ``step_N.tmp`` and ``os.replace`` it
  into place after fsync; the ``_COMMITTED`` marker is written last, so a
  crash mid-save never yields a checkpoint that ``latest_step`` would
  resume from.
* **Async save** — ``save(..., blocking=False)`` copies every leaf to host
  memory synchronously (a consistent cut), then writes in a background
  thread so the train loop keeps stepping (the next save joins the
  previous writer first).
* **Keep-N GC** — older committed checkpoints beyond ``keep`` are deleted
  after a successful commit.
* **Resume** — ``restore(like, step=None)`` loads the newest committed step
  into the structure of ``like``, each tensor leaf on the device and with
  the dtype of ``like``'s.

Leaves are flattened by ``optim._tree`` (dicts in sorted key order, as JAX
flattens them), so a tree of numpy arrays gives the same ``.npz`` as the
reference's manager. A packed ``SymmetricMatrix`` or ``CholeskyFactor`` is
one leaf, its block array, as it is one array leaf in the reference;
Python numbers are 0-d arrays. ``meta.json``'s ``treedef`` is the list of
leaf key paths (``optim._tree``'s), not JAX's serialized structure.

On a mesh (one process a rank, ``launch.mesh``) every rank calls ``save``
with its blocks and their specs (``parallel.sharding``): each leaf is
gathered back to the full array the format stores, one leaf at a time, and
rank 0 writes them. ``restore_sharded(like, shardings)`` reads the full
arrays and cuts each rank's block (``parallel.sharding.local_block``), so
a run saved on one mesh resumes on another (``runtime.elastic``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim._tree import tree_flatten, tree_flatten_with_path

__all__ = ["CheckpointManager"]


def _host(x) -> np.ndarray:
    """A leaf as a host array (a copy: the caller may go on writing ``x``)."""
    if hasattr(x, "blocks"):             # SymmetricMatrix, CholeskyFactor
        x = x.blocks
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _like(arr: np.ndarray, want):
    """``arr`` as a leaf of ``want``'s kind, device and dtype."""
    if hasattr(want, "blocks"):
        return type(want)(_like(arr, want.blocks), want.n, want.bn)
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(arr).to(device=want.device, dtype=want.dtype)
    if isinstance(want, (bool, int, float)):
        return type(want)(arr.item())
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths --------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(path, "_COMMITTED")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True, extra: dict = None, *,
             shardings=None):
        """Checkpoint ``tree`` at ``step``. Non-blocking saves copy to host
        first (consistent), then write in the background. ``shardings``: a
        tree of ``parallel.sharding.NamedSharding`` (one a leaf of
        ``tree``): ``tree`` holds this rank's blocks, every rank of the
        mesh must call ``save``, and rank 0 writes."""
        self.wait()  # at most one in-flight writer
        flat, _ = tree_flatten_with_path(tree)
        if shardings is None:
            host_leaves = [_host(x) for _, x in flat]
        else:
            from repro_torch.parallel.sharding import gather, spec_leaves

            named = spec_leaves(shardings)
            mesh = named[0].mesh
            host_leaves = []
            for (_, x), ns in zip(flat, named):
                full = gather(x, mesh, ns.spec) if hasattr(x, "shape") or hasattr(
                    x, "blocks") else x
                host_leaves.append(_host(full) if mesh.rank == 0 else None)
                del full
            if mesh.rank != 0:
                return
        meta = {
            "step": step,
            "treedef": [path for path, _ in flat],
            "num_leaves": len(host_leaves),
            "extra": extra or {},
        }

        def _write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(
                os.path.join(tmp, "shard_00000.npz"),
                **{f"leaf_{i}": x for i, x in enumerate(host_leaves)},
            )
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        def _background():
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._writer = threading.Thread(target=_background, daemon=True)
            self._writer.start()

    def wait(self):
        """Join the in-flight writer; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, like: Any, step: Optional[int] = None):
        """Restore into the structure of ``like`` (shapes must match)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self._step_dir(step)
        leaves, treedef = tree_flatten(like)
        with np.load(os.path.join(path, "shard_00000.npz")) as data:
            restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
        for got, want in zip(restored, leaves):
            want_shape = tuple(np.shape(want.blocks if hasattr(want, "blocks") else want))
            if tuple(got.shape) != want_shape:
                raise ValueError(
                    f"checkpoint leaf shape {got.shape} != expected {want_shape}"
                )
        out = treedef.unflatten(_like(got, want) for got, want in zip(restored, leaves))
        return out, step

    def restore_sharded(self, like: Any, shardings, step: Optional[int] = None, fit=None):
        """Restore and place with target shardings (the elastic re-mesh
        path): ``like`` is this rank's tree of blocks (or anything with
        their structure, devices and dtypes), ``shardings`` a tree of
        ``parallel.sharding.NamedSharding``; each full array read is cut to
        this rank's block under its spec. ``fit(key, array, shape)``, where
        given, maps a stored array whose shape is not the one wanted (a key
        path of ``optim._tree``) onto ``shape``; any other mismatch raises.
        Returns ``(tree, step)``."""
        from repro_torch.parallel.sharding import global_shape, local_block, spec_leaves

        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        keys = [k for k, _ in tree_flatten_with_path(like)[0]]
        leaves, treedef = tree_flatten(like)
        named = spec_leaves(shardings)
        if len(named) != len(leaves):
            raise ValueError(f"{len(named)} shardings for {len(leaves)} leaves")
        out = []
        with np.load(os.path.join(self._step_dir(step), "shard_00000.npz")) as data:
            for i, (want, ns) in enumerate(zip(leaves, named)):
                got = data[f"leaf_{i}"]
                full = global_shape(want, ns.mesh, ns.spec)
                if tuple(got.shape) != full and fit is not None:
                    got = fit(keys[i], got, full)
                if tuple(got.shape) != full:
                    raise ValueError(f"checkpoint leaf shape {got.shape} != expected {full}")
                if got.ndim:
                    got = np.ascontiguousarray(local_block(torch.from_numpy(got), ns.mesh,
                                                           ns.spec).numpy())
                out.append(_like(got, want))
        return treedef.unflatten(out), step

    def extra(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f).get("extra", {})
