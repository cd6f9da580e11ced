"""Meshes of ranks for the distributed schedules (port of
``repro.launch.mesh``).

The reference runs one program over a ``jax.sharding.Mesh`` of devices
(``shard_map``). The port runs one process per rank over
``torch.distributed``: every rank calls the same function with its own
view of the operands, and a :class:`Mesh` tells it where it sits.

* A rank's **flat rank** is row-major over ``axis_names`` (the first axis
  varies slowest), as a ``jax`` mesh lays its devices out.
* The mesh keeps one ``ProcessGroup`` per line of every axis and per
  merged pool of several axes (every subset of the axes), built with
  ``dist.new_group``. Group creation is collective over the default group,
  so every rank builds every group, in the same order: :func:`make_mesh`
  and :func:`split_axis` must be called by all ranks alike.
* ``dist.new_group`` orders a group's ranks by flat rank. For a merged
  ``(task, row)`` pool whose task axis precedes the row axis in
  ``axis_names`` that is the task-major chunk order :func:`merged_axis`
  documents; otherwise :meth:`Mesh.pool_order` gives the permutation.

:func:`spawn` starts the ranks of one run on this host (the ``spawn``
start method, a ``file://`` rendezvous in a temporary directory) and joins
them under a time limit.

:func:`make_production_mesh` gives one rank's view of the production
meshes, :data:`SINGLE_POD` and :data:`MULTI_POD`, over torch's fake process
group (:func:`fake_mesh`): no other process runs, and the collectives
return at once and move nothing, but the port's collective wrappers still
count the bytes each would move. ``launch/dryrun.py`` traces a rank's
program on fake tensors over it. Departure: the reference's mesh holds
every device of the pod; the port's is one rank's, so it takes the
``rank`` and the ``device`` of that rank.
"""

from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Mesh", "AbstractMesh", "make_mesh", "make_production_mesh", "fake_mesh",
           "merged_axis", "split_axis", "spawn", "SINGLE_POD", "MULTI_POD"]

Axes = Union[str, Sequence[str]]

# the production meshes, read as NVIDIA H100s in hosts of 8: 256 cards
# (32 hosts) as (data, model), and 512 cards (64 hosts) as (pod, data, model)
SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


class AbstractMesh:
    """A mesh's shape and nothing else (``jax.sharding.AbstractMesh``):
    ``shape`` maps axis name → size in ``axis_names`` order. The sharding
    rules (``parallel.sharding``) read only this, so they can be held
    against the reference on the production meshes, (16, 16) and
    (2, 16, 16), with no process group. :class:`Mesh` is one rank's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} must pair up")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must be distinct, got {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of mesh axis names, in the caller's order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for name in names:
            if name not in self.shape:
                raise ValueError(f"axis {name!r} not in mesh {self.axis_names}")
        return names

    def axis_size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (one name or several, merged)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


class Mesh(AbstractMesh):
    """This rank's place in a named mesh of ranks, and the mesh's groups.

    ``shape``: axis name → size, in ``axis_names`` order. ``coords``: this
    rank's index along each axis. ``device``: where this rank keeps its
    tensors. ``backend``: the process groups' backend (``"nccl"``,
    ``"gloo"``, or ``"fake"`` for :func:`fake_mesh`).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, backend: str,
                 device, rank: int):
        super().__init__(shape, axis_names)
        self.backend = backend
        self.device = torch.device(device)
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names, self._coords_of(self.rank)))
        self._groups = self._build_groups()

    def _coords_of(self, rank: int) -> Tuple[int, ...]:
        coords = []
        for name in reversed(self.axis_names):
            rank, c = divmod(rank, self.shape[name])
            coords.append(c)
        return tuple(reversed(coords))

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def _members(self, axes: Tuple[str, ...], coords: dict) -> list:
        """Flat ranks that share ``coords`` off ``axes``, in the order of
        ``axes`` (the first axis varies slowest)."""
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            out.append(self._rank_of({**coords, **dict(zip(axes, idx))}))
        return out

    def _build_groups(self) -> dict:
        """One group per line of every subset of the axes that holds more
        than one rank, created in one fixed order on every rank."""
        groups = {}
        world = list(range(self.size))
        for r in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                others = [a for a in self.axis_names if a not in axes]
                mine = None
                for idx in itertools.product(*(range(self.shape[a]) for a in others)):
                    ranks = sorted(self._members(axes, dict(zip(others, idx))))
                    if ranks == world:
                        group = dist.group.WORLD
                    else:
                        group = dist.new_group(ranks, backend=self.backend)
                    if self.rank in ranks:
                        mine = group
                groups[frozenset(axes)] = mine
        return groups

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes``; for several axes, the merged
        index with the first named axis slowest (``jax.lax.axis_index`` of
        a tuple of axes)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The ``ProcessGroup`` of this rank's line along ``axes``; None
        where that line holds this rank alone (its collectives are
        identities)."""
        return self._groups.get(frozenset(self._axes(axes)))

    def pool_order(self, axes: Axes) -> Optional[list]:
        """For a merged pool: ``order[g]`` is the merged index
        (:meth:`axis_index`, first named axis slowest) of the rank at group
        position ``g`` (groups order their ranks by flat rank); None where
        the two orders agree."""
        names = self._axes(axes)
        members = self._members(names, self.coords)
        order = [members.index(r) for r in sorted(members)]
        return None if order == list(range(len(order))) else order

    def local_block(self, x: torch.Tensor, spec: Sequence[Optional[Axes]]) -> torch.Tensor:
        """This rank's block of a global ``x`` under a partition spec: one
        entry per leading dim, an axis name (or a tuple of names, merged)
        that shards the dim, or None (replicated) — the slice ``shard_map``
        hands a device for ``in_specs=P(*spec)``. Raises ``ValueError``
        where an axis size does not divide its dim."""
        index = []
        for d, axes in enumerate(spec):
            if axes is None:
                index.append(slice(None))
                continue
            p, size = self.axis_size(axes), x.shape[d]
            if size % p:
                raise ValueError(f"mesh axis {axes!r} size {p} must divide dim {d} "
                                 f"of size {size} (P{tuple(spec)!r})")
            i, step = self.axis_index(axes), size // p
            index.append(slice(i * step, (i + 1) * step))
        return x[tuple(index)]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str, device) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default process group.

    ``backend`` is explicit (``"nccl"``: one card per rank; ``"gloo"``: CPU
    tensors, or CUDA tensors of ranks that share a card) and must be the
    default group's. ``device``: where this rank keeps its tensors. Every
    rank must call it (group creation is collective).
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or 'gloo'")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or launch.mesh.spawn)")
    if dist.get_backend() != backend:
        raise ValueError(f"backend {backend!r} differs from the process group's "
                         f"{dist.get_backend()!r}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh shape {tuple(shape)} holds {math.prod(shape)} ranks, "
                         f"the process group {dist.get_world_size()}")
    return Mesh(shape, axes, backend=backend, device=device, rank=dist.get_rank())


def fake_mesh(shape: Sequence[int], axes: Sequence[str], *, rank: int = 0,
              device=None) -> Mesh:
    """Rank ``rank``'s :class:`Mesh` of ``shape`` over torch's fake process
    group (backend ``"fake"``): collectives return at once and move no
    data, so one process can trace any rank's program on fake tensors.

    Initialises the default group (world ``prod(shape)``, rank ``rank``)
    where none is initialised; raises ``ValueError`` where an initialised
    one is not a fake group of that world size and rank (tear it down with
    ``torch.distributed.destroy_process_group``). ``device``: where the
    rank keeps its tensors (None: the card).
    """
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.backend import resolve_device

    world = math.prod(shape)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a mesh of {world} ranks")
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), world_size=world, rank=rank)
    elif (dist.get_backend(), dist.get_world_size(), dist.get_rank()) != ("fake", world, rank):
        raise ValueError(
            f"the initialised process group ({dist.get_backend()!r}, world "
            f"{dist.get_world_size()}, rank {dist.get_rank()}) is not the fake group of "
            f"world {world} and rank {rank} that mesh {tuple(shape)} needs")
    return Mesh(shape, axes, backend="fake", device=resolve_device(device), rank=rank)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0, device=None) -> Mesh:
    """Rank ``rank``'s view of the production mesh: :data:`SINGLE_POD`
    (256 H100s, 32 hosts of 8) with axes ``("data", "model")``, or
    :data:`MULTI_POD` (512 H100s, 64 hosts of 8) with ``("pod", "data",
    "model")``, over the fake process group (:func:`fake_mesh`, whose
    rules on an initialised group apply)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, rank=rank, device=device)


def merged_axis(task_axis: str, row_axis: Optional[str] = None) -> Union[str, Tuple[str, str]]:
    """The rank pool the BFS reduce-scatter runs over.

    ``ata_bfs_dfs`` stages every rank's partial tiles at their global tri
    positions and issues ONE ``reduce_scatter_tensor`` over the task and
    row axes merged into a single pool (:meth:`Mesh.group` of the tuple).
    Chunk order is task-major (the tuple's first axis is the slowest),
    which is exactly the order ``bfs_dfs_assignment`` deals contiguous tri
    chunks in, so the scattered result is already in packed tri order.
    """
    return (task_axis, row_axis) if row_axis is not None else task_axis


def split_axis(mesh: Mesh, axis: str, sizes: Sequence[int], names: Sequence[str]) -> Mesh:
    """Refactor one mesh axis into named subgroup axes, same rank order.

    Row-major over the original axis, so ``(grp, sub)`` subgroup ``g``
    holds the ranks that owned the contiguous index range ``[g·sub_size,
    (g+1)·sub_size)``. Builds the new mesh's groups, so every rank must
    call it.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh {mesh.axis_names}")
    if len(sizes) != len(names):
        raise ValueError("sizes and names must pair up")
    if math.prod(sizes) != mesh.shape[axis]:
        raise ValueError(
            f"prod(sizes)={math.prod(sizes)} != mesh.shape[{axis!r}]={mesh.shape[axis]}")
    new_shape, new_names = [], []
    for name in mesh.axis_names:
        if name == axis:
            new_shape.extend(sizes)
            new_names.extend(names)
        else:
            new_shape.append(mesh.shape[name])
            new_names.append(name)
    return Mesh(new_shape, new_names, backend=mesh.backend, device=mesh.device, rank=mesh.rank)


# ---------------------------------------------------------------------------
# starting the ranks of one run on this host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world_size: int, backend: str, init_file: str, out_dir: str,
               args: tuple) -> None:
    """One rank: join the process group, run ``fn``, write its result (or
    its traceback) under ``out_dir``."""
    try:
        device_id = None
        if backend == "gloo":
            # one host: keep gloo's pairs on the loopback interface
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        else:
            device_id = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device_id)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size, device_id=device_id)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"result.{rank}"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world_size: int, *, backend: str, init_file: Optional[str] = None,
          timeout_s: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks of this
    host and return their results, rank by rank.

    Each rank is a process of the ``spawn`` start method (never ``fork``:
    forking a process whose threads hold locks can deadlock), so ``fn`` and
    ``args`` are pickled: ``fn`` must be importable by name. Each rank
    joins the default process group over ``backend`` through a
    ``file://`` rendezvous at ``init_file`` (default: a file in a fresh
    temporary directory, removed afterwards), needing no port. With
    ``"nccl"`` rank ``r`` takes card ``r`` mod the card count first.

    Results travel back pickled through files in the temporary directory.
    If any rank fails, the others are killed after a short grace (they
    would wait in a collective for it), and if any is alive after
    ``timeout_s`` all are killed; either way ``RuntimeError`` names each
    failed or hung rank with its traceback.
    """
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        init_file = init_file or os.path.join(out_dir, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, init_file, out_dir, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        grace_end = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if grace_end is None and any(p.exitcode not in (None, 0) for p in procs):
                grace_end = now + 5.0
            if now > deadline or (grace_end is not None and now > grace_end):
                break
            time.sleep(0.02)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            lines = []
            for r in failed:
                path = os.path.join(out_dir, f"error.{r}")
                if os.path.exists(path):
                    with open(path) as f:
                        lines.append(f"rank {r}:\n{f.read()}")
                elif r in hung:
                    lines.append(f"rank {r}: still running, killed")
                else:
                    lines.append(f"rank {r}: exit code {procs[r].exitcode}")
            why = (f"timed out after {timeout_s:.0f} s" if hung and grace_end is None
                   else "failed")
            raise RuntimeError(f"spawn of {world_size} {backend} ranks {why}; ranks {failed}:\n"
                               + "\n".join(lines))
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"result.{r}"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
