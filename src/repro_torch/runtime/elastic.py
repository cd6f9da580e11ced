"""Elastic scaling: re-mesh a run onto a different topology (port of
``repro.runtime.elastic``).

The checkpoint format stores full (unsharded) arrays per leaf, so elastic
re-scale is a *placement* problem, not a data transformation:

    1. survivors agree on the new mesh shape (drop a pod / halve the data
       axis / grow after repair);
    2. sharding rules are re-derived for the new mesh (they are functions
       of the mesh, see ``parallel/sharding.py``);
    3. ``CheckpointManager.restore_sharded`` cuts every leaf to the new
       rank's block.

Global batch is kept constant across re-meshes by adjusting the
gradient-accumulation microbatch count (``microbatches_for``), so training
curves are unaffected by topology changes.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["remesh_plan", "microbatches_for", "reshard_tree"]


def remesh_plan(
    n_devices: int, prefer_model: int = 16
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Choose a (data, model) mesh for an arbitrary surviving device count.

    Keeps the model axis at the largest power-of-two divisor ≤ prefer_model
    (TP degree should shrink last — it is baked into layout choices)."""
    model = 1
    while model * 2 <= prefer_model and n_devices % (model * 2) == 0:
        model *= 2
    data = n_devices // model
    return (data, model), ("data", "model")


def microbatches_for(global_batch: int, per_device_batch: int, n_data: int) -> int:
    """Microbatch count that keeps global batch constant on a new topology."""
    per_step = per_device_batch * n_data
    if global_batch % per_step:
        raise ValueError(
            f"global batch {global_batch} not divisible by {per_step} "
            f"(= {per_device_batch} × {n_data} data shards)"
        )
    return global_batch // per_step


def reshard_tree(tree, mesh, spec_tree):
    """Place a full tree as this rank's blocks under a spec tree (the
    reference's ``device_put`` onto ``NamedSharding``s): each leaf is cut
    by ``parallel.sharding.local_block`` and its block moved to
    ``mesh.device``."""
    from repro_torch.parallel.sharding import map_specs, local_block

    def place(spec, x):
        if hasattr(x, "blocks"):
            return type(x)(place(spec, x.blocks), x.n, x.bn)
        if not hasattr(x, "to"):
            return x
        blk = local_block(x, mesh, spec)
        if blk.numel() == x.numel():
            return x.to(mesh.device)
        # a copy, so the block does not keep the whole array alive
        return blk.to(mesh.device, copy=True).contiguous()

    return map_specs(place, spec_tree, tree)
