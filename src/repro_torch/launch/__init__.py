"""``repro_torch.launch`` — ranks and meshes on ``torch.distributed``
(port of ``repro.launch``): :mod:`~repro_torch.launch.mesh` (the mesh, its
process groups, and ``spawn``) and :mod:`~repro_torch.launch.collectives`
(the counted collectives the distributed schedules use)."""
