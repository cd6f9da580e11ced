"""``repro_torch.launch`` — ranks, meshes and entry points (port of
``repro.launch``): :mod:`~repro_torch.launch.mesh` (the mesh, its process
groups, and ``spawn``), :mod:`~repro_torch.launch.collectives` (the
counted collectives the distributed schedules use) and
:mod:`~repro_torch.launch.train` (the training CLI,
``python -m repro_torch.launch.train``)."""
