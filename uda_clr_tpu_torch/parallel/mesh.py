"""Layout checks of data parallelism (the counterpart of
uda_clr_tpu/parallel/mesh.py). The JAX package shards the batch over a
``('data',)`` mesh of devices inside one program; the port runs one process
per device (``RunConfig.dist_*``, :mod:`.distributed`), so its mesh is the
set of ranks and each rank holds a contiguous slice of every global batch."""

from __future__ import annotations

import math


def check_mesh(mesh_shape, world: int) -> None:
    """Accept ``mesh_shape`` None, ``(1,)`` or ``(world,)``. A
    ``('data', 'space')`` mesh raises (not ported); so does a mesh wider
    than the process group, since the port drives one device per process."""
    if mesh_shape is None:
        return
    shape = tuple(mesh_shape)
    if len(shape) == 2:
        raise NotImplementedError(
            f"mesh_shape {shape}: the ('data', 'space') spatial mesh is not ported "
            f"(ROADMAP A5, the spatial mesh)")
    if len(shape) != 1:
        raise ValueError(f"mesh_shape {shape}: one axis, ('data',)")
    if shape[0] not in (1, world):
        raise ValueError(
            f"mesh_shape {shape} in a group of {world} process(es): the port drives one device "
            f"per process; run {math.prod(shape)} processes, each with run.dist_coordinator, "
            f"run.dist_num_processes {math.prod(shape)} and its run.dist_process_id")


def local_rows(n_global: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n_global``."""
    if n_global % world:
        raise ValueError(f"a global batch of {n_global} does not split over {world} ranks")
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)
