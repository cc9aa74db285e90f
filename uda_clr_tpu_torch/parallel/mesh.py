"""Layout checks of data parallelism and of the ``('data', 'space')`` mesh
(the counterpart of uda_clr_tpu/parallel/mesh.py). The JAX package shards
the batch over a ``('data',)`` or ``('data', 'space')`` mesh of devices
inside one program; the port runs one process per device
(``RunConfig.dist_*``, :mod:`.distributed`), so its mesh is the set of
ranks. Each rank holds a contiguous slice of every global batch and, on a
2-D mesh, a stripe of rows of every per-pixel array (:mod:`.spatial`).

Device order is JAX's (``get_mesh`` reshapes the devices to ``(n_data,
n_space)``): rank r is data index ``r // n_space`` and space index
``r % n_space``."""

from __future__ import annotations

import math


def check_mesh(mesh_shape, world: int) -> None:
    """Accept ``mesh_shape`` None, ``(1,)``, ``(world,)`` or ``(n_data,
    n_space)`` with ``n_data * n_space == world``; raise for any other shape
    (the port drives one device per process)."""
    if mesh_shape is None:
        return
    shape = tuple(mesh_shape)
    launch = (f"run {math.prod(shape)} processes, each with run.dist_coordinator, "
              f"run.dist_num_processes {math.prod(shape)} and its run.dist_process_id")
    if len(shape) == 2:
        if any(not isinstance(n, int) or n < 1 for n in shape):
            raise ValueError(f"mesh_shape {shape}: (n_data, n_space), two positive integers")
        if math.prod(shape) != world:
            raise ValueError(f"mesh_shape {shape} in a group of {world} process(es): the port "
                             f"drives one device per process; {launch}")
        return
    if len(shape) != 1:
        raise ValueError(f"mesh_shape {shape}: ('data',) or ('data', 'space')")
    if shape[0] not in (1, world):
        raise ValueError(f"mesh_shape {shape} in a group of {world} process(es): the port "
                         f"drives one device per process; {launch}")


def mesh_coords(rank: int, n_space: int) -> tuple[int, int]:
    """(data index, space index) of ``rank``, JAX's device order."""
    return divmod(rank, n_space)


def local_rows(n_global: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n_global``."""
    if n_global % world:
        raise ValueError(f"a global batch of {n_global} does not split over {world} ranks")
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def check_stripes(height: int, n_space: int, output_stride: int) -> None:
    """Raise unless an image of ``height`` rows splits into ``n_space``
    equal stripes at every stride-2 stage down to ``output_stride``; the
    message names the heights that do."""
    unit = n_space * output_stride
    if height % unit:
        lo = max(unit, height // unit * unit)
        raise ValueError(
            f"an image of {height} rows does not split into {n_space} stripes at output "
            f"stride {output_stride}: the height must be a multiple of {unit} "
            f"(n_space x output stride), e.g. {lo} or {lo + unit}")


def local_stripe(height: int, s: int, n_space: int) -> slice:
    """Space index ``s``'s rows of ``height`` rows split into ``n_space``
    equal stripes."""
    if height % n_space:
        raise ValueError(f"{height} rows do not split into {n_space} stripes")
    per = height // n_space
    return slice(s * per, (s + 1) * per)
