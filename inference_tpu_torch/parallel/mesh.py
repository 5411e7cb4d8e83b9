"""Device meshes for sharded sampling.

Port of ``inference_tpu.parallel.mesh``. A JAX mesh is a grid of devices;
PyTorch runs one process per device under ``torch.distributed`` (what
``torchrun`` starts), and one process may hold many mesh cells. A cell
here names the process that holds it and that process's device
(``Cell(rank, device)``), and a ``Mesh`` is a grid of cells with named
axes, with the surface the samplers read: ``mesh.shape[name]``,
``mesh.axis_names``, ``mesh.devices`` and ``mesh.size``.

The cells of the mesh helpers are ordered process-major, as
``jax.devices()`` orders devices host-major: process 0's cells first.
``n_devices`` counts cells, by default one per process (one without a
process group); a multiple of the process count puts ``n_devices / world``
cells on each process's device. The cells of one process on one device are
slots: the samplers advance them as one batch. Built inside a process
group, a mesh is a collective: every process builds it, and each learns
the others' devices from one ``all_gather_object``.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


class Cell(NamedTuple):
    """One mesh cell: the rank of the process that holds it and that
    process's device."""

    rank: int
    device: torch.device


class Mesh:
    """A grid of ``Cell``s with named axes.

    :param devices: an object array of ``Cell`` (``cell_grid``) with one
        dimension per axis name.
    :param axis_names: one name per grid axis.
    """

    def __init__(self, devices, axis_names):
        if not isinstance(devices, np.ndarray) or devices.ndim != len(axis_names):
            raise ValueError(
                f"a mesh with axes {tuple(axis_names)} needs an object array of cells with "
                f"as many dimensions (cell_grid)"
            )
        self.devices = cell_grid([Cell(int(c[0]), torch.device(c[1]))
                                  for c in devices.reshape(-1)], devices.shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def cells(self):
        """The cells in grid order (row-major)."""
        return list(self.devices.reshape(-1))


def cell_grid(cells, shape):
    """An object array of ``shape`` holding ``cells`` in row-major order
    (numpy would unpack the tuples of a plain ``np.array``)."""
    grid = np.empty(len(cells), dtype=object)
    for i, cell in enumerate(cells):
        grid[i] = cell
    return grid.reshape(shape)


def process_info():
    """``(rank, world)`` of this process: (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device, owner: str) -> torch.device:
    """``device`` resolved for this process: ``resolve_device`` (no card
    raises), and a CUDA device without an index takes the current one."""
    device = resolve_device(device, owner)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def process_cells(n_devices, device, owner: str):
    """The cells of an ``n_devices``-cell mesh, process-major: each process
    holds ``n_devices / world`` cells on its own ``device``."""
    rank, world = process_info()
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n % world != 0:
        raise ValueError(
            f"[ {owner} error ] n_devices ({n}) must be a positive multiple of the "
            f"process count ({world}): each process holds n_devices / {world} cells"
        )
    mine = local_device(device, owner)
    if world > 1:
        names = [None] * world
        dist.all_gather_object(names, str(mine))
        devices = [torch.device(d) for d in names]
    else:
        devices = [mine]
    per = n // world
    return [Cell(r, devices[r]) for r in range(world) for _ in range(per)]


def chain_mesh(n_devices: int = None, axis_name: str = "chains", device="cuda") -> Mesh:
    """A 1D mesh of ``n_devices`` cells for chain-batch sharding (by default
    one per process), each process's on its ``device``."""
    cells = process_cells(n_devices, device, "chain_mesh")
    return Mesh(cell_grid(cells, (len(cells),)), (axis_name,))


def tempering_mesh(n_rungs: int, n_devices: int = None, device="cuda") -> Mesh:
    """
    A 2D ('rungs', 'chains') mesh: temperature rungs on the first axis (the
    swap exchanges run along it), independent chains on the second.
    """
    cells = process_cells(n_devices, device, "tempering_mesh")
    n = len(cells)
    if n % n_rungs != 0:
        raise ValueError(
            f"n_rungs ({n_rungs}) must divide the device count ({n})"
        )
    return Mesh(cell_grid(cells, (n_rungs, n // n_rungs)), ("rungs", "chains"))
