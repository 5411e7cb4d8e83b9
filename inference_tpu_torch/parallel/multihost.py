"""Multi-process scale-out helpers.

Port of ``inference_tpu.parallel.multihost``. JAX joins hosts into one
multi-controller system with ``jax.distributed.initialize``; PyTorch runs
one process per device and joins them with ``torch.distributed``
(``torchrun`` starts such processes and sets their environment). Every
process runs the same program. ``initialize_multihost`` creates the
process group (NCCL between cards, gloo between CPU processes), and the
global meshes lay the cells of every process out as the JAX helpers lay
out devices: chains across the whole system, rungs on contiguous cells,
within one process where they fit, so that swaps stay inside it.

``cells_per_process`` plays the part of a host's local device count: each
process holds that many cells of the global meshes on its own device, and
the samplers advance them as one batch.
"""

from datetime import timedelta
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, cell_grid, local_device, process_cells, process_info

# this process's device and cells, set by initialize_multihost
_PROCESS = {"device": "cuda", "cells": 1}


def initialize_multihost(
    coordinator_address: str = None,
    num_processes: int = None,
    process_id: int = None,
    *,
    cells_per_process: int = 1,
    device="cuda",
    timeout: float = None,
):
    """
    Join this process into a process group. With ``coordinator_address``
    ("host:port" of process 0) it initialises from ``tcp://`` with
    ``num_processes`` and this process's ``process_id``; with no arguments
    from the ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``).

    The process's device is ``device`` (default the card: ``cuda:LOCAL_RANK``,
    or ``cuda:process_id`` modulo the cards without ``LOCAL_RANK``; raises
    without a card), and the backend NCCL on a card, gloo on the CPU.
    ``cells_per_process`` is how many cells of the global meshes each process
    holds; ``timeout`` (seconds) bounds the group's collectives.

    Call once, on every process, before building a mesh. Returns the JAX
    helper's dict: process_id, n_processes, local_devices (this process's
    cells) and global_devices (all cells).
    """
    if coordinator_address is not None:
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                    rank=int(process_id))
        rank = int(process_id)
    else:
        init = dict(init_method="env://")
        rank = int(os.environ.get("RANK", 0))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank % torch.cuda.device_count())
    device = local_device(device, "initialize_multihost")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if timeout is not None:
        init["timeout"] = timedelta(seconds=float(timeout))
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, **init)
    _PROCESS.update(device=device, cells=int(cells_per_process))
    rank, world = process_info()
    return {
        "process_id": rank,
        "n_processes": world,
        "local_devices": _PROCESS["cells"],
        "global_devices": world * _PROCESS["cells"],
    }


def _global_cells(owner, device, cells_per_process):
    _, world = process_info()
    per = _PROCESS["cells"] if cells_per_process is None else int(cells_per_process)
    return process_cells(world * per, _PROCESS["device"] if device is None else device, owner)


def global_chain_mesh(axis_name: str = "chains", *, device=None,
                      cells_per_process: int = None) -> Mesh:
    """A 1D mesh over every cell of every process: shard chain batches
    across the whole system (chains are independent, so the cross-process
    axis carries no traffic while they sample). ``device`` and
    ``cells_per_process`` default to ``initialize_multihost``'s (the card,
    one cell, without it)."""
    cells = _global_cells("global_chain_mesh", device, cells_per_process)
    return Mesh(cell_grid(cells, (len(cells),)), (axis_name,))


def global_tempering_mesh(n_rungs: int, *, device=None, cells_per_process: int = None) -> Mesh:
    """
    A ('rungs', 'chains') mesh over every cell of every process, with the
    rung axis laid out along contiguous cells (within one process where
    possible) so that swap exchanges stay inside a process. ``device`` and
    ``cells_per_process`` as in ``global_chain_mesh``.
    """
    cells = _global_cells("global_tempering_mesh", device, cells_per_process)
    n = len(cells)
    if n % n_rungs != 0:
        raise ValueError(
            f"n_rungs ({n_rungs}) must divide the global device count ({n})"
        )
    # the cells are process-major: reshaping chains-major puts consecutive
    # rungs on consecutive cells of the same process
    return Mesh(cell_grid(cells, (n // n_rungs, n_rungs)).T.copy(), ("rungs", "chains"))
