"""The exchanges of the sharded samplers, on one process or many.

The JAX package shards its state over a mesh and lets XLA move it: a
``lax.ppermute`` exchanges the blocks of partner devices, and
``process_allgather`` brings a sharded array to every host. This module
does both for a mesh of cells (``parallel.mesh``):

- ``Layout``: which rows of a sharded state this process holds. Cell ``f``
  of the mesh (grid order) holds the global rows ``f * lanes`` to
  ``(f + 1) * lanes - 1``, and a process stacks the rows of its cells, in
  grid order, into one batch on its device. ``Layout.gather`` brings any
  number of such batches to the host as global arrays in one host read
  (``dist.all_gather`` when a process group exists).
- ``Exchange``: the partner rows of a permutation of cells, the counterpart
  of ``lax.ppermute``. A partner cell of the same process is an index into
  the batch (the R-row swap of ``mcmc.parallel``); one of another process
  is sent and received with ``dist.batch_isend_irecv``, one message each
  way between two processes, whatever the number of cells.
- ``deal_blocks``: the row blocks of a product dealt to a mesh's cells
  (the row-sharded GP products), each process computing its own cells'
  blocks; across processes one ``dist.all_gather`` brings the whole
  product to every process's device (``shard_map``'s row-sharded output,
  replicated).

The same code runs whether the mesh spans one process or many. A process
whose cells lie on more than one device is not supported (ROADMAP
A13(c)).
"""

from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from .mesh import process_info


def to_host(tensors):
    """Numpy copies of ``tensors`` with one host synchronisation: the
    copies from a card are issued without blocking, then the stream is
    synchronised once."""
    if not tensors:
        return []
    device = tensors[0].device
    if device.type != "cuda":
        return [t.numpy() for t in tensors]
    copies = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(device).synchronize()
    return [c.numpy() for c in copies]


class Layout:
    """The rows of a mesh's cells that this process holds.

    :param mesh: a ``parallel.mesh.Mesh``.
    :param lanes: rows a cell holds.
    :param owner: the class named in error messages.
    """

    def __init__(self, mesh, lanes: int, owner: str):
        self.rank, self.world = process_info()
        # gather through the process group whenever there is one
        self.grouped = dist.is_available() and dist.is_initialized()
        cells = mesh.cells()
        self.n_cells, self.lanes = len(cells), int(lanes)
        self.owners = [c.rank for c in cells]
        counts = Counter(self.owners)
        if set(counts) != set(range(self.world)) or len(set(counts.values())) != 1:
            raise ValueError(
                f"[ {owner} error ] every process of the group must hold the same number of "
                f"mesh cells, got {dict(sorted(counts.items()))} over {self.world} processes"
            )
        self.local = [f for f, c in enumerate(cells) if c.rank == self.rank]
        devices = {cells[f].device for f in self.local}
        if len(devices) != 1:
            raise NotImplementedError(
                f"[ {owner} error ] the cells of one process lie on {len(devices)} devices "
                f"({sorted(map(str, devices))}); cells of one process on several cards are "
                f"not supported yet (ROADMAP A13(c)). Run one process per card."
            )
        self.device = devices.pop()
        self.start = {f: i * self.lanes for i, f in enumerate(self.local)}
        lane = np.arange(self.lanes)
        self.rows = np.concatenate([f * self.lanes + lane for f in self.local])
        # the global rows in the order all_gather stacks the processes' batches
        order = np.concatenate([f * self.lanes + lane for q in range(self.world)
                                for f in range(self.n_cells) if self.owners[f] == q])
        self._order = None if np.array_equal(order, np.arange(order.size)) else order
        self.host_reads = 0

    @property
    def n_rows(self) -> int:
        return len(self.local) * self.lanes

    def gather(self, tensors, axis: int = 0):
        """Global numpy copies of local batches: each tensor's ``axis`` holds
        this process's rows, and its copy's holds every cell's
        (``n_cells * lanes``), in one host read."""
        gathered = []
        for t in tensors:
            t = t.movedim(axis, 0).contiguous()
            is_bool = t.dtype == torch.bool
            if is_bool:  # the backends' collectives take no bool
                t = t.to(torch.uint8)
            if self.grouped:
                parts = [torch.empty_like(t) for _ in range(self.world)]
                dist.all_gather(parts, t)
                t = torch.cat(parts)
            gathered.append((t, is_bool))
        host = to_host([t for t, _ in gathered])
        self.host_reads += 1
        out = []
        for h, (_, is_bool) in zip(host, gathered):
            if is_bool:
                h = h.astype(bool)
            if self._order is not None:
                g = np.empty_like(h)
                g[self._order] = h
                h = g
            out.append(np.ascontiguousarray(np.moveaxis(h, 0, axis)))
        return out

    def local_rows(self, global_array, axis: int = 0):
        """This process's rows of a global array (rows on ``axis``): the
        array itself when the process holds every row."""
        if self.rows.size == self.n_cells * self.lanes:
            return global_array
        return np.take(global_array, self.rows, axis=axis)


class Exchange:
    """The partner rows of a permutation of cells that pairs them off
    (``partner[partner[f]] == f``; a cell that is its own partner keeps its
    rows).

    ``gather`` indexes ``[own rows; rows received from each peer]`` to give
    each local row its partner's; ``has_partner`` flags the rows whose cell
    has one. A process sends a peer the rows of its cells whose partners
    that peer holds, in ascending cell order, and the peer files them by
    the same order: one message each way between two processes.
    """

    def __init__(self, layout: Layout, partner):
        L = layout.lanes
        lane = np.arange(L)
        K = layout.n_rows
        gather = np.arange(K)
        has = np.zeros(K, bool)
        sends, recvs = {}, {}
        for f in layout.local:
            g = int(partner[f])
            if g == f:
                continue
            own = layout.start[f]
            has[own:own + L] = True
            q = layout.owners[g]
            if q == layout.rank:
                gather[own:own + L] = layout.start[g] + lane
            else:
                sends.setdefault(q, []).append(f)
                recvs.setdefault(q, []).append(g)
        self.send, self.recv = [], []
        offset = K
        for q in sorted(recvs):
            for i, g in enumerate(sorted(recvs[q])):
                own = layout.start[int(partner[g])]
                gather[own:own + L] = offset + i * L + lane
            self.recv.append((q, len(recvs[q]) * L))
            offset += len(recvs[q]) * L
        for q in sorted(sends):
            rows = np.concatenate([layout.start[f] + lane for f in sorted(sends[q])])
            self.send.append((q, torch.as_tensor(rows, device=layout.device)))
        self.gather = torch.as_tensor(gather, device=layout.device)
        self.has_partner = torch.as_tensor(has, device=layout.device)
        self.local_only = not (self.send or self.recv)

    def __call__(self, data):
        """Each local row's partner row of ``data`` (``(K, ...)``, this
        process's batch)."""
        if self.local_only:
            return data[self.gather]
        ops, received = [], []
        for q, rows in self.send:
            ops.append(dist.P2POp(dist.isend, data[rows].contiguous(), q))
        for q, n in self.recv:
            buf = data.new_empty((n,) + tuple(data.shape[1:]))
            received.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, q))
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return torch.cat([data, *received])[self.gather]


def deal_blocks(cells, step: int, n: int, block_fn, home):
    """
    The row blocks of an ``n``-row product dealt to ``cells`` in turn
    (block ``b``, rows ``b * step`` on, to cell ``b % len(cells)``):
    ``block_fn(b, device)`` computes block b on its cell's device, for each
    block of this process's cells. Returns every block in order on
    ``home``. When the cells span processes, each process's blocks, in
    block order and padded to ``step`` rows and to the most blocks any
    process holds, travel in one ``dist.all_gather``, and the ragged last
    block is trimmed after; every process must hold a block.
    """
    rank, world = process_info()
    n_blocks = -(-n // step)
    owners = [cells[b % len(cells)].rank for b in range(n_blocks)]
    mine = {b: block_fn(b, cells[b % len(cells)].device).to(home)
            for b in range(n_blocks) if owners[b] == rank}
    if len(mine) == n_blocks:
        return torch.cat([mine[b] for b in range(n_blocks)])
    held = [[b for b, q in enumerate(owners) if q == p] for p in range(world)]
    if not all(held):
        raise ValueError(
            f"{n_blocks} row blocks leave a process of {world} without one; use "
            f"smaller blocks or fewer cells"
        )
    some = next(iter(mine.values()))
    local = some.new_zeros((max(map(len, held)) * step,) + tuple(some.shape[1:]))
    for j, b in enumerate(held[rank]):
        local[j * step:j * step + mine[b].shape[0]] = mine[b]
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    out = []
    for b, q in enumerate(owners):
        j = held[q].index(b)
        out.append(parts[q][j * step:j * step + min(step, n - b * step)])
    return torch.cat(out)
