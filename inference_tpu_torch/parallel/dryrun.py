"""The multi-device dry run of the port.

Port of ``__graft_entry__.dryrun_multichip`` (its ``_dryrun_body``): on an
``n_devices``-cell mesh, a (rungs, chains) ``ShardedTempering`` advance of
HMC rungs on the flagship posterior, then the sharded df64
``LargeScaleGP`` solve at n = 128 per cell, whose products run kernel B4
on every cell's block of rows. The JAX dry run provisions virtual CPU
devices when it lacks devices; here the cells of one process are slots,
and a card may hold several of them only when the caller says so.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from .mesh import Cell, Mesh, cell_grid, process_info
from .tempering import ShardedTempering


def flagship_posterior(n_dim: int = 10, device="cpu", dtype=None):
    """The JAX dry run's correlated Gaussian log-density (the headline HMC
    target), its inverse covariance on ``device``."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(n_dim, n_dim)) / np.sqrt(n_dim)
    cov = A @ A.T + np.eye(n_dim)
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=dtype or torch.get_default_dtype(),
                           device=device)

    def logp(t):
        return -0.5 * t @ icov @ t

    return logp


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """
    Drive the sharded paths on an ``n_devices``-cell mesh of this process
    and check them: the tempering advance (finite positions of the mesh's
    shape) and the sharded df64 solve (FP64 residual below 1e-6, finite
    means). The cells lie on ``devices`` (one per cell, a card may repeat),
    by default one per card of ``device``'s type: with fewer cards than
    cells it raises unless ``devices`` is given. Cells of one process on
    several cards are ROADMAP A13(c). Returns the readings.
    """
    from ..gp import LargeScaleGP

    device = resolve_device(device, "dryrun_multichip")
    if devices is None:
        available = torch.cuda.device_count() if device.type == "cuda" else 1
        if available < n_devices:
            raise ValueError(
                f"[ dryrun_multichip error ] {n_devices} cells need as many "
                f"{device.type} devices, found {available}; pass devices= (a list of "
                f"{n_devices}, which may repeat a device) to put several cells on one."
            )
        devices = [torch.device("cuda", i) for i in range(n_devices)] \
            if device.type == "cuda" else [device] * n_devices
    devices = [resolve_device(d, "dryrun_multichip") for d in devices]
    if len(devices) != n_devices:
        raise ValueError(
            f"[ dryrun_multichip error ] devices names {len(devices)} cells, not {n_devices}."
        )
    rank, _ = process_info()
    cells = [Cell(rank, d) for d in devices]

    # factor the cell count into a (rungs, chains) grid, as the JAX dry run
    n_rungs = next(r for r in (4, 2, n_devices) if n_devices % r == 0)
    n_chain_shards = n_devices // n_rungs
    mesh = Mesh(cell_grid(cells, (n_rungs, n_chain_shards)), ("rungs", "chains"))
    st = ShardedTempering(
        posterior=flagship_posterior(4, devices[0]),
        start=np.zeros(4),
        temperatures=np.geomspace(1.0, 30.0, n_rungs),
        n_chains=2 * n_chain_shards,
        mesh=mesh,
        steps=5,
        epsilon=0.2,
        seed=0,
    )
    accepted = st.advance(10, swap_interval=5)
    positions = st.theta
    if positions.shape != (n_rungs, 2 * n_chain_shards, 4) or not np.isfinite(st.logp).all():
        raise RuntimeError(
            f"dryrun_multichip: tempering positions {positions.shape}, finite logp "
            f"{bool(np.isfinite(st.logp).all())}"
        )
    print(f"dryrun_multichip OK: mesh {dict(mesh.shape)}, {accepted.shape[0]} swap phases, "
          f"swap accept rate {accepted.mean():.2f}")

    # the sharded df64 solve: 128 rows a cell, B4 on each cell's rows
    gp_mesh = Mesh(cell_grid(cells, (n_devices,)), ("chains",))
    n = 128 * n_devices
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 8, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(0.5 * x[:, 1])
    gp = LargeScaleGP(x, y, np.full(n, 0.05), hyperpars=np.array([0.0, 0.0, 0.0]),
                      block_size=128, preconditioner_rank=64, solver="df64", cg_tol=1e-8,
                      mesh=gp_mesh, device=devices[0])
    resid = gp.residual_norm_f64(residual_backend="host")
    mu = gp(x[:8])
    if not np.isfinite(mu).all() or not resid < 1e-6:
        raise RuntimeError(f"dryrun_multichip: sharded df64 solve residual {resid}")
    print(f"dryrun_multichip OK: sharded df64 GP solve n={n} over {n_devices} cells, "
          f"f64 residual {resid:.2e}")
    return {"mesh": dict(mesh.shape), "swap_phases": int(accepted.shape[0]),
            "swap_rate": float(accepted.mean()), "gp_n": n, "residual": float(resid)}
