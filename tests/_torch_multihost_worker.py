"""Worker process of tests/test_torch_multihost.py: one of two gloo
processes on the CPU, each holding 4 cells of the port's meshes (2 of the
GP's 4-cell mesh).

Run as:  python _torch_multihost_worker.py <coordinator host:port> <n_procs> <proc_id> <out_dir>

Writes ``<out_dir>/rank<proc_id>.npz`` with what it measured, then
destroys its process group. ``swap_scenario`` and ``gp_scenario`` are also
run by the parent test in one process, on the same inputs.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TEMPS = [1.0, 2.0, 4.0, 8.0]
START = np.array([1.0, -1.0])


def gauss2(t):
    return -0.5 * (t * t).sum()


def swap_scenario(st):
    """Both swap phases of ``st`` (4 rungs x 4 lanes) on a scattered state
    and a fixed uniform table, the same in any process layout: the
    gathered state and flags after each phase."""
    from inference_tpu_torch.parallel._kinds import positions_of

    state = st.global_state()
    rng = np.random.default_rng(0)
    theta = torch.as_tensor(START + rng.normal(0, 2.0, size=tuple(state.theta.shape)))
    logp = torch.func.vmap(gauss2)(theta) * state.inv_temp
    st.set_global_state(state._replace(theta=theta, logp=logp))
    out = {}
    for phase in (0, 1):
        table = torch.as_tensor(rng.uniform(size=(st.n_rungs * st.n_chains,)))
        st._state, accept = st._swap(st._state, phase, st._layout.local_rows(table))
        flags, pos, lp = st._layout.gather([accept, *positions_of(st._state)])
        out.update({f"flags{phase}": flags, f"theta{phase}": pos, f"logp{phase}": lp})
    return out


def gp_scenario(mesh):
    """The row-sharded GP products on ``mesh``'s first axis (4 cells):
    ``sqexp_matmat_df64_sharded`` at n = 512, q = 3; ``LargeScaleGP`` in the
    df64 tier and in the cg tier (500 points in 6 row blocks of 96, so the
    processes hold 4 and 2 blocks, the last ragged); the df64
    ``LargeScaleGpLinearInverter``. Their outputs, float64 on the CPU."""
    from inference_tpu_torch.gp import LargeScaleGP, LargeScaleGpLinearInverter
    from inference_tpu_torch.ops import df64

    rng = np.random.default_rng(2)
    x = rng.uniform(0, 8, size=(512, 2))
    uh, ul = (torch.as_tensor(a) for a in df64.split_f64(x))
    V = torch.as_tensor(rng.normal(size=(512, 3)), dtype=torch.float32)
    out = {"matmat": df64.sqexp_matmat_df64_sharded(uh, ul, V, mesh).numpy()}
    y = np.sin(x[:500, 0]) * np.cos(0.5 * x[:500, 1])
    q = rng.uniform(1, 7, size=(16, 2))
    kw = dict(hyperpars=[0.0, 0.0, 0.0], preconditioner_rank=64, mesh=mesh, device="cpu")
    gp = LargeScaleGP(x[:500], y, np.full(500, 0.01), solver="df64", block_size=128,
                      cg_tol=1e-9, cg_maxiter=3000, **kw)
    out["df64_means"], out["df64_var"] = gp(q, with_variance=True)
    out["df64_residual"] = gp.residual_norm_f64()
    gp = LargeScaleGP(x[:500], y, np.full(500, 0.1), solver="cg", block_size=96, cg_tol=1e-6,
                      **kw)
    out["cg_means"] = gp(q)
    centres = rng.uniform(0, 8, size=(40, 2))
    A = np.exp(-0.5 * ((centres[:, None, :] - x[None, :, :]) ** 2).sum(-1) / 0.5)
    A /= A.sum(axis=1, keepdims=True)
    inv = LargeScaleGpLinearInverter(A @ np.sin(x[:, 0]), np.full(40, 0.05), A, x,
                                     [0.0, 0.0, 0.0], block_size=128, solver="df64",
                                     cg_tol=1e-10, mesh=mesh, device="cpu")
    out["inv_mean"] = inv.calculate_posterior_mean()
    return out


def main():
    coordinator, n_procs, proc_id, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    torch.set_default_dtype(torch.float64)
    import torch.distributed as dist
    from inference_tpu_torch.parallel import (ChainArray, ShardedTempering, global_chain_mesh,
                                              global_tempering_mesh, initialize_multihost,
                                              tempering_mesh)

    info = initialize_multihost(coordinator, n_procs, proc_id, cells_per_process=4, device="cpu",
                                timeout=60)
    out = {f"info_{k}": v for k, v in info.items()}

    # the gather: every cell of the global chain mesh holds its own rows
    mesh = global_chain_mesh()
    from inference_tpu_torch.parallel._collectives import Layout

    layout = Layout(mesh, 2, "test")
    out["gathered"] = layout.gather([torch.as_tensor(layout.rows, dtype=torch.float64)])[0]
    out["tempering_col_procs"] = [len({c.rank for c in global_tempering_mesh(4).devices[:, j]})
                                  for j in range(2)]

    # the swaps across the process boundary: rungs 0-1 on process 0, 2-3
    # on process 1, so phase 1's pair (1, 2) crosses it
    st = ShardedTempering(gauss2, START, TEMPS, 4, tempering_mesh(4, 8, device="cpu"),
                          steps=5, epsilon=0.25, seed=3)
    out.update({f"swap_{k}": v for k, v in swap_scenario(st).items()})

    # a short run across both processes, then a checkpoint restored into a
    # fresh instance
    accepted = st.advance(40, swap_interval=5)
    out["advance_rate"] = accepted.mean()
    out["advance_theta"] = st.theta
    out["advance_logp"] = st.logp
    out["advance_history"] = np.concatenate(st._history)
    out["advance_successful"] = st.successful_swaps
    ckpt = os.path.join(out_dir, f"st{proc_id}.npz")
    st.save(ckpt)
    st2 = ShardedTempering(gauss2, START, TEMPS, 4, tempering_mesh(4, 8, device="cpu"),
                           steps=5, epsilon=0.25, seed=99)
    st2.restore(ckpt)
    out["restored_theta"] = st2.theta
    out["restored_phase"] = st2._phase
    st2.advance(10, swap_interval=5)
    out["restored_logp"] = st2.logp

    # ChainArray over the global chain mesh: 16 chains, 2 a cell
    starts = np.tile(START, (16, 1))
    ca = ChainArray("gibbs", gauss2, starts, mesh=mesh, seed=7, retry=False)
    ca.advance(64)
    out["ca_history"] = np.concatenate(ca._history)
    out["ca_theta"] = ca.theta
    out["ca_rhat"] = ca.rhat(burn=16)
    ca.save(os.path.join(out_dir, f"ca{proc_id}.npz"))
    ca2 = ChainArray("gibbs", gauss2, starts, mesh=mesh, seed=8, retry=False)
    ca2.restore(os.path.join(out_dir, f"ca{proc_id}.npz"))
    out["ca_restored_theta"] = ca2.theta
    out["ca_local_rows"] = ca._layout.rows

    # the GP across the processes: 4 cells, 2 a process
    gp_mesh = global_chain_mesh(cells_per_process=2)
    out["gp_cell_ranks"] = [c.rank for c in gp_mesh.cells()]
    out.update({f"gp_{k}": v for k, v in gp_scenario(gp_mesh).items()})

    np.savez(os.path.join(out_dir, f"rank{proc_id}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
