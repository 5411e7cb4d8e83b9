"""The matrix-free GP's solvers of the PyTorch port (``ops.solvers``: ``cg``,
``mixed_pcg``, ``pcg_multi``) against the JAX package's (``jax.scipy``'s
``cg``, ``inference_tpu.ops.solvers``), on the CPU, in float64, on a shared
dense SPD operator (condition 8), with and without a Jacobi-like
preconditioner, converged (tol 1e-10) and stopped at ``maxiter``.

The operator is well conditioned on purpose: on a GP kernel matrix (200
points, condition 60) the two packages' iterates, the same arithmetic
summed in other orders, part by 1e-8 relative after 20 iterations before
they converge together again, so where a solve stops would be decided by
rounding, not by the stopping rule. Here they agree to 1e-15 throughout.

Tolerances, with reasons: solutions within 1e-10 relative to their largest
entry; ``info`` and the iteration counts equal, since a different count
would make every other tolerance meaningless. The JAX ``cg`` returns no
count, so its operator counts its calls by a host callback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import cg as jax_cg

from inference_tpu.ops import solvers as jsolvers
from inference_tpu_torch.ops import solvers

N = 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    """A (N, N) SPD operator with eigenvalues log-uniform on [1, 8], a
    right-hand side, a block of three and the diagonal of a preconditioner
    (the inverse diagonal of A, perturbed so that it is not exactly
    Jacobi)."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    A = (Q * np.exp(rng.uniform(0.0, np.log(8.0), N))) @ Q.T
    A = 0.5 * (A + A.T)
    minv = rng.uniform(0.8, 1.2, N) / np.diag(A)
    return A, rng.normal(size=N), rng.normal(size=(N, 3)), minv


def _ops(system, precond):
    """The operator and preconditioner of each package, or None."""
    A, _, _, minv = system
    At, mt, Aj, mj = torch.as_tensor(A), torch.as_tensor(minv), jnp.asarray(A), jnp.asarray(minv)
    port = (lambda v: At @ v, (lambda v: (mt * v.T).T) if precond else None)
    ref = (lambda v: Aj @ v, (lambda v: (mj * v.T).T) if precond else None)
    return port, ref


def _close(got, ref, tol=1e-10):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "preconditioned"])
@pytest.mark.parametrize("stop", ["converged", "maxiter"])
def test_cg_matches_jax_scipy_cg(system, precond, stop):
    (mv, M), (mv_j, M_j) = _ops(system, precond)
    b = system[1]
    maxiter = 7 if stop == "maxiter" else None
    x, k = solvers.cg(mv, torch.as_tensor(b), M=M, tol=1e-10, maxiter=maxiter)
    x_j, _ = jax_cg(mv_j, jnp.asarray(b), M=M_j, tol=1e-10, maxiter=maxiter)
    _close(x, x_j)
    if stop == "maxiter":
        assert k == 7
        return
    assert 10 < k < 10 * N
    # JAX's loop ran k iterations too: its operator, counted by a host
    # callback, runs once for the first residual and once an iteration
    calls = []

    def counted(v):
        jax.debug.callback(lambda: calls.append(1))
        return mv_j(v)

    jax_cg(counted, jnp.asarray(b), M=M_j, tol=1e-10)[0].block_until_ready()
    assert len(calls) - 1 == k
    res = np.linalg.norm(system[0] @ x.numpy() - b) / np.linalg.norm(b)
    assert res <= 1e-10


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "preconditioned"])
@pytest.mark.parametrize("stop", ["converged", "maxiter"])
def test_mixed_pcg_matches_jax(system, precond, stop):
    """Restarts every 5 iterations, so either solve passes several."""
    (mv, M), (mv_j, M_j) = _ops(system, precond)
    b = system[1]
    maxiter = 7 if stop == "maxiter" else 2000
    x, info = solvers.mixed_pcg(mv, torch.as_tensor(b), M=M, tol=1e-10, maxiter=maxiter,
                                restart_every=5)
    x_j, info_j = jsolvers.mixed_pcg(mv_j, jnp.asarray(b), M=M_j, tol=1e-10, maxiter=maxiter,
                                     restart_every=5)
    _close(x, x_j)
    assert info == int(info_j) == (7 if stop == "maxiter" else 0)


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "preconditioned"])
@pytest.mark.parametrize("stop", ["converged", "maxiter"])
def test_pcg_multi_matches_jax(system, precond, stop):
    """Three right-hand sides and a zero column (frozen from the start);
    restarts every 5 iterations."""
    (mv, M), (mv_j, M_j) = _ops(system, precond)
    B = np.concatenate([system[2], np.zeros((N, 1))], axis=1)
    maxiter = 7 if stop == "maxiter" else 2000
    X, i = solvers.pcg_multi(mv, torch.as_tensor(B), M=M, tol=1e-10, maxiter=maxiter,
                             restart_every=5)
    X_j, i_j = jsolvers.pcg_multi(mv_j, jnp.asarray(B), M=M_j, tol=1e-10, maxiter=maxiter,
                                  restart_every=5)
    _close(X, X_j)
    assert i == int(i_j)
    assert (i == 7) if stop == "maxiter" else (i < 2000)
    assert not X[:, 3].any()
