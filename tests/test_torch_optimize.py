"""The port's BFGS batched over starts (inference_tpu_torch/utils/optimize.py)
against ``jax.scipy.optimize.minimize(method="BFGS")`` vmapped over the same
starts, in float64 on the CPU.

Tolerances: iterate for iterate (``maxiter`` 1, 3, 5) ``x`` and ``fun`` to
1e-10; whole runs on the SPD quadratic ``x`` to 1e-10 with equal ``nit`` and
``status``; on Rosenbrock equal ``status`` and ``x`` within 1e-6 (its
iterates stop where the line search fails, within gtol of each other); a
batched run equals one run per row exactly when the objective's arithmetic
does not depend on the batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.optimize import minimize

from inference_tpu_torch.utils import optimize
from inference_tpu_torch.utils.optimize import minimize_bfgs

N = 10  # the quadratic's dimension
STARTS = 8


@pytest.fixture(autouse=True)
def float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _quadratic():
    rng = np.random.default_rng(0)
    Q = rng.normal(size=(N, N))
    A = Q @ Q.T / N + np.eye(N)  # SPD, condition ~4
    b = rng.normal(size=N)
    x0 = rng.normal(size=(STARTS, N))
    At, bt = torch.tensor(A), torch.tensor(b)
    return (lambda x: 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x,
            lambda X: 0.5 * ((X @ At) * X).sum(dim=1) - X @ bt, x0)


def _rosenbrock():
    x0 = np.random.default_rng(1).normal(size=(STARTS, 2)) * 1.5
    return (lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
            lambda X: (1 - X[:, 0]) ** 2 + 100 * (X[:, 1] - X[:, 0] ** 2) ** 2, x0)


PROBLEMS = {"quadratic": _quadratic, "rosenbrock": _rosenbrock}


def _both(problem, **options):
    fj, ft, x0 = PROBLEMS[problem]()
    ref = jax.vmap(lambda z: minimize(fj, z, method="BFGS", options=options))(jnp.asarray(x0))
    got = minimize_bfgs(ft, torch.tensor(x0), **options)
    return ref, got


@pytest.mark.parametrize("maxiter", [1, 3, 5])
@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_iterate_for_iterate(problem, maxiter):
    ref, got = _both(problem, maxiter=maxiter)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(ref.fun), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(got.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(ref.nfev))


def test_quadratic_to_the_end():
    ref, got = _both("quadratic")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.jac.numpy(), np.asarray(ref.jac), rtol=0, atol=1e-10)
    assert (got.status.numpy() == 0).any()


def test_rosenbrock_to_the_end():
    ref, got = _both("rosenbrock")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-6)


def test_gtol_and_maxiter_options():
    """A looser gtol and a cap on the line search take JAX's meaning."""
    ref, got = _both("quadratic", gtol=1e-3, maxiter=40, line_search_maxiter=2)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)


def test_non_finite_region():
    """A start whose line search steps into the region where the objective
    is NaN ends with JAX's status, value and iterate; the other starts are
    untouched by it."""
    x0 = np.array([[3.5, 0.0], [0.0, 0.0], [-2.0, 1.0]])

    def fj(x):
        return jnp.sum((x - 3.0) ** 2) - jnp.log(4.0 - x[0])

    def ft(X):
        return ((X - 3.0) ** 2).sum(dim=1) - torch.log(4.0 - X[:, 0])

    ref = jax.vmap(lambda z: minimize(fj, z, method="BFGS"))(jnp.asarray(x0))
    got = minimize_bfgs(ft, torch.tensor(x0))
    assert int(ref.status[0]) >= 2  # the first start's line search failed there
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(ref.fun), rtol=1e-10)


def test_batched_run_equals_single_runs():
    """Rows are independent: with an objective evaluated row by row, the
    batched run equals one run per row bit for bit."""
    _, ft, x0 = _rosenbrock()

    def rowwise(X):
        return torch.stack([ft(X[r : r + 1])[0] for r in range(X.shape[0])])

    batched = minimize_bfgs(rowwise, torch.tensor(x0))
    for r in range(STARTS):
        single = minimize_bfgs(rowwise, torch.tensor(x0[r : r + 1]))
        for field in ("x", "fun", "jac", "nit", "status", "nfev"):
            assert torch.equal(getattr(batched, field)[r], getattr(single, field)[0]), field


def test_host_reads_at_the_stated_cadence():
    """The loop reads the done flags once every CHECK_EVERY rounds and the
    process counters add them up."""
    before = dict(optimize.COUNTS)
    _, got = _both("quadratic")
    assert got.rounds == optimize.CHECK_EVERY * got.host_reads
    assert got.rounds >= int(got.nfev.max()) - 1
    assert optimize.COUNTS["host_reads"] - before["host_reads"] == got.host_reads
    assert optimize.COUNTS["rounds"] - before["rounds"] == got.rounds


def test_float32_follows_float64():
    """In float32 the run keeps JAX's float32 constants and ends near the
    float64 minimiser of the quadratic."""
    _, ft, x0 = _quadratic()
    rng = np.random.default_rng(0)
    Q = rng.normal(size=(N, N))
    A = torch.tensor(Q @ Q.T / N + np.eye(N), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=N), dtype=torch.float32)
    got = minimize_bfgs(lambda X: 0.5 * ((X @ A) * X).sum(dim=1) - X @ b,
                        torch.tensor(x0, dtype=torch.float32))
    assert got.x.dtype == torch.float32 and torch.isfinite(got.x).all()
    best = minimize_bfgs(ft, torch.tensor(x0)).x.numpy()
    assert np.abs(got.x.numpy() - best).max() < 1e-3
