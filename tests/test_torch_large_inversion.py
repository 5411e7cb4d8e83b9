"""``LargeScaleGpLinearInverter`` of the PyTorch port against the JAX
package and against dense float64 truth, on the CPU, in float64 (kernels
B2-B8 run their plain versions there).

Problems: tests/gp/test_GpLinearInverter.py's local-averaging model (M = 60
data of N = 200 parameters on [0, 10]^2, weights exp(-d^2 / (2 * 0.5))
normalised per row, truth sin x0 cos(x1 / 2), y_err 0.05) for the cg and
mixed tiers and ``fit()``; its df64 problem (M = 96, N = 256 on [0, 6]^2,
A normal / sqrt(N), y_err 1e-3) for the df64 tier against the dense FP64
posterior.

Tolerances, with reasons: z, means, variances and ``predict_data`` 1e-8
relative to their largest entry for cg and mixed (both packages solve to
``cg_tol`` 1e-12, where their iterates agree to about 1e-12); the df64
tier's means 1e-8 relative and variances 1e-8 absolute against the dense
FP64 truth (the JAX test's variance bound; its pair arithmetic held the
means only to 1e-6, FP64 holds them to 1e-8); ``fit()``'s theta after 3
steps 1e-6 (inner solves to 1e-10, as in test_torch_large_scale_cg.py);
a converted instance's means 1e-10 (1e-8 from the JAX df64 tier, whose
mean contraction runs in pair arithmetic).
"""

import numpy as np
import pytest
import torch

from inference_tpu.gp import LargeScaleGpLinearInverter as JaxInverter
from inference_tpu.gp import RationalQuadratic as JaxRationalQuadratic
from inference_tpu.gp import SquaredExponential as JaxSquaredExponential
from inference_tpu.gp import WhiteNoise as JaxWhiteNoise
from inference_tpu_torch import convert
from inference_tpu_torch.parallel import chain_mesh
from inference_tpu_torch.parallel.mesh import Cell, Mesh, cell_grid
from inference_tpu_torch.gp import (
    LargeScaleGpLinearInverter,
    RationalQuadratic,
    SquaredExponential,
    WhiteNoise,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_float64():
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def averaging_problem(m=60, n=200, seed=5, err=0.05):
    """tests/gp/test_GpLinearInverter.py's local-averaging forward model."""
    rng = np.random.default_rng(seed)
    xp = rng.uniform(0, 10, size=(n, 2))
    truth = np.sin(xp[:, 0]) * np.cos(0.5 * xp[:, 1])
    centres = rng.uniform(0, 10, size=(m, 2))
    A = np.exp(-0.5 * ((centres[:, None, :] - xp[None, :, :]) ** 2).sum(-1) / 0.5)
    A /= A.sum(axis=1, keepdims=True)
    y = A @ truth + rng.normal(0, err, m)
    return y, np.full(m, err), A, xp


def random_problem(err=1e-3):
    """tests/gp/test_GpLinearInverter.py's df64 problem."""
    rng = np.random.default_rng(11)
    xp = rng.uniform(0, 6, size=(256, 2))
    A = rng.normal(size=(96, 256)) / np.sqrt(256)
    truth = np.sin(xp[:, 0]) * np.cos(0.5 * xp[:, 1])
    return A @ truth + 1e-3 * rng.normal(size=96), np.full(96, err), A, xp


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


KERNELS = {
    "se": (lambda: SquaredExponential, lambda: JaxSquaredExponential, [0.0, 0.3, 0.3]),
    "rq": (lambda: RationalQuadratic, lambda: JaxRationalQuadratic, [0.0, 0.5, 0.3, 0.3]),
    "se+wn": (lambda: SquaredExponential() + WhiteNoise(),
              lambda: JaxSquaredExponential() + JaxWhiteNoise(), [0.0, 0.3, 0.3, np.log(0.1)]),
}
CASES = [("cg", "se"), ("mixed", "se"), ("cg", "rq"), ("mixed", "se+wn")]
IDX = np.arange(0, 200, 29)


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def pair(request):
    solver, kernel = request.param
    port_k, jax_k, theta = KERNELS[kernel]
    y, err, A, xp = averaging_problem()
    kw = dict(block_size=128, solver=solver, cg_tol=1e-12, cg_maxiter=4000, dtype="float64",
              prior_mean=0.1)
    return {"jax": JaxInverter(y, err, A, xp, theta, kernel=jax_k(), **kw),
            "port": LargeScaleGpLinearInverter(y, err, A, xp, theta, kernel=port_k(),
                                               device="cpu", **kw)}


def test_solution_and_mean_match_jax(pair):
    port, ref = pair["port"], pair["jax"]
    assert port.z.dtype == torch.float64 and port.z64.shape == (60,)
    assert _rel(port.z64, ref.z) <= 1e-8
    mean = port.calculate_posterior_mean()
    assert mean.shape == (200,) and port.calculate_posterior_mean() is mean
    assert _rel(mean, ref.calculate_posterior_mean()) <= 1e-8
    assert _rel(port.predict_data(), ref.predict_data()) <= 1e-8
    assert port.residual_norm() <= 1e-11


def test_variances_match_jax(pair):
    var = pair["port"].posterior_variances(IDX)
    ref = np.asarray(pair["jax"].posterior_variances(IDX))
    assert var.shape == (len(IDX),) and (var > 0).all()
    assert _rel(var, ref) <= 1e-8


def test_cg_tier_counts_its_iterations(pair):
    port = pair["port"]
    if port.solver == "cg":
        assert 0 < port.cg_iterations_estimate < 4000
    else:
        assert port.cg_iterations_estimate is None


# --------------------------------------------------------------------- #
# the df64 tier against the dense FP64 truth
# --------------------------------------------------------------------- #
def dense_truth(err):
    y, err, A, xp = random_problem(err)
    K = np.exp(-0.5 * ((xp[:, None, :] - xp[None, :, :]) ** 2).sum(-1))
    S = A @ K @ A.T + np.diag(err**2)
    mean = K @ A.T @ np.linalg.solve(S, y)
    cov = K - K @ A.T @ np.linalg.solve(S, A @ K)
    return (y, err, A, xp), mean, np.diag(cov)


@pytest.mark.parametrize("store_entries, err", [("auto", 1e-3), (False, 1e-2)])
def test_df64_tier_matches_dense_truth(store_entries, err):
    """``"auto"`` (the FP64 store, B5 then B6) at the JAX test's y_err 1e-3,
    and ``False`` (the fused B3/B4, whose plain version evaluates every
    entry in every product) at 1e-2, which needs fewer iterations: the mean
    field, variances at every 37th parameter, the data-space residual and
    the forward-modelled data."""
    (y, err, A, xp), mean_ref, var_ref = dense_truth(err)
    inv = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], block_size=128,
                                     solver="df64", cg_tol=1e-10, cg_maxiter=4000,
                                     store_entries=store_entries, device="cpu")
    assert (inv._entries is not None) == (store_entries == "auto") and inv._entries_f32 is None
    assert inv.residual_norm_f64() <= 1e-9 and inv.residual_norm() == inv.residual_norm_f64()
    mean = inv.calculate_posterior_mean()
    assert _rel(mean, mean_ref) <= 1e-8
    idx = np.arange(0, 256, 37)
    assert np.abs(inv.posterior_variances(idx) - var_ref[idx]).max() <= 1e-8
    assert _rel(inv.predict_data(), A @ mean_ref) <= 1e-8


def test_df64_f32_store_is_an_explicit_opt_in():
    """``"f32"`` iterates on the float32 store (B7, B8) with fused
    refreshes; at y_err = 0.05, above its 2^-24 quantisation, it reaches the
    df64 residual and the FP64 tier's mean to 1e-7."""
    y, err, A, xp = random_problem(0.05)
    kw = dict(block_size=128, solver="df64", cg_tol=1e-10, cg_maxiter=4000, device="cpu")
    f32 = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], store_entries="f32", **kw)
    auto = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], **kw)
    assert f32._entries_f32 is not None and f32._entries is None and auto._entries_f32 is None
    assert f32.residual_norm_f64() <= 1e-9
    assert _rel(f32.calculate_posterior_mean(), auto.calculate_posterior_mean()) <= 1e-7


# --------------------------------------------------------------------- #
# fit()
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("solver", ["cg", "df64"])
def test_fit_matches_jax(solver):
    """Three Adam steps from tests/gp/test_GpLinearInverter.py's poor
    theta [1.5, 1.5, 1.5] with the same seed and probes (M = 30, N = 100):
    theta within 1e-6 of the JAX package's; the instance does not change.
    The fit runs through the kernel rows in the working dtype whatever the
    tier, in both packages, so the JAX reference is its float64 cg-tier
    instance (its df64 tier's pair kernels would only lengthen the test)."""
    y, err, A, xp = averaging_problem(m=30, n=100)
    kw = dict(block_size=128, dtype="float64", cg_tol=1e-8)
    fit = dict(n_steps=3, learning_rate=0.1, n_probes=8, seed=0, fit_tol=1e-10,
               fit_maxiter=4000)
    theta0 = np.array([1.5, 1.5, 1.5])
    port = LargeScaleGpLinearInverter(y, err, A, xp, theta0, solver=solver, device="cpu", **kw)
    assert port._A.dtype == torch.float64
    z = port.z64.copy()
    theta = port.fit(**fit)
    theta_jax = JaxInverter(y, err, A, xp, theta0, **kw).fit(**fit)
    assert isinstance(theta, np.ndarray) and np.abs(theta - theta0).max() > 0.1
    assert np.abs(theta - theta_jax).max() <= 1e-6
    np.testing.assert_array_equal(port.hyperpars, theta0)
    np.testing.assert_array_equal(port.z64, z)


def test_fit_warns_once_on_a_biased_step(recwarn):
    y, err, A, xp = averaging_problem()
    inv = LargeScaleGpLinearInverter(y, err, A, xp, [1.5, 1.5, 1.5], block_size=128,
                                     device="cpu")
    inv.fit(n_steps=2, fit_maxiter=1)
    assert sum("substantially biased" in str(w.message) for w in recwarn) == 1


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #
def _case(name):
    """The arguments of each error case, for both packages."""
    y, err, A, xp = averaging_problem(m=20, n=50)
    theta = [0.0, 0.0, 0.0]
    return {
        "solver": ((y, err, A, xp, theta), dict(solver="bogus")),
        "df64_kernel": ((y, err, A, xp, [0.0, 0.0, 0.0, 0.0]),
                        dict(solver="df64", kernel="rq")),
        "store_value": ((y, err, A, xp, theta), dict(solver="df64", store_entries="yes")),
        "store_flag": ((y, err, A, xp, theta), dict(store_entries=True)),
        "shapes": ((y[:-1], err[:-1], A, xp, theta), {}),
        "y_err": ((y, np.r_[err[:-1], 0.0], A, xp, theta), {}),
        "n_hyperpars": ((y, err, A, xp, [0.0, 0.0]), {}),
        "df64_padding": ((y, err, A, xp, theta), dict(solver="df64", block_size=100)),
        "unsupported_kernel": ((y, err, A, xp, theta), dict(kernel="bogus")),
    }[name]


@pytest.mark.parametrize("name", ["solver", "df64_kernel", "store_value", "store_flag",
                                  "shapes", "y_err", "n_hyperpars", "df64_padding",
                                  "unsupported_kernel"])
def test_validation_matches_jax(name):
    args, kw = _case(name)
    errors = []
    for cls, rq, extra in ((JaxInverter, JaxRationalQuadratic, {}),
                           (LargeScaleGpLinearInverter, RationalQuadratic, {"device": "cpu"})):
        kwargs = dict(kw, **extra)
        if kwargs.get("kernel") == "rq":
            kwargs["kernel"] = rq
        with pytest.raises(ValueError) as info:
            cls(*args, **kwargs)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("call", ["fit", "residual_norm_f64"])
def test_method_errors_match_jax(call):
    """``fit(n_probes=0)`` and ``residual_norm_f64`` off the df64 tier."""
    y, err, A, xp = averaging_problem(m=20, n=50)
    errors = []
    for inv in (JaxInverter(y, err, A, xp, [0.0, 0.0, 0.0], block_size=64),
                LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], block_size=64,
                                           device="cpu")):
        with pytest.raises(ValueError) as info:
            inv.fit(n_probes=0) if call == "fit" else inv.residual_norm_f64()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_mesh_raises_naming_its_roadmap_item():
    """``mesh=`` is ported (A13(b), and across processes A13(c), run in
    tests/test_torch_multihost.py): on two CPU cells of one process the
    df64 inverter solves as it does without a mesh; a mesh naming a
    process that does not exist raises the Layout's ValueError."""
    y, err, A, xp = averaging_problem(m=20, n=50)
    kw = dict(block_size=128, solver="df64", cg_tol=1e-10, device="cpu")
    inv = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0],
                                     mesh=chain_mesh(2, device="cpu"), block_size=256,
                                     solver="df64", cg_tol=1e-10, device="cpu")
    one = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], store_entries=False, **kw)
    mean, ref = inv.calculate_posterior_mean(), one.calculate_posterior_mean()
    assert np.abs(mean - ref).max() <= 1e-8 * np.abs(ref).max()
    across = Mesh(cell_grid([Cell(0, torch.device("cpu")), Cell(1, torch.device("cpu"))], (2,)),
                  ("chains",))
    with pytest.raises(ValueError, match=r"every process of the group must hold the same"):
        LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], mesh=across, device="cpu")


# --------------------------------------------------------------------- #
# convert
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("solver, kernel", [("cg", "se"), ("mixed", "se+wn"), ("df64", "se")])
def test_large_inverter_state_round_trip(solver, kernel):
    """A solved JAX inverter (M = 30, N = 100) carried across keeps its
    tier, kernel and solution and gives its posterior mean to 1e-10 (the
    df64 tier to 1e-8: the JAX package's mean contraction runs in pair
    arithmetic); the port's instance carried across again is the same
    model."""
    port_k, jax_k, theta = KERNELS[kernel]
    y, err, A, xp = averaging_problem(m=30, n=100)
    ref = JaxInverter(y, err, A, xp, theta, kernel=jax_k(), block_size=128, solver=solver,
                      cg_tol=1e-10, cg_maxiter=4000, dtype="float64", prior_mean=0.1)
    state = convert.large_inverter_state_of(ref, cg_tol=1e-10, cg_maxiter=4000)
    assert state["solver"] == solver and state["model_matrix"].shape == (30, 100)
    inv = convert.large_inverter_from_state(state, device="cpu")
    np.testing.assert_array_equal(inv.z64, state["z64"])
    mean = inv.calculate_posterior_mean()
    assert _rel(mean, ref.calculate_posterior_mean()) <= (1e-8 if solver == "df64" else 1e-10)
    again = convert.large_inverter_from_state(convert.large_inverter_state_of(inv), device="cpu")
    np.testing.assert_array_equal(again.calculate_posterior_mean(), mean)
