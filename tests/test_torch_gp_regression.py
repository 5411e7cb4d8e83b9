"""The PyTorch port's GpRegressor and GpLinearInverter against the JAX
package's, in float64 on the CPU. Each JAX model is carried across with
inference_tpu_torch/convert.py (``gp_state_of``, ``gp_regressor_from_state``),
so both packages compute from the same data, kernel, mean and
hyperparameters.

Tolerance: 1e-8 relative, the BASELINE contract for the LML and its
gradient, with an absolute floor of 1e-8 times the largest reference value
for entries near zero. Both packages run the same algebra in float64; they
differ by roundoff in the factorisation (LAPACK through torch against
XLA's), which stays orders of magnitude below that."""

import numpy as np
import pytest
import torch

from inference_tpu import gp as jgp
from inference_tpu_torch import gp as tgp
from inference_tpu_torch.convert import gp_regressor_from_state, gp_state_of
from inference_tpu_torch.gp.regression import _AnalyticLml
from inference_tpu_torch.ops import pairwise

RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def make_data(n=40, d=2, seed=0):
    """``benchmarks/gp_lml_bench.py``'s data at a small size."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, d))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


THETA = np.array([0.1, 0.2, 0.5, 0.4])
QUERY = np.random.default_rng(9).uniform(0, 10, (7, 2))


def pair(cholesky="auto", jax_cholesky=None, **kw):
    """A JAX model and the port's model carried across from it."""
    x, y, err = make_data()
    kw.setdefault("y_err", err)
    jg = jgp.GpRegressor(x, y, hyperpars=kw.pop("hyperpars", THETA),
                         cholesky=jax_cholesky or cholesky, **kw)
    return jg, gp_regressor_from_state(gp_state_of(jg), cholesky=cholesky, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def models():
    return pair()


@pytest.mark.parametrize("cholesky, jax_cholesky", [
    ("auto", None), ("blocked", None), (24, 24), ("analytic", None), ("xla", None),
])
def test_lml_and_loo_with_gradients_match_jax(cholesky, jax_cholesky):
    """LML and LOO likelihood, values and gradients, for every
    factorisation option (an int panel width below N exercises the blocked
    recursion)."""
    jg, tg = pair(cholesky, jax_cholesky)
    close(tg.marginal_likelihood(THETA), jg.marginal_likelihood(THETA))
    for port, ref in ((tg.marginal_likelihood_gradient(THETA), jg.marginal_likelihood_gradient(THETA)),
                      (tg.loo_likelihood_gradient(THETA), jg.loo_likelihood_gradient(THETA))):
        close(port[0], ref[0])
        close(port[1], ref[1])
    close(tg.loo_likelihood(THETA), jg.loo_likelihood(THETA))


@pytest.mark.parametrize("method", ["__call__", "gradient", "spatial_derivatives",
                                    "build_posterior"])
def test_predictions_match_jax(models, method):
    jg, tg = models
    for port, ref in zip(getattr(tg, method)(QUERY), getattr(jg, method)(QUERY)):
        close(port, ref)


def test_loo_predictions_and_state_match_jax(models):
    jg, tg = models
    for port, ref in zip(tg.loo_predictions(), jg.loo_predictions()):
        close(port, ref)
    close(tg.build_posterior(QUERY, mean_only=True), jg.build_posterior(QUERY, mean_only=True))
    close(tg.alpha.numpy(), np.asarray(jg.alpha))
    close(tg.L.numpy(), np.asarray(jg.L))
    assert tg.hp_bounds == jg.hp_bounds
    assert str(tg) == str(jg)


def test_pad_to_matches_jax_and_unpadded(models):
    """Padded rows decouple: the padded port model equals the padded JAX
    model and the unpadded port model."""
    jg, tg = pair(pad_to=64)
    assert tg._x_dev.shape[0] == 64
    v, g = tg.marginal_likelihood_gradient(THETA)
    close(v, jg.marginal_likelihood_gradient(THETA)[0])
    close(g, jg.marginal_likelihood_gradient(THETA)[1])
    close(g, models[1].marginal_likelihood_gradient(THETA)[1])
    for port, ref in zip(tg(QUERY), jg(QUERY)):
        close(port, ref)
    for port, ref in zip(tg.loo_predictions(), models[1].loo_predictions()):
        close(port, ref)


KERNEL_CASES = {
    "sum": (lambda m: m.SquaredExponential() + m.WhiteNoise(), "ConstantMean"),
    "change_point": (lambda m: m.ChangePoint([m.SquaredExponential, m.SquaredExponential]),
                     "LinearMean"),
    "rq": (lambda m: m.RationalQuadratic(), "QuadraticMean"),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_other_kernels_and_means_match_jax(name):
    """Composite and ChangePoint kernels, the rational quadratic, and the
    linear and quadratic means: LML, gradient and predictions."""
    x, y, err = make_data()
    make_kernel, mean = KERNEL_CASES[name]
    kernel = make_kernel(jgp)
    kernel.pass_spatial_data(x)
    kernel.estimate_hyperpar_bounds(y)
    mean_j = getattr(jgp, mean)()
    mean_j.pass_spatial_data(x)
    mean_j.estimate_hyperpar_bounds(y)
    bounds = np.array([*mean_j.bounds, *kernel.bounds])
    theta = bounds[:, 0] + (bounds[:, 1] - bounds[:, 0]) * np.random.default_rng(1).uniform(
        0.3, 0.7, len(bounds))
    jg = jgp.GpRegressor(x, y, y_err=err, hyperpars=theta, kernel=make_kernel(jgp),
                         mean=getattr(jgp, mean))
    tg = gp_regressor_from_state(gp_state_of(jg), device="cpu")
    assert type(tg.cov).__name__ == type(jg.cov).__name__
    v, g = tg.marginal_likelihood_gradient(theta)
    vj, gj = jg.marginal_likelihood_gradient(theta)
    close(v, vj)
    close(g, gj)
    for port, ref in zip(tg(QUERY), jg(QUERY)):
        close(port, ref)


def test_full_error_covariance_matches_jax():
    x, y, err = make_data()
    A = np.random.default_rng(4).normal(size=(40, 40)) * 0.01
    y_cov = A @ A.T + np.diag(err**2)
    jg, tg = pair(y_err=None, y_cov=y_cov)
    assert not tg._sig_is_diag
    close(tg.marginal_likelihood_gradient(THETA)[1], jg.marginal_likelihood_gradient(THETA)[1])
    for port, ref in zip(tg(QUERY), jg(QUERY)):
        close(port, ref)


def test_through_b2_plain_version_at_n2100(monkeypatch):
    """N = 2,100, D = 2: the port assembles the covariance through
    SqexpCovariance (B2's plain version on the CPU, both sides >= 2,048
    rows), the JAX package through the matmul form; LML, gradient and
    predictions agree to 1e-8."""
    x, y, err = make_data(n=2100)
    theta = np.array([0.0, 0.0, 0.5, 0.5])
    jg = jgp.GpRegressor(x, y, y_err=err, hyperpars=theta)
    tg = gp_regressor_from_state(gp_state_of(jg), device="cpu")
    blocks = []
    plain = pairwise._sqexp_block
    monkeypatch.setattr(pairwise, "_sqexp_block", lambda *a: blocks.append(1) or plain(*a))
    v, g = tg.marginal_likelihood_gradient(theta)
    assert blocks == [1]
    vj, gj = jg.marginal_likelihood_gradient(theta)
    close(v, vj)
    close(g, gj)
    for port, ref in zip(tg(QUERY), jg(QUERY)):
        close(port, ref)


def test_analytic_backward_gives_none_or_true_gradients():
    """The analytic LML's backward returns None for inputs that need no
    gradient (never zeros), and for x and y, when they need one, the
    gradient that autograd through the factorisation gives."""
    _, tg = pair("analytic")
    theta = tg._theta(THETA, requires_grad=True)
    x, y, sig, m = (a.clone() for a in tg._data())
    value = _AnalyticLml.apply(tg, theta, x, y, sig, m)
    raw = value.grad_fn.apply(torch.ones(()))
    assert raw[0] is None and raw[1] is not None
    assert all(r is None for r in raw[2:])

    x.requires_grad_(True)
    y.requires_grad_(True)
    got = torch.autograd.grad(_AnalyticLml.apply(tg, theta, x, y, sig, m), (theta, x, y))
    K, r = tg._assemble(theta, x, y, sig, m)
    L = torch.linalg.cholesky(K)
    v = torch.linalg.solve_triangular(L, r[:, None], upper=False)[:, 0]
    ref = torch.autograd.grad(-0.5 * (v @ v) - torch.log(torch.diagonal(L)).sum(), (theta, x, y))
    for a, b in zip(got, ref):
        assert float(b.abs().max()) > 0
        close(a, b)


def test_fit_bfgs_and_options():
    """fit("bfgs") and fit("device") end at least as high as the start
    centre; an unknown optimizer warns and falls back to "bfgs"."""
    x, y, err = make_data(n=30)
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, device="cpu")
    lwr, upr = (np.array([b[i] for b in tg.hp_bounds]) for i in (0, 1))
    theta = tg.fit(optimizer="bfgs", n_starts=2)
    assert tg.marginal_likelihood(theta) >= tg.marginal_likelihood(0.5 * (lwr + upr))
    theta = tg.fit(optimizer="device")
    assert tg.marginal_likelihood(theta) > tg.marginal_likelihood(0.5 * (lwr + upr))
    with pytest.warns(UserWarning):
        tg.fit(optimizer="nonsense", n_starts=1)
    with pytest.raises(ValueError):
        tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, cholesky="lu", device="cpu")


def test_fit_diffev_and_fit_at_construction():
    """fit("diffev") beats the start centre too, and a model built without
    hyperparameters fits itself and sets the result."""
    x, y, err = make_data(n=20)
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, device="cpu")
    lwr, upr = (np.array([b[i] for b in tg.hp_bounds]) for i in (0, 1))
    centre = tg.marginal_likelihood(0.5 * (lwr + upr))
    assert tg.marginal_likelihood(tg.fit(optimizer="diffev")) >= centre
    fitted = tgp.GpRegressor(x, y, y_err=err, n_starts=1, dtype=torch.float64, device="cpu")
    assert fitted.hyperpars.shape == (4,)
    assert tg.marginal_likelihood(fitted.hyperpars) >= centre


@pytest.mark.parametrize("cross_val", [False, True])
def test_deleted_regressor_is_freed_without_the_collector(cross_val):
    """The model selector dispatches on ``cross_val`` without a stored bound
    method, so no reference cycle holds a deleted regressor (and its device
    tensors) until the garbage collector runs."""
    import gc
    import weakref

    x, y, err = make_data(n=30)
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, cross_val=cross_val, device="cpu")
    objective = tg.loo_likelihood if cross_val else tg.marginal_likelihood
    assert tg.model_selector(THETA) == objective(THETA)
    gradient = tg.loo_likelihood_gradient if cross_val else tg.marginal_likelihood_gradient
    np.testing.assert_array_equal(tg.model_selector_gradient(THETA)[1], gradient(THETA)[1])
    del objective, gradient
    ref = weakref.ref(tg)
    gc.disable()
    try:
        del tg
        assert ref() is None
    finally:
        gc.enable()


def test_update_data_and_stale_state_match_jax():
    """update_data with set_state=False blocks predictions until the state
    is set again; after it both packages agree on the new data."""
    x, y, err = make_data(n=50)
    jg = jgp.GpRegressor(x[:40], y[:40], y_err=err[:40], hyperpars=THETA, pad_to=32)
    tg = gp_regressor_from_state(gp_state_of(jg), device="cpu")
    for model in (jg, tg):
        model.update_data(x, y, y_err=err, set_state=False)
    with pytest.raises(RuntimeError, match="stale"):
        tg(QUERY)
    for model in (jg, tg):
        model.set_hyperparameters(THETA)
    assert tg._x_dev.shape[0] == 64
    for port, ref in zip(tg(QUERY), jg(QUERY)):
        close(port, ref)


def _inverter_problem():
    rng = np.random.default_rng(1)
    n_params, n_data = 24, 16
    positions = np.linspace(0, 10, n_params)[:, None]
    truth = np.sin(positions[:, 0])
    A = rng.uniform(0, 1, (n_data, n_params)) / n_params
    y_err = np.full(n_data, 0.01)
    y = A @ truth + rng.normal(0, 0.01, n_data)
    return y, y_err, A, positions


def test_linear_inverter_matches_jax():
    """GpLinearInverter's posterior, LML and LML gradient against the JAX
    package's."""
    problem = _inverter_problem()
    jinv = jgp.GpLinearInverter(*problem)
    tinv = tgp.GpLinearInverter(*problem, device="cpu")
    theta = np.array([0.1, -0.5, 0.3])
    for port, ref in zip(tinv.calculate_posterior(theta), jinv.calculate_posterior(theta)):
        close(port, ref)
    close(tinv.calculate_posterior_mean(theta), jinv.calculate_posterior_mean(theta))
    close(tinv.marginal_likelihood(theta), jinv.marginal_likelihood(theta))
    for port, ref in zip(tinv.marginal_likelihood_gradient(theta),
                         jinv.marginal_likelihood_gradient(theta)):
        close(port, ref)
    assert tinv.hyperpar_labels == jinv.hyperpar_labels
    with pytest.raises(ValueError):
        tinv.optimize_hyperparameters(np.zeros(2))


def test_gp_threshold_is_the_jax_one():
    import inference_tpu.ops.pairwise as jpairwise

    assert pairwise._PALLAS_MIN_N == jpairwise._PALLAS_MIN_N
