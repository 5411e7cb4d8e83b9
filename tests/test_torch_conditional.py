"""The port's conditional approximations (``inference_tpu_torch.approx``)
against the JAX package's on the CPU: one correlated Gaussian written as a
torch function and as its jnp twin, the same conditioning point and
bounds. The grids and densities agree within 1e-10, the moments with
JAX's and with the closed form, the samplers element by element on one
numpy stream (fed to JAX's module through its ``rng``), the numpy route
with the torch route, and the validation messages are JAX's. The port's
batched procedure makes as many posterior calls for 8 variables as for 2.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import inference_tpu.approx.conditional as jax_conditional
from inference_tpu.approx import (conditional_moments as jax_moments,
                                  conditional_sample as jax_sample,
                                  get_conditionals as jax_get,
                                  piecewise_linear_sample as jax_plsample)
from inference_tpu_torch.approx import (conditional_moments, conditional_sample,
                                        get_conditionals, piecewise_linear_sample)
from inference_tpu_torch.approx.conditional import (COUNTS, Conditional, _evaluate_variables,
                                                    _trapezium_quantile, evaluate_conditional)

RTOL = 1e-10


def gaussian(P, seed=0):
    """A correlated Gaussian: its precision, mean, a conditioning point
    drawn near the mean, and the log-density as a torch function, a jnp
    function and a numpy function."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(P, P))
    icov = B @ B.T / P + np.eye(P)
    mu = rng.normal(size=P)
    point = mu + 0.5 * rng.normal(size=P)
    it, mt = torch.as_tensor(icov), torch.as_tensor(mu)
    ij, mj = jnp.asarray(icov), jnp.asarray(mu)

    def logp_torch(t):
        d = t - mt
        return -0.5 * d @ it @ d

    def logp_jax(t):
        d = jnp.asarray(t) - mj
        return -0.5 * d @ ij @ d

    def logp_numpy(t):
        d = np.asarray(t) - mu
        return float(-0.5 * d @ icov @ d)

    return icov, mu, point, logp_torch, logp_jax, logp_numpy


def closed_form(icov, mu, point):
    """The conditionals' exact means and variances: variance 1 / L_ii, mean
    mu_i - sum_{j != i} L_ij (x_j - mu_j) / L_ii."""
    diag = np.diag(icov)
    d = point - mu
    return mu - (icov @ d - diag * d) / diag, 1.0 / diag


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def problem():
    return gaussian(3)


def test_get_conditionals_match_jax(problem):
    _, _, point, lt, lj, _ = problem
    bounds = [(-6.0, 6.0)] * 3
    axes, probs = get_conditionals(lt, bounds, point, device="cpu")
    ref_axes, ref_probs = jax_get(lj, bounds, point)
    assert axes.shape == probs.shape == (64, 3)
    assert _rel(axes, ref_axes) <= RTOL and _rel(probs, ref_probs) <= RTOL


def test_conditional_moments_match_jax_and_closed_form(problem):
    icov, mu, point, lt, lj, _ = problem
    bounds = [(-6.0, 6.0)] * 3
    means, variances = conditional_moments(lt, bounds, point, device="cpu")
    ref_means, ref_vars = jax_moments(lj, bounds, point)
    assert _rel(means, ref_means) <= RTOL and _rel(variances, ref_vars) <= RTOL
    exact_means, exact_vars = closed_form(icov, mu, point)
    # the 64-point grid over the 8-nat range: means to 1e-4 of a standard
    # deviation, variances within 0.5% (the range drops the tails beyond
    # 4 standard deviations)
    assert np.abs(means - exact_means).max() <= 1e-4 * np.sqrt(exact_vars).max()
    assert np.abs(variances / exact_vars - 1.0).max() <= 5e-3


def test_piecewise_linear_sample_matches_jax_element_by_element(monkeypatch):
    x = np.linspace(-1.0, 2.0, 40)
    density = np.exp(-x**2) * (1.0 + 0.5 * np.sin(3 * x))
    monkeypatch.setattr(jax_conditional, "rng", np.random.default_rng(7))
    ref = jax_plsample(x, density, 5000)
    got = piecewise_linear_sample(x, density, 5000, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(got, ref)


def test_conditional_sample_matches_jax_element_by_element(problem, monkeypatch):
    _, _, point, lt, lj, _ = problem
    bounds = [(-6.0, 6.0)] * 3
    monkeypatch.setattr(jax_conditional, "rng", np.random.default_rng(3))
    ref = jax_sample(lj, bounds, point, 2000)
    got = conditional_sample(lt, bounds, point, 2000, rng=np.random.default_rng(3),
                             device="cpu")
    assert got.shape == (2000, 3)
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_trapezium_quantile_series_branch():
    """Below |dh| = 1e-5 the first-order series takes over: equal to JAX's,
    and F(t) = dh t^2 + (1 - dh) t gives back u."""
    u = np.linspace(0.0, 1.0, 101)
    for dh in (0.0, 3e-6, -9e-6, 2e-5, -0.4, 0.9):
        t = _trapezium_quantile(u, np.full_like(u, dh))
        np.testing.assert_array_equal(t, jax_conditional._trapezium_quantile(u, dh))
        assert np.abs(dh * t**2 + (1.0 - dh) * t - u).max() <= 1e-10


def test_numpy_route_matches_torch_route_and_jax(problem):
    """A numpy posterior takes the host route, one call a point."""
    _, _, point, lt, lj, ln = problem
    bounds = [(-6.0, 6.0)] * 3
    cond = Conditional(ln, point, 0, device="cpu")
    assert cond.host and not Conditional(lt, point, 0, device="cpu").host
    axes, probs = get_conditionals(ln, bounds, point, device="cpu")
    ref_axes, ref_probs = get_conditionals(lt, bounds, point, device="cpu")
    assert _rel(axes, ref_axes) <= RTOL and _rel(probs, ref_probs) <= RTOL
    jax_axes, jax_probs = jax_get(ln, bounds, point)
    assert _rel(axes, jax_axes) <= RTOL and _rel(probs, jax_probs) <= RTOL


def test_validation_messages_match_jax():
    cases = [
        (np.array([1.0, 0.5]), np.array([1.0, 1.0])),
        (np.array([0.0, 1.0]), np.array([-1.0, 1.0])),
        (np.linspace(0.0, 1.0, 32), np.zeros(32)),
    ]
    for x, p in cases:
        with pytest.raises(ValueError) as ours:
            piecewise_linear_sample(x, p, 10, rng=np.random.default_rng(0))
        with pytest.raises(ValueError) as theirs:
            jax_plsample(x, p, 10)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_cuda_without_a_card_raises(problem):
    _, _, point, lt, _, _ = problem
    for call in (lambda: get_conditionals(lt, [(-6, 6)] * 3, point),
                 lambda: conditional_moments(lt, [(-6, 6)] * 3, point),
                 lambda: conditional_sample(lt, [(-6, 6)] * 3, point, 10)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


def test_batched_call_count_does_not_grow_with_variables():
    """All variables advance together: the search, each of 6 refinements,
    each of 20 bisection rounds and the grid are one batched call each, so 2
    and 8 variables of one posterior make the same number of calls,
    1 + 6 + 20 + 1."""
    counts = []
    for n_params in (2, 8):
        cond = Conditional(lambda t: -0.5 * (t * t).sum(), np.zeros(n_params), 0, device="cpu")
        points = [np.insert(np.linspace(-5, 5, 16), 8, 0.0)] * n_params
        before = COUNTS["calls"]
        axes, _ = _evaluate_variables(cond, np.arange(n_params), points)
        counts.append(COUNTS["calls"] - before)
        assert axes.shape == (64, n_params)
    assert counts[0] == counts[1] == 28


def test_evaluate_conditional_one_variable_matches_jax(problem):
    _, _, point, lt, lj, _ = problem
    ours = Conditional(lt, point, 1, device="cpu")
    theirs = jax_conditional.Conditional(lj, point, 1)
    pts = np.linspace(-5, 5, 17)
    for a, b in zip(evaluate_conditional(ours, pts),
                    jax_conditional.evaluate_conditional(theirs, pts)):
        assert _rel(a, b) <= RTOL
