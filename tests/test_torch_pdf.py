"""The density estimators of the PyTorch port (inference_tpu_torch/pdf/) and
a chain's ``get_marginal`` and ``get_interval`` against the JAX package's,
on the CPU in float64: tests/test_pdf.py's 15 tests, each also holding the
port's estimate to the JAX class's on the same sample (KDE pdf, cdf,
bandwidth and cross-validation to 1e-10), the blocked kernel sums, and the
two chain views on one history loaded into both packages."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from inference_tpu import pdf as jax_pdf
from inference_tpu.mcmc import GibbsChain as JaxGibbs
from inference_tpu_torch import convert
from inference_tpu_torch.pdf import (KDE2D, GaussianKDE, UnimodalPdf, kde, sample_hdi,
                                     sample_hdi_device)

TIGHT = dict(rtol=1e-10, atol=1e-13)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal_sample(n=5000, mu=2.0, sigma=0.5, seed=0):
    return np.random.default_rng(seed).normal(mu, sigma, n)


def kde_pair(s, **kw):
    ours = GaussianKDE(s, device="cpu", **kw)
    theirs = jax_pdf.GaussianKDE(s, **kw)
    return ours, theirs


def unimodal_pair(s):
    return UnimodalPdf(s, device="cpu"), jax_pdf.UnimodalPdf(s)


def assert_kde_matches(ours, theirs, x):
    assert ours.h == pytest.approx(theirs.h, rel=1e-10)
    np.testing.assert_allclose(ours(x), theirs(x), **TIGHT)
    np.testing.assert_allclose(ours.cdf(x), theirs.cdf(x), **TIGHT)
    assert ours.mode == pytest.approx(theirs.mode, abs=1e-5)


def assert_unimodal_matches(ours, theirs):
    """The same objective at the same parameters (1e-12), and each fit's
    MAP no worse than the other's by 1e-9 of the objective."""
    for theta in (theirs.MAP, ours.MAP):
        assert ours.posterior(theta) == pytest.approx(theirs.posterior(theta), rel=1e-12)
    f_ours, f_theirs = ours.posterior(ours.MAP), theirs.posterior(theirs.MAP)
    assert f_ours >= f_theirs - 1e-9 * abs(f_theirs)
    np.testing.assert_allclose(ours.MAP, theirs.MAP, rtol=1e-4, atol=1e-6)


def test_kde_moments_match_normal():
    s = normal_sample()
    kde_, ref = kde_pair(s)
    assert_kde_matches(kde_, ref, np.linspace(0.0, 4.0, 50))
    mu, var, skw, kur = kde_.moments()
    np.testing.assert_allclose([mu, var, skw, kur], ref.moments(), rtol=1e-9, atol=1e-12)
    assert abs(mu - 2.0) < 0.05
    assert abs(var - 0.25) < 0.05
    assert abs(skw) < 0.2
    assert abs(kur) < 0.3
    assert abs(kde_.mode - 2.0) < 0.15


def test_kde_pdf_and_cdf_values():
    s = normal_sample(n=20000)
    kde_, ref = kde_pair(s)
    x = np.array([1.0, 2.0, 3.0])
    assert_kde_matches(kde_, ref, x)
    analytic = np.exp(-0.5 * ((x - 2.0) / 0.5) ** 2) / (0.5 * np.sqrt(2 * np.pi))
    assert np.allclose(kde_(x), analytic, rtol=0.1)
    from scipy.stats import norm

    assert np.allclose(kde_.cdf(x), norm.cdf(x, 2.0, 0.5), atol=0.02)
    assert np.isscalar(float(kde_(2.0)))
    assert kde_(2.0) == pytest.approx(ref(2.0), rel=1e-12)


def test_kde_interval():
    s = normal_sample(n=10000)
    kde_, ref = kde_pair(s)
    lo, hi = kde_.interval(0.9545)
    np.testing.assert_allclose([lo, hi], ref.interval(0.9545), rtol=1e-6)
    assert abs(lo - 1.0) < 0.1
    assert abs(hi - 3.0) < 0.1


def test_kde_cross_validation_bandwidth():
    s = normal_sample(n=1200, seed=3)
    kde_, ref = kde_pair(s, cross_validation=True)
    assert_kde_matches(kde_, ref, np.linspace(0.5, 3.5, 40))
    samples = torch.as_tensor(np.sort(s))
    for h in (0.05, 0.1, 0.3):
        ours = float(kde._loo_cv_logprob(samples, torch.tensor(h, dtype=torch.float64)))
        theirs = float(jax_pdf.kde._loo_cv_logprob(jnp.asarray(np.sort(s)), jnp.asarray(h)))
        assert ours == pytest.approx(theirs, rel=1e-10)
    silverman = kde_.simple_bandwidth_estimator()
    assert 0.2 * silverman < kde_.h < 5 * silverman


def test_kde_validation():
    with pytest.raises(ValueError):
        GaussianKDE(np.array([1.0, 2.0]), device="cpu")  # too few samples


def test_kde_plot_summary():
    import matplotlib

    matplotlib.use("Agg")
    s = normal_sample(n=2000)
    kde_ = GaussianKDE(s, device="cpu")
    fig, ax = kde_.plot_summary(show=False)
    lines = ax[0].get_lines()[0].get_xydata()
    np.testing.assert_allclose(lines[:, 1], jax_pdf.GaussianKDE(s)(lines[:, 0]), **TIGHT)


def test_kde2d():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, 3000)
    y = rng.normal(0, 2, 3000)
    kde_ = KDE2D(x, y, device="cpu")
    v_mode = float(kde_(np.array([0.0]), np.array([0.0])))
    v_off = float(kde_(np.array([1.0]), np.array([2.0])))
    assert abs(v_off / v_mode - np.exp(-1.0)) < 0.05
    vals = kde_(np.array([0.0, 1.0]), np.array([0.0, 1.0]))
    assert len(np.atleast_1d(vals)) == 2
    qx, qy = rng.normal(0, 1, 500), rng.normal(0, 2, 500)
    np.testing.assert_allclose(kde_(qx, qy), jax_pdf.KDE2D(x, y)(qx, qy), **TIGHT)


def test_unimodal_pdf_normal():
    s = normal_sample(n=4000)
    pdf_, ref = unimodal_pair(s)
    assert_unimodal_matches(pdf_, ref)
    mu, var, skw, kur = pdf_.moments()
    assert abs(mu - 2.0) < 0.1
    assert abs(var - 0.25) < 0.08
    assert abs(pdf_.mode - 2.0) < 0.15
    assert abs(pdf_.cdf(2.0) - 0.5) < 0.05


def test_unimodal_pdf_skewed():
    rng = np.random.default_rng(5)
    s = rng.normal(0, 1, 4000) + rng.exponential(2.0, 4000)
    pdf_, ref = unimodal_pair(s)
    assert_unimodal_matches(pdf_, ref)
    mu, var, skw, kur = pdf_.moments()
    assert abs(mu - 2.0) < 0.3
    assert abs(var - 5.0) < 1.0
    assert 0.8 < skw < 2.0


def test_sample_hdi_1d():
    s = normal_sample(n=20000)
    lo, hi = sample_hdi(s, 0.9545)
    np.testing.assert_array_equal([lo, hi], jax_pdf.sample_hdi(s, 0.9545))
    np.testing.assert_array_equal(sample_hdi_device(torch.as_tensor(s), 0.9545).numpy(),
                                  [lo, hi])
    assert abs(lo - 1.0) < 0.08
    assert abs(hi - 3.0) < 0.08


def test_sample_hdi_2d_columns():
    rng = np.random.default_rng(2)
    s = rng.normal(size=(5000, 3)) * np.array([1.0, 2.0, 0.5])
    hdi = sample_hdi(s, 0.6827)
    assert hdi.shape == (2, 3)
    np.testing.assert_array_equal(hdi, jax_pdf.sample_hdi(s, 0.6827))
    np.testing.assert_array_equal(sample_hdi_device(torch.as_tensor(s), 0.6827).numpy(), hdi)
    np.testing.assert_array_equal(
        sample_hdi_device(torch.as_tensor(s[:, :1]), 0.6827).numpy(),
        np.asarray(jax_pdf.sample_hdi_device(jnp.asarray(s[:, :1]), 0.6827)))
    widths = hdi[1] - hdi[0]
    assert np.allclose(widths, 2 * np.array([1.0, 2.0, 0.5]), rtol=0.15)


@settings(max_examples=20, deadline=None)
@given(fraction=st.floats(min_value=0.05, max_value=0.95))
def test_sample_hdi_linear_ramp(fraction):
    s = np.linspace(0.0, 1.0, 1000)
    lo, hi = sample_hdi(s, fraction)
    np.testing.assert_array_equal([lo, hi], jax_pdf.sample_hdi(s, fraction))
    np.testing.assert_array_equal(sample_hdi_device(torch.as_tensor(s), fraction).numpy(),
                                  np.asarray(jax_pdf.sample_hdi_device(jnp.asarray(s), fraction)))
    assert 0.0 <= lo <= hi <= 1.0
    assert abs((hi - lo) - fraction) < 0.01


def test_sample_hdi_validation():
    s = normal_sample(n=100)
    with pytest.raises(ValueError):
        sample_hdi(s, 1.5)
    with pytest.raises(ValueError):
        sample_hdi(s, 0.0)
    with pytest.raises(ValueError):
        sample_hdi("not a sample", 0.5)
    with pytest.raises(ValueError):
        sample_hdi(np.zeros([2, 2, 2]), 0.5)
    with pytest.raises(ValueError):
        sample_hdi(np.array([1.0]), 0.5)
    with pytest.warns(UserWarning):
        sample_hdi(np.linspace(0, 1, 30), 0.95)
    # a tensor is taken as the array it holds
    np.testing.assert_array_equal(sample_hdi(torch.as_tensor(s), 0.5), sample_hdi(s, 0.5))


def test_unimodal_cdf_matches_adaptive_quadrature():
    from scipy.integrate import quad

    rng = np.random.default_rng(1)
    pdf_ = UnimodalPdf(rng.gamma(4.0, 1.5, size=3000), device="cpu")
    xs = np.array([2.0, 5.0, 8.0, 12.0, 3.3])
    got = pdf_.cdf(xs)
    ref = np.array(
        [quad(pdf_, pdf_.lwr_limit, v)[0] if v > pdf_.lwr_limit else 0.0 for v in xs]
    )
    assert np.abs(got - ref).max() < 1e-7


def test_unimodal_cdf_below_lower_limit():
    rng = np.random.default_rng(5)
    sample = rng.exponential(size=3000)
    pdf_ = UnimodalPdf(sample, device="cpu")
    x_far_below = pdf_.lwr_limit - 10.0
    joint = pdf_.cdf(np.array([x_far_below, 1.0]))
    alone = pdf_.cdf(1.0)
    assert joint[0] <= 1e-12
    assert np.isclose(joint[1], alone, rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------- #
# the port's own: blocked sums, the seeded subsample, the chain views
# --------------------------------------------------------------------- #
def test_kde_blocked_sums_match_jax(monkeypatch):
    """Query chunks and sample blocks far smaller than a real run's (8
    points, 40 kernel values a block) give the JAX class's pdf, cdf and
    KDE2D values (1e-10)."""
    monkeypatch.setattr(kde, "_CHUNK", 8)
    monkeypatch.setattr(kde, "_BLOCK", 40)
    s = normal_sample(n=301, seed=4)
    ours, theirs = kde_pair(s, bandwidth=0.2)
    x = np.linspace(0.0, 4.0, 37)
    np.testing.assert_allclose(ours(x), theirs(x), **TIGHT)
    np.testing.assert_allclose(ours.cdf(x), theirs.cdf(x), **TIGHT)
    y = normal_sample(n=301, seed=5)
    np.testing.assert_allclose(KDE2D(s, y, device="cpu")(x, x),
                               jax_pdf.KDE2D(s, y)(x, x), **TIGHT)


def test_kde_cross_validation_subsample_draws_from_rng():
    """Above max_cv_samples the subsample comes from ``rng``: the same seed
    gives the same bandwidth, which is the cross-validation maximum of that
    subsample."""
    s = normal_sample(n=900, seed=6)
    a = GaussianKDE(s, cross_validation=True, max_cv_samples=300,
                    rng=np.random.default_rng(1), device="cpu")
    b = GaussianKDE(s, cross_validation=True, max_cv_samples=300,
                    rng=np.random.default_rng(1), device="cpu")
    assert a.h == b.h
    idx = np.random.default_rng(1).choice(s.size, 300, replace=False)
    sub = GaussianKDE(np.sort(s)[idx], device="cpu")
    assert a.h == sub.cross_validation_bandwidth_estimator(a.simple_bandwidth_estimator())


@pytest.fixture(scope="module")
def chain_pair():
    """One history in both packages: a JAX GibbsChain and the port's chain
    loaded from its checkpoint."""
    icov = np.linalg.inv(np.array([[1.0, 0.5], [0.5, 2.0]]))
    ref = JaxGibbs(lambda t: -0.5 * t @ jnp.asarray(icov) @ t, start=np.array([0.5, -0.5]),
                   display_progress=False, seed=3)
    ref.advance(3000)
    return convert.gibbs_chain_from_jax(ref, device="cpu"), ref


def test_get_marginal_matches_jax(chain_pair):
    ours, ref = chain_pair
    np.testing.assert_array_equal(ours.get_sample(), ref.get_sample())
    k_ours, k_ref = ours.get_marginal(0, burn=200, thin=2), ref.get_marginal(0, burn=200, thin=2)
    assert isinstance(k_ours, GaussianKDE) and k_ours.device.type == "cpu"
    np.testing.assert_array_equal(k_ours.sample, k_ref.sample)
    assert_kde_matches(k_ours, k_ref, np.linspace(-3.0, 3.0, 61))
    u_ours, u_ref = ours.get_marginal(1, burn=200, unimodal=True), ref.get_marginal(
        1, burn=200, unimodal=True)
    assert isinstance(u_ours, UnimodalPdf)
    assert_unimodal_matches(u_ours, u_ref)


def test_get_interval_matches_jax(chain_pair):
    ours, ref = chain_pair
    for interval, burn, thin in [(0.95, 1, 1), (0.5, 100, 3)]:
        s_ours, p_ours = ours.get_interval(interval, burn=burn, thin=thin)
        s_ref, p_ref = ref.get_interval(interval, burn=burn, thin=thin)
        np.testing.assert_array_equal(s_ours, s_ref)
        np.testing.assert_array_equal(p_ours, p_ref)
    # a requested count (here thinning by 1: 2,700 kept, 1,100 trimmed)
    # trims at random from the given Generator
    s1, p1 = ours.get_interval(0.9, samples=1600, rng=np.random.default_rng(0))
    s2, p2 = ours.get_interval(0.9, samples=1600, rng=np.random.default_rng(0))
    assert s1.shape == (1600, 2) and p1.shape == (1600,)
    np.testing.assert_array_equal(s1, s2)
    kept, _ = ours.get_interval(0.9)
    assert {tuple(r) for r in s1} <= {tuple(r) for r in kept}
