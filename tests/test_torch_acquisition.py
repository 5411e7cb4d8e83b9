"""The port's acquisition functions (inference_tpu_torch/gp/acquisition.py)
against the JAX package's, in float64 on the CPU, on one GP carried across
by ``gp_state_of`` / ``gp_regressor_from_state``: values and spatial
gradients of ExpectedImprovement (z from below -3 to above 13),
UpperConfidenceBound and MaxVariance at 50 points to 1e-10 relative (an
absolute floor of 1e-10 times the largest reference value), and the
multistart clouds drawn from one seeded generator equal to the last bit.

EI is held to JAX where z >= -20. Below, JAX's ``log_ndtr`` switches to its
asymptotic series, and its ``log(1 + z Phi/phi)`` is off by up to 2e-7 in
value and 3e-4 in gradient at z = -21 against a 50-digit reference; the
port's erfcx form is held to that reference there instead (1e-9 value,
1e-8 gradient, z in [-40, -20]).
The JAX side draws from ``np.random.default_rng()``; the tests seed it by
monkeypatching that function."""

import numpy as np
import pytest
import torch

from inference_tpu import gp as jgp
from inference_tpu.gp import acquisition as jacq
from inference_tpu_torch import gp as tgp
from inference_tpu_torch.convert import gp_regressor_from_state, gp_state_of
from inference_tpu_torch.gp import acquisition as tacq

RTOL = 1e-10
THETA = np.array([0.1, 0.0, 0.3])


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


def objective_2d(v):
    return np.sin(v[..., 0]) * np.cos(0.7 * v[..., 1]) - 0.05 * (v**2).sum(-1)


@pytest.fixture(scope="module")
def models():
    """A JAX GpRegressor on 12 points of [0, 5]^2 with y_err 0.05 and the
    port's twin. Without noise the predictive variance near the data is a
    cancellation of O(1) terms down to ~1e-8, whose roundoff differs between
    the two packages' factorisations by more than the tolerance."""
    x = np.random.default_rng(0).uniform(0, 5, (12, 2))
    jg = jgp.GpRegressor(x, objective_2d(x), y_err=np.full(12, 0.05),
                         hyperpars=np.array([0.1, 0.2, 0.1, 0.3]), pad_to=64)
    return jg, gp_regressor_from_state(gp_state_of(jg), device="cpu",
                                       dtype=torch.float64)


def _points(gp):
    """25 points over the box and 25 within 1e-3 of the data, where the
    predictive sigma is small and |z| large."""
    rng = np.random.default_rng(3)
    near = gp.x[rng.integers(0, gp.x.shape[0], 25)] + rng.uniform(-1e-3, 1e-3, (25, 2))
    return np.concatenate([rng.uniform(0, 5, (25, 2)), near])


KINDS = {
    "ei": (jacq.ExpectedImprovement, tacq.ExpectedImprovement, {}),
    "ucb": (jacq.UpperConfidenceBound, tacq.UpperConfidenceBound, {"kappa": 1.5}),
    "maxvar": (jacq.MaxVariance, tacq.MaxVariance, {}),
}


@pytest.mark.parametrize("shift", ["best", "below", "above"])
@pytest.mark.parametrize("kind", ["ei", "ucb", "maxvar"])
def test_value_and_gradient(models, kind, shift):
    """``shift`` moves the incumbent mu_max: "below" the data by 10 ptp (z >
    13 near the data), "above" it by ptp (z < -3 at most points)."""
    jg, tg = models
    jcls, tcls, kw = KINDS[kind]
    ja, ta = jcls(**kw), tcls(**kw)
    ja.update_gp(jg)
    ta.update_gp(tg)
    ptp = np.ptp(tg.y)
    mu_max = {"best": tg.y.max(), "below": tg.y.min() - 10 * ptp,
              "above": tg.y.max() + ptp}[shift]
    ja.mu_max = ta.mu_max = mu_max
    pts = _points(tg)
    if kind == "ei":
        mu, var = torch.func.vmap(lambda q: tg._predict_single(q, *tg._state()))(
            torch.tensor(pts))
        z = ((mu - mu_max) / torch.sqrt(var.abs())).numpy()
        pts = pts[z >= -20]  # JAX's own lower tail: test_ei_far_lower_tail
        z = z[z >= -20]
        if shift == "below":
            assert z.max() > 13
        if shift == "above":
            assert (z < -3).sum() >= 10
        if shift == "best":
            assert z.min() < -3 and z.max() > -0.1
    ref = [ja.opt_func_gradient(p) for p in pts]
    got = [ta.opt_func_gradient(p) for p in pts]
    close([g[0] for g in got], [r[0] for r in ref])
    close(np.stack([g[1] for g in got]), np.stack([r[1] for r in ref]))
    close([ta(p) for p in pts[:5]], [ja(p) for p in pts[:5]])
    close([ta.convergence_metric(p) for p in pts[:5]], [ja.convergence_metric(p) for p in pts[:5]])


def test_batched_scores_equal_single_points(models):
    """The clouds' one batched call scores each point as the single-point
    objective does."""
    _, tg = models
    ta = tacq.ExpectedImprovement()
    ta.update_gp(tg)
    pts = _points(tg)
    st = ta.gp_state()
    batched = ta.score(torch.tensor(pts), st).numpy()
    close(batched, [ta.opt_func(p) for p in pts])


def test_ei_far_lower_tail():
    """Below z = -20 the EI objective -log EI = -log sigma - log phi(z) -
    log(1 + z Phi(z)/phi(z)) is held to a 50-digit reference of its z part,
    value and derivative."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 50

    def exact(z):
        z = mp.mpf(z)
        return mp.log(mp.npdf(z) + z * mp.ncdf(z))

    for z in (-20.5, -21.0, -25.0, -30.0, -40.0):
        zt = torch.tensor(z, requires_grad=True)
        ta = tacq.ExpectedImprovement()
        # sigma = 1, mu_max = 0, mu = z: -log EI is minus the exact value
        ta._mu_var = lambda q, st: (q[0], torch.ones_like(q[0]))
        value = ta._objective(zt[None], (None,) * 6 + (torch.tensor(0.0),))
        (grad,) = torch.autograd.grad(value, zt)
        close(-float(value.detach()), float(exact(z)), rtol=1e-9)
        close(-float(grad), float(mp.diff(exact, z)), rtol=1e-8)


def test_log_ndtr_matches_torch():
    """The erfcx/erfc form of log Phi equals torch.special.log_ndtr."""
    z = torch.tensor(np.concatenate([-np.logspace(-3, 2.5, 200), [0.0],
                                     np.logspace(-3, 1.3, 200)]), requires_grad=True)
    ours, ref = tacq._log_ndtr(z), torch.special.log_ndtr(z)
    close(ours.detach(), ref.detach(), rtol=1e-12)
    g_ours, = torch.autograd.grad(ours.sum(), z)
    g_ref, = torch.autograd.grad(ref.sum(), z)
    close(g_ours, g_ref, rtol=1e-9)


def test_candidate_cloud_equals_jax():
    lwr, upr = np.array([0.0, -1.0]), np.array([4.0, 3.0])
    widths = upr - lwr
    lwr_in, upr_in = lwr + 0.01 * widths, upr - 0.01 * widths
    for x0 in (np.array([1.0, 1.0]), np.array([3.99, 0.0]), np.array([-2.0, 0.0]), None):
        a = jacq.candidate_cloud(x0, lwr_in, upr_in, widths, np.random.default_rng(4))
        b = tacq.candidate_cloud(x0, lwr_in, upr_in, widths, np.random.default_rng(4))
        np.testing.assert_array_equal(a, b)
    assert (tacq.CLOUD_SIZE, tacq.CLOUD_INSET, tacq.CLOUD_WIDTH) == (
        jacq.CLOUD_SIZE, jacq.CLOUD_INSET, jacq.CLOUD_WIDTH)


def _seeded(monkeypatch, seed):
    """Make the JAX side's unseeded ``np.random.default_rng()`` draw from
    ``seed``."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: real(seed))
    return real(seed)


def test_starting_positions_equal_jax(models, monkeypatch):
    jg, tg = models
    bounds = [(0.0, 5.0), (0.0, 4.0)]  # one data point may fall outside
    ja, ta = jacq.ExpectedImprovement(), tacq.ExpectedImprovement()
    ja.update_gp(jg)
    ta.update_gp(tg)
    ta.rng = _seeded(monkeypatch, 11)
    ref = ja.starting_positions(bounds)
    got = ta.starting_positions(bounds)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_optimiser_clouds_equal_jax(monkeypatch):
    """``GpOptimiser._candidate_clouds`` (padded to the bucket, uniform
    rows for padding and out-of-bounds points) equals JAX's."""
    x = np.random.default_rng(1).uniform(-0.5, 3, (19, 2))
    y = objective_2d(x)
    bounds = [(0.0, 3.0), (0.0, 3.0)]
    hp = np.array([0.0, 0.0, 0.0, 0.0])
    jo = jgp.GpOptimiser(x, y, bounds=bounds, hyperpars=hp)
    to = tgp.GpOptimiser(x, y, bounds=bounds, hyperpars=hp, device="cpu")
    to.acquisition.rng = _seeded(monkeypatch, 12)
    ref = jo._candidate_clouds()
    got = to._candidate_clouds()
    assert got.shape == (32, tacq.CLOUD_SIZE, 2)
    np.testing.assert_array_equal(got, ref)
