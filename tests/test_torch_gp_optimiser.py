"""The port's on-device GP fit (``GpRegressor.fit_device``) and Bayesian
optimisation (``GpOptimiser``) against the JAX package's, in float64 on the
CPU, and the port's deferred device iteration against its own eager
sequence.

Tolerances: a fit's winner scores at least the JAX winner's objective less
1e-8 of its size (the fits are held by the objective, not by iterates);
the batched objective equals the single-start one to 1e-10 relative in
value and gradient; the device multistart's proposal scores at least as
well as JAX's less 1e-8; the fused iteration's theta and objective agree
with the eager sequence's to 1e-10 relative and its proposal to 1e-8; the
adopted L and alpha equal an explicit ``set_hyperparameters`` to 1e-10. The
float32 fit (its jitter path) reaches the float64 optimum's LML to 1e-4
relative. JAX's unseeded ``np.random.default_rng()`` is seeded by
monkeypatching it."""

import numpy as np
import pytest
import torch

from inference_tpu import gp as jgp
from inference_tpu_torch import gp as tgp
from inference_tpu_torch.convert import (
    gp_optimiser_from_state,
    gp_optimiser_state_of,
    gp_regressor_from_state,
    gp_state_of,
)
from inference_tpu_torch.gp.acquisition import ExpectedImprovement, MaxVariance, UpperConfidenceBound
from inference_tpu_torch.ops import pairwise
from inference_tpu_torch.utils.optimize import value_and_grad

THETA = np.array([0.1, 0.2, 0.5, 0.4])


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


def make_data(n=24, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, d))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


def objective_1d(x):
    return -np.sin(3 * x) - 0.5 * (x - 2) ** 2 + 2


def objective_2d(v):
    x, y = v
    return -((x - 1.0) ** 2) - (y - 2.0) ** 2


def _seeded(monkeypatch, seed):
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: real(seed))
    return real(seed)


# --------------------------------------------------------------------------
# fit_device
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cross_val", [False, True])
def test_fit_device_against_jax(cross_val):
    x, y, err = make_data()
    jg = jgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, cross_val=cross_val)
    tg = gp_regressor_from_state(gp_state_of(jg), device="cpu", dtype=torch.float64)
    tg.cross_val = cross_val
    ref = jg.fit_device(starts=4, seed=0)
    got = tg.fit_device(starts=4, seed=0)
    score = tg.model_selector
    assert score(got) >= score(ref) - 1e-8 * abs(score(ref))
    lwr, upr = (np.array([b[i] for b in tg.hp_bounds]) for i in (0, 1))
    assert score(got) > score(0.5 * (lwr + upr))
    assert (got >= lwr).all() and (got <= upr).all()


@pytest.mark.parametrize("cross_val", [False, True])
@pytest.mark.parametrize("cholesky", ["auto", "blocked", "analytic"])
def test_batched_objective_equals_single_start(cholesky, cross_val):
    x, y, err = make_data()
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, cross_val=cross_val,
                         cholesky=cholesky, pad_to=32, device="cpu")
    lo, hi = tg._hp_box()
    z = torch.tensor(np.random.default_rng(3).uniform(-2, 2, (5, 4)))
    thetas = lo + (hi - lo) * torch.sigmoid(z)
    f, g = value_and_grad(tg._batched_objective, thetas)
    for r in range(5):
        v1, g1 = tg.model_selector_gradient(thetas[r].numpy())
        assert abs(float(f[r]) - v1) <= 1e-10 * abs(v1)
        np.testing.assert_allclose(g[r].numpy(), g1, rtol=1e-10, atol=1e-10 * np.abs(g1).max())


def test_batched_objective_per_start_from_b2_size(monkeypatch):
    """From pairwise._PALLAS_MIN_N rows each start is its own B2 block (on
    the CPU B2's plain version, through SqexpCovariance): the per-start
    route, never the matmul form, with the single-start values."""
    x, y, err = make_data(n=pairwise._PALLAS_MIN_N, seed=1)
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, device="cpu")
    blocks = []
    real = pairwise.SqexpCovariance.apply
    monkeypatch.setattr(pairwise.SqexpCovariance, "apply",
                        lambda *a: blocks.append(a[0].shape) or real(*a))
    thetas = torch.tensor(np.stack([THETA, THETA + 0.1]))
    f, g = value_and_grad(tg._batched_objective, thetas)
    assert len(blocks) == 2
    for r in range(2):
        v1, g1 = tg.marginal_likelihood_gradient(thetas[r].numpy())
        assert abs(float(f[r]) - v1) <= 1e-10 * abs(v1)
        np.testing.assert_allclose(g[r].numpy(), g1, rtol=1e-10, atol=1e-10 * np.abs(g1).max())


def test_fit_jitter_only_on_the_fit_path():
    """The float32 fit adds 1e-6 mean(diag K) to K's diagonal; every other
    path assembles K without it."""
    x, y, err = make_data()
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, device="cpu")
    th = tg._theta(THETA)
    K0, r0 = tg._assemble(th, *tg._data())
    K1, r1 = tg._assemble(th, *tg._data(), 1e-6)
    assert torch.equal(r0, r1)
    shift = 1e-6 * torch.diagonal(K0).mean()
    off = ~torch.eye(K0.shape[0], dtype=torch.bool)
    assert torch.equal(K1[off], K0[off])
    np.testing.assert_allclose(torch.diagonal(K1 - K0).numpy(), float(shift), rtol=1e-9)
    assert torch.equal(tg._fit_state(th)[0], K0)


def test_fit_device_float32_jitter_path():
    x, y, err = make_data()
    jg = jgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, dtype="float32")
    t32 = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, dtype=torch.float32, device="cpu")
    t64 = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, device="cpu")
    got = t32.fit_device(starts=4)
    ref = jg.fit_device(starts=4)
    best = t64.marginal_likelihood(t64.fit_device(starts=4))
    assert np.isfinite(got).all()
    assert t64.marginal_likelihood(got) >= best - 1e-4 * abs(best)
    assert t64.marginal_likelihood(got) >= t64.marginal_likelihood(ref) - 1e-4 * abs(best)


def test_fit_device_polish_options():
    x, y, err = make_data()
    tg = tgp.GpRegressor(x, y, y_err=err, hyperpars=THETA, device="cpu")
    device = tg.fit_device(starts=3)
    host = tg.fit_device(starts=3, polish="host")
    none = tg.fit_device(starts=3, polish=None)
    lml = tg.marginal_likelihood
    assert lml(device) >= lml(none) - 1e-10 * abs(lml(none))
    assert lml(host) >= lml(none) - 1e-10 * abs(lml(none))
    np.testing.assert_array_equal(tg.fit(optimizer="device", n_starts=3), device)


# --------------------------------------------------------------------------
# GpOptimiser
# --------------------------------------------------------------------------


def _pair(optimizer="device", **kw):
    """A JAX GpOptimiser at fixed hyperparameters and the port's twin."""
    x = np.array([0.5, 1.5, 2.5, 3.5])
    jo = jgp.GpOptimiser(x, objective_1d(x), bounds=[(0.0, 4.0)],
                         hyperpars=np.array([0.5, 1.0, 0.0]), optimizer=optimizer, **kw)
    to = gp_optimiser_from_state(gp_optimiser_state_of(jo), device="cpu",
                                 dtype=torch.float64)
    return jo, to


def test_state_round_trip():
    jo, to = _pair()
    st_j, st_t = gp_optimiser_state_of(jo), gp_optimiser_state_of(to)
    for key in ("x", "y", "hyperpars", "iteration_history"):
        np.testing.assert_array_equal(st_t[key], st_j[key])
    assert st_t["bounds"] == st_j["bounds"] and st_t["acquisition"] == st_j["acquisition"]
    q = np.linspace(0, 4, 9)
    mu_j, sd_j = jo(q)
    mu_t, sd_t = to(q)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-10)
    # the noise-free sd at the data is a cancellation of O(1) terms
    np.testing.assert_allclose(sd_t, sd_j, rtol=1e-10, atol=1e-9)


def test_multistart_device_against_jax(monkeypatch):
    """From the same state and the same seeded starts, the port's device
    multistart proposes a point at least as good as JAX's."""
    jo, to = _pair()
    to.acquisition.rng = _seeded(monkeypatch, 5)
    x_ref, f_ref = jo.multistart_device()
    x_got, f_got = to.multistart_device()
    assert 0.0 <= float(np.atleast_1d(x_got)[0]) <= 4.0
    assert f_got <= f_ref + 1e-8 * max(1.0, abs(f_ref))
    assert f_got == pytest.approx(to.acquisition.opt_func(x_got), rel=1e-8, abs=1e-10)


def _two_device_optimisers():
    x = np.array([1.0, 5.0, 9.0])
    y = np.sin(2 * x) + 0.1 * x
    a = tgp.GpOptimiser(x, y, bounds=[(0.0, 10.0)], optimizer="device", device="cpu")
    b = gp_optimiser_from_state(gp_optimiser_state_of(a), device="cpu")
    return a, b


def test_fused_proposal_equals_eager_sequence():
    """The deferred iteration (one call) equals the eager sequence of its
    parts: fit_device, set_hyperparameters, the clouds from the same
    generator, the cloud multistart."""
    a, b = _two_device_optimisers()
    nx, ny = np.array([3.0]), np.array([np.sin(6.0) + 0.3])
    a.add_evaluation(nx, ny)
    b.add_evaluation(nx, ny)
    a.acquisition.rng = np.random.default_rng(7)
    b.acquisition.rng = np.random.default_rng(7)
    obj_b = float(b._old_objective(b._pending))  # under the proposing state
    prop_a = a.propose_evaluation()

    b.gp.set_hyperparameters(b.gp.fit_device())
    b.mu_max = b.y.max()
    b.acquisition.update_gp(b.gp)
    cand = b.acquisition._tensor(b._candidate_clouds())
    z, f = b._cloud_multistart(cand, b.acquisition.gp_state())
    prop_b = b._to_box(z.numpy())[0]

    np.testing.assert_allclose(a.gp.hyperpars, b.gp.hyperpars, rtol=1e-10)
    assert a._acq_max_history[-1] == pytest.approx(
        b.acquisition._value_from_objective(obj_b), rel=1e-10)
    assert prop_a == pytest.approx(prop_b, rel=1e-8, abs=1e-8)
    assert a._pending is None and a.iteration_history == [4]


def test_settled_state_equals_explicit_refit():
    a, _ = _two_device_optimisers()
    for _ in range(2):
        nx = a.propose_evaluation()
        a.add_evaluation(np.atleast_1d(nx), np.array([np.sin(2 * nx) + 0.1 * nx]))
    mu = a(np.array([[2.5]]))  # a public read settles the pending refit
    assert a._pending is None and np.isfinite(mu).all()
    L, alpha = a.gp.L.clone(), a.gp.alpha.clone()
    a.gp.set_hyperparameters(a.gp.hyperpars.copy())
    np.testing.assert_allclose(L.numpy(), a.gp.L.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(alpha.numpy(), a.gp.alpha.numpy(), rtol=1e-10,
                               atol=1e-10 * float(alpha.abs().max()))
    # and after a fused proposal too
    nx = a.propose_evaluation()
    a.add_evaluation(np.atleast_1d(nx), np.array([np.sin(2 * nx) + 0.1 * nx]))
    a.propose_evaluation()
    L, alpha = a.gp.L.clone(), a.gp.alpha.clone()
    a.gp.set_hyperparameters(a.gp.hyperpars.copy())
    np.testing.assert_allclose(L.numpy(), a.gp.L.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(alpha.numpy(), a.gp.alpha.numpy(), rtol=1e-10,
                               atol=1e-10 * float(alpha.abs().max()))


def test_histories_flush_on_plain_read():
    a, _ = _two_device_optimisers()
    for _ in range(3):
        nx = a.propose_evaluation()
        a.add_evaluation(np.atleast_1d(nx), np.array([np.sin(2 * nx) + 0.1 * nx]))
        assert a._pending is not None  # refit deferred
    assert len(a.convergence_metric_history) == 3
    assert a._pending is None
    assert len(a.acquisition_max_history) == 3
    assert a.iteration_history == [4, 5, 6] and a.iteration_history[-1] == a.y.size


def test_raising_refit_leaves_pending(monkeypatch):
    a, _ = _two_device_optimisers()
    nx = a.propose_evaluation()
    a.add_evaluation(np.atleast_1d(nx), np.array([np.sin(2 * nx) + 0.1 * nx]))

    def boom(*args, **kw):
        raise RuntimeError("refit failed")

    monkeypatch.setattr(a.gp, "_fit_device_z", boom)
    with pytest.raises(RuntimeError, match="refit failed"):
        a.propose_evaluation()
    assert a._pending is not None
    with pytest.raises(RuntimeError, match="refit failed"):
        a(np.array([[1.0]]))
    assert a._pending is not None
    monkeypatch.undo()
    assert len(a.iteration_history) == 1 and a._pending is None


@pytest.mark.parametrize("optimizer", ["bfgs", "diffev", "device"])
@pytest.mark.parametrize("acquisition", [ExpectedImprovement, UpperConfidenceBound, MaxVariance])
def test_1d_loop(acquisition, optimizer):
    x = np.array([0.5, 2.0, 3.5])
    opt = tgp.GpOptimiser(x, objective_1d(x), bounds=[(0.0, 4.0)], acquisition=acquisition,
                          optimizer=optimizer, device="cpu")
    for _ in range(3):
        nx = float(np.atleast_1d(opt.propose_evaluation())[0])
        assert 0.0 <= nx <= 4.0
        opt.add_evaluation(np.array([nx]), np.array([objective_1d(nx)]))
    assert opt.y.size == 6
    assert len(opt.convergence_metric_history) == 3
    assert opt.iteration_history == [4, 5, 6]


def test_2d_loop():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 3, size=(5, 2))
    y = np.array([objective_2d(v) for v in x])
    opt = tgp.GpOptimiser(x, y, bounds=[(0.0, 3.0), (0.0, 3.0)], optimizer="device", device="cpu")
    for _ in range(3):
        nx = np.asarray(opt.propose_evaluation())
        assert ((nx >= 0) & (nx <= 3)).all()
        opt.add_evaluation(nx, np.array([objective_2d(nx.flatten())]))
    assert opt.y.size == 8


def test_finds_maximum():
    x = np.array([0.5, 1.5, 2.5, 3.5])
    opt = tgp.GpOptimiser(x, objective_1d(x), bounds=[(0.0, 4.0)], optimizer="device",
                          device="cpu")
    for _ in range(5):
        nx = float(np.atleast_1d(opt.propose_evaluation())[0])
        opt.add_evaluation(np.array([nx]), np.array([objective_1d(nx)]))
    true_max = objective_1d(np.linspace(0, 4, 2000)).max()
    assert opt.y.max() > true_max - 0.05


def test_y_err_requirement():
    x = np.array([0.5, 2.0, 3.5])
    opt = tgp.GpOptimiser(x, objective_1d(x), bounds=[(0.0, 4.0)], y_err=np.full(3, 0.01),
                          hyperpars=np.array([0.5, 1.0, 0.0]), device="cpu")
    with pytest.raises(ValueError):
        opt.add_evaluation(np.array([1.0]), np.array([objective_1d(1.0)]))


def test_plot_results(tmp_path):
    pytest.importorskip("matplotlib")
    x = np.array([0.5, 2.0, 3.5])
    opt = tgp.GpOptimiser(x, objective_1d(x), bounds=[(0.0, 4.0)], optimizer="device",
                          device="cpu")
    nx = float(np.atleast_1d(opt.propose_evaluation())[0])
    opt.add_evaluation(np.array([nx]), np.array([objective_1d(nx)]))
    opt.plot_results(filename=str(tmp_path / "bo.png"), show_plot=False)
    assert (tmp_path / "bo.png").exists() and opt._pending is None
