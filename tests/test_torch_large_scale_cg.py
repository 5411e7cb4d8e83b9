"""The matrix-free GP's cg and mixed tiers, its block kernels and its
``fit()`` in the PyTorch port, against the JAX package on the CPU, in
float64 (kernel B2 runs its plain version there).

Problem: n = 200 points uniform on [0, 10]^2, y = sin x0 cos x1 + N(0,
0.1^2), y_err 0.3, blocks of 128 (two blocks after padding). Tolerances,
with reasons:

- block kernel maps 1e-13 (the same formulas; the squared exponential's
  rows from exact differences against JAX's matmul form, both in float64);
- alpha, means and variances 1e-8 of the JAX instance's (relative to the
  largest alpha and mean; variances, which are at most amp^2, absolute):
  both solve to ``cg_tol`` 1e-12, where the two packages' iterates, the
  same arithmetic summed in other orders, agree to about 1e-12;
- ``fit()``'s theta after 3 steps 1e-6: its inner solves run to 1e-9 here,
  since at the default 1e-3 the step at which a column stops is decided by
  rounding on a problem this ill-conditioned (see tests/test_torch_solvers.py);
- a converted instance's means 1e-10 (one alpha, two float64
  cross-covariances).
"""

import numpy as np
import pytest
import torch

from inference_tpu.gp import ChangePoint as JaxChangePoint
from inference_tpu.gp import HeteroscedasticNoise as JaxHeteroscedasticNoise
from inference_tpu.gp import LargeScaleGP as JaxLargeScaleGP
from inference_tpu.gp import RationalQuadratic as JaxRationalQuadratic
from inference_tpu.gp import SquaredExponential as JaxSquaredExponential
from inference_tpu.gp import WhiteNoise as JaxWhiteNoise
from inference_tpu.gp import block_kernels as jbk
from inference_tpu_torch import convert
from inference_tpu_torch.gp import (
    ChangePoint,
    HeteroscedasticNoise,
    LargeScaleGP,
    RationalQuadratic,
    SquaredExponential,
    WhiteNoise,
)
from inference_tpu_torch.gp import block_kernels as tbk

N = 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread_float64():
    n, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(n)
    torch.set_default_dtype(dtype)


def problem(n=N, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.3), rng.uniform(1, 9, (12, 2))


# name: (port kernel, JAX kernel, hyperparameters)
KERNELS = {
    "se": (lambda: SquaredExponential, lambda: JaxSquaredExponential, [0.0, 0.3, 0.3]),
    "rq": (lambda: RationalQuadratic, lambda: JaxRationalQuadratic, [0.0, 0.5, 0.3, 0.3]),
    "se+wn": (lambda: SquaredExponential() + WhiteNoise(),
              lambda: JaxSquaredExponential() + JaxWhiteNoise(), [0.0, 0.3, 0.3, np.log(0.05)]),
    "wn+rq": (lambda: WhiteNoise() + RationalQuadratic(),
              lambda: JaxWhiteNoise() + JaxRationalQuadratic(), [np.log(0.05), 0.0, 0.5, 0.3, 0.3]),
}


# --------------------------------------------------------------------- #
# block kernels
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_block_kernel_maps_match_jax(name):
    port_k, jax_k, theta = KERNELS[name]
    bk = tbk.as_block_kernel(port_k(), "LargeScaleGP")
    jk = jbk.as_block_kernel(jax_k(), "LargeScaleGP")
    assert bk.name == jk.name and bk.supports_df64 == jk.supports_df64 is (name == "se")
    assert bk.n_params(2) == jk.n_params(2) == len(theta)
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0, 4, (7, 2)), rng.uniform(0, 4, (9, 2))
    th = torch.as_tensor(theta)
    close = lambda p, j: np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=0, atol=1e-13)
    close(bk.rows(torch.as_tensor(a), torch.as_tensor(b), th), jk.rows(a, b, np.asarray(theta)))
    close(bk.amp2(th), jk.amp2(np.asarray(theta)))
    close(bk.noise_variance(th), jk.noise_variance(np.asarray(theta)))
    close(bk.rows_host64(a, b, theta), jk.rows_host64(a, b, theta))
    close(bk.amp2_host(theta), jk.amp2_host(theta))
    close(bk.noise_variance_host(theta), jk.noise_variance_host(theta))


def test_block_kernel_tensor_maps_are_differentiable():
    """The fit's gradients come through rows, amp2 and noise_variance."""
    bk = tbk.as_block_kernel(RationalQuadratic() + WhiteNoise(), "LargeScaleGP")
    th = torch.tensor([0.1, 0.5, 0.3, 0.2, -2.0], requires_grad=True)
    x = torch.as_tensor(np.random.default_rng(2).uniform(0, 4, (6, 2)))
    (bk.rows(x, x, th).sum() + bk.amp2(th) + bk.noise_variance(th)).backward()
    assert torch.isfinite(th.grad).all() and (th.grad != 0).all()


# each case: the kernel argument of both packages
ERROR_CASES = {
    "change_point_class": (lambda: ChangePoint, lambda: JaxChangePoint),
    "heteroscedastic_class": (lambda: HeteroscedasticNoise, lambda: JaxHeteroscedasticNoise),
    "se+rq": (lambda: SquaredExponential() + RationalQuadratic(),
              lambda: JaxSquaredExponential() + JaxRationalQuadratic()),
    "se+wn+wn": (lambda: SquaredExponential() + WhiteNoise() + WhiteNoise(),
                 lambda: JaxSquaredExponential() + JaxWhiteNoise() + JaxWhiteNoise()),
    "white_noise_alone": (lambda: WhiteNoise(), lambda: JaxWhiteNoise()),
    "not_a_kernel": (lambda: "bogus", lambda: "bogus"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_as_block_kernel_errors_match_jax(case):
    port_k, jax_k = ERROR_CASES[case]
    with pytest.raises(ValueError) as port:
        tbk.as_block_kernel(port_k(), "LargeScaleGP")
    with pytest.raises(ValueError) as ref:
        jbk.as_block_kernel(jax_k(), "LargeScaleGP")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("name", ["rq", "se+wn"])
def test_df64_tier_refuses_other_kernels_like_jax(name):
    port_k, jax_k, theta = KERNELS[name]
    x, y, err, _ = problem(64)
    kw = dict(hyperpars=theta, block_size=128, solver="df64")
    with pytest.raises(ValueError) as port:
        LargeScaleGP(x, y, err, kernel=port_k(), device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        JaxLargeScaleGP(x, y, err, kernel=jax_k(), **kw)
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------- #
# the cg and mixed tiers against the JAX package
# --------------------------------------------------------------------- #
# (solver, preconditioner, rank, kernel)
CASES = [(s, pc, r, "se") for s in ("cg", "mixed")
         for pc, r in (("pivchol", 64), ("nystrom", 64), ("pivchol", 0))]
CASES += [(s, "pivchol", 64, k) for s in ("cg", "mixed") for k in ("rq", "se+wn")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(map(str, c)) for c in CASES])
def pair(request):
    solver, pc, rank, kernel = request.param
    port_k, jax_k, theta = KERNELS[kernel]
    x, y, err, q = problem()
    kw = dict(hyperpars=theta, block_size=128, preconditioner_rank=rank, preconditioner=pc,
              solver=solver, cg_tol=1e-12, cg_maxiter=3000, dtype="float64")
    jgp = JaxLargeScaleGP(x, y, err, kernel=jax_k(), **kw)
    tgp = LargeScaleGP(x, y, err, kernel=port_k(), device="cpu", **kw)
    return {"jax": jgp, "port": tgp, "q": q, "x": x, "y": y, "err": err}


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def test_alpha_matches_jax(pair):
    port = pair["port"]
    assert port.alpha.dtype == torch.float64
    assert _rel(port.alpha64, pair["jax"].alpha) <= 1e-8
    assert port.residual_norm() <= 1e-11


def test_means_and_variances_match_jax(pair):
    mu, sd = pair["port"](pair["q"], with_variance=True)
    mu_j, sd_j = pair["jax"](pair["q"], with_variance=True)
    assert _rel(mu, mu_j) <= 1e-8
    assert np.abs(sd**2 - np.asarray(sd_j) ** 2).max() <= 1e-8
    np.testing.assert_array_equal(pair["port"](pair["q"]), mu)


def test_preconditioner_factor_matches_jax(pair):
    """The pivoted Cholesky (first-maximum pivots) and Nystrom (the same
    numpy draw of inducing rows) factors, 1e-10 of amp^2."""
    port, ref = pair["port"], pair["jax"]
    if port._precond is None:
        assert ref._precond is None
        return
    assert np.abs(port._precond[0].numpy() - np.asarray(ref._precond[0])).max() <= 1e-10


def test_pivoted_cholesky_builds_in_float64_for_every_tier():
    """The factor is built in FP64 from the float64 coordinates whatever the
    working dtype: a float32 instance's factor is the float64 instance's
    cast to float32. Past the kernel's numerical rank (three distinct
    points, forty copies each) the factor's columns are zero and finite,
    and U U^T reproduces K to 1e-12."""
    x, y, err, _ = problem()
    kw = dict(hyperpars=[0.0, 0.3, 0.3], block_size=128, preconditioner_rank=32, cg_maxiter=1)
    f64 = LargeScaleGP(x, y, err, dtype="float64", device="cpu", **kw)._pivoted_cholesky(32)
    f32 = LargeScaleGP(x, y, err, dtype="float32", device="cpu", **kw)._pivoted_cholesky(32)
    assert f32.dtype == torch.float32
    torch.testing.assert_close(f32, f64.float(), rtol=0, atol=0)
    x3 = np.repeat(np.array([[0.0, 0.0], [1.0, 0.5], [3.0, 2.0]]), 40, axis=0)
    gp = LargeScaleGP(x3, np.sin(x3[:, 0]), np.full(120, 0.1), hyperpars=[0.0, 0.0, 0.0],
                      block_size=128, preconditioner_rank=10, dtype="float64", device="cpu")
    U = gp._pivoted_cholesky(10).numpy()[:120]
    K = np.exp(-0.5 * ((x3[:, None] - x3[None]) ** 2).sum(-1))
    assert np.isfinite(U).all() and not U[:, 4:].any()
    assert np.abs(U @ U.T - K).max() <= 1e-12


def test_cg_counts_its_iterations(pair):
    """The cg tier keeps its training solve's iteration count (the JAX
    package's attribute holds None: its cg reports none); the mixed tier's
    info carries none either."""
    port = pair["port"]
    if port.solver == "cg":
        assert 0 < port.cg_iterations_estimate < 3000
    else:
        assert port.cg_iterations_estimate is None


@pytest.fixture(scope="module")
def loose():
    """cg at cg_tol 1e-4 in both packages (rank 64), for refine()."""
    x, y, err, _ = problem()
    kw = dict(hyperpars=[0.0, 0.3, 0.3], block_size=128, preconditioner_rank=64,
              cg_tol=1e-4, dtype="float64")
    return (x, y, err), JaxLargeScaleGP(x, y, err, **kw), LargeScaleGP(x, y, err, device="cpu", **kw)


def test_residual_norm_matches_jax_and_numpy(loose):
    """A loose solve's residual (3e-7), by the port against the JAX
    package's and against numpy's dense |K alpha - b| / |b|, 1e-8
    relative."""
    (x, y, err), jgp, tgp = loose
    K = np.exp(-0.5 * (((x[:, None] - x[None]) / np.exp(0.3)) ** 2).sum(-1)) + np.diag(err**2 + 1e-12)
    b = y - tgp.mean_value
    truth = np.linalg.norm(K @ tgp.alpha64[:N] - b) / np.linalg.norm(b)
    res = tgp.residual_norm()
    assert 1e-9 < res < 1e-4
    assert abs(res - truth) <= 1e-8 * truth
    assert abs(res - jgp.residual_norm()) <= 1e-8 * truth
    assert abs(tgp.residual_norm_f64() - truth) <= 1e-8 * truth
    assert abs(tgp.residual_norm_f64("host") - truth) <= 1e-8 * truth


def test_refine_matches_jax(loose):
    """refine() from the loose solve: both packages reach 1e-11 through
    their float64 device residual and agree on alpha64 to 1e-8."""
    (x, y, err), jgp, tgp = loose
    jgp.refine(target=1e-11)
    tgp.refine(target=1e-11)
    assert tgp.residual_norm_f64() <= 1e-11
    assert _rel(tgp.alpha64, jgp.alpha64) <= 1e-8
    assert tgp.alpha.dtype == torch.float64


def test_float32_tier_refines_to_float64_residuals():
    """The JAX package's test_iterative_refinement_small_noise on the port:
    n = 512, sigma = 0.01, rank 128, dtype float32. The float32 solve alone
    stops far above float64 level; refine() reaches 3e-9 and alpha64 the
    dense float64 solve to 3e-5 (kappa times the residual)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 8, size=(512, 2))
    y = np.sin(x[:, 0]) * np.cos(0.5 * x[:, 1])
    err = np.full(512, 0.01)
    gp = LargeScaleGP(x, y, err, hyperpars=[0.0, 0.0, 0.0], block_size=128,
                      preconditioner_rank=128, dtype="float32", device="cpu")
    assert gp._x.dtype == gp.alpha.dtype == torch.float32 and gp.alpha64.dtype == np.float64
    r32 = gp.residual_norm_f64()
    gp.refine(target=1e-9)
    assert gp.residual_norm_f64() < min(3e-9, 1e-2 * r32)
    K = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1)) + np.diag(err**2 + 1e-12)
    direct = np.linalg.solve(K, y - gp.mean_value)
    assert _rel(gp.alpha64[:512], direct) < 3e-5


@pytest.mark.parametrize("default", [torch.float32, torch.float64])
def test_dtype_none_is_the_default_float(default):
    x, y, err, _ = problem(64)
    torch.set_default_dtype(default)
    try:
        gp = LargeScaleGP(x, y, err, hyperpars=[0.0, 0.3, 0.3], block_size=128,
                          preconditioner_rank=16, device="cpu")
    finally:
        torch.set_default_dtype(torch.float64)
    assert gp._x.dtype == gp.alpha.dtype == default
    explicit = LargeScaleGP(x, y, err, hyperpars=[0.0, 0.3, 0.3], block_size=128,
                            preconditioner_rank=16, device="cpu", dtype=np.float32)
    assert explicit._x.dtype == torch.float32


# --------------------------------------------------------------------- #
# fit()
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("solver, kernel", [("cg", "se"), ("df64", "se"), ("mixed", "se+wn")])
def test_fit_matches_jax(solver, kernel):
    """Three Adam steps from a poor theta with the same seed and probes,
    the preconditioner rebuilt at the live theta after two: theta within
    1e-6 of the JAX package's; neither instance changes."""
    port_k, jax_k, theta = KERNELS[kernel]
    theta0 = np.asarray(theta) + np.r_[0.5, 0.5, 0.5, np.zeros(len(theta) - 3)]
    x, y, err, _ = problem()
    kw = dict(hyperpars=theta0, block_size=128, preconditioner_rank=64, solver=solver,
              cg_tol=1e-8, dtype="float64")
    fit = dict(n_steps=3, learning_rate=0.1, n_probes=4, seed=1, precond_every=2, fit_tol=1e-9,
               fit_maxiter=1000)
    jgp = JaxLargeScaleGP(x, y, err, kernel=jax_k(), **kw)
    tgp = LargeScaleGP(x, y, err, kernel=port_k(), device="cpu", **kw)
    alpha = tgp.alpha64.copy()
    theta_j = jgp.fit(**fit)
    theta_t = tgp.fit(**fit)
    assert isinstance(theta_t, np.ndarray) and theta_t.dtype == np.float64
    assert np.abs(theta_t - theta_j).max() <= 1e-6
    assert np.abs(theta_t - theta0).max() > 0.1
    np.testing.assert_array_equal(tgp.hyperpars, theta0)
    np.testing.assert_array_equal(tgp.alpha64, alpha)


def test_fit_n_probes_zero_raises_like_jax():
    x, y, err, _ = problem(64)
    kw = dict(hyperpars=[0.0, 0.3, 0.3], block_size=128, preconditioner_rank=0)
    with pytest.raises(ValueError) as port:
        LargeScaleGP(x, y, err, device="cpu", **kw).fit(n_probes=0)
    with pytest.raises(ValueError) as ref:
        JaxLargeScaleGP(x, y, err, **kw).fit(n_probes=0)
    assert str(port.value) == str(ref.value)


def test_fit_warns_once_on_a_biased_step(recwarn):
    """An inner solve cut at one iteration leaves a biased gradient: one
    warning for the whole fit, as in the JAX package; the step cache holds
    one entry per (fit_tol, fit_maxiter, use_precond)."""
    x, y, err, _ = problem(64)
    gp = LargeScaleGP(x, y, err, hyperpars=[0.5, 0.8, 0.8], block_size=128,
                      preconditioner_rank=16, device="cpu")
    gp.fit(n_steps=3, fit_maxiter=1)
    biased = [w for w in recwarn if "substantially biased" in str(w.message)]
    assert len(biased) == 1
    gp.fit(n_steps=1, fit_maxiter=1)
    assert list(gp._fit_step_cache) == [(1e-3, 1, True)]


def test_fit_precond_refresh_inverts_live_theta_system():
    """The JAX package's test of the same name on the port: at near-full
    rank the preconditioner rebuilt at a new theta inverts the system at
    that theta to 1e-2, and the stale one does not."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 10, size=(150, 2))
    y = np.sin(x[:, 0]) + rng.normal(0, 0.05, 150)
    gp = LargeScaleGP(x, y, np.full(150, 0.05), hyperpars=[0.0, 0.3, 0.3], block_size=64,
                      preconditioner_rank=140, device="cpu")
    theta_new = torch.tensor([0.4, 0.9, 0.7])

    def apply_M(pc, V):
        Up, dinv, Cinv = pc
        W = V * dinv[:, None]
        return W - dinv[:, None] * (Up @ (Cinv @ (Up.T @ W)))

    fresh = gp._fit_precond(theta_new)
    stale = gp._fit_precond(torch.as_tensor(gp.hyperpars))
    v = torch.as_tensor(rng.normal(size=(gp._n_padded, 1)) * gp._mask[:, None])
    Av = gp._system_matmat(theta_new, v)
    rel = lambda pc: float(torch.linalg.norm(apply_M(pc, Av) - v) / torch.linalg.norm(v))
    assert rel(fresh) < 1e-2
    assert rel(stale) > 10 * rel(fresh)


# --------------------------------------------------------------------- #
# convert
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("solver, pc, kernel",
                         [("cg", "pivchol", "se"), ("mixed", "nystrom", "se"),
                          ("cg", "pivchol", "wn+rq"), ("df64", "pivchol", "se")])
def test_large_scale_state_round_trip(solver, pc, kernel):
    """A solved JAX instance carried across keeps its tier, kernel, alpha
    and factor and predicts its means to 1e-10; the port's own instance
    carried across again is the same model."""
    port_k, jax_k, theta = KERNELS[kernel]
    x, y, err, q = problem()
    jgp = JaxLargeScaleGP(x, y, err, kernel=jax_k(), hyperpars=theta, block_size=128,
                          preconditioner_rank=32, preconditioner=pc, solver=solver,
                          cg_tol=1e-10, dtype="float64")
    state = convert.large_scale_state_of(jgp)
    assert state["solver"] == solver and state["U"].shape == (256, 32)
    tgp = convert.large_scale_gp_from_state(state, device="cpu")
    assert tgp.solver == solver and tgp._bk.name == jgp._bk.name
    np.testing.assert_array_equal(tgp.alpha64, state["alpha64"])
    np.testing.assert_array_equal(tgp._factor().numpy(), state["U"])
    assert np.abs(tgp(q) - np.asarray(jgp(q))).max() <= 1e-10 * np.abs(np.asarray(jgp(q))).max()
    again = convert.large_scale_gp_from_state(convert.large_scale_state_of(tgp), device="cpu")
    np.testing.assert_array_equal(again(q), tgp(q))
