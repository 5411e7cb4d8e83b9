"""The matrix-free small-noise GP (``LargeScaleGP(solver="df64")``) of the
PyTorch port against the JAX package and against dense float64 truth, on
the CPU (kernels B2-B8 run their plain versions there), in float64.

Tolerances, with reasons: the training solve's float64 residual 3e-8 (the
JAX test's bound; the port's FP64 operator reaches ~1e-12 here); means
1e-6 against the dense truth and against the JAX instance (the JAX test's
bound, set by its pair arithmetic's ~1e-8 operator noise amplified by
|alpha| ~ 1/sigma^2); the pivoted Cholesky factor 1e-12 (the same float64
algorithm, exp and summation order differ by an ulp); variances 1e-7
against the dense truth (the JAX test's); a converted instance's means
1e-10 (one alpha, two float64 cross-covariances).
"""

import numpy as np
import pytest
import torch

from inference_tpu.gp import LargeScaleGP as JaxLargeScaleGP
from inference_tpu.gp import large_scale as jls
from inference_tpu_torch import convert
from inference_tpu_torch.gp import LargeScaleGP, RationalQuadratic, SquaredExponential, WhiteNoise
from inference_tpu_torch.gp import large_scale as tls
from inference_tpu_torch.parallel import chain_mesh

THETA = np.array([0.0, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_noise_problem(n, seed, noise=0.0):
    """tests/gp/test_LargeScaleGP.py's small-noise problem: x uniform on
    [0, 8]^2, y = sin x0 cos(x1/2), sigma = 0.01."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 8, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(0.5 * x[:, 1]) + noise * rng.normal(size=n)
    return x, y, np.full(n, 0.01), rng


def dense_truth(x, y, err, q, mean):
    sq = lambda a, b: ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    K = np.exp(-0.5 * sq(x, x)) + np.diag(err**2 + 1e-12)
    Kq = np.exp(-0.5 * sq(q, x))
    mu = Kq @ np.linalg.solve(K, y - mean) + mean
    var = 1.0 - np.einsum("ij,ij->i", Kq, np.linalg.solve(K, Kq.T).T)
    return mu, var


KW = dict(hyperpars=THETA, block_size=128, preconditioner_rank=128, solver="df64",
          cg_tol=1e-9, cg_maxiter=3000)


@pytest.fixture(scope="module")
def pair():
    """test_LargeScaleGP.py::test_df64_solver_small_noise's problem (n = 512,
    sigma = 0.01, rank 128, block 128) in both packages: the JAX instance
    once (its pair kernels run in interpret mode), and the port's."""
    x, y, err, rng = small_noise_problem(512, seed=7)
    jgp = JaxLargeScaleGP(x, y, err, dtype="float32", **KW)
    tgp = LargeScaleGP(x, y, err, device="cpu", **KW)
    q = rng.uniform(1, 7, size=(300, 2))
    return {"x": x, "y": y, "err": err, "q": q, "jax": jgp, "port": tgp}


def test_training_solve_residual(pair):
    gp = pair["port"]
    res = gp.residual_norm_f64(residual_backend="host")
    assert res < 3e-8
    assert abs(gp.residual_norm_f64() - res) < 1e-8  # "auto" is the df64 operator
    assert gp.alpha.dtype == torch.float64 and gp.alpha64.shape == (512,)


def test_residual_norm_is_the_fp64_relative_residual(pair):
    """``residual_norm()`` (the JAX package's name) against a numpy
    |K alpha - b| / |b| from the dense float64 K and the port's alpha, and
    within the JAX tests' 1e-6 bound. The two agree to 1e-12 of |b|: both
    sum the same FP64 products in other orders, and the residual itself is
    about 7e-13 here, so a bound relative to it would measure rounding."""
    gp, x, y, err = pair["port"], pair["x"], pair["y"], pair["err"]
    K = np.exp(-0.5 * ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)) + np.diag(err**2 + 1e-12)
    b = y - gp.mean_value
    truth = np.linalg.norm(K @ gp.alpha64 - b) / np.linalg.norm(b)
    res = gp.residual_norm()
    assert isinstance(res, float)
    assert abs(res - truth) <= 1e-12
    assert res <= 1e-6


def test_residual_norm_of_an_unconverged_solve():
    """Far from rounding (a solve cut at 3 iterations with a rank-8
    preconditioner; n = 300, padded to 384), ``residual_norm()`` is numpy's
    |K alpha - b| / |b| over the real rows to 1e-8 relative."""
    x, y, err, _ = small_noise_problem(300, seed=5)
    with pytest.warns(UserWarning, match="stopped after"):
        gp = LargeScaleGP(x, y, err, device="cpu",
                          **{**KW, "preconditioner_rank": 8, "cg_maxiter": 3})
    K = np.exp(-0.5 * ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)) + np.diag(err**2 + 1e-12)
    b = y - gp.mean_value
    truth = np.linalg.norm(K @ gp.alpha64[:300] - b) / np.linalg.norm(b)
    res = gp.residual_norm()
    assert truth > 1e-6
    assert abs(res - truth) <= 1e-8 * truth


@pytest.fixture(scope="module")
def default_dtype_alpha():
    x, y, err, _ = small_noise_problem(256, seed=3)
    kw = {**KW, "preconditioner_rank": 64}
    return (x, y, err, kw), LargeScaleGP(x, y, err, device="cpu", **kw).alpha64


@pytest.mark.parametrize("dtype", ["float32", "float64", np.float32, torch.float64])
def test_dtype_is_taken_and_changes_nothing(default_dtype_alpha, dtype):
    """The JAX package's ``dtype`` (``tests/gp/test_LargeScaleGP.py`` passes
    "float32" with the df64 solver): the port's tier is FP64 throughout, so
    alpha is the same bit for bit as with ``dtype=None``."""
    (x, y, err, kw), alpha = default_dtype_alpha
    gp = LargeScaleGP(x, y, err, dtype=dtype, device="cpu", **kw)
    assert np.array_equal(gp.alpha64, alpha)


@pytest.mark.parametrize("dtype", ["int8", torch.int32, "bogus"])
def test_other_dtypes_raise(dtype):
    x, y, err, _ = small_noise_problem(64, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        LargeScaleGP(x, y, err, dtype=dtype, device="cpu", **KW)


def test_means_match_dense_truth_and_jax(pair):
    """300 queries (the 256-wide mean blocks and a ragged one)."""
    x, y, err, q = pair["x"], pair["y"], pair["err"], pair["q"]
    mu = pair["port"](q)
    mu_ref, _ = dense_truth(x, y, err, q, y.mean())
    assert np.abs(mu - mu_ref).max() < 1e-6
    assert np.abs(mu - np.asarray(pair["jax"](q))).max() < 1e-6


def test_twenty_dimensions_match_jax_and_dense_truth():
    """d = 20, where the port's kernels raised before (n = 512, sigma =
    0.01, rank 128, block 128; x uniform on [0, 1.5]^20 so that the kernel
    matrix is well filled): the training residual, and 64 means against the
    dense truth and the JAX instance, to this file's bounds."""
    rng = np.random.default_rng(20)
    x = rng.uniform(0, 1.5, size=(512, 20))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + x[:, 2:].mean(axis=1)
    err = np.full(512, 0.01)
    q = rng.uniform(0, 1.5, size=(64, 20))
    kw = {**KW, "hyperpars": np.zeros(21)}
    gp = LargeScaleGP(x, y, err, device="cpu", **kw)
    assert gp.residual_norm_f64(residual_backend="host") < 3e-8
    mu = gp(q)
    mu_ref, _ = dense_truth(x, y, err, q, y.mean())
    assert np.abs(mu - mu_ref).max() < 1e-6
    mu_jax = np.asarray(JaxLargeScaleGP(x, y, err, dtype="float32", **kw)(q))
    assert np.abs(mu - mu_jax).max() < 1e-6


def test_pivoted_cholesky_matches_jax_host_build(pair):
    """The port's device FP64 pivoted Cholesky against the JAX package's
    host float64 build: the same pivots (the argmax of each column, which
    is its pivot's root) and the factor to 1e-12."""
    U, piv = pair["port"]._pivoted_cholesky(128, return_pivots=True)
    U_jax = pair["jax"]._pivoted_cholesky_host(128)
    np.testing.assert_array_equal(piv.numpy(), np.argmax(U_jax, axis=0))
    assert np.abs(U.numpy() - U_jax).max() <= 1e-12


def test_full_rank_pivoted_cholesky_reproduces_kernel_matrix():
    """At full rank the factor reproduces the masked kernel matrix (the JAX
    package's test_host_pivoted_cholesky_quality)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (200, 2))
    gp = LargeScaleGP(x, np.sin(x[:, 0]), np.full(200, 0.1), hyperpars=THETA, block_size=128,
                      preconditioner_rank=64, solver="df64", cg_maxiter=50, device="cpu")
    U = gp._pivoted_cholesky(gp.n_points).numpy()
    xp = gp._x_host
    K = np.exp(-0.5 * ((xp[:, None] - xp[None]) ** 2).sum(-1)) * np.outer(gp._mask, gp._mask)
    assert np.abs(U @ U.T - K).max() < 1e-10


def test_woodbury_application_matches_jax_and_dense(pair):
    """The FP64 Woodbury application against a dense float64 (D + U U^T)^{-1}
    and against the JAX package's woodbury_apply on the same operands."""
    gp = pair["port"]
    U, Cinv, dinv = gp._precond64
    v = np.random.default_rng(11).normal(size=(512, 3))
    A = np.diag(1.0 / dinv.numpy()) + U.numpy() @ U.numpy().T
    truth = np.linalg.solve(A, v)
    z = tls.woodbury_apply(torch.as_tensor(v), U, dinv, Cinv, core_chol=False).numpy()
    assert np.abs(z - truth).max() < 1e-9 * np.abs(truth).max()
    z_jax = np.asarray(jls.woodbury_apply(v, U.numpy(), dinv.numpy(), Cinv.numpy(),
                                          core_chol=False))
    assert np.abs(z - z_jax).max() <= 1e-12 * np.abs(z_jax).max()
    zc = tls.woodbury_apply(torch.as_tensor(v[:, 0]), U, dinv,
                            torch.linalg.cholesky(torch.linalg.inv(Cinv)), core_chol=True)
    assert np.abs(zc.numpy() - truth[:, 0]).max() < 1e-8 * np.abs(truth).max()


def test_sqexp_rows_host64_matches_jax():
    rng = np.random.default_rng(2)
    q, x, h = rng.normal(size=(5, 3)), rng.normal(size=(40, 3)), [0.3, -0.2, 0.1, 0.4]
    np.testing.assert_array_equal(tls.sqexp_rows_host64(q, x, h), jls.sqexp_rows_host64(q, x, h))


def test_variances_match_dense_truth():
    """test_LargeScaleGP.py::test_df64_small_noise_variances_match_dense_truth's
    problem (n = 640, 8 queries, rank 160) on the port's side: variances of
    ~1e-5 to 1e-4 to 1e-7 absolute, and the means of the same call."""
    x, y, err, rng = small_noise_problem(640, seed=2, noise=0.01)
    q = rng.uniform(0, 8, size=(8, 2))
    gp = LargeScaleGP(x, y, err, hyperpars=THETA, block_size=128, preconditioner_rank=160,
                      solver="df64", cg_tol=1e-9, cg_maxiter=600, device="cpu")
    mu, sd = gp(q, with_variance=True)
    mu_ref, var_ref = dense_truth(x, y, err, q, y.mean())
    assert np.abs(sd**2 - var_ref).max() < 1e-7
    assert np.abs(mu - mu_ref).max() < 1e-6


def test_f32_store_tier_matches_dense_truth_and_jax(pair):
    """store_entries="f32": iterations on the float32 store (B7/B8) in
    chunks of four, refreshes through the fused kernel (B3). The JAX
    package's own test of this tier (``test_df64_stored_f32_tier_matches_
    pair_tier``, n = 512) is marked slow; here the port's instance is held
    to its bounds (residual 3e-8, alpha 1e-6 of the exact-store tier's) and
    to this file's (means against the dense truth and the JAX instance
    1e-6, variances 1e-7)."""
    x, y, err, q = pair["x"], pair["y"], pair["err"], pair["q"]
    gp = LargeScaleGP(x, y, err, device="cpu", store_entries="f32", **KW)
    assert gp._entries_f32 is not None and gp._entries is None and gp._tier == "f32"
    assert gp._entries_f32.dtype == torch.float32
    assert gp._df64_solver.restart_every == 4
    assert gp.residual_norm_f64(residual_backend="host") < 3e-8
    ref = pair["port"].alpha64
    assert np.abs(gp.alpha64 - ref).max() <= 1e-6 * np.abs(ref).max()
    mu, sd = gp(q[:8], with_variance=True)
    mu_ref, var_ref = dense_truth(x, y, err, q[:8], y.mean())
    assert np.abs(mu - mu_ref).max() < 1e-6
    assert np.abs(sd**2 - var_ref).max() < 1e-7
    assert np.abs(gp(q) - np.asarray(pair["jax"](q))).max() < 1e-6


def test_auto_takes_the_f32_store_past_the_fp64_limit(monkeypatch):
    """Between ``STORE_MAX_N`` and ``F32_STORE_MAX_N`` "auto" takes the
    float32 store, unless the soundness guard refuses it: limits lowered so
    that n = 512 lies between them, at sigma = 0.01 the guard accepts, at
    sigma = 1e-5 (2^-24 of the row sums far above 32 sigma^2) it warns and
    the fused kernel serves."""
    from inference_tpu_torch.ops import df64

    monkeypatch.setattr(df64, "STORE_MAX_N", 256)
    x, y, err, _ = small_noise_problem(512, seed=5)
    gp = LargeScaleGP(x, y, err, device="cpu", **KW)
    assert gp._tier == "f32" and gp._entries_f32 is not None
    assert gp.residual_norm_f64(residual_backend="host") < 3e-8
    with pytest.warns(UserWarning, match="falling back"):
        gp = LargeScaleGP(x, y, np.full(512, 1e-5), device="cpu",
                          **{**KW, "preconditioner_rank": 0, "cg_maxiter": 50})
    assert gp._tier is None and gp._entries is None and gp._entries_f32 is None


@pytest.mark.parametrize("store_entries", [True, False])
def test_store_tiers_agree(pair, store_entries):
    """The stored-entries tier (B5/B6) and the fused tier (B3/B4) give the
    same solve."""
    x, y, err = pair["x"], pair["y"], pair["err"]
    gp = LargeScaleGP(x, y, err, device="cpu", store_entries=store_entries, **KW)
    assert (gp._entries is not None) == store_entries
    assert gp.residual_norm_f64(residual_backend="host") < 3e-8
    ref = pair["port"].alpha64
    assert np.abs(gp.alpha64 - ref).max() <= 1e-6 * np.abs(ref).max()


def test_refine_keeps_the_best_iterate(pair):
    """refine() on the df64 route from a perturbed iterate recovers the
    solve and never returns a worse residual."""
    x, y, err = pair["x"], pair["y"], pair["err"]
    gp = LargeScaleGP(x, y, err, device="cpu", **KW)
    gp.alpha64 = gp.alpha64 * (1.0 + 1e-4)
    r0 = gp.residual_norm_f64()
    gp.refine(target=1e-11)
    assert gp.residual_norm_f64() <= min(r0, 1e-9)
    assert gp.alpha.dtype == torch.float64


def test_converted_jax_instance_predicts_the_same_means(pair):
    """A solved JAX instance carried across by large_scale_gp_from_state
    keeps its alpha and factor and predicts its means to 1e-10."""
    jgp = pair["jax"]
    state = convert.large_scale_state_of(jgp)
    assert state["preconditioner_rank"] == 128 and state["U"].shape == (512, 128)
    tgp = convert.large_scale_gp_from_state(state, device="cpu")
    np.testing.assert_array_equal(tgp.alpha64, np.asarray(jgp.alpha64))
    torch.testing.assert_close(tgp._precond64[0], torch.as_tensor(state["U"]))
    q = pair["q"]
    assert np.abs(tgp(q) - np.asarray(jgp(q))).max() < 1e-10


def test_f32_store_soundness_guard():
    """The JAX package's soundness guard for the rounded float32 store,
    kept for that tier: with row sums of E near 1e3, 2^-24 of them exceeds
    32 sigma^2 at sigma = 1e-3, so it refuses (and warns); at sigma = 0.1 it
    accepts."""
    x, y, err, _ = small_noise_problem(1024, seed=1)
    gp = LargeScaleGP(x, y, err, hyperpars=[0.0, 1.5, 1.5], block_size=1024,
                      preconditioner_rank=0, solver="df64", cg_maxiter=1, device="cpu",
                      store_entries=False)
    gp._sig_host = np.full_like(gp._sig_host, 1e-3**2)
    with pytest.warns(UserWarning, match="falling back"):
        assert not gp._f32_store_is_sound()
    gp._sig_host = np.full_like(gp._sig_host, 0.1**2)
    assert gp._f32_store_is_sound()


def _both(fn):
    """Run ``fn(cls, **extra)`` on both packages; return the two errors."""
    errors = []
    for cls, extra in ((JaxLargeScaleGP, {}), (LargeScaleGP, {"device": "cpu"})):
        with pytest.raises(Exception) as info:
            fn(cls, **extra)
        errors.append(info.value)
    return errors


@pytest.mark.parametrize("case", ["padding", "nystrom", "store_flag", "store_value", "solver",
                                  "n_hyperpars"])
def test_validation_matches_jax(case):
    """The JAX package's error paths: the padded count must be a multiple
    of 128, df64 needs pivchol, store_entries is a df64 option with four
    values, the solver name, the hyperparameter count."""
    x, y, err, _ = small_noise_problem(64, seed=0)
    kw = {
        "padding": dict(hyperpars=THETA, block_size=100, solver="df64"),
        "nystrom": dict(hyperpars=THETA, block_size=64, solver="df64", preconditioner="nystrom"),
        "store_flag": dict(hyperpars=THETA, store_entries=True, solver="cg"),
        "store_value": dict(hyperpars=THETA, store_entries="yes", solver="df64"),
        "solver": dict(hyperpars=THETA, solver="bogus"),
        "n_hyperpars": dict(hyperpars=[0.0, 0.0], block_size=128, solver="df64"),
    }[case]
    jax_error, port_error = _both(lambda cls, **extra: cls(x, y, err, **kw, **extra))
    assert type(jax_error) is type(port_error) is ValueError
    assert str(port_error) == str(jax_error)


@pytest.mark.parametrize("case", ["cg", "mixed", "mesh", "rq", "white_noise", "fit"])
def test_unported_options_raise(case):
    """What earlier slices left for later no longer raises: the cg and
    mixed tiers, the RQ and white-noise kernels and ``fit()`` (A11), and
    ``mesh=`` (A13(b): the df64 tier on two CPU cells of a ``chain_mesh``,
    the padded rows split into one 128-row block a cell). Each constructs,
    solves and takes a fit step."""
    x, y, err, _ = small_noise_problem(64, seed=0)
    base = dict(hyperpars=THETA, block_size=128, solver="df64", device="cpu",
                preconditioner_rank=16)
    kw = {
        "cg": dict(solver="cg"),
        "mixed": dict(solver="mixed"),
        "mesh": dict(mesh=chain_mesh(2, device="cpu"), block_size=256),
        "rq": dict(solver="cg", kernel=RationalQuadratic, hyperpars=[0.0, 0.0, 0.0, 0.0]),
        "white_noise": dict(solver="cg", kernel=SquaredExponential() + WhiteNoise(),
                            hyperpars=[0.0, 0.0, 0.0, -2.0]),
        "fit": {},
    }[case]
    gp = LargeScaleGP(x, y, err, **{**base, **kw})
    theta = gp.fit(n_steps=1, fit_maxiter=1000)
    assert theta.shape == gp.hyperpars.shape and np.isfinite(theta).all()
    assert np.isfinite(gp(x[:4], with_variance=True)).all()


def test_deleted_instance_frees_its_entry_store(pair):
    """The solvers hold no reference to the instance, so ``del`` frees the
    (n, n) entry store at once, without the cyclic garbage collector (on
    the card that store is 22.7 GB at N = 50,000)."""
    import gc
    import weakref

    x, y, err = pair["x"], pair["y"], pair["err"]
    gp = LargeScaleGP(x, y, err, device="cpu", **KW)
    gp(pair["q"][:3], with_variance=True)
    store = weakref.ref(gp._entries)
    gc.disable()
    try:
        del gp
        assert store() is None
    finally:
        gc.enable()
