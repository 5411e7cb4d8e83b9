"""The batched HMC transition of the PyTorch port
(inference_tpu_torch/mcmc/_kernels/hmc.py and parallel/_kinds.py): one
transition from injected draws against the JAX package's mirror, the mass
maps, and sampling statistics for every mass form and both retry modes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from inference_tpu.mcmc._kernels.common import AdaptiveScale as JaxScale
from inference_tpu.ops import hmc_fused as jax_fused
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.mcmc._kernels import hmc
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.parallel._kinds import build_kind, build_mass_maps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


COV = np.array([[1.0, 0.6], [0.6, 1.0]])


def _transition_inputs(P, K, n, seed):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(P, P)) / np.sqrt(P)
    A = np.linalg.inv(B @ B.T + np.eye(P))
    A = 0.5 * (A + A.T)
    theta = rng.normal(0, 0.7, (K, P))
    num = rng.integers(0, 20, K).astype(np.int32)
    eps = dict(value=rng.uniform(0.1, 0.4, K), avg=num * rng.uniform(0.4, 0.9, K),
               var=num * 0.2, num=num, chk_int=rng.choice([15, 20], K).astype(np.int32))
    z = rng.normal(size=(n, K, P))
    return A, theta, eps, z, rng.uniform(size=(n, K)), rng.uniform(size=(n, K))


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("diag_mass", [False, True])
def test_step_matches_jax_mirror_float64(float64, n, diag_mass):
    """``n`` retry=False transitions with injected draws equal the JAX
    package's fused-kernel mirror on the same draws to 1e-10 in float64:
    for step counts >= 1 and diagonal mass the two are the same
    transition."""
    P, K, steps = 4, 64, 12
    A, theta, eps, z, us, ua = _transition_inputs(P, K, n, seed=n + 3 * diag_mass)
    im = np.array([1.0, 4.0, 0.25, 16.0]) if diag_mass else None

    form = GaussianForm(torch.as_tensor(A))
    init, step = build_kind("hmc", form, P, torch.float64, "cpu",
                            steps=steps, inverse_mass=im, retry=False)
    state = init(torch.as_tensor(theta), form(torch.as_tensor(theta)))
    state = state._replace(eps=AdaptiveScale(*(torch.as_tensor(eps[k]) for k in AdaptiveScale._fields)))
    outs = []
    for i in range(n):
        state, out = step(state, None, torch.as_tensor(z[i]), torch.as_tensor(us[i]),
                          torch.as_tensor(ua[i]))
        outs.append(out)

    Aj = jnp.asarray(A)
    logp_fn = lambda t: -0.5 * t @ Aj @ t
    row = lambda x: jnp.asarray(x).reshape(1, K)
    t, lp, e, hist = jax_fused._reference_chunk(
        jnp.asarray(theta.T), jax_fused._batch_posterior(logp_fn)(jnp.asarray(theta.T))[0],
        JaxScale(*(row(eps[k]) for k in JaxScale._fields)), jnp.ones((1, K)),
        jnp.asarray(np.swapaxes(z, 1, 2)), jnp.asarray(us)[:, None, :],
        jnp.asarray(ua)[:, None, :], logp_fn=logp_fn, steps=steps, inv_mass_diag=im,
    )
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(state.theta.numpy(), np.asarray(t).T, **tol)
    np.testing.assert_allclose(state.logp.numpy(), np.asarray(lp)[0], **tol)
    for ours, theirs in zip(state.eps[:3], e[:3]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs)[0], **tol)
    np.testing.assert_array_equal(state.eps.num.numpy(), np.asarray(e.num)[0])
    np.testing.assert_array_equal(state.eps.chk_int.numpy(), np.asarray(e.chk_int)[0])
    ht, hp, hs, he = (np.asarray(h) for h in hist)
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out.theta.numpy(), ht[i].T, **tol)
        np.testing.assert_allclose(out.logp.numpy(), hp[i, 0], **tol)
        np.testing.assert_array_equal(out.leapfrog_steps.numpy(), hs[i, 0])
        np.testing.assert_allclose(out.epsilon.numpy(), he[i, 0], **tol)
    assert not state.failed.any()


def test_init_hmc_state_shapes():
    theta = torch.zeros(5, 3)
    s = hmc.init_hmc_state(theta, torch.zeros(5), 0.3, inv_temp=0.5, steps=7)
    assert s.eps.value.shape == (5,) and s.eps.num.dtype == torch.int32
    assert int(s.eps.chk_int[0]) == hmc.EPS_CHK_INT
    assert s.failed.dtype == torch.bool and not s.failed.any()
    assert float(s.inv_temp[0]) == 0.5 and int(s.steps[0]) == 7


def test_run_steps_store_modes():
    form = GaussianForm(torch.eye(2))
    init, step = build_kind("hmc", form, 2, torch.float32, "cpu", steps=5, retry=False)
    theta = torch.full((8, 2), 0.3)
    state = init(theta, form(theta))
    s1, outs = hmc.run_steps(step, state, 4, True, torch.Generator().manual_seed(2))
    s2, none = hmc.run_steps(step, state, 4, False, torch.Generator().manual_seed(2))
    assert none is None
    assert outs.theta.shape == (4, 8, 2) and outs.leapfrog_steps.shape == (4, 8)
    torch.testing.assert_close(s1.theta, s2.theta, rtol=0, atol=0)
    _, empty = hmc.run_steps(step, state, 0, True, torch.Generator())
    assert empty.theta.shape == (0, 8, 2) and empty.logp.shape == (0, 8)


def test_mass_maps(float64):
    """Diagonal: velocity m*r and momentum z/sqrt(m); full: velocity M^-1 r
    and momentum L^-T z, whose covariance is M."""
    vel, mom = build_mass_maps(3, torch.float64, "cpu", np.array([1.0, 4.0, 0.25]))
    r = torch.ones(2, 3)
    torch.testing.assert_close(vel(r), torch.tensor([[1.0, 4.0, 0.25]] * 2))
    torch.testing.assert_close(mom(r), torch.tensor([[1.0, 0.5, 2.0]] * 2))
    vel, mom = build_mass_maps(2, torch.float64, "cpu", 2.0)
    torch.testing.assert_close(vel(torch.ones(1, 2)), torch.full((1, 2), 2.0))

    inv_mass = np.array([[2.0, 0.5], [0.5, 1.0]])
    vel, mom = build_mass_maps(2, torch.float64, "cpu", inv_mass)
    r = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 2)))
    np.testing.assert_allclose(vel(r).numpy(), r.numpy() @ inv_mass.T, rtol=1e-12)
    rows = mom(torch.eye(2)).numpy()  # row i is L^-T e_i
    np.testing.assert_allclose(rows.T @ rows, np.linalg.inv(inv_mass), rtol=1e-12)
    with pytest.raises(ValueError, match="positive"):
        build_mass_maps(2, torch.float64, "cpu", np.array([1.0, -1.0]))
    with pytest.raises(ValueError, match="do not match"):
        build_mass_maps(2, torch.float64, "cpu", np.eye(3))


def _sample(inverse_mass=None, retry=False, n=300, K=96, seed=7, cov=COV, eps=0.4):
    form = GaussianForm(torch.as_tensor(np.linalg.inv(cov)))
    starts = np.random.default_rng(seed).normal(0, 0.3, (K, cov.shape[0])) * np.sqrt(np.diag(cov))
    ca = ChainArray("hmc", form, starts, steps=12, epsilon=eps, retry=retry,
                    inverse_mass=inverse_mass, seed=seed, device="cpu")
    ca.advance(n, store=True)
    return ca, ca.get_sample(burn=100)


@pytest.mark.parametrize("inverse_mass", [None, 0.5, np.array([1.0, 2.0]), COV])
def test_mass_forms_sample_correlated_gaussian(inverse_mass):
    """Unit, scalar, diagonal and full inverse mass all sample the
    correlated 2-D Gaussian: pooled mean within 0.1, covariance within 0.15
    (the tolerances of the JAX package's sampler tests)."""
    _, sample = _sample(inverse_mass)
    assert abs(sample.mean(axis=0)).max() < 0.1
    np.testing.assert_allclose(np.cov(sample.T), COV, atol=0.15)


def test_diag_mass_badly_scaled():
    scales = np.array([1.0, 25.0])
    _, sample = _sample(scales**2, cov=np.diag(scales**2), eps=0.5)
    np.testing.assert_allclose(sample.std(axis=0), scales, rtol=0.25)


def test_retry_sampling_statistics():
    """repeat-until-accept: every chain accepts every transition, the
    leapfrog count covers every attempt, and the moments are right."""
    ca, sample = _sample(retry=True, n=220, K=32)
    assert not ca._state.failed.any()
    assert abs(sample.mean(axis=0)).max() < 0.1
    np.testing.assert_allclose(np.cov(sample.T), COV, atol=0.15)
    h = np.concatenate(ca._history)
    assert (np.abs(np.diff(h, axis=0)).max(axis=2) > 0).all()


def test_retry_counts_every_attempt():
    form = GaussianForm(torch.eye(2))
    init, step = build_kind("hmc", form, 2, torch.float32, "cpu", steps=10,
                            epsilon=1.6, retry=True)
    theta = torch.full((32, 2), 0.5)
    _, out = step(init(theta, form(theta)), torch.Generator().manual_seed(0))
    # a large step size is rejected often: some chains needed several attempts
    assert (out.leapfrog_steps >= 9).all() and (out.leapfrog_steps > 11).any()


def test_retry_rejects_injected_draws():
    form = GaussianForm(torch.eye(2))
    init, step = build_kind("hmc", form, 2, torch.float32, "cpu", retry=True)
    theta = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="retry=False"):
        step(init(theta, form(theta)), None, z=torch.zeros(4, 2))


def test_bounds_not_ported():
    """Reflecting bounds run on the batched transition (the bounded
    leapfrog, tests/test_torch_bounds.py) but not in the fused kernel, which
    refuses them as the JAX package's does."""
    from inference_tpu_torch.utils import Bounds

    bounds = Bounds(np.full(2, -1.0), np.full(2, 1.0))
    ca = ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((4, 2)), bounds=bounds,
                    retry=False, seed=0, device="cpu")
    ca.advance(5)
    assert bounds.inside(ca.get_sample())
    with pytest.raises(ValueError, match="reflecting bounds"):
        ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((4, 2)), bounds=bounds,
                   retry=False, fused=True, device="cpu")

