"""The PyTorch port's batched-HMC slice end to end on the CPU
(inference_tpu_torch.parallel.ChainArray with fused=True runs kernel B1's
plain version there), checkpoints shared with the JAX package, and the
diagnostics and utilities against the JAX package's."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from inference_tpu.parallel import ChainArray as JaxChainArray
from inference_tpu.utils import diagnostics as jax_diag
from inference_tpu.utils import ess as jax_ess
from inference_tpu_torch import convert
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.utils import (
    as_device_logp,
    default_float,
    diagnostics,
    effective_sample_size,
    effective_sample_size_batched,
    make_generator,
)


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


def bench_cov():
    """The covariance of bench.py's 10-dim correlated Gaussian."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(10, 10)) / np.sqrt(10)
    return A @ A.T + np.eye(10)


# --------------------------------------------------------------------- #
# the slice end to end
# --------------------------------------------------------------------- #
def test_fused_chain_array_2d_statistics():
    """ChainArray('hmc', GaussianForm, fused=True) on the correlated 2-D
    Gaussian: pooled moments within the tolerances of the JAX package's
    test, and the step size adapted."""
    cov = np.array([[1.0, 0.6], [0.6, 1.0]])
    starts = np.random.default_rng(0).normal(0, 0.3, (128, 2))
    ca = ChainArray("hmc", convert.gaussian_form_from_numpy(np.linalg.inv(cov)), starts,
                    steps=12, epsilon=0.4, retry=False, fused=True, device="cpu", seed=7)
    assert ca._fused_plan is not None
    ca.advance(400, store=True)
    sample = ca.get_sample(burn=100)
    assert sample.shape == (300 * 128, 2)
    assert abs(sample.mean(axis=0)).max() < 0.1
    np.testing.assert_allclose(np.cov(sample.T), cov, atol=0.15)
    assert np.any(ca._state.eps.value.numpy() != np.float32(0.4))


def test_fused_chain_array_bench_posterior():
    """The bench.py workload (P=10, steps=50, epsilon=0.25) through the
    fused path: every marginal variance within 15% and every mean within
    0.15 standard deviations, R-hat below 1.05, ESS positive."""
    cov = bench_cov()
    starts = np.random.default_rng(0).normal(0, 0.1, (128, 10))
    ca = ChainArray("hmc", GaussianForm(torch.as_tensor(np.linalg.inv(cov))), starts,
                    steps=50, epsilon=0.25, retry=False, fused=True, device="cpu", seed=1)
    ca.advance(400, store=True)
    sample = ca.get_sample(burn=100)
    sd = np.sqrt(np.diag(cov))
    assert (np.abs(sample.mean(axis=0)) / sd).max() < 0.15
    np.testing.assert_allclose(sample.var(axis=0), np.diag(cov), rtol=0.15)
    assert ca.rhat(burn=100).max() < 1.05
    ess = ca.effective_sample_size(burn=100)
    assert ess.shape == (128, 10) and (ess > 0).all()


def test_set_inverse_mass_and_warmup_rebuild_the_plan():
    form = GaussianForm(torch.as_tensor(np.diag([1.0, 1 / 16.0])))
    starts = np.random.default_rng(3).normal(0, 0.3, (64, 2))
    ca = ChainArray("hmc", form, starts, steps=10, epsilon=0.3, retry=False,
                    fused=True, seed=3, device="cpu")
    ca.set_inverse_mass(4.0)
    assert ca._fused_plan.inv_mass_diag == (4.0, 4.0)
    ca.warmup(n_steps=60, n_windows=2)
    im = np.asarray(ca._fused_plan.inv_mass_diag)
    assert im[1] > 4 * im[0]  # the wide parameter got the larger inverse mass
    assert ca._history == [] and ca.get_sample().shape == (0, 2)
    with pytest.raises(ValueError, match="full-matrix"):
        ca.set_inverse_mass(np.eye(2))
    with pytest.raises(ValueError, match="n_windows"):
        ca.warmup(n_steps=3, n_windows=2)


def test_history_accessors_and_thinning():
    ca = ChainArray("hmc", GaussianForm(torch.eye(3)), np.zeros((8, 3)) + 0.1,
                    retry=False, fused=True, seed=0, steps=5, device="cpu")
    ca.advance(6, store=True, thin=2)
    ca.advance(4, store=False)
    assert ca.get_sample().shape == (3 * 8, 3)
    assert ca.get_probabilities().shape == (3 * 8,)
    assert ca.get_sample(burn=1, thin=2).shape == (8, 3)
    assert ca.theta.shape == (8, 3) and ca.logp.shape == (8,)
    np.testing.assert_allclose(ca.logp, -0.5 * (ca.theta**2).sum(axis=1), rtol=1e-5)


def test_unported_options_raise():
    """Every kind builds now (nuts last); an unknown kind and a mesh
    (ROADMAP A13) still raise."""
    form = GaussianForm(torch.eye(2))
    starts = np.zeros((4, 2))
    nuts = ChainArray("nuts", form, starts, max_depth=4, device="cpu")
    assert nuts.kind == "nuts" and nuts._state.grad.shape == (4, 2)
    for kind in ("gibbs", "metropolis", "pca"):
        assert ChainArray(kind, form, starts, device="cpu").kind == kind
    walkers = np.random.default_rng(0).normal(size=(2, 6, 2))
    assert ChainArray("ensemble", form, walkers, device="cpu").theta.shape == (2, 6, 2)
    with pytest.raises(ValueError, match="unknown"):
        ChainArray("slice", form, starts, device="cpu")
    with pytest.raises(ValueError, match="A13"):
        ChainArray("hmc", form, starts, mesh=object(), device="cpu")


# --------------------------------------------------------------------- #
# checkpoints shared with the JAX package
# --------------------------------------------------------------------- #
def _jax_chain_array(icov, starts, seed):
    A = jnp.asarray(icov)
    return JaxChainArray("hmc", lambda t: -0.5 * t @ A @ t, starts, steps=8,
                         epsilon=0.3, retry=False, seed=seed)


def test_jax_checkpoint_restores_into_port(float64, tmp_path):
    icov = np.linalg.inv(np.array([[1.0, 0.3], [0.3, 2.0]]))
    starts = np.random.default_rng(1).normal(0, 0.5, (16, 2))
    theirs = _jax_chain_array(icov, starts, seed=1)
    theirs.advance(20, store=False)
    theirs.save(str(tmp_path / "jax.npz"))

    ours = ChainArray("hmc", GaussianForm(torch.as_tensor(icov)), starts, steps=8,
                      retry=False, fused=True, seed=2, device="cpu")
    ours.restore(str(tmp_path / "jax.npz"))
    st = theirs._state
    np.testing.assert_array_equal(ours.theta, np.asarray(st.theta))
    np.testing.assert_array_equal(ours.logp, np.asarray(st.logp))
    for field in ("value", "avg", "var", "num", "chk_int"):
        np.testing.assert_array_equal(
            getattr(ours._state.eps, field).numpy(), np.asarray(getattr(st.eps, field))
        )
    np.testing.assert_array_equal(ours._state.steps.numpy(), np.asarray(st.steps))
    ours.advance(3, store=True)
    assert np.isfinite(ours.get_sample()).all()


@pytest.mark.parametrize("port_float64", [True, False])
def test_port_checkpoint_restores_into_jax(port_float64, tmp_path):
    icov = np.linalg.inv(np.array([[1.0, -0.4], [-0.4, 1.5]]))
    starts = np.random.default_rng(2).normal(0, 0.5, (16, 2))
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if port_float64 else torch.float32)
    try:
        ours = ChainArray("hmc", GaussianForm(torch.as_tensor(icov)), starts, steps=8,
                          epsilon=0.3, retry=False, fused=True, seed=3, device="cpu")
        ours.advance(20, store=False)
        ours.save(str(tmp_path / "port.npz"))
    finally:
        torch.set_default_dtype(old)

    theirs = _jax_chain_array(icov, starts, seed=4)
    theirs.restore(str(tmp_path / "port.npz"))
    st = theirs._state
    np.testing.assert_array_equal(np.asarray(st.theta), ours.theta.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(st.eps.value),
                                  ours._state.eps.value.numpy().astype(np.float64))
    np.testing.assert_array_equal(np.asarray(st.eps.num), ours._state.eps.num.numpy())
    assert np.asarray(st.key).shape == (16, 2) and np.asarray(st.key).dtype == np.uint32
    theirs.advance(3, store=True)
    assert np.isfinite(theirs.get_sample()).all()


def test_restore_rejects_mismatched_checkpoint(tmp_path):
    ca = ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((4, 2)), retry=False, device="cpu")
    ca.save(str(tmp_path / "a.npz"))
    other = ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((5, 2)), retry=False, device="cpu")
    with pytest.raises(ValueError, match="n_chains"):
        other.restore(str(tmp_path / "a.npz"))


def test_convert_round_trip(float64):
    rng = np.random.default_rng(0)
    K = 6
    leaves = [rng.normal(size=(K, 3)), rng.normal(size=K), rng.uniform(size=K),
              rng.uniform(size=K), rng.uniform(size=K),
              rng.integers(0, 9, K).astype(np.int32), np.full(K, 20, np.int32),
              rng.integers(0, 2**32, (K, 2), dtype=np.uint64).astype(np.uint32),
              rng.uniform(size=K) < 0.5, np.full(K, 0.5), np.full(K, 50, np.int32)]
    state = convert.hmc_state_from_jax(leaves, device="cpu")
    back = convert.hmc_state_to_jax_leaves(state, leaves[7])
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="11 leaves"):
        convert.hmc_state_from_jax(leaves[:10], device="cpu")
    form = convert.gaussian_form_from_numpy(np.eye(3) * 2.0, mean=[1.0, 2.0, 3.0])
    assert float(form(torch.tensor([1.0, 2.0, 3.0]))) == 0.0


# --------------------------------------------------------------------- #
# diagnostics against the JAX package
# --------------------------------------------------------------------- #
def _ar1(shape, n, rho, seed):
    rng = np.random.default_rng(seed)
    x = np.empty(shape + (n,))
    x[..., 0] = rng.normal(size=shape)
    for i in range(1, n):
        x[..., i] = rho * x[..., i - 1] + np.sqrt(1 - rho**2) * rng.normal(size=shape)
    return x


@pytest.mark.parametrize("n", [200, 201])
def test_ess_batched_matches_jax_exactly(n):
    """Integer ESS of autocorrelated series (and a constant one, which gets
    the sentinel 0) equal to the JAX package's, for even and odd lengths."""
    x = _ar1((6, 3), n, 0.7, seed=n)
    x[0, 0] = 1.5
    ours = effective_sample_size_batched(torch.as_tensor(x)).numpy()
    theirs = np.asarray(jax_ess.effective_sample_size_batched(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, theirs)
    assert ours[0, 0] == 0 and ours.dtype == np.int32
    assert effective_sample_size(x[1, 1]) == jax_ess.effective_sample_size(x[1, 1])


def test_chain_array_diagnostics_match_jax_functions():
    ca = ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((16, 2)) + 0.2,
                    retry=False, fused=True, steps=6, seed=5, device="cpu")
    ca.advance(60, store=True)
    h = np.concatenate(ca._history)[10:].astype(np.float64)
    np.testing.assert_array_equal(
        ca.effective_sample_size(burn=10),
        np.asarray(jax_ess.effective_sample_size_batched(jnp.moveaxis(jnp.asarray(h), 0, -1))),
    )
    series = jnp.transpose(jnp.asarray(h), (2, 1, 0))
    np.testing.assert_allclose(ca.rhat(burn=10), np.asarray(jax_diag.rank_normalized_rhat(series)),
                               rtol=1e-5)
    np.testing.assert_allclose(ca.rhat(burn=10, rank_normalized=False),
                               np.asarray(jax_diag.split_rhat(series)), rtol=1e-5)
    with pytest.raises(ValueError, match="no stored history"):
        ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((4, 2)), device="cpu").rhat()


def _rhat_input(seed):
    """(P=4, m=8 chains, n=51 steps): mixed chains, chains stuck at
    different constants (+inf), identical constant chains (1), and data
    rounded to one decimal (ties)."""
    x = _ar1((4, 8), 51, 0.5, seed)
    x[1] = np.arange(8)[:, None] * 0.5
    x[2] = 3.0
    x[3] = np.round(x[3], 1)
    return x


@pytest.mark.parametrize("estimator", ["split_rhat", "rank_normalized_rhat"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rhat_matches_jax(float64, estimator, seed):
    """Both estimators agree with the JAX package to 1e-10. Chains stuck
    at different constants report +inf; the JAX package's rank-normalized
    form reports a huge finite value there instead, because its variance
    of a chain's identical scores rounds to a tiny positive number."""
    x = _rhat_input(seed)
    ours = getattr(diagnostics, estimator)(torch.as_tensor(x)).numpy()
    theirs = np.asarray(getattr(jax_diag, estimator)(jnp.asarray(x)))
    mixed = [0, 2, 3]
    np.testing.assert_allclose(ours[mixed], theirs[mixed], rtol=1e-10, atol=1e-10)
    assert np.isinf(ours[1]) and theirs[1] > 1e12
    assert ours[2] == 1.0


def test_rhat_input_validation():
    with pytest.raises(ValueError, match="at least 2 chains"):
        diagnostics.split_rhat(torch.zeros(1, 10))
    with pytest.raises(ValueError, match="at least 4 samples"):
        diagnostics.rank_normalized_rhat(torch.zeros(3, 3))


# --------------------------------------------------------------------- #
# utilities
# --------------------------------------------------------------------- #
def test_default_float_follows_torch_default(float64):
    assert default_float() == torch.float64
    torch.set_default_dtype(torch.float32)
    assert default_float() == torch.float32


def test_make_generator_seeding():
    draw = lambda g: torch.rand(4, generator=g)
    torch.testing.assert_close(draw(make_generator(5)), draw(make_generator(5 + 2**32)))
    assert not torch.equal(draw(make_generator(5)), draw(make_generator(6)))
    assert make_generator(None).device.type == "cpu"


def test_as_device_logp_validation():
    """A torch posterior takes the torch route; numpy posteriors (one that
    reads a tensor through ``__array__``, one that needs numpy's methods)
    take the host route and give tensors in the example's dtype; the JAX
    package's validation rules raise."""
    example = torch.zeros(3)
    logp = as_device_logp(lambda t: -(t**2).sum(), example)
    assert not logp.host and logp(torch.ones(3)).shape == ()
    for numpy_fn in (lambda t: float(np.sum(np.asarray(t) ** 2)),
                     lambda t: -0.5 * (t.astype(float) ** 2).sum()):
        host = as_device_logp(numpy_fn, example)
        assert host.host
        out = host.batched(torch.ones(4, 3))
        assert out.shape == (4,) and out.dtype == example.dtype
        np.testing.assert_allclose(out.numpy(), [numpy_fn(np.ones(3))] * 4)
    with pytest.raises(ValueError, match="scalar"):
        as_device_logp(lambda t: t * 2, example)
    with pytest.raises(ValueError, match="finite"):
        as_device_logp(lambda t: (t - np.inf).sum(), example)
    with pytest.raises(ValueError, match="callable"):
        as_device_logp(3.0, example)
