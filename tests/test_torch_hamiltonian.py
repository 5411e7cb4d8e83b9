"""The single-chain HamiltonianChain of the PyTorch port
(inference_tpu_torch/mcmc/hmc) against the JAX package's: the cases of the
JAX package's tests/mcmc/test_hamiltonian.py (advance and slicing,
statistics, a user gradient, bounds, the mass options, estimate_mass, mode
and burn-in, steps changed without a rebuild), its statistics beside the
JAX chain's, the mass maps and the step-size record on the same inputs,
and checkpoints that load in both directions."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from inference_tpu.mcmc import HamiltonianChain as JaxChain
from inference_tpu.mcmc import Bounds as JaxBounds
from inference_tpu.mcmc.hmc import mass as jax_mass
from inference_tpu.mcmc.hmc.epsilon import EpsilonSelector as JaxSelector
from inference_tpu_torch import Bounds, HamiltonianChain
from inference_tpu_torch.convert import bounds_from_numpy, hamiltonian_chain_from_jax, mass_from_numpy
from inference_tpu_torch.mcmc.hmc import EpsilonSelector, MatrixMass, ScalarMass, VectorMass
from inference_tpu_torch.mcmc.hmc.mass import get_particle_mass

START = np.array([1.0, 0.1, 0.1])


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


class Toroidal:
    """The JAX tests' Gaussian ring in 3D (tests/mcmc/mcmc_utils.py) over
    ``lib`` (torch or jax.numpy), with its analytic gradient."""

    def __init__(self, lib):
        self.lib, self.r0, self.eps = lib, 1.0, 0.05
        self.coeff = -0.5 / self.eps**2

    def __call__(self, theta):
        x, y, z = theta[0], theta[1], theta[2]
        return self.coeff * (z**2 + (self.lib.sqrt(x**2 + y**2) - self.r0) ** 2)

    def gradient(self, theta):
        x, y, z = theta[0], theta[1], theta[2]
        K = 1 - self.r0 / self.lib.sqrt(x**2 + y**2)
        return 2 * self.coeff * self.lib.stack([K * x, K * y, z])


def make_chain(n=150, seed=4, **kwargs):
    chain = HamiltonianChain(Toroidal(torch), start=START, display_progress=False, seed=seed,
                             device="cpu", **kwargs)
    chain.advance(n)
    return chain


def _radius(s):
    return np.sqrt(s[:, 0] ** 2 + s[:, 1] ** 2)


def test_hamiltonian_advance_and_slicing():
    chain = make_chain(n=150)
    assert chain.chain_length == 151
    for burn, thin in [(0, 1), (1, 1), (10, 3), (50, 7)]:
        expected = len(range(chain.chain_length)[burn::thin])
        assert chain.get_sample(burn=burn, thin=thin).shape == (expected, 3)
        assert chain.get_probabilities(burn=burn, thin=thin).size == expected
        assert chain.get_parameter(1, burn=burn, thin=thin).shape == (expected,)
    np.testing.assert_array_equal(chain.get_sample(burn=0)[0], START)
    assert len(chain.theta) == len(chain.probs) == len(chain.leapfrog_steps) == 151
    np.testing.assert_array_equal(chain.get_last(), chain.get_sample()[-1])
    chain.take_step()
    assert chain.chain_length == 152


def test_hamiltonian_statistics_beside_the_jax_chain():
    """The sampled ring: radius mean within 0.05 of 1 and the height's mean
    and spread near 0 and 0.05, for the port's chain and the JAX package's
    alike, and the two radius means within 5 joint standard errors."""
    ours = make_chain(n=700, seed=1).get_sample(burn=150)
    theirs = JaxChain(Toroidal(jnp), start=START, display_progress=False, seed=1)
    theirs.advance(700)
    theirs = theirs.get_sample(burn=150)
    for s in (ours, theirs):
        assert abs(_radius(s).mean() - 1.0) < 0.05
        assert abs(s[:, 2].mean()) < 0.05
        assert abs(s[:, 2].std() - 0.05) < 0.02
    se = np.hypot(_radius(ours).std() / np.sqrt(len(ours) / 10),
                  _radius(theirs).std() / np.sqrt(len(theirs) / 10))
    assert abs(_radius(ours).mean() - _radius(theirs).mean()) < 5 * se


def test_hamiltonian_user_gradient():
    posterior = Toroidal(torch)
    chain = HamiltonianChain(posterior, grad=posterior.gradient, start=START,
                             display_progress=False, seed=2, device="cpu")
    chain.advance(250)
    assert abs(_radius(chain.get_sample(burn=50)).mean() - 1.0) < 0.1
    # the user gradient is what the transition uses
    t = torch.as_tensor([0.8, 0.5, -0.1])
    torch.testing.assert_close(chain._gradient_fn(t)(t), posterior.gradient(t))


def test_hamiltonian_bounded():
    bounds = Bounds(lower=np.array([0.0, -2.0, -2.0]), upper=np.array([2.0, 2.0, 2.0]))
    chain = make_chain(n=200, seed=3, bounds=bounds)
    s = chain.get_sample()
    assert (s[:, 0] >= 0.0).all() and (s[:, 0] <= 2.0).all()
    assert (np.abs(s[:, 1:]) <= 2.0).all()
    # the half ring the bound keeps: x > 0 only
    assert s[:, 0].mean() > 0.4


def test_bounds_given_as_arrays_and_outside_start_raise():
    chain = HamiltonianChain(Toroidal(torch), start=START, bounds=(np.full(3, -3.0), np.full(3, 3.0)),
                             display_progress=False, device="cpu")
    assert isinstance(chain.bounds, Bounds)
    with pytest.raises(ValueError, match="outside specified bounds"):
        HamiltonianChain(Toroidal(torch), start=START, bounds=(np.full(3, 0.5), np.full(3, 3.0)),
                         display_progress=False, device="cpu")


@pytest.mark.parametrize(
    "inverse_mass", [2.0, np.array([1.0, 2.0, 0.5]), np.diag([1.0, 2.0, 0.5])],
)
def test_hamiltonian_mass_options(inverse_mass):
    chain = make_chain(n=60, seed=5, inverse_mass=inverse_mass)
    assert chain.chain_length == 61
    assert np.isfinite(chain.get_sample()).all()


@pytest.mark.parametrize("inverse_mass", [
    2.0, np.array([1.0, 2.0, 0.5]), np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]]),
])
def test_mass_maps_match_jax(inverse_mass):
    """Velocity and momentum from the same standard normals equal the JAX
    package's within 1e-12, one vector and a batch of them."""
    ours = get_particle_mass(inverse_mass, 3, torch.float64, "cpu")
    theirs = jax_mass.get_particle_mass(inverse_mass, 3)
    assert type(ours).__name__ == type(theirs).__name__ and ours.kind == theirs.kind
    rng = np.random.default_rng(6)
    r = rng.normal(size=3)
    np.testing.assert_allclose(ours.get_velocity(torch.as_tensor(r)).numpy(),
                               np.asarray(theirs.get_velocity(jnp.asarray(r))), rtol=1e-12)
    key = jax.random.PRNGKey(2)
    z = np.array(jax.random.normal(key, (3,), jnp.float64))
    np.testing.assert_allclose(ours.sample_momentum(z=torch.as_tensor(z)).numpy(),
                               np.asarray(theirs.sample_momentum(key, jnp.float64)), rtol=1e-12)
    batch = rng.normal(size=(5, 3))
    want = np.stack([np.asarray(theirs.get_velocity(jnp.asarray(b))) for b in batch])
    np.testing.assert_allclose(ours.get_velocity(torch.as_tensor(batch)).numpy(), want, rtol=1e-12)
    g = torch.Generator().manual_seed(0)
    assert ours.sample_momentum(g).shape == (3,)


@pytest.mark.parametrize("bad", [np.array([1.0, -2.0, 1.0]), np.ones(2), np.ones((3, 2)),
                                 np.array([[1.0, 0.5], [0.0, 1.0]]), np.eye(2)])
def test_mass_validation_matches_jax(bad):
    def err(fn):
        with pytest.raises(ValueError) as info:
            fn()
        return str(info.value)
    assert (err(lambda: get_particle_mass(bad, 3, torch.float64, "cpu"))
            == err(lambda: jax_mass.get_particle_mass(bad, 3)))


def test_hamiltonian_estimate_mass():
    chain = make_chain(n=120)
    chain.estimate_mass(burn=20, diagonal=True)
    assert isinstance(chain.mass, VectorMass)
    np.testing.assert_allclose(chain.mass.inv_mass, chain.get_sample(burn=20).var(axis=0))
    chain.advance(30)
    assert chain.chain_length == 151
    chain.estimate_mass(burn=20, diagonal=False)
    assert isinstance(chain.mass, MatrixMass)
    chain.advance(30)
    assert chain.chain_length == 181


def test_hamiltonian_mode_and_burn_in():
    chain = make_chain(n=200)
    burn = chain.estimate_burn_in()
    assert 0 <= burn <= 0.9 * chain.chain_length + 1
    mode = chain.mode()
    assert mode.shape == (3,)
    assert chain.get_probabilities(burn=0).max() == pytest.approx(
        float(Toroidal(torch)(torch.as_tensor(mode))))


def test_hamiltonian_steps_change_no_rebuild():
    """'steps' lives in the state: changing it does not rebuild the step,
    and the recorded leapfrog counts follow it."""
    chain = HamiltonianChain(Toroidal(torch), start=START, display_progress=False, seed=0,
                             device="cpu")
    chain.advance(20)
    step_obj = chain._step
    first = np.concatenate(chain._leapfrog_chunks)[1:21]
    chain.steps = 10
    chain.advance(20)
    assert chain._step is step_obj
    second = np.asarray(chain.leapfrog_steps)[21:41]
    assert first.mean() > 40 and second.mean() < 20


def test_replace_last_and_its_probability():
    chain = make_chain(n=10)
    chain.replace_last(np.array([0.9, 0.0, 0.0]))
    chain.replace_last_probability(-0.5)
    np.testing.assert_array_equal(chain.get_last(), [0.9, 0.0, 0.0])
    assert chain.get_probabilities(burn=0)[-1] == -0.5
    np.testing.assert_array_equal(chain._state.theta.numpy()[0], [0.9, 0.0, 0.0])
    assert float(chain._state.logp[0]) == -0.5


def test_failed_step_raises_the_jax_error():
    """A chain whose proposals are all rejected raises once it exhausts
    max_attempts, with the JAX package's message."""
    start = torch.as_tensor(START)
    spike = lambda t: torch.where(((t - start) ** 2).sum() < 1e-20, 0.0, -torch.inf) - 0.0 * t.sum()
    chain = HamiltonianChain(spike, start=START, display_progress=False, seed=0, device="cpu")
    chain.max_attempts = 3
    with pytest.raises(ValueError, match="Failed to take step within maximum allowed attempts of 3"):
        chain.advance(1)


def test_numpy_posterior_and_gradient_raise_naming_a1():
    """A numpy posterior (host route, forward-difference gradient) and a
    numpy gradient of a torch posterior (evaluated on the host) now run;
    a non-callable still raises."""
    chain = HamiltonianChain(lambda t: float(-0.5 * np.sum(np.asarray(t) ** 2)), start=START,
                             display_progress=False, device="cpu", seed=3)
    assert chain._logp.host
    chain.advance(20)
    assert np.isfinite(chain.get_sample()).all() and chain.chain_length == 21
    torus = Toroidal(np)
    chain = HamiltonianChain(Toroidal(torch), start=START, display_progress=False, device="cpu",
                             grad=torus.gradient, seed=3)
    chain.advance(20)
    sample = chain.get_sample()
    assert np.isfinite(sample).all() and chain.chain_length == 21
    assert np.abs(np.hypot(sample[:, 0], sample[:, 1]) - 1.0).max() < 0.5
    with pytest.raises(ValueError, match="not a callable"):
        HamiltonianChain(3.0, start=START, display_progress=False, device="cpu")


def test_unported_views_raise_naming_a14_and_burn_thin_errors():
    """The plot views still raise naming A14; get_marginal and get_interval
    (A14's first part) return an estimator on the chain's device and the
    top of the sample."""
    from inference_tpu_torch.pdf import GaussianKDE

    chain = make_chain(n=4)
    for call in (lambda: chain.matrix_plot(), lambda: chain.trace_plot(),
                 lambda: chain.plot_diagnostics(show=False)):
        with pytest.raises(NotImplementedError, match="A14"):
            call()
    marginal = chain.get_marginal(0, burn=0)
    assert isinstance(marginal, GaussianKDE) and marginal.device == chain.device
    sample, probs = chain.get_interval(0.5, burn=0)
    assert sample.shape == (3, 3) and probs.min() >= np.median(chain.get_probabilities(0))
    with pytest.raises(AttributeError, match="burn"):
        chain.burn
    with pytest.raises(AttributeError, match="thin"):
        chain.thin = 2


def test_run_for_advances_for_a_while():
    chain = make_chain(n=1)
    chain.run_for(minutes=0.01)
    assert chain.chain_length > 2


def test_epsilon_selector_matches_jax():
    ours, theirs = EpsilonSelector(0.2), JaxSelector(0.2)
    trace = np.array([0.2, 0.2, 0.15, 0.15, 0.3])
    ours.record_trace(trace, 5)
    theirs.record_trace(trace, 5)
    ours.sync_counters(torch.tensor([1.5]), torch.tensor([0.3]), torch.tensor([4]),
                       torch.tensor([21]))
    theirs.sync_counters(1.5, 0.3, 4, 21)
    assert ours.get_items() == theirs.get_items()


def _assert_same_items(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("bounded", [False, True])
def test_jax_checkpoint_loads_into_the_port_and_continues(tmp_path, bounded):
    bounds = JaxBounds(np.full(3, -5.0), np.full(3, 5.0)) if bounded else None
    jchain = JaxChain(Toroidal(jnp), start=START, display_progress=False, seed=6, bounds=bounds,
                      inverse_mass=np.array([1.0, 2.0, 0.5]))
    jchain.advance(40)
    jchain.steps = 30
    f = tmp_path / "jax.npz"
    jchain.save(str(f))
    ours = HamiltonianChain.load(str(f), posterior=Toroidal(torch), device="cpu")
    _assert_same_items(dict(np.load(f)), ours._checkpoint_items())
    assert (ours.bounds is not None) == bounded and ours.steps == 30
    np.testing.assert_array_equal(ours.get_sample(), jchain.get_sample())
    # the step size and its counters carry over into the state
    assert float(ours._state.eps.value[0]) == jchain.ES.epsilon
    assert int(ours._state.eps.chk_int[0]) == jchain.ES.chk_int
    ours.advance(15)
    assert ours.chain_length == jchain.chain_length + 15
    # the same through convert, without a file
    again = hamiltonian_chain_from_jax(jchain, Toroidal(torch), device="cpu")
    _assert_same_items(again._checkpoint_items(), dict(np.load(f)))


def test_port_checkpoint_loads_into_jax_and_continues(tmp_path):
    ours = make_chain(n=40, bounds=Bounds(np.full(3, -5.0), np.full(3, 5.0)),
                      inverse_mass=np.diag([1.0, 2.0, 0.5]))
    f = tmp_path / "port.npz"
    ours.save(str(f))
    theirs = JaxChain.load(str(f), posterior=Toroidal(jnp))
    jf = tmp_path / "back.npz"
    theirs.save(str(jf))
    _assert_same_items(dict(np.load(f)), dict(np.load(jf)))
    np.testing.assert_array_equal(theirs.get_sample(), ours.get_sample())
    theirs.advance(10)
    assert theirs.chain_length == ours.chain_length + 10


def test_convert_builds_bounds_and_mass_from_numpy():
    b = bounds_from_numpy([0.0, 1.0], [1.0, 2.0])
    assert isinstance(b, Bounds) and b.inside([0.5, 1.5])
    assert isinstance(mass_from_numpy(2.0, 3, device="cpu"), ScalarMass)
    m = mass_from_numpy(np.eye(3), 3, device="cpu")
    assert isinstance(m, MatrixMass) and m.dtype == torch.float64
