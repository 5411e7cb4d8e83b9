"""Posteriors written with numpy in the PyTorch port (inference_tpu_torch/
utils/wrap.py, ROADMAP A1) against the JAX package's host callbacks: the
route each posterior takes, the forward-difference gradient of
HamiltonianChain element by element, a numpy user gradient, the
validate_posterior rules and messages, numpy-posterior GibbsChain,
HamiltonianChain and ChainArray runs by statistics, and the batched HMC
kind's refusal."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from inference_tpu.mcmc import GibbsChain as JaxGibbs
from inference_tpu.mcmc import HamiltonianChain as JaxHamiltonian
from inference_tpu.parallel import ChainArray as JaxChainArray
from inference_tpu.utils import validate_posterior as jax_validate
from inference_tpu_torch import GibbsChain, HamiltonianChain
from inference_tpu_torch.mcmc.hmc import fd_gradient
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.utils import as_device_logp, validate_posterior

COV = np.array([[1.0, 0.4, 0.0], [0.4, 0.5, 0.1], [0.0, 0.1, 2.0]])
ICOV = np.linalg.inv(COV)


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


def gauss_numpy(t):
    t = np.asarray(t)
    return float(-0.5 * t @ ICOV @ t)


def gauss_numpy_grad(t):
    return -ICOV @ np.asarray(t)


# --------------------------------------------------------------------- #
# the route
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fn, host", [
    (lambda t: -0.5 * (t**2).sum(), False),
    (lambda t: -0.5 * t @ torch.as_tensor(ICOV) @ t, False),
    (gauss_numpy, True),  # reads a CPU tensor through __array__, not a batched one
    (lambda t: -float(np.dot(np.asarray(t), np.asarray(t))), True),
    (lambda t: math.exp(-float(t[0] ** 2)), True),
    (lambda t: -np.sum(np.asarray(t) ** 2), True),
], ids=["torch-sum", "torch-form", "numpy-form", "numpy-dot", "math-exp", "numpy-sum"])
def test_route_on_the_cpu(fn, host):
    """The vmap check decides the route on the CPU as on the card: torch
    posteriors run under vmap, numpy ones on the host even where they accept
    a CPU tensor; both give the same values in the chain's dtype."""
    example = torch.tensor([0.3, -0.2, 0.5])
    logp = as_device_logp(fn, example)
    assert logp.host is host
    rows = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 3)))
    out = logp.batched(rows)
    assert out.shape == (5,) and out.dtype == torch.float64
    want = [float(fn(r.numpy() if host else r)) for r in rows]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-15)
    assert logp(rows[1]).shape == () and float(logp(rows[1])) == pytest.approx(want[1], rel=1e-15)


def test_host_route_keeps_the_dtype_of_the_chain():
    logp = as_device_logp(gauss_numpy, torch.zeros(3, dtype=torch.float32))
    out = logp.batched(torch.ones(4, 3, dtype=torch.float32))
    assert logp.host and out.dtype == torch.float32 and out.device.type == "cpu"


def test_validate_posterior_rules_and_messages():
    """Not callable, not a float-like scalar, not finite at the start: the
    JAX package's errors, word for word, on either route."""
    start = np.array([0.5, 0.5, 0.5])
    cases = [3.0, lambda t: np.asarray(t) * 2.0, lambda t: np.inf * np.sum(np.asarray(t)),
             lambda t: {"p": 1.0}]
    for case in cases:
        with pytest.raises(ValueError) as ref:
            jax_validate(case, start, error_source="GibbsChain")
        with pytest.raises(ValueError) as got:
            validate_posterior(case, torch.as_tensor(start), error_source="GibbsChain")
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="finite"):
        validate_posterior(lambda t: (t - torch.inf).sum(), torch.as_tensor(start))
    with pytest.raises(ValueError, match="scalar float-like"):
        validate_posterior(lambda t: t * 2, torch.as_tensor(start))


# --------------------------------------------------------------------- #
# gradients of HamiltonianChain
# --------------------------------------------------------------------- #
def test_fd_gradient_equals_jax():
    """The forward-difference gradient of a host posterior (h = 1e-6
    max(|t|, 1), P + 1 evaluations) equals the JAX package's ``_gradient_fn``
    element by element to 1e-12, at points inside and outside [-1, 1]."""
    start = np.array([0.5, -1.0, 0.25])
    ref = JaxHamiltonian(rosen3, start=start, display_progress=False, seed=0)
    port = HamiltonianChain(rosen3, start=start, display_progress=False, seed=0, device="cpu")
    assert port._logp.host
    jgrad = jax.jit(ref._gradient_fn(start))
    pgrad = port._gradient_fn(torch.as_tensor(start))
    for t in np.random.default_rng(1).normal(0, 2, (6, 3)):
        want = np.asarray(jgrad(jnp.asarray(t)))
        got = pgrad(torch.as_tensor(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(got, fd_gradient(port._logp.batched, torch.as_tensor(t)).numpy())


def rosen3(t):
    t = np.asarray(t)
    return float(-np.sum(100.0 * (t[1:] - t[:-1] ** 2) ** 2 + (1 - t[:-1]) ** 2))


def test_numpy_user_grad_runs_on_the_host():
    """A numpy gradient is evaluated on the host, for a numpy and for a
    torch posterior, and gives the user's values in the chain's dtype."""
    start = np.array([0.3, -0.4, 0.2])
    for post in (gauss_numpy, lambda t: -0.5 * t @ torch.as_tensor(ICOV) @ t):
        chain = HamiltonianChain(post, start=start, grad=gauss_numpy_grad, display_progress=False,
                                 seed=2, device="cpu")
        g = chain._gradient_fn(torch.as_tensor(start))
        for t in np.random.default_rng(3).normal(size=(3, 3)):
            got = g(torch.as_tensor(t))
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), gauss_numpy_grad(t))
        chain.steps = 10
        chain.advance(50)
        assert np.isfinite(chain.get_sample()).all()


# --------------------------------------------------------------------- #
# numpy-posterior chains against the JAX package's host-callback chains
# --------------------------------------------------------------------- #
def test_numpy_gibbs_chain_statistics_match_jax():
    """GibbsChain on a numpy posterior (host evaluations) against the JAX
    host-callback chain and the torch-posterior chain of the port: the same
    moments within sampling error; with one seed the host and torch routes
    take the same steps."""
    start = np.array([0.5, -0.5, 0.2])
    port = GibbsChain(gauss_numpy, start=start, widths=1.0, display_progress=False, seed=7,
                      device="cpu")
    torch_twin = GibbsChain(lambda t: -0.5 * t @ torch.as_tensor(ICOV) @ t, start=start,
                            widths=1.0, display_progress=False, seed=7, device="cpu")
    ref = JaxGibbs(gauss_numpy, start=start, widths=1.0, display_progress=False, seed=7)
    assert port._logp.host and not torch_twin._logp.host
    for chain in (port, torch_twin, ref):
        chain.advance(400)
    np.testing.assert_allclose(port.get_sample(0), torch_twin.get_sample(0), rtol=1e-12,
                               atol=1e-14)
    sd = np.sqrt(np.diag(COV))
    for chain in (port, ref):
        s = chain.get_sample(burn=100)
        assert (np.abs(s.mean(0)) / sd).max() < 0.35
        np.testing.assert_allclose(s.var(0), np.diag(COV), rtol=0.5)


def test_numpy_hamiltonian_chain_statistics_match_jax():
    """HamiltonianChain on a numpy posterior with the forward-difference
    gradient against the JAX host-callback chain: finite samples, moments
    within sampling error of the truth in both."""
    start = np.array([0.2, 0.1, -0.3])
    port = HamiltonianChain(gauss_numpy, start=start, display_progress=False, seed=5,
                            device="cpu")
    ref = JaxHamiltonian(gauss_numpy, start=start, display_progress=False, seed=5)
    sd = np.sqrt(np.diag(COV))
    for chain in (port, ref):
        chain.steps = 10
        chain.advance(200)
        s = chain.get_sample(burn=50)
        assert np.isfinite(s).all()
        assert (np.abs(s.mean(0)) / sd).max() < 0.35
        np.testing.assert_allclose(s.var(0), np.diag(COV), rtol=0.5)


def test_numpy_chain_array_gibbs_and_refused_hmc():
    """ChainArray('gibbs', <numpy posterior>) evaluates each chain on the
    host and matches the JAX ChainArray by statistics; the batched hmc
    kind refuses a numpy posterior, as the JAX package's does."""
    starts = np.random.default_rng(6).normal(0, 1, (16, 3))
    port = ChainArray("gibbs", gauss_numpy, starts, widths=1.0, retry=False, seed=1,
                      device="cpu")
    ref = JaxChainArray("gibbs", gauss_numpy, starts, widths=1.0, retry=False, seed=1)
    assert port._logp.host
    for ca in (port, ref):
        ca.advance(200)
    sp, sj = port.get_sample(burn=50), ref.get_sample(burn=50)
    for s in (sp, sj):
        np.testing.assert_allclose(s.var(0), np.diag(COV), rtol=0.3)
    np.testing.assert_allclose(port.logp, [gauss_numpy(t) for t in port.theta], rtol=1e-12)
    with pytest.raises(ValueError, match="needs a torch posterior"):
        ChainArray("hmc", gauss_numpy, starts, device="cpu")
    with pytest.raises(Exception, match="JVP"):
        JaxChainArray("hmc", gauss_numpy, starts, retry=False).advance(1)
