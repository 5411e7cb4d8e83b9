"""Reflecting bounds in the PyTorch port (inference_tpu_torch/utils/bounds.py)
against the JAX package's: the reflection maps on points inside, far
outside and exactly on each bound, the validation errors, one bounded HMC
transition on the same draws as JAX's ``make_hmc_step(bounds_reflect=...)``,
and bounded sampling through ``ChainArray``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from inference_tpu.mcmc._kernels import hmc as jax_hmc
from inference_tpu.utils.bounds import Bounds as JaxBounds
from inference_tpu.utils.bounds import reflect_to_bounds as jax_reflect_to_bounds
from inference_tpu_torch.mcmc._kernels import hmc
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.utils import Bounds, reflect_to_bounds

LOWER = np.array([-1.0, 0.0, 2.0, -1e3])
UPPER = np.array([1.0, 3.0, 2.5, -999.0])


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


def _points(kind):
    """Points inside, far outside (tens of widths both ways) and exactly on
    each bound (and one width beyond each, where the reflection lands on a
    bound again)."""
    rng = np.random.default_rng(11)
    width = UPPER - LOWER
    if kind == "inside":
        return LOWER + rng.uniform(size=(64, 4)) * width
    if kind == "outside":
        return LOWER + rng.uniform(-40, 40, size=(256, 4)) * width
    return np.stack([LOWER, UPPER, LOWER - width, UPPER + width, LOWER + 2 * width,
                     LOWER - 3 * width])


def _assert_rel(ours, theirs, rtol=1e-14):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=rtol * np.abs(theirs).max())


@pytest.mark.parametrize("kind", ["inside", "outside", "on_bounds"])
def test_reflect_and_reflect_momenta_match_jax(kind):
    pts = _points(kind)
    ours, theirs = Bounds(LOWER, UPPER), JaxBounds(LOWER, UPPER)
    t = torch.as_tensor(pts)
    _assert_rel(ours.reflect(t).numpy(), theirs.reflect(jnp.asarray(pts)))
    pos, flips = ours.reflect_momenta(t)
    jpos, jflips = theirs.reflect_momenta(jnp.asarray(pts))
    _assert_rel(pos.numpy(), jpos)
    np.testing.assert_array_equal(flips.numpy(), np.asarray(jflips))
    _assert_rel(reflect_to_bounds(t, torch.as_tensor(LOWER), torch.as_tensor(UPPER)).numpy(),
                jax_reflect_to_bounds(jnp.asarray(pts), jnp.asarray(LOWER), jnp.asarray(UPPER)))
    assert ((pos.numpy() >= LOWER) & (pos.numpy() <= UPPER)).all()
    if kind == "inside":
        np.testing.assert_array_equal(pos.numpy(), pts)
        assert (flips.numpy() == 1).all()


def test_reflection_follows_the_positions_dtype_and_flips_both_ways():
    b = Bounds([0.0], [1.0])
    t = torch.tensor([[0.25], [1.25], [-0.25], [2.25], [-1.25]], dtype=torch.float32)
    pos, flips = b.reflect_momenta(t)
    assert pos.dtype == torch.float32 and flips.dtype == torch.float32
    np.testing.assert_allclose(pos.numpy()[:, 0], [0.25, 0.75, 0.25, 0.25, 0.75])
    np.testing.assert_array_equal(flips.numpy()[:, 0], [1, -1, -1, 1, 1])


def test_inside_and_inside_device():
    b, jb = Bounds(LOWER, UPPER), JaxBounds(LOWER, UPPER)
    for p in _points("on_bounds")[:2]:
        assert b.inside(p) and jb.inside(p)
    outside = LOWER - 1e-9
    assert not b.inside(outside) and not jb.inside(outside)
    batch = torch.as_tensor(np.stack([LOWER, outside, UPPER]))
    np.testing.assert_array_equal(b.inside_device(batch).numpy(), [True, False, True])
    assert bool(b.inside_device(batch[0])) == bool(jb.inside_device(jnp.asarray(LOWER)))


def _error(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("lower, upper", [
    (np.zeros((2, 2)), np.ones((2, 2))),
    (np.zeros(2), np.ones(3)),
    (np.zeros(2), np.array([1.0, 0.0])),
])
def test_validation_errors_match_jax(lower, upper):
    assert _error(lambda: Bounds(lower, upper, "X")) == _error(lambda: JaxBounds(lower, upper, "X"))


@pytest.mark.parametrize("start", [np.zeros(3), np.array([2.0, 1.0, 2.2, -999.5])])
def test_start_point_errors_match_jax(start):
    ours, theirs = Bounds(LOWER, UPPER), JaxBounds(LOWER, UPPER)
    assert (_error(lambda: ours.validate_start_point(start, "HamiltonianChain"))
            == _error(lambda: theirs.validate_start_point(start, "HamiltonianChain")))


def _jax_draws(keys, P):
    """The draws JAX's retry=False step takes from each chain's key."""
    def one(key):
        _, step_key = jax.random.split(key)
        _, k_mom, k_steps, k_acc = jax.random.split(step_key, 4)
        return (jax.random.normal(k_mom, (P,), jnp.float64),
                jax.random.uniform(k_steps, dtype=jnp.float64),
                jax.random.uniform(k_acc, dtype=jnp.float64))
    return [np.array(x) for x in jax.vmap(one)(keys)]


def test_bounded_transition_matches_jax_make_hmc_step(float64):
    """One bounded retry=False transition of 64 chains with the draws JAX's
    step takes from its keys, injected into the port's step: positions,
    log-probabilities, step sizes and leapfrog counts equal JAX's
    ``make_hmc_step(bounds_reflect=Bounds.reflect_momenta)`` within 1e-12,
    and the trajectories did reflect."""
    P, K, steps, eps = 3, 64, 12, 0.35
    rng = np.random.default_rng(5)
    B = rng.normal(size=(P, P))
    A = B @ B.T / P + 0.5 * np.eye(P)
    lower, upper = np.array([-0.6, -1.0, 0.0]), np.array([0.6, 1.5, 0.8])
    theta0 = lower + rng.uniform(0.1, 0.9, size=(K, P)) * (upper - lower)

    Aj = jnp.asarray(A)
    jlogp = lambda t: -0.5 * t @ Aj @ t
    jbounds = JaxBounds(lower, upper)
    jstep = jax_hmc.make_hmc_step(jlogp, jax.grad(jlogp), bounds_reflect=jbounds.reflect_momenta,
                                  retry=False)
    keys = jax.random.split(jax.random.PRNGKey(9), K)
    init = lambda t, k: jax_hmc.init_hmc_state(t, jlogp(t), eps, k, steps=steps)
    jstate = jax.vmap(init)(jnp.asarray(theta0), keys)
    jnew, jout = jax.vmap(jstep)(jstate)

    At = torch.as_tensor(A)
    logp = lambda t: -0.5 * t @ At @ t
    bounds = Bounds(lower, upper)
    step = hmc.make_hmc_step(torch.func.vmap(logp), torch.func.vmap(torch.func.grad(logp)),
                             bounds_reflect=bounds.reflect_momenta, retry=False)
    t0 = torch.as_tensor(theta0)
    state = hmc.init_hmc_state(t0, torch.func.vmap(logp)(t0), eps, steps=steps)
    z, us, ua = (torch.as_tensor(x) for x in _jax_draws(keys, P))
    new, out = step(state, None, z=z, u_steps=us, u_acc=ua)

    rel = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(new.theta.numpy(), np.asarray(jnew.theta), **rel)
    np.testing.assert_allclose(new.logp.numpy(), np.asarray(jnew.logp), **rel)
    for f in ("value", "avg", "var"):
        np.testing.assert_allclose(getattr(new.eps, f).numpy(), np.asarray(getattr(jnew.eps, f)), **rel)
    np.testing.assert_array_equal(new.eps.num.numpy(), np.asarray(jnew.eps.num))
    np.testing.assert_array_equal(out.leapfrog_steps.numpy(), np.asarray(jout.leapfrog_steps))
    assert bounds.inside(new.theta.numpy())
    # without bounds the same draws leave the box: the reflections mattered
    free = hmc.make_hmc_step(torch.func.vmap(logp), torch.func.vmap(torch.func.grad(logp)),
                             retry=False)
    assert not bounds.inside(free(state, None, z=z, u_steps=us, u_acc=ua)[0].theta.numpy())


def test_chain_array_samples_inside_bounds_and_fused_refuses_them(float64):
    """ChainArray takes bounds on the plain path (as the JAX package's does):
    every stored sample is inside, and the cut-off tail moves the mean. The
    fused kernel refuses bounds, as the JAX package's does."""
    bounds = Bounds([0.0, -5.0], [5.0, 5.0])
    form = GaussianForm(torch.eye(2))
    starts = np.random.default_rng(0).uniform(0.1, 1.0, (64, 2))
    ca = ChainArray("hmc", form, starts, steps=10, epsilon=0.5, bounds=bounds, retry=False,
                    seed=3, device="cpu")
    ca.advance(150, store=True)
    sample = ca.get_sample(burn=50)
    assert bounds.inside(sample)
    # half-normal mean sqrt(2/pi) = 0.798 on the bounded axis, 0 on the other
    assert abs(sample[:, 0].mean() - np.sqrt(2 / np.pi)) < 0.08
    assert abs(sample[:, 1].mean()) < 0.1
    with pytest.raises(ValueError, match="reflecting bounds"):
        ChainArray("hmc", form, starts, bounds=bounds, retry=False, fused=True, device="cpu")
