"""The posterior building blocks of the PyTorch port
(inference_tpu_torch/models) against the JAX package's
(inference_tpu/models): each likelihood, prior and Posterior in value and
gradient (through a user jacobian and through autodiff) within 1e-12
relative in float64, the same under ``torch.func.vmap`` over 8 points, the
same validation errors, and a Posterior sampled directly by ``ChainArray``
and ``HamiltonianChain``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import inference_tpu.models as jm
import inference_tpu_torch.models as tm
from inference_tpu_torch import HamiltonianChain
from inference_tpu_torch.parallel import ChainArray

RTOL = 1e-12
X = np.linspace(0.5, 4.0, 12)


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


def _close(ours, theirs):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=RTOL * max(np.abs(theirs).max(), 1e-300))


# the forward model F(t) = t0 exp(-t1 x) + t2 x and its jacobian, in both packages
def _model(lib, x):
    return lambda t: t[0] * lib.exp(-t[1] * x) + t[2] * x


def _jacobian(lib, x, stack):
    return lambda t: stack([lib.exp(-t[1] * x), -t[0] * x * lib.exp(-t[1] * x), x], 1)


def _pair(cls_name, jacobian):
    """The same likelihood in both packages: ``(ours, theirs)``."""
    rng = np.random.default_rng(3)
    y = 2.0 * np.exp(-0.7 * X) + 0.3 * X + rng.normal(0, 0.1, X.size)
    err = rng.uniform(0.05, 0.2, X.size)
    xt, xj = torch.as_tensor(X), jnp.asarray(X)
    ours = getattr(tm, cls_name)(
        y, err, _model(torch, xt), _jacobian(torch, xt, torch.stack) if jacobian else None,
        device="cpu")
    theirs = getattr(jm, cls_name)(
        y, err, _model(jnp, xj), _jacobian(jnp, xj, jnp.stack) if jacobian else None)
    return ours, theirs


POINTS = np.random.default_rng(8).normal([2.0, 0.7, 0.3], [0.5, 0.2, 0.1], size=(8, 3))
LIKELIHOODS = ["GaussianLikelihood", "CauchyLikelihood", "LogisticLikelihood"]


@pytest.mark.parametrize("name", LIKELIHOODS)
@pytest.mark.parametrize("jacobian", [True, False])
def test_likelihood_value_and_gradient_match_jax(name, jacobian):
    ours, theirs = _pair(name, jacobian)
    for p in POINTS:
        t = torch.as_tensor(p)
        _close(ours(t), theirs(jnp.asarray(p)))
        _close(ours.gradient(t), theirs.gradient(jnp.asarray(p)))
        _close(ours.cost(t), theirs.cost(jnp.asarray(p)))
        _close(ours.cost_gradient(t), theirs.cost_gradient(jnp.asarray(p)))
    # numpy parameters are taken, as jnp.asarray takes them
    _close(ours(POINTS[0]), theirs(POINTS[0]))


@pytest.mark.parametrize("name", LIKELIHOODS)
@pytest.mark.parametrize("jacobian", [True, False])
def test_likelihood_under_vmap_and_grad(name, jacobian):
    """Value and gradient batched by torch.func.vmap over 8 points equal
    JAX's jax.vmap, and autodiff of the value equals ``gradient``."""
    ours, theirs = _pair(name, jacobian)
    pts = torch.as_tensor(POINTS)
    _close(torch.func.vmap(ours)(pts), jax.vmap(theirs)(jnp.asarray(POINTS)))
    _close(torch.func.vmap(ours.gradient)(pts), jax.vmap(theirs.gradient)(jnp.asarray(POINTS)))
    _close(torch.func.vmap(torch.func.grad(ours))(pts), jax.vmap(theirs.gradient)(jnp.asarray(POINTS)))


def _priors(lib):
    """A Gaussian (variables 0, 3), an exponential (2) and a uniform (1, 4)
    prior, and their joint over 5 variables, in one package."""
    kw = {"device": "cpu"} if lib is tm else {}
    g = lib.GaussianPrior(mean=[0.5, -1.0], sigma=[2.0, 0.5], variable_indices=[0, 3], **kw)
    e = lib.ExponentialPrior(beta=1.5, variable_indices=2, **kw)
    u = lib.UniformPrior(lower=[-1.0, 0.0], upper=[2.0, 3.0], variable_indices=[1, 4], **kw)
    return {"gaussian": g, "exponential": e, "uniform": u,
            "joint": lib.JointPrior([g, e, u], n_variables=5)}


# inside every support, and points outside the exponential's and the uniform's
PRIOR_POINTS = np.array([
    [0.3, 0.5, 0.2, -0.8, 1.0],
    [1.5, -0.9, 3.0, -1.2, 2.9],
    [-2.0, 2.5, 0.1, 0.0, 0.5],    # outside the uniform (variable 1)
    [0.0, 0.0, -0.1, 0.0, 0.0],    # outside the exponential
])


@pytest.mark.parametrize("kind", ["gaussian", "exponential", "uniform", "joint"])
def test_prior_value_and_gradient_match_jax(kind):
    ours, theirs = _priors(tm)[kind], _priors(jm)[kind]
    for p in PRIOR_POINTS:
        _close(ours(torch.as_tensor(p)), theirs(jnp.asarray(p)))
        _close(ours.gradient(torch.as_tensor(p)), theirs.gradient(jnp.asarray(p)))
        _close(ours.cost(torch.as_tensor(p)), theirs.cost(jnp.asarray(p)))
    pts = torch.as_tensor(np.concatenate([PRIOR_POINTS, PRIOR_POINTS[:2] + 0.05, PRIOR_POINTS[:2] - 0.05]))
    _close(torch.func.vmap(ours)(pts), jax.vmap(theirs)(jnp.asarray(pts.numpy())))
    _close(torch.func.vmap(ours.gradient)(pts), jax.vmap(theirs.gradient)(jnp.asarray(pts.numpy())))
    assert ours.bounds == theirs.bounds
    assert ours.variables == theirs.variables if kind != "joint" else (
        ours.prior_variables == theirs.prior_variables)


def test_priors_in_float32_match_jax_without_x64():
    """In float32 the out-of-support log-probability -1e100 is -inf, as the
    JAX package gives it without x64."""
    torch.set_default_dtype(torch.float32)
    ours = _priors(tm)["joint"]
    vals = torch.func.vmap(ours)(torch.as_tensor(PRIOR_POINTS, dtype=torch.float32))
    assert vals.dtype == torch.float32
    assert np.isfinite(vals[:2].numpy()).all() and (vals[2:].numpy() == -np.inf).all()
    with jax.enable_x64(False):
        theirs = _priors(jm)["joint"]
        want = jax.vmap(theirs)(jnp.asarray(PRIOR_POINTS, jnp.float32))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want), rtol=1e-6)


def test_joint_prior_merges_and_samples_inside_its_support():
    """Two Gaussian components merge into one (as in the JAX package), and
    ``sample`` draws from an explicit numpy generator."""
    parts = [tm.GaussianPrior(0.0, 1.0, 0, device="cpu"), tm.GaussianPrior(1.0, 2.0, 2, device="cpu"),
             tm.UniformPrior(0.0, 1.0, 1, device="cpu")]
    joint = tm.JointPrior(parts, n_variables=3)
    theirs = jm.JointPrior([jm.GaussianPrior(0.0, 1.0, 0), jm.GaussianPrior(1.0, 2.0, 2),
                            jm.UniformPrior(0.0, 1.0, 1)], n_variables=3)
    assert [type(c).__name__ for c in joint.components] == [
        type(c).__name__ for c in theirs.components]
    a = joint.sample(np.random.default_rng(4))
    b = joint.sample(np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3,) and 0.0 <= a[1] <= 1.0


def _line_posterior(lib):
    """The JAX package's straight-line test posterior (tests/mcmc/
    mcmc_utils.py): a Gaussian likelihood and a uniform prior."""
    rng = np.random.default_rng(1)
    x = np.linspace(1, 10, 10)
    y = 2.0 * x + 1.0 + rng.normal(0.0, 2.0, x.size)
    xs = torch.as_tensor(x) if lib is tm else jnp.asarray(x)
    kw = {"device": "cpu"} if lib is tm else {}
    like = lib.GaussianLikelihood(y, np.full(x.size, 2.0), lambda t: t[0] * xs + t[1], **kw)
    prior = lib.UniformPrior(lower=[0.0, -5.0], upper=[5.0, 5.0], variable_indices=[0, 1], **kw)
    return lib.Posterior(likelihood=like, prior=prior)


def test_posterior_matches_jax_and_vmaps():
    ours, theirs = _line_posterior(tm), _line_posterior(jm)
    pts = np.random.default_rng(2).uniform([0.0, -5.0], [5.0, 5.0], size=(8, 2))
    pts[0] = [6.0, 0.0]  # outside the prior
    for p in pts:
        t = torch.as_tensor(p)
        _close(ours(t), theirs(jnp.asarray(p)))
        _close(ours.gradient(t), theirs.gradient(jnp.asarray(p)))
        _close(ours.cost(t), theirs.cost(jnp.asarray(p)))
        _close(ours.cost_gradient(t), theirs.cost_gradient(jnp.asarray(p)))
    _close(torch.func.vmap(ours)(torch.as_tensor(pts)), jax.vmap(theirs)(jnp.asarray(pts)))
    _close(torch.func.vmap(torch.func.grad(ours))(torch.as_tensor(pts[1:])),
           jax.vmap(jax.grad(theirs))(jnp.asarray(pts[1:])))


def test_generate_initial_guesses():
    post = _line_posterior(tm)
    guesses = post.generate_initial_guesses(n_guesses=3, prior_samples=50,
                                            rng=np.random.default_rng(0))
    assert len(guesses) == 3
    costs = [float(post.cost(g)) for g in guesses]
    assert costs == sorted(costs)
    with pytest.raises(ValueError, match="less than"):
        post.generate_initial_guesses(n_guesses=5, prior_samples=5)
    with pytest.raises(TypeError, match="integers"):
        post.generate_initial_guesses(n_guesses=1.0)


def _error(fn):
    try:
        fn()
    except (TypeError, ValueError) as err:
        return type(err).__name__, str(err)
    raise AssertionError("no error")


def _both(build):
    """The error each package raises for the same bad arguments."""
    return _error(lambda: build(tm, {"device": "cpu"})), _error(lambda: build(jm, {}))


BAD_MODELS = {
    "model not callable": lambda lib, kw: lib.GaussianLikelihood([1.0], [1.0], 3.0, **kw),
    "jacobian not callable": lambda lib, kw: lib.CauchyLikelihood([1.0], [1.0], abs, 3.0, **kw),
    "sizes differ": lambda lib, kw: lib.GaussianLikelihood([1.0, 2.0], [1.0], abs, **kw),
    "two dimensions": lambda lib, kw: lib.LogisticLikelihood(np.ones((2, 2)), np.ones((2, 2)), abs, **kw),
    "sigma not positive": lambda lib, kw: lib.GaussianLikelihood([1.0, 2.0], [1.0, 0.0], abs, **kw),
    "parameter type": lambda lib, kw: lib.GaussianPrior("a", 1.0, 0, **kw),
    "parameter dimensions": lambda lib, kw: lib.GaussianPrior(np.ones((2, 2)), np.ones((2, 2)), [0, 1], **kw),
    "non-finite": lambda lib, kw: lib.ExponentialPrior([np.inf], 0, **kw),
    "not positive": lambda lib, kw: lib.ExponentialPrior([-1.0], 0, **kw),
    "unequal sizes": lambda lib, kw: lib.UniformPrior([0.0, 1.0], [1.0], [0, 1], **kw),
    "lower above upper": lambda lib, kw: lib.UniformPrior([1.0], [0.0], [0], **kw),
    "index type": lambda lib, kw: lib.GaussianPrior(0.0, 1.0, 1.5, **kw),
    "index count": lambda lib, kw: lib.GaussianPrior([0.0, 1.0], [1.0, 1.0], [0], **kw),
    "index repeated": lambda lib, kw: lib.GaussianPrior([0.0, 1.0], [1.0, 1.0], [0, 0], **kw),
    "joint components": lambda lib, kw: lib.JointPrior([abs], 1),
    "joint repeated": lambda lib, kw: lib.JointPrior(
        [lib.GaussianPrior(0.0, 1.0, 0, **kw), lib.UniformPrior(0.0, 1.0, 0, **kw)], 1),
    "joint count": lambda lib, kw: lib.JointPrior([lib.GaussianPrior(0.0, 1.0, 0, **kw)], 2),
    "joint range": lambda lib, kw: lib.JointPrior([lib.GaussianPrior(0.0, 1.0, 3, **kw)], 1),
}


@pytest.mark.parametrize("case", sorted(BAD_MODELS))
def test_validation_errors_match_jax(case):
    ours, theirs = _both(BAD_MODELS[case])
    assert ours == theirs


def test_posterior_samples_in_chain_array_and_hamiltonian_chain():
    """A Posterior goes straight into ChainArray (vmap of its grad) and
    HamiltonianChain; both find the straight line's least-squares fit
    (gradient 2.06, offset 0.53 for this data) within the posterior's
    spread."""
    post = _line_posterior(tm)
    starts = np.random.default_rng(0).uniform([1.5, -1.0], [2.5, 1.0], size=(64, 2))
    ca = ChainArray("hmc", post, starts, steps=10, epsilon=0.1, retry=False, seed=1, device="cpu")
    ca.advance(120, store=True)
    mean = ca.get_sample(burn=40).mean(axis=0)
    x = np.linspace(1, 10, 10)
    y = 2.0 * x + 1.0 + np.random.default_rng(1).normal(0.0, 2.0, x.size)
    fit = np.polyfit(x, y, 1)
    assert abs(mean[0] - fit[0]) < 0.1 and abs(mean[1] - fit[1]) < 0.6
    chain = HamiltonianChain(post, start=np.array([2.0, 0.5]), display_progress=False, seed=2,
                             device="cpu")
    chain.steps = 10
    chain.advance(60)
    assert chain.get_sample().shape == (60, 2)
    assert np.isfinite(chain.get_probabilities()).all()
