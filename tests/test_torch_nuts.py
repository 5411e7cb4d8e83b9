"""The NUTS transition, ``ChainArray("nuts")`` and ``NutsChain`` of the
PyTorch port (inference_tpu_torch/mcmc/_kernels/nuts.py, parallel/_kinds.py,
mcmc/nuts.py) against the JAX package's, on the CPU in float64: 20
transitions of 16 lanes on draws replayed from the JAX package's key tree,
for unit, diagonal and full mass, diverging and depth-capped lanes
included; the batched kind's statistics, warm-up and checkpoints of both
packages; and the port's versions of tests/mcmc/test_nuts.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from inference_tpu.mcmc import NutsChain as JaxNutsChain
from inference_tpu.parallel import ChainArray as JaxChainArray
from inference_tpu.parallel._kinds import build_kind as jax_build_kind
from inference_tpu_torch import convert
from inference_tpu_torch.mcmc import NutsChain
from inference_tpu_torch.mcmc._kernels import nuts
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.parallel._kinds import build_kind


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


P, K, MAX_DEPTH, N_STEPS = 3, 16, 5, 20
ICOV = np.linalg.inv(np.array([[2.0, 1.2, 0.3], [1.2, 1.0, 0.1], [0.3, 0.1, 0.5]]))
MASSES = {"unit": None, "diagonal": np.array([1.0, 2.0, 0.5]),
          "full": np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])}


def gauss_torch(t):
    return -0.5 * t @ torch.as_tensor(ICOV) @ t


def gauss_jax(t):
    return -0.5 * t @ jnp.asarray(ICOV) @ t


def narrow_torch(t):
    """tests/mcmc/test_nuts.py's narrow_logp."""
    return -0.5e6 * (t @ t)


def narrow_jax(t):
    return -0.5e6 * (t @ t)


@jax.jit
def _jax_draws(keys):
    """Each lane's draws of one JAX transition from its key: the next key,
    the momentum's normals, and per doubling its direction and merge
    uniforms and its leaves' take uniforms, by the step's own key tree."""

    def one(key):
        key_next, k_mom, k_step = jax.random.split(key, 3)
        z = jax.random.normal(k_mom, (P,), jnp.float64)
        c, u_dir, u_merge, u_take = k_step, [], [], []
        for d in range(MAX_DEPTH):
            c, k_dir, k_sub, k_merge = jax.random.split(c, 4)
            u_dir.append(jax.random.uniform(k_dir, dtype=jnp.float64))
            u_merge.append(jax.random.uniform(k_merge, dtype=jnp.float64))
            s = k_sub
            for _ in range(2**d):
                s, k_take = jax.random.split(s)
                u_take.append(jax.random.uniform(k_take, dtype=jnp.float64))
        return key_next, z, jnp.stack(u_dir), jnp.stack(u_merge), jnp.stack(u_take)

    return jax.vmap(one)(keys)


def _lanes(case):
    """Starts, initial step sizes and posteriors of one case: the Gaussian
    with lanes at epsilon 50 (they diverge) and 0.004 (they reach
    max_depth) among ordinary ones, or the narrow target at epsilon 50."""
    rng = np.random.default_rng(7)
    if case == "narrow":
        return rng.normal(0.5, 0.1, (K, P)), np.full(K, 50.0), narrow_torch, narrow_jax
    eps = rng.uniform(0.2, 1.2, K)
    eps[:2], eps[2:4] = 50.0, 0.004
    return rng.normal(0.0, 1.0, (K, P)), eps, gauss_torch, gauss_jax


@pytest.mark.parametrize("case, mass", [("gauss", "unit"), ("gauss", "diagonal"),
                                        ("gauss", "full"), ("narrow", "unit")])
def test_step_matches_jax_on_replayed_draws(case, mass):
    """20 transitions of 16 lanes from the JAX package's draws: every
    output and state field within 1e-10, depths, leapfrog counts and
    divergence flags equal."""
    starts, eps, logp_t, logp_j = _lanes(case)
    im = MASSES[mass]
    j_init, j_step = jax_build_kind("nuts", logp_j, P, jnp.float64, epsilon=0.1,
                                    inverse_mass=im, max_depth=MAX_DEPTH)
    th = jnp.asarray(starts)
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    js = jax.vmap(j_init, in_axes=(0, 0, 0, None))(th, jax.vmap(logp_j)(th), keys, 1.0)
    js = js._replace(eps=js.eps._replace(value=jnp.asarray(eps)))
    j_step = jax.jit(jax.vmap(j_step))

    init, step = build_kind("nuts", logp_t, P, torch.float64, "cpu", epsilon=0.1,
                            inverse_mass=im, max_depth=MAX_DEPTH)
    ts = torch.as_tensor(starts)
    state = init(ts, torch.func.vmap(logp_t)(ts))
    state = state._replace(eps=state.eps._replace(value=torch.as_tensor(eps)))

    tol = dict(rtol=1e-10, atol=1e-12)
    seen_div = seen_cap = False
    for _ in range(N_STEPS):
        key_next, *draws = (np.asarray(x) for x in _jax_draws(js.key))
        js, jo = j_step(js)
        np.testing.assert_array_equal(np.asarray(js.key), key_next)
        state, out = step(state, None, *(torch.tensor(x) for x in draws))
        for name in ("theta", "logp", "epsilon"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jo, name)),
                                       **tol)
        for name in ("leapfrog_steps", "tree_depth", "divergent"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(jo, name)))
        for name in ("theta", "logp", "grad", "inv_temp"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(js, name)), **tol)
        for ours, theirs in zip(state.eps, js.eps):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **tol)
        np.testing.assert_array_equal(state.divergences.numpy(), np.asarray(js.divergences))
        seen_div |= bool(out.divergent.any())
        seen_cap |= bool((out.tree_depth == MAX_DEPTH).any())
    assert seen_div
    assert seen_cap or case == "narrow"


def test_multinomial_take_at_minus_inf_is_false():
    """A leaf whose posterior is -inf (or NaN, or +inf in the energy) gets
    weight -inf, and as the first leaf of a subtree (lse = -inf) it is not
    taken: exp(lw - lse) is NaN and u < NaN is False, as in the JAX step.
    A finite leaf is taken with probability 1 there."""
    h0 = torch.zeros(5)
    logp = torch.tensor([-torch.inf, torch.nan, 0.0, -1.0, torch.inf])
    kinetic = torch.tensor([0.5, 0.5, torch.inf, 0.5, 0.5])
    lw = nuts.leaf_log_weight(h0, kinetic, logp)
    assert torch.isneginf(lw[:3]).all() and torch.isneginf(lw[4])
    assert float(lw[3]) == -1.5
    lse, take = nuts.multinomial_take(torch.full((5,), 0.999), torch.full((5,), -torch.inf), lw)
    assert torch.isneginf(lse[[0, 1, 2, 4]]).all() and float(lse[3]) == -1.5
    assert take.tolist() == [False, False, False, True, False]


class _FiniteOnly:
    """A host-route posterior (values by ``batched``, a per-row gradient)
    that, like a Cholesky or an assert, raises on a non-finite position."""

    def __call__(self, t):
        return self.batched(t[None])[0]

    def batched(self, t):
        if not torch.isfinite(t).all():
            raise ValueError("non-finite position")
        return -0.5 * (t * t).sum(-1)

    def grad(self, row):
        if not torch.isfinite(row).all():
            raise ValueError("non-finite position")
        return -row


def test_stopped_lanes_are_not_integrated_past_the_stop():
    """Lane 0 diverges at its first leaf (epsilon 1e10: a position past it
    grows ~1e20 a leaf, to inf within 16 leaves) while lane 1 runs a long
    trajectory (epsilon 0.05): lane 0's posterior never sees a position
    past its stop, so a posterior that raises on non-finite input completes
    the transition, which equals the torch route's on the same draws."""
    post = _FiniteOnly()
    theta = torch.tensor([[0.3, -0.2, 0.1], [1.0, 0.5, -0.5]])
    outs = []
    for logp_fn, grad_fn in ((post, post.grad), (lambda t: -0.5 * t @ t, None)):
        step = nuts.make_nuts_step(logp_fn, grad_fn, max_depth=7)
        state = nuts.init_nuts_state(theta, post.batched(theta), 0.1, grad0=-theta)
        state = state._replace(eps=state.eps._replace(value=torch.tensor([1e10, 0.05])))
        outs.append(step(state, torch.Generator().manual_seed(4)))
    (s_host, o_host), (s_torch, o_torch) = outs
    assert o_host.divergent.tolist() == [True, False]
    assert int(o_host.tree_depth[1]) >= 6 and int(o_host.leapfrog_steps[1]) >= 32
    for a, b in ((s_host.theta, s_torch.theta), (s_host.grad, s_torch.grad),
                 (o_host.logp, o_torch.logp)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    for name in ("leapfrog_steps", "tree_depth", "divergent"):
        assert torch.equal(getattr(o_host, name), getattr(o_torch, name))


def test_init_state_and_run_steps_store_modes():
    with pytest.raises(ValueError, match="grad0"):
        nuts.init_nuts_state(torch.zeros(2, 3), torch.zeros(2), 0.1)
    init, step = build_kind("nuts", gauss_torch, P, torch.float64, "cpu", epsilon=0.3,
                            max_depth=4)
    theta = torch.full((8, P), 0.3)
    state = init(theta, torch.func.vmap(gauss_torch)(theta), inv_temp=0.5)
    np.testing.assert_allclose(state.grad.numpy(), -0.5 * theta.numpy() @ ICOV, rtol=1e-12)
    assert state.divergences.dtype == torch.int32 and float(state.inv_temp[0]) == 0.5
    s1, outs = nuts.run_steps(step, state, 4, True, torch.Generator().manual_seed(2))
    s2, none = nuts.run_steps(step, state, 4, False, torch.Generator().manual_seed(2))
    assert none is None
    assert outs.theta.shape == (4, 8, P) and outs.tree_depth.shape == (4, 8)
    assert outs.divergent.dtype == torch.bool
    torch.testing.assert_close(s1.theta, s2.theta, rtol=0, atol=0)
    _, empty = nuts.run_steps(step, state, 0, True, torch.Generator())
    assert empty.theta.shape == (0, 8, P) and empty.tree_depth.shape == (0, 8)
    # the cached gradient is the tempered gradient at the new position
    np.testing.assert_allclose(s1.grad.numpy(), -0.5 * s1.theta.numpy() @ ICOV, rtol=1e-10)


def test_unknown_options_raise():
    from inference_tpu_torch.utils import Bounds

    with pytest.raises(ValueError, match="reflecting bounds"):
        build_kind("nuts", gauss_torch, P, torch.float64, "cpu",
                   bounds=Bounds(np.full(P, -5.0), np.full(P, 5.0)))
    with pytest.raises(ValueError, match="torch posterior"):
        ChainArray("nuts", lambda t: -0.5 * float(np.sum(np.asarray(t) ** 2)),
                   np.zeros((4, 2)), device="cpu")
    with pytest.raises(ValueError, match="only available"):
        ChainArray("nuts", gauss_torch, np.zeros((4, P)), fused=True, device="cpu")


# --------------------------------------------------------------------- #
# ChainArray("nuts")
# --------------------------------------------------------------------- #
COV2 = np.array([[1.0, 0.7], [0.7, 2.0]])


def gauss2(t):
    """tests/test_parallel_sharded.py's correlated Gaussian."""
    return -0.5 * t @ torch.as_tensor(np.linalg.inv(COV2)) @ t


def test_chain_array_nuts_statistics():
    """tests/test_parallel_sharded.py:52-61 on the port: 64 chains sample
    the correlated Gaussian."""
    starts = np.random.default_rng(5).normal(0, 1, size=(64, 2))
    ca = ChainArray("nuts", gauss2, starts, seed=6, max_depth=8, device="cpu")
    ca.advance(300)
    s = ca.get_sample(burn=100)
    assert np.allclose(s.mean(0), 0.0, atol=0.1)
    assert np.allclose(np.cov(s.reshape(-1, 2).T), COV2, atol=0.3)
    assert ca.rhat(burn=100).max() < 1.05


def test_chain_array_nuts_warmup_and_set_inverse_mass():
    """warmup and set_inverse_mass apply to the nuts kind: the windows'
    pooled variances become the diagonal inverse mass, the warm-up samples
    are discarded, and the state survives the rebuilt step."""
    scales = np.array([1.0, 10.0, 0.1])
    logp = lambda t: -0.5 * ((t / torch.as_tensor(scales)) ** 2).sum()
    starts = np.random.default_rng(0).normal(size=(16, 3)) * scales
    ca = ChainArray("nuts", logp, starts, max_depth=6, seed=0, device="cpu")
    ca.warmup(n_steps=96, n_windows=3)
    assert not ca._history
    ratio = np.asarray(ca._build_kwargs["inverse_mass"]) / scales**2
    assert ratio.max() / ratio.min() < 10.0
    theta = ca.theta.copy()
    ca.set_inverse_mass(scales**2)
    np.testing.assert_array_equal(ca.theta, theta)
    ca.advance(32)
    assert np.isfinite(ca.get_sample()).all()
    gibbs = ChainArray("gibbs", logp, starts, device="cpu")
    with pytest.raises(ValueError, match="'hmc' and 'nuts'"):
        gibbs.warmup(100)


def test_chain_array_nuts_checkpoints_both_ways(tmp_path):
    """A JAX nuts ChainArray's checkpoint restores into the port and the
    port's into JAX: the 11 leaves in the order of jax.tree_util.tree_leaves
    of a JAX NutsState, every leaf equal but the key."""
    starts = np.random.default_rng(1).normal(0, 0.5, (8, 2))
    A = jnp.asarray(np.linalg.inv(COV2))
    theirs = JaxChainArray("nuts", lambda t: -0.5 * t @ A @ t, starts, max_depth=5, seed=1)
    theirs.advance(6, store=False)
    leaves = jax.tree_util.tree_leaves(theirs._state)
    assert len(leaves) == convert.N_NUTS_LEAVES
    ours_leaves = convert.nuts_state_to_jax_leaves(
        convert.nuts_state_from_jax(leaves, device="cpu"), np.asarray(leaves[8]))
    for a, b in zip(ours_leaves, leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    theirs.save(str(tmp_path / "jax.npz"))

    ours = ChainArray("nuts", gauss2, starts, max_depth=5, seed=2, device="cpu")
    ours.restore(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(ours._state.grad.numpy(), np.asarray(theirs._state.grad))
    np.testing.assert_array_equal(ours._state.divergences.numpy(),
                                  np.asarray(theirs._state.divergences))
    ours.advance(4)
    ours.save(str(tmp_path / "port.npz"))
    back = JaxChainArray("nuts", lambda t: -0.5 * t @ A @ t, starts, max_depth=5, seed=3)
    back.restore(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back._state.theta), ours.theta)
    np.testing.assert_array_equal(np.asarray(back._state.eps.value),
                                  ours._state.eps.value.numpy())
    back.advance(2)


# --------------------------------------------------------------------- #
# NutsChain: tests/mcmc/test_nuts.py on the port
# --------------------------------------------------------------------- #
class Toroidal:
    """tests/mcmc/mcmc_utils.py's ToroidalGaussian in torch."""

    coeff = -0.5 / 0.05**2

    def __call__(self, theta):
        r_sqr = theta[2] ** 2 + (torch.sqrt(theta[0] ** 2 + theta[1] ** 2) - 1.0) ** 2
        return self.coeff * r_sqr

    def gradient(self, theta):
        x, y, z = theta[0], theta[1], theta[2]
        k = 1 - 1.0 / torch.sqrt(x**2 + y**2)
        return 2 * self.coeff * torch.stack([k * x, k * y, z])


def toroidal_jax(theta):
    r_sqr = theta[2] ** 2 + (jnp.sqrt(theta[0] ** 2 + theta[1] ** 2) - 1.0) ** 2
    return Toroidal.coeff * r_sqr


COV = np.array([[2.0, 1.2], [1.2, 1.0]])


def gaussian_logp(t):
    return -0.5 * t @ torch.as_tensor(np.linalg.inv(COV)) @ t


def make_chain(n=300, seed=4, **kwargs):
    chain = NutsChain(posterior=Toroidal(), start=np.array([1.0, 0.1, 0.1]),
                      display_progress=False, seed=seed, device="cpu", **kwargs)
    chain.advance(n)
    return chain


@pytest.fixture(scope="module")
def toroidal_chain():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return make_chain(n=128)
    finally:
        torch.set_default_dtype(old)


@pytest.fixture(scope="module")
def divergent_chain():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        chain = NutsChain(posterior=narrow_torch, start=np.array([0.5, 0.5]), epsilon=50.0,
                          display_progress=False, seed=5, device="cpu")
        chain.advance(32)
        return chain
    finally:
        torch.set_default_dtype(old)


def test_nuts_advance_and_slicing(toroidal_chain):
    chain = toroidal_chain
    assert chain.chain_length == 129
    for burn, thin in [(0, 1), (1, 1), (10, 3), (50, 7)]:
        expected = len(range(chain.chain_length)[burn::thin])
        assert chain.get_sample(burn=burn, thin=thin).shape == (expected, 3)
        assert chain.get_probabilities(burn=burn, thin=thin).size == expected
    depths = chain.tree_depths
    leaps = np.array(chain.leapfrog_steps)
    assert depths.shape == (129,)
    assert (depths[1:] >= 1).all() and (depths <= 10).all()
    assert (leaps[1:] >= 2 ** (depths[1:] - 1)).all()


def test_nuts_gaussian_covariance():
    """The JAX test's chain (2,500 transitions, burn 500). Its means are
    held to 4 standard errors from the chain's own ESS: the JAX test's
    0.15 is about one standard error of this chain."""
    from inference_tpu_torch.utils import effective_sample_size

    chain = NutsChain(posterior=gaussian_logp, start=np.array([0.1, 0.1]),
                      display_progress=False, seed=11, device="cpu")
    chain.advance(2500)
    s = chain.get_sample(burn=500)
    assert np.abs(np.cov(s.T) - COV).max() < 0.25
    se = s.std(axis=0) / np.sqrt([effective_sample_size(x) for x in s.T])
    assert (np.abs(s.mean(axis=0)) < 4 * se).all()
    assert 1.0 < chain.tree_depths[500:].mean() < 6.0
    assert chain.n_divergences == 0


@pytest.mark.slow
def test_nuts_statistics():
    chain = make_chain(n=3000, seed=1)
    s = chain.get_sample(burn=500)
    radius = np.sqrt(s[:, 0] ** 2 + s[:, 1] ** 2)
    assert abs(radius.mean() - 1.0) < 0.05
    assert abs(s[:, 2].mean()) < 0.05
    assert abs(s[:, 2].std() - 0.05) < 0.02


def test_nuts_user_gradient():
    """A torch user gradient takes HamiltonianChain's gradient route and
    gives the autograd chain's transitions."""
    posterior = Toroidal()
    chains = [NutsChain(posterior=posterior, grad=g, start=np.array([1.0, 0.1, 0.1]),
                        display_progress=False, seed=2, device="cpu")
              for g in (posterior.gradient, None)]
    for c in chains:
        c.advance(40)
    np.testing.assert_allclose(chains[0].get_sample(), chains[1].get_sample(), rtol=1e-8)
    radius = np.hypot(*chains[0].get_sample(burn=10)[:, :2].T)
    assert abs(radius.mean() - 1.0) < 0.1


@pytest.mark.parametrize("inverse_mass", [2.0, np.array([1.0, 2.0, 0.5]),
                                          np.diag([1.0, 2.0, 0.5]) + 0.1])
def test_nuts_mass_options(inverse_mass):
    chain = make_chain(n=32, inverse_mass=inverse_mass)
    assert chain.chain_length == 33
    assert np.isfinite(chain.get_probabilities()).all()


def test_nuts_divergence_counting(divergent_chain):
    chain = divergent_chain
    assert chain.n_divergences > 0
    assert chain.n_divergences == int(chain.divergent_steps.sum())
    assert np.isfinite(chain.get_sample()).all()


def test_nuts_save_load_both_packages(toroidal_chain, tmp_path):
    """A port checkpoint loads in the port and in the JAX package, and a
    JAX checkpoint in the port, each with its history, depths, divergence
    flags and count, max_depth and step size."""
    chain = toroidal_chain
    f = tmp_path / "nuts.npz"
    chain.save(str(f))
    loaded = NutsChain.load(str(f), posterior=Toroidal(), device="cpu")
    assert np.allclose(loaded.get_sample(), chain.get_sample())
    assert np.allclose(loaded.get_probabilities(), chain.get_probabilities())
    np.testing.assert_array_equal(loaded.tree_depths, chain.tree_depths)
    assert loaded.n_divergences == chain.n_divergences
    assert loaded.max_depth == chain.max_depth
    np.testing.assert_allclose(loaded._state.grad.numpy(), chain._state.grad.numpy(),
                               rtol=1e-12)
    loaded.advance(8)
    assert loaded.chain_length == chain.chain_length + 8

    jax_loaded = JaxNutsChain.load(str(f), posterior=toroidal_jax)
    np.testing.assert_array_equal(jax_loaded.get_sample(), chain.get_sample())
    np.testing.assert_array_equal(jax_loaded.tree_depths, chain.tree_depths)
    assert jax_loaded.ES.epsilon == chain.ES.epsilon
    ref = JaxNutsChain(toroidal_jax, start=np.array([1.0, 0.1, 0.1]), max_depth=7,
                       display_progress=False, seed=1)
    ref.advance(8)
    port = convert.nuts_chain_from_jax(ref, Toroidal(), seed=0, device="cpu")
    np.testing.assert_array_equal(port.get_sample(), ref.get_sample())
    np.testing.assert_array_equal(port.tree_depths, ref.tree_depths)
    np.testing.assert_array_equal(port.divergent_steps, ref.divergent_steps)
    assert port.max_depth == 7 and port.n_divergences == ref.n_divergences
    np.testing.assert_allclose(port._state.grad.numpy()[0], np.asarray(ref._state.grad),
                               rtol=1e-10)
    port.advance(4)


def test_nuts_plot_diagnostics_names_a14(toroidal_chain):
    with pytest.raises(NotImplementedError, match="A14"):
        toroidal_chain.plot_diagnostics(show=False)


def test_nuts_mode_and_estimate_mass():
    chain = make_chain(n=64, seed=3)
    assert np.isfinite(chain.mode()).all()
    chain.estimate_mass(burn=16, diagonal=False)
    chain.advance(16)
    assert chain.chain_length == 81


def test_nuts_resave_preserves_divergences(divergent_chain, tmp_path):
    n_div = divergent_chain.n_divergences
    assert n_div > 0
    f1, f2 = tmp_path / "a.npz", tmp_path / "b.npz"
    divergent_chain.save(str(f1))
    analysis_only = NutsChain.load(str(f1), device="cpu")
    analysis_only.save(str(f2))
    resumed = NutsChain.load(str(f2), posterior=narrow_torch, device="cpu")
    assert resumed.n_divergences == n_div
    assert int(resumed.divergent_steps.sum()) == n_div


def test_nuts_grad_cache_matches_position():
    chain = NutsChain(posterior=gaussian_logp, start=np.array([1.0, 0.5]), temperature=2.5,
                      display_progress=False, seed=11, device="cpu")
    chain.advance(32)
    st = chain._state
    expected = chain.inv_temp * -(st.theta.numpy() @ np.linalg.inv(COV))
    np.testing.assert_allclose(st.grad.numpy(), expected, rtol=1e-10)


def test_nuts_replace_last_refreshes_grad_cache():
    chain = NutsChain(posterior=gaussian_logp, start=np.array([1.0, 0.5]),
                      display_progress=False, seed=3, device="cpu")
    chain.advance(8)
    new_theta = np.array([0.3, -0.2])
    chain.replace_last(new_theta)
    chain.replace_last_probability(float(gaussian_logp(torch.as_tensor(new_theta))))
    np.testing.assert_allclose(chain._state.grad.numpy()[0], -np.linalg.inv(COV) @ new_theta,
                               rtol=1e-12)
    chain.advance(8)
    assert np.isfinite(chain.get_probabilities()).all()


def test_nuts_host_posterior_takes_forward_differences():
    """A numpy posterior runs on the host with HamiltonianChain's
    forward-difference gradient, to 1e-5 of the torch chain's cache."""
    icov = np.linalg.inv(COV)
    chain = NutsChain(lambda t: -0.5 * float(t @ icov @ t), start=np.array([0.4, -0.3]),
                      display_progress=False, seed=3, device="cpu")
    assert chain._logp.host
    chain.advance(16)
    g = chain._state.grad.numpy()[0]
    np.testing.assert_allclose(g, -icov @ chain._state.theta.numpy()[0], rtol=1e-4, atol=1e-5)
    assert np.isfinite(chain.get_sample()).all()


@pytest.mark.slow
def test_nuts_warmup_mass_adaptation_raises_ess():
    """tests/mcmc/test_nuts.py's warm-up test on the port: on a Gaussian of
    variance condition 1e4, windowed diagonal mass adaptation raises the
    worst parameter's ESS a step at least fivefold, and the adapted inverse
    mass tracks the variances."""
    scales = np.geomspace(1.0, 100.0, 6)
    logp = lambda t: -0.5 * ((t / torch.as_tensor(scales)) ** 2).sum()
    starts = np.random.default_rng(0).normal(size=(8, 6)) * scales[None, :]
    worst_ess = lambda ca: float(ca.effective_sample_size().mean(axis=0).min())
    base = ChainArray("nuts", logp, starts, max_depth=6, seed=0, device="cpu")
    base.advance(384)
    warm = ChainArray("nuts", logp, starts, max_depth=6, seed=0, device="cpu")
    warm.warmup(n_steps=384, n_windows=3)
    assert not warm._history
    ratio = np.asarray(warm._build_kwargs["inverse_mass"]) / scales**2
    assert ratio.max() / ratio.min() < 30.0
    warm.advance(384)
    assert worst_ess(warm) >= 5.0 * worst_ess(base)
