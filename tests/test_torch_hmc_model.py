"""Kernel B1's model route in the PyTorch port
(inference_tpu_torch/ops/hmc_model.py): a posterior of the library's models
over a ``LinearForwardModel`` as the ``ModelForm`` the kernel reads, held
to the JAX package's posterior over the same linear model (value and
autodiff gradient), its plain version (``hmc_fused._reference_chunk`` on
the form) to the JAX package's mirror (``_reference_chunk`` with the JAX
posterior) on the same draws, ``linear_posterior_from_jax``, the fused
``ChainArray`` on the CPU, the plan and padded operands of a launch, and the
gating. The kernel itself is tested on the card by test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import inference_tpu.models as jm
from inference_tpu.mcmc._kernels.common import AdaptiveScale as JaxScale
from inference_tpu.ops import hmc_fused as jax_fused
import inference_tpu_torch.models as tm
from inference_tpu_torch.convert import linear_posterior_from_jax
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.ops import hmc_fused, hmc_model
from inference_tpu_torch.parallel import ChainArray
from test_torch_hmc_fused import _assert_chunks_match

FAMILIES = ("gaussian", "cauchy", "logistic")
PRIORS = ("none", "gauss", "gauss+exp", "gauss+unif")
LIKELIHOODS = {"gaussian": "GaussianLikelihood", "cauchy": "CauchyLikelihood",
               "logistic": "LogisticLikelihood"}
# diagonal inverse masses whose momentum scales 1/sqrt(m) are exact in
# float32 (the JAX package computes them in float32 even under x64)
MASSES = (1.0, 4.0, 0.25, 16.0, 0.0625, 64.0, 1.0, 4.0, 0.25, 16.0)


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


def _data(family, P, N, seed):
    """M (N, P), an offset, data about M truth + offset with the family's
    noise, the scales and the truth (its last two variables positive)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(N, P)) / np.sqrt(P)
    offset = rng.normal(0, 0.5, N)
    truth = rng.normal(0, 1, P)
    truth[-2:] = np.abs(truth[-2:]) + 0.2
    noise = {"gaussian": rng.normal(size=N), "cauchy": rng.standard_cauchy(N),
             "logistic": rng.logistic(size=N)}[family]
    scales = rng.uniform(0.2, 0.4, N)
    return M, offset, M @ truth + offset + 0.3 * noise, scales, truth


def _prior_args(prior, P):
    """(kind, args) of each component: a Gaussian on all but the last two
    variables (all of them for "gauss"), an Exponential or a Uniform on
    those two."""
    rest = list(range(P - 2)) if prior != "gauss" else list(range(P))
    parts = [("GaussianPrior", (np.linspace(-0.5, 0.5, len(rest)), np.linspace(1.0, 2.0, len(rest)),
                                rest))]
    if prior == "gauss+exp":
        parts.append(("ExponentialPrior", (np.array([1.0, 0.5]), [P - 2, P - 1])))
    if prior == "gauss+unif":
        parts.append(("UniformPrior", (np.array([-1.0, 0.0]), np.array([3.0, 2.5]), [P - 2, P - 1])))
    return parts


def _posteriors(family, prior, P, N=40, seed=0):
    """The same posterior in both packages: (torch, JAX, M, offset, truth)."""
    M, offset, y, scales, truth = _data(family, P, N, seed)
    Mj, oj = jnp.asarray(M), jnp.asarray(offset)
    jlik = getattr(jm, LIKELIHOODS[family])(y, scales, forward_model=lambda t: Mj @ t + oj)
    tlik = getattr(tm, LIKELIHOODS[family])(y, scales, tm.LinearForwardModel(M, offset, device="cpu"),
                                            device="cpu")
    if prior == "none":
        return tlik, jlik, M, offset, truth
    parts = _prior_args(prior, P)
    jparts = [getattr(jm, k)(*a) for k, a in parts]
    tparts = [getattr(tm, k)(*a, device="cpu") for k, a in parts]
    if len(parts) == 1:
        return tm.Posterior(tlik, tparts[0]), jm.Posterior(jlik, jparts[0]), M, offset, truth
    return (tm.Posterior(tlik, tm.JointPrior(tparts, P)),
            jm.Posterior(jlik, jm.JointPrior(jparts, P)), M, offset, truth)


def _points(prior, truth, K, seed):
    """(P, K) points about the truth; for a bounded prior every fourth one
    outside its support (a bounded variable below its lower end)."""
    rng = np.random.default_rng(seed)
    t = truth[:, None] + rng.normal(0, 0.3, (len(truth), K))
    t[-2:] = np.abs(t[-2:]) + 0.05
    if prior in ("gauss+exp", "gauss+unif"):
        t[-1, ::4] = -1.5
    return t


# --------------------------------------------------------------------- #
# the form against the JAX posterior
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("family", FAMILIES)
def test_form_value_and_gradient_match_jax(family, prior):
    """value_cols and grad_cols of the form equal ``jax.vmap(
    jax.value_and_grad(posterior))`` of the JAX posterior over the same
    linear model to 1e-10, inside and outside the support (where the value
    is -1e100 in both and an Exponential prior's gradient 0); they also
    equal autodiff of the port's own posterior."""
    post, jpost, M, offset, truth = _posteriors(family, prior, 5)
    t = _points(prior, truth, 12, seed=1)
    form = hmc_model.model_form(post)
    v, g = form.value_cols(torch.as_tensor(t)).numpy(), form.grad_cols(torch.as_tensor(t)).numpy()
    jv, jg = jax.vmap(jax.value_and_grad(jpost), in_axes=1, out_axes=(0, 1))(jnp.asarray(t))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-10, atol=1e-10)
    tg = torch.func.vmap(torch.func.grad(post))(torch.as_tensor(t.T.copy())).numpy().T
    np.testing.assert_allclose(g, tg, rtol=1e-10, atol=1e-10)
    if prior in ("gauss+exp", "gauss+unif"):
        assert (v[::4] == -1e100).all() and (v[1::4] > -1e100).all()


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("family", FAMILIES)
def test_linear_posterior_from_jax_gives_jax_values(family, prior):
    """``linear_posterior_from_jax`` builds, from the JAX objects and the
    matrix as numpy, a port posterior with the JAX posterior's values."""
    _, jpost, M, offset, truth = _posteriors(family, prior, 4, seed=2)
    post = linear_posterior_from_jax(jpost, M, offset, device="cpu")
    assert isinstance((post.likelihood if prior != "none" else post).model, tm.LinearForwardModel)
    t = _points(prior, truth, 8, seed=3)
    ours = np.array([float(post(torch.as_tensor(t[:, k]))) for k in range(8)])
    theirs = np.array([float(jpost(jnp.asarray(t[:, k]))) for k in range(8)])
    np.testing.assert_allclose(ours, theirs, rtol=1e-10)


def test_linear_forward_model_is_m_theta_plus_offset():
    rng = np.random.default_rng(0)
    M, off = rng.normal(size=(6, 3)), rng.normal(size=6)
    f = tm.LinearForwardModel(M, off, device="cpu")
    t = rng.normal(size=(4, 3))
    np.testing.assert_allclose(f(torch.as_tensor(t)).numpy(), t @ M.T + off, rtol=1e-14)
    np.testing.assert_allclose(f(t[0]).numpy(), M @ t[0] + off, rtol=1e-14)
    np.testing.assert_allclose(tm.LinearForwardModel(M, device="cpu")(t[0]).numpy(), M @ t[0],
                               rtol=1e-14)
    with pytest.raises(ValueError, match="2D"):
        tm.LinearForwardModel(np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="offset"):
        tm.LinearForwardModel(M, np.ones(5), device="cpu")


# --------------------------------------------------------------------- #
# the plain version against the JAX mirror
# --------------------------------------------------------------------- #
def _state(P, K, n, seed, truth, prior, dtype=np.float64):
    """Positions about the truth, a mid-adaptation step-size state and the
    draws of n transitions, numpy."""
    rng = np.random.default_rng(seed)
    theta = _points(prior, truth, K, seed)
    theta[-1, ::4] = np.abs(theta[-1, ::4])  # start inside; proposals may leave
    num = rng.integers(0, 20, K).astype(np.int32)
    eps = dict(value=rng.uniform(0.005, 0.03, K), avg=num * rng.uniform(0.4, 0.9, K),
               var=num * 0.2, num=num, chk_int=rng.choice([15, 20], K).astype(np.int32))
    draws = dict(z=rng.normal(size=(n, P, K)), us=rng.uniform(size=(n, K)),
                 ua=rng.uniform(size=(n, K)))
    cast = lambda x: x.astype(dtype) if x.dtype.kind == "f" else x
    return cast(theta), {k: cast(v) for k, v in eps.items()}, {k: cast(v) for k, v in draws.items()}


def _jax_chunk(jpost, theta, eps, draws, inv_temp, steps, im):
    vg = jax_fused._batch_posterior(jpost)
    K = theta.shape[1]
    row = lambda x: jnp.asarray(x).reshape(1, K)
    it = row(np.full(K, inv_temp, theta.dtype))
    lp = vg(jnp.asarray(theta))[0] * it
    t, lp, e, hist = jax_fused._reference_chunk(
        jnp.asarray(theta), lp, JaxScale(*(row(eps[k]) for k in JaxScale._fields)),
        it, jnp.asarray(draws["z"]), jnp.asarray(draws["us"])[:, None, :],
        jnp.asarray(draws["ua"])[:, None, :], logp_fn=jpost, steps=steps, inv_mass_diag=im)
    ht, hp, hs, he = (np.asarray(h) for h in hist)
    return (np.asarray(t), np.asarray(lp)[0], [np.asarray(x)[0] for x in e],
            (ht, hp[:, 0], hs[:, 0], he[:, 0]))


def _torch_chunk(form, theta, eps, draws, inv_temp, steps, im):
    t = torch.as_tensor(theta)
    it = torch.full((t.shape[1],), inv_temp, dtype=t.dtype)
    lp = form.value_cols(t) * it
    e = AdaptiveScale(*(torch.as_tensor(eps[k]) for k in AdaptiveScale._fields))
    imt = None if im is None else torch.as_tensor(im, dtype=t.dtype)
    t, lp, e, hist = hmc_fused._reference_chunk(
        t, lp, e, it, *(torch.as_tensor(draws[k]) for k in ("z", "us", "ua")),
        form=form, steps=steps, inv_mass_diag=imt, store=True)
    return t.numpy(), lp.numpy(), [x.numpy() for x in e], tuple(h.numpy() for h in hist)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("P", [3, 10])
@pytest.mark.parametrize("diag_mass", [False, True])
@pytest.mark.parametrize("inv_temp", [1.0, 0.5])
def test_reference_chunk_matches_jax_mirror_float64(family, P, diag_mass, inv_temp):
    """8 transitions of 64 chains on a posterior with a Gaussian and an
    Exponential prior: the port's plain version on the form equals the JAX
    package's mirror on the JAX posterior to 1e-10 in float64, step counts
    and adaptation counters exactly; proposals were both accepted and
    rejected. (Logistic: the JAX kernel does not trace it, its mirror
    runs it.)"""
    post, jpost, M, offset, truth = _posteriors(family, "gauss+exp", P, N=30, seed=P)
    theta, eps, draws = _state(P, 64, 8, P + int(10 * inv_temp), truth, "gauss+exp")
    im = np.asarray(MASSES[:P]) if diag_mass else None
    form = hmc_model.model_form(post)
    ours = _torch_chunk(form, theta, eps, draws, inv_temp, 8, im)
    theirs = _jax_chunk(jpost, theta, eps, draws, inv_temp, 8, im)
    _assert_chunks_match(ours, theirs, rtol=1e-10, atol=1e-12)
    moved = (ours[3][0] != np.concatenate([theta[None], ours[3][0][:-1]])).any(axis=1)
    assert 0.0 < moved.mean() < 1.0


@pytest.mark.parametrize("prior", ["none", "gauss", "gauss+unif"])
def test_reference_chunk_matches_jax_mirror_other_priors(prior):
    """The same with no prior, a Gaussian prior alone and a Gaussian with a
    Uniform, Gaussian likelihood, P = 3."""
    post, jpost, M, offset, truth = _posteriors("gaussian", prior, 3, N=30, seed=4)
    theta, eps, draws = _state(3, 64, 8, 5, truth, prior)
    ours = _torch_chunk(hmc_model.model_form(post), theta, eps, draws, 1.0, 8, None)
    theirs = _jax_chunk(jpost, theta, eps, draws, 1.0, 8, None)
    _assert_chunks_match(ours, theirs, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_chunk_matches_jax_mirror_float32(family):
    """6 transitions in float32: agreement to float32 roundoff (the
    tolerances of the JAX package's own kernel-vs-mirror test). The energy's
    roundoff grows with |logp|, so the data are few (N = 10, |logp| ~ 10)."""
    torch.set_default_dtype(torch.float32)
    post, jpost, M, offset, truth = _posteriors(family, "gauss+exp", 3, N=10, seed=6)
    theta, eps, draws = _state(3, 64, 6, 7, truth, "gauss+exp", dtype=np.float32)
    with jax_fused._x64_off_ctx():
        jpost32 = _posteriors(family, "gauss+exp", 3, N=10, seed=6)[1]
        theirs = _jax_chunk(jpost32, theta, eps, draws, 1.0, 8, None)
    ours = _torch_chunk(hmc_model.model_form(post), theta, eps, draws, 1.0, 8, None)
    assert ours[0].dtype == np.float32 and theirs[0].dtype == np.float32
    _assert_chunks_match(ours, theirs, rtol=2e-5, atol=2e-6)


# --------------------------------------------------------------------- #
# ChainArray(fused=True) on the CPU
# --------------------------------------------------------------------- #
def test_fused_chain_array_equals_the_mirror():
    """On the CPU the fused advance of a model posterior is its plain
    version: it equals ``_advance_mirror`` on the same generator state."""
    post, _, M, offset, truth = _posteriors("cauchy", "gauss+exp", 4, seed=8)
    starts = truth + np.random.default_rng(9).normal(0, 0.05, (32, 4))
    starts[:, -2:] = np.abs(starts[:, -2:])
    ca = ChainArray("hmc", post, starts, steps=10, epsilon=0.02, retry=False, fused=True,
                    seed=5, device="cpu")
    assert isinstance(ca._fused_plan.form, hmc_model.ModelForm) and ca._fused_plan.padded is None
    state0 = ca._state
    ca.advance(5, store=True)
    _, hist = hmc_fused._advance_mirror(ca._fused_plan, state0, 5, True,
                                        torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(np.concatenate(ca._history), hist[0].numpy())
    np.testing.assert_array_equal(ca.logp, hist[1][-1].numpy())


def test_fused_chain_array_samples_the_linear_gaussian_posterior():
    """A Gaussian likelihood over a linear model with a Gaussian prior has a
    Gaussian posterior; the fused ChainArray's pooled means lie within 5
    standard errors of its mean and its variances within 10%."""
    post, _, M, offset, truth = _posteriors("gaussian", "gauss", 3, N=40, seed=10)
    lik, prior = post.likelihood, post.prior
    w = lik.inv_sigma.numpy() ** 2
    precision = M.T @ (M * w[:, None]) + np.diag(prior.inv_sigma.numpy() ** 2)
    cov = np.linalg.inv(precision)
    mean = cov @ (M.T @ (w * (lik.y.numpy() - offset)) + prior.mean.numpy() * prior.inv_sigma.numpy() ** 2)
    starts = mean + np.random.default_rng(11).normal(0, 0.05, (256, 3))
    ca = ChainArray("hmc", post, starts, steps=10, epsilon=0.5 * np.sqrt(np.linalg.eigvalsh(cov).min()),
                    retry=False, fused=True, seed=12, device="cpu")
    ca.advance(50, store=False)
    ca.advance(100, store=True)
    h = np.concatenate(ca._history)
    sample = h.reshape(-1, 3)
    se = h.mean(axis=0).std(axis=0, ddof=1) / np.sqrt(h.shape[1])
    assert (np.abs(sample.mean(axis=0) - mean) / se).max() < 5.0
    assert np.abs(sample.var(axis=0) / np.diag(cov) - 1.0).max() < 0.10


def test_set_inverse_mass_rebuilds_the_model_plan():
    post = _posteriors("logistic", "gauss+unif", 3, seed=13)[0]
    ca = ChainArray("hmc", post, np.full((8, 3), 0.5), retry=False, fused=True, seed=0,
                    device="cpu")
    assert ca._fused_plan.inv_mass_diag is None
    ca.set_inverse_mass(np.array([1.0, 4.0, 0.25]))
    assert ca._fused_plan.inv_mass_diag == (1.0, 4.0, 0.25)
    assert isinstance(ca._fused_plan.form, hmc_model.ModelForm)
    ca.advance(2, store=True)
    assert ca.get_sample().shape == (16, 3)


# --------------------------------------------------------------------- #
# gating
# --------------------------------------------------------------------- #
class _CustomPrior(tm.BasePrior):
    def __init__(self):
        self.variables = [0]
        self.bounds = [(None, None)]
        self._place("cpu")

    def __call__(self, theta):
        return -(theta[..., 0] ** 2)

    def gradient(self, theta):
        return -2 * theta[..., :1]


REFUSED = ("a lambda forward model", "a lambda forward model, bare", "a custom prior",
           "a custom prior in a JointPrior", "a numpy posterior")


def _refused(case):
    M = np.eye(3)
    lam = tm.GaussianLikelihood(np.zeros(3), np.ones(3), lambda t: t, device="cpu")
    lin = tm.GaussianLikelihood(np.zeros(3), np.ones(3), tm.LinearForwardModel(M, device="cpu"),
                                device="cpu")
    if case == "a lambda forward model":
        return tm.Posterior(lam, tm.GaussianPrior(0.0, 1.0, 0, device="cpu"))
    if case == "a lambda forward model, bare":
        return lam
    if case == "a custom prior":
        return tm.Posterior(lin, _CustomPrior())
    if case == "a custom prior in a JointPrior":
        return tm.Posterior(lin, tm.JointPrior(
            [_CustomPrior(), tm.GaussianPrior([0.0, 0.0], [1.0, 1.0], [1, 2], device="cpu")], 3))
    return lambda t: -0.5 * float(np.sum(np.asarray(t) ** 2))


@pytest.mark.parametrize("case", REFUSED)
def test_plan_refuses_what_the_kernel_cannot_read(case):
    """Each posterior the model route cannot read raises, naming what the
    kernel takes; through ChainArray(fused=True) too where the posterior
    runs in torch."""
    posterior = _refused(case)
    with pytest.raises(ValueError, match="LinearForwardModel"):
        hmc_fused.plan_fused_hmc(posterior, 3, steps=10)
    if case != "a numpy posterior":
        with pytest.raises(ValueError, match="LinearForwardModel"):
            ChainArray("hmc", posterior, np.full((4, 3), 0.5), retry=False, fused=True,
                       device="cpu")


def test_plan_checks_parameter_counts():
    post = _posteriors("gaussian", "none", 3)[0]
    with pytest.raises(ValueError, match="3 parameters, the chains have 4"):
        hmc_fused.plan_fused_hmc(post, 4, steps=10)
    with pytest.raises(ValueError, match="names variable"):
        hmc_model.model_form(tm.Posterior(post, tm.GaussianPrior(0.0, 1.0, 5, device="cpu")))


def test_auto_keeps_the_plain_path():
    post = _posteriors("cauchy", "gauss+exp", 3)[0]
    ca = ChainArray("hmc", post, np.full((8, 3), 0.5), retry=False, fused="auto", device="cpu")
    assert ca._fused_plan is None
    ca.advance(2, store=True)
    assert ca.get_sample().shape == (16, 3)


# --------------------------------------------------------------------- #
# a launch's plan and padded operands
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("N", [1, 40, 1024, 100_000])
@pytest.mark.parametrize("K", [1, 1000, 4096, 65536])
@pytest.mark.parametrize("P", [1, 10, hmc_model.NARROW_P_MAX, hmc_model.NARROW_P_MAX + 1, 65, 256,
                               1000, 2048, 2049, 2760, hmc_model.model_p_max()])
def test_model_plan_fits_a_block(P, K, N):
    """Every plan fits a block's shared memory by the kernel's own formula
    and takes the route ``model_route`` names. Narrow: lanes a chain a
    power of two up to 32, 256 / lanes chains a block, the resident rows N
    rounded up to 32, and the most lanes whose blocks fit the card at once.
    Wide: 4 to 64 chains (a power of two) whose momenta are one 8 x 4 tile
    a thread at most, or two at 4 chains where one is too few (P above
    2,048), a slab of 4 to 256 rows (a power of two), the residual's
    groups none empty and their tiles no more than the threads where they
    can, the gradient's groups as many as its tiles leave threads; a
    larger P raises."""
    plan = hmc_model.model_plan(P, K, N)
    assert plan.route == hmc_model.model_route(P, N)
    assert plan.blocks == -(-K // plan.chains) and plan.smem <= hmc_model.SMEM_BLOCK
    if plan.route == "narrow":
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.chains == 256 // plan.lanes
        assert plan.rows == -(-N // 32) * 32 and plan.stride == hmc_model.narrow_width(P)
        assert (plan.slab, plan.ga, plan.gc, plan.tiles) == (0, 0, 0, 0)
        assert plan.smem == hmc_model._narrow_smem(plan.rows, P)
        per_sm = max(1, min(hmc_model.narrow_blocks_sm(P), 233_472 // (plan.smem + 1024)))
        fits = lambda lanes: -(-K * lanes // 256) <= 132 * per_sm
        assert plan.lanes == 1 or fits(plan.lanes)
        assert plan.lanes == 32 or not fits(2 * plan.lanes)
        return
    assert plan.lanes == 0 and plan.chains in (4, 8, 16, 32, 64)
    assert plan.slab in (4, 8, 16, 32, 64, 128, 256)
    assert plan.rows == -(-P // 8) * 8 and plan.stride == plan.rows + 4
    assert plan.tiles == hmc_model.wide_tiles(P) == (1 if plan.rows <= 2048 else 2)
    assert plan.rows * plan.chains <= plan.tiles * 8 * 4 * 256
    assert plan.tiles == 1 or (plan.chains == 4 and plan.rows * plan.chains > 8 * 4 * 256)
    assert plan.smem == hmc_model._wide_smem(plan.rows, plan.chains, plan.slab, plan.ga, plan.gc)
    tiles_a = plan.slab // 4 * plan.chains // 4
    tiles_c = plan.rows // 8 * plan.chains // 4
    quads, per_group = plan.rows // 4, -(-plan.rows // 4 // plan.ga)
    assert tiles_a * plan.ga <= max(tiles_a, 256) and 4 * plan.ga <= plan.rows
    assert (plan.ga - 1) * per_group < quads  # no residual group empty
    assert tiles_c * plan.gc <= 256 * plan.tiles and plan.gc <= plan.slab
    assert plan.gc == plan.slab or tiles_c * (plan.gc + 1) > 256
    with pytest.raises(ValueError, match=str(hmc_model.model_p_max())):
        hmc_model.model_plan(hmc_model.model_p_max() + 1, K, N)


@pytest.mark.parametrize("P, N, route", [
    (1, 1, "narrow"), (10, 1024, "narrow"), (hmc_model.NARROW_P_MAX, 768, "narrow"),
    (hmc_model.NARROW_P_MAX + 1, 768, "wide"), (65, 40, "wide"), (256, 1024, "wide"),
    (10, 4832, "narrow"), (10, 4833, "wide"), (10, 100_000, "wide"),
    (16, 2880, "narrow"), (16, 2881, "wide"), (40, 1312, "narrow"), (40, 1313, "wide"),
    (48, 1088, "narrow"), (48, 1089, "wide"), (hmc_model.NARROW_P_MAX, 960, "narrow"),
    (hmc_model.NARROW_P_MAX, 961, "wide")])
def test_model_route_by_p_and_n(P, N, route):
    """The route by shape alone: narrow up to ``NARROW_P_MAX`` parameters
    while N rounded up to 32 rows of ``narrow_width(P)`` words and the four
    per-variable words fit a block (P = 10: 4,832 data; P = 16: 2,880; P =
    40: 1,312; P = 48: 1,088; P = 52: 960), wide above either; the padded
    operands follow it."""
    assert hmc_model.model_route(P, N) == route
    rows = -(-N // 32) * 32
    resident = 4 * (rows * hmc_model.narrow_width(P) + 4 * (-(-P // 8) * 8))
    assert (route == "narrow") == (P <= hmc_model.NARROW_P_MAX
                                   and resident <= hmc_model.SMEM_BLOCK)
    form = hmc_model.ModelForm(torch.ones(N, P), torch.ones(N), torch.ones(N), 0,
                               torch.tensor(0.0), [])
    ops = hmc_model.model_operands(form)
    assert ops.route == route
    assert ops.M.shape == ((rows, hmc_model.narrow_width(P)) if route == "narrow"
                           else (-(-N // 256) * 256, -(-P // 8) * 8 + 4))
    assert hmc_model.model_variant(0, True, P, N) == hmc_model.kernel_variant(
        0, True, P if route == "narrow" else 0)


def test_narrow_limit_is_at_least_sixteen():
    """The narrow route takes robust-10's P = 10 and every P up to its
    limit, 52 (at least 16), at N = 768, and up to P = 50 at N = 1,024
    (the rows of P = 51 and 52 pass a block's shared memory there); its
    rows' words are 4 mod 8 (distinct banks for 8 lanes on 8 consecutive
    rows) and hold M, y - offset and the scale."""
    assert hmc_model.NARROW_P_MAX == 52
    for P in range(1, hmc_model.NARROW_P_MAX + 1):
        assert hmc_model.model_plan(P, 4096, 768).route == "narrow"
        assert hmc_model.model_plan(P, 4096, 1024).route == ("narrow" if P <= 50 else "wide")
        w = hmc_model.narrow_width(P)
        assert w % 8 == 4 and P + 2 <= w < P + 2 + 8
    assert hmc_model.model_plan(hmc_model.NARROW_P_MAX + 1, 4096, 768).route == "wide"


def test_wide_route_keeps_the_first_designs_parameters():
    """The wide route takes every P the model route's first design took
    (up to 2,760 by a block's shared memory at 4 chains), one momentum tile
    a thread up to P = 2,048 and two above, each its own library, named
    by the shape and checked by the C entry."""
    assert hmc_model.model_p_max() >= 2760
    assert [hmc_model.wide_tiles(P) for P in (65, 2048, 2049, 2760)] == [1, 1, 2, 2]
    for P, tiles in ((2048, 1), (2049, 2), (2760, 2), (hmc_model.model_p_max(), 2)):
        plan = hmc_model.model_plan(P, 4096, 1024)
        assert (plan.route, plan.chains, plan.tiles) == ("wide", 4, tiles)
        assert hmc_model.model_variant(1, True, P, 1024) == hmc_model.kernel_variant(1, True, 0, tiles)
    assert dict(hmc_model.kernel_variant(0, False, 10))["HM_TILES"] == 1
    text = open(hmc_model.__file__[:-len("hmc_model.py")] + "csrc/hmc_model.cu").read()
    assert "constexpr int NT = HM_TILES;" in text
    assert "rows * chains > NT * TILE_VALUES || (NT == 2 && rows * chains <= TILE_VALUES)" in text


def test_model_smem_formula_is_the_kernels():
    """``_narrow_smem`` and ``_wide_smem`` are csrc/hmc_model.cu's
    ``narrow_smem`` and ``wide_smem``, term by term, and the constants they
    use are the kernel's."""
    src = (hmc_model.__file__[:-len("hmc_model.py")] + "csrc/hmc_model.cu")
    text = open(src).read()
    for name, value in (("THREADS", 256), ("STAGES", 3), ("TR", 8), ("RR", 4),
                        ("CHAIN_WORDS", 13), ("TILE_VALUES", 8192), ("NARROW_ROWS", 32)):
        assert f"constexpr int {name} = {value};" in text
    assert (hmc_model.THREADS, hmc_model.STAGES, hmc_model.TILE_ROWS, hmc_model.RES_ROWS,
            hmc_model.CHAIN_WORDS, hmc_model.TILE_VALUES, hmc_model.NARROW_ROWS) == (
        256, 3, 8, 4, 13, 8192, 32)
    assert "constexpr size_t SMEM_BLOCK = 232448;" in text
    # narrow: the resident rows, the four per-variable words (P rounded up to 8)
    assert "4 * (size_t(rows) * narrow_width(p) + 4 * size_t((p + 7) / 8 * 8))" in text
    assert "return (p + 5) / 4 * 4 % 8 == 0 ? (p + 5) / 4 * 4 + 4 : (p + 5) / 4 * 4;" in text
    # the narrow route's blocks an SM by its registers
    assert "constexpr int NARROW_BLOCKS_SM = NP <= 16 ? 2 : 1;" in text
    assert [hmc_model.narrow_blocks_sm(P) for P in (1, 16, 17, 40)] == [2, 2, 1, 1]
    # wide: the ring, the positions, psi's two buffers, the groups' sums, the
    # owners' partial sums, vred and the chains' words (the per-variable
    # words are read through L1)
    wide = text[text.index("size_t wide_smem("):]
    wide = wide[:wide.index("return 4 * words;")]
    for term in ("size_t(STAGES) * slab * (rows + 4)", "size_t(rows) * chains",
                 "2 * size_t(slab) * chains", "(ga > 1 ? size_t(ga) * slab * chains : 0)",
                 "(gc > 1 ? size_t(gc - 1) * rows * chains : 0)",
                 "3 * size_t(rows / TR) * chains", "4 * size_t(THREADS)",
                 "CHAIN_WORDS * size_t(chains)"):
        assert term in wide
    assert "4 * size_t(rows)" not in wide
    assert hmc_model._wide_smem(256, 32, 32, 4, 1) == 4 * (
        3 * 32 * 260 + 256 * 32 + 2 * 32 * 32 + 4 * 32 * 32 + 3 * 32 * 32 + 4 * 256 + 13 * 32)
    assert hmc_model._narrow_smem(1024, 10) == 4 * (1024 * 12 + 4 * 16)


@pytest.mark.parametrize("route", ["narrow", "wide"])
@pytest.mark.parametrize("diag", [False, True])
def test_model_operands_are_the_form_zero_padded(diag, route):
    """M zero padded to the route's rows and words, y - offset and the
    scale in the words after P (narrow) or after P rounded up to 8 (wide:
    the ring rows' padding); the inverse mass (ones for unit mass), the
    prior's kind, a and b per variable and the whole normalisation in
    ``vec``."""
    N = 37 if route == "narrow" else 5000
    post, jpost, M, offset, truth = _posteriors("gaussian", "gauss+exp", 5, N=N, seed=14)
    form = hmc_model.model_form(post)
    im = torch.linspace(0.5, 2.0, 5) if diag else None
    ops = hmc_model.model_operands(form, im)
    assert ops.route == route and ops.M.dtype == torch.float32 and ops.unit == (not diag)
    at = 5 if route == "narrow" else 8
    assert ops.M.shape == ((64, 12) if route == "narrow" else (-(-N // 256) * 256, 12))
    torch.testing.assert_close(ops.M[:N, :5], form.M.float())
    torch.testing.assert_close(ops.M[:N, at], form.yo.float())
    torch.testing.assert_close(ops.M[:N, at + 1], form.w.float())
    assert not ops.M[N:].any() and not ops.M[:, 5:at].any() and not ops.M[:, at + 2:].any()
    rows = 8
    torch.testing.assert_close(ops.vec[:5], im.float() if diag else torch.ones(5, dtype=torch.float32))
    assert ops.vec[:rows][5:].eq(1.0).all()
    assert ops.vec[rows:2 * rows].tolist() == [1.0, 1.0, 1.0, 2.0, 2.0, 0.0, 0.0, 0.0]
    lik, (g, e) = post.likelihood, post.prior.components
    np.testing.assert_allclose(ops.vec[2 * rows:2 * rows + 5].numpy(),
                               np.r_[g.mean.numpy(), e.lam.numpy()], rtol=1e-7)
    np.testing.assert_allclose(ops.vec[3 * rows:3 * rows + 3].numpy(), g.inv_sigma.numpy(),
                               rtol=1e-7)
    norm = float(lik.normalisation + g.normalisation + e.normalisation)
    np.testing.assert_allclose(float(ops.vec[4 * rows]), norm, rtol=1e-6)


def test_launch_wrapper_rejects_float64_and_cpu():
    """The kernel wrapper never casts: float64 operands raise, and a CPU
    tensor never reaches the CUDA library."""
    post, _, M, offset, truth = _posteriors("gaussian", "none", 3, seed=15)
    form = hmc_model.model_form(post)
    theta, eps, draws = _state(3, 8, 2, 1, truth, "none")
    t = torch.as_tensor(theta)
    e = AdaptiveScale(*(torch.as_tensor(eps[k]) for k in AdaptiveScale._fields))
    args = (t, form.value_cols(t), e, torch.ones(8), *(torch.as_tensor(draws[k]) for k in ("z", "us", "ua")))
    kw = dict(form=form, steps=5, inv_mass_diag=None, store=False,
              operands=hmc_model.model_operands(form))
    with pytest.raises(TypeError, match="float64"):
        hmc_model._launch_model_chunk(*args, **kw)
    f32 = lambda x: x.float() if x.is_floating_point() else x
    args32 = (f32(args[0]), f32(args[1]), AdaptiveScale(*map(f32, e)), *map(f32, args[3:]))
    with pytest.raises(ValueError, match="CUDA"):
        hmc_model._launch_model_chunk(*args32, **kw)


def test_form_to_float32_keeps_the_posterior():
    post, _, M, offset, truth = _posteriors("logistic", "gauss+unif", 4, seed=16)
    form = hmc_model.model_form(post)
    f32 = form.to(torch.float32)
    assert f32.M.dtype == torch.float32 and f32.priors[0][1].dtype == torch.long
    t = torch.as_tensor(_points("gauss+unif", truth, 8, seed=17))
    v32, v64 = f32.value_cols(t.float()).numpy(), form.value_cols(t).numpy()
    inside = v64 > -1e100
    assert inside[1::4].all() and not inside[::4].any()
    assert np.isneginf(v32[~inside]).all()  # -1e100 is -inf in float32
    np.testing.assert_allclose(v32[inside], v64[inside], rtol=1e-5)
