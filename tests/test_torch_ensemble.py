"""The ensemble sampler of the PyTorch port (inference_tpu_torch/mcmc/
_kernels/ensemble.py, mcmc/ensemble.py, ChainArray's "ensemble" kind)
against the JAX package's, on the CPU: the batched stretch-move step on the
JAX kernel's own draws (replayed from its keys here with jax.random) to
1e-12 in float64, under both retry settings, with and without bounds;
EnsembleSampler's views, validation and checkpoints both ways; ChainArray's
ensemble kind by statistics, its checks and checkpoints; and the
covariance: retry=False recovers it, while the default retry=True (the
reference's update, kept for parity) shrinks it."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from inference_tpu.mcmc import EnsembleSampler as JaxEnsemble
from inference_tpu.mcmc._kernels import ensemble as je
from inference_tpu.parallel import ChainArray as JaxChainArray
from inference_tpu.utils import Bounds as JaxBounds
from inference_tpu_torch import convert
from inference_tpu_torch.mcmc import EnsembleSampler
from inference_tpu_torch.mcmc._kernels import ensemble as ens
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.parallel._kinds import build_kind, positions_of, with_positions
from inference_tpu_torch.utils import Bounds

P = 3
MU = np.array([0.4, -0.3, 0.8])
COV = np.array([[1.0, 0.5, 0.2], [0.5, 2.0, -0.3], [0.2, -0.3, 0.7]])
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


def logp_jax(t):
    d = t - jnp.asarray(MU)
    return -0.5 * d @ jnp.asarray(ICOV) @ d


def logp_torch(t):
    d = t - torch.as_tensor(MU)
    return -0.5 * d @ torch.as_tensor(ICOV) @ d


def rosen_jax(t):
    return -((1 - t[0]) ** 2) - 10 * (t[1] - t[0] ** 2) ** 2


def rosen_torch(t):
    return -((1 - t[0]) ** 2) - 10 * (t[1] - t[0] ** 2) ** 2


@functools.lru_cache(maxsize=None)
def _draw_fn(A, h, n_anchor):
    def one(key):
        def body(k, _):
            k, kj, kz, ku = jax.random.split(k, 4)
            return k, (jax.random.randint(kj, (h,), 0, n_anchor),
                       jax.random.uniform(kz, (h,), jnp.float64),
                       jax.random.uniform(ku, (h,), jnp.float64))

        return lax.scan(body, key, None, length=A)[1]

    return jax.jit(jax.vmap(one))


def _jax_draws(keys, W, A):
    """The draws the JAX step takes from each ensemble's key, in its order:
    ``split(key, 3)`` for the two halves, then ``split(k, 4)`` for every
    attempt; per half (j, u_stretch, u_accept), each (A, C, h)."""
    half = W // 2
    subs = jax.vmap(lambda k: jax.random.split(k, 3))(keys)  # (C, 3, 2)
    out = []
    for idx, (h, n_anchor) in ((1, (half, W - half)), (2, (W - half, half))):
        draws = _draw_fn(A, h, n_anchor)(subs[:, idx])
        out.append(tuple(torch.tensor(np.moveaxis(np.asarray(d), 0, 1)) for d in draws))
    return out


@pytest.mark.parametrize("retry", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
def test_step_matches_jax_on_its_draws(retry, bounded):
    """Four iterations of C = 3 ensembles of W = 11 walkers (halves of 5
    and 6) at P = 3 and inverse temperatures 1, 0.5, 0.25, from the JAX
    kernel's own draws, give its walkers, logps, proposal counts and
    failures to 1e-12; with bounds every walker stays inside."""
    C, W, A = 3, 11, 100
    rng = np.random.default_rng(5 + retry + 2 * bounded)
    walkers = MU + rng.normal(0, 0.6, (C, W, P))
    inv_t = np.array([1.0, 0.5, 0.25])
    jb = JaxBounds([-1.0, -2.0, -0.5], [2.0, 1.5, 2.0]) if bounded else None
    pb = Bounds([-1.0, -2.0, -0.5], [2.0, 1.5, 2.0]) if bounded else None
    if bounded:
        walkers = np.asarray(pb.reflect(torch.as_tensor(walkers)))
    logps = np.array([[float(logp_jax(jnp.asarray(w))) for w in e] for e in walkers])
    logps = logps * inv_t[:, None]
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    jstate = jax.vmap(je.init_ensemble_state)(jnp.asarray(walkers), jnp.asarray(logps), keys,
                                              jnp.asarray(inv_t))
    pstate = ens.init_ensemble_state(torch.as_tensor(walkers), torch.as_tensor(logps))
    pstate = pstate._replace(inv_temp=torch.as_tensor(inv_t))
    jstep = jax.jit(jax.vmap(je.make_ensemble_step(
        logp_jax, n_walkers=W, bounds_reflect=jb and jb.reflect, retry=retry)))
    pstep = ens.make_ensemble_step(torch.func.vmap(logp_torch), n_walkers=W,
                                   bounds_reflect=pb and pb.reflect, retry=retry)
    for _ in range(4):
        draws = _jax_draws(jstate.key, W, A)
        pstate, pout = pstep(pstate, None, draws)
        jstate, jout = jstep(jstate)
        for got, want in ((pstate.walkers, jstate.walkers), (pstate.logps, jstate.logps),
                          (pout.walkers, jout.walkers)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(pout.attempts.numpy(), np.asarray(jout.attempts))
        np.testing.assert_array_equal(pout.failures.numpy(), np.asarray(jout.failures))
    if retry:
        assert pout.attempts.max() > 1
    else:
        assert (pout.attempts == 1).all()
    if bounded:
        w = pstate.walkers.numpy()
        assert (w >= pb.lower).all() and (w <= pb.upper).all()


def test_retry_exhaustion_and_short_streams():
    """A walker whose every move is refused stops at max_attempts and
    counts as a failure; an injected stream shorter than the attempts
    raises."""
    C, W = 1, 8
    state = ens.init_ensemble_state(torch.zeros(C, W, 1) + torch.arange(W)[None, :, None],
                                    torch.zeros(C, W))
    never = lambda t: torch.full(t.shape[:1], -1e300)
    step = ens.make_ensemble_step(never, n_walkers=W, max_attempts=3, retry=True)
    _, out = step(state, torch.Generator().manual_seed(0))
    assert out.attempts.tolist() == [[3] * W] and out.failures.tolist() == [W]
    one = (torch.zeros(1, C, 4, dtype=torch.long), torch.full((1, C, 4), 0.5),
           torch.ones(1, C, 4))
    with pytest.raises(ValueError, match="ran out"):
        step(state, None, (one, one))


# --------------------------------------------------------------------- #
# EnsembleSampler
# --------------------------------------------------------------------- #
def _pair(n_walkers=20, iterations=30, seed=9, **kw):
    starts = np.random.default_rng(seed).normal(0.1, 0.3, size=(n_walkers, 2))
    port = EnsembleSampler(rosen_torch, starts, display_progress=False, seed=seed,
                           device="cpu", **kw)
    ref = JaxEnsemble(rosen_jax, starts, display_progress=False, seed=seed, **kw)
    port.advance(iterations)
    ref.advance(iterations)
    return port, ref


def test_sampler_views():
    """The views of tests/mcmc/test_ensemble.py on the port, with the JAX
    sampler's shapes; the properties convert to mutable numpy and take
    setters; the proposal counts are drained lazily; plot_diagnostics names
    A14."""
    port, ref = _pair()
    n = 20 * 30
    assert port.chain_length == ref.chain_length == n and port.n_iterations == 30
    assert port.get_sample().shape == ref.get_sample().shape == (n, 2)
    assert port.get_probabilities().shape == (n,)
    for burn, thin in [(0, 1), (100, 3), (500, 7)]:
        assert port.get_sample(burn, thin).shape == ref.get_sample(burn, thin).shape
        assert port.get_parameter(1, burn, thin).shape == ref.get_parameter(1, burn, thin).shape
    np.testing.assert_array_equal(port.get_sample()[-20:], port.walker_positions)
    np.testing.assert_array_equal(port.get_probabilities()[-20:], port.walker_probs)
    np.testing.assert_allclose(port.walker_probs,
                               [float(rosen_torch(torch.as_tensor(w))) for w in port.walker_positions],
                               rtol=1e-12)
    assert port.mode().shape == (2,) and port.get_probabilities().max() == rosen_torch(
        torch.as_tensor(port.mode()))
    live = port._state.walkers.clone()
    port.walker_positions[0, 0] = 7.0  # mutable numpy, not a view of the state
    assert port.walker_positions[0, 0] == 7.0 and torch.equal(port._state.walkers, live)
    port.sample = None
    assert port.sample is None
    port._drain_stats()
    assert [len(v) for v in port.total_proposals] == [30] * 20
    assert port.failed_updates == [0] * 30
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    port.plot_diagnostics()  # Agg: draws, shows nothing
    assert len(plt.gcf().axes) == 2
    plt.close("all")


def test_sampler_validation():
    """The start checks, the alpha check and the n_walkers warning of the
    JAX sampler, with its messages; bounds keep every sample inside."""
    rosen = rosen_torch
    kw = dict(display_progress=False, device="cpu")
    bad = [np.zeros([2, 2]) + [[1, 2], [3, 4]], np.ones([10, 1]),
           np.stack([np.arange(10.0), 2 * np.arange(10.0)], axis=1), [[1.0, 2.0]] * 10]
    nonfinite = np.random.default_rng(0).normal(size=(10, 2))
    nonfinite[0, 0] = np.nan
    for starts in bad + [nonfinite]:
        with pytest.raises(ValueError, match="EnsembleSampler error"):
            EnsembleSampler(rosen, starting_positions=starts, **kw)
    with pytest.raises(ValueError, match="'alpha'"):
        EnsembleSampler(rosen, np.random.default_rng(0).normal(size=(10, 2)), alpha=0.5, **kw)
    with pytest.warns(UserWarning, match="n_walkers >= 2"):
        EnsembleSampler(rosen, np.random.default_rng(0).normal(size=(5, 2)), **kw)
    starts = np.random.default_rng(5).uniform(0.3, 0.7, size=(10, 2))
    es = EnsembleSampler(rosen, starts, bounds=(np.zeros(2), np.ones(2)), seed=5, **kw)
    es.advance(50)
    s = es.get_sample()
    assert (s >= 0).all() and (s <= 1).all()


def test_save_load_both_ways(tmp_path):
    """A checkpoint of either package loads in the other with the same
    walkers, history and counts, and continues; the JAX sampler crosses by
    convert with its retry setting and inverse temperature."""
    port, ref = _pair(15, 40, retry=False)
    for src, dst_cls, name in ((port, JaxEnsemble, "port.npz"), (ref, EnsembleSampler, "jax.npz")):
        f = str(tmp_path / name)
        src.save(f)
        kw = {} if dst_cls is JaxEnsemble else dict(device="cpu")
        post = rosen_jax if dst_cls is JaxEnsemble else rosen_torch
        loaded = dst_cls.load(f, posterior=post, **kw)
        assert loaded.n_walkers == 15 and loaded.n_iterations == 40
        np.testing.assert_array_equal(loaded.get_sample(), src.get_sample())
        np.testing.assert_array_equal(loaded.walker_positions, src.walker_positions)
        np.testing.assert_array_equal(np.array(loaded.total_proposals),
                                      np.array(src.total_proposals))
        loaded.advance(10)
        assert loaded.n_iterations == 50 and np.isfinite(loaded.get_sample()).all()
    moved = convert.ensemble_sampler_from_jax(ref, rosen_torch, seed=1, device="cpu")
    assert moved.retry is False and float(moved._state.inv_temp) == 1.0
    np.testing.assert_array_equal(moved.get_probabilities(), ref.get_probabilities())
    moved.advance(5)
    assert moved.chain_length == 15 * 45


def test_statistics_of_the_default_update():
    """tests/mcmc/test_ensemble.py::test_ensemble_statistics on the port:
    the default retry=True update's mean on a Gaussian at 2."""
    starts = np.random.default_rng(3).normal(2.0, 0.5, size=(40, 2))
    es = EnsembleSampler(lambda t: -0.5 * ((t - 2.0) ** 2).sum(), starts, display_progress=False,
                         seed=3, device="cpu")
    es.advance(800)
    assert np.allclose(es.get_sample(burn=8000).mean(0), 2.0, atol=0.1)


def test_retry_false_recovers_the_covariance():
    """32 walkers on the correlated 3-D Gaussian, 2,000 iterations after
    none of burn-in to speak of (500 dropped): retry=False gives the true
    variances within 10% and means within 0.1 sd; the default retry=True
    gives them below the truth, 0.97 of it on average (the
    repeat-until-accept update's shrink: about 0.9 here in 3-D, 0.4 at 10
    dimensions)."""
    starts = MU + np.random.default_rng(0).normal(0, 0.5, (32, P))
    var = {}
    for retry in (False, True):
        es = EnsembleSampler(logp_torch, starts, display_progress=False, seed=0, retry=retry,
                             device="cpu")
        es.advance(2000 if not retry else 1200)
        s = es.get_sample(burn=500 * 32)
        var[retry] = np.diag(np.cov(s.T)) / np.diag(COV)
        if not retry:
            assert (np.abs(s.mean(0) - MU) / np.sqrt(np.diag(COV))).max() < 0.1
    np.testing.assert_allclose(var[False], 1.0, rtol=0.1)
    assert var[True].mean() < 0.97


# --------------------------------------------------------------------- #
# ChainArray("ensemble")
# --------------------------------------------------------------------- #
def test_chain_array_statistics_match_jax():
    """8 chains of 16 walkers on the correlated 3-D Gaussian with
    retry=False: the pooled means and variances of both packages within
    sampling error of the truth and of each other; the diagnostics count
    every walker as a replicate chain."""
    starts = MU + np.random.default_rng(4).normal(0, 0.5, (8, 16, P))
    port = ChainArray("ensemble", logp_torch, starts, retry=False, seed=5, device="cpu")
    ref = JaxChainArray("ensemble", logp_jax, starts, retry=False, seed=5)
    for ca in (port, ref):
        ca.advance(600)
    sp, sj = port.get_sample(burn=200), ref.get_sample(burn=200)
    assert sp.shape == sj.shape == (400 * 8 * 16, P)
    sd = np.sqrt(np.diag(COV))
    for s in (sp, sj):
        assert (np.abs(s.mean(0) - MU) / sd).max() < 0.15
        np.testing.assert_allclose(s.var(0), np.diag(COV), rtol=0.15)
    np.testing.assert_allclose(sp.var(0), sj.var(0), rtol=0.2)
    rhat, jax_rhat = port.rhat(burn=200), ref.rhat(burn=200)
    assert rhat.shape == jax_rhat.shape == (P,)
    # 128 walkers of 400 slowly mixing steps each: about 1.1 in both packages
    assert rhat.max() < 1.2 and np.abs(rhat - jax_rhat).max() < 0.05
    assert port.effective_sample_size().shape == (8, 16, P)
    assert port.theta.shape == (8, 16, P) and port.logp.shape == (8, 16)
    np.testing.assert_allclose(port.logp, [[float(logp_torch(torch.as_tensor(w))) for w in c]
                                           for c in port.theta], rtol=1e-12)


def test_chain_array_checks_and_checkpoints(tmp_path):
    """The n_walkers checks of the JAX kind and its starts' shape; a
    checkpoint of either package restores in the other."""
    with pytest.raises(ValueError, match="requires starts of shape"):
        ChainArray("ensemble", logp_torch, np.zeros((4, P)), device="cpu")
    with pytest.raises(ValueError, match=r"n_walkers >= 2 \* \(n_parameters \+ 1\) = 8"):
        ChainArray("ensemble", logp_torch, np.random.default_rng(0).normal(size=(2, 6, P)),
                   device="cpu")
    with pytest.raises(ValueError, match="requires n_walkers"):
        build_kind("ensemble", logp_torch, P, torch.float64, "cpu")
    starts = MU + np.random.default_rng(1).normal(0, 0.5, (3, 10, P))
    port = ChainArray("ensemble", logp_torch, starts, retry=True, seed=2, device="cpu")
    ref = JaxChainArray("ensemble", logp_jax, starts, retry=True, seed=2)
    port.advance(5)
    ref.advance(5)
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    ref.restore(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(ref.theta, port.theta)
    port2 = ChainArray("ensemble", logp_torch, starts, seed=3, device="cpu")
    port2.restore(str(tmp_path / "jax.npz"))
    ref2 = JaxChainArray("ensemble", logp_jax, starts, seed=3)
    ref2.restore(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(port2.theta, ref2.theta)
    np.testing.assert_allclose(port2.logp, ref2.logp, rtol=1e-12)
    port2.advance(3)
    assert np.isfinite(port2.theta).all()
    moved = with_positions(port2._state, *(2 * x for x in positions_of(port2._state)))
    assert torch.equal(positions_of(moved)[0], 2 * port2._state.walkers)
    assert torch.equal(moved.logps, 2 * port2._state.logps)
