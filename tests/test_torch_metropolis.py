"""The batched Metropolis, Gibbs and PCA transitions of the PyTorch port
(inference_tpu_torch/mcmc/_kernels/metropolis.py, parallel/_kinds.py,
ChainArray's gibbs, metropolis and pca kinds) against the JAX package's:
each step on the JAX kernel's own draws (replayed from its keys here with
jax.random) to 1e-12 in float64, under both retry settings, with
non-negative and reflecting modes and with PCA bounds; ChainArray by
statistics; update_directions on one history; checkpoints both ways."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from inference_tpu.mcmc._kernels import metropolis as jm
from inference_tpu.parallel import ChainArray as JaxChainArray
from inference_tpu.utils import Bounds as JaxBounds
from inference_tpu_torch import convert
from inference_tpu_torch.mcmc._kernels import metropolis as met
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.parallel._kinds import build_proposal_modes
from inference_tpu_torch.utils import Bounds

P, K = 3, 12
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


@functools.lru_cache(maxsize=None)
def _draw_fn(T, event):
    def one(key):
        def body(k, _):
            k, kp, ka = jax.random.split(k, 3)
            return k, (jax.random.normal(kp, event, jnp.float64),
                       jax.random.uniform(ka, dtype=jnp.float64))

        return lax.scan(body, jax.random.split(key)[1], None, length=T)[1]

    return jax.jit(jax.vmap(one))


def _jax_draws(keys, T, event):
    """The draws the JAX step takes from each chain's key, in its order:
    ``split(key)``, then ``split(k, 3)`` for every try; normals (T, K,
    *event) and uniforms (T, K)."""
    z, u = _draw_fn(T, event)(keys)
    return torch.tensor(np.moveaxis(np.asarray(z), 0, 1)), torch.tensor(np.asarray(u).T)


def _start(seed, kind):
    """K chains' positions, adaptation states part way to their checks, try
    counts some of which pass MAX_TRIES within a step, and (pca) random
    orthonormal directions, as JAX states and their leaves."""
    rng = np.random.default_rng(seed)
    theta = MU + rng.normal(0, 0.8, (K, P))
    theta[:, 0] = np.abs(theta[:, 0])
    theta[:, 2] = np.clip(theta[:, 2], -0.9, 1.4)
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    state = jax.vmap(jm.init_metropolis_state, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(theta), jax.vmap(logp_jax)(jnp.asarray(theta)),
        jnp.asarray(rng.uniform(0.3, 1.5, (K, P))), keys, 1.0)
    num = rng.integers(90, 100, (K, P)).astype(np.int32)
    widths = state.widths._replace(
        avg=jnp.asarray(num * rng.uniform(0.1, 0.9, (K, P))),
        var=jnp.asarray(num * rng.uniform(0.05, 0.25, (K, P))),
        num=jnp.asarray(num), chk_int=jnp.asarray(rng.choice([100, 170], (K, P)).astype(np.int32)))
    state = state._replace(widths=widths,
                           try_count=jnp.asarray(rng.integers(0, 60, (K, P)).astype(np.int32)),
                           inv_temp=jnp.asarray(rng.choice([1.0, 0.5], K)))
    state = state._replace(logp=jax.vmap(logp_jax)(state.theta) * state.inv_temp)
    if kind == "pca":
        dirs = np.linalg.qr(rng.normal(size=(K, P, P)))[0]
        state = jm.PcaState(*state, directions=jnp.asarray(dirs))
    return state


def _assert_states_equal(port, ref):
    leaves = convert.metropolis_state_to_jax_leaves(port, np.zeros((K, 2), np.uint32))
    for i, (got, want) in enumerate(zip(leaves, jax.tree.leaves(ref))):
        if i == 8:  # the key leaf
            continue
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, i
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300, err_msg=f"leaf {i}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"leaf {i}")


def _steps(kind, retry, modes_on):
    """The port's and the JAX package's step for one kind."""
    nn = [True, False, False] if modes_on else None
    bnd = (np.array([-5.0, -5.0, -1.0]), np.array([5.0, 5.0, 1.5])) if modes_on else None
    if kind == "pca":
        jb = JaxBounds([-1.0, -2.5, -1.0], [3.0, 2.5, 1.5]) if modes_on else None
        pb = Bounds([-1.0, -2.5, -1.0], [3.0, 2.5, 1.5]) if modes_on else None
        jstep = jm.make_pca_step(logp_jax, bounds_reflect=jb and jb.reflect, retry=retry)
        pstep = met.make_pca_step(torch.func.vmap(logp_torch),
                                  bounds_reflect=pb and pb.reflect, retry=retry)
        return jstep, pstep
    from inference_tpu.parallel._kinds import build_proposal_modes as jax_modes

    jfac = jm.make_gibbs_step if kind == "gibbs" else jm.make_metropolis_step
    pfac = met.make_gibbs_step if kind == "gibbs" else met.make_metropolis_step
    # every parameter bounded or non-negative at once is refused; split them
    jmodes = jax_modes(P, jnp.float64, nn, None)
    pmodes = build_proposal_modes(P, torch.float64, "cpu", nn, None)
    if modes_on:
        bounded = np.array([False, False, True])
        jmodes = jmodes._replace(bounded=jnp.asarray(bounded), lower=jnp.asarray(bnd[0]),
                                 upper=jnp.asarray(bnd[1]))
        pmodes = pmodes._replace(bounded=torch.as_tensor(bounded), lower=torch.as_tensor(bnd[0]),
                                 upper=torch.as_tensor(bnd[1]))
    return jfac(logp_jax, jmodes, retry=retry), pfac(torch.func.vmap(logp_torch), pmodes, retry=retry)


@pytest.mark.parametrize("kind", ["gibbs", "metropolis", "pca"])
@pytest.mark.parametrize("retry", [False, True])
@pytest.mark.parametrize("modes_on", [False, True])
def test_step_matches_jax_on_its_draws(kind, retry, modes_on):
    """Five steps of K = 12 chains at P = 3 from the JAX kernel's own draws
    give the JAX step's positions, log-probabilities, widths, adaptation
    counters and try counts to 1e-12 relative; some chains start past
    MAX_TRIES and some at their check interval, so the cut and the width
    adjustments both run."""
    jstate = _start(11 + retry + 2 * modes_on, kind)
    pstate = convert.metropolis_state_from_jax(jax.tree.leaves(jstate), device="cpu")
    jstep, pstep = _steps(kind, retry, modes_on)
    jstep = jax.jit(jax.vmap(jstep))
    tries_per_step = (P if kind != "metropolis" else 1) if not retry else 400
    event = (P,) if kind == "metropolis" else ()
    widths0 = pstate.widths.value.clone()
    for _ in range(5):
        z, u = _jax_draws(jstate.key, tries_per_step, event)
        pstate, pout = pstep(pstate, None, z, u)
        jstate, jout = jstep(jstate)
        _assert_states_equal(pstate, jstate)
        np.testing.assert_allclose(pout.sigmas.numpy(), np.asarray(jout.sigmas), rtol=1e-12)
        np.testing.assert_allclose(pout.theta.numpy(), np.asarray(jout.theta), rtol=1e-12)
    assert not torch.equal(pstate.widths.value, widths0)  # cut or adjusted


def test_injected_streams_too_short_raise():
    jstate = _start(3, "gibbs")
    pstate = convert.metropolis_state_from_jax(jax.tree.leaves(jstate), device="cpu")
    _, pstep = _steps("gibbs", True, False)
    # one try's draws, far downhill and never taken: the second try runs out
    with pytest.raises(ValueError, match="ran out"):
        pstep(pstate, None, torch.full((1, K), 50.0), torch.ones(1, K))


def test_apply_modes_matches_jax():
    """Non-negative folding and the floored reflection of the JAX package
    on proposals far outside the bounds, both signs."""
    x = np.random.default_rng(0).normal(0, 20, (64, 3))
    nn, bounded = [True, False, False], [False, False, True]
    lo, up = np.array([0, 0, -1.0]), np.array([1, 1, 1.5])
    jmodes = jm.ProposalModes(jnp.asarray(nn), jnp.asarray(bounded), jnp.asarray(lo), jnp.asarray(up))
    pmodes = met.ProposalModes(torch.as_tensor(nn), torch.as_tensor(bounded), torch.as_tensor(lo),
                               torch.as_tensor(up))
    want = np.asarray(jm._apply_modes(jnp.asarray(x), None, jmodes))
    np.testing.assert_array_equal(met._apply_modes(torch.as_tensor(x), pmodes).numpy(), want)
    for i in range(3):
        got = met._apply_modes(torch.as_tensor(x[:, i]), pmodes, i).numpy()
        np.testing.assert_array_equal(got, want[:, i])


# --------------------------------------------------------------------- #
# ChainArray against the JAX ChainArray
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind, retry", [("gibbs", True), ("metropolis", False), ("pca", False)])
def test_chain_array_statistics_match_jax(kind, retry):
    """64 chains on the correlated 3-D Gaussian: the pooled means and
    variances of both packages within sampling error of the truth and of
    each other."""
    starts = MU + np.random.default_rng(4).normal(0, 1, (64, P))
    kw = dict(widths=1.0, retry=retry, seed=5)
    port = ChainArray(kind, logp_torch, starts, device="cpu", **kw)
    ref = JaxChainArray(kind, logp_jax, starts, **kw)
    n, burn = (300, 100) if kind != "metropolis" else (600, 200)
    for ca in (port, ref):
        ca.advance(n // 2)
        if kind == "pca":
            ca.update_directions()
        ca.advance(n // 2)
    sp, sj = port.get_sample(burn=burn), ref.get_sample(burn=burn)
    assert sp.shape == sj.shape == ((n - burn) * 64, P)
    sd = np.sqrt(np.diag(COV))
    for s in (sp, sj):
        assert (np.abs(s.mean(0) - MU) / sd).max() < 0.15
        np.testing.assert_allclose(s.var(0), np.diag(COV), rtol=0.2)
    np.testing.assert_allclose(sp.var(0), sj.var(0), rtol=0.25)
    assert port.rhat(burn=burn).max() < 1.1
    assert port.theta.shape == (64, P) and port.logp.shape == (64,)


def test_chain_array_widths_and_modes():
    """Per-chain initial widths are 5% of each start (1 where it is 0);
    non-negative and reflecting proposals keep the chains inside; the
    validation messages are the JAX package's."""
    starts = np.array([[0.0, 2.0, -4.0], [1.0, 0.0, 0.5]])
    ca = ChainArray("gibbs", logp_torch, starts, device="cpu", seed=0)
    np.testing.assert_array_equal(ca._state.widths.value.numpy(),
                                  np.where(starts != 0, np.abs(starts) * 0.05, 1.0))
    ca = ChainArray("metropolis", logp_torch, np.abs(starts) + 0.1, non_negative=True,
                    device="cpu", seed=0, widths=[1.0, 2.0, 3.0])
    np.testing.assert_array_equal(ca._state.widths.value.numpy(), [[1.0, 2.0, 3.0]] * 2)
    ca.advance(50)
    assert (ca.get_sample() >= 0).all()
    ca = ChainArray("gibbs", logp_torch, np.zeros((4, P)) + 0.5, device="cpu", seed=0,
                    boundaries=([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]))
    ca.advance(50)
    s = ca.get_sample()
    assert (s >= 0).all() and (s <= 1).all()
    with pytest.raises(ValueError, match="upper bounds must exceed"):
        ChainArray("gibbs", logp_torch, starts, device="cpu", boundaries=([0, 0, 1], [1, 1, 1]))
    with pytest.raises(ValueError, match="both non-negative and reflecting"):
        ChainArray("gibbs", logp_torch, starts, device="cpu", non_negative=True,
                   boundaries=([0, 0, 0], [1, 1, 1]))
    for call in (lambda: ca.warmup(10), lambda: ca.set_inverse_mass(1.0)):
        with pytest.raises(ValueError, match="'hmc' and 'nuts' kinds only"):
            call()
    with pytest.raises(ValueError, match="only available for kind='pca'"):
        ca.update_directions()


def test_update_directions_match_jax():
    """On the same stored history the batched eigh gives the JAX
    directions up to sign to 1e-10; below max(2P, 3) steps nothing
    changes; ``last`` takes the latest steps."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(8, P, P))
    hist = [np.einsum("kpq,skq->skp", A, rng.normal(size=(40, 8, P)))]
    starts = rng.normal(size=(8, P))
    port = ChainArray("pca", logp_torch, starts, device="cpu", seed=0)
    ref = JaxChainArray("pca", logp_jax, starts, seed=0)
    for last in (None, 25):
        port._history, ref._history = list(hist), list(hist)
        port.update_directions(last), ref.update_directions(last)
        got = port._state.directions.numpy()
        want = np.asarray(ref._state.directions)
        signs = np.sign(np.einsum("kpi,kpi->ki", got, want))[:, None, :]
        np.testing.assert_allclose(got * signs, want, rtol=0, atol=1e-10)
    port._history = [hist[0][:5]]
    before = port._state.directions.clone()
    port.update_directions()
    assert torch.equal(port._state.directions, before)


@pytest.mark.parametrize("kind", ["gibbs", "pca"])
def test_checkpoints_cross_both_ways(kind, tmp_path):
    """A JAX ChainArray checkpoint restores into the port and continues, and
    the port's restores into the JAX ChainArray: every leaf but the key
    equal."""
    starts = MU + np.random.default_rng(2).normal(0, 1, (16, P))
    ref = JaxChainArray(kind, logp_jax, starts, seed=1, retry=False)
    ref.advance(20, store=False)
    ref.save(tmp_path / "jax.npz")
    port = ChainArray(kind, logp_torch, starts, seed=1, retry=False, device="cpu")
    port.restore(tmp_path / "jax.npz")
    _assert_states_equal_full(port._state, ref._state)
    port.advance(10)
    port.save(tmp_path / "port.npz")
    back = JaxChainArray(kind, logp_jax, starts, seed=3, retry=False)
    back.restore(tmp_path / "port.npz")
    _assert_states_equal_full(port._state, back._state)
    back.advance(5)
    with pytest.raises(ValueError, match="leaves"):
        _restore_other(kind, starts, tmp_path)


def _restore_other(kind, starts, tmp_path):
    """A checkpoint of one kind refused by a ChainArray of a kind whose
    state has another leaf count."""
    other = ChainArray("pca" if kind == "gibbs" else "gibbs", logp_torch, starts, device="cpu")
    np.savez(tmp_path / "other.npz", **{**dict(np.load(tmp_path / "port.npz")),
                                        "kind": other.kind})
    other.restore(tmp_path / "other.npz")


def _assert_states_equal_full(port, ref):
    leaves = convert.metropolis_state_to_jax_leaves(port, np.zeros((port.theta.shape[0], 2),
                                                                   np.uint32))
    ref_leaves = jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for i, (got, want) in enumerate(zip(leaves, ref_leaves)):
        if i != 8:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"leaf {i}")
