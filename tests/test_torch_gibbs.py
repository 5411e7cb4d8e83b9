"""The single-chain MetropolisChain, GibbsChain and PcaChain of the PyTorch
port (inference_tpu_torch/mcmc/gibbs.py, pca.py) against the JAX
package's: sample statistics, the width trace, the set_non_negative and
set_boundaries effects, PcaChain's direction-update schedule and bounds,
the history views, and .npz checkpoints that load in both directions."""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from inference_tpu.mcmc import GibbsChain as JaxGibbs
from inference_tpu.mcmc import MetropolisChain as JaxMetropolis
from inference_tpu.mcmc import PcaChain as JaxPca
from inference_tpu_torch import GibbsChain, MetropolisChain, PcaChain, convert

COV = np.array([[1.0, 0.6], [0.6, 2.0]])
ICOV = np.linalg.inv(COV)
START = np.array([0.5, 0.5])


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


def gauss_torch(t):
    return -0.5 * t @ torch.as_tensor(ICOV) @ t


def gauss_jax(t):
    return -0.5 * t @ jnp.asarray(ICOV) @ t


PAIRS = {"gibbs": (GibbsChain, JaxGibbs), "metropolis": (MetropolisChain, JaxMetropolis),
         "pca": (PcaChain, JaxPca)}


def _pair(kind, n=512, **kw):
    port_cls, jax_cls = PAIRS[kind]
    port = port_cls(gauss_torch, start=START, display_progress=False, seed=1, device="cpu", **kw)
    ref = jax_cls(gauss_jax, start=START, display_progress=False, seed=1, **kw)
    for chain in (port, ref):
        chain.advance(n)
    return port, ref


PCA_BOUNDS = ([-6.0, -8.0], [6.0, 8.0])


@pytest.fixture(scope="module")
def pca_pair():
    """One port and one JAX PcaChain with bounds, 512 steps (the JAX chain
    compiles a program for each chunk length between updates)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    pair = _pair("pca", widths=1.0, bounds=PCA_BOUNDS)
    torch.set_default_dtype(old)
    return pair


@pytest.mark.parametrize("kind", ["gibbs", "metropolis", "pca"])
def test_statistics_and_width_trace_match_jax(kind, request):
    """512 steps on the correlated 2-D Gaussian: both packages' means and
    variances within sampling error of the truth and of each other; the
    width trace starts at the initial widths at step 0, logs change points
    at increasing steps inside the chain, ends at the state's widths, and
    (gibbs, pca) moved in both packages."""
    port, ref = request.getfixturevalue("pca_pair") if kind == "pca" else _pair(kind, widths=1.0)
    burn = 100
    sp, sj = port.get_sample(burn=burn), ref.get_sample(burn=burn)
    assert sp.shape == sj.shape == (513 - burn, 2)
    sd = np.sqrt(np.diag(COV))
    tol = 0.45 if kind == "metropolis" else 0.3
    for s in (sp, sj):
        assert (np.abs(s.mean(0)) / sd).max() < tol
        np.testing.assert_allclose(s.var(0), np.diag(COV), rtol=2 * tol)
    for chain in (port, ref):
        chain.estimate_burn_in()  # drains the trace
        for i in range(2):
            vals, chks = chain.sigma_values[i], chain.sigma_checks[i]
            assert len(vals) == len(chks) and vals[0] == 1.0 and chks[0] == 0.0
            assert np.all(np.diff(chks) > 0) and chks[-1] <= chain.chain_length
            assert vals[-1] == chain._last_widths[i]
            if kind != "metropolis":
                assert len(vals) > 1
    np.testing.assert_allclose(port._state.widths.value.numpy()[0], port._last_widths)
    assert 0 <= port.estimate_burn_in() <= port.chain_length


def test_gibbs_constraints_and_views():
    """set_non_negative and set_boundaries rebuild the step and keep the
    samples inside, as in the JAX package; a bad flag or an empty interval
    warns and changes nothing; the history views slice as the JAX chain's."""
    chains = []
    for cls in (GibbsChain, JaxGibbs):
        kw = dict(device="cpu") if cls is GibbsChain else {}
        chain = cls(gauss_torch if cls is GibbsChain else gauss_jax, start=np.array([0.5, 0.2]),
                    widths=1.0, display_progress=False, seed=2, **kw)
        chain.set_non_negative(0)
        chain.set_boundaries(1, [-0.5, 0.5])
        with pytest.warns(UserWarning, match="boolean"):
            chain.set_non_negative(1, flag=1)
        with pytest.warns(UserWarning, match="greater"):
            chain.set_boundaries(0, [1.0, 0.0])
        chain.advance(256)
        s = chain.get_sample()
        assert (s[:, 0] >= 0).all() and (np.abs(s[:, 1]) <= 0.5).all()
        chain.set_boundaries(1, None, remove=True)
        chain.advance(256)
        assert np.abs(chain.get_parameter(1, burn=300)).max() > 0.5
        assert chain.get_parameter(0, burn=10, thin=3).shape == ((513 - 10 + 2) // 3,)
        assert chain.get_probabilities(burn=0).shape == (513,)
        mode = chain.mode()
        assert mode.shape == (2,) and chain.get_probabilities(0).max() == pytest.approx(
            chain._consolidated_probs().max())
        chain.replace_last(np.array([0.1, 0.1]))
        chain.replace_last_probability(-0.01)
        np.testing.assert_array_equal(chain.get_last(), [0.1, 0.1])
        assert chain.probs[-1] == -0.01
        chain.advance(4)
        chains.append(chain)
    np.testing.assert_allclose(chains[0].get_sample(300).var(0), chains[1].get_sample(300).var(0),
                               rtol=0.5)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    chains[0].plot_diagnostics()  # Agg: draws, shows nothing
    assert len(plt.gcf().axes) == 4
    plt.close("all")


def test_pca_schedule_bounds_and_disabled_constraints(pca_pair):
    """PcaChain updates its directions at 100, 250 and 475 steps as the JAX
    chain does, its directions orthonormal and its angle history one row an
    update; the samples lie in the bounds; set_non_negative and
    set_boundaries warn and change nothing."""
    port, ref = pca_pair
    bounds = PCA_BOUNDS
    for chain in (port, ref):
        assert list(chain.update_history) == [100, 250, 475]
        assert chain.next_update == 475 + 337 and chain.dir_update_interval == 337
        assert np.asarray(chain.angles_history).shape == (3, 2)
        V = chain.directions
        np.testing.assert_allclose(V.T @ V, np.eye(2), atol=1e-12)
        s = chain.get_sample(burn=0)
        assert (s >= bounds[0]).all() and (s <= bounds[1]).all()
    np.testing.assert_allclose(port._state.directions[0].numpy(), port.directions)
    for call in (lambda: port.set_non_negative(0), lambda: port.set_boundaries(0, [0, 1])):
        with pytest.warns(UserWarning, match="not available for PcaChain"):
            call()
    assert port._step is not None


def test_pca_update_directions_matches_jax_on_one_history():
    """The blended covariance and its eigenvectors from the same history
    equal the JAX chain's (up to sign) to 1e-10."""
    port, ref = _pair("pca", n=8, widths=1.0)
    theta = np.random.default_rng(3).multivariate_normal([0, 0], COV, 400)
    for chain in (port, ref):
        chain._theta_chunks = [theta]
        chain.chain_length, chain.last_update, chain.dir_update_interval = 400, 150, 150
        chain.covar = np.array([[2.0, 0.3], [0.3, 0.5]])
        chain.update_directions()
    np.testing.assert_allclose(port.covar, ref.covar, rtol=1e-12)
    signs = np.sign(np.sum(port.directions * ref.directions, axis=0))
    np.testing.assert_allclose(port.directions * signs, ref.directions, atol=1e-10)
    np.testing.assert_allclose(port.angles_history, ref.angles_history, atol=1e-10)


@pytest.mark.parametrize("kind", ["gibbs", "metropolis", "pca"])
def test_checkpoints_load_in_both_directions(kind, tmp_path):
    """A JAX chain's .npz loads into the port (and through convert) with its
    history, widths, adaptation, trace, modes and (pca) directions,
    schedule and bounds, and continues; the port's loads into the JAX
    package and continues there."""
    port_cls, jax_cls = PAIRS[kind]
    kw = dict(bounds=([-3.0, -4.0], [3.0, 4.0])) if kind == "pca" else {}
    ref = jax_cls(gauss_jax, start=START, widths=1.0, display_progress=False, seed=4, **kw)
    if kind != "pca":
        ref.set_non_negative(0)
    ref.advance(256)
    ref.save(tmp_path / "jax.npz")
    from_file = port_cls.load(tmp_path / "jax.npz", posterior=gauss_torch, device="cpu")
    via = (convert.pca_chain_from_jax if kind == "pca" else convert.gibbs_chain_from_jax)(
        ref, posterior=gauss_torch, device="cpu")
    for port in (from_file, via):
        assert type(port) is port_cls
        np.testing.assert_array_equal(port.get_sample(0), ref.get_sample(0))
        np.testing.assert_array_equal(port.get_probabilities(0), ref.get_probabilities(0))
        assert port.sigma_values == [list(v) for v in ref.sigma_values]
        st, rs = port._state, ref._state
        for f in ("value", "avg", "var", "num", "chk_int"):
            np.testing.assert_array_equal(getattr(st.widths, f).numpy()[0],
                                          np.asarray(getattr(rs.widths, f)))
        if kind == "pca":
            np.testing.assert_array_equal(port.directions, ref.directions)
            assert port.update_history == list(ref.update_history)
            np.testing.assert_array_equal(port.bounds.lower, ref.bounds.lower)
        else:
            np.testing.assert_array_equal(port._non_negative, ref._non_negative)
    port = from_file
    port.advance(64)
    assert port.chain_length == 257 + 64
    port.save(tmp_path / "port.npz")
    back = jax_cls.load(tmp_path / "port.npz", posterior=gauss_jax)
    np.testing.assert_array_equal(back.get_sample(0), port.get_sample(0))
    back.advance(8)
    assert back.chain_length == port.chain_length + 8
    with pytest.raises(ValueError, match="without a 'posterior'"):
        port_cls.load(tmp_path / "port.npz", device="cpu").advance(1)


def test_constructor_rules():
    """Widths default to 5% of the start (1 at 0) and broadcast; a
    non-finite start raises the JAX package's error; the default device is
    the card and raises without one."""
    chain = GibbsChain(gauss_torch, start=[0.0, -2.0], display_progress=False, device="cpu")
    np.testing.assert_array_equal(chain._last_widths, [1.0, 0.1])
    chain = MetropolisChain(gauss_torch, start=[1.0, 2.0], widths=0.3, temperature=2.0,
                            display_progress=False, device="cpu")
    np.testing.assert_array_equal(chain._last_widths, [0.3, 0.3])
    assert chain.inv_temp == 0.5 and chain.probs[0] == pytest.approx(0.5 * float(
        gauss_torch(torch.tensor([1.0, 2.0]))))
    with pytest.raises(ValueError, match="finite"):
        GibbsChain(lambda t: t.sum() * torch.inf, start=[1.0, 1.0], device="cpu")
    if not torch.cuda.is_available():
        for cls in (GibbsChain, MetropolisChain, PcaChain):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls(gauss_torch, start=START)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        PcaChain(gauss_torch, start=START, display_progress=False, device="cpu")
