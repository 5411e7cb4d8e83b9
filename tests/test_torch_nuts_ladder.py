"""NUTS ladders of the PyTorch port's ``ParallelTempering``
(inference_tpu_torch/mcmc/parallel.py) on the CPU in float64: the R-row
NUTS step against each rung's own step on injected draws, the ladder's
depths and leapfrog counts (NUTS transitions, not HMC ones), the three NUTS
tests of tests/mcmc/test_parallel.py:212-300 (the cached gradients follow
the positions through the fused and the host swaps), and a JAX NUTS ladder
carried into the port."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.utils._pytree import tree_leaves, tree_map

from inference_tpu.mcmc import NutsChain as JaxNutsChain
from inference_tpu.mcmc import ParallelTempering as JaxTempering
from inference_tpu_torch import convert
from inference_tpu_torch.mcmc import GibbsChain, HamiltonianChain, NutsChain, ParallelTempering
from inference_tpu_torch.mcmc._kernels import nuts


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


def bimodal(t):
    """tests/mcmc/test_parallel.py's posterior: modes at +-4, 2:1 weights."""
    x = t[0]
    return torch.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2,
                           -0.5 * ((x - 4.0) / 0.5) ** 2 + np.log(0.5))


def bimodal_jax(t):
    x = t[0]
    return jnp.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2,
                         -0.5 * ((x - 4.0) / 0.5) ** 2 + jnp.log(0.5))


def bimodal_grad(theta):
    """The gradient of ``bimodal`` by autograd, at a numpy position."""
    t = torch.as_tensor(np.asarray(theta, dtype=float)).requires_grad_(True)
    return torch.autograd.grad(bimodal(t), t)[0].numpy()


def gauss3(t):
    d = t - torch.tensor([0.3, -0.2, 0.5])
    return -0.5 * (d * d * torch.tensor([1.0, 2.0, 0.5])).sum()


def nuts_ladder(temps=(1.0, 3.0, 10.0), max_depth=5, seed=3):
    return ParallelTempering([
        NutsChain(bimodal, start=np.array([4.0]), temperature=T, max_depth=max_depth,
                  display_progress=False, seed=seed + i, device="cpu")
        for i, T in enumerate(temps)])


def _row(state, k):
    return tree_map(lambda x: x[k:k + 1], state)


def _assert_grad_follows_position(state, inv_temps):
    for k, it in enumerate(inv_temps):
        expected = it * bimodal_grad(state.theta[k].numpy())
        np.testing.assert_allclose(state.grad[k].numpy(), expected, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("inverse_mass", [None, np.array([1.0, 2.0, 0.5])])
def test_rung_step_equals_each_chains_step(inverse_mass):
    """Three R-row NUTS steps of a 4-rung ladder (temperatures 1-8) on
    injected draws equal each rung's own NUTS step on its row of the
    draws (1e-12), depths and leapfrog counts equal."""
    rng = np.random.default_rng(2)
    temps, P, R, D = [1.0, 2.0, 4.0, 8.0], 3, 4, 6
    chains = [NutsChain(gauss3, start=rng.normal(0, 1, P), temperature=T, epsilon=0.4,
                        inverse_mass=inverse_mass, max_depth=D, display_progress=False,
                        seed=k, device="cpu") for k, T in enumerate(temps)]
    pt = ParallelTempering(chains)
    assert not pt._heterogeneous and pt._run_steps is nuts.run_steps
    state = pt._batched_state
    for _ in range(3):
        draws = (rng.normal(size=(R, P)), rng.uniform(size=(R, D)), rng.uniform(size=(R, D)),
                 rng.uniform(size=(R, 2**D - 1)))
        draws = [torch.as_tensor(d) for d in draws]
        with torch.no_grad():
            new, out = pt._vstep(state, None, *draws)
            for k, c in enumerate(chains):
                own, own_out = c._get_step()(_row(state, k), None, *(d[k:k + 1] for d in draws))
                for got, want in zip(tree_leaves(_row(new, k)), tree_leaves(own)):
                    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
                assert int(out.tree_depth[k]) == int(own_out.tree_depth[0])
                assert int(out.leapfrog_steps[k]) == int(own_out.leapfrog_steps[0])
        state = new


def test_nuts_ladder_runs_nuts_transitions():
    """A ladder of NutsChain rungs advances by NUTS transitions, not the
    R-row HMC step a HamiltonianChain ladder takes: every rung records a
    tree depth a step, its leapfrog counts lie in [2^(d-1), 2^d - 1] for
    depth d (an HMC transition takes ~50), and the depths vary."""
    pt = nuts_ladder(max_depth=5)
    assert pt._run_steps is nuts.run_steps
    pt.advance(60, swap_interval=5)
    for c in pt.return_chains():
        depths, leaps = c.tree_depths[1:], np.array(c.leapfrog_steps[1:])
        assert depths.shape == (60,) and (depths >= 1).all() and (depths <= 5).all()
        assert (leaps >= 2 ** (depths - 1)).all() and (leaps <= 2**depths - 1).all()
        assert len(set(depths.tolist())) > 1
        assert c.divergent_steps.shape == (61,)
    hmc = ParallelTempering([HamiltonianChain(bimodal, start=np.array([4.0]), temperature=T,
                                              display_progress=False, seed=i, device="cpu")
                             for i, T in enumerate([1.0, 3.0])])
    assert hmc._run_steps is not nuts.run_steps


def test_pt_nuts_grad_cache_swaps():
    """tests/mcmc/test_parallel.py:212-247 on the port: the fused on-device
    swaps permute and re-temper each rung's cached gradient with its
    position, and so do 10 host swap()s."""
    pt = nuts_ladder()
    pt.advance(120, swap_interval=5)
    assert not pt._heterogeneous
    assert pt.successful_swaps.sum() - np.trace(pt.successful_swaps) > 0
    _assert_grad_follows_position(pt._batched_state, pt.inv_temps)
    moved = 0
    for _ in range(10):
        before = pt._batched_state.theta.clone()
        pt.swap()
        moved += int(not torch.equal(before, pt._batched_state.theta))
    assert moved > 0
    _assert_grad_follows_position(pt._batched_state, pt.inv_temps)
    for k, c in enumerate(pt.return_chains()):
        np.testing.assert_array_equal(c._state.grad.numpy(), pt._batched_state.grad[k:k + 1])


def test_pt_nuts_heterogeneous_grad_refresh():
    """tests/mcmc/test_parallel.py:250-280: in a mixed ladder the Gibbs
    partner carries no gradient, so the NUTS rung recomputes its cache
    after it receives a position."""
    rung = NutsChain(bimodal, start=np.array([4.0]), temperature=1.0, display_progress=False,
                     seed=0, device="cpu")
    gibbs = GibbsChain(bimodal, start=np.array([-4.0]), widths=np.array([0.3]),
                       temperature=5.0, display_progress=False, seed=1, device="cpu")
    pt = ParallelTempering([rung, gibbs])
    assert pt._heterogeneous
    pt.advance(60, swap_interval=5)
    _assert_grad_follows_position(rung._state, [rung.inv_temp])


def test_pt_mixed_max_depth_routes_heterogeneous():
    """tests/mcmc/test_parallel.py:283-300: rungs that differ only in
    max_depth cannot share one step."""
    chains = [NutsChain(bimodal, start=np.array([4.0]), temperature=T, max_depth=d,
                        display_progress=False, seed=i, device="cpu")
              for i, (T, d) in enumerate([(1.0, 8), (5.0, 4)])]
    pt = ParallelTempering(chains)
    assert pt._heterogeneous
    pt.advance(10, swap_interval=5)
    assert [c.chain_length for c in pt.return_chains()] == [11, 11]


def test_nuts_ladder_from_jax():
    """A JAX NUTS ladder crosses as its chains: the same temperatures,
    histories, depths and max_depth; each rung's cache is the tempered
    gradient at its position, and the ladder advances in the port."""
    ref = JaxTempering([JaxNutsChain(bimodal_jax, start=np.array([s]), temperature=T,
                                     max_depth=4, display_progress=False, seed=k)
                        for k, (s, T) in enumerate([(4.0, 1.0), (-4.0, 3.0)])])
    ref.take_steps(4)
    pt = convert.parallel_tempering_from_jax(ref, bimodal, seed=0, device="cpu")
    assert pt.temperatures == pytest.approx(ref.temperatures)
    assert not pt._heterogeneous and pt._run_steps is nuts.run_steps
    for c, jc in zip(pt.chains, ref.return_chains()):
        assert isinstance(c, NutsChain) and c.max_depth == 4
        np.testing.assert_array_equal(c.get_sample(burn=0), jc.get_sample(burn=0))
        np.testing.assert_array_equal(c.tree_depths, jc.tree_depths)
    _assert_grad_follows_position(pt._batched_state, pt.inv_temps)
    pt.advance(10, swap_interval=5)
    assert [c.chain_length for c in pt.return_chains()] == [15, 15]
