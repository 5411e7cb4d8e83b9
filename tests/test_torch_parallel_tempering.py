"""Parallel tempering and chain pools of the PyTorch port
(inference_tpu_torch/mcmc/parallel.py) against the JAX package's
(inference_tpu/mcmc/parallel.py) and against the port's own chains, on the
CPU in float64: the pairings and the host swap of both packages from one
numpy stream, the fused on-device swap against the host swap, the rung-batched
step against each chain's own step on injected draws, and the port's
versions of tests/mcmc/test_parallel.py (but the NUTS ones, which wait for
NUTS: ROADMAP A12). JAX's ``advance`` is not run here: its tests are slow."""

import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.utils._pytree import tree_leaves, tree_map

from inference_tpu.mcmc import GibbsChain as JaxGibbs
from inference_tpu.mcmc import HamiltonianChain as JaxHamiltonian
from inference_tpu.mcmc import ParallelTempering as JaxTempering
from inference_tpu_torch import convert
from inference_tpu_torch.mcmc import (ChainPool, GibbsChain, HamiltonianChain, MetropolisChain,
                                      ParallelTempering, PcaChain)
from inference_tpu_torch.mcmc.parallel import _swap_on_device


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


def curved(t):
    return -0.5 * (t[0] ** 2 + (t[1] - t[0] ** 2) ** 2)


def make_pt(temps=(1.0, 3.0, 10.0, 30.0), seed=0):
    chains = [GibbsChain(bimodal, start=np.array([4.0]), widths=np.array([0.3]), temperature=T,
                         display_progress=False, seed=seed + i, device="cpu")
              for i, T in enumerate(temps)]
    pt = ParallelTempering(chains)
    pt.rng = np.random.default_rng(seed)
    pt._generator.manual_seed(seed)
    return pt


def _bare(cls, n, seed):
    """A ladder object of either package with only what the pairings read."""
    pt = cls.__new__(cls)
    pt.N_chains, pt.rng = n, np.random.default_rng(seed)
    return pt


# --------------------------------------------------------------------- #
# pairings and swaps against the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", range(2, 10))
def test_pairings_match_jax(n):
    """tight_pairs() and uniform_pairs() give the JAX lists from one
    default_rng stream, 20 calls each, interleaved."""
    port, ref = _bare(ParallelTempering, n, n), _bare(JaxTempering, n, n)
    for _ in range(20):
        for name in ("tight_pairs", "uniform_pairs"):
            got, want = getattr(port, name)(), getattr(ref, name)()
            assert [tuple(map(int, p)) for p in got] == [tuple(map(int, p)) for p in want]
        flat = [i for p in port.tight_pairs() for i in p]
        ref.tight_pairs()
        assert len(flat) == len(set(flat)) and len(flat) == 2 * (n // 2)


def _ladders(kinds, temps, starts, seed):
    """The same ladder in both packages: rung k of class kinds[k] from
    starts[k] at temps[k], with one rng stream each."""
    port, ref = [], []
    for k, (kind, T, s) in enumerate(zip(kinds, temps, starts)):
        kw = dict(temperature=T, display_progress=False, seed=seed + k)
        if kind == "gibbs":
            port.append(GibbsChain(bimodal, np.array([s]), widths=np.array([0.3]), device="cpu",
                                   **kw))
            ref.append(JaxGibbs(bimodal_jax, np.array([s]), widths=np.array([0.3]), **kw))
        else:
            port.append(HamiltonianChain(bimodal, np.array([s]), device="cpu", **kw))
            ref.append(JaxHamiltonian(bimodal_jax, np.array([s]), **kw))
    pt, jpt = ParallelTempering(port), JaxTempering(ref)
    pt.rng, jpt.rng = np.random.default_rng(seed), np.random.default_rng(seed)
    return pt, jpt


def _rows(pt):
    """Positions and logps of each rung as the ladder holds them."""
    if pt._batched_state is not None:
        return np.asarray(pt._batched_state.theta), np.asarray(pt._batched_state.logp)
    return (np.array([np.asarray(c._state.theta).reshape(-1) for c in pt.chains]),
            np.array([float(np.asarray(c._state.logp).reshape(())) for c in pt.chains]))


@pytest.mark.parametrize("kinds", [("gibbs",) * 6, ("gibbs", "hmc", "gibbs", "hmc", "gibbs")],
                         ids=["homogeneous", "mixed"])
def test_swap_matches_jax(kinds):
    """swap() on rungs spread over both modes moves the same positions,
    logps, last history entries, attempted_swaps and successful_swaps as the
    JAX class's swap() from the same states and rng (1e-12), some pairs
    accepted and some not."""
    n = len(kinds)
    temps = [2.0**k for k in range(n)]
    starts = np.random.default_rng(1).uniform(-6, 6, n)
    pt, jpt = _ladders(kinds, temps, starts, seed=7)
    assert pt._heterogeneous == jpt._heterogeneous == ("hmc" in kinds)
    for _ in range(12):
        pt.swap()
        jpt.swap()
        for got, want in zip(_rows(pt), _rows(jpt)):
            np.testing.assert_allclose(got, want, rtol=1e-12)
        for c, jc in zip(pt.chains, jpt.chains):
            np.testing.assert_allclose(c._consolidated_theta()[-1], jc._consolidated_theta()[-1],
                                       rtol=1e-12)
            np.testing.assert_allclose(c._consolidated_probs()[-1], jc._consolidated_probs()[-1],
                                       rtol=1e-12)
        np.testing.assert_array_equal(pt.attempted_swaps, jpt.attempted_swaps)
        np.testing.assert_array_equal(pt.successful_swaps, jpt.successful_swaps)
    moved = pt.successful_swaps.sum()
    assert 0 < moved < pt.attempted_swaps.sum() - n


def test_swap_on_device_equals_swap():
    """_swap_on_device with the pairs and uniforms swap() draws (from a copy
    of its rng) gives swap()'s positions, logps and accepted pairs, the
    logps to 1e-12 relative."""
    temps = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]
    chains = [GibbsChain(bimodal, start=np.array([s]), temperature=T, display_progress=False,
                         seed=i, device="cpu")
              for i, (T, s) in enumerate(zip(temps, np.linspace(-5, 5, 7)))]
    pt = ParallelTempering(chains)
    pt.rng = np.random.default_rng(3)
    for _ in range(10):
        twin = copy.deepcopy(pt.rng)
        probe = _bare(ParallelTempering, pt.N_chains, 0)
        probe.rng = twin
        pairs = probe.tight_pairs()
        uniforms = [twin.random() for _ in pairs]
        before = pt.successful_swaps.copy()
        state, accepted = _swap_on_device(pt._batched_state, torch.tensor(pairs),
                                          torch.tensor(uniforms))
        pt.swap()
        np.testing.assert_array_equal(state.theta.numpy(), pt._batched_state.theta.numpy())
        np.testing.assert_allclose(state.logp.numpy(), pt._batched_state.logp.numpy(),
                                   rtol=1e-12)
        delta = pt.successful_swaps - before
        assert [bool(delta[i, j]) for i, j in pairs] == accepted.tolist()


# --------------------------------------------------------------------- #
# the rung-batched step against each chain's own step
# --------------------------------------------------------------------- #
def gauss3(t):
    d = t - torch.tensor([0.3, -0.2, 0.5])
    return -0.5 * (d * d * torch.tensor([1.0, 2.0, 0.5])).sum()


def _row(state, k):
    return tree_map(lambda x: x[k:k + 1], state)


@pytest.mark.parametrize("cls", [GibbsChain, MetropolisChain, PcaChain, HamiltonianChain])
def test_batched_step_equals_each_chains_step(cls):
    """Three steps of a 4-rung ladder (temperatures 1-8, random starts and
    widths; PCA with random orthonormal directions) on injected draws equal
    each rung's own step on its column of the draws, row by row (1e-12)."""
    rng = np.random.default_rng(2)
    temps, P, R = [1.0, 2.0, 4.0, 8.0], 3, 4
    kw = dict(display_progress=False, device="cpu")
    if cls is HamiltonianChain:
        chains = [cls(gauss3, start=rng.normal(0, 1, P), temperature=T, seed=k, **kw)
                  for k, T in enumerate(temps)]
        for c in chains:
            c.steps = 6
    else:
        chains = [cls(gauss3, start=rng.normal(0, 1, P), widths=rng.uniform(0.3, 1.5, P),
                      temperature=T, seed=k, **kw) for k, T in enumerate(temps)]
    pt = ParallelTempering(chains)
    assert not pt._heterogeneous
    state = pt._batched_state
    if cls is PcaChain:
        dirs = torch.as_tensor(np.linalg.qr(rng.normal(size=(R, P, P)))[0])
        state = state._replace(directions=dirs)
    for _ in range(3):
        if cls is HamiltonianChain:
            A = chains[0].max_attempts
            draws = (torch.as_tensor(rng.normal(size=(A, R, P))),
                     torch.as_tensor(rng.uniform(size=(A, R))),
                     torch.as_tensor(rng.uniform(size=(A, R))))
        else:
            T = 400
            event = (P,) if cls is MetropolisChain else ()
            draws = (torch.as_tensor(rng.normal(size=(T, R, *event))),
                     torch.as_tensor(rng.uniform(size=(T, R))))
        with torch.no_grad():
            new, _ = pt._vstep(state, None, *draws)
            for k, c in enumerate(chains):
                own, _ = c._get_step()(_row(state, k), None, *(d[:, k:k + 1] for d in draws))
                for got, want in zip(tree_leaves(_row(new, k)), tree_leaves(own)):
                    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)
        state = new


def test_pca_ladder_updates_where_a_chain_does():
    """Each PcaChain rung of a ladder re-estimates its directions at the
    chain lengths a single PcaChain does (100, 250), and the batched state
    carries each rung's new directions."""
    starts = np.random.default_rng(4).normal(0, 1, (3, 2))
    make = lambda s, T: PcaChain(curved, start=s, temperature=T, display_progress=False,
                                 seed=1, device="cpu")
    single = make(starts[0], 1.0)
    single.advance(300)
    pt = ParallelTempering([make(s, T) for s, T in zip(starts, [1.0, 2.0, 4.0])])
    pt.rng = np.random.default_rng(0)
    assert not pt._fusable and not pt._heterogeneous
    pt.advance(300, swap_interval=10)
    chains = pt.return_chains()
    for k, c in enumerate(chains):
        assert c.update_history == single.update_history == [100, 250]
        np.testing.assert_allclose(pt._batched_state.directions[k].numpy(), c.directions)
        np.testing.assert_allclose(c._state.directions[0].numpy(), c.directions)


# --------------------------------------------------------------------- #
# host reads of the fused advance
# --------------------------------------------------------------------- #
class _HostReads:
    """Counts the ways Python reads a tensor's values (item, tolist, numpy,
    bool, int, float), apart from those made inside ``paused``."""

    NAMES = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__")

    def __init__(self, monkeypatch):
        self.count, self.inside, self.depth = 0, 0, 0
        for name in self.NAMES:
            original = getattr(torch.Tensor, name)

            def counted(t, *a, _original=original, **kw):
                if self.depth:
                    self.inside += 1
                else:
                    self.count += 1
                return _original(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)

    def paused(self, fn):
        def wrapped(*a, **kw):
            self.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self.depth -= 1
        return wrapped


@pytest.mark.parametrize("cls", [GibbsChain, MetropolisChain])
def test_fused_advance_reads_the_host_once(cls, monkeypatch):
    """Outside the transitions' own retry loops a fused advance reads the
    host once per chunk of cycles: advance(200) at swap_interval 10 is one
    chunk of 16 cycles and one of 4, two reads; the transitions read once a
    try (ROADMAP D2)."""
    chains = [cls(bimodal, start=np.array([4.0]), widths=np.array([0.3]), temperature=T,
                  display_progress=False, seed=i, device="cpu")
              for i, T in enumerate([1.0, 4.0, 16.0])]
    pt = ParallelTempering(chains)
    assert pt._fusable
    reads = _HostReads(monkeypatch)
    pt._vstep = reads.paused(pt._vstep)
    pt.advance(200, swap_interval=10)
    assert reads.count == 2
    assert reads.inside >= 200  # a try's count of acceptances, at least one a step
    monkeypatch.undo()
    assert all(c.chain_length == 201 for c in pt.return_chains())


# --------------------------------------------------------------------- #
# tests/mcmc/test_parallel.py, ported (but the NUTS ones)
# --------------------------------------------------------------------- #
def test_pt_advance_lengths():
    pt = make_pt()
    pt.advance(200, swap_interval=10)
    for c in pt.return_chains():
        assert c.chain_length == 201
    pt.shutdown()


def test_pt_mode_hopping():
    """The cold chain reaches the second mode via replica exchange: the
    weighted bimodal target puts ~2/3 of its mass in the left mode."""
    pt = make_pt(seed=3)
    pt.advance(3000, swap_interval=10)
    cold = pt.return_chains()[0]
    left_fraction = (cold.get_sample(burn=500)[:, 0] < 0).mean()
    assert 0.4 < left_fraction < 0.9
    pt.shutdown()


def test_pt_swap_bookkeeping():
    pt = make_pt()
    pt.advance(300, swap_interval=10)
    assert pt.attempted_swaps.sum() > pt.N_chains  # diagonal + attempts
    assert (pt.successful_swaps >= 0).all()
    assert (pt.successful_swaps <= pt.attempted_swaps).all()
    assert pt.attempted_swaps.sum() - pt.N_chains == 30 * (pt.N_chains // 2)
    pt.shutdown()


def test_pt_temperature_order_warning():
    chains = [GibbsChain(bimodal, start=np.array([4.0]), widths=np.array([0.3]), temperature=T,
                         display_progress=False, device="cpu") for T in [10.0, 1.0]]
    with pytest.warns(UserWarning):
        pt = ParallelTempering(chains)
    pt.shutdown()


def test_pt_with_hmc_chains():
    chains = [HamiltonianChain(curved, start=np.array([0.5, 0.5]), temperature=T,
                               display_progress=False, seed=i, device="cpu")
              for i, T in enumerate([1.0, 5.0])]
    for c in chains:
        c.steps = 10
    pt = ParallelTempering(chains)
    assert pt._fusable
    pt.advance(100, swap_interval=10)
    for c in pt.return_chains():
        assert c.chain_length == 101
        c._drain_epsilon_trace()
        assert len(c.ES.epsilon_values) > 1  # the epsilon trace reached the selector
        assert c.ES.num == float(c._state.eps.num[0])
    pt.shutdown()


def test_chain_pool():
    chains = [GibbsChain(bimodal, start=np.array([4.0]), widths=np.array([0.3]),
                         display_progress=False, seed=i, device="cpu") for i in range(3)]
    pool = ChainPool(chains)
    assert pool.pool_size == 3
    pool.advance(100)
    for c in chains:
        assert c.chain_length == 101


def test_parallel_tempering_heterogeneous_chains():
    """A mixed list of classes advances each rung through its own chain and
    swaps on the host."""
    start = np.array([4.0])
    kw = dict(display_progress=False, device="cpu")
    chains = [GibbsChain(bimodal, start=start, temperature=1.0, seed=0, **kw),
              HamiltonianChain(bimodal, start=start, temperature=3.0, seed=1, **kw),
              GibbsChain(bimodal, start=start, temperature=10.0, seed=2, **kw)]
    chains[1].steps = 10
    pt = ParallelTempering(chains=chains)
    assert pt._heterogeneous and not pt._fusable
    pt.advance(60, swap_interval=10)
    for c in pt.chains:
        assert c.chain_length == 61
        assert np.isfinite(c.get_probabilities(burn=0)).all()
    assert pt.attempted_swaps.sum() > 3  # diagonal + attempts


def test_pt_single_rung_degrades_gracefully():
    c = GibbsChain(bimodal, start=np.array([4.0]), widths=np.array([0.5]),
                   display_progress=False, seed=0, device="cpu")
    pt = ParallelTempering([c])
    pt.advance(50, swap_interval=10)
    assert pt.successful_swaps.sum() == 0
    chains = pt.return_chains()
    assert chains[0]._state is not None
    assert chains[0].chain_length == 51


def test_pt_heterogeneous_return_chains_keeps_states():
    c0 = GibbsChain(bimodal, start=np.array([4.0]), widths=np.array([0.5]),
                    display_progress=False, seed=1, device="cpu")
    c1 = HamiltonianChain(bimodal, start=np.array([4.0]), temperature=5.0,
                          display_progress=False, seed=2, device="cpu")
    c1.steps = 5
    pt = ParallelTempering([c0, c1])
    pt.advance(30, swap_interval=10)
    chains = pt.return_chains()
    assert all(c._state is not None for c in chains)
    chains[0].advance(10)  # still usable
    assert chains[0].chain_length == 41


def test_pt_mismatched_configs_use_per_chain_path():
    """Same-class rungs whose step settings differ do not share chains[0]'s
    step; identical settings take the batched path, whose rungs keep their
    states after return_chains()."""
    kw = dict(display_progress=False, device="cpu")
    c0 = HamiltonianChain(bimodal, start=np.array([4.0]), seed=3, **kw)
    c0.steps = 5
    c1 = HamiltonianChain(bimodal, start=np.array([4.0]), temperature=5.0, seed=4, **kw)
    c1.steps = 20
    pt = ParallelTempering([c0, c1])
    assert pt._heterogeneous
    pt.advance(40, swap_interval=10)
    assert all(c._state is not None for c in pt.return_chains())
    assert c0.chain_length == 41 and c1.chain_length == 41

    c2 = HamiltonianChain(bimodal, start=np.array([4.0]), seed=5, **kw)
    c3 = HamiltonianChain(bimodal, start=np.array([4.0]), temperature=5.0, seed=6, **kw)
    assert not ParallelTempering([c2, c3])._heterogeneous
    g0 = GibbsChain(bimodal, start=np.array([4.0]), seed=0, **kw)
    g1 = GibbsChain(bimodal, start=np.array([4.0]), temperature=3.0, seed=1, **kw)
    g1.set_non_negative(0)
    assert ParallelTempering([g0, g1])._heterogeneous


def test_pt_rejects_mixed_parameter_counts_and_names_a14():
    kw = dict(display_progress=False, device="cpu")
    with pytest.raises(ValueError, match="same number of parameters"):
        ParallelTempering([GibbsChain(bimodal, start=np.array([4.0]), **kw),
                           GibbsChain(curved, start=np.array([0.5, 0.5]), **kw)])
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert make_pt().swap_diagnostics() is None  # Agg: draws, shows nothing (A14(b))
    assert len(plt.gcf().axes) == 2
    plt.close("all")


def test_parallel_tempering_from_jax():
    """A JAX ladder crosses as its chains: the same temperatures, histories
    and last states, and it advances in the port."""
    ref = JaxTempering([JaxGibbs(bimodal_jax, start=np.array([s]), widths=np.array([0.3]),
                                 temperature=T, display_progress=False, seed=k)
                        for k, (s, T) in enumerate([(4.0, 1.0), (-4.0, 3.0), (0.5, 9.0)])])
    pt = convert.parallel_tempering_from_jax(ref, bimodal, seed=0, device="cpu")
    assert pt.temperatures == pytest.approx(ref.temperatures)
    assert not pt._heterogeneous
    for c, jc in zip(pt.chains, ref.chains):
        np.testing.assert_array_equal(c.get_sample(burn=0), jc.get_sample(burn=0))
    pt.advance(20, swap_interval=10)
    assert [c.chain_length for c in pt.return_chains()] == [21, 21, 21]
