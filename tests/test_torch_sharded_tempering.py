"""``ShardedTempering`` of the PyTorch port against the JAX package's, on
8 CPU cells (``tempering_mesh(4, 8, device="cpu")``: 4 rungs x 2 chain
shards) and JAX's 8 virtual CPU devices.

The JAX class compiles a program per swap phase and per advance shape
(seconds each), so each JAX object is built once per module and the
parity tests call its swap programs directly on a state both packages
share, with JAX's own uniforms: for rung r and chain shard s,
``uniform(fold_in(fold_in(key, min(r, partner)), s), (1, lanes[, W]))``,
rebuilt here and injected into the port's ``_swap``.

Tolerances, with reasons: one swap phase 1e-12 (the same float64
arithmetic in the same order: the only operations are divisions, a
product, an exp and selections, so the two agree to an ulp or exactly);
accept flags exactly; statistics by the JAX tests' own bands.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from inference_tpu.parallel import ShardedTempering as JaxShardedTempering
from inference_tpu.parallel import tempering_mesh as jax_tempering_mesh
from inference_tpu.parallel.tempering import _even_odd_perm as jax_even_odd_perm
from inference_tpu_torch import convert
from inference_tpu_torch.parallel import ShardedTempering, tempering_mesh
from inference_tpu_torch.parallel.tempering import _even_odd_perm

TEMPS = [1.0, 3.0, 10.0, 30.0]
N_CHAINS = 4  # 2 lanes a cell on the 4 x 2 mesh


@pytest.fixture(autouse=True, scope="module")
def _float64():
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dt)


def jax_bimodal(t):
    x = t[0]
    return jnp.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2, -0.5 * ((x - 4.0) / 0.5) ** 2 + jnp.log(0.5))


def bimodal(t):
    x = t[0]
    return torch.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2,
                           -0.5 * ((x - 4.0) / 0.5) ** 2 + np.log(0.5))


def jax_gauss2(t):
    return -0.5 * (t[0] ** 2 + (10.0 * (t[1] - t[0])) ** 2)


def gauss2(t):
    return -0.5 * (t[0] ** 2 + (10.0 * (t[1] - t[0])) ** 2)


def cpu_mesh(n_rungs=4, n=8):
    return tempering_mesh(n_rungs, n, device="cpu")


KINDS = {  # kind: (jax posterior, port posterior, start, keyword arguments)
    "hmc": (jax_bimodal, bimodal, [4.0], dict(steps=5)),
    "nuts": (jax_bimodal, bimodal, [4.0], dict(max_depth=4)),
    "gibbs": (jax_gauss2, gauss2, [0.5, 0.5], dict(widths=0.3)),
    "ensemble": (jax_gauss2, gauss2, [0.5, 0.5], dict(n_walkers=6, widths=1.0)),
}


def scattered_state(jst, kind, seed):
    """The JAX instance's state with scattered positions and consistent
    tempered log-probabilities (and tempered gradients for nuts), so that
    a swap phase accepts some pairs and rejects others."""
    jlogp, _, start, _ = KINDS[kind]
    state = jst._state
    pos, _ = (state.walkers, state.logps) if kind == "ensemble" else (state.theta, state.logp)
    rng = np.random.default_rng(seed)
    new = jnp.asarray(np.asarray(start) + rng.normal(0, 3.0, size=pos.shape))
    it = state.inv_temp
    f = jax.vmap(jax.vmap(jax.vmap(jlogp))) if kind == "ensemble" else jax.vmap(jax.vmap(jlogp))
    lp = f(new) * (it[..., None] if kind == "ensemble" else it)
    if kind == "ensemble":
        state = state._replace(walkers=new, logps=lp)
    else:
        state = state._replace(theta=new, logp=lp)
    if kind == "nuts":
        g = jax.vmap(jax.vmap(jax.grad(jlogp)))(new)
        state = state._replace(grad=g * it[..., None])
    return jst._shard(state)


def jax_uniforms(key, n_rungs, n_chains, n_shards, phase, tail=()):
    """JAX's swap uniforms of every (rung, lane), from its key."""
    _, partner = jax_even_odd_perm(n_rungs, phase)
    lanes = n_chains // n_shards
    table = np.zeros((n_rungs, n_chains) + tail)
    for r in range(n_rungs):
        for s in range(n_shards):
            k = jax.random.fold_in(jax.random.fold_in(key, min(r, partner[r])), s)
            table[r, s * lanes:(s + 1) * lanes] = np.asarray(
                jax.random.uniform(k, (1, lanes) + tail, jnp.float64))[0]
    return table


def leaves_of(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def port_state_from(jstate, port):
    """The port's global state from a JAX state's leaves."""
    leaves = leaves_of(jstate)
    R, C = leaves[0].shape[:2]
    flat = [x.reshape((R * C,) + x.shape[2:]) for x in leaves]
    return port._leaf_codec()[1](flat, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_objects():
    """One JAX ShardedTempering per kind, built once."""
    out = {}
    for kind, (jlogp, _, start, kw) in KINDS.items():
        out[kind] = JaxShardedTempering(jlogp, np.array(start), TEMPS, N_CHAINS,
                                        jax_tempering_mesh(4), kind=kind, seed=3, **kw)
    return out


@pytest.mark.parametrize("n_rungs", range(1, 10))
def test_pairings_match_jax(n_rungs):
    for phase in (0, 1):
        assert _even_odd_perm(n_rungs, phase) == jax_even_odd_perm(n_rungs, phase)


def port_twin(kind, jst, seed=0):
    _, logp, start, kw = KINDS[kind]
    return ShardedTempering(logp, np.array(start), TEMPS, N_CHAINS, cpu_mesh(), kind=kind,
                            seed=seed, **kw)


def swap_both(jst, st, jstate, phase, key):
    """One swap phase in both packages on the same state and JAX's
    uniforms: (jax state, jax flags, port state, port flags)."""
    tail = (jst._state.walkers.shape[2],) if jst.kind == "ensemble" else ()
    table = jax_uniforms(key, 4, N_CHAINS, 2, phase, tail)
    js, ja = jst._swap_fns[phase](jstate, key)
    u = st._layout.local_rows(torch.as_tensor(table.reshape((16,) + tail)))
    ts, ta = st._swap(st._state, phase, u)
    return js, np.asarray(ja), ts, ta.numpy()


# the position of the PRNG key among a JAX state's leaves (the port's
# states have none)
KEY_LEAF = {"hmc": 7, "nuts": 8, "gibbs": 8, "metropolis": 8, "pca": 8, "ensemble": 2}


def assert_states_match(jstate, tstate, st):
    st._state = tstate
    got = convert._state_leaves(st.global_state())
    ref = leaves_of(jstate)
    ref = [x for i, x in enumerate(ref) if i != KEY_LEAF[st.kind]]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = r.reshape(g.shape)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kind, phase", [("hmc", 0), ("hmc", 1), ("nuts", 0), ("gibbs", 1),
                                         ("ensemble", 0)])
def test_one_swap_phase_matches_jax(jax_objects, kind, phase):
    jst = jax_objects[kind]
    jstate = scattered_state(jst, kind, seed=phase)
    st = port_twin(kind, jst)
    st.set_global_state(port_state_from(jstate, st))
    key = jax.random.PRNGKey(11 + phase)
    js, ja, ts, ta = swap_both(jst, st, jstate, phase, key)
    flags = ja.reshape(16, *ja.shape[2:])
    assert 0 < flags.mean() < 1  # the phase accepts some pairs and rejects others
    np.testing.assert_array_equal(st._layout.gather([torch.as_tensor(ta)])[0], flags)
    assert_states_match(js, ts, st)


def test_conversion_then_the_next_swap_matches_jax(jax_objects):
    """``sharded_tempering_from_jax`` carries the state, phase and swap
    counts; the next swap phase of both then agrees."""
    jst = jax_objects["nuts"]
    jst._state = scattered_state(jst, "nuts", seed=5)
    jst._phase = 1
    jst.successful_swaps[0, 1] = 3.0
    st = convert.sharded_tempering_from_jax(jst, bimodal, cpu_mesh(), max_depth=4)
    assert st._phase == 1 and st.successful_swaps[0, 1] == 3.0 and st.kind == "nuts"
    np.testing.assert_array_equal(st.theta, np.asarray(jst._state.theta))
    key = jax.random.PRNGKey(2)
    js, ja, ts, ta = swap_both(jst, st, jst._state, st._phase, key)
    assert_states_match(js, ts, st)
    st.advance(10, swap_interval=5)  # and it keeps advancing
    assert np.isfinite(st.logp).all()


def test_exact_step_accounting_and_phase_match_jax():
    """``tests/test_parallel_sharded.py::test_sharded_tempering_exact_step_accounting``
    on both packages: advance(n, interval) runs exactly n steps, the
    remainder as a swap-free tail; shapes and the phase agree."""
    jst = JaxShardedTempering(jax_bimodal, np.array([4.0]), [1.0, 10.0], 4, jax_tempering_mesh(2),
                              steps=5, seed=0)
    st = ShardedTempering(bimodal, np.array([4.0]), [1.0, 10.0], 4, cpu_mesh(2), steps=5, seed=0)
    for n, swaps, stored in ((25, 2, 25), (3, 0, 28), (10, 1, 38)):
        ja, ta = jst.advance(n, swap_interval=10), st.advance(n, swap_interval=10)
        assert ta.shape == ja.shape and ta.shape[0] == swaps
        assert sum(h.shape[0] for h in st._history) == stored
        assert [h.shape for h in st._history] == [h.shape for h in jst._history]
        assert st._phase == jst._phase
        np.testing.assert_array_equal(st.attempted_swaps, jst.attempted_swaps)
    assert st.theta.shape == (2, 4, 1) and st.logp.shape == (2, 4)
    assert st.get_sample(0).shape == (38 * 4, 1) and st.get_probabilities(1).shape == (38 * 4,)


@pytest.mark.parametrize("kind,kwargs", [
    ("hmc", dict(steps=5)),
    ("gibbs", dict(widths=0.5)),
    ("metropolis", dict(widths=0.5)),
    ("pca", dict(widths=0.5)),
    ("ensemble", dict(n_walkers=8, widths=1.0)),
    ("nuts", dict(max_depth=6)),
])
def test_every_kind_hops_modes(kind, kwargs):
    """``test_sharded_tempering_kinds``'s checks on the port: swaps at a
    healthy rate between adjacent rungs only, the cold rung reaching the
    left mode from +4."""
    st = ShardedTempering(bimodal, np.array([4.0]), TEMPS, 8, cpu_mesh(), kind=kind, seed=5,
                          **kwargs)
    acc = st.advance(400, swap_interval=10)
    assert acc.shape == (40, 4, 8) + ((8,) if kind == "ensemble" else ())
    assert 0.1 < acc.mean() < 0.98
    assert (st.cold_chain_positions() < 0).any()
    sample = st.get_sample(rung=0, burn=100)
    assert sample.ndim == 2 and sample.shape[1] == 1 and np.isfinite(sample).all()
    attempted = st.attempted_swaps - np.identity(4)
    i, j = np.nonzero(attempted)
    assert (np.abs(i - j) == 1).all()
    assert st.swap_rate_matrix()[0, 1] > 0.0


def test_nuts_grad_cache_after_swaps():
    """``test_sharded_tempering_nuts_grad_cache_after_swaps``: the swap
    exchanges and re-tempers the cached gradient."""
    st = ShardedTempering(bimodal, np.array([4.0]), TEMPS, 4, cpu_mesh(), kind="nuts",
                          max_depth=5, seed=7)
    acc = st.advance(60, swap_interval=5)
    assert acc.mean() > 0.05
    state = st.global_state()
    theta = state.theta.requires_grad_(True)
    g = torch.autograd.grad(torch.func.vmap(bimodal)(theta).sum(), theta)[0]
    torch.testing.assert_close(state.grad, state.inv_temp[:, None] * g, rtol=1e-5, atol=1e-6)


def test_swap_uniforms_independent_across_chain_shards():
    """``test_swap_uniforms_independent_across_chain_shards``: with every
    lane's acceptance probability 1/2, shards draw different patterns;
    partners read the same uniform."""
    st = ShardedTempering(lambda t: 0.0 * t.sum(), np.zeros(1), [1.0, 2.0], 64, cpu_mesh(2),
                          steps=2, seed=0)
    it = 1.0 / st.temperatures
    a_minus_b = np.log(2.0) / (it[0] - it[1])
    untempered = np.stack([np.full(64, a_minus_b), np.zeros(64)])
    state = st._state._replace(logp=torch.as_tensor((untempered * it[:, None]).reshape(-1)))
    table = torch.rand((2, 64), generator=st._swap_generator)
    u = st._local_uniforms(table, 0)
    assert torch.equal(u[:64], u[64:])  # rung 0 and rung 1 read one uniform a lane
    _, accept = st._swap(state, 0, u)
    blocks = accept[:64].numpy().reshape(4, 16)  # rung 0's lanes by chains shard
    assert 0 < blocks.mean() < 1
    assert not all(np.array_equal(blocks[0], blocks[k]) for k in range(1, 4))


def test_store_false_keeps_no_history():
    st = ShardedTempering(bimodal, np.array([4.0]), [1.0, 10.0], 4, cpu_mesh(2), steps=5, seed=1)
    acc = st.advance(25, swap_interval=10, store=False)
    assert acc.shape[0] == 2 and not st._history and st.get_sample(0).shape == (0, 1)
    st2 = ShardedTempering(bimodal, np.array([4.0]), [1.0, 10.0], 4, cpu_mesh(2),
                           kind="ensemble", n_walkers=6, widths=1.0, seed=2)
    empty = st2.advance(3, swap_interval=10)
    full = st2.advance(20, swap_interval=10)
    assert empty.shape[1:] == full.shape[1:]


def test_update_directions_and_rhat_match_jax_on_one_history():
    """The PCA directions re-estimated and R-hat computed from one stored
    history in both packages."""
    st = ShardedTempering(gauss2, np.array([0.5, 0.5]), [1.0, 5.0], 4, cpu_mesh(2), kind="pca",
                          widths=0.3, seed=2)
    st.advance(60, swap_interval=10)
    d0 = st.global_state().directions.clone()
    jst = JaxShardedTempering(jax_gauss2, np.array([0.5, 0.5]), [1.0, 5.0], 4,
                              jax_tempering_mesh(2), kind="pca", widths=0.3, seed=2)
    jst._history = list(st._history)
    st.update_directions()
    jst.update_directions()
    d1 = st.global_state().directions
    assert not torch.allclose(d0, d1)
    np.testing.assert_allclose(d1.numpy().reshape(2, 4, 2, 2), np.asarray(jst._state.directions),
                               rtol=0, atol=1e-12)
    for rung in (0, 1):
        for ranked in (True, False):
            np.testing.assert_allclose(st.rhat(rung, burn=10, rank_normalized=ranked),
                                       jst.rhat(rung, burn=10, rank_normalized=ranked),
                                       rtol=1e-10)
    st.advance(30, swap_interval=10)
    assert np.isfinite(st.get_sample(0)).all()


def test_checkpoints_cross_between_the_packages(tmp_path):
    """save() writes the JAX class's layout: the port restores a JAX
    checkpoint and the JAX class restores the port's."""
    jst = JaxShardedTempering(jax_bimodal, np.array([4.0]), [1.0, 5.0], 4, jax_tempering_mesh(2),
                              steps=5, seed=7)
    jst._state = jst._shard(jst._state._replace(
        theta=jnp.asarray(np.random.default_rng(0).normal(size=(2, 4, 1)))))
    jst._phase = 1
    jst.save(str(tmp_path / "jax.npz"))
    st = ShardedTempering(bimodal, np.array([4.0]), [1.0, 5.0], 4, cpu_mesh(2), steps=5, seed=9)
    st.restore(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(st.theta, np.asarray(jst._state.theta))
    assert st._phase == 1
    st.advance(20, swap_interval=10)
    st.save(str(tmp_path / "port.npz"))
    jst.restore(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jst._state.theta), st.theta)
    np.testing.assert_array_equal(jst.successful_swaps, st.successful_swaps)


def test_save_restore_round_trip(tmp_path):
    st = ShardedTempering(gauss2, np.array([0.5, 0.5]), TEMPS, 4, cpu_mesh(), kind="gibbs",
                          widths=0.3, seed=4)
    st.advance(30, swap_interval=10)
    st.save(str(tmp_path / "st.npz"))
    st2 = ShardedTempering(gauss2, np.array([0.5, 0.5]), TEMPS, 4, cpu_mesh(), kind="gibbs",
                           widths=0.3, seed=8)
    st2.restore(str(tmp_path / "st.npz"))
    for a, b in zip(convert._state_leaves(st.global_state()),
                    convert._state_leaves(st2.global_state())):
        np.testing.assert_array_equal(a, b)
    assert st2._phase == st._phase
    with pytest.raises(ValueError, match="does not match"):
        ShardedTempering(gauss2, np.array([0.5, 0.5]), TEMPS, 8, cpu_mesh(), kind="gibbs",
                         seed=8).restore(str(tmp_path / "st.npz"))


def test_validation_matches_jax():
    cases = [
        dict(temperatures=[1.0, 2.0, 4.0], n_chains=4),   # 3 rungs on a 4-rung mesh
        dict(temperatures=TEMPS, n_chains=3),            # 3 lanes over 2 chain shards
    ]
    for case in cases:
        errors = []
        for cls, mesh, logp in ((JaxShardedTempering, jax_tempering_mesh(4), jax_gauss2),
                                (ShardedTempering, cpu_mesh(), gauss2)):
            with pytest.raises(ValueError) as info:
                cls(logp, np.zeros(2), case["temperatures"], case["n_chains"], mesh)
            errors.append(str(info.value))
        assert errors[0] == errors[1]
    st = ShardedTempering(gauss2, np.zeros(2), TEMPS, 4, cpu_mesh(), steps=2)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert len(st.swap_diagnostics(show=False).axes) == 2  # ported with A14(b)
    plt.close("all")
    with pytest.raises(ValueError, match="pca"):
        st.update_directions()


def test_run_for():
    st = ShardedTempering(bimodal, np.array([4.0]), [1.0, 10.0], 4, cpu_mesh(2), steps=5, seed=1,
                          display_progress=False)
    st.run_for(minutes=1.0 / 60.0, swap_interval=5)
    assert sum(h.shape[0] for h in st._history) >= 5 and np.isfinite(st.get_sample(0)).all()


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["gibbs", "hmc"])
def test_operations_a_step_do_not_grow_with_the_cells(kind):
    """The cells of a process advance as one batch: the same ladder on 2
    and on 8 cells of one device dispatches the same operations."""
    counts = []
    for n_cells in (2, 8):
        st = ShardedTempering(gauss2, np.array([0.5, 0.5]), [1.0, 4.0], 16,
                              cpu_mesh(2, n_cells), kind=kind, steps=3, widths=0.3, seed=0)
        st.advance(10, swap_interval=5)  # warm
        with _CountOps() as ops:
            st.advance(20, swap_interval=5)
        counts.append(ops.n)
    assert counts[0] == counts[1]
