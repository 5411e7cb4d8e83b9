"""Step-size adaptation of the PyTorch port (inference_tpu_torch
mcmc/_kernels/common.py) against the JAX package's, on the same sequences
of acceptance probabilities."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from inference_tpu.mcmc._kernels import common as jax_common
from inference_tpu.mcmc._kernels import hmc as jax_hmc
from inference_tpu_torch.mcmc._kernels import common as torch_common
from inference_tpu_torch.mcmc._kernels import hmc as torch_hmc


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


HMC_CONSTANTS = dict(
    target=0.65, growth_factor=1.4, adjust_power=0.15, adjust_min=0.5,
    adjust_max=2.0, var_floor=0.03,
)
METROPOLIS_CONSTANTS = dict(
    target=0.25, growth_factor=1.75, adjust_power=0.25, adjust_min=0.1,
    adjust_max=3.0,
)


def _prob_sequence(seed, n_steps=500, lanes=64):
    """Acceptance probabilities in [0, 1] with exact 0s and 1s: lane 0 is
    always 1, lane 1 always 0, and scattered entries of other lanes too."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 1.0, (n_steps, lanes))
    p[:, 0] = 1.0
    p[:, 1] = 0.0
    p[rng.uniform(size=p.shape) < 0.05] = 0.0
    p[rng.uniform(size=p.shape) < 0.05] = 1.0
    # lanes 2-9 accept rarely and 10-17 almost always, so both
    # directions of adjustment and the interval growth all happen
    p[:, 2:10] *= 0.2
    p[:, 10:18] = 0.9 + 0.1 * p[:, 10:18]
    return p


def _run_both(p, value0, chk0, constants, mask=None):
    jax_state = jax_common.init_adaptive_scale(jnp.asarray(value0), chk0)
    torch_state = torch_common.init_adaptive_scale(torch.as_tensor(value0), chk0)
    submit = jax.jit(
        lambda s, q, m: jax_common.submit_accept_prob(s, q, mask=m, **constants)
    )
    jax_steps, torch_steps = [], []
    for i, row in enumerate(p):
        m = True if mask is None else mask[i]
        jax_state = submit(jax_state, jnp.asarray(row), jnp.asarray(m))
        torch_state = torch_common.submit_accept_prob(
            torch_state, torch.as_tensor(row), mask=torch.as_tensor(m), **constants
        )
        jax_steps.append([np.asarray(x) for x in jax_state])
        torch_steps.append([x.numpy() for x in torch_state])
    return jax_steps, torch_steps


def _assert_same(jax_steps, torch_steps):
    for j, t in zip(jax_steps, torch_steps):
        for field in range(3):  # value, avg, var
            np.testing.assert_allclose(t[field], j[field], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(t[3], j[3])  # num
        np.testing.assert_array_equal(t[4], j[4])  # chk_int


@pytest.mark.parametrize("seed", [0, 1])
def test_submit_accept_prob_matches_jax_hmc_constants(float64, seed):
    """500 submissions for 64 lanes with the HMC constants: value, avg and
    var agree to 1e-12 in float64 at every step; num and chk_int exactly."""
    p = _prob_sequence(seed)
    value0 = np.random.default_rng(seed + 10).uniform(0.05, 0.5, 64)
    jax_steps, torch_steps = _run_both(p, value0, jax_hmc.EPS_CHK_INT, HMC_CONSTANTS)
    _assert_same(jax_steps, torch_steps)
    final = torch_steps[-1]
    # the sequences exercised both adjustment directions and the growth
    assert np.any(final[0] > value0) and np.any(final[0] < value0)
    assert np.any(final[4] != jax_hmc.EPS_CHK_INT)


def test_submit_accept_prob_matches_jax_with_mask(float64):
    """A per-step mask gates the update identically in both packages
    (Metropolis-family constants, no variance floor)."""
    p = _prob_sequence(3)
    mask = np.random.default_rng(4).uniform(size=p.shape) < 0.7
    jax_steps, torch_steps = _run_both(
        p, np.full(64, 0.3), 100, METROPOLIS_CONSTANTS, mask=mask
    )
    _assert_same(jax_steps, torch_steps)


def test_check_interval_growth_formula(float64):
    """The reference's integer growth int(growth * chk * 0.1) * 10, with
    its fixpoint at 20 for the HMC constants (15 -> 20 -> 20)."""
    state = torch_common.init_adaptive_scale(torch.full((1,), 0.1), 15)
    chks = []
    for _ in range(40):
        # p = target keeps the observed rate inside the band: always grow
        state = torch_common.submit_accept_prob(
            state, torch.full((1,), 0.65), **HMC_CONSTANTS
        )
        chks.append(int(state.chk_int[0]))
    assert chks[14] == 20 and chks[-1] == 20
    assert set(chks) == {15, 20}


def test_mu_clip_keeps_adjustment_finite_float32():
    """All-accept lanes drive mu to 1, where log(mu) = 0; the clip (which
    rounds to 1.0 in float32, as in the JAX package) still yields the
    largest adjustment, never a NaN."""
    state = torch_common.init_adaptive_scale(torch.full((4,), 0.2), 15)
    for _ in range(15):
        state = torch_common.submit_accept_prob(
            state, torch.ones(4), **HMC_CONSTANTS
        )
    assert state.value.dtype == torch.float32
    torch.testing.assert_close(state.value, torch.full((4,), 0.4))
    assert int(state.num[0]) == 0


def test_rescale_matches_jax(float64):
    rng = np.random.default_rng(5)
    value = rng.uniform(0.1, 1.0, 16)
    mask = rng.uniform(size=16) < 0.5
    j = jax_common.rescale(
        jax_common.AdaptiveScale(
            jnp.asarray(value), jnp.ones(16), jnp.ones(16),
            jnp.full(16, 3, jnp.int32), jnp.full(16, 15, jnp.int32),
        ),
        0.5, mask=jnp.asarray(mask),
    )
    t = torch_common.rescale(
        torch_common.AdaptiveScale(
            torch.as_tensor(value), torch.ones(16), torch.ones(16),
            torch.full((16,), 3, dtype=torch.int32),
            torch.full((16,), 15, dtype=torch.int32),
        ),
        0.5, mask=torch.as_tensor(mask),
    )
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adaptation_constants_match_jax():
    names = ("EPS_TARGET", "EPS_CHK_INT", "EPS_GROWTH", "EPS_VAR_FLOOR",
             "EPS_POWER", "EPS_MIN_ADJ", "EPS_MAX_ADJ")
    for name in names:
        assert getattr(torch_hmc, name) == getattr(jax_hmc, name), name
