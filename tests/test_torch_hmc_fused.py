"""Kernel B1's plain version in the PyTorch port
(inference_tpu_torch/ops/hmc_fused.py) against the JAX package's pure-jax
mirror on the same random draws, the chunked advance around it, and the
configuration gating. The kernel itself is tested on the card by
test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from inference_tpu.mcmc._kernels.common import AdaptiveScale as JaxScale
from inference_tpu.ops import hmc_fused as jax_fused
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.mcmc._kernels.hmc import init_hmc_state
from inference_tpu_torch.ops import hmc_fused
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray


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


def _problem(P, K, n, seed, dtype=np.float64, fresh=False):
    """A random SPD precision, positions, a step-size state and the draws
    of ``n`` transitions, all numpy. Without ``fresh`` the adaptation
    state is mid-run, so the chunk exercises its adjust and grow
    branches."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(P, P)) / np.sqrt(P)
    A = np.linalg.inv(B @ B.T + np.eye(P))
    A = 0.5 * (A + A.T)
    mu = rng.normal(0, 0.3, P)
    theta = rng.normal(0, 0.5, (P, K)) + mu[:, None]
    if fresh:
        eps = dict(value=np.full(K, 0.2), avg=np.zeros(K), var=np.zeros(K),
                   num=np.zeros(K, np.int32), chk_int=np.full(K, 15, np.int32))
    else:
        num = rng.integers(0, 20, K).astype(np.int32)
        eps = dict(value=rng.uniform(0.1, 0.4, K), avg=num * rng.uniform(0.4, 0.9, K),
                   var=num * 0.2, num=num,
                   chk_int=rng.choice([15, 20], K).astype(np.int32))
    draws = dict(z=rng.normal(size=(n, P, K)), us=rng.uniform(size=(n, K)),
                 ua=rng.uniform(size=(n, K)))
    cast = lambda x: x.astype(dtype) if x.dtype.kind == "f" else x
    return (cast(A), cast(mu), cast(theta), {k: cast(v) for k, v in eps.items()},
            {k: cast(v) for k, v in draws.items()})


def _jax_chunk(A, mu, theta, eps, draws, inv_temp, steps, im):
    Aj, muj = jnp.asarray(A), jnp.asarray(mu)
    logp_fn = lambda t: -0.5 * (t - muj) @ Aj @ (t - muj)
    vg = jax_fused._batch_posterior(logp_fn)
    K = theta.shape[1]
    row = lambda x: jnp.asarray(x).reshape(1, K)
    it = row(np.full(K, inv_temp, theta.dtype))
    lp = vg(jnp.asarray(theta))[0] * it
    t, lp, e, hist = jax_fused._reference_chunk(
        jnp.asarray(theta), lp, JaxScale(*(row(eps[k]) for k in JaxScale._fields)),
        it, jnp.asarray(draws["z"]), jnp.asarray(draws["us"])[:, None, :],
        jnp.asarray(draws["ua"])[:, None, :],
        logp_fn=logp_fn, steps=steps, inv_mass_diag=im,
    )
    ht, hp, hs, he = (np.asarray(h) for h in hist)
    return (np.asarray(t), np.asarray(lp)[0], [np.asarray(x)[0] for x in e],
            (ht, hp[:, 0], hs[:, 0], he[:, 0]))


def _torch_chunk(A, mu, theta, eps, draws, inv_temp, steps, im, store=True):
    form = GaussianForm(torch.as_tensor(A), torch.as_tensor(mu))
    t = torch.as_tensor(theta)
    it = torch.full((t.shape[1],), inv_temp, dtype=t.dtype)
    lp = form.value_cols(t) * it
    e = AdaptiveScale(*(torch.as_tensor(eps[k]) for k in AdaptiveScale._fields))
    imt = None if im is None else torch.as_tensor(im, dtype=t.dtype)
    t, lp, e, hist = hmc_fused._reference_chunk(
        t, lp, e, it, *(torch.as_tensor(draws[k]) for k in ("z", "us", "ua")),
        form=form, steps=steps, inv_mass_diag=imt, store=store,
    )
    hist = None if hist is None else tuple(h.numpy() for h in hist)
    return t.numpy(), lp.numpy(), [x.numpy() for x in e], hist


def _assert_chunks_match(ours, theirs, rtol, atol):
    (t1, lp1, e1, h1), (t2, lp2, e2, h2) = ours, theirs
    np.testing.assert_allclose(t1, t2, rtol=rtol, atol=atol)
    np.testing.assert_allclose(lp1, lp2, rtol=rtol, atol=atol)
    for a, b in zip(e1[:3], e2[:3]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(e1[3], e2[3])
    np.testing.assert_array_equal(e1[4], e2[4])
    np.testing.assert_allclose(h1[0], h2[0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(h1[1], h2[1], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(h1[2], h2[2])
    np.testing.assert_allclose(h1[3], h2[3], rtol=rtol, atol=atol)


# diagonal inverse masses whose momentum scales 1/sqrt(m) are exact in
# float32 (the JAX package computes them in float32 even under x64)
_MASSES = (1.0, 4.0, 0.25, 16.0, 0.0625, 64.0, 1.0, 4.0, 0.25, 16.0)


@pytest.mark.parametrize("P", [3, 10])
@pytest.mark.parametrize("diag_mass", [False, True])
@pytest.mark.parametrize("inv_temp", [1.0, 0.5])
def test_reference_chunk_matches_jax_float64(float64, P, diag_mass, inv_temp):
    """16 transitions of 128 chains from a mid-adaptation state: the final
    state and the history agree with the JAX mirror to 1e-10 in float64,
    step counts and adaptation counters exactly."""
    A, mu, theta, eps, draws = _problem(P, 128, 16, seed=P + int(10 * inv_temp))
    im = np.asarray(_MASSES[:P]) if diag_mass else None
    ours = _torch_chunk(A, mu, theta, eps, draws, inv_temp, 12, im)
    theirs = _jax_chunk(A, mu, theta, eps, draws, inv_temp, 12, im)
    _assert_chunks_match(ours, theirs, rtol=1e-10, atol=1e-12)
    # proposals were both accepted and rejected, and the step size adapted
    moved = (ours[3][0] != np.concatenate([theta[None], ours[3][0][:-1]])).any(axis=1)
    assert 0.0 < moved.mean() < 1.0
    assert np.any(ours[2][0] != eps["value"])


def test_reference_chunk_matches_jax_float32():
    """11 transitions in float32 from a fresh adaptation state: agreement to
    float32 roundoff over ~130 leapfrog steps (the tolerances of the JAX
    package's own kernel-vs-mirror test)."""
    A, mu, theta, eps, draws = _problem(3, 128, 11, seed=7, dtype=np.float32, fresh=True)
    ours = _torch_chunk(A, mu, theta, eps, draws, 1.0, 12, None)
    theirs = _jax_chunk(A, mu, theta, eps, draws, 1.0, 12, None)
    assert ours[0].dtype == np.float32 and theirs[0].dtype == np.float32
    _assert_chunks_match(ours, theirs, rtol=2e-5, atol=2e-6)


def test_reference_chunk_store_false_matches_store_true(float64):
    A, mu, theta, eps, draws = _problem(4, 64, 6, seed=2)
    with_hist = _torch_chunk(A, mu, theta, eps, draws, 1.0, 10, None, store=True)
    without = _torch_chunk(A, mu, theta, eps, draws, 1.0, 10, None, store=False)
    assert without[3] is None
    np.testing.assert_array_equal(with_hist[0], without[0])
    np.testing.assert_array_equal(with_hist[1], without[1])


def test_step_count_never_below_one(float64):
    """At steps=1 a jittered count of 0 is raised to one drift, as the
    batched transition of mcmc/_kernels/hmc.py takes."""
    A, mu, theta, eps, draws = _problem(2, 64, 4, seed=3)
    draws["us"][:] = 0.01  # int(1 * 0.902) == 0
    _, _, _, hist = _torch_chunk(A, mu, theta, eps, draws, 1.0, 1, None)
    assert (hist[2] == 1).all()
    assert np.any(hist[0][0] != theta)


# --------------------------------------------------------------------- #
# GaussianForm
# --------------------------------------------------------------------- #
def test_gaussian_form_value_and_gradient(float64):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 4))  # not symmetric: the form symmetrises it
    mu = rng.normal(size=4)
    form = GaussianForm(torch.as_tensor(A), torch.as_tensor(mu))
    S = 0.5 * (A + A.T)
    theta = rng.normal(size=(5, 4))
    want = -0.5 * np.einsum("kp,pq,kq->k", theta - mu, S, theta - mu)
    np.testing.assert_allclose(form(torch.as_tensor(theta)).numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(form(torch.as_tensor(theta[0])).numpy(), want[0], rtol=1e-12)
    grad = torch.func.vmap(torch.func.grad(form))(torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(grad, -(theta - mu) @ S, rtol=1e-12)
    cols = torch.as_tensor(theta.T.copy())
    np.testing.assert_allclose(form.value_cols(cols).numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(form.grad_cols(cols).numpy(), grad.T, rtol=1e-12)


def test_gaussian_form_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        GaussianForm(torch.ones(2, 3))


# --------------------------------------------------------------------- #
# the chunked advance
# --------------------------------------------------------------------- #
def _state(K, P, seed=3):
    rng = np.random.default_rng(seed)
    form = GaussianForm(torch.eye(P))
    theta = torch.as_tensor(rng.normal(0, 0.5, (K, P)), dtype=torch.float32)
    return init_hmc_state(theta, form(theta), 0.2, steps=10), form


def test_fused_chunking_consistent_state_shape():
    """Advances longer than one chunk run several chunks (here 4 + 4 + 2)
    and keep shapes and dtypes."""
    state, form = _state(128, 2)
    plan = hmc_fused.plan_fused_hmc(form, 2, steps=10, chunk=4)
    s, hist = hmc_fused.fused_hmc_advance(plan, state, 10, True, torch.Generator())
    assert hist[0].shape == (10, 128, 2)
    assert hist[1].shape == (10, 128)
    assert hist[2].shape == (10, 128) and hist[2].dtype == torch.int32
    assert hist[3].shape == (10, 128)
    assert s.theta.shape == state.theta.shape
    assert s.theta.dtype == state.theta.dtype
    assert s.eps.num.dtype == torch.int32


def test_fused_store_false_matches_store_true():
    state, form = _state(128, 2)
    plan = hmc_fused.plan_fused_hmc(form, 2, steps=10, chunk=4)
    s1, _ = hmc_fused.fused_hmc_advance(plan, state, 7, True, torch.Generator().manual_seed(1))
    s2, none = hmc_fused.fused_hmc_advance(plan, state, 7, False, torch.Generator().manual_seed(1))
    assert none is None
    torch.testing.assert_close(s1.theta, s2.theta, rtol=0, atol=0)
    torch.testing.assert_close(s1.eps.value, s2.eps.value, rtol=0, atol=0)


def test_fused_advance_zero_returns_empty_history():
    state, form = _state(16, 3)
    plan = hmc_fused.plan_fused_hmc(form, 3, steps=10)
    s, hist = hmc_fused.fused_hmc_advance(plan, state, 0, True, torch.Generator())
    assert [tuple(h.shape) for h in hist] == [(0, 16, 3), (0, 16), (0, 16), (0, 16)]
    torch.testing.assert_close(s.theta, state.theta)


def test_fused_advance_equals_mirror_on_cpu():
    """On a CPU state the fused advance is the plain version, drawing the
    same numbers as the mirror from the same generator state."""
    state, form = _state(32, 3)
    plan = hmc_fused.plan_fused_hmc(form, 3, steps=10, chunk=3)
    a = hmc_fused.fused_hmc_advance(plan, state, 5, True, torch.Generator().manual_seed(9))
    b = hmc_fused._advance_mirror(plan, state, 5, True, torch.Generator().manual_seed(9))
    for x, y in zip(a[1], b[1]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_launch_wrapper_rejects_float64_and_cpu(float64):
    """The kernel wrapper never casts: float64 operands raise, and a CPU
    tensor never reaches the CUDA library."""
    A, mu, theta, eps, draws = _problem(3, 8, 2, seed=1)
    form = GaussianForm(torch.as_tensor(A), torch.as_tensor(mu))
    t = torch.as_tensor(theta)
    e = AdaptiveScale(*(torch.as_tensor(eps[k]) for k in AdaptiveScale._fields))
    args = (t, form.value_cols(t), e, torch.ones(8), *(torch.as_tensor(draws[k]) for k in ("z", "us", "ua")))
    kw = dict(form=form, steps=5, inv_mass_diag=None, store=False)
    with pytest.raises(TypeError, match="float64"):
        hmc_fused._launch_chunk(*args, **kw)
    f32 = lambda x: x.float() if x.is_floating_point() else x
    form32 = GaussianForm(form.A.float(), form.mu.float()).float()
    args32 = (f32(args[0]), f32(args[1]), AdaptiveScale(*map(f32, e)), *map(f32, args[3:]))
    with pytest.raises(ValueError, match="CUDA"):
        hmc_fused._launch_chunk(*args32, **dict(kw, form=form32))


# --------------------------------------------------------------------- #
# the wide route's planner (P > 64) and padded form
# --------------------------------------------------------------------- #
P_MAX_WIDE = hmc_fused.SMEM_WARPS // 16  # 12,800, the largest P the wide route takes


@pytest.mark.parametrize("K", [65536, 16384, 4096, 1000, 7, 1])
@pytest.mark.parametrize("P", [65, 100, 200, 256, 1000, P_MAX_WIDE])
def test_wide_plan_fits_shared_memory(P, K):
    """Every plan fits a block's 227 KB of shared memory (the warp kernel's
    200 KB) with at least one chain a block and threads enough for the
    tiles and the chains' owners; a tiled plan's shared memory is what the
    launcher computes, and K below the block's chains gets one block."""
    plan = hmc_fused.wide_plan(P, K)
    assert plan.chains >= 1 and plan.blocks == -(-K // plan.chains)
    assert plan.rows == -(-P // 8) * 8 and plan.depth >= P
    if plan.tiled:
        assert plan.smem == hmc_fused._tile_smem(plan.rows, plan.depth, plan.chains, plan.slab,
                                                 plan.stages) <= hmc_fused.SMEM_BLOCK
        assert plan.chains % 4 == 0 and plan.chains <= plan.threads <= hmc_fused.TILE_THREADS
        assert plan.threads == plan.rows // 8 * plan.chains // 4
        assert plan.depth % max(plan.slab, 4) == 0 and plan.depth <= -(-P // 16) * 16
        assert (plan.slab, plan.stages) in ((0, 0), *hmc_fused.RINGS)
    else:
        assert plan.smem <= hmc_fused.SMEM_WARPS and plan.depth == plan.rows
        assert plan.threads == 32 * plan.chains
    if K < plan.chains:
        assert plan.blocks == 1


@pytest.mark.parametrize("K", [65536, 16384, 4096, 1000, 1])
def test_wide_plan_chains_never_grow_with_p(K):
    """As P grows the plan's chains a block never grow, the tiled kernel
    serves every P up to 2,048 and the warp-per-chain kernel every P above,
    up to 12,800; a larger P raises."""
    Ps = sorted({*range(65, 1500), *range(1500, P_MAX_WIDE, 37), 2048, 2049, P_MAX_WIDE})
    plans = [hmc_fused.wide_plan(P, K) for P in Ps]
    assert all(b.chains <= a.chains for a, b in zip(plans, plans[1:]))
    tiled = [P for P, p in zip(Ps, plans) if p.tiled]
    assert tiled == Ps[:len(tiled)] and tiled[-1] == 2048
    with pytest.raises(ValueError, match="12800"):
        hmc_fused.wide_plan(P_MAX_WIDE + 1, K)


@pytest.mark.parametrize("K", [65536, 16384, 4096, 1000, 1])
def test_wide_plan_resident_exactly_where_a_fits(K):
    """A tiled plan keeps A resident exactly where A fits beside the block's
    tiles at the plan's chains, in the plan's share of an SM (half of it
    where two blocks fit, else all), and streams it above; at the main
    path's K A is resident at P = 65 and 100 and streamed at 256."""
    for P in range(65, 1200):
        plan = hmc_fused.wide_plan(P, K)
        if not plan.tiled:
            break
        budget = (hmc_fused.SMEM_HALF if plan.smem <= hmc_fused.SMEM_HALF
                  else hmc_fused.SMEM_BLOCK)
        fits = hmc_fused._tile_smem(plan.rows, -(-P // 4) * 4, plan.chains, 0, 0)
        assert (plan.stages == 0) == (fits <= budget), P
    if K == 65536:
        assert [hmc_fused.wide_plan(P, K).stages == 0 for P in (65, 100, 256)] == [
            True, True, False]


@pytest.mark.parametrize("P, diag", [(65, False), (100, True), (257, True)])
def test_wide_form_is_the_form_zero_padded(P, diag):
    """The wide route's padded form holds A, mu and the inverse mass in its
    leading block and zeros elsewhere, as float32; a plan on the CPU makes
    none (the plain version runs there)."""
    rng = np.random.default_rng(P)
    form = GaussianForm(torch.as_tensor(rng.normal(size=(P, P))), torch.as_tensor(rng.normal(size=P)))
    im = torch.as_tensor(rng.uniform(0.5, 2.0, P)) if diag else None
    w = hmc_fused.wide_form(form, im)
    rows, depth = -(-P // 8) * 8, -(-P // 16) * 16
    assert w.A.shape == (depth, rows) and w.mu.shape == (rows,) and w.A.dtype == torch.float32
    torch.testing.assert_close(w.A[:P, :P], form.A.float())
    torch.testing.assert_close(w.mu[:P], form.mu.float())
    assert not w.A[P:].any() and not w.A[:, P:].any() and not w.mu[P:].any()
    if diag:
        torch.testing.assert_close(w.inv_mass[:P], im.float())
        assert not w.inv_mass[P:].any()
    else:
        assert w.inv_mass is None
    assert hmc_fused.plan_fused_hmc(form, P, steps=10).padded is None


# --------------------------------------------------------------------- #
# gating
# --------------------------------------------------------------------- #
def test_fused_gating():
    """Unsupported configurations raise with the reason for fused=True;
    'auto' keeps the batched transition."""
    form = GaussianForm(torch.eye(2))
    starts = np.zeros((8, 2)) + 0.1

    with pytest.raises(ValueError, match="retry"):
        ChainArray("hmc", form, starts, retry=True, fused=True, device="cpu")
    with pytest.raises(ValueError, match="full-matrix"):
        ChainArray("hmc", form, starts, retry=False, fused=True, inverse_mass=np.eye(2), device="cpu")
    with pytest.raises(ValueError, match="fused=True is only available for the 'hmc' kind"):
        ChainArray("gibbs", form, starts, fused=True, device="cpu")
    with pytest.raises(ValueError, match="GaussianForm"):
        ChainArray("hmc", lambda t: -0.5 * (t * t).sum(), starts, retry=False, fused=True, device="cpu")
    # any P takes the kernel, as in the JAX package (the wide route above 64)
    wide = ChainArray("hmc", GaussianForm(torch.eye(65)), np.zeros((4, 65)),
                      retry=False, fused=True, device="cpu")
    assert wide._fused_plan is not None

    ca = ChainArray("hmc", form, starts, retry=False, fused="auto", device="cpu")
    assert ca._fused_plan is None
    ca.advance(3, store=True)
    assert ca.get_sample().shape == (24, 2)


def test_fused_set_inverse_mass_rebuilds_plan():
    form = GaussianForm(torch.eye(2))
    ca = ChainArray("hmc", form, np.zeros((16, 2)) + 0.1, retry=False, fused=True, seed=0, device="cpu")
    assert ca._fused_plan.inv_mass_diag is None
    ca.set_inverse_mass(np.array([1.0, 4.0]))
    assert ca._fused_plan.inv_mass_diag == (1.0, 4.0)
    ca.advance(3, store=True)
    assert ca.get_sample().shape == (3 * 16, 2)


def test_fused_chain_array_at_one_hundred_parameters_matches_jax(float64):
    """ChainArray(fused=True) with a 100-parameter GaussianForm runs on the
    CPU (kernel B1's plain version; the card takes B1's wide route), and its
    advance equals the JAX package's CPU route for fused chunks of fewer than
    128 chains (``_reference_chunk``) on the same draws, to 1e-10 in
    float64."""
    P, K, n, steps = 100, 48, 3, 10
    rng = np.random.default_rng(100)
    B = rng.normal(size=(P, P)) / np.sqrt(P)
    A = np.linalg.inv(B @ B.T + np.eye(P))
    mu = rng.normal(0, 0.3, P)
    starts = mu + rng.normal(0, 0.3, (K, P))
    ca = ChainArray("hmc", GaussianForm(torch.as_tensor(A), torch.as_tensor(mu)), starts,
                    steps=steps, epsilon=0.15, retry=False, fused=True, seed=4, device="cpu")
    assert ca._fused_plan is not None
    state0 = ca._state
    ca.advance(n, store=True)

    # the draws the advance took: one chunk, from the array's generator seed
    gen = torch.Generator().manual_seed(4)
    z = torch.randn((n, P, K), generator=gen)
    us, ua = torch.rand((n, K), generator=gen), torch.rand((n, K), generator=gen)
    eps = {f: getattr(state0.eps, f).numpy() for f in AdaptiveScale._fields}
    draws = {"z": z.numpy(), "us": us.numpy(), "ua": ua.numpy()}
    t, lp, e, hist = _jax_chunk(A, mu, state0.theta.numpy().T.copy(), eps, draws, 1.0,
                                steps, None)
    np.testing.assert_allclose(ca.theta, t.T, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ca.logp, lp, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ca._state.eps.value.numpy(), e[0], rtol=1e-10)
    np.testing.assert_allclose(np.concatenate(ca._history), np.swapaxes(hist[0], 1, 2),
                               rtol=1e-10, atol=1e-12)
    moved = (np.abs(np.diff(np.concatenate(ca._history), axis=0)).max(axis=2) > 0).mean()
    assert 0.0 < moved < 1.0
