"""The GP path's operations in the PyTorch port against the JAX package:
kernel B2's plain version (inference_tpu_torch/ops/pairwise.py) against the
Pallas kernel in interpret mode, the autograd.Function's gradients against
the JAX custom VJP, the dispatch, the blocked factorisations of
ops/linalg.py, and the covariance and mean functions. All in float64; the
kernel itself is tested on the card by test_torch_cuda.py.

Tolerances: 1e-12 relative where both sides run the same arithmetic in the
same order (only exp and libm may differ by an ulp); 1e-9 where one side
uses the matmul form of the squared distances (cancellation of |u|^2 +
|v|^2 - 2 u.v costs a few digits); 1e-8 for gradients, the BASELINE
contract."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from inference_tpu import gp as jgp
from inference_tpu.ops import linalg as jlinalg
from inference_tpu.ops import pairwise as jpairwise
from inference_tpu_torch import gp as tgp
from inference_tpu_torch.ops import linalg, pairwise


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


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(port, ref, rtol):
    """Element-wise within ``rtol``, with an absolute floor of ``rtol``
    times the largest reference value (for entries near zero)."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _inputs(m, n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, d)), rng.normal(size=(n, d)), 1.3, rng.uniform(0.6, 1.5, d)


@pytest.mark.parametrize("m, n, d", [(300, 260, 3), (520, 137, 1), (200, 130, 20)])
def test_sqexp_reference_matches_pallas_interpret(m, n, d):
    """B2's plain version against the Pallas kernel in interpret mode on
    ragged sizes: the same exact differences in the same order, 1e-12."""
    u, v, amp, ls = _inputs(m, n, d, seed=m)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpairwise._sqexp_pallas(jnp.asarray(u), jnp.asarray(v), amp,
                                                 jnp.asarray(ls)))
    got = pairwise._sqexp_reference(t(u), t(v), t(amp), t(ls))
    close(got, ref, 1e-12)


@pytest.mark.parametrize("same", [True, False])
def test_sqexp_function_gradients_match_pallas_custom_vjp(same):
    """SqexpCovariance's amplitude, lengthscale and position gradients
    against jax.grad of _sqexp_pallas_diff in interpret mode, for K(u, u)
    and K(u, v)."""
    u, v, amp, ls = _inputs(40, 48, 3, seed=11)
    if same:
        v = u
    kbar = np.random.default_rng(2).normal(size=(40, v.shape[0]))

    def jloss(u_, v_, a_, l_):
        return jnp.sum(jpairwise._sqexp_pallas_diff(u_, v_ if not same else u_, a_, l_) * kbar)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(amp), jnp.asarray(ls))
    leaves = [t(a).requires_grad_(True) for a in (u, v, amp, ls)]
    tu, tv, ta, tl = leaves
    K = pairwise.SqexpCovariance.apply(tu, tu if same else tv, ta, tl)
    (K * t(kbar)).sum().backward()
    close(ta.grad, ref[2], 1e-8)
    close(tl.grad, ref[3], 1e-8)
    close(tu.grad, ref[0], 1e-8)
    if not same:
        close(tv.grad, ref[1], 1e-8)


def test_sqexp_function_skips_unneeded_position_pass(monkeypatch):
    """With positions that need no gradient, the backward never runs the
    position pass."""
    calls = []
    monkeypatch.setattr(pairwise, "_sqexp_position_backward",
                        lambda *a: calls.append(1) or (None, None))
    u, _, amp, ls = _inputs(30, 1, 2, seed=5)
    ta, tl = t(amp).requires_grad_(True), t(ls).requires_grad_(True)
    pairwise.SqexpCovariance.apply(t(u), t(u), ta, tl).sum().backward()
    assert calls == [] and ta.grad is not None and tl.grad is not None


@pytest.mark.parametrize("m, n, through_function", [(2048, 2050, True), (2047, 2100, False)])
def test_sqexp_covariance_dispatch(m, n, through_function):
    """Blocks with both sides >= 2048 rows go through SqexpCovariance (B2's
    plain version on the CPU), smaller ones through the matmul form; both
    match the JAX package's sqexp_covariance (the matmul form off the TPU)
    to 1e-9."""
    u, v, amp, ls = _inputs(m, n, 2, seed=m)
    ta = t(amp).requires_grad_(True)
    K = pairwise.sqexp_covariance(t(u), t(v), ta, t(ls))
    assert (type(K.grad_fn).__name__ == "SqexpCovarianceBackward") == through_function
    ref = np.asarray(jpairwise.sqexp_covariance(u, v, amp, jnp.asarray(ls)))
    close(K.detach(), ref, 1e-9)


def test_sqexp_covariance_at_twenty_features_matches_jax():
    """D = 20 through SqexpCovariance (B2's plain version on the CPU; on the
    card the wide library of kernel B2), where the port raised before:
    against the JAX package's sqexp_covariance to 1e-9, and the amplitude
    and lengthscale gradients against jax.grad of it to 1e-8."""
    u, v, amp, ls = _inputs(2048, 2050, 20, seed=20)
    ls = ls * 4.0  # a well-filled block at D = 20
    kbar = np.random.default_rng(21).normal(size=(2048, 2050))
    ta, tl = t(amp).requires_grad_(True), t(ls).requires_grad_(True)
    K = pairwise.sqexp_covariance(t(u), t(v), ta, tl)
    assert type(K.grad_fn).__name__ == "SqexpCovarianceBackward"
    ref = np.asarray(jpairwise.sqexp_covariance(u, v, amp, jnp.asarray(ls)))
    assert np.median(ref) > 1e-3
    close(K.detach(), ref, 1e-9)
    (K * t(kbar)).sum().backward()
    g_amp, g_ls = jax.grad(
        lambda a_, l_: jnp.sum(jpairwise.sqexp_covariance(u, v, a_, l_) * kbar), argnums=(0, 1)
    )(jnp.asarray(amp), jnp.asarray(ls))
    close(ta.grad, g_amp, 1e-8)
    close(tl.grad, g_ls, 1e-8)


# (m, n) with ragged row and column tiles in both dtypes, and one tile
PLAN_SHAPES = [(16_384, 16_384), (3001, 2500), (3001, 2501), (37, 300), (1, 1), (4096, 255),
               (2048, 2050)]


def _b2_source(name):
    """The integer constant ``name`` of csrc/sqexp.cu."""
    src = (Path(pairwise.__file__).with_name("csrc") / "sqexp.cu").read_text()
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def _b2_minb(lib_d):
    """csrc/sqexp.cu's MINB for the library of B2_D = ``lib_d``, evaluated
    from its source: ``D >= 1 && D <= x ? a : b``."""
    src = (Path(pairwise.__file__).with_name("csrc") / "sqexp.cu").read_text()
    x, a, b = map(int, re.search(r"MINB = D >= 1 && D <= (\d+) \? (\d+) : (\d+);",
                                 src).groups())
    return a if 1 <= lib_d <= x else b


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("d", [2, 5, 16, 17])
@pytest.mark.parametrize("m, n", PLAN_SHAPES)
def test_sqexp_plan_covers_every_tile_once(m, n, d, dtype, sms):
    """Kernel B2's plan, which the kernel takes as given: tiles of 1 KiB
    rows, every output entry in exactly one tile of the row-major walk
    (block b takes tiles b, b + blocks, ...), as many blocks per SM as the
    library of its D is built to fit (the table csrc/sqexp.cu holds) and
    none without a tile; 16-byte stores only where a row of the output is
    whole 16-byte units."""
    plan = pairwise.sqexp_plan(m, n, d, dtype, sms)
    size = dtype.itemsize
    assert plan.tile_n * size == 1024 and plan.tile_m == pairwise.B2_TILE_M == _b2_source("TM")
    n_tiles = plan.tiles_m * plan.tiles_n
    assert plan.blocks == min(n_tiles, sms * _b2_minb(d if d <= pairwise.B2_D_REG else 0))
    walked = [t for b in range(plan.blocks) for t in range(b, n_tiles, plan.blocks)]
    assert sorted(walked) == list(range(n_tiles))
    # the tiles reach past the last row and column, and one fewer would not
    assert (plan.tiles_m - 1) * plan.tile_m < m <= plan.tiles_m * plan.tile_m
    assert (plan.tiles_n - 1) * plan.tile_n < n <= plan.tiles_n * plan.tile_n
    if m * n <= 1 << 24:
        covered = np.zeros((m, n), dtype=np.int8)
        for t_ in walked:
            r0, c0 = t_ // plan.tiles_n * plan.tile_m, t_ % plan.tiles_n * plan.tile_n
            covered[r0:r0 + plan.tile_m, c0:c0 + plan.tile_n] += 1
        assert (covered == 1).all()
    assert plan.route == ("vector" if n * size % 16 == 0 else "scalar")
    assert pairwise.ROUTES == {"scalar": _b2_source("SCALAR"), "vector": _b2_source("VECTOR")}


def test_scaled_sq_distances_and_fallback_match_jax():
    u, v, amp, ls = _inputs(33, 17, 4, seed=0)
    close(pairwise.scaled_sq_distances(t(u), t(v), t(ls)),
          jpairwise.scaled_sq_distances(u, v, ls), 1e-12)
    close(pairwise._sqexp_fallback(t(u), t(v), t(amp), t(ls)),
          jpairwise._sqexp_fallback(jnp.asarray(u), jnp.asarray(v), amp, jnp.asarray(ls)), 1e-12)


def _spd(n, seed):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("method, remat", [("inv", True), ("trsm", False)])
def test_blocked_cholesky_matches_jax(method, remat):
    """blocked_cholesky on a padded size above one block, and the logdet
    gradient through it, against the JAX package's."""
    K = _spd(200, seed=3)
    kw = dict(block=64, method=method, remat=remat)
    logdet = jax.jit(lambda A: jnp.log(jnp.diag(jlinalg.blocked_cholesky(A, **kw))).sum())
    ref = jax.jit(lambda A: jlinalg.blocked_cholesky(A, **kw))(jnp.asarray(K))
    close(linalg.blocked_cholesky(t(K), **kw), ref, 1e-10)

    tK = t(K).requires_grad_(True)
    torch.log(torch.diagonal(linalg.blocked_cholesky(tK, **kw))).sum().backward()
    close(tK.grad, jax.grad(logdet)(jnp.asarray(K)), 1e-8)


def test_blocked_cholesky_failure_is_nan():
    K = _spd(300, seed=4)
    K[200, 200] = -1.0
    assert bool(torch.isnan(linalg.blocked_cholesky(t(K), block=128)).any())
    assert bool(torch.isnan(linalg.cholesky_or_nan(t(K))).all())


@pytest.mark.parametrize("n, block", [(300, 128), (256, 128), (100, 128)])
def test_blocked_tril_inverse_and_gram_match_jax(n, block):
    """blocked_tril_inverse and tril_gram against their JAX counterparts
    across padded, exact-multiple and single-block sizes."""
    L = np.linalg.cholesky(_spd(n, seed=n))
    X = linalg.blocked_tril_inverse(t(L), block=block)
    close(X, jlinalg.blocked_tril_inverse(jnp.asarray(L), block=block), 1e-10)
    G = linalg.tril_gram(X, block=block)
    close(G, jlinalg.tril_gram(jnp.asarray(np.asarray(X)), block=block), 1e-10)
    close(G, np.linalg.inv(L @ L.T), 1e-9)


def test_add_diagonal_and_identity():
    K = np.random.default_rng(1).normal(size=(5, 5))
    close(linalg.add_diagonal(t(K), t(np.arange(5.0))), K + np.diag(np.arange(5.0)), 1e-15)
    close(linalg.add_diagonal(t(K), 2.0), jlinalg.add_diagonal(jnp.asarray(K), 2.0), 1e-15)
    close(linalg.identity_like(t(K)), np.eye(5), 1e-15)


KERNELS = {
    "sqexp": (tgp.SquaredExponential, jgp.SquaredExponential),
    "rq": (tgp.RationalQuadratic, jgp.RationalQuadratic),
    "white": (tgp.WhiteNoise, jgp.WhiteNoise),
    "hetero": (tgp.HeteroscedasticNoise, jgp.HeteroscedasticNoise),
    "sum": (lambda: tgp.SquaredExponential() + tgp.WhiteNoise(),
            lambda: jgp.SquaredExponential() + jgp.WhiteNoise()),
    "change_point": (lambda: tgp.ChangePoint([tgp.SquaredExponential, tgp.SquaredExponential]),
                     lambda: jgp.ChangePoint([jgp.SquaredExponential, jgp.SquaredExponential])),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_covariance_functions_match_jax(name):
    """Bounds, build_covariance, __call__ and covariance_and_gradients of
    every covariance class against the JAX package's."""
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 2, (12, 2)), rng.normal(size=12)
    q = rng.uniform(0, 2, (5, 2))
    kt, kj = (f() for f in KERNELS[name])
    for k in (kt, kj):
        k.pass_spatial_data(x)
        k.estimate_hyperpar_bounds(y)
    assert kt.bounds == kj.bounds and kt.n_params == kj.n_params
    lwr, upr = np.array(kj.bounds).T
    theta = lwr + (upr - lwr) * rng.random(lwr.size)
    # the JAX side runs jitted: one compilation instead of one per operation
    jbuild = jax.jit(lambda th: (kj.build_covariance(th), kj(q, x, th)))
    Kj_build, Kj_call = jbuild(jnp.asarray(theta))
    close(kt.build_covariance(t(theta)), Kj_build, 1e-12)
    close(kt(t(q), t(x), t(theta)), Kj_call, 1e-12)
    K, grads = kt.covariance_and_gradients(t(theta))
    if name == "hetero":  # lazy gradients
        Kj, grads_j = kj.covariance_and_gradients(jnp.asarray(theta))
    else:
        Kj, grads_j = jax.jit(kj.covariance_and_gradients)(jnp.asarray(theta))
    close(K, Kj, 1e-12)
    assert len(grads) == len(grads_j) == theta.size
    for g, gj in zip(grads, grads_j):
        close(g, gj, 1e-10)


def test_covariance_and_gradients_takes_the_matmul_form(monkeypatch):
    """Where build_covariance goes through SqexpCovariance (here with the
    gate lowered to 16 rows), which forward-mode autodiff cannot pass,
    covariance_and_gradients takes the matmul form and matches the JAX
    package."""
    monkeypatch.setattr(pairwise, "_PALLAS_MIN_N", 16)
    x = np.random.default_rng(1).uniform(0, 5, (40, 1))
    kt, kj = tgp.SquaredExponential(), jgp.SquaredExponential()
    kt.pass_spatial_data(x)
    kj.pass_spatial_data(jnp.asarray(x))
    theta = np.array([0.2, -0.1])
    assert type(kt.build_covariance(t(theta).requires_grad_(True)).grad_fn).__name__ != (
        "SqexpCovarianceBackward")  # add_diagonal sits on top of it
    K, grads = kt.covariance_and_gradients(t(theta))
    Kj, grads_j = jax.jit(kj.covariance_and_gradients)(jnp.asarray(theta))
    close(K, Kj, 1e-9)
    for g, gj in zip(grads, grads_j):
        close(g, gj, 1e-9)
    assert not pairwise._MATMUL_FORM.get()


@pytest.mark.parametrize("name", ["ConstantMean", "LinearMean", "QuadraticMean"])
def test_mean_functions_match_jax(name):
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, 2, (15, 2)), rng.normal(size=15)
    mt, mj = getattr(tgp, name)(), getattr(jgp, name)()
    for mf in (mt, mj):
        mf.pass_spatial_data(x)
        mf.estimate_hyperpar_bounds(y)
    assert mt.bounds == mj.bounds and mt.hyperpar_labels == mj.hyperpar_labels
    theta = rng.normal(size=mt.n_params)
    q = rng.uniform(0, 2, 2)
    ref = jax.jit(lambda th, xx, qq: (
        mj.build_mean(th), mj.vector(xx, th), mj.point(qq, th, xx), mj(qq, th),
        mj.mean_and_gradients(th)))(jnp.asarray(theta), jnp.asarray(x), jnp.asarray(q))
    got = (mt.build_mean(t(theta)), mt.vector(t(x), t(theta)), mt.point(t(q), t(theta), t(x)),
           mt(t(q), t(theta)))
    for a, b in zip(got, ref[:4]):
        close(a, b, 1e-13)
    mu, grads = mt.mean_and_gradients(t(theta))
    close(mu, ref[4][0], 1e-13)
    for g, gj in zip(grads, ref[4][1]):
        close(g, gj, 1e-13)
