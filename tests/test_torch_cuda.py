"""Kernels B1 (inference_tpu_torch/ops/csrc/hmc_fused.cu), B2
(inference_tpu_torch/ops/csrc/sqexp.cu), B3-B8 (ops/csrc/sqexp_fused.cu,
sqexp_entries.cu, sqexp_stored.cu) and the probes P1-P3 (issue_probe.cu,
sqexp_ablate.cu, sqexp_words_mma.cu) on a CUDA device: each against its
plain PyTorch version on the same inputs, its launch count and its input
checks; the fused ChainArray, the GpRegressor and the LargeScaleGP end to
end.

Every test here needs the card and carries the ``cuda`` marker; without a
card each one skips. The file imports only the port (not the JAX package),
so it runs on a machine with CUDA torch alone:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from inference_tpu_torch.gp import GpRegressor, LargeScaleGP
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.ops import df64, hmc_fused, pairwise
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.probes import df64_ablate, vpu_probe
from inference_tpu_torch.probes import df64_mxu_d2_experiment as p3

RTOL, ATOL = 1e-4, 1e-5  # float32 kernel vs float32 plain version


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels B1-B8 and P1-P3 have no CPU form)")
    return torch.device("cuda")


def _chunk_inputs(device, P, K, chunk, inv_temp, seed):
    """A mid-adaptation float32 state of K chains on a random P-dim
    Gaussian form, and the draws of ``chunk`` transitions."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(P, P)) / np.sqrt(P)
    cov = B @ B.T + np.eye(P)
    dev = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt).to(device)
    form = GaussianForm(dev(np.linalg.inv(cov)), dev(rng.normal(0, 0.3, P))).to(device)
    theta = dev(rng.multivariate_normal(np.zeros(P), cov, K).T.copy())
    num = rng.integers(0, 20, K)
    eps = AdaptiveScale(
        dev(rng.uniform(0.1, 0.3, K)), dev(num * rng.uniform(0.4, 0.9, K)),
        dev(num * 0.2), dev(num, torch.int32), dev(rng.choice([15, 20], K), torch.int32),
    )
    it = torch.full((K,), inv_temp, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((chunk, P, K), generator=gen, device=device)
    us = torch.rand((chunk, K), generator=gen, device=device)
    ua = torch.rand((chunk, K), generator=gen, device=device)
    return form, (theta, form.value_cols(theta) * it, eps, it, z, us, ua)


def _close(a, b):
    return torch.isclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P, K, inv_temp, diag_mass",
    [(10, 65536, 1.0, False), (32, 4096, 0.5, True), (3, 1000, 1.0, True)],
)
def test_kernel_matches_plain_one_transition(cuda, P, K, inv_temp, diag_mass):
    """One transition: position, logp and step size within tolerance and the
    adaptation counters equal on >= 99.9% of chains (both P_MAX
    instantiations, unit and diagonal mass, a ragged last block)."""
    form, args = _chunk_inputs(cuda, P, K, 1, inv_temp, seed=P)
    im = (torch.as_tensor(np.random.default_rng(5).uniform(0.5, 2.0, P),
                          dtype=torch.float32, device=cuda) if diag_mass else None)
    kw = dict(form=form, steps=50, inv_mass_diag=im, store=False)
    before = hmc_fused.KERNEL_LAUNCHES
    k = hmc_fused._launch_chunk(*args, **kw)
    p = hmc_fused._reference_chunk(*args, **kw)
    torch.cuda.synchronize()
    assert hmc_fused.KERNEL_LAUNCHES == before + 1
    ok = _close(k[0], p[0]).all(dim=0) & _close(k[1], p[1]) & _close(k[2].value, p[2].value)
    ok &= (k[2].num == p[2].num) & (k[2].chk_int == p[2].chk_int)
    assert float(ok.float().mean()) >= 0.999


@pytest.mark.cuda
def test_kernel_matches_plain_stored_chunk(cuda):
    """A stored 64-transition chunk: the first transition and every step
    count agree per chain, and the accept fraction of every transition
    agrees to 1e-3 (single chains drift apart over a chunk at float32
    roundoff, as the plain version does from itself in float64)."""
    form, args = _chunk_inputs(cuda, 10, 16384, 64, 1.0, seed=12)
    kw = dict(form=form, steps=50, inv_mass_diag=None, store=True)
    hk = hmc_fused._launch_chunk(*args, **kw)[3]
    hp = hmc_fused._reference_chunk(*args, **kw)[3]
    torch.cuda.synchronize()
    first = _close(hk[0][0], hp[0][0]).all(dim=0) & (hk[2] == hp[2]).all(dim=0)
    assert float(first.float().mean()) >= 0.999
    theta = args[0]
    accepted = lambda h: (h[0] != torch.cat([theta[None], h[0][:-1]])).any(dim=1)
    frac_k = accepted(hk).float().mean(dim=1)
    frac_p = accepted(hp).float().mean(dim=1)
    assert float((frac_k - frac_p).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_fused_chain_array_on_card(cuda):
    """ChainArray(fused=True) on the card launches the kernel and samples
    the correlated 2-D Gaussian."""
    cov = np.array([[1.0, 0.6], [0.6, 1.0]])
    starts = np.random.default_rng(0).normal(0, 0.3, (4096, 2))
    ca = ChainArray("hmc", GaussianForm(torch.as_tensor(np.linalg.inv(cov))), starts,
                    steps=12, epsilon=0.4, retry=False, fused=True, device=cuda, seed=7)
    before = hmc_fused.KERNEL_LAUNCHES
    ca.advance(200, store=False)
    ca.advance(100, store=True)
    assert hmc_fused.KERNEL_LAUNCHES - before == 4 + 2
    sample = ca.get_sample()
    assert abs(sample.mean(axis=0)).max() < 0.05
    np.testing.assert_allclose(np.cov(sample.T), cov, atol=0.05)
    assert ca.rhat().max() < 1.05


@pytest.mark.cuda
def test_float64_state_raises_on_card(cuda):
    """The fused path takes float32 only: a float64 CUDA state raises
    instead of being cast."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ca = ChainArray("hmc", GaussianForm(torch.eye(3)), np.zeros((256, 3)) + 0.1,
                        retry=False, fused=True, device=cuda, seed=0)
        with pytest.raises(TypeError, match="float64"):
            ca.advance(2, store=False)
    finally:
        torch.set_default_dtype(old)


# B2 against its plain version on the card: both run the same operations in
# the same order (the kernel is built with --fmad=false); the only difference
# is the exp, within a few ulp, so the relative error is a few epsilon
B2_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _sqexp_inputs(device, dtype, m, n, d, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return (t(rng.uniform(0, 3, (m, d))), t(rng.uniform(0, 3, (n, d))),
            t(1.3), t(rng.uniform(0.5, 2.0, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m, n, d", [(3001, 2500, 5), (1, 70, 1), (130, 65, 2), (257, 300, 16)])
def test_sqexp_kernel_matches_plain(cuda, dtype, m, n, d):
    """Kernel B2 against _sqexp_reference on ragged shapes, both dtypes,
    D from 1 to its maximum."""
    args = _sqexp_inputs(cuda, dtype, m, n, d, seed=m + d)
    k = pairwise._launch_sqexp(*args)
    p = pairwise._sqexp_reference(*args)
    torch.cuda.synchronize()
    assert k.shape == (m, n) and k.dtype == dtype
    assert bool(torch.isfinite(k).all())
    assert float(((k - p).abs() / p.abs()).max()) <= B2_RTOL[dtype]


@pytest.mark.cuda
def test_sqexp_covariance_launch_count(cuda):
    """sqexp_covariance launches B2 once for a block with both sides >= 2048
    rows, and never for a smaller one; its autograd backward launches
    nothing."""
    u, v, amp, ls = _sqexp_inputs(cuda, torch.float64, 2048, 2100, 2, seed=3)
    amp.requires_grad_(True)
    before = pairwise.KERNEL_LAUNCHES
    K = pairwise.sqexp_covariance(u, v, amp, ls)
    assert pairwise.KERNEL_LAUNCHES == before + 1
    K.sum().backward()
    pairwise.sqexp_covariance(u[:2047], v, amp, ls)
    torch.cuda.synchronize()
    assert pairwise.KERNEL_LAUNCHES == before + 1
    assert amp.grad is not None and bool(torch.isfinite(amp.grad))


@pytest.mark.cuda
def test_sqexp_wrapper_raises(cuda):
    """The wrapper raises on a wrong dtype, a non-contiguous input, a
    CPU/CUDA mix and D above the kernel's maximum; it never casts."""
    u, v, amp, ls = _sqexp_inputs(cuda, torch.float64, 64, 64, 3, seed=4)
    with pytest.raises(TypeError):
        pairwise._launch_sqexp(u.half(), v.half(), amp.half(), ls.half())
    with pytest.raises(TypeError):
        pairwise._launch_sqexp(u, v.float(), amp, ls)
    with pytest.raises(ValueError, match="contiguous"):
        pairwise._launch_sqexp(u.T.contiguous().T, v, amp, ls)
    with pytest.raises(ValueError, match="device"):
        pairwise._launch_sqexp(u, v.cpu(), amp, ls)
    with pytest.raises(ValueError, match="device"):
        pairwise._launch_sqexp(u, v, amp, ls.cpu())
    w = torch.zeros((64, pairwise.D_MAX + 1), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="B2"):
        pairwise._launch_sqexp(w, w, amp, torch.ones(pairwise.D_MAX + 1, dtype=torch.float64,
                                                     device=cuda))


@pytest.mark.cuda
def test_gp_regressor_on_card_matches_cpu(cuda):
    """GpRegressor at N = 2,100 on the card (through B2) against the same
    model on the CPU (through B2's plain version): LML, gradient and
    predictions to 1e-9 relative in float64."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (2100, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, 2100)
    theta = np.array([0.0, 0.0, 0.5, 0.5])
    kw = dict(y_err=np.full(2100, 0.1), hyperpars=theta, dtype=torch.float64)
    on_card = GpRegressor(x, y, device=cuda, **kw)
    on_cpu = GpRegressor(x, y, **kw, device="cpu")
    before = pairwise.KERNEL_LAUNCHES
    v1, g1 = on_card.marginal_likelihood_gradient(theta)
    assert pairwise.KERNEL_LAUNCHES > before
    v2, g2 = on_cpu.marginal_likelihood_gradient(theta)
    assert abs(v1 - v2) <= 1e-9 * abs(v2)
    np.testing.assert_allclose(g1, g2, rtol=1e-9, atol=1e-9 * np.abs(g2).max())
    q = rng.uniform(0, 10, (2048, 2))
    for a, b in zip(on_card(q), on_cpu(q)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# Kernels B3-B8 against their plain versions on the card. Each entry is
# formed by the same operations in the same order (--fmad=false), so B5 and
# B7 are equal bit for bit; the products sum over j in another order than the
# plain version's matmul, so B3, B4, B6 and B8 are held to 1e-13 of
# sum_j |E_ij| |V_jk| per row and column.
DF64_ATOL = 1e-13


def _df64_inputs(device, n, d, q, seed):
    rng = np.random.default_rng(seed)
    uh, ul = df64.split_f64(rng.uniform(0, 12, (n, d)))
    t = lambda a: torch.as_tensor(a, device=device)
    return t(uh), t(ul), t(rng.normal(size=(n, q)).astype(np.float32))


def _within_scale(got, ref, E_abs_V):
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert float(((got - ref).abs() / E_abs_V).max()) <= DF64_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, q", [(4096, 2, 1), (4096, 2, 8), (4096, 3, 5), (1024, 5, 16)])
def test_df64_fused_kernel_matches_plain(cuda, n, d, q):
    """B4 (and B3 for q = 1) against _fused_reference: a ragged q, the
    templated and the runtime-d paths."""
    uh, ul, V = _df64_inputs(cuda, n, d, q, seed=n + d + q)
    us = uh.double() + ul.double()
    before = dict(df64.KERNEL_LAUNCHES)
    got = df64.sqexp_matmat_df64(uh, ul, V)
    ref = df64._fused_reference(us, us, V)
    scale = df64._fused_reference(us, us, V.abs())
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B4"] == before["B4"] + 1
    _within_scale(got, ref, scale)
    if q == 1:
        vec = df64.sqexp_matvec_df64(uh, ul, V[:, 0])
        torch.cuda.synchronize()
        assert df64.KERNEL_LAUNCHES["B3"] == before["B3"] + 1
        _within_scale(vec[:, None], ref, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(4096, 2), (1024, 5)])
def test_df64_entries_kernel_equals_plain(cuda, n, d):
    """B5 against _entries_reference: bit for bit."""
    uh, ul, _ = _df64_inputs(cuda, n, d, 1, seed=d)
    E = df64.sqexp_entries_df64(uh, ul)
    ref = df64._entries_reference(uh.double() + ul.double())
    torch.cuda.synchronize()
    assert E.shape == (n, n) and E.dtype == torch.float64
    assert torch.equal(E, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 3, 8])
def test_df64_stored_kernel_matches_plain_and_fused(cuda, q):
    """B6 against _stored_reference and against B4 on the same V."""
    uh, ul, V = _df64_inputs(cuda, 4096, 2, q, seed=q)
    E = df64.sqexp_entries_df64(uh, ul)
    before = df64.KERNEL_LAUNCHES["B6"]
    got = df64.sqexp_stored_matmat_df64(E, V)
    ref = df64._stored_reference(E, V)
    scale = df64._stored_reference(E, V.abs())
    fused = df64.sqexp_matmat_df64(uh, ul, V)
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B6"] == before + 1
    _within_scale(got, ref, scale)
    _within_scale(got, fused, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(4096, 2), (1024, 5)])
def test_df64_entries_f32_kernel_equals_plain(cuda, n, d):
    """B7 against _entries_f32_reference: bit for bit, and B5's entries
    rounded to nearest."""
    uh, ul, _ = _df64_inputs(cuda, n, d, 1, seed=10 + d)
    before = df64.KERNEL_LAUNCHES["B7"]
    E32 = df64.sqexp_entries_f32(uh, ul)
    ref = df64._entries_f32_reference(uh.double() + ul.double())
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B7"] == before + 1
    assert E32.shape == (n, n) and E32.dtype == torch.float32
    assert torch.equal(E32, ref)
    assert torch.equal(E32, df64.sqexp_entries_df64(uh, ul).float())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 8])
def test_df64_stored_f32_kernel_matches_plain(cuda, q):
    """B8 against _stored_reference on B7's store."""
    uh, ul, V = _df64_inputs(cuda, 4096, 2, q, seed=20 + q)
    E32 = df64.sqexp_entries_f32(uh, ul)
    before = df64.KERNEL_LAUNCHES["B8"]
    got = df64.sqexp_stored_f32_matmat(E32, V)
    ref = df64._stored_reference(E32, V)
    scale = df64._stored_reference(E32, V.abs())
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B8"] == before + 1
    _within_scale(got, ref, scale)


@pytest.mark.cuda
def test_df64_wrappers_raise(cuda):
    """The launch wrappers raise on a wrong dtype, a CPU/CUDA mix or a
    non-contiguous operand; they never cast or fall back."""
    uh, ul, V = _df64_inputs(cuda, 256, 2, 2, seed=0)
    us = uh.double() + ul.double()
    with pytest.raises(TypeError):
        df64._launch_fused(us, us, V.double())
    with pytest.raises(ValueError, match="device"):
        df64._launch_fused(us, us.cpu(), V)
    with pytest.raises(TypeError):
        df64._launch_stored(torch.zeros((256, 256), device=cuda), V)
    with pytest.raises(TypeError):
        df64._launch_stored(torch.zeros((256, 256), dtype=torch.float64, device=cuda).T[:, :],
                            V.T.contiguous().T)
    with pytest.raises(ValueError, match="device"):
        df64.sqexp_matmat_df64(uh, ul, V.cpu())
    with pytest.raises(TypeError):
        df64._launch_stored(torch.zeros((256, 256), dtype=torch.float64, device=cuda), V,
                            torch.float32)
    with pytest.raises(TypeError):
        df64.sqexp_stored_f32_matmat(torch.zeros((256, 256), dtype=torch.float64, device=cuda), V)


@pytest.mark.cuda
@pytest.mark.parametrize("store_entries", ["auto", False, "f32"])
def test_large_scale_gp_on_card_matches_cpu(cuda, store_entries):
    """LargeScaleGP(solver="df64") at n = 1024, sigma = 0.01 on the card
    (through B5/B6, B3/B4 or B7/B8 with B3 refreshes, and B2 for the
    cross-covariances) against the same model on the CPU (the plain
    versions): the solve, means and variances."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 8, (1000, 2))
    y = np.sin(x[:, 0]) * np.cos(0.5 * x[:, 1]) + rng.normal(0, 0.01, 1000)
    kw = dict(hyperpars=[0.0, 0.0, 0.0], block_size=512, preconditioner_rank=128,
              solver="df64", cg_tol=1e-10, cg_maxiter=2000, store_entries=store_entries)
    before = dict(df64.KERNEL_LAUNCHES)
    on_card = LargeScaleGP(x, y, np.full(1000, 0.01), device=cuda, **kw)
    on_cpu = LargeScaleGP(x, y, np.full(1000, 0.01), device="cpu", **kw)
    launched = {k: df64.KERNEL_LAUNCHES[k] - before[k] for k in before}
    if store_entries == "auto":
        assert launched["B5"] == 1 and launched["B6"] > 0
    elif store_entries == "f32":
        assert launched["B7"] == 1 and launched["B8"] > 0 and launched["B3"] > 0
    else:
        assert launched["B3"] > 0 and launched["B5"] == 0
    assert on_card.residual_norm_f64("host") < 1e-9
    np.testing.assert_allclose(on_card.alpha64, on_cpu.alpha64, rtol=0,
                               atol=1e-6 * np.abs(on_cpu.alpha64).max())
    q = rng.uniform(1, 7, (16, 2))
    for a, b in zip(on_card(q, with_variance=True), on_cpu(q, with_variance=True)):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)


# The probes P1-P3 against their plain versions on the card: P1 bit for bit
# (one rounded operation each, in the kernel and in torch); P2 and P3 sum
# over j in another order than the plain versions' matmuls, so 1e-13 of
# sum_j |term_ij| |w_j| (d2exp32, a float32 exp and accumulate, 1e-6, also
# on coordinates shifted by 1e4, which a float32 distance would not hold to
# it); P3 against B3 1e-11, the words' truncation.
@pytest.mark.cuda
@pytest.mark.parametrize("mode", vpu_probe.MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_issue_probe_kernel_equals_plain(cuda, dtype, mode):
    x = vpu_probe.make_tile(dtype, cuda, seed=1)
    for n_chains in vpu_probe.CHAINS:
        before = vpu_probe.KERNEL_LAUNCHES
        got = vpu_probe.issue_probe(x, 128, n_chains, mode)
        ref = vpu_probe._probe_reference(x, 128, n_chains, mode)
        torch.cuda.synchronize()
        assert vpu_probe.KERNEL_LAUNCHES == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", df64_ablate.VARIANTS)
def test_ablate_kernel_matches_plain(cuda, variant):
    _, _, us, v = df64_ablate.make_inputs(4096, cuda, seed=2)
    before = df64_ablate.KERNEL_LAUNCHES
    got = df64_ablate.sqexp_ablate(us, v, variant)
    ref = df64_ablate._ablate_reference(us, v, variant)
    scale = df64_ablate._ablate_reference(us, v.abs(), variant)
    torch.cuda.synchronize()
    assert df64_ablate.KERNEL_LAUNCHES == before + 1
    assert got.dtype == ref.dtype and bool(torch.isfinite(got).all())
    tol = 1e-6 if variant == "d2exp32" else DF64_ATOL
    assert float(((got - ref).abs() / scale).max()) <= tol
    if variant == "d2exp32":
        shifted = df64_ablate.sqexp_ablate(us + 1e4, v, variant)
        assert float(((shifted - ref).abs() / scale).max()) <= tol


@pytest.mark.cuda
def test_words_mma_tile_and_matvec(cuda):
    """One 16 x 8 tile of the class sums equals the plain version's exactly;
    the matvec matches its plain version and B3."""
    uh, ul, us, v = df64_ablate.make_inputs(4096, cuda, seed=3)
    ops = p3.prepare(us.cpu().numpy(), cuda)
    assert torch.equal(p3._launch_tile(ops), p3._tile_reference(ops))
    before = p3.KERNEL_LAUNCHES
    got = p3.words_matvec(ops, v)
    ref = p3._words_reference(ops, v)
    scale = df64._fused_reference(us, us, v.abs()[:, None])[:, 0]
    b3 = df64.sqexp_matvec_df64(uh, ul, v)
    torch.cuda.synchronize()
    assert p3.KERNEL_LAUNCHES == before + 1
    assert float(((got - ref).abs() / scale).max()) <= DF64_ATOL
    assert float(((got - b3).abs() / scale).max()) <= 1e-11


@pytest.mark.cuda
def test_probe_wrappers_raise(cuda):
    """The probes' launch wrappers raise on a wrong dtype or a CPU/CUDA mix;
    they never cast or fall back."""
    _, _, us, v = df64_ablate.make_inputs(256, cuda, seed=0)
    with pytest.raises(TypeError):
        df64_ablate.sqexp_ablate(us, v.double(), "full")
    with pytest.raises(ValueError, match="device"):
        df64_ablate.sqexp_ablate(us, v.cpu(), "full")
    ops = p3.prepare(us.cpu().numpy(), cuda)
    with pytest.raises(ValueError, match="device"):
        p3.words_matvec(ops, v.cpu())
    with pytest.raises(TypeError):
        p3._launch_words(ops, v.double())
    with pytest.raises(TypeError):
        vpu_probe.issue_probe(torch.zeros((128, 128), dtype=torch.float16, device=cuda))
