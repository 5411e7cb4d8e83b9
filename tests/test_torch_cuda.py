"""Kernels B1 (inference_tpu_torch/ops/csrc/hmc_fused.cu, and its wide
route for P > 64), B2
(inference_tpu_torch/ops/csrc/sqexp.cu), B3-B8 (ops/csrc/sqexp_fused.cu,
sqexp_entries.cu, sqexp_stored.cu) and the probes P1-P3 (issue_probe.cu,
sqexp_ablate.cu, sqexp_words_mma.cu) on a CUDA device: each against its
plain PyTorch version on the same inputs, its launch count and its input
checks; the fused ChainArray, HamiltonianChain and a models.Posterior on
the card, the GpRegressor (and its on-device fit, B2 once per start and
evaluation), the GpOptimiser's state, the LargeScaleGP (its df64 store tiers, its cg
tier's product and a fit step) and the LargeScaleGpLinearInverter's df64
stores end to end; the gibbs,
metropolis and pca ChainArrays on the card against their CPU runs, a
numpy posterior's chains with their state on the card, tempering ladders
and the ensemble step, the NUTS step and the density estimators against
the CPU.

Every test here needs the card and carries the ``cuda`` marker; without a
card each one skips. The file imports only the port (not the JAX package),
so it runs on a machine with CUDA torch alone:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from inference_tpu_torch.gp import (GpOptimiser, GpRegressor, LargeScaleGP,
                                    LargeScaleGpLinearInverter)
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.ops import _build, df64, hmc_fused, pairwise
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
    [(10, 65536, 1.0, False), (32, 4096, 0.5, True), (3, 1000, 1.0, True),
     (1, 4096, 1.0, False), (2, 4096, 1.0, False), (16, 4096, 1.0, False),
     (17, 4096, 1.0, True), (64, 4096, 1.0, False), (10, 4096, 1.0, "scalar"),
     (10, 4096, 0.5, False)],
)
def test_kernel_matches_plain_one_transition(cuda, P, K, inv_temp, diag_mass):
    """One transition: position, logp and step size within tolerance and the
    adaptation counters equal on >= 99.9% of chains (the libraries of P = 1
    to 64, unit, scalar and diagonal mass, tempering, a ragged last
    block)."""
    form, args = _chunk_inputs(cuda, P, K, 1, inv_temp, seed=P)
    im = (torch.as_tensor(np.random.default_rng(5).uniform(0.5, 2.0, P),
                          dtype=torch.float32, device=cuda) if diag_mass else None)
    if diag_mass == "scalar":
        im = torch.full((P,), 0.7, device=cuda)
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
@pytest.mark.parametrize("P", [10, 32])
def test_kernel_matches_plain_stored_chunk(cuda, P):
    """A stored 64-transition chunk: the first transition and every step
    count agree per chain, and the accept fraction of every transition
    agrees to 1e-3 (single chains drift apart over a chunk at float32
    roundoff, as the plain version does from itself in float64)."""
    form, args = _chunk_inputs(cuda, P, 16384, 64, 1.0, seed=12)
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


def _resident_edge(K):
    """The smallest P > 64 whose wide plan at K chains streams A: there A
    just stops fitting beside the block's tiles."""
    return next(P for P in range(65, 2000) if hmc_fused.wide_plan(P, K).stages)


def _wide_inputs(device, P, K, chunk, inv_temp, seed):
    """``_chunk_inputs`` for large P: a diagonally dominant form and
    positions near its mean, made without a P x P inverse or factorisation."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(P, P)) * (0.5 / np.sqrt(P))
    dev = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt).to(device)
    mu = rng.normal(0, 0.3, P)
    form = GaussianForm(dev(np.eye(P) + 0.5 * (B + B.T)), dev(mu)).to(device)
    theta = dev(mu[:, None] + rng.normal(0, 0.7, (P, K)))
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P, K, inv_temp, diag_mass",
    [(65, 4096, 1.0, False), (100, 4096, 0.5, True), (256, 2048, 1.0, False),
     (129, 1000, 1.0, "scalar"), (65, 65536, 1.0, False), ("edge", 4096, 1.0, False),
     ("edge - 1", 4096, 1.0, False), (700, 1000, 1.0, False), (700, 1000, 0.5, True),
     (100, 1000, 1.0, False), (256, 1000, 0.7, True), (2000, 96, 1.0, False),
     (3000, 64, 1.0, False), (3000, 64, 0.5, True)],
)
def test_wide_kernel_matches_plain_one_transition(cuda, P, K, inv_temp, diag_mass):
    """B1's wide route (P > 64, one library): one transition agrees with the
    plain version per chain within the float32 tolerance on >= 99.9% of the
    chains, with unit, scalar and diagonal mass, tempering and K not a
    multiple of the block's chains; each launch counts once. The tiled
    kernel at P = 65 (rows padded to 72), where A just stops fitting beside
    the block's tiles at this K ("edge", streamed) and one P before it
    (resident), at P = 700 and 2,000 (few chains a block, A streamed; 2,000
    with a whole SM's shared memory), and the warp-per-chain kernel beyond
    the tiled kernel's reach (P = 3,000)."""
    edge = _resident_edge(K)
    P = {"edge": edge, "edge - 1": edge - 1}.get(P, P)
    plan = hmc_fused.wide_plan(P, K)
    assert plan.tiled == (P <= 2048)
    if P == edge:
        assert plan.stages and not hmc_fused.wide_plan(P - 1, K).stages
    make = _chunk_inputs if P <= 256 else _wide_inputs
    form, args = make(cuda, P, K, 1, inv_temp, seed=P)
    im = (torch.as_tensor(np.random.default_rng(5).uniform(0.5, 2.0, P),
                          dtype=torch.float32, device=cuda) if diag_mass else None)
    if diag_mass == "scalar":
        im = torch.full((P,), 0.7, device=cuda)
    kw = dict(form=form, steps=50, inv_mass_diag=im, store=False)
    before = hmc_fused.KERNEL_LAUNCHES
    k = hmc_fused._launch_chunk(*args, **kw, padded=hmc_fused.wide_form(form, im))
    p = hmc_fused._reference_chunk(*args, **kw)
    torch.cuda.synchronize()
    assert hmc_fused.KERNEL_LAUNCHES == before + 1
    ok = _close(k[0], p[0]).all(dim=0) & _close(k[1], p[1]) & _close(k[2].value, p[2].value)
    ok &= (k[2].num == p[2].num) & (k[2].chk_int == p[2].chk_int)
    assert float(ok.float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("P", [10, 100])
def test_padded_form_goes_with_the_wide_route_only(cuda, P):
    """The wide route launches only with the plan's padded form, and the
    narrow route only without one: either mistake raises before a launch."""
    form, args = _chunk_inputs(cuda, P, 256, 1, 1.0, seed=P)
    padded = None if P > hmc_fused.P_NARROW else hmc_fused.wide_form(form)
    before = hmc_fused.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="takes padded="):
        hmc_fused._launch_chunk(*args, form=form, steps=10, inv_mass_diag=None, store=False,
                                padded=padded)
    assert hmc_fused.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("P, K, diag_mass", [(100, 4096, False), (100, 4100, True),
                                             (256, 2048, False), (700, 4100, False)])
def test_wide_kernel_matches_plain_stored_chunk(cuda, P, K, diag_mass):
    """A stored 64-transition chunk on the wide route (A resident at P = 100,
    streamed at 256 and 700; K = 4,100 not a multiple of the block's
    chains): the first transition and every step count agree per chain,
    and the accept fraction of every transition agrees to 1e-3."""
    make = _chunk_inputs if P <= 256 else _wide_inputs
    form, args = make(cuda, P, K, 64, 1.0, seed=30)
    im = (torch.as_tensor(np.random.default_rng(6).uniform(0.5, 2.0, P),
                          dtype=torch.float32, device=cuda) if diag_mass else None)
    kw = dict(form=form, steps=50, inv_mass_diag=im, store=True)
    hk = hmc_fused._launch_chunk(*args, **kw, padded=hmc_fused.wide_form(form, im))[3]
    hp = hmc_fused._reference_chunk(*args, **kw)[3]
    torch.cuda.synchronize()
    first = _close(hk[0][0], hp[0][0]).all(dim=0) & (hk[2] == hp[2]).all(dim=0)
    assert float(first.float().mean()) >= 0.999
    theta = args[0]
    accepted = lambda h: (h[0] != torch.cat([theta[None], h[0][:-1]])).any(dim=1)
    assert float((accepted(hk).float().mean(dim=1)
                  - accepted(hp).float().mean(dim=1)).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_wide_launcher_refuses_bad_sizes(cuda):
    """The wide library refuses P < 1, rows that are not P rounded up to 8,
    a missing form, and plans the kernels do not take: chains not a
    multiple of 4 or too many threads, a depth off the padded A, a slab or
    stage count outside the ring's, too much shared memory, and a warp
    plan whose depth is not its rows."""
    fn = _build.bind("hmc_fused", "hmc_fused_chunk_wide", 25, 10,
                     hmc_fused.kernel_variant(100, True))
    A = torch.zeros((112, 104), device=cuda)
    mu = torch.zeros(104, device=cuda)
    ok = hmc_fused.wide_plan(100, 256)
    assert ok.tiled and ok.stages == 0
    bad = [  # (P, A, chains, rows, depth, slab, stages)
        (100, A, ok.chains, 101, 100, 0, 0), (0, A, 4, 0, 0, 0, 0), (100, None, 4, 104, 100, 0, 0),
        (100, A, 6, 104, 100, 0, 0), (100, A, 256, 104, 100, 0, 0), (100, A, 96, 104, 100, 0, 0),
        (100, A, 4, 104, 98, 0, 0), (100, A, 4, 104, 116, 0, 0), (100, A, 4, 104, 112, 12, 3),
        (100, A, 4, 104, 112, 16, 4), (100, A, 4, 104, 100, 16, 0), (240, A, 64, 240, 240, 0, 0),
        (100, A, 0, 104, 100, 0, 0),
    ]
    for P, a, chains, rows, depth, slab, stages in bad:
        ptrs = [None] * 12 + [None if a is None else a.data_ptr(), mu.data_ptr()] + [None] * 11
        assert fn(*ptrs, P, 256, 1, 10, 11, chains, rows, depth, slab, stages,
                  _build.stream(cuda)) == 1, (P, chains, rows, depth, slab, stages)


@pytest.mark.cuda
def test_fused_chain_array_at_one_hundred_parameters_on_card(cuda):
    """ChainArray(fused=True) at P = 100 takes B1's wide route on the card
    and samples the Gaussian: pooled variances within 10%."""
    P = 100
    rng = np.random.default_rng(1)
    B = rng.normal(size=(P, P)) / np.sqrt(P)
    cov = B @ B.T + np.eye(P)
    starts = rng.multivariate_normal(np.zeros(P), cov, 4096)
    ca = ChainArray("hmc", GaussianForm(torch.as_tensor(np.linalg.inv(cov))), starts, steps=30,
                    epsilon=0.2, retry=False, fused=True, device=cuda, seed=2)
    before = hmc_fused.KERNEL_LAUNCHES
    ca.advance(64, store=False)
    ca.advance(128, store=True, thin=8)
    assert hmc_fused.KERNEL_LAUNCHES - before == 1 + 2
    rel = np.abs(ca.get_sample().var(axis=0) / np.diag(cov) - 1.0)
    assert rel.max() < 0.10


def _bounded_gaussian_chain(device, seed):
    from inference_tpu_torch import Bounds, HamiltonianChain

    cov = np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]])
    bounds = Bounds([-0.5, -8.0, -8.0], [8.0, 8.0, 8.0])
    return HamiltonianChain(GaussianForm(torch.as_tensor(np.linalg.inv(cov))),
                            start=np.full(3, 0.1), bounds=bounds, display_progress=False,
                            seed=seed, device=device)


@pytest.mark.cuda
def test_hamiltonian_chain_on_card_matches_cpu(cuda):
    """HamiltonianChain on the card against the same chain on the CPU, by
    statistics: every sample inside the bounds, each mean within 5 joint
    standard errors (sd / sqrt(ESS)), and save, load and advance on the
    card."""
    from inference_tpu_torch import HamiltonianChain
    from inference_tpu_torch.utils import effective_sample_size

    chains = {}
    for device in (cuda, "cpu"):
        chain = _bounded_gaussian_chain(device, seed=3)
        chain.steps = 20
        chain.advance(600)
        chains[str(torch.device(device).type)] = chain
    moments = []
    for chain in chains.values():
        s = chain.get_sample(burn=100)
        assert chain.bounds.inside(s)
        ess = np.array([effective_sample_size(s[:, i]) for i in range(3)])
        moments.append((s.mean(axis=0), s.var(axis=0), ess))
    (m1, v1, e1), (m2, v2, e2) = moments
    assert (np.abs(m1 - m2) / np.sqrt(v1 / e1 + v2 / e2)).max() < 5.0
    card = chains["cuda"]
    path = _build.BUILD_DIR.parent / "test_hamiltonian_card.npz"
    card.save(str(path))
    loaded = HamiltonianChain.load(str(path), posterior=card.posterior, device=cuda)
    path.unlink()
    loaded.advance(20)
    assert loaded.chain_length == card.chain_length + 20


@pytest.mark.cuda
def test_posterior_on_card_inside_chain_array(cuda):
    """A models.Posterior with its data on the card goes into ChainArray on
    the card and finds the straight line's least-squares fit."""
    from inference_tpu_torch.models import GaussianLikelihood, Posterior, UniformPrior

    rng = np.random.default_rng(1)
    x = np.linspace(1, 10, 10)
    y = 2.0 * x + 1.0 + rng.normal(0.0, 2.0, x.size)
    xs = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    post = Posterior(GaussianLikelihood(y, np.full(10, 2.0), lambda t: t[0] * xs + t[1], device=cuda),
                     UniformPrior([0.0, -5.0], [5.0, 5.0], [0, 1], device=cuda))
    starts = rng.uniform([1.5, -1.0], [2.5, 1.0], size=(1024, 2))
    ca = ChainArray("hmc", post, starts, steps=10, epsilon=0.1, retry=False, seed=1, device=cuda)
    ca.advance(200, store=True)
    mean = ca.get_sample(burn=50).mean(axis=0)
    fit = np.polyfit(x, y, 1)
    assert abs(mean[0] - fit[0]) < 0.05 and abs(mean[1] - fit[1]) < 0.3


@pytest.mark.cuda
def test_failed_variant_build_raises_naming_b1_and_p(cuda, tmp_path, monkeypatch):
    """A library of B1 that fails to build raises naming the kernel and P:
    no fallback to the plain version or to another P."""
    bad = tmp_path / "nvcc"
    bad.write_text("#!/bin/sh\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(bad))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    _build.load.cache_clear()
    form, args = _chunk_inputs(cuda, 7, 256, 1, 1.0, seed=7)
    before = hmc_fused.KERNEL_LAUNCHES
    try:
        with pytest.raises(RuntimeError, match="kernel B1 for P = 7"):
            hmc_fused._launch_chunk(*args, form=form, steps=10, inv_mass_diag=None, store=False)
    finally:
        _build.load.cache_clear()
    assert hmc_fused.KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_launch_refuses_another_libraries_p(cuda):
    """The library of one P and kind of mass refuses a launch with another
    P or another kind of mass."""
    fn = _build.bind("hmc_fused", "hmc_fused_chunk", 25, 5, hmc_fused.kernel_variant(10, True))
    rc = fn(*([None] * 25), 9, 256, 1, 10, 11, _build.stream(cuda))
    assert rc == 1  # cudaErrorInvalidValue
    im = torch.ones(10)  # the form's operands are host pointers
    rc = fn(*([None] * 11), im.data_ptr(), *([None] * 13), 10, 256, 1, 10, 11,
            _build.stream(cuda))
    assert rc == 1


@pytest.mark.cuda
def test_launch_follows_a_form_changed_in_place(cuda):
    """The launcher copies the form into the kernel's parameters from host
    copies; a form changed in place between launches reaches the next
    launch, and each launch agrees with the plain version."""
    form, args = _chunk_inputs(cuda, 10, 4096, 1, 1.0, seed=21)
    kw = dict(form=form, steps=50, inv_mass_diag=None, store=False)
    for _ in range(2):
        k = hmc_fused._launch_chunk(*args, **kw)
        p = hmc_fused._reference_chunk(*args, **kw)
        torch.cuda.synchronize()
        ok = _close(k[0], p[0]).all(dim=0) & _close(k[1], p[1])
        assert float(ok.float().mean()) >= 0.999
        form.A.mul_(2.0)
        form.mu.add_(0.5)


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
@pytest.mark.parametrize("m, n, d", [
    (3001, 2500, 5), (1, 70, 1), (130, 65, 2), (257, 300, 16),
    (300, 257, 3), (2048, 2056, 17), (513, 260, 64), (1000, 1001, 100), (64, 2, 2),
])
def test_sqexp_kernel_matches_plain(cuda, dtype, m, n, d):
    """Kernel B2 against _sqexp_reference on ragged shapes, both dtypes, D
    from 1 to 100 (its own library up to B2_D_REG, the wide one above), on
    16-byte row pitches (vector stores) and others (n = 65, 257 and 1001;
    n = 70 and 2 in float32: scalar stores); the route the plan takes is the
    one the pitch allows."""
    args = _sqexp_inputs(cuda, dtype, m, n, d, seed=m + d)
    args = (*args[:3], args[3] * max(1.0, (d / 5) ** 0.5))  # entries of order one
    k = pairwise._launch_sqexp(*args)
    p = pairwise._sqexp_reference(*args)
    torch.cuda.synchronize()
    assert k.shape == (m, n) and k.dtype == dtype
    assert bool(torch.isfinite(k).all())
    assert float(((k - p).abs() / p.abs()).max()) <= B2_RTOL[dtype]
    plan = pairwise.sqexp_plan(m, n, d, dtype, 132)
    assert plan.route == ("vector" if n * dtype.itemsize % 16 == 0 else "scalar")


def _b2_launcher(cuda, dtype, m, n, d):
    """Kernel B2's C entry point for D and its operands, as the wrapper
    passes them: (fn, pointers, out, plan)."""
    u, v, amp, ls = _sqexp_inputs(cuda, dtype, m, n, d, seed=5)
    us, vs = pairwise._scaled(u, v, ls)
    a2 = (amp**2).reshape(1).contiguous()
    out = torch.full((m, n), float("nan"), dtype=dtype, device=cuda)
    symbol = "sqexp_f64" if dtype == torch.float64 else "sqexp_f32"
    fn = _build.bind("sqexp", symbol, 4, 9, pairwise.kernel_variant(d))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = pairwise.sqexp_plan(m, n, d, dtype, sms)
    keep = (us, vs, a2)
    return fn, keep, out, plan, pairwise._sqexp_reference(u, v, amp, ls)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [2, 17])
def test_sqexp_each_store_route_matches_plain(cuda, dtype, d):
    """Both store routes of kernel B2 on one 16-byte pitch, each launched by
    the plan with only its route changed: equal bit for bit, and to the
    plain version within B2_RTOL."""
    fn, (us, vs, a2), out, plan, ref = _b2_launcher(cuda, dtype, 1000, 1024, d)
    results = []
    for route in pairwise.ROUTES.values():
        out.fill_(float("nan"))
        rc = fn(us.data_ptr(), vs.data_ptr(), a2.data_ptr(), out.data_ptr(), 1000, 1024, d,
                plan.tile_m, plan.tile_n, plan.tiles_m, plan.tiles_n, plan.blocks, route,
                _build.stream(cuda))
        torch.cuda.synchronize()
        assert rc == 0
        results.append(out.clone())
    assert torch.equal(results[0], results[1])
    assert float(((results[0] - ref).abs() / ref.abs()).max()) <= B2_RTOL[dtype]


@pytest.mark.cuda
def test_sqexp_launcher_refuses_a_bad_plan(cuda):
    """Kernel B2's launcher takes the wrapper's plan only where its tiles
    cover the output exactly once, every block has a tile, the tile is the
    one it is built for, the vector route has a 16-byte pitch and D is its
    library's; else it refuses before the launch."""
    m, n, d = 1000, 1001, 2
    fn, (us, vs, a2), out, plan, ref = _b2_launcher(cuda, torch.float64, m, n, d)

    def launch(**kw):
        p = {**plan._asdict(), "route": pairwise.ROUTES[plan.route], "d": d, **kw}
        return fn(us.data_ptr(), vs.data_ptr(), a2.data_ptr(), out.data_ptr(), m, n, p["d"],
                  p["tile_m"], p["tile_n"], p["tiles_m"], p["tiles_n"], p["blocks"], p["route"],
                  _build.stream(cuda))

    assert plan.route == "scalar" and launch() == 0
    torch.cuda.synchronize()
    assert float(((out - ref).abs() / ref.abs()).max()) <= B2_RTOL[torch.float64]
    n_tiles = plan.tiles_m * plan.tiles_n
    for bad in (dict(tiles_n=plan.tiles_n - 1),  # the last column tile missed
                dict(tiles_m=plan.tiles_m + 1),  # a row tile past the end
                dict(tile_m=16, tiles_m=-(-m // 16)),  # another tile than the library's
                dict(tile_n=64, tiles_n=-(-n // 64)),
                dict(blocks=0), dict(blocks=n_tiles + 1),  # no block, a block without a tile
                dict(route=pairwise.ROUTES["vector"]),  # 16-byte stores on an odd pitch
                dict(route=7), dict(d=3)):  # no such route, another library's D
        assert launch(**bad) != 0, bad


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
    """The wrapper raises on a wrong dtype, a non-contiguous input and a
    CPU/CUDA mix; it never casts."""
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


@pytest.mark.cuda
def test_gp_regressor_with_seventeen_features_on_card_matches_cpu(cuda):
    """GpRegressor with D = 17 at N = 2,100 (kernel B2's wide library on the
    card, where the port raised before) against the same model on the CPU:
    LML, gradient and predictions to 1e-9 relative in float64."""
    rng = np.random.default_rng(17)
    x = rng.uniform(0, 3, (2100, 17))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + x[:, 2:].mean(axis=1) + rng.normal(0, 0.1, 2100)
    theta = np.concatenate([[0.0, 0.0], np.full(17, np.log(2.0))])
    kw = dict(y_err=np.full(2100, 0.1), hyperpars=theta, dtype=torch.float64)
    on_card = GpRegressor(x, y, device=cuda, **kw)
    on_cpu = GpRegressor(x, y, **kw, device="cpu")
    before = pairwise.KERNEL_LAUNCHES
    v1, g1 = on_card.marginal_likelihood_gradient(theta)
    assert pairwise.KERNEL_LAUNCHES > before
    v2, g2 = on_cpu.marginal_likelihood_gradient(theta)
    assert abs(v1 - v2) <= 1e-9 * abs(v2)
    np.testing.assert_allclose(g1, g2, rtol=1e-9, atol=1e-9 * np.abs(g2).max())
    q = rng.uniform(0, 3, (2048, 17))
    for a, b in zip(on_card(q), on_cpu(q)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


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


@pytest.mark.cuda
def test_fit_device_launches_b2_once_per_start_and_evaluation(cuda, monkeypatch):
    """fit_device at N = 2,048 on the card: every start of every batched
    evaluation is one kernel-B2 launch (the per-start route, never the
    matmul form or the CPU), and the fit beats the start centre."""
    rng = np.random.default_rng(2)
    n = pairwise._PALLAS_MIN_N
    x = rng.uniform(0, 10, (n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    gp = GpRegressor(x, y, y_err=np.full(n, 0.1), hyperpars=[0.0, 0.0, 0.5, 0.5],
                     dtype=torch.float64, device=cuda)
    rows = []
    batched = gp._batched_objective

    def counted(thetas, jitter=0.0):
        assert thetas.device.type == "cuda"
        rows.append(thetas.shape[0])
        return batched(thetas, jitter)

    monkeypatch.setattr(gp, "_batched_objective", counted)
    before = pairwise.KERNEL_LAUNCHES
    theta = gp.fit_device(starts=4)
    assert pairwise.KERNEL_LAUNCHES - before == sum(rows) > 0
    lwr, upr = (np.array([b[i] for b in gp.hp_bounds]) for i in (0, 1))
    assert gp.marginal_likelihood(theta) > gp.marginal_likelihood(0.5 * (lwr + upr))


@pytest.mark.cuda
def test_gp_optimiser_state_stays_on_card(cuda):
    """A GpOptimiser built with the default device keeps its GP's tensors on
    the card, and so does its fused proposal's state (L, alpha, K, the
    parameters); the proposal lies in the bounds."""
    x = np.array([1.0, 5.0, 9.0])
    y = np.sin(2 * x) + 0.1 * x
    opt = GpOptimiser(x, y, bounds=[(0.0, 10.0)], optimizer="device", dtype=torch.float64)
    gp = opt.gp
    for t in (gp._x_dev, gp._y_dev, gp._mask_dev, gp._sig_dev, gp.L, gp.alpha):
        assert t.device.type == "cuda"
    nx = opt.propose_evaluation()
    opt.add_evaluation(np.atleast_1d(nx), np.array([np.sin(2 * nx) + 0.1 * nx]))
    assert opt._pending is not None
    nx = opt.propose_evaluation()  # the fused step
    assert opt._pending is None and 0.0 <= float(nx) <= 10.0
    for t in (gp.L, gp.alpha, gp.K_xx, gp.mu, gp._cov_pars_dev, gp._mean_pars_dev):
        assert t.device.type == "cuda"
    assert all(t.device.type == "cuda" for t in opt.acquisition.gp_state())


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
@pytest.mark.parametrize("n_rows, n, d, q", [
    (4096, 4096, 2, 1), (4096, 4096, 2, 2), (4096, 4096, 2, 8), (4096, 4096, 2, 16),
    (4096, 4096, 3, 5), (1024, 1024, 5, 16),
    # 4,224 rows = 33 row tiles: the last block is ragged for 2 and 4 rows per thread
    (4224, 4096, 2, 1), (4224, 4096, 2, 2), (4224, 4096, 2, 8), (4224, 4096, 2, 16),
    (4224, 1024, 5, 3),
])
def test_df64_fused_kernel_matches_plain(cuda, n_rows, n, d, q):
    """B4 (and B3 for q = 1) against _fused_reference: square and
    rectangular with ragged row blocks, every bucket of q and a ragged q,
    the templated and the runtime-d paths."""
    uh, ul, V = _df64_inputs(cuda, n, d, q, seed=n + d + q)
    us = uh.double() + ul.double()
    before = dict(df64.KERNEL_LAUNCHES)
    if n_rows == n:
        rows = us
        got = df64.sqexp_matmat_df64(uh, ul, V)
    else:
        rh, rl, _ = _df64_inputs(cuda, n_rows, d, 1, seed=n_rows + q)
        rows = rh.double() + rl.double()
        got = df64.sqexp_matmat_rect_df64(rh, rl, uh, ul, V)
    ref = df64._fused_reference(rows, us, V)
    scale = df64._fused_reference(rows, us, V.abs())
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B4"] == before["B4"] + 1
    _within_scale(got, ref, scale)
    if q == 1 and n_rows == n:
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


STORED_Q = [1, 2, 3, 8, 16]
# 4,736 = 37 column tiles: the last split and panel are ragged at every grid
STORED_N = [4096, 4736]


@pytest.mark.cuda
@pytest.mark.parametrize("n", STORED_N)
@pytest.mark.parametrize("q", STORED_Q)
def test_df64_stored_kernel_matches_plain_and_fused(cuda, n, q):
    """B6 against _stored_reference and against B4 on the same V; one
    launch, counted under its q."""
    uh, ul, V = _df64_inputs(cuda, n, 2, q, seed=q + n)
    E = df64.sqexp_entries_df64(uh, ul)
    before = df64.KERNEL_LAUNCHES["B6"]
    before_q = df64.STORED_LAUNCHES_BY_Q["B6"].get(q, 0)
    got = df64.sqexp_stored_matmat_df64(E, V)
    ref = df64._stored_reference(E, V)
    scale = df64._stored_reference(E, V.abs())
    fused = df64.sqexp_matmat_df64(uh, ul, V)
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B6"] == before + 1
    assert df64.STORED_LAUNCHES_BY_Q["B6"][q] == before_q + 1
    _within_scale(got, ref, scale)
    _within_scale(got, fused, scale)


@pytest.mark.cuda
def test_df64_stored_mma_fragment_layout(cuda):
    """One m16n8k4 FP64 MMA with B6/B8's fragment mapping equals A @ B
    exactly on small integers."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.integers(-9, 10, (16, 4)), dtype=torch.float64, device=cuda)
    B = torch.as_tensor(rng.integers(-9, 10, (4, 8)), dtype=torch.float64, device=cuda)
    D = df64._launch_stored_mma_tile(A, B)
    torch.cuda.synchronize()
    assert torch.equal(D, A @ B)


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
@pytest.mark.parametrize("n", STORED_N)
@pytest.mark.parametrize("q", STORED_Q)
def test_df64_stored_f32_kernel_matches_plain(cuda, n, q):
    """B8 against _stored_reference on B7's store; one launch, counted
    under its q."""
    uh, ul, V = _df64_inputs(cuda, n, 2, q, seed=20 + q + n)
    E32 = df64.sqexp_entries_f32(uh, ul)
    before = df64.KERNEL_LAUNCHES["B8"]
    before_q = df64.STORED_LAUNCHES_BY_Q["B8"].get(q, 0)
    got = df64.sqexp_stored_f32_matmat(E32, V)
    ref = df64._stored_reference(E32, V)
    scale = df64._stored_reference(E32, V.abs())
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES["B8"] == before + 1
    assert df64.STORED_LAUNCHES_BY_Q["B8"][q] == before_q + 1
    _within_scale(got, ref, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["B4", "B4 rect", "B6", "B8"])
def test_df64_products_at_twenty_right_hand_sides(cuda, which):
    """q = 20: one launch per block of at most 16 columns (two here), each
    column within 1e-13 of sum_j |E_ij| |V_jk| of the plain version."""
    n = 1024
    uh, ul, V = _df64_inputs(cuda, n, 2, 20, seed=30)
    us = uh.double() + ul.double()
    E = df64.sqexp_entries_df64(uh, ul) if which == "B6" else None
    E32 = df64.sqexp_entries_f32(uh, ul) if which == "B8" else None
    kernel = which.split()[0]
    before = df64.KERNEL_LAUNCHES[kernel]
    if which == "B4":
        got, ref, scale = (df64.sqexp_matmat_df64(uh, ul, V), df64._fused_reference(us, us, V),
                           df64._fused_reference(us, us, V.abs()))
    elif which == "B4 rect":
        got = df64.sqexp_matmat_rect_df64(uh[:256], ul[:256], uh, ul, V)
        ref, scale = df64._fused_reference(us[:256], us, V), df64._fused_reference(us[:256], us,
                                                                                   V.abs())
    elif which == "B6":
        got, ref, scale = (df64.sqexp_stored_matmat_df64(E, V), df64._stored_reference(E, V),
                           df64._stored_reference(E, V.abs()))
    else:
        got, ref, scale = (df64.sqexp_stored_f32_matmat(E32, V), df64._stored_reference(E32, V),
                           df64._stored_reference(E32, V.abs()))
    torch.cuda.synchronize()
    assert df64.KERNEL_LAUNCHES[kernel] == before + 2
    assert got.shape == (ref.shape[0], 20)
    _within_scale(got, ref, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 20, 33, 100])
@pytest.mark.parametrize("which", ["B3", "B4", "B5", "B7"])
def test_df64_kernels_at_twenty_dimensions(cuda, which, d):
    """d > 16, the wide kernels, at both ends of a padded step of 4 (17,
    20), with a second staged chunk of B5/B7 (33) and B3/B4 in chunks of 16
    dimensions (100): B5 and B7 bit for bit with their plain versions, B3 and B4
    (q = 1, 8 and 16, on 640 rows: a last row block that is not full) within
    1e-13 of sum_j |E_ij| |V_jk|."""
    n = 1024
    uh, ul, V = _df64_inputs(cuda, n, d, 16, seed=31 + d)
    scale = 8 * np.sqrt(d / 20)  # a well-filled E at every d
    uh, ul = uh / scale, ul / scale
    us = uh.double() + ul.double()
    before = df64.KERNEL_LAUNCHES[which]
    if which in ("B5", "B7"):
        got = (df64.sqexp_entries_df64 if which == "B5" else df64.sqexp_entries_f32)(uh, ul)
        ref = (df64._entries_reference if which == "B5" else df64._entries_f32_reference)(us)
        torch.cuda.synchronize()
        assert float((ref > 1e-3).double().mean()) > 0.1
        assert torch.equal(got, ref)
        launches = 1
    elif which == "B3":
        got = df64.sqexp_matvec_df64(uh, ul, V[:, 0])
        torch.cuda.synchronize()
        _within_scale(got[:, None], df64._fused_reference(us, us, V[:, :1]),
                      df64._fused_reference(us, us, V[:, :1].abs()))
        launches = 1
    else:
        rh, rl = uh[:640], ul[:640]
        for q in (1, 8, 16):
            Vq = V[:, :q].contiguous()
            got = df64.sqexp_matmat_rect_df64(rh, rl, uh, ul, Vq)
            torch.cuda.synchronize()
            _within_scale(got, df64._fused_reference(us[:640], us, Vq),
                          df64._fused_reference(us[:640], us, Vq.abs()))
        launches = 3
    assert df64.KERNEL_LAUNCHES[which] == before + launches


@pytest.mark.cuda
def test_df64_wide_launcher_refuses_a_bad_plan(cuda):
    """The wide fused launcher takes df64.fused_wide_plan's plan as given and
    returns cudaErrorInvalidValue (1) for another d_pad, chunk or shared
    memory, and for d <= 16; with the plan itself it launches."""
    n, d, q = 256, 20, 1
    uh, ul, V = _df64_inputs(cuda, n, d, q, seed=5)
    us = (uh.double() + ul.double()).contiguous()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = df64.fused_wide_plan(n, n, d, q, sms)
    fn = _build.bind("sqexp_fused", "sqexp_fused_wide_f64", 4, 9)
    partial = torch.empty((plan.splits, n, q), dtype=torch.float64, device=cuda)

    def launch(d_pad=plan.d_pad, dc=plan.dc, smem=plan.smem, width=d):
        return fn(us.data_ptr(), us.data_ptr(), V.data_ptr(), partial.data_ptr(), n, n, width,
                  q, plan.splits, plan.per, d_pad, dc, smem, _build.stream(cuda))

    assert launch() == 0
    torch.cuda.synchronize()
    for bad in (dict(d_pad=plan.d_pad + 4), dict(dc=df64.WIDE_DC), dict(smem=plan.smem + 8),
                dict(width=16, d_pad=16, dc=16)):
        assert launch(**bad) == 1, bad


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
    with pytest.raises(ValueError, match="aligned"):
        df64._launch_stored(torch.zeros(256 * 256 + 1, dtype=torch.float32, device=cuda)[1:]
                            .view(256, 256), V, torch.float32)


@pytest.mark.cuda
def test_df64_fused_launcher_checks_the_plan(cuda):
    """B3/B4's launcher takes the wrapper's plan only where its rows per
    thread are the ones it instantiates for q and the splits cover the
    column tiles with none empty; else it refuses before the launch."""
    uh, ul, V = _df64_inputs(cuda, 1024, 2, 1, seed=3)
    us = (uh.double() + ul.double()).contiguous()
    partial = torch.zeros((8, 1024, 1), dtype=torch.float64, device=cuda)
    fn = _build.bind("sqexp_fused", "sqexp_fused_f64", 4, 7)
    rpt = df64.FUSED_RPT[1]

    def launch(rpt, splits, per):
        return fn(us.data_ptr(), us.data_ptr(), V.data_ptr(), partial.data_ptr(), 1024, 1024, 2,
                  1, rpt, splits, per, _build.stream(us.device))

    assert launch(rpt, 4, 2) == 0  # 8 tiles in 4 splits of 2
    torch.cuda.synchronize()
    _within_scale(partial[:4].sum(dim=0), df64._fused_reference(us, us, V),
                  df64._fused_reference(us, us, V.abs()))
    other = next(r for r in (1, 2, 4) if r != rpt)
    for bad in ((rpt, 3, 2),  # tiles 6 and 7 in no split
                (rpt, 5, 2),  # an empty fifth split
                (rpt, 4, 0), (rpt, 0, 8),  # no tiles, no splits
                (other, 4, 2), (3, 4, 2)):  # rows per thread not instantiated for q = 1
        assert launch(*bad) != 0


@pytest.mark.cuda
def test_df64_stored_launcher_checks_the_plan(cuda):
    """B6's launcher takes the wrapper's plan only where it covers the
    matrix in whole boxes and tiles and the panel fits its buffer; else it
    refuses before the launch."""
    E = torch.ones((256, 256), dtype=torch.float64, device=cuda)
    V = torch.ones((256, 1), device=cuda)
    partial = torch.zeros((4, 256, 1), dtype=torch.float64, device=cuda)
    fn = _build.bind("sqexp_stored", "sqexp_stored_f64", 4, 6)

    def launch(rows, cols, panel):
        bounds = torch.tensor(rows + cols, dtype=torch.int32)
        return fn(E.data_ptr(), V.data_ptr(), partial.data_ptr(), bounds.data_ptr(), 256, 256,
                  1, len(rows) - 1, len(cols) - 1, panel, _build.stream(E.device))

    assert launch([0, 128, 256], [0, 128, 256], 1024) == 0
    torch.cuda.synchronize()
    assert torch.equal(partial.sum(dim=0), E @ V.double())
    for rows, cols, panel in (([0, 128, 252], [0, 128, 256], 1024),  # rows short of the end
                              ([0, 130, 256], [0, 128, 256], 1024),  # off a box of 4 rows
                              ([0, 256, 256], [0, 128, 256], 1024),  # an empty row group
                              ([0, 128, 256], [0, 64, 256], 1024),  # off a column tile
                              ([0, 128, 256], [0, 128, 256], 2048),  # wider than its buffer
                              ([0, 128, 256], [0, 128, 256], 96)):  # not whole tiles
        assert launch(rows, cols, panel) != 0


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


@pytest.mark.cuda
def test_cg_tier_product_on_card_matches_cpu(cuda):
    """The cg tier's system product at n = 4,096 in float64: kernel B2's
    rows in four blocks of 1,024, then the product with a (n, 3) block, on
    the card against the same on the CPU (B2's plain version): 1e-10 of the
    largest entry; one B2 launch a block."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 10, (4096, 2))
    kw = dict(hyperpars=[0.0, 0.3, 0.3], block_size=1024, preconditioner_rank=0, cg_maxiter=1,
              dtype="float64")
    args = (x, np.sin(x[:, 0]), np.full(4096, 0.1))
    card, cpu = LargeScaleGP(*args, device=cuda, **kw), LargeScaleGP(*args, device="cpu", **kw)
    V = rng.normal(size=(4096, 3))
    before = pairwise.KERNEL_LAUNCHES
    got = card._system_matmat(card._theta, torch.as_tensor(V, device=cuda)).cpu().numpy()
    assert pairwise.KERNEL_LAUNCHES - before == 4
    ref = cpu._system_matmat(cpu._theta, torch.as_tensor(V)).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def _averaging_inversion(n, m, seed=0):
    """n parameters on [0, 10]^2, m local-averaging data (weights exp(-d^2 /
    (2 * 0.5)), rows summing to 1), truth sin x0 cos(x1 / 2), y_err 0.02."""
    rng = np.random.default_rng(seed)
    xp, centres = rng.uniform(0, 10, (n, 2)), rng.uniform(0, 10, (m, 2))
    A = np.exp(-0.5 * ((centres[:, None] - xp[None]) ** 2).sum(-1) / 0.5)
    A /= A.sum(axis=1, keepdims=True)
    y = A @ (np.sin(xp[:, 0]) * np.cos(0.5 * xp[:, 1])) + rng.normal(0, 0.02, m)
    return y, np.full(m, 0.02), A, xp


@pytest.mark.cuda
def test_inverter_df64_stores_agree_on_card(cuda):
    """LargeScaleGpLinearInverter(solver="df64") at N = 4,096 (M = 512) on the
    card with store_entries="auto" (B5, then B6) and False (B3/B4): the
    data-space residual 1e-9, the two means within 1e-9 of the largest and
    four variances within 1e-9."""
    args = _averaging_inversion(4096, 512)
    kw = dict(block_size=1024, solver="df64", cg_tol=1e-11, cg_maxiter=8000, device=cuda)
    before = dict(df64.KERNEL_LAUNCHES)
    auto = LargeScaleGpLinearInverter(*args, [0.0, 0.0, 0.0], store_entries="auto", **kw)
    mid = dict(df64.KERNEL_LAUNCHES)
    fused = LargeScaleGpLinearInverter(*args, [0.0, 0.0, 0.0], store_entries=False, **kw)
    assert mid["B5"] - before["B5"] == 1 and mid["B6"] > before["B6"]
    assert df64.KERNEL_LAUNCHES["B4"] > mid["B4"] and df64.KERNEL_LAUNCHES["B5"] == mid["B5"]
    assert auto.residual_norm_f64() <= 1e-9 and fused.residual_norm_f64() <= 1e-9
    m_a, m_f = auto.calculate_posterior_mean(), fused.calculate_posterior_mean()
    assert np.abs(m_a - m_f).max() <= 1e-9 * np.abs(m_a).max()
    idx = [0, 1000, 2047, 4095]
    assert np.abs(auto.posterior_variances(idx) - fused.posterior_variances(idx)).max() <= 1e-9


@pytest.mark.cuda
def test_fit_step_on_card_matches_cpu(cuda):
    """One Adam step of LargeScaleGP.fit() (cg tier, float64, n = 2,048,
    rank 64: the batched solve and autograd through kernel B2's rows) on
    the card against the CPU: the gradient and theta within 1e-8."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 10, (2048, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, 2048)
    kw = dict(hyperpars=[0.5, 1.0, 1.0], block_size=1024, preconditioner_rank=64,
              dtype="float64", cg_tol=1e-8)
    steps = []
    for device in (cuda, "cpu"):
        gp = LargeScaleGP(x, y, np.full(2048, 0.1), device=device, **kw)
        probes = torch.as_tensor(np.random.default_rng(1).choice([-1.0, 1.0], (2048, 4)),
                                 device=device)
        theta = torch.as_tensor(gp.hyperpars, device=device)
        rhs = (gp._y - gp.mean_value) * gp._mask_dev
        step = gp._get_fit_step(1e-10, 2000, True)
        out = step(gp, theta, (torch.zeros_like(theta), torch.zeros_like(theta)),
                   torch.tensor(1.0, device=device), torch.tensor(0.1, device=device), rhs,
                   probes, gp._fit_precond_initial())
        steps.append((out[0].cpu().numpy(), out[2].cpu().numpy()))
    (theta_card, g_card), (theta_cpu, g_cpu) = steps
    assert np.abs(g_card - g_cpu).max() <= 1e-8 * np.abs(g_cpu).max()
    assert np.abs(theta_card - theta_cpu).max() <= 1e-8


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
@pytest.mark.parametrize("d, n", [(2, 4096), (3, 4096), (20, 4096), (33, 4096), (256, 512),
                                  (300, 512), (p3.D_RESIDENT, 256),
                                  (p3.D_RESIDENT + 1, 256), (1000, 256)])
def test_words_mma_tile_and_matvec(cuda, d, n):
    """One 32 x 16 tile of the class sums and their parts equal the plain
    version's exactly, on the data and on words of +-64 (the largest sums);
    the matvec matches its plain version and B3, one launch; past d = 256,
    where S passes int64, up to the largest d of the resident plan, and
    above it the streamed kernel (d = 412 and 1,000)."""
    uh, ul, us, v = p3.make_coords(n, d, cuda, seed=3)
    ops = p3.prepare(us.cpu().numpy(), cuda)
    for got, ref in zip(p3._launch_tile(ops), p3._tile_reference(ops)):
        assert torch.equal(got, ref)
    W = np.random.default_rng(d).choice([-64, 64], (32, p3.NW * d))
    rows, cols = p3._operands(W, d)
    big = {**ops, "rows": torch.as_tensor(rows, device=cuda), "cols": torch.as_tensor(cols, device=cuda)}
    for got, ref in zip(p3._launch_tile(big), p3._tile_reference(big)):
        assert torch.equal(got, ref)
    before = p3.KERNEL_LAUNCHES
    got = p3.words_matvec(ops, v)
    ref = p3._words_reference(ops, v)
    scale = df64._fused_reference(us, us, v.abs()[:, None])[:, 0]
    b3 = df64.sqexp_matvec_df64(uh, ul, v)
    torch.cuda.synchronize()
    assert p3.KERNEL_LAUNCHES == before + 1
    assert bool(torch.isfinite(got).all())
    assert float(((got - ref).abs() / scale).max()) <= DF64_ATOL
    assert float(((got - b3).abs() / scale).max()) <= 1e-11


@pytest.mark.cuda
def test_words_launcher_refuses_a_bad_plan(cuda):
    """The launcher returns cudaErrorInvalidValue (1) for another library's
    d, a split count that does not divide the column tiles evenly or an n
    off the 128 grid, and its plan splits the tiles evenly."""
    _, _, us, v = p3.make_coords(4096, 3, cuda, seed=0)
    ops = p3.prepare(us.cpu().numpy(), cuda)
    p = p3.plan(4096, 3, cuda)
    assert p["d"] == 3 and (p["ka"], p["kb"]) == (ops["rows"].shape[1], ops["cols"].shape[1])
    tiles = 4096 // p["tj"]
    assert -(-tiles // -(-tiles // p["splits"])) == p["splits"]
    partial = torch.empty((tiles, 4096), dtype=torch.float64, device=cuda)
    fn = _build.bind("sqexp_words_mma", "sqexp_words_mma", 5, 4, p3.kernel_variant(3))
    ptrs = (ops["rows"].data_ptr(), ops["cols"].data_ptr(), ops["norms"].data_ptr(), v.data_ptr(),
            partial.data_ptr())
    for n, d, splits in ((4096, 2, p["splits"]), (4096, 3, tiles + 1), (4000, 3, 1)):
        assert fn(*ptrs, ops["shift"], n, d, splits, _build.stream(cuda)) == 1
    assert fn(*ptrs, ops["shift"], 4096, 3, p["splits"], _build.stream(cuda)) == 0
    torch.cuda.synchronize()


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


# The Metropolis family on the card (no kernel of its own: the batched
# transitions of mcmc/_kernels/metropolis.py): gibbs, metropolis and pca
# ChainArrays against the same run on the CPU by statistics, every state
# tensor on the card; a numpy posterior's chains keep their state there.
def _gauss10(t):
    """bench.py's 10-dim correlated Gaussian of chain_batch_bench.py:
    d = t - roll(t, 1) / 2, logp = -|d|^2 / 2."""
    d = t - 0.5 * torch.roll(t, 1, dims=-1)
    return -0.5 * (d * d).sum(-1)


def _gauss10_cov():
    S = np.roll(np.eye(10), 1, axis=0)
    M = np.eye(10) - 0.5 * S
    return np.linalg.inv(M.T @ M)


def _state_devices(state):
    return {t.device.type for t in torch.utils._pytree.tree_leaves(state)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind, retry", [("gibbs", True), ("gibbs", False),
                                         ("metropolis", False), ("pca", False)])
def test_metropolis_family_chain_array_on_card(cuda, kind, retry):
    """128 chains of the 10-dim Gaussian on the card and on the CPU, from the
    same starts: after a warm-up (pca: then one update_directions) pooled
    variances within 10% of the truth on both devices, every state tensor on
    the card, rank-normalized R-hat below 1.05 there."""
    starts = np.random.default_rng(0).normal(0, 1, (128, 10))
    var = np.diag(_gauss10_cov())
    burn, n, width = {"gibbs": (100, 300, 1.0) if retry else (200, 500, 1.0),
                      "metropolis": (500, 2000, 0.7), "pca": (200, 500, 1.0)}[kind]
    for device in (cuda, "cpu"):
        ca = ChainArray(kind, _gauss10, starts, widths=width, retry=retry, seed=1, device=device)
        ca.advance(burn)
        if kind == "pca":
            ca.update_directions()
        ca.advance(n)
        np.testing.assert_allclose(ca.get_sample(burn=burn).var(0), var, rtol=0.1)
        if device == cuda:
            assert _state_devices(ca._state) == {"cuda"}
            assert ca.rhat(burn=burn).max() < 1.05


@pytest.mark.cuda
def test_numpy_posterior_state_stays_on_card(cuda):
    """A numpy posterior runs on the host while the chain's state stays on
    the card: GibbsChain and ChainArray('gibbs'), their log-probabilities
    those of the numpy function."""
    from inference_tpu_torch import GibbsChain, HamiltonianChain

    def rosen(t):
        x, y = t
        return float(-((1 - x) ** 2) - 100 * (y - x**2) ** 2)

    chain = GibbsChain(rosen, start=np.array([2.0, -4.0]), display_progress=False, seed=0,
                       device=cuda)
    assert chain._logp.host
    chain.advance(200)
    assert _state_devices(chain._state) == {"cuda"}
    np.testing.assert_allclose(chain.get_probabilities(0)[-1], rosen(chain.get_last()), rtol=1e-5)
    hmc = HamiltonianChain(rosen, start=np.array([0.5, 0.3]), display_progress=False, seed=0,
                           device=cuda)
    hmc.steps = 10
    hmc.advance(20)
    assert _state_devices(hmc._state) == {"cuda"} and np.isfinite(hmc.get_sample(0)).all()
    ca = ChainArray("gibbs", rosen, np.random.default_rng(1).normal(0.5, 0.3, (64, 2)), seed=0,
                    device=cuda)
    ca.advance(20)
    assert _state_devices(ca._state) == {"cuda"}
    np.testing.assert_allclose(ca.logp, [rosen(t) for t in ca.theta], rtol=1e-4, atol=1e-4)


def _bimodal(t):
    x = t[0]
    return torch.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2,
                           -0.5 * ((x - 4.0) / 0.5) ** 2 + np.log(0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["GibbsChain", "HamiltonianChain"])
def test_tempering_ladder_on_card_matches_cpu(cuda, cls):
    """A 4-rung ladder in float64 on the card and on the CPU from the same
    starts: the rung-batched step on injected draws and the swap on the
    device with the same pairs and uniforms give the same states (1e-12);
    a fused advance keeps every state tensor on the card."""
    import inference_tpu_torch.mcmc as mcmc
    from inference_tpu_torch.mcmc.parallel import _swap_on_device

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        temps, R = [1.0, 2.0, 4.0, 8.0], 4
        rng = np.random.default_rng(0)
        starts = rng.uniform(-5, 5, R)
        ladders = {}
        for device in (cuda, "cpu"):
            chains = [getattr(mcmc, cls)(_bimodal, start=np.array([s]), temperature=T,
                                         display_progress=False, seed=k, device=device)
                      for k, (s, T) in enumerate(zip(starts, temps))]
            for c in chains:
                c.steps = 8
            ladders[str(torch.device(device).type)] = mcmc.ParallelTempering(chains)
        if cls == "HamiltonianChain":
            A = 200
            draws = [rng.normal(size=(A, R, 1)), rng.uniform(size=(A, R)), rng.uniform(size=(A, R))]
        else:
            draws = [rng.normal(size=(400, R)), rng.uniform(size=(400, R))]
        pairs, uniforms = [[0, 1], [2, 3]], [0.3, 0.6]
        out = {}
        for name, pt in ladders.items():
            dev = pt._batched_state.theta.device
            with torch.no_grad():
                state, _ = pt._vstep(pt._batched_state, None,
                                     *(torch.as_tensor(d, device=dev) for d in draws))
            state, acc = _swap_on_device(state, torch.tensor(pairs, device=dev),
                                         torch.tensor(uniforms, device=dev))
            out[name] = (state.theta.cpu().numpy(), state.logp.cpu().numpy(), acc.tolist())
        for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
        assert out["cuda"][2] == out["cpu"][2]
        pt = ladders["cuda"]
        pt.advance(40, swap_interval=10)
        assert _state_devices(pt._batched_state) == {"cuda"}
        assert all(c.chain_length == 41 for c in pt.return_chains())
    finally:
        torch.set_default_dtype(old)


@pytest.mark.cuda
@pytest.mark.parametrize("retry", [False, True])
def test_ensemble_step_on_card_matches_cpu(cuda, retry):
    """The batched stretch move of 2 ensembles of 64 walkers in float64 on
    injected draws gives the same walkers, logps and proposal counts on the
    card and on the CPU (1e-12); EnsembleSampler and ChainArray("ensemble")
    keep their state on the card."""
    from inference_tpu_torch.mcmc import EnsembleSampler
    from inference_tpu_torch.mcmc._kernels import ensemble as ens

    C, W, P, A = 2, 64, 3, 100
    rng = np.random.default_rng(1)
    walkers = rng.normal(size=(C, W, P))
    h = W // 2
    draws = [tuple(torch.as_tensor(x) for x in (rng.integers(0, h, (A, C, h)),
                                                rng.uniform(size=(A, C, h)),
                                                rng.uniform(size=(A, C, h))))
             for _ in range(2)]
    logp = lambda t: -0.5 * (t * t).sum(-1)
    out = {}
    for device in (cuda, "cpu"):
        w = torch.as_tensor(walkers, device=device)
        state = ens.init_ensemble_state(w, logp(w))
        step = ens.make_ensemble_step(logp, n_walkers=W, retry=retry)
        for _ in range(3):
            state, o = step(state, None, draws)
        out[torch.device(device).type] = (state.walkers.cpu().numpy(), state.logps.cpu().numpy(),
                                          o.attempts.cpu().numpy())
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    es = EnsembleSampler(lambda t: -0.5 * (t * t).sum(), walkers[0], display_progress=False,
                         seed=0, retry=retry, device=cuda)
    es.advance(20)
    assert _state_devices(es._state) == {"cuda"} and np.isfinite(es.get_sample()).all()
    ca = ChainArray("ensemble", lambda t: -0.5 * (t * t).sum(), walkers, retry=retry, seed=0,
                    device=cuda)
    ca.advance(20)
    assert _state_devices(ca._state) == {"cuda"} and ca.get_sample().shape == (20 * C * W, P)


@pytest.mark.cuda
def test_nuts_step_on_card_matches_cpu(cuda):
    """Three batched NUTS transitions of 32 chains in float64 on injected
    draws give the same positions, logps and cached gradients on the card
    and on the CPU (1e-12), the same depths, leapfrog counts and divergence
    flags; ChainArray("nuts"), NutsChain and a NUTS ladder keep their state
    on the card."""
    from inference_tpu_torch.mcmc import NutsChain, ParallelTempering
    from inference_tpu_torch.parallel._kinds import build_kind

    K, P, D = 32, 4, 6
    rng = np.random.default_rng(2)
    B = rng.normal(size=(P, P)) / 2
    icov = np.linalg.inv(B @ B.T + np.eye(P))
    starts = rng.normal(size=(K, P))
    draws = [(rng.normal(size=(K, P)), rng.uniform(size=(K, D)), rng.uniform(size=(K, D)),
              rng.uniform(size=(K, 2**D - 1))) for _ in range(3)]
    out = {}
    for device in (cuda, "cpu"):
        A = torch.as_tensor(icov, device=device)
        logp = lambda t, A=A: -0.5 * t @ A @ t
        init, step = build_kind("nuts", logp, P, torch.float64, device, epsilon=0.4, max_depth=D)
        theta = torch.as_tensor(starts, device=device)
        with torch.no_grad():
            state = init(theta, torch.func.vmap(logp)(theta))
            for d in draws:
                state, o = step(state, None, *(torch.as_tensor(x, device=device) for x in d))
        out[torch.device(device).type] = [x.cpu().numpy() for x in (
            state.theta, state.logp, state.grad, o.tree_depth, o.leapfrog_steps, o.divergent)]
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    for got, want in zip(out["cuda"][3:], out["cpu"][3:]):
        np.testing.assert_array_equal(got, want)
    A32 = torch.as_tensor(icov, dtype=torch.float32, device=cuda)
    gauss = lambda t: -0.5 * t @ A32 @ t  # one callable: the ladder batches its rungs
    ca = ChainArray("nuts", gauss, starts, max_depth=D, seed=0, device=cuda)
    ca.advance(10)
    chain = NutsChain(gauss, start=starts[0], max_depth=D, display_progress=False, seed=0,
                      device=cuda)
    chain.advance(10)
    pt = ParallelTempering([NutsChain(gauss, start=s, temperature=T, max_depth=D,
                                      display_progress=False, seed=k, device=cuda)
                            for k, (s, T) in enumerate(zip(starts, [1.0, 4.0]))])
    assert not pt._heterogeneous
    pt.advance(20, swap_interval=5)
    for state in (ca._state, chain._state, pt._batched_state):
        assert _state_devices(state) == {"cuda"}
    assert chain.tree_depths.shape == (11,) and np.isfinite(ca.get_sample()).all()


@pytest.mark.cuda
def test_kde_on_card_matches_cpu(cuda):
    """GaussianKDE with cross-validation, KDE2D and UnimodalPdf on the card
    against the CPU on one sample: the bandwidth, pdf and cdf within 1e-10,
    the same objective at the CPU's MAP (1e-12); sample_hdi_device on the
    card equals sample_hdi."""
    from inference_tpu_torch.pdf import (KDE2D, GaussianKDE, UnimodalPdf, sample_hdi,
                                         sample_hdi_device)

    rng = np.random.default_rng(3)
    s = rng.normal(0, 1, 6000) + rng.exponential(1.0, 6000)
    x = np.linspace(-3.0, 8.0, 2000)
    kdes = [GaussianKDE(s, cross_validation=True, rng=np.random.default_rng(0), device=d)
            for d in (cuda, "cpu")]
    assert kdes[0].h == pytest.approx(kdes[1].h, rel=1e-10)
    np.testing.assert_allclose(kdes[0](x), kdes[1](x), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(kdes[0].cdf(x), kdes[1].cdf(x), rtol=1e-10, atol=1e-14)
    y = rng.normal(size=6000)
    np.testing.assert_allclose(KDE2D(s, y, device=cuda)(x, x), KDE2D(s, y, device="cpu")(x, x),
                               rtol=1e-10, atol=1e-14)
    card, cpu = UnimodalPdf(s, device=cuda), UnimodalPdf(s, device="cpu")
    assert card.posterior(cpu.MAP) == pytest.approx(cpu.posterior(cpu.MAP), rel=1e-12)
    assert card.posterior(card.MAP) >= cpu.posterior(cpu.MAP) - 1e-9 * abs(cpu.posterior(cpu.MAP))
    two = np.stack([s, y], axis=1)
    for f in (0.3, 0.9):
        np.testing.assert_array_equal(
            sample_hdi_device(torch.as_tensor(two, device=cuda), f).cpu().numpy(),
            sample_hdi(two, f))
