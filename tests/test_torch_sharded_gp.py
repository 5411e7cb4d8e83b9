"""The row-sharded df64 matmat and ``mesh=`` of the matrix-free GP and
inverter in the PyTorch port, against the JAX package on its 8 virtual CPU
devices and against the port without a mesh, at the multi-device dryrun's
size (n = 1,024 = 128 x 8 cells), on a ``chain_mesh(8)`` of CPU cells.

Tolerances, with reasons:

- the sharded matmat against JAX's: 1e-7 of max |truth| (the JAX pair
  arithmetic's own contract, tests/test_df64.py, as in
  test_torch_df64_ops.py); against the port's unsharded B4: 1e-13 of
  sum_j |E_ij| |V_jk| per row (each row's sum runs in another blocking);
- ``LargeScaleGP(solver="df64", mesh=)`` against JAX's: means 1e-6 (the
  JAX test's bound, set by its pair arithmetic's operator noise amplified
  by |alpha|), the FP64 residual below the dryrun's 1e-6 on both; against
  the port without a mesh: alpha 1e-12 of max |alpha| (the same FP64
  operator, rows summed in blocks), means 1e-10, variances 1e-8 (their
  solves stop at cg_tol 1e-8, each on iterates whose products sum the
  rows in other blocks);
- the cg tier (float64) against JAX's with a mesh: means 1e-5 (each stops
  at cg_tol 1e-6 on its own iterates); against the port without a mesh
  exactly (the same blocks in the same order, dealt to cells of one
  device);
- the df64 inverter against JAX's: the posterior mean 1e-6 of its max
  (test_torch_large_inversion.py's bound); without a mesh 1e-8 of it (the
  data-space solves stop at cg_tol 1e-9, each on iterates whose prior
  products sum the rows in other blocks, and the A products carry the
  difference through the data-space condition); the cg tier exactly.
"""

import numpy as np
import pytest
import torch

from inference_tpu.gp import LargeScaleGP as JaxLargeScaleGP
from inference_tpu.gp import LargeScaleGpLinearInverter as JaxInverter
from inference_tpu.ops import df64 as jdf64
from inference_tpu.parallel import chain_mesh as jax_chain_mesh
from inference_tpu_torch.gp import LargeScaleGP, LargeScaleGpLinearInverter
from inference_tpu_torch.ops import df64
from inference_tpu_torch.parallel import chain_mesh, tempering_mesh
from inference_tpu_torch.parallel.mesh import Cell, Mesh, cell_grid

N = 1024  # the dryrun's n: one 128-row tile per cell of 8
KW = dict(hyperpars=np.array([0.0, 0.0, 0.0]), block_size=128, preconditioner_rank=64)


@pytest.fixture(autouse=True, scope="module")
def _float64():
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dt)


def dryrun_problem(n=N):
    """``__graft_entry__._dryrun_body``'s GP problem."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 8, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(0.5 * x[:, 1])
    return x, y, np.full(n, 0.05)


def cpu_mesh(n=8):
    return chain_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def df64_pair():
    """The dryrun's sharded df64 solve in both packages, each once."""
    x, y, err = dryrun_problem()
    kw = dict(KW, solver="df64", cg_tol=1e-8)
    jgp = JaxLargeScaleGP(x, y, err, mesh=jax_chain_mesh(8), **kw)
    tgp = LargeScaleGP(x, y, err, mesh=cpu_mesh(), device="cpu", **kw)
    return x, y, err, jgp, tgp


def test_sharded_matmat_matches_jax_and_unsharded():
    x, _, _ = dryrun_problem()
    uh, ul = df64.split_f64(x)
    V = np.random.default_rng(1).normal(size=(N, 3)).astype(np.float32)
    got = df64.sqexp_matmat_df64_sharded(torch.as_tensor(uh), torch.as_tensor(ul),
                                         torch.as_tensor(V), cpu_mesh()).numpy()
    ref = np.asarray(jdf64.sqexp_matmat_df64_sharded(uh, ul, V, jax_chain_mesh(8)))
    assert got.shape == ref.shape == (N, 3) and got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-7 * np.abs(ref).max()
    one = df64.sqexp_matmat_df64(torch.as_tensor(uh), torch.as_tensor(ul), torch.as_tensor(V))
    E = np.exp(-0.5 * ((x[:, None, :] - x[None]) ** 2).sum(-1))
    scale = E @ np.abs(V.astype(np.float64))
    assert (np.abs(got - one.numpy()) <= 1e-13 * scale).all()


@pytest.mark.parametrize("n_cells, n", [(8, 1000), (3, 1024)])
def test_sharded_matmat_row_alignment_error_matches_jax(n_cells, n):
    """JAX's error for rows that do not split into 128-row blocks."""
    uh = np.zeros((n, 2), np.float32)
    V = np.zeros((n, 1), np.float32)
    errors = []
    for fn, mesh in ((jdf64.sqexp_matmat_df64_sharded, jax_chain_mesh(n_cells)),
                     (df64.sqexp_matmat_df64_sharded, cpu_mesh(n_cells))):
        with pytest.raises(ValueError) as info:
            fn(uh, uh, V, mesh)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_sharded_matmat_counts_one_launch_a_cell_on_the_card_only():
    """On CPU cells it runs B4's plain version and counts no launch; the
    card test holds the launches (tests/test_torch_cuda.py)."""
    before = dict(df64.KERNEL_LAUNCHES)
    uh = torch.zeros((256, 2), dtype=torch.float32)
    df64.sqexp_matmat_df64_sharded(uh, uh, torch.ones((256, 1), dtype=torch.float32),
                                   cpu_mesh(2))
    assert df64.KERNEL_LAUNCHES == before


def test_df64_solve_on_a_mesh_matches_jax(df64_pair):
    x, _, _, jgp, tgp = df64_pair
    assert tgp._entries is None and tgp._tier is None  # "auto" stores nothing on a mesh
    q = x[:16]
    mj, mt = np.asarray(jgp(q)), tgp(q)
    assert np.abs(mt - mj).max() < 1e-6
    assert tgp.residual_norm_f64(residual_backend="host") < 1e-6
    assert jgp.residual_norm_f64(residual_backend="host") < 1e-6


def test_df64_solve_on_a_mesh_matches_one_device(df64_pair):
    x, y, err, _, tgp = df64_pair
    one = LargeScaleGP(x, y, err, device="cpu", store_entries=False, solver="df64", cg_tol=1e-8,
                       **KW)
    scale = np.abs(one.alpha64).max()
    assert np.abs(tgp.alpha64 - one.alpha64).max() <= 1e-12 * scale
    mean_m, var_m = tgp(x[:4], with_variance=True)
    mean_1, var_1 = one(x[:4], with_variance=True)
    assert np.abs(mean_m - mean_1).max() <= 1e-10 and np.abs(var_m - var_1).max() <= 1e-8


def test_df64_sharded_products_launch_b4_per_cell(monkeypatch, df64_pair):
    """Every df64 product of a mesh goes through the sharded matmat, the
    single vectors as one column."""
    x, y, err, _, tgp = df64_pair
    calls = []
    real = df64.sqexp_matmat_df64_sharded
    import inference_tpu_torch.gp.large_scale as tls

    def spy(us_hi, us_lo, V, mesh):
        calls.append(V.shape[1])
        return real(us_hi, us_lo, V, mesh)

    monkeypatch.setattr(tls, "sqexp_matmat_df64_sharded", spy)
    tgp.residual_norm_f64()
    assert calls == [1, 1]  # the hi and lo words of alpha


@pytest.mark.parametrize("solver", ["cg", "mixed"])
def test_cg_tiers_on_a_mesh(solver):
    """The cg and mixed tiers deal their row blocks to the cells: against
    JAX's sharded instance and, exactly, against the port's on one device."""
    x, y, err = dryrun_problem()
    kw = dict(KW, solver=solver, cg_tol=1e-6)
    mesh = cpu_mesh()
    tgp = LargeScaleGP(x, y, err, mesh=mesh, device="cpu", dtype="float64", **kw)
    one = LargeScaleGP(x, y, err, device="cpu", dtype="float64", **kw)
    assert torch.equal(tgp.alpha, one.alpha)
    if solver == "cg":
        jgp = JaxLargeScaleGP(x, y, err, mesh=jax_chain_mesh(8), dtype="float64", **kw)
        q = x[:16]
        assert np.abs(tgp(q) - np.asarray(jgp(q))).max() < 1e-5
    assert tgp.residual_norm_f64() < 1e-5


def test_fit_on_a_mesh_equals_one_device():
    x, y, err = dryrun_problem(512)
    kw = dict(KW, solver="cg", cg_tol=1e-6, dtype="float64", device="cpu")
    a = LargeScaleGP(x, y, err, mesh=cpu_mesh(4), **kw)
    b = LargeScaleGP(x, y, err, **kw)
    np.testing.assert_array_equal(a.fit(n_steps=2, n_probes=2), b.fit(n_steps=2, n_probes=2))


def test_mesh_validation_matches_jax():
    """store_entries=True or "f32" with a mesh, and rows that do not split
    over the cells, raise JAX's errors."""
    x, y, err = dryrun_problem(1000)
    cases = [dict(store_entries=True), dict(store_entries="f32")]
    for extra in cases + [dict(block_size=200)]:
        kw = dict(KW, solver="df64", **extra)
        errors = []
        for cls, mesh, dev in ((JaxLargeScaleGP, jax_chain_mesh(8), {}),
                               (LargeScaleGP, cpu_mesh(), dict(device="cpu"))):
            with pytest.raises(ValueError) as info:
                cls(x, y, err, mesh=mesh, **kw, **dev)
            errors.append(str(info.value))
        assert errors[0] == errors[1], extra


def test_mesh_across_processes_raises_naming_a13c():
    """The GP across processes is ported (its working case runs in two
    processes, tests/test_torch_multihost.py): a mesh with a cell of a
    process that does not exist (rank 1 with no process group) raises the
    Layout's ValueError."""
    x, y, err = dryrun_problem(256)
    mesh = Mesh(cell_grid([Cell(0, torch.device("cpu")), Cell(1, torch.device("cpu"))], (2,)),
                ("chains",))
    message = r"every process of the group must hold the same number of mesh cells"
    for solver in ("df64", "cg"):
        with pytest.raises(ValueError, match=message):
            LargeScaleGP(x, y, err, mesh=mesh, solver=solver, device="cpu", **KW)
    A = np.eye(256)[:64]
    with pytest.raises(ValueError, match=message):
        LargeScaleGpLinearInverter(y[:64], err[:64], A, x, [0.0, 0.0, 0.0], block_size=128,
                                   mesh=mesh, device="cpu")


def test_a_tempering_mesh_shards_gp_rows_over_its_first_axis():
    """As in JAX, the GP's rows split over a mesh's first axis."""
    x, y, err = dryrun_problem(512)
    gp = LargeScaleGP(x, y, err, mesh=tempering_mesh(4, 8, device="cpu"), solver="df64",
                      device="cpu", cg_tol=1e-8, **KW)
    assert len(gp._cells) == 4 and gp.residual_norm_f64() < 1e-6


def inversion_problem(n=N, m=128, seed=5, err=0.05):
    """A local-averaging inversion over the dryrun's points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (n, 2))
    centres = rng.uniform(0, 10, (m, 1, 2))
    A = np.exp(-((centres - x) ** 2).sum(-1))
    A /= A.sum(1, keepdims=True)
    y = A @ np.sin(x[:, 0]) + rng.normal(0, err, m)
    return y, np.full(m, err), A, x


@pytest.mark.parametrize("solver", ["df64", "cg"])
def test_inverter_on_a_mesh(solver):
    y, err, A, xp = inversion_problem()
    kw = dict(block_size=128, solver=solver, cg_tol=1e-9)
    if solver == "cg":
        kw["dtype"] = "float64"
    tinv = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], mesh=cpu_mesh(),
                                      device="cpu", **kw)
    one = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], device="cpu",
                                     store_entries=False if solver == "df64" else "auto", **kw)
    mt, m1 = tinv.calculate_posterior_mean(), one.calculate_posterior_mean()
    limit = 1e-8 if solver == "df64" else 0.0
    assert np.abs(mt - m1).max() <= limit * np.abs(m1).max()
    if solver == "df64":
        jinv = JaxInverter(y, err, A, xp, [0.0, 0.0, 0.0], mesh=jax_chain_mesh(8), **kw)
        mj = np.asarray(jinv.calculate_posterior_mean())
        assert np.abs(mt - mj).max() <= 1e-6 * np.abs(mj).max()
        assert tinv.residual_norm_f64() < 1e-8
        with pytest.raises(ValueError) as port_error:
            LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], mesh=cpu_mesh(),
                                       device="cpu", store_entries=True, **kw)
        with pytest.raises(ValueError) as jax_error:
            JaxInverter(y, err, A, xp, [0.0, 0.0, 0.0], mesh=jax_chain_mesh(8),
                        store_entries=True, **kw)
        assert str(port_error.value) == str(jax_error.value)
