"""Matrix-free Gaussian-process regression for large datasets.

Port of ``inference_tpu.gp.large_scale``. ``LargeScaleGP`` solves
``(K + diag(sigma^2) + noise + jitter I) alpha = y - m`` without forming K,
in one of three tiers:

- ``solver="cg"`` (the default) and ``"mixed"``: K's action is computed in
  row blocks of ``block_size``, each block's rows by the kernel adapter of
  ``gp.block_kernels`` (kernel B2 for the squared exponential) and then one
  product with the vector or block, in the working dtype (``dtype``, by
  default ``utils.dtypes.default_float()``). ``"cg"`` runs the port's
  ``ops.solvers.cg``, the JAX package's ``jax.scipy`` CG step for step;
  ``"mixed"`` runs ``ops.solvers.mixed_pcg`` (float64 scalars, true-residual
  restarts). The preconditioner is a rank-m Woodbury application of a
  pivoted Cholesky or Nystrom factor, its core inverted on the host in
  float64 and applied in FP64. Predictive variances come from one batched
  ``pcg_multi`` solve.
- ``solver="df64"``, the small-noise tier, in FP64 throughout: kernel B6 on
  the FP64 entry store of kernel B5 (``store_entries="auto"`` or ``True`` up
  to ``ops.df64.STORE_MAX_N``), the fused kernels B3/B4 that evaluate the
  entries in every product (``store_entries=False``), or, with
  ``store_entries="f32"``, kernel B8 on the float32-rounded store of kernel
  B7 for the iterations and B3/B4 for each chunk's residual refresh (mixed-
  precision iterative refinement, as in the JAX package). Its CG has float64
  iterates (``ops.solvers.Df64Solver``); predictive variances run one
  batched solve per eight query points (``Df64MultiSolver``).

``fit()`` maximises the marginal likelihood in any tier by Adam on
Hutchinson-trace gradients: one ``pcg_multi`` a step over the data and the
Rademacher probes, and the gradient of the surrogate by autograd through
the blocked system product, one row block alive at a time.

The JAX package runs the df64 tier in float32-pair arithmetic because the
TPU has no float64. The card has, and these of its choices become design
decisions:

- **Pivoted Cholesky on the device in FP64** in every tier, with the same
  pivot order as the JAX package's builds (``torch.argmax`` takes the first
  maximum, as ``np.argmax`` and ``jnp.argmax`` do), the factor then cast to
  the working dtype. The JAX package builds the df64 tier's factor on the
  host in float64 because its device build is float32, and that build
  repeats pivots in float32 on the card (see ``_pivoted_cholesky``).
- **FP64 device arrays in the df64 tier.** x, y, the factor U and the core
  inverse are FP64 on the device; the JAX package's float32 casts for its
  traced prediction paths have no job there, so in that tier ``dtype`` is
  taken and checked but changes nothing.
- **K(q, x) for the df64 tier's predictions** is built on the device in
  FP64 through the kernel adapter (kernel B2, exact coordinate
  differences). The JAX package's host numpy ``sqexp_rows_host64`` stays,
  for the host residual and the parity tests.
- **The cg and mixed tiers apply the preconditioner in FP64**: 1/d and
  the core's explicit inverse (from an FP64 Gram), the result cast to the
  working dtype, as the JAX package's ``fit()`` applies it. The JAX
  package's solves apply the core by its Cholesky factor in the working
  dtype; in float32 on the card that stagnated at gp-large-cg-50k's
  configuration (N = 50,000, sigma = 0.1, ranks 2,048 and 4,096: relative
  residual 0.6-0.8 after 120 iterations, where the FP64 application
  reached 1.7e-4 in 10, measured on an H100). The Woodbury subtraction
  cancels about log10(amp^2 N / sigma^2) digits on the data's smooth
  directions, more than float32 holds.
- **Residual backend.** ``"auto"`` resolves to ``"df64"`` (the FP64 fused
  kernel) in the df64 tier and to ``"device"`` (the blocked system product
  in FP64 on the device) in the others. The JAX rule (its emulated-float64
  program up to 16,384 rows, the pair kernel on a TPU, the host beyond)
  guards TPU limits the card does not have.
- **Variance solves of the df64 tier** run to ``cg_tol``: the JAX package
  floors their tolerance at 1e-8, the noise of its pair arithmetic, which
  FP64 does not have.

``mesh=`` (a ``parallel.mesh.Mesh``, its first axis) deals the work to
the cells of a mesh, as the JAX package shards it over devices: the
df64 tier's products run kernel B4 on each cell's block of rows
(``ops.df64.sqexp_matmat_df64_sharded``; its single vectors too, as one
column) and store no entries, and the cg and mixed tiers' system product
deals its row blocks to the cells in turn. A mesh may span processes
(``parallel.multihost``): each process passes the full data, runs its own
cells' blocks and gathers the rest (``parallel._collectives.deal_blocks``),
so every process holds every product and takes the same solver steps. A
mesh naming processes that do not exist raises ``ValueError``.
"""

from functools import partial
from warnings import warn

import numpy as np
import torch

from ..ops.df64 import (
    _TI,
    _TJ,
    mesh_row_cells,
    split_f64,
    sqexp_entries_df64,
    sqexp_entries_f32,
    sqexp_matmat_df64,
    sqexp_matmat_df64_sharded,
    sqexp_matvec_df64,
    sqexp_stored_f32_matmat,
    sqexp_stored_matmat_df64,
    sqexp_stored_matvec_df64,
    stored_entries_tier,
)
from ..ops.solvers import Df64MultiSolver, Df64Solver, cg, mixed_pcg, pcg_multi
from ..utils.device import resolve_device
from ..utils.dtypes import default_float
from .block_kernels import as_block_kernel, sqexp_rows_host64  # noqa: F401 (re-exported under its JAX module)
from .covariance import SquaredExponential


def woodbury_apply(V, U, dinv, core, *, core_chol, out_dtype=None):
    """``(D + U U^T)^{-1} V`` for a vector or (n, q) block ``V`` by the
    Woodbury identity: the one application of the low-rank preconditioner.
    ``U`` (n, m); ``dinv`` the elementwise ``1/diag(D)`` in the application
    dtype (float64 at small noise: the core's condition reaches ``amp^2 N /
    sigma^2`` and the subtraction cancels about log10 of it in digits);
    ``core`` the lower Cholesky factor of ``C = I + U^T D^{-1} U``
    (``core_chol=True``) or its explicit inverse (``core_chol=False``). The
    result is cast to ``out_dtype`` when given."""
    vec = V.ndim == 1
    W = (V[:, None] if vec else V).to(dinv.dtype) * dinv[:, None]
    U_ = U.to(dinv.dtype)
    t = U_.T @ W
    t = torch.cholesky_solve(t, core) if core_chol else core @ t
    out = W - dinv[:, None] * (U_ @ t)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out[:, 0] if vec else out


def _system_matvec(amp2, diag, v32, *op):
    """``(amp2 E + diag) v`` for a float32 vector, float64 out: kernel B6 on
    the FP64 store ``op = (E,)``, B8 on the float32 store, kernel B3 on the
    coordinate pair ``op = (us_hi, us_lo)``, or B4 on each cell's rows with
    ``op = (us_hi, us_lo, mesh)``."""
    if len(op) == 3:
        Ev = sqexp_matmat_df64_sharded(op[0], op[1], v32[:, None], op[2])[:, 0]
    elif len(op) == 2:
        Ev = sqexp_matvec_df64(op[0], op[1], v32)
    elif op[0].dtype == torch.float32:
        Ev = sqexp_stored_f32_matmat(op[0], v32[:, None])[:, 0]
    else:
        Ev = sqexp_stored_matvec_df64(op[0], v32)
    return amp2 * Ev + diag * v32.double()


def _entries_apply(V32, *op):
    """``E V`` through the FP64 store (kernel B6), the float32 store (B8),
    the fused kernel (B4), or B4 on each cell's rows of a mesh."""
    if len(op) == 3:
        return sqexp_matmat_df64_sharded(op[0], op[1], V32, op[2])
    if len(op) == 2:
        return sqexp_matmat_df64(op[0], op[1], V32)
    if op[0].dtype == torch.float32:
        return sqexp_stored_f32_matmat(op[0], V32)
    return sqexp_stored_matmat_df64(op[0], V32)


def _system_matmat(amp2, diag, V32, *op):
    """``(amp2 E + diag) V`` for a float32 (n, q) block: kernel B6, B8 or
    B4."""
    return amp2 * _entries_apply(V32, *op) + diag[:, None] * V32.double()


def blocked_rows_product(rows, x, theta, V, step, cells=None):
    """``K(x, x) V`` in row blocks of ``step`` (one block alive at a time),
    each block's kernel rows by ``rows`` then one product with V; with
    ``cells`` (a mesh's first-axis cells), block b on the device of cell
    ``b % len(cells)`` by the process that holds it, the blocks back in
    order on x's device (gathered from the other processes when the cells
    span processes)."""
    n = x.shape[0]
    if cells is None:
        return torch.cat([rows(x[s : s + step], x, theta) @ V for s in range(0, n, step)])
    on = {}

    def block(b, d):
        if d not in on:
            on[d] = (x.to(d), theta.to(d), V.to(d))
        xd, td, Vd = on[d]
        return rows(xd[b * step : (b + 1) * step], xd, td) @ Vd

    from ..parallel._collectives import deal_blocks

    return deal_blocks(cells, step, n, block, x.device)


def mesh_cells(mesh, solver, n_padded, owner, what):
    """The cells of a mesh's first axis (None without a mesh), after the
    JAX package's row-alignment check of the df64 tier."""
    if mesh is None:
        return None
    cells = mesh_row_cells(mesh, owner)
    n_dev = len(cells)
    if solver == "df64" and n_padded % (n_dev * _TI) != 0:
        raise ValueError(
            f"[ {owner} error ] solver='df64' on a {n_dev}-device mesh needs the padded "
            f"{what} ({n_padded}) to split into per-device blocks that are multiples of "
            f"{_TI}; adjust block_size."
        )
    return cells


def _as_dtype(dtype, owner="LargeScaleGP"):
    """The torch dtype of the JAX package's ``dtype`` values: None, or
    float32/float64 as a name, numpy or torch dtype; anything else raises,
    naming ``owner``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        if dtype in (torch.float32, torch.float64):
            return dtype
    else:
        try:
            np_dtype = np.dtype(dtype)
        except TypeError:
            np_dtype = None
        if np_dtype in (np.float32, np.float64):
            return torch.float32 if np_dtype == np.float32 else torch.float64
    raise ValueError(
        f"[ {owner} error ] 'dtype' must be None, float32 or float64, but "
        f"{dtype!r} was given."
    )


def _adam(theta, adam, g, t, lr):
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8), the JAX package's
    arithmetic in theta's dtype. Returns ``(theta, (m, v))``."""
    m, v = adam
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    m_hat = m / (1.0 - b1**t)
    v_hat = v / (1.0 - b2**t)
    return theta - lr * m_hat / (torch.sqrt(v_hat) + eps), (m, v)


def _worst_relative_residual(R, B):
    """``sqrt(max_k |R_k|^2 / |B_k|^2)`` over the columns, in their dtype."""
    return torch.sqrt(torch.max((R * R).sum(dim=0) / (B * B).sum(dim=0)))


class LargeScaleGP:
    """
    GP regression with matrix-free training solves, for datasets beyond the
    reach of dense factorisation; hyperparameters are selected at that scale
    too (``fit()``).

    :param x: data positions, shape (n_points, n_dims).
    :param y: data values, shape (n_points,).
    :param y_err: per-point Gaussian error standard deviations.
    :param hyperpars: the kernel's hyperparameter vector: ``[ln A, ln
        l_1..l_D]`` for the default ``SquaredExponential`` (a known constant
        mean, as ``mean_value``), ``[ln A, ln alpha, ln l_1..l_D]`` for
        ``RationalQuadratic``; a ``+ WhiteNoise()`` composition adds its
        ``ln sigma_w`` in the dense composite's slice order.
    :param kernel: ``SquaredExponential`` (default), ``RationalQuadratic``
        or either ``+ WhiteNoise()`` (class or instance); others raise (see
        ``gp.block_kernels``). The df64 tier takes the squared exponential
        only.
    :param mean_value: constant mean (defaults to the data mean).
    :param block_size: rows of each kernel block; the data is padded with
        inert rows to a multiple of it (a multiple of 128 for df64).
    :param cg_tol: relative residual the solves stop at.
    :param cg_maxiter: iteration cap of each solve.
    :param preconditioner_rank: rank m of the Woodbury preconditioner (0
        disables it).
    :param preconditioner: ``"pivchol"`` (greedy pivoted Cholesky) or
        ``"nystrom"`` (m random inducing rows; not with df64).
    :param solver: ``"cg"`` (default), ``"mixed"`` or ``"df64"`` (see the
        module docstring).
    :param store_entries: df64 tier only. ``"auto"`` (default) and ``True``
        store the FP64 entries once (kernel B5) and multiply them in every
        iteration (kernel B6), up to ``ops.df64.STORE_MAX_N`` padded rows;
        ``"f32"`` stores them rounded to float32 (kernel B7), iterates on
        that store (kernel B8) in chunks of four and refreshes each chunk's
        residual through the fused kernel, which ``"auto"`` also does up to
        ``ops.df64.F32_STORE_MAX_N`` when its soundness guard allows;
        ``False`` evaluates the entries in every product (kernels B3/B4).
        See ``ops.df64.stored_entries_tier``.
    :param dtype: the working dtype of the cg and mixed tiers: ``None`` (the
        default float), ``"float32"`` or ``"float64"`` (or the numpy or torch
        dtype of either). The df64 tier is FP64 throughout, so there it is
        taken and checked but changes nothing; any other value raises
        ``ValueError``.
    :param mesh: optional ``parallel.mesh.Mesh`` whose first axis's cells
        share the products (see the module docstring); across processes
        every process passes the same data. With ``solver="df64"`` the
        entries are not stored (``store_entries`` True or ``"f32"`` raise,
        ``"auto"`` stores none).
    :param device: where the data and the computation live (default the
        card; raises when there is none, pass ``"cpu"`` for the CPU).
    """

    # query rows per K(q, x) block of the mean contraction (109 MB at 53,248)
    _DF64_MEAN_CHUNK = 256
    # right-hand sides per batched variance solve of the df64 tier
    _DF64_VAR_COLS = 8
    # CG iterations between true-residual refreshes of the df64 tier
    _RESTART_EVERY = 50
    # the same over the float32 store (see _df64_chunk)
    _RESTART_EVERY_F32 = 4

    def __init__(
        self,
        x,
        y,
        y_err,
        hyperpars,
        kernel=SquaredExponential,
        mean_value: float = None,
        block_size: int = 4096,
        cg_tol: float = 1e-6,
        cg_maxiter: int = 1000,
        preconditioner_rank: int = 512,
        preconditioner: str = "pivchol",
        solver: str = "cg",
        store_entries="auto",
        dtype=None,
        mesh=None,
        device="cuda",
    ):
        self._setup(x, y, y_err, hyperpars, kernel, mean_value, block_size, preconditioner,
                    solver, store_entries, dtype, mesh, device)
        self._build_preconditioner(preconditioner_rank)
        self._build_compiled(cg_tol, cg_maxiter)
        self._set_alpha(self._solve_alpha())

    @classmethod
    def _from_solved(cls, x, y, y_err, hyperpars, alpha64, U, *, kernel=SquaredExponential,
                     solver="df64", preconditioner="pivchol", dtype=None, mean_value, block_size,
                     cg_tol, cg_maxiter, store_entries, device):
        """An instance whose training solve and preconditioner factor are
        given (``convert.large_scale_gp_from_state``): nothing is solved."""
        gp = cls.__new__(cls)
        gp._setup(x, y, y_err, hyperpars, kernel, mean_value, block_size, preconditioner,
                  solver, store_entries, dtype, None, device)
        gp._build_preconditioner(0 if U is None else U.shape[1], U=U)
        gp._build_compiled(cg_tol, cg_maxiter)
        alpha64 = np.asarray(alpha64, np.float64)
        gp._set_alpha(torch.as_tensor(alpha64, **gp._like), alpha64)
        return gp

    def _setup(self, x, y, y_err, hyperpars, kernel, mean_value, block_size, preconditioner,
               solver, store_entries, dtype, mesh, device):
        """Validate the arguments (in the JAX package's order, with its
        messages), pad the data and stage it on the device."""
        if solver not in ("cg", "mixed", "df64"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'solver' must be 'cg', 'mixed' or "
                f"'df64', but '{solver}' was given."
            )
        self._bk = as_block_kernel(kernel, "LargeScaleGP")
        if solver == "df64" and not self._bk.supports_df64:
            raise ValueError(
                f"[ LargeScaleGP error ] solver='df64' is implemented for "
                f"the pure SquaredExponential kernel only (its pair-"
                f"arithmetic Pallas entry kernels are kernel-specific); "
                f"got {self._bk.name}. Use solver='cg' or 'mixed' for "
                f"this kernel."
            )
        if solver == "df64" and mesh is not None and store_entries in (True, "f32"):
            raise ValueError(
                "[ LargeScaleGP error ] store_entries=True is single-chip "
                "(the stored entries are one device's HBM); with a mesh "
                "the df64 tier runs the row-sharded fused kernel instead "
                "— drop the flag."
            )
        if store_entries not in ("auto", True, False, "f32"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'store_entries' must be 'auto', "
                f"True, False or 'f32', but {store_entries!r} was given."
            )
        if store_entries in (True, "f32") and solver != "df64":
            raise ValueError(
                "[ LargeScaleGP error ] store_entries is a df64-tier option "
                "(the stored entries serve the double-float matvec); use "
                "solver='df64' or drop the flag."
            )
        dtype = _as_dtype(dtype)
        self.solver = solver
        self.store_entries = store_entries
        self._device = resolve_device(device, "LargeScaleGP")
        # the working dtype: FP64 for df64, else the caller's or the default
        self._wd = torch.float64 if solver == "df64" else (dtype or default_float())
        self._like = dict(dtype=self._wd, device=self._device)
        self._f64 = dict(dtype=torch.float64, device=self._device)

        x = np.atleast_2d(np.asarray(x, dtype=float))
        if x.shape[0] == 1 and x.shape[1] > 1 and np.asarray(y).size > 1:
            x = x.T
        y = np.asarray(y, dtype=float).squeeze()
        y_err = np.asarray(y_err, dtype=float).squeeze()
        self.n_points, self.n_dimensions = x.shape
        hyperpars = np.asarray(hyperpars, dtype=float)
        expected = self._bk.n_params(self.n_dimensions)
        if hyperpars.size != expected:
            raise ValueError(
                f"[ LargeScaleGP error ] kernel {self._bk.name} over "
                f"{self.n_dimensions}-dimensional data takes {expected} "
                f"hyperparameters, but {hyperpars.size} were given."
            )
        self.hyperpars = hyperpars

        self.block_size = int(block_size)
        # padded rows carry huge noise and a zero residual, so they leave
        # the solve unchanged
        n_pad = -(-self.n_points // self.block_size) * self.block_size
        extra = n_pad - self.n_points
        if extra > 0:
            x = np.concatenate([x, np.repeat(x.mean(axis=0, keepdims=True), extra, axis=0)])
            y = np.concatenate([y, np.zeros(extra)])
            y_err = np.concatenate([y_err, np.full(extra, 1e8)])
        self._n_padded = n_pad
        self._mask = np.zeros(n_pad)
        self._mask[: self.n_points] = 1.0
        if solver == "df64" and n_pad % _TJ != 0:
            raise ValueError(
                f"[ LargeScaleGP error ] solver='df64' needs the padded row "
                f"count to be a multiple of {_TJ}; use a block_size that is a "
                f"multiple of {_TJ}."
            )
        self._mesh = mesh
        self._cells = mesh_cells(mesh, solver, n_pad, "LargeScaleGP", "row count")
        self.mean_value = float(np.mean(y[: self.n_points])) if mean_value is None else mean_value

        self._x_host = x
        self._y_host = y
        self._sig_host = y_err**2
        self._x = torch.as_tensor(x, **self._like)
        self._y = torch.as_tensor(y, **self._like)
        self._sig_diag = torch.as_tensor(self._sig_host, **self._like)
        self._mask_dev = torch.as_tensor(self._mask, **self._like)
        self._theta = torch.as_tensor(hyperpars, **self._like)
        self._amp2 = self._bk.amp2_host(hyperpars)

        if preconditioner not in ("pivchol", "nystrom"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'preconditioner' must be 'pivchol' "
                f"or 'nystrom', but '{preconditioner}' was given."
            )
        if solver == "df64" and preconditioner == "nystrom":
            raise ValueError(
                "[ LargeScaleGP error ] solver='df64' requires the 'pivchol' "
                "preconditioner: its factor is built AND applied in float64 "
                "(the f32-built, f32-applied Nystrom factor stalls the "
                "small-noise solve this solver exists for)."
            )
        self.preconditioner = preconditioner
        # the df64 storage decision, before any O(N m^2) work; a mesh's
        # cells share the fused kernel and store nothing
        self._tier = stored_entries_tier(n_pad, store_entries) \
            if solver == "df64" and mesh is None else None

    # ------------------------------------------------------------------ #
    # preconditioner
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _pivoted_cholesky(self, rank: int, theta=None, return_pivots: bool = False):
        """Greedy pivoted Cholesky of the masked kernel matrix on the
        device in FP64, at ``theta`` (default the instance's): ``rank``
        steps, each pivoting on the largest residual diagonal (the first
        one, as ``np.argmax``), evaluating that point's kernel column through
        the kernel adapter (kernel B2 for the squared exponential) and
        subtracting its projection on the factors found so far. Returns U
        (n, rank) in the working dtype with K ~ U U^T, white noise excluded
        (and the pivots). The JAX package's builds step for step, with two
        departures:

        - FP64 in every tier (the JAX package's cg and mixed tiers build in
          their float32 working dtype): in float32 the residual diagonal's
          rounding takes over near eps32 amp^2 and the build pivots on one
          point again and again (at gp-large-fit-16k's start, 90 distinct
          pivots of 512, measured on an H100).
        - A pivot whose residual diagonal is not positive (the kernel's
          numerical rank used up) gives a zero factor. The JAX builds divide
          by sqrt(tiny) there, ~1e-154 in FP64, and the factor overflows
          (at gp-large-fit-16k's start in FP64: every diagonal zero at step
          227, then inf and NaN, measured on an H100)."""
        f64 = self._f64
        theta = torch.as_tensor(self.hyperpars if theta is None else theta, **f64)
        x, mask = torch.as_tensor(self._x_host, **f64), torch.as_tensor(self._mask, **f64)
        n = x.shape[0]
        diag = self._bk.amp2(theta) * mask
        Ut = torch.zeros((rank, n), **f64)  # U transposed: rows are factors
        pivots = torch.empty(rank, dtype=torch.long, device=self._device)
        for i in range(rank):
            j = torch.argmax(diag, dim=0, keepdim=True)
            pivots[i : i + 1] = j
            col = self._bk.rows(x, x.index_select(0, j), theta)[:, 0] * mask * mask.index_select(0, j)
            proj = Ut[:i].T @ Ut[:i].index_select(1, j)[:, 0]
            dj = diag.index_select(0, j)
            u = torch.where(dj > 0, (col - proj) / torch.sqrt(dj), 0.0)
            Ut[i] = u
            diag = torch.clamp(diag - u * u, min=0.0) * mask
        U = Ut.T.to(self._wd).contiguous()
        return (U, pivots) if return_pivots else U

    @torch.no_grad()
    def _nystrom(self, rank: int):
        """The Nystrom factor ``U = K_nm L_mm^{-T}`` from ``rank`` inducing
        rows drawn by ``np.random.default_rng(0)`` (sorted), with a jitter of
        1e-3 amp^2 in float32 and 1e-8 in float64 on K_mm's diagonal; padded
        rows masked out."""
        idx = np.sort(np.random.default_rng(0).choice(self.n_points, rank, replace=False))
        xm = self._x[torch.as_tensor(idx, device=self._device)]
        theta = self._theta
        K_mm = self._bk.rows(xm, xm, theta).clone()
        jitter = 1e-3 if self._wd == torch.float32 else 1e-8
        K_mm.diagonal().add_(self._bk.amp2(theta) * jitter)
        L_mm = torch.linalg.cholesky(K_mm)
        K_nm = self._bk.rows(self._x, xm, theta)
        U = torch.linalg.solve_triangular(L_mm, K_nm.T, upper=False).T
        return U * self._mask_dev[:, None]

    @torch.no_grad()
    def _precond_gram(self, U, theta):
        """The Woodbury core's Gram ``G = U^T D^-1 U`` of a low-rank factor at
        ``theta``, D the noise and jitter diagonal, in FP64 (U and D widened:
        G reaches amp^2 N / sigma^2, beyond float32's digits): the cg and
        mixed tiers' build and ``fit()``'s live-theta refresh."""
        d = (self._sig_diag + self._bk.noise_variance(theta) + self._bk.amp2(theta) * 1e-12).double()
        U = U.double()
        return (U / d[:, None]).T @ U

    @staticmethod
    def _factor_core_host(G) -> np.ndarray:
        """Float64 host Cholesky of the Woodbury core C = I + G, with an
        escalating-jitter retry (the core's Gram entries reach ~amp^2 N /
        sigma^2 at small noise). The m x m core is tiny; the host keeps the
        JAX package's jitter policy exactly."""
        m = G.shape[0]
        G = np.asarray(G, np.float64)
        C = np.eye(m) + 0.5 * (G + G.T)
        bump = 0.0
        scale = float(np.diag(C).max())
        for _ in range(6):
            try:
                return np.linalg.cholesky(C + bump * np.eye(m))
            except np.linalg.LinAlgError:
                bump = max(bump * 100.0, 1e-10 * scale)
        raise np.linalg.LinAlgError(
            "[ LargeScaleGP error ] preconditioner core factorisation "
            "failed even with diagonal regularisation"
        )

    @classmethod
    def _core_inverse_host(cls, G) -> np.ndarray:
        """Explicit float64 inverse of the Woodbury core C = I + G: the
        preconditioner is then applied by (n, m) matmuls only."""
        Linv = np.linalg.inv(cls._factor_core_host(G))
        return Linv.T @ Linv

    def _build_preconditioner(self, rank: int, U=None):
        """The Woodbury preconditioner ``(D + U U^T)^{-1}``, D the noise and
        jitter diagonal, from the pivoted Cholesky or Nystrom factor (or a
        given factor ``U``). df64 tier: ``self._precond64 = (U, C^{-1},
        1/d)`` in FP64; the others: ``self._precond = (U, 1/d, C^{-1})``, U in
        the working dtype, 1/d and the core's inverse in FP64 (``fit()``'s
        format). Both None for rank 0 or rank >= n_points."""
        self._precond = self._precond64 = None
        if rank <= 0 or rank >= self.n_points:
            return
        if self.solver == "df64":
            U = self._pivoted_cholesky(rank) if U is None else torch.as_tensor(U, **self._f64)
            d64 = torch.as_tensor(self._sig_host + self._amp2 * 1e-12, **self._f64)
            G = (U / d64[:, None]).T @ U
            Cinv = self._core_inverse_host(G.cpu().numpy())
            self._precond64 = (U, torch.as_tensor(Cinv, **self._f64), 1.0 / d64)
            return
        if U is not None:
            U = torch.as_tensor(U, **self._like)
        elif self.preconditioner == "pivchol":
            U = self._pivoted_cholesky(rank)
        else:
            U = self._nystrom(rank)
        self._precond = self._fit_pc_from_U(U, self.hyperpars)

    def _factor(self):
        """The preconditioner's low-rank factor U, or None."""
        pc = self._precond64 if self.solver == "df64" else self._precond
        return None if pc is None else pc[0]

    @staticmethod
    def _woodbury64(V, U64, Cinv, dinv):
        return woodbury_apply(V, U64, dinv, Cinv, core_chol=False)

    def _woodbury(self):
        """The cg/mixed tiers' preconditioner application, or None: 1/d and
        the core's inverse in FP64, the result in the working dtype."""
        if self._precond is None:
            return None
        U, dinv, Cinv = self._precond
        return partial(woodbury_apply, U=U, dinv=dinv, core=Cinv, core_chol=False,
                       out_dtype=self._wd)

    # ------------------------------------------------------------------ #
    # the system operator
    # ------------------------------------------------------------------ #
    def _system_matmat(self, theta, V):
        """``(K(theta) + diag(sig) + noise + jitter I) V`` for a vector
        (n_pad,) or a column block (n_pad, q), in row blocks of
        ``block_size``: each block's kernel rows through the adapter (kernel
        B2 for the squared exponential), then one product with V, so one
        block is alive at a time. The one system product of the cg and
        mixed tiers, of ``fit()`` and of the ``"device"`` residual."""
        KV = blocked_rows_product(self._bk.rows, self._x, theta, V, self.block_size,
                                  self._cells)
        diag = self._sig_diag + self._bk.noise_variance(theta) + self._bk.amp2(theta) * 1e-12
        return KV + (diag[:, None] * V if V.ndim == 2 else diag * V)

    def _prepare_df64(self, store=True):
        """Split the scaled coordinates into a float32 pair (the kernels'
        signature; host float64) and, when the storage policy says so and
        ``store``, store the entries once: in FP64 (kernel B5) or rounded to
        float32 (kernel B7)."""
        ls64 = np.exp(np.asarray(self.hyperpars[1:], np.float64))
        uh, ul = split_f64(self._x_host / ls64[None, :])
        self._us_hi = torch.as_tensor(uh, device=self._device)
        self._us_lo = torch.as_tensor(ul, device=self._device)
        self._sig64 = torch.as_tensor(self._sig_host, **self._f64)
        self._entries = None
        self._entries_f32 = None
        if not store:
            return
        if self._tier == "f32" and self.store_entries == "auto" and not self._f32_store_is_sound():
            self._tier = None
        if self._tier == "f64":
            self._entries = sqexp_entries_df64(self._us_hi, self._us_lo)
        elif self._tier == "f32":
            # the iterations run on the rounded store; the refreshes and
            # residuals keep the fused kernel (_df64_op_args)
            self._entries_f32 = sqexp_entries_f32(self._us_hi, self._us_lo)

    def _f32_store_is_sound(self) -> bool:
        """The JAX package's soundness guard of ``"auto"`` for the rounded
        float32 store: its 2^-24 quantisation has a spectral norm of
        row-sum scale, amp^2 2^-24 max row sum of E, and refinement over it
        stalls once that exceeds 32 times the smallest noise variance; it
        then warns and returns False (the fused kernel)."""
        ls64 = np.exp(np.asarray(self.hyperpars[1:], np.float64))
        us = self._x_host[: self.n_points] / ls64[None, :]
        rows = np.random.default_rng(0).choice(self.n_points, size=min(self.n_points, 512),
                                               replace=False)
        a = us[rows]
        d2 = np.maximum((a**2).sum(1)[:, None] + (us**2).sum(1)[None, :] - 2.0 * (a @ us.T), 0.0)
        quant_norm = self._amp2 * 2.0**-24 * float(np.exp(-0.5 * d2).sum(axis=1).max())
        sig2_min = float(self._sig_host[: self.n_points].min())
        if quant_norm > 32.0 * sig2_min:
            warn(
                f"[ LargeScaleGP warning ] store_entries='auto' is falling back "
                f"to the fused df64 kernel: the stored-f32 entry quantisation "
                f"(spectral scale ~{quant_norm:.1e}) exceeds 32x the smallest "
                f"noise variance ({sig2_min:.1e}), where the quantised "
                f"operator's iterative refinement stalls above the requested "
                f"tolerance."
            )
            return False
        return True

    def _df64_op_args(self):
        """Operands of the df64 system operator: the stored entries, the
        scaled-coordinate pair, or the pair and the mesh."""
        if self._entries is not None:
            return (self._entries,)
        if self._mesh is not None:
            return (self._us_hi, self._us_lo, self._mesh)
        return (self._us_hi, self._us_lo)

    def _diag64(self):
        return self._sig64 + self._amp2 * 1e-12

    def _matvec64_pair(self, v32, *op):
        """df64 system matvec: float32 vector in, float64 ``(K + diag(sig) +
        jitter I) v`` out: kernel B6 on the stored entries or kernel B3, and
        the diagonal in float64."""
        return _system_matvec(self._amp2, self._diag64(), v32, *op)

    def _matmat64_pair(self, V32, *op):
        """df64 system matmat on a float32 (n, q) block: kernel B6 or B4."""
        return _system_matmat(self._amp2, self._diag64(), V32, *op)

    def _df64_chunk(self) -> int:
        """CG iterations per chunk. The JAX package sizes them by a TPU
        watchdog budget (50 at test sizes, fewer at large N); a GPU has no
        watchdog, so the port keeps 50 at every size.

        Over the float32 store the chunk is four iterations, the JAX
        package's choice and not for a watchdog: the store's 2^-24
        rounding has a spectral norm of row-sum scale (about 2e-4 at
        N = 50,000, sigma = 0.01, above the 1e-4 noise variance), so the
        stored operator can be slightly indefinite and an inner CG that digs
        below that level breaks down. Four iterations stay above it, and
        each chunk's fused refresh contracts the error (measured in the JAX
        package: 100x or more per refresh)."""
        return self._RESTART_EVERY_F32 if self._entries_f32 is not None else self._RESTART_EVERY

    def _solver_kwargs(self, kind):
        """The df64 solvers' operands, for a ``Df64Solver`` (``kind``
        "matvec") or a ``Df64MultiSolver`` ("matmat"); over the float32
        store the iterations' operator (B8) is the fast one. The operators
        are partials over tensors, not bound methods: a solver that held the
        instance would make a reference cycle, and the (n, n) entry store
        would outlive ``del`` until the garbage collector ran."""
        op = _system_matvec if kind == "matvec" else _system_matmat
        kw = {f"{kind}_args": self._df64_op_args(), "restart_every": self._df64_chunk()}
        if self._precond64 is not None:
            kw.update(M=self._woodbury64, M_args=self._precond64)
        if self._entries_f32 is not None:
            kw.update({f"{kind}_fast": partial(op, self._amp2, self._diag64()),
                       f"{kind}_fast_args": (self._entries_f32,)})
        return partial(op, self._amp2, self._diag64()), kw

    def _build_compiled(self, cg_tol, cg_maxiter):
        """The training solver's settings, and the df64 tier's operator and
        solver. Nothing is compiled here (the name is the JAX package's):
        every solver is a host loop over torch operations."""
        self._cg_tol, self._cg_maxiter = cg_tol, cg_maxiter
        self.cg_iterations_estimate = None
        if self.solver == "df64":
            self._prepare_df64()
            op, kw = self._solver_kwargs("matvec")
            self._df64_solver = Df64Solver(op, **kw)

    @torch.no_grad()
    def _solve_rhs(self, rhs):
        """The training solve of ``A x = rhs``. df64: the checked df64
        solve, which warns when it stops above ``cg_tol`` and returns the
        best iterate. cg: ``ops.solvers.cg``, whose iteration count it keeps
        as ``cg_iterations_estimate``. mixed: ``ops.solvers.mixed_pcg``."""
        if self.solver != "df64":
            matvec = partial(self._system_matmat, self._theta)
            rhs = torch.as_tensor(rhs, **self._like)
            M = self._woodbury()
            if self.solver == "mixed":
                sol, _ = mixed_pcg(matvec, rhs, M=M, tol=self._cg_tol, maxiter=self._cg_maxiter)
            else:
                sol, self.cg_iterations_estimate = cg(matvec, rhs, M=M, tol=self._cg_tol,
                                                      maxiter=self._cg_maxiter)
            return sol
        sol, info = self._df64_solver.solve(
            torch.as_tensor(rhs, **self._f64), tol=self._cg_tol, maxiter=self._cg_maxiter
        )
        if info != 0:
            hint = (
                " The float32 entry store is active: its 2^-24 rounding may "
                "exceed the noise scale; retry with store_entries=False."
                if self._entries_f32 is not None
                else " Raise cg_maxiter or loosen cg_tol."
            )
            warn(
                f"[ LargeScaleGP warning ] the df64 training solve stopped after "
                f"{info} iterations above the requested tolerance "
                f"{self._cg_tol:.1e}; the best iterate is returned but may be "
                f"inaccurate.{hint}"
            )
        return sol

    def _solve_alpha(self):
        """The training solve. Its right-hand side comes from the float64
        host data in the df64 tier and from the device copy in the working
        dtype in the others, as in the JAX package."""
        if self.solver == "df64":
            return self._solve_rhs(
                torch.as_tensor((self._y_host - self.mean_value) * self._mask, **self._f64)
            )
        return self._solve_rhs((self._y - self.mean_value) * self._mask_dev)

    def _set_alpha(self, alpha, alpha64=None):
        """The training solve's iterate: ``alpha`` (device, working dtype)
        and ``alpha64`` (host float64: ``alpha`` itself, or the
        full-precision iterate of ``refine()``)."""
        self.alpha = alpha
        self.alpha64 = alpha.double().cpu().numpy() if alpha64 is None else alpha64

    # ------------------------------------------------------------------ #
    # fit
    # ------------------------------------------------------------------ #
    def fit(
        self,
        n_steps: int = 40,
        learning_rate: float = 0.05,
        n_probes: int = 8,
        fit_tol: float = 1e-3,
        fit_maxiter: int = 150,
        precond_every: int = 10,
        seed: int = 0,
        verbose: bool = False,
    ):
        """
        Select hyperparameters by maximising the log-marginal likelihood
        without forming K. Each Adam step runs one batched CG solve
        (``ops.solvers.pcg_multi``) of ``alpha = K^-1 r`` and ``u_i = K^-1
        z_i`` for Rademacher probes ``z_i`` drawn once by
        ``np.random.default_rng(seed)`` (common random numbers), then takes
        the gradient of

            S(th) = -0.5 alpha^T K(th) alpha + 0.5 mean_i u_i^T K(th) z_i,

        whose gradient is minus the LML's, with ``alpha, u`` held fixed
        (Hutchinson's trace estimate), by autograd through the blocked
        system product at the live theta: one row block at a time, so one
        block's kernel rows are alive at once.

        Returns the optimised hyperparameter vector (numpy) and leaves this
        instance as it is: construct a new ``LargeScaleGP`` with it. A step
        whose inner CG stops above ``max(10 * fit_tol, 0.05)`` relative
        residual warns once: its gradient is biased. The preconditioner is
        rebuilt at the live hyperparameters every ``precond_every`` steps
        (0 keeps the construction-time one), its core applied in float64.
        """
        if n_probes < 1:
            raise ValueError(
                "LargeScaleGP.fit requires n_probes >= 1 — the Hutchinson "
                "trace term has no estimate from zero probes"
            )
        rng = np.random.default_rng(seed)
        probes = torch.as_tensor(
            rng.choice([-1.0, 1.0], size=(self._n_padded, n_probes)) * self._mask[:, None],
            **self._like,
        )
        rhs0 = torch.as_tensor((self._y_host - self.mean_value) * self._mask, **self._like)
        use_precond = self._factor() is not None
        fit_step = self._get_fit_step(float(fit_tol), int(fit_maxiter), use_precond)
        theta = torch.as_tensor(self.hyperpars, **self._like)
        adam = (torch.zeros_like(theta), torch.zeros_like(theta))
        pc = self._fit_precond_initial() if use_precond else None
        warned = False
        for step in range(int(n_steps)):
            if use_precond and precond_every and step and step % precond_every == 0:
                pc = self._fit_precond(theta)
            theta, adam, g, data_fit, rel_resid = fit_step(
                self, theta, adam, torch.tensor(step + 1, **self._like),
                torch.tensor(learning_rate, **self._like), rhs0, probes, pc,
            )
            if not warned and float(rel_resid) > max(10.0 * fit_tol, 0.05):
                warn(
                    f"LargeScaleGP.fit: inner CG stopped at relative "
                    f"residual {float(rel_resid):.2e} on step {step + 1} — "
                    f"the stochastic gradient is substantially biased; "
                    f"increase fit_maxiter or reduce the step size"
                )
                warned = True
            if verbose:
                print(
                    f"  [ LargeScaleGP.fit step {step + 1}/{n_steps}: "
                    f"|grad| {float(torch.linalg.norm(g)):.3e}, data-fit "
                    f"{float(data_fit):.4f}, CG resid "
                    f"{float(rel_resid):.1e}, theta "
                    f"{theta.cpu().numpy().round(3)} ]",
                    flush=True,
                )
        return theta.cpu().numpy().astype(float)

    def _fit_precond(self, theta):
        """The preconditioner triple (U, 1/d, C^{-1}) at live
        hyperparameters for ``fit()``: the pivoted Cholesky on the device at
        theta and the core's explicit inverse on the host in float64. 1/d
        and C^{-1} stay float64: the core's condition reaches ~amp^2 N /
        sigma^2, where an all-float32 application diverges."""
        th = theta.detach().cpu().numpy().astype(np.float64)
        U = self._pivoted_cholesky(self._factor().shape[1], theta=torch.as_tensor(th, **self._like))
        return self._fit_pc_from_U(U, th)

    def _fit_pc_from_U(self, U, theta64):
        """The triple (U, 1/d, C^{-1}) of a low-rank factor at theta64: the
        device Gram, 1/d and the core's inverse (host, escalating jitter) in
        float64."""
        th = np.asarray(theta64, np.float64)
        G = self._precond_gram(U, torch.as_tensor(th, **self._like))
        dinv = 1.0 / (self._sig_host + self._bk.noise_variance_host(th)
                      + self._bk.amp2_host(th) * 1e-12)
        Cinv = self._core_inverse_host(G.cpu().numpy())
        return U, torch.as_tensor(dinv, **self._f64), torch.as_tensor(Cinv, **self._f64)

    def _fit_precond_initial(self):
        """The fit's preconditioner at the construction hyperparameters: the
        triple already built (the df64 tier's in its own order)."""
        if self._precond64 is not None:
            U64, Cinv, dinv = self._precond64
            return U64.to(self._wd), dinv, Cinv
        return self._precond

    def _get_fit_step(self, fit_tol, fit_maxiter, use_precond):
        """The Adam step of ``fit()`` for ``(fit_tol, fit_maxiter,
        use_precond)``, cached per key as the JAX package caches its
        compiled step (nothing is compiled here). The cached object is a
        partial of the class's function, not of this instance, so the cache
        makes no reference cycle."""
        cache = self.__dict__.setdefault("_fit_step_cache", {})
        key = (fit_tol, fit_maxiter, use_precond)
        if key not in cache:
            cache[key] = partial(type(self)._fit_step, fit_tol=fit_tol, fit_maxiter=fit_maxiter,
                                 use_precond=use_precond)
        return cache[key]

    def _fit_step(self, theta, adam, t, lr, rhs, Z, pc, *, fit_tol, fit_maxiter, use_precond):
        """One Adam step: the batched solve over ``[rhs, Z]`` at theta, its
        worst true relative residual, the surrogate's gradient, the update.
        Returns ``(theta, adam, g, data_fit, rel_resid)``."""
        th0 = theta.detach()
        B = torch.cat([rhs[:, None], Z], dim=1)
        M = None
        if use_precond:
            Up, dinv, Cinv = pc
            M = partial(woodbury_apply, U=Up, dinv=dinv, core=Cinv, core_chol=False,
                        out_dtype=B.dtype)
        with torch.no_grad():
            Sol, _ = pcg_multi(partial(self._system_matmat, th0), B, M=M, tol=fit_tol,
                               maxiter=fit_maxiter)
            rel_resid = _worst_relative_residual(B - self._system_matmat(th0, Sol), B)
        alpha, U = Sol[:, :1], Sol[:, 1:]
        g = self._surrogate_grad(th0, torch.cat([alpha, Z], dim=1),
                                 torch.cat([-0.5 * alpha, (0.5 / Z.shape[1]) * U], dim=1))
        theta, adam = _adam(th0, adam, g, t, lr)
        return theta, adam, g, -0.5 * (alpha[:, 0] * rhs).sum(), rel_resid

    def _surrogate_grad(self, theta, W, weights):
        """The gradient at theta of ``sum(weights * (K(theta) + diag(theta))
        W)``, the surrogate of ``fit()`` with ``W = [alpha, Z]`` and
        ``weights = [-alpha / 2, U / (2 p)]``: one ``torch.autograd.grad``
        per row block of kernel rows (one block's graph alive at a time),
        then the diagonal's part."""
        th = theta.detach().requires_grad_(True)
        x, step = self._x, self.block_size
        g = torch.zeros_like(theta)
        for s in range(0, self._n_padded, step):
            block = (weights[s : s + step] * (self._bk.rows(x[s : s + step], x, th) @ W)).sum()
            g = g + torch.autograd.grad(block, th)[0]
        diag = self._sig_diag + self._bk.noise_variance(th) + self._bk.amp2(th) * 1e-12
        return g + torch.autograd.grad((weights * (diag[:, None] * W)).sum(), th)[0]

    # ------------------------------------------------------------------ #
    # prediction
    # ------------------------------------------------------------------ #
    def __call__(self, points, with_variance: bool = False):
        """Predictive means, and with ``with_variance`` standard deviations,
        at the given points. cg/mixed: ``K(q, x) alpha + m`` in the working
        dtype and one batched ``pcg_multi`` over every query's column. df64:
        FP64 cross-covariances on the device, the means contracted with
        ``alpha``, each block of eight query points' variances from one
        batched df64 solve."""
        q_host = np.atleast_2d(np.asarray(points, dtype=float))
        if q_host.shape[1] != self.n_dimensions:
            q_host = q_host.reshape(-1, self.n_dimensions)
        if self.solver == "df64":
            if with_variance:
                mu, var = self._predict_var_df64(q_host, self.alpha, return_mean=True)
                return mu, np.sqrt(np.abs(var))
            return self._predict_mean_df64(q_host)
        mu = self._predict_mean(q_host)
        if not with_variance:
            return mu
        return mu, np.sqrt(np.abs(self._predict_var(q_host)))

    @torch.no_grad()
    def _predict_mean(self, q_host):
        """cg/mixed means ``K(q, x) alpha + m`` in the working dtype, in query
        blocks of ``_DF64_MEAN_CHUNK`` (each mean its own row)."""
        q = torch.as_tensor(q_host, **self._like)
        step = self._DF64_MEAN_CHUNK
        mu = [self._bk.rows(q[s : s + step], self._x, self._theta) @ self.alpha
              for s in range(0, q.shape[0], step)]
        return (torch.cat(mu) + self.mean_value).cpu().numpy()

    @torch.no_grad()
    def _predict_var(self, q_host):
        """cg/mixed variances ``amp^2 - diag(K(q, x) A^{-1} K(x, q))``: one
        ``pcg_multi`` over every query's column under the preconditioner, in
        the working dtype."""
        q = torch.as_tensor(q_host, **self._like)
        K_qx = self._bk.rows(q, self._x, self._theta)
        sols, _ = pcg_multi(partial(self._system_matmat, self._theta), K_qx.T,
                            M=self._woodbury(), tol=self._cg_tol, maxiter=self._cg_maxiter)
        quad = (K_qx.T * sols).sum(dim=0)
        return (self._bk.amp2(self._theta) - quad).cpu().numpy()

    @torch.no_grad()
    def _kqx(self, q64):
        """FP64 cross-covariance rows ``K(q, x)`` on the device (query
        block x padded points, padded columns masked to zero)."""
        q = torch.as_tensor(q64, **self._f64)
        return self._bk.rows(q, self._x, self._theta) * self._mask_dev[None, :]

    def _predict_mean_df64(self, q_host):
        """df64 means: ``K(q, x) alpha + mean`` in FP64, in query blocks of
        ``_DF64_MEAN_CHUNK``."""
        q64 = np.atleast_2d(np.asarray(q_host, np.float64))
        step = self._DF64_MEAN_CHUNK
        mu = [self._kqx(q64[s : s + step]) @ self.alpha for s in range(0, q64.shape[0], step)]
        return torch.cat(mu).cpu().numpy() + self.mean_value

    def _predict_var_df64(self, q_host, alpha, return_mean: bool = False):
        """df64 variances ``amp^2 - K(q, x) A^{-1} K(x, q)``: one batched df64
        solve per block of ``_DF64_VAR_COLS`` query points (zero columns pad
        the last block and converge at once), the quadratic form in FP64.
        With ``return_mean`` the same cross-covariance block also gives the
        means."""
        q64 = np.atleast_2d(np.asarray(q_host, np.float64))
        m, qc = q64.shape[0], self._DF64_VAR_COLS
        solver = self._get_df64_multi_solver()
        quad, mu = [], []
        for start in range(0, m, qc):
            stop = min(start + qc, m)
            Kqx = self._kqx(q64[start:stop])
            if return_mean:
                mu.append(Kqx @ alpha)
            B = torch.zeros((self._n_padded, qc), **self._f64)
            B[:, : stop - start] = Kqx.T
            X, info = solver.solve(B, tol=self._cg_tol, maxiter=self._cg_maxiter)
            if info != 0:
                warn(
                    f"LargeScaleGP variance solve for query block {start}:{stop} "
                    f"stopped at iteration {info} without reaching "
                    f"tol={self._cg_tol:.1e}; the returned variances for these "
                    f"points may be inaccurate; raise cg_maxiter."
                )
            quad.append((Kqx * X[:, : stop - start].T).sum(dim=1))
        var = self._amp2 - torch.cat(quad).cpu().numpy()
        if return_mean:
            return torch.cat(mu).cpu().numpy() + self.mean_value, var
        return var

    def _get_df64_multi_solver(self):
        """The batched variance solver, built once (the hyperparameters are
        fixed for the instance's lifetime)."""
        solver = getattr(self, "_df64_msolver", None)
        if solver is None:
            op, kw = self._solver_kwargs("matmat")
            solver = self._df64_msolver = Df64MultiSolver(op, **kw)
        return solver

    # ------------------------------------------------------------------ #
    # float64 residuals and refinement
    # ------------------------------------------------------------------ #
    def _host_matvec64(self, v) -> np.ndarray:
        """Float64 system matvec on the host (blocked numpy, the matmul
        form): the independent ``"host"`` residual route."""
        v = np.asarray(v, dtype=np.float64)
        h = np.asarray(self.hyperpars, dtype=np.float64)
        out = np.empty(self._n_padded)
        B = min(self.block_size, 4096)
        for i in range(0, self._n_padded, B):
            blk = slice(i, min(i + B, self._n_padded))
            out[blk] = self._bk.rows_host64(self._x_host[blk], self._x_host, h) @ v
        diag = self._sig_host + self._bk.noise_variance_host(h) + self._amp2 * 1e-12
        return out + diag * v

    @torch.no_grad()
    def _device_matvec64(self, v) -> np.ndarray:
        """Float64 system matvec on the device: the blocked system product
        on FP64 copies of x, theta and the noise (kernel B2 for the squared
        exponential, in FP64)."""
        x = torch.as_tensor(self._x_host, **self._f64)
        th = torch.as_tensor(self.hyperpars, **self._f64)
        v = torch.as_tensor(v, **self._f64)
        step = self.block_size
        Kv = torch.cat([self._bk.rows(x[s : s + step], x, th) @ v
                        for s in range(0, self._n_padded, step)])
        diag = self._sig_host + self._bk.noise_variance_host(self.hyperpars) + self._amp2 * 1e-12
        return (Kv + torch.as_tensor(diag, **self._f64) * v).cpu().numpy()

    def _residual64(self, alpha64, backend: str):
        """``A alpha`` in float64: ``"df64"`` through the df64 operator
        (kernel B6, or B3 for the fused and the float32-store tiers; outside
        the df64 tier the fused kernel, squared exponential only) on an
        exact hi/lo split of alpha, ``"device"`` through the blocked system
        product in FP64, ``"host"`` through blocked host numpy."""
        if backend == "df64":
            if not self._bk.supports_df64:
                raise ValueError(
                    f"[ LargeScaleGP error ] residual_backend='df64' needs the "
                    f"squared exponential kernel; got {self._bk.name}."
                )
            if not hasattr(self, "_us_hi"):
                # one product needs no (n, n) store
                self._prepare_df64(store=False)
            ah = alpha64.astype(np.float32)
            al = (alpha64 - ah.astype(np.float64)).astype(np.float32)
            op = self._df64_op_args()
            dev = lambda a: torch.as_tensor(a, device=self._device)
            return (self._matvec64_pair(dev(ah), *op)
                    + self._matvec64_pair(dev(al), *op)).cpu().numpy()
        if backend == "device":
            return self._device_matvec64(alpha64)
        if backend == "host":
            return self._host_matvec64(alpha64)
        raise ValueError(
            f"[ LargeScaleGP error ] residual_backend must be 'auto', 'df64', "
            f"'device' or 'host', got {backend!r}."
        )

    def _resolve_residual_backend(self, residual_backend: str) -> str:
        """``"auto"`` is ``"df64"`` (the tier's own FP64 operator) in the df64
        tier and ``"device"`` (the blocked FP64 system product) in the others.
        ``refine()`` and ``residual_norm_f64`` resolve identically."""
        if residual_backend != "auto":
            return residual_backend
        return "df64" if self.solver == "df64" else "device"

    def refine(self, rounds: int = None, target: float = 1e-9, max_rounds: int = 40,
               residual_backend: str = "auto"):
        """Iterative refinement of the training solve: the float64 residual
        ``r = b - A alpha`` (``residual_backend``), a solve of ``A d = r`` by
        the tier's own solver (the df64 solve on the float64 residual, the
        others on its cast to the working dtype), ``alpha += d`` in float64.
        With ``rounds=None`` it stops at ``target``, on stagnation
        (contraction worse than 0.9 per round) or after ``max_rounds``; it
        keeps the best-residual iterate as ``alpha64``, and its cast as
        ``alpha``. Returns ``self``."""
        residual_backend = self._resolve_residual_backend(residual_backend)
        b64 = (np.asarray(self._y_host) - self.mean_value) * self._mask
        b_norm = float(np.linalg.norm(b64))
        alpha64 = np.asarray(self.alpha64, np.float64)
        n_rounds = max_rounds if rounds is None else rounds
        best_alpha, best_res = alpha64, np.inf
        last_res = np.inf
        for _ in range(n_rounds):
            r64 = (b64 - self._residual64(alpha64, residual_backend)) * self._mask
            res = float(np.linalg.norm(r64)) / max(b_norm, 1e-300)
            if res < best_res:
                best_alpha, best_res = alpha64, res
            if res <= target or (rounds is None and res > 0.9 * last_res):
                break
            last_res = res
            d = self._solve_rhs(torch.as_tensor(r64, **self._like))
            alpha64 = alpha64 + d.double().cpu().numpy()
        else:
            r64 = (b64 - self._residual64(alpha64, residual_backend)) * self._mask
            res = float(np.linalg.norm(r64)) / max(b_norm, 1e-300)
            if res < best_res:
                best_alpha, best_res = alpha64, res
        self._set_alpha(torch.as_tensor(best_alpha, **self._like), best_alpha)
        return self

    def residual_norm(self) -> float:
        """Relative residual of the training solve over the real (unpadded)
        rows, ``|(A alpha - (y - m)) mask| / |(y - m) mask|``: a CG
        convergence check. cg/mixed: the JAX package's, through the system
        product in the working dtype. df64: the port's system product is
        FP64 (kernel B6 on the FP64 store, else B3 on the coordinates,
        applied to an exact hi/lo split of alpha), so this is
        ``residual_norm_f64("df64")``."""
        if self.solver == "df64":
            return self.residual_norm_f64("df64")
        with torch.no_grad():
            rhs = (self._y - self.mean_value) * self._mask_dev
            r = (self._system_matmat(self._theta, self.alpha) - rhs) * self._mask_dev
            return float(torch.linalg.norm(r) / torch.linalg.norm(rhs))

    def residual_norm_f64(self, residual_backend: str = "auto") -> float:
        """Relative residual of the training solve, evaluated in float64."""
        residual_backend = self._resolve_residual_backend(residual_backend)
        b64 = (np.asarray(self._y_host) - self.mean_value) * self._mask
        r = (b64 - self._residual64(self.alpha64, residual_backend)) * self._mask
        return float(np.linalg.norm(r) / max(np.linalg.norm(b64), 1e-300))
