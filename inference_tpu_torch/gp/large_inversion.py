"""Matrix-free GP linear inversion for large parameter grids.

Port of ``inference_tpu.gp.large_inversion``. The dense
``GpLinearInverter`` factorises the N x N prior covariance; this class
solves the same linear-Gaussian inverse problem without forming it:

    data-space system   (Sigma + A K A^T) z = y - A mu
    posterior mean      m = mu + K A^T z

The M x M data-space operator is applied as ``A (K (A^T v)) + Sigma v`` and
solved by CG under the Jacobi preconditioner of the noise diagonal. The
prior contraction ``K p`` takes one of three tiers:

- ``solver="cg"`` (default) and ``"mixed"``: K's rows in blocks of
  ``block_size`` through the kernel adapter of ``gp.block_kernels`` (kernel
  B2 for the squared exponential), one block alive at a time, in the working
  dtype, plus a white-noise prior term on the diagonal; ``ops.solvers.cg``
  or ``mixed_pcg`` for the data-space solve, one batched ``pcg_multi`` for
  the posterior variances.
- ``solver="df64"``: FP64 throughout, the squared exponential only. The
  prior contraction goes through the FP64 entry store (kernel B5 once, then
  B6), the fused kernels B3/B4 (``store_entries=False``) or, as an explicit
  opt-in (``store_entries="f32"``), the float32 store (B7, then B8 for the
  iterations with fused refreshes), on the exact hi/lo float32 split of its
  FP64 input (the kernels take float32 right-hand sides; hi and lo ride in
  one launch). The A products run in FP64; the CG iterates are float64
  (``ops.solvers.Df64Solver``).

``fit()`` selects the prior hyperparameters by Adam on Hutchinson-trace
gradients of the data-space marginal likelihood, as ``LargeScaleGP.fit``
does, with autograd through the blocked live-theta product.

``mesh=`` (a ``parallel.mesh.Mesh``, its first axis) deals the prior
contraction to the cells of a mesh, as in ``LargeScaleGP``: the df64
tier runs kernel B4 on each cell's block of parameter rows
(``ops.df64.sqexp_matmat_df64_sharded``) and stores no entries, and the cg
and mixed tiers deal K's row blocks to the cells in turn. A mesh may span
processes, each of them holding the full problem and gathering the blocks
of the others' cells, as in ``LargeScaleGP``.
"""

from functools import partial
from warnings import warn

import numpy as np
import torch

from ..ops.df64 import (
    _TJ,
    split_f64,
    sqexp_entries_df64,
    sqexp_entries_f32,
    sqexp_matmat_df64,
    sqexp_matmat_df64_sharded,
    sqexp_stored_f32_matmat,
    sqexp_stored_matmat_df64,
    stored_entries_tier,
)
from ..ops.solvers import Df64MultiSolver, Df64Solver, cg, mixed_pcg, pcg_multi
from ..utils.device import resolve_device
from ..utils.dtypes import default_float
from .block_kernels import as_block_kernel
from .covariance import SquaredExponential
from .large_scale import (_adam, _as_dtype, _worst_relative_residual, blocked_rows_product,
                          mesh_cells)

_ERR = "[ LargeScaleGpLinearInverter error ]"


def _prior_apply_split64(amp2, P64, *op):
    """``amp2 E P`` for a float64 (n, q) block, through one launch on the
    exact hi/lo float32 split of ``P`` (2q columns): kernel B6 on the FP64
    store ``op = (E,)``, B8 on the float32 store, B4 on the coordinate pair
    ``op = (us_hi, us_lo)``, or B4 on each cell's rows with ``op = (us_hi,
    us_lo, mesh)``."""
    q = P64.shape[1]
    Ph = P64.float()
    Pl = (P64 - Ph.double()).float()
    V = torch.cat([Ph, Pl], dim=1)
    if len(op) == 3:
        KP = sqexp_matmat_df64_sharded(op[0], op[1], V, op[2])
    elif len(op) == 2:
        KP = sqexp_matmat_df64(op[0], op[1], V)
    elif op[0].dtype == torch.float32:
        KP = sqexp_stored_f32_matmat(op[0], V)
    else:
        KP = sqexp_stored_matmat_df64(op[0], V)
    return amp2 * (KP[:, :q] + KP[:, q:])


def _data_matmat64(amp2, sig64, V32, A64, *op):
    """The data-space product ``(Sigma + A K A^T) V`` for a float32 (M, q)
    block, float64 out: the A products in FP64 and the prior contraction by
    ``_prior_apply_split64``."""
    V64 = V32.double()
    KP = _prior_apply_split64(amp2, A64.T @ V64, *op)
    return sig64[:, None] * V64 + A64 @ KP


def _data_matvec64(amp2, sig64, v32, A64, *op):
    """The single-vector form of ``_data_matmat64``."""
    return _data_matmat64(amp2, sig64, v32[:, None], A64, *op)[:, 0]


def _jacobi(v, sig):
    """The data-space preconditioner: the inverse noise diagonal."""
    return v / sig if v.ndim == 1 else v / sig[:, None]


class LargeScaleGpLinearInverter:
    """
    Solve a linear-Gaussian inverse problem ``y = A p + noise`` with a GP
    prior over the parameter field ``p``, for parameter counts far beyond
    dense factorisation.

    :param y: measured data, shape (M,).
    :param y_err: data error standard deviations, shape (M,).
    :param model_matrix: linear forward model ``A``, shape (M, N).
    :param parameter_spatial_positions: positions of the N parameters,
        shape (N, D).
    :param hyperpars: prior-covariance hyperparameters: ``[ln A, ln l_1,
        ..., ln l_D]`` for the default ``SquaredExponential``, ``[ln A, ln
        alpha, ln l_1..l_D]`` for ``RationalQuadratic``; a ``+ WhiteNoise()``
        composition adds its ``ln sigma_w``.
    :param kernel: the prior covariance (class or instance):
        ``SquaredExponential`` (default), ``RationalQuadratic`` or either
        ``+ WhiteNoise()`` (an independent per-parameter prior variance);
        others raise. The df64 tier takes the squared exponential only.
    :param prior_mean: constant prior mean (default 0).
    :param block_size: parameter rows per kernel block; the parameters are
        padded to a multiple of it (of 128 for df64) with zero model-matrix
        columns.
    :param cg_tol: relative residual the solves stop at.
    :param cg_maxiter: iteration cap of each solve.
    :param solver: ``"cg"`` (default), ``"mixed"`` or ``"df64"`` (see the
        module docstring).
    :param store_entries: df64 tier only. ``"auto"`` (default) and ``True``
        store the FP64 entries (kernels B5, B6) as far as
        ``ops.df64.stored_entries_tier`` allows, beyond which ``"auto"``
        evaluates the entries in every product (B3/B4); ``"f32"`` is an
        explicit opt-in to the float32 store (B7, B8), sound only when the
        data noise ``sigma^2`` exceeds the prior's 2^-24 entry quantisation
        (``"auto"`` never picks it here: the data-space system's smallest
        eigenvalue is the data noise); ``False`` never stores.
    :param dtype: the working dtype of the cg and mixed tiers: ``None`` (the
        default float), ``"float32"`` or ``"float64"``; the df64 tier is FP64
        throughout, so there it is taken and checked but changes nothing.
    :param mesh: optional ``parallel.mesh.Mesh`` whose first axis's cells
        share the prior contraction (see the module docstring); across
        processes every process passes the same problem. With ``solver="df64"`` the entries are not
        stored (``store_entries`` True or ``"f32"`` raise).
    :param device: where the data and the computation live (default the
        card; raises when there is none, pass ``"cpu"`` for the CPU).
    """

    # right-hand sides per batched variance solve of the df64 tier: each
    # carries a hi/lo pair through the kernel, so 8 fill one launch (Q_MAX)
    _DF64_VAR_COLS = 8
    # CG iterations between true-residual refreshes of the df64 tier; the
    # float32 store keeps full-length chunks here (a diagonal preconditioner
    # needs real Krylov depth), as in the JAX package
    _RESTART_EVERY = 50

    def __init__(
        self,
        y,
        y_err,
        model_matrix,
        parameter_spatial_positions,
        hyperpars,
        kernel=None,
        prior_mean: float = 0.0,
        block_size: int = 4096,
        cg_tol: float = 1e-6,
        cg_maxiter: int = 1000,
        solver: str = "cg",
        store_entries="auto",
        dtype=None,
        mesh=None,
        device="cuda",
    ):
        self._setup(y, y_err, model_matrix, parameter_spatial_positions, hyperpars, kernel,
                    prior_mean, block_size, solver, store_entries, dtype, mesh, device)
        self._build_compiled(cg_tol, cg_maxiter)
        self._set_z(self._solve_data_space())

    @classmethod
    def _from_solved(cls, y, y_err, model_matrix, parameter_spatial_positions, hyperpars, z64, *,
                     kernel=None, prior_mean, block_size, cg_tol, cg_maxiter, solver,
                     store_entries, dtype, device):
        """An instance whose data-space solve is given
        (``convert.large_inverter_from_state``): nothing is solved."""
        inv = cls.__new__(cls)
        inv._setup(y, y_err, model_matrix, parameter_spatial_positions, hyperpars, kernel,
                   prior_mean, block_size, solver, store_entries, dtype, None, device)
        inv._build_compiled(cg_tol, cg_maxiter)
        z64 = np.asarray(z64, np.float64)
        inv._set_z(torch.as_tensor(z64, **inv._like), z64)
        return inv

    def _setup(self, y, y_err, model_matrix, positions, hyperpars, kernel, prior_mean,
               block_size, solver, store_entries, dtype, mesh, device):
        """Validate the arguments (in the JAX package's order, with its
        messages), pad the parameters and stage everything on the device."""
        if solver not in ("cg", "mixed", "df64"):
            raise ValueError(
                f"{_ERR} 'solver' must be 'cg', 'mixed' or 'df64', but '{solver}' was given."
            )
        self._bk = as_block_kernel(SquaredExponential if kernel is None else kernel,
                                   "LargeScaleGpLinearInverter")
        if solver == "df64" and not self._bk.supports_df64:
            raise ValueError(
                f"{_ERR} solver='df64' is implemented for the pure SquaredExponential "
                f"kernel only (its pair-arithmetic Pallas entry kernels are kernel-"
                f"specific); got {self._bk.name}. Use solver='cg' or 'mixed' for this "
                f"kernel."
            )
        if store_entries not in ("auto", True, False, "f32"):
            raise ValueError(
                f"{_ERR} 'store_entries' must be 'auto', True, False or 'f32', but "
                f"{store_entries!r} was given."
            )
        if store_entries in (True, "f32") and solver != "df64":
            raise ValueError(
                f"{_ERR} store_entries is a df64-tier option; use solver='df64' or drop "
                f"the flag."
            )
        if solver == "df64" and mesh is not None and store_entries in (True, "f32"):
            raise ValueError(
                f"{_ERR} store_entries is single-chip (the stored entries are one "
                f"device's HBM); with a mesh the df64 tier runs the row-sharded fused "
                f"kernel — drop the flag."
            )
        dtype = _as_dtype(dtype, "LargeScaleGpLinearInverter")
        self.store_entries = store_entries
        self.solver = solver
        self._device = resolve_device(device, "LargeScaleGpLinearInverter")
        self._wd = torch.float64 if solver == "df64" else (dtype or default_float())
        self._like = dict(dtype=self._wd, device=self._device)
        self._f64 = dict(dtype=torch.float64, device=self._device)

        y = np.asarray(y, dtype=float).squeeze()
        y_err = np.asarray(y_err, dtype=float).squeeze()
        A = np.asarray(model_matrix, dtype=float)
        x = np.atleast_2d(np.asarray(positions, dtype=float))
        if A.ndim != 2 or A.shape[0] != y.size or A.shape[1] != x.shape[0]:
            raise ValueError(
                f"{_ERR} shapes are inconsistent: A {A.shape}, y {y.shape}, positions "
                f"{x.shape}"
            )
        if (y_err <= 0).any():
            raise ValueError(f"{_ERR} all 'y_err' values must be positive")
        self.M, self.n_parameters = A.shape
        self.n_dimensions = x.shape[1]
        hyperpars = np.asarray(hyperpars, dtype=float)
        expected = self._bk.n_params(self.n_dimensions)
        if hyperpars.size != expected:
            raise ValueError(
                f"{_ERR} kernel {self._bk.name} over {self.n_dimensions}-dimensional "
                f"positions takes {expected} hyperparameters, but {hyperpars.size} were "
                f"given."
            )
        self.hyperpars = hyperpars
        self.prior_mean = float(prior_mean)

        # padded parameters have zero model-matrix columns: they never reach
        # the data space
        self.block_size = int(block_size)
        n_pad = -(-self.n_parameters // self.block_size) * self.block_size
        extra = n_pad - self.n_parameters
        if extra > 0:
            x = np.concatenate([x, np.repeat(x.mean(axis=0, keepdims=True), extra, axis=0)])
            A = np.concatenate([A, np.zeros((self.M, extra))], axis=1)
        self._n_padded = n_pad
        if solver == "df64" and n_pad % _TJ != 0:
            raise ValueError(
                f"{_ERR} solver='df64' needs the padded parameter count to be a "
                f"multiple of {_TJ}; use a block_size that is a multiple of {_TJ}."
            )
        self._mesh = mesh
        self._cells = mesh_cells(mesh, solver, n_pad, "LargeScaleGpLinearInverter",
                                 "parameter count")

        self._x_pad_host = x
        self._y_host = y
        self._sig_host = y_err**2
        self._A_row_sums = A.sum(axis=1)
        self._x = torch.as_tensor(x, **self._like)
        self._A = torch.as_tensor(A, **self._like)
        self._y = torch.as_tensor(y, **self._like)
        self._sig = torch.as_tensor(self._sig_host, **self._like)
        self._theta = torch.as_tensor(hyperpars, **self._like)
        self._amp2 = self._bk.amp2_host(hyperpars)

    # ------------------------------------------------------------------ #
    # the cg and mixed tiers
    # ------------------------------------------------------------------ #
    def _k_matvec(self, theta, V):
        """The prior product ``K(theta) V`` for a vector or (n_pad, q) block
        in row blocks of ``block_size`` (one block's rows alive at a time),
        plus the white-noise prior term on the diagonal."""
        KV = blocked_rows_product(self._bk.rows, self._x, theta, V, self.block_size,
                                  self._cells)
        return KV + self._bk.noise_variance(theta) * V

    def _data_matmat(self, theta, V):
        """``(Sigma + A K(theta) A^T) V`` for a vector or (M, q) block, in the
        working dtype: the solves' operator (at the instance's theta) and the
        fit's (at the live theta)."""
        KP = self._k_matvec(theta, self._A.T @ V)
        sig = self._sig if V.ndim == 1 else self._sig[:, None]
        return sig * V + self._A @ KP

    def _rhs(self):
        return self._y - self.prior_mean * self._A.sum(dim=1)

    def _rhs64(self) -> np.ndarray:
        return self._y_host - self.prior_mean * self._A_row_sums

    # ------------------------------------------------------------------ #
    # the df64 tier
    # ------------------------------------------------------------------ #
    def _prepare_df64(self):
        """The scaled coordinates as a float32 pair (host float64), the FP64
        noise and model matrix, and the entry store the policy allows:
        ``stored_entries_tier``, except that ``"auto"`` never takes the
        float32 store here (its 2^-24 quantisation must stay below the data
        noise, the data-space system's smallest eigenvalue)."""
        ls64 = np.exp(np.asarray(self.hyperpars[1:], np.float64))
        uh, ul = split_f64(self._x_pad_host / ls64[None, :])
        self._us_hi = torch.as_tensor(uh, device=self._device)
        self._us_lo = torch.as_tensor(ul, device=self._device)
        self._sig64 = torch.as_tensor(self._sig_host, **self._f64)
        self._A64 = self._A.double()
        self._entries = None
        self._entries_f32 = None
        tier = stored_entries_tier(self._n_padded, self.store_entries)
        if (tier == "f32" and self.store_entries == "auto") or self._mesh is not None:
            tier = None  # a mesh's cells share the fused kernel
        self._tier = tier
        if tier == "f64":
            self._entries = sqexp_entries_df64(self._us_hi, self._us_lo)
        elif tier == "f32":
            # CG iterates on the rounded store; the refreshes keep the fused
            # kernel (iterative refinement, as in LargeScaleGP)
            self._entries_f32 = sqexp_entries_f32(self._us_hi, self._us_lo)

    def _df64_op_args(self):
        """Operands of the prior contraction: the FP64 store, or the scaled
        coordinate pair."""
        if self._entries is not None:
            return (self._entries,)
        if self._mesh is not None:
            return (self._us_hi, self._us_lo, self._mesh)
        return (self._us_hi, self._us_lo)

    def _solver_kwargs(self, kind):
        """The df64 solvers' operator and keyword arguments for a
        ``Df64Solver`` (``kind`` "matvec") or ``Df64MultiSolver``
        ("matmat"); over the float32 store its product is the fast
        operator. Partials over tensors, not bound methods, so that no
        solver holds the instance."""
        op = partial(_data_matvec64 if kind == "matvec" else _data_matmat64, self._amp2,
                     self._sig64)
        kw = {f"{kind}_args": (self._A64, *self._df64_op_args()),
              "M": _jacobi, "M_args": (self._sig64,), "restart_every": self._RESTART_EVERY}
        if self._entries_f32 is not None:
            kw.update({f"{kind}_fast": op, f"{kind}_fast_args": (self._A64, self._entries_f32)})
        return op, kw

    def _build_compiled(self, cg_tol, cg_maxiter):
        """The solves' settings, and the df64 tier's operator and training
        solver. Nothing is compiled here (the name is the JAX package's)."""
        self._cg_tol, self._cg_maxiter = cg_tol, cg_maxiter
        self.cg_iterations_estimate = None
        if self.solver == "df64":
            self._prepare_df64()
            op, kw = self._solver_kwargs("matvec")
            self._df64_solver = Df64Solver(op, **kw)

    @torch.no_grad()
    def _solve_data_space(self):
        """The data-space solve ``(Sigma + A K A^T) z = y - mu A 1``: the
        checked df64 solve on the float64 host right-hand side, else ``cg``
        or ``mixed_pcg`` under the Jacobi preconditioner in the working
        dtype."""
        if self.solver != "df64":
            matvec = partial(self._data_matmat, self._theta)
            M = partial(_jacobi, sig=self._sig)
            if self.solver == "mixed":
                z, _ = mixed_pcg(matvec, self._rhs(), M=M, tol=self._cg_tol,
                                 maxiter=self._cg_maxiter)
            else:
                z, self.cg_iterations_estimate = cg(matvec, self._rhs(), M=M, tol=self._cg_tol,
                                                    maxiter=self._cg_maxiter)
            return z
        z, info = self._df64_solver.solve(torch.as_tensor(self._rhs64(), **self._f64),
                                          tol=self._cg_tol, maxiter=self._cg_maxiter)
        if info != 0:
            hint = (
                " The stored-f32 entry tier is active: its 2^-24 quantisation may "
                "exceed the data noise scale — retry with store_entries=False."
                if self._entries_f32 is not None
                else " Raise cg_maxiter or loosen cg_tol."
            )
            warn(
                f"[ LargeScaleGpLinearInverter warning ] the df64 data-space solve "
                f"stopped after {info} iterations above the requested tolerance "
                f"{self._cg_tol:.1e}; the best iterate is returned but may be "
                f"inaccurate.{hint}"
            )
        return z

    def _set_z(self, z, z64=None):
        """The data-space solution: ``z`` (device, working dtype) and ``z64``
        (host float64)."""
        self.z = z
        self.z64 = z.double().cpu().numpy() if z64 is None else z64
        self.posterior_mean_field = None

    # ------------------------------------------------------------------ #
    # hyperparameter fitting
    # ------------------------------------------------------------------ #
    def fit(
        self,
        n_steps: int = 40,
        learning_rate: float = 0.05,
        n_probes: int = 8,
        fit_tol: float = 1e-3,
        fit_maxiter: int = 150,
        seed: int = 0,
        verbose: bool = False,
    ):
        """
        Select the prior hyperparameters by maximising the data-space
        marginal likelihood

            L = -0.5 r^T S^-1 r - 0.5 logdet S,   S = Sigma + A K(th) A^T,

        without factorising S: per Adam step one batched CG
        (``ops.solvers.pcg_multi``, Jacobi preconditioner) computes ``z =
        S^-1 r`` and ``u_i = S^-1 zeta_i`` for Rademacher probes drawn once by
        ``np.random.default_rng(seed)``, and autograd through the blocked
        live-theta prior product (one row block at a time) gives the
        gradient of the Hutchinson surrogate with ``z, u`` held fixed. Runs
        in the working dtype through the kernel adapter's rows in every tier.
        Returns the optimised hyperparameter vector (numpy) and leaves this
        instance as it is. A step whose inner CG stops above ``max(10 *
        fit_tol, 0.05)`` relative residual warns once: its gradient is
        biased.
        """
        if n_probes < 1:
            raise ValueError("LargeScaleGpLinearInverter.fit requires n_probes >= 1")
        rng = np.random.default_rng(seed)
        probes = torch.as_tensor(rng.choice([-1.0, 1.0], size=(self.M, n_probes)), **self._like)
        rhs0 = torch.as_tensor(self._rhs64(), **self._like)
        fit_step = self._get_fit_step(float(fit_tol), int(fit_maxiter))
        theta = torch.as_tensor(self.hyperpars, **self._like)
        adam = (torch.zeros_like(theta), torch.zeros_like(theta))
        warned = False
        for step in range(int(n_steps)):
            theta, adam, g, data_fit, rel_resid = fit_step(
                self, theta, adam, torch.tensor(step + 1, **self._like),
                torch.tensor(learning_rate, **self._like), rhs0, probes,
            )
            if not warned and float(rel_resid) > max(10.0 * fit_tol, 0.05):
                warn(
                    f"LargeScaleGpLinearInverter.fit: inner CG stopped at "
                    f"relative residual {float(rel_resid):.2e} on step "
                    f"{step + 1} — the stochastic gradient is "
                    f"substantially biased; increase fit_maxiter"
                )
                warned = True
            if verbose:
                print(
                    f"  [ LargeScaleGpLinearInverter.fit step "
                    f"{step + 1}/{n_steps}: |grad| "
                    f"{float(torch.linalg.norm(g)):.3e}, data-fit "
                    f"{float(data_fit):.4f}, CG resid "
                    f"{float(rel_resid):.1e}, theta "
                    f"{theta.cpu().numpy().round(3)} ]",
                    flush=True,
                )
        return theta.cpu().numpy().astype(float)

    def _get_fit_step(self, fit_tol, fit_maxiter):
        """The Adam step for ``(fit_tol, fit_maxiter)``, cached per key as
        the JAX package caches its compiled step; a partial of the class's
        function, so the cache makes no reference cycle."""
        cache = self.__dict__.setdefault("_fit_step_cache", {})
        key = (fit_tol, fit_maxiter)
        if key not in cache:
            cache[key] = partial(type(self)._fit_step, fit_tol=fit_tol, fit_maxiter=fit_maxiter)
        return cache[key]

    def _fit_step(self, theta, adam, t, lr, rhs, Z, *, fit_tol, fit_maxiter):
        """One Adam step: the batched solve over ``[rhs, Z]``, its worst true
        relative residual, the surrogate's gradient, the update. Returns
        ``(theta, adam, g, data_fit, rel_resid)``."""
        th0 = theta.detach()
        B = torch.cat([rhs[:, None], Z], dim=1)
        with torch.no_grad():
            Sol, _ = pcg_multi(partial(self._data_matmat, th0), B, M=partial(_jacobi, sig=self._sig),
                               tol=fit_tol, maxiter=fit_maxiter)
            rel_resid = _worst_relative_residual(B - self._data_matmat(th0, Sol), B)
        z, U = Sol[:, :1], Sol[:, 1:]
        W = torch.cat([z, Z], dim=1)
        weights = torch.cat([-0.5 * z, (0.5 / Z.shape[1]) * U], dim=1)
        g = self._surrogate_grad(th0, self._A.T @ W, self._A.T @ weights)
        theta, adam = _adam(th0, adam, g, t, lr)
        return theta, adam, g, -0.5 * (z[:, 0] * rhs).sum(), rel_resid

    def _surrogate_grad(self, theta, P, Q):
        """The gradient at theta of ``sum(Q * K(theta) P)``, which is the
        surrogate ``sum(weights * S(theta) W)`` of ``fit()`` less its
        theta-free noise term, with ``P = A^T W`` and ``Q = A^T weights``:
        one ``torch.autograd.grad`` per row block of prior rows, then the
        white-noise prior term's part."""
        th = theta.detach().requires_grad_(True)
        x, step = self._x, self.block_size
        g = torch.zeros_like(theta)
        for s in range(0, self._n_padded, step):
            block = (Q[s : s + step] * (self._bk.rows(x[s : s + step], x, th) @ P)).sum()
            g = g + torch.autograd.grad(block, th)[0]
        noise = self._bk.noise_variance(th)
        if noise.requires_grad:
            g = g + torch.autograd.grad(noise * (Q * P).sum(), th)[0]
        return g

    # ------------------------------------------------------------------ #
    # results
    # ------------------------------------------------------------------ #
    def calculate_posterior_mean(self) -> np.ndarray:
        """Posterior mean of the parameter field, shape (N,)."""
        if self.posterior_mean_field is None:
            self.posterior_mean_field = self._mean_field()[: self.n_parameters]
        return self.posterior_mean_field

    @torch.no_grad()
    def _mean_field(self) -> np.ndarray:
        """``mu + K A^T z``: in the working dtype, or in FP64 through the
        df64 prior contraction on the FP64 solution."""
        if self.solver == "df64":
            z64 = torch.as_tensor(self.z64, **self._f64)
            Kw = _prior_apply_split64(self._amp2, (self._A64.T @ z64)[:, None],
                                      *self._df64_op_args())
            return (self.prior_mean + Kw[:, 0]).cpu().numpy()
        return (self.prior_mean + self._k_matvec(self._theta, self._A.T @ self.z)).cpu().numpy()

    def posterior_variances(self, indices) -> np.ndarray:
        """Posterior variances at the given parameter indices (one batched
        solve: request the points you need, not all N)."""
        idx = np.atleast_1d(np.asarray(indices, dtype=int))
        if self.solver == "df64":
            return self._variances_df64(idx)
        return self._variances(idx)

    @torch.no_grad()
    def _variances(self, idx):
        """cg/mixed: ``prior variance - (A k_i)^T S^-1 (A k_i)`` for each
        index, all columns in one ``pcg_multi``."""
        theta = self._theta
        sel = torch.as_tensor(idx, device=self._device)
        K_sx = self._bk.rows(self._x[sel], self._x, theta).clone()
        # a white-noise prior adds its variance on each selected parameter
        K_sx[torch.arange(len(idx), device=self._device), sel] += self._bk.noise_variance(theta)
        AK = self._A @ K_sx.T
        sols, _ = pcg_multi(partial(self._data_matmat, theta), AK,
                            M=partial(_jacobi, sig=self._sig), tol=self._cg_tol,
                            maxiter=self._cg_maxiter)
        quad = (AK * sols).sum(dim=0)
        prior_var = self._bk.amp2(theta) + self._bk.noise_variance(theta)
        return (prior_var - quad).cpu().numpy()

    @torch.no_grad()
    def _variances_df64(self, idx):
        """df64: the same in FP64 end to end: FP64 prior rows on the device
        (kernel B2), batched df64 data-space solves of ``_DF64_VAR_COLS``
        columns (zero columns pad the last block and converge at once) to
        ``cg_tol``, the subtraction in FP64."""
        solver = getattr(self, "_df64_var_solver", None)
        if solver is None:
            op, kw = self._solver_kwargs("matmat")
            solver = self._df64_var_solver = Df64MultiSolver(op, **kw)
        x64 = self._x  # FP64 in this tier
        qc, m = self._DF64_VAR_COLS, len(idx)
        quad = []
        for start in range(0, m, qc):
            stop = min(start + qc, m)
            sel = torch.as_tensor(idx[start:stop], device=self._device)
            AK = self._A64 @ self._bk.rows(x64[sel], x64, self._theta).T
            B = torch.zeros((self.M, qc), **self._f64)
            B[:, : stop - start] = AK
            X, info = solver.solve(B, tol=self._cg_tol, maxiter=self._cg_maxiter)
            if info != 0:
                warn(
                    f"LargeScaleGpLinearInverter variance solve for parameter "
                    f"indices {idx[start:stop].tolist()} stopped at iteration "
                    f"{info} without reaching tol={self._cg_tol:.1e}; raise "
                    f"cg_maxiter."
                )
            quad.append((AK * X[:, : stop - start]).sum(dim=0))
        return self._amp2 - torch.cat(quad).cpu().numpy()

    def predict_data(self) -> np.ndarray:
        """The forward model applied to the posterior mean, shape (M,)."""
        A = self._A64 if self.solver == "df64" else self._A
        m = torch.as_tensor(self.calculate_posterior_mean(), dtype=A.dtype, device=self._device)
        return (A[:, : self.n_parameters] @ m).cpu().numpy()

    def residual_norm(self) -> float:
        """Relative residual of the data-space solve, ``|S z - r| / |r|``:
        through the working-dtype operator in the cg and mixed tiers, as
        ``residual_norm_f64`` in the df64 tier (its operator is FP64)."""
        if self.solver == "df64":
            return self.residual_norm_f64()
        with torch.no_grad():
            rhs = self._rhs()
            r = self._data_matmat(self._theta, self.z) - rhs
            return float(torch.linalg.norm(r) / torch.linalg.norm(rhs))

    def residual_norm_f64(self) -> float:
        """Relative residual of the data-space solve through the df64
        operator on the exact hi/lo split of ``z64`` (solver='df64'
        instances only)."""
        if self.solver != "df64":
            raise ValueError(f"{_ERR} residual_norm_f64 requires solver='df64'.")
        zh = self.z64.astype(np.float32)
        zl = (self.z64 - zh.astype(np.float64)).astype(np.float32)
        op = (self._A64, *self._df64_op_args())
        with torch.no_grad():
            Az = sum(_data_matvec64(self._amp2, self._sig64,
                                    torch.as_tensor(part, device=self._device), *op)
                     for part in (zh, zl)).cpu().numpy()
        rhs = self._rhs64()
        return float(np.linalg.norm(rhs - Az) / max(np.linalg.norm(rhs), 1e-300))
