"""Matrix-free Gaussian-process regression for large datasets: the
small-noise ``solver="df64"`` tier.

Port of ``inference_tpu.gp.large_scale`` for ``solver="df64"``:
``LargeScaleGP`` solves ``(K + diag(sigma^2) + jitter I) alpha = y - m``
by preconditioned CG with float64 iterates (``ops.solvers.Df64Solver``),
where K's action is kernel B6 on the FP64 entry store of kernel B5
(``store_entries="auto"`` or ``True`` up to ``ops.df64.STORE_MAX_N``), the
fused kernels B3/B4 that evaluate the entries in every product
(``store_entries=False``), or, with ``store_entries="f32"``, kernel B8 on
the float32-rounded store of kernel B7 for the iterations and B3/B4 for
each chunk's residual refresh (mixed-precision iterative refinement, as in
the JAX package). The preconditioner is a rank-m Woodbury application of a
greedy pivoted Cholesky factor. Predictive variances run
one batched solve per eight query points (``Df64MultiSolver``).

The JAX package runs this tier in float32-pair arithmetic because the TPU
has no float64. The card has, and these of its choices become design
decisions:

- **Pivoted Cholesky on the card in FP64.** The JAX package runs the
  greedy algorithm on the host in float64 (``_pivoted_cholesky_host``) only
  because its device build is float32. The port runs the same algorithm on
  the device in FP64, with the same pivot order: ``torch.argmax`` takes the
  first maximum, as ``np.argmax`` does. At rank 512 and N = 53,248 the
  host loop would cost seconds.
- **FP64 device arrays.** x, y, the factor U and the core inverse are
  FP64 on the device; the JAX package's float32 casts for its traced
  prediction paths have no job here, so its ``dtype`` argument is taken
  and checked but changes nothing.
- **K(q, x) for predictions** is built on the device in FP64 through
  ``SqExpBlock.rows`` (kernel B2, exact coordinate differences). The JAX
  package's host numpy ``sqexp_rows_host64`` stays, for the host residual
  and the parity tests.
- **Residual backend.** ``"auto"`` resolves to ``"df64"``, the FP64 fused
  kernel, on every device. The JAX rule (its emulated-float64 program up
  to 16,384 rows, the pair kernel on a TPU, the host beyond) guards TPU
  limits the card does not have.
- **Variance solves** run to ``cg_tol``: the JAX package floors their
  tolerance at 1e-8, the noise of its pair arithmetic, which FP64 does
  not have.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: ``solver="cg"``/``"mixed"`` and the non-squared-exponential
block kernels (A11, next slice), ``fit()`` (A11, next slice), ``mesh=``
(A13).
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
    sqexp_matvec_df64,
    sqexp_stored_f32_matmat,
    sqexp_stored_matmat_df64,
    sqexp_stored_matvec_df64,
    stored_entries_tier,
)
from ..ops.solvers import Df64MultiSolver, Df64Solver
from ..utils.device import resolve_device
from .block_kernels import as_block_kernel, sqexp_rows_host64  # noqa: F401 (re-exported under its JAX module)
from .covariance import SquaredExponential


def woodbury_apply(V, U, dinv, core, *, core_chol):
    """``(D + U U^T)^{-1} V`` for a vector or (n, q) block ``V`` by the
    Woodbury identity: the one application of the low-rank preconditioner.
    ``U`` (n, m); ``dinv`` the elementwise ``1/diag(D)`` in the application
    dtype (float64 here: the core's condition reaches ``amp^2 N /
    sigma^2`` and the subtraction cancels about log10 of it in digits);
    ``core`` the lower Cholesky factor of ``C = I + U^T D^{-1} U``
    (``core_chol=True``) or its explicit inverse (``core_chol=False``)."""
    vec = V.ndim == 1
    W = (V[:, None] if vec else V).to(dinv.dtype) * dinv[:, None]
    U_ = U.to(dinv.dtype)
    t = U_.T @ W
    t = torch.cholesky_solve(t, core) if core_chol else core @ t
    out = W - dinv[:, None] * (U_ @ t)
    return out[:, 0] if vec else out


def _system_matvec(amp2, diag, v32, *op):
    """``(amp2 E + diag) v`` for a float32 vector, float64 out: kernel B6 on
    the FP64 store ``op = (E,)``, B8 on the float32 store, or kernel B3 on
    the coordinate pair ``op = (us_hi, us_lo)``."""
    if len(op) == 2:
        Ev = sqexp_matvec_df64(op[0], op[1], v32)
    elif op[0].dtype == torch.float32:
        Ev = sqexp_stored_f32_matmat(op[0], v32[:, None])[:, 0]
    else:
        Ev = sqexp_stored_matvec_df64(op[0], v32)
    return amp2 * Ev + diag * v32.double()


def _entries_apply(V32, *op):
    """``E V`` through the FP64 store (kernel B6), the float32 store (B8),
    else the fused kernel (B4)."""
    if len(op) == 2:
        return sqexp_matmat_df64(op[0], op[1], V32)
    if op[0].dtype == torch.float32:
        return sqexp_stored_f32_matmat(op[0], V32)
    return sqexp_stored_matmat_df64(op[0], V32)


def _system_matmat(amp2, diag, V32, *op):
    """``(amp2 E + diag) V`` for a float32 (n, q) block: kernel B6, B8 or
    B4."""
    return amp2 * _entries_apply(V32, *op) + diag[:, None] * V32.double()


def _check_dtype(dtype):
    """Accept the JAX package's ``dtype`` values of the df64 tier: None or
    float32/float64 as a name, numpy or torch dtype."""
    if dtype is None:
        return
    if isinstance(dtype, torch.dtype):
        ok = dtype in (torch.float32, torch.float64)
    else:
        try:
            ok = np.dtype(dtype) in (np.float32, np.float64)
        except TypeError:
            ok = False
    if not ok:
        raise ValueError(
            f"[ LargeScaleGP error ] 'dtype' must be None, float32 or float64, "
            f"but {dtype!r} was given."
        )


class LargeScaleGP:
    """
    GP regression with matrix-free training solves, for datasets beyond
    the reach of dense factorisation, in the small-noise regime
    (``solver="df64"``).

    :param x: data positions, shape (n_points, n_dims).
    :param y: data values, shape (n_points,).
    :param y_err: per-point Gaussian error standard deviations.
    :param hyperpars: ``[ln A, ln l_1..l_D]`` of the squared exponential
        (a known constant mean, as ``mean_value``).
    :param kernel: ``SquaredExponential`` (class or instance); other
        kernels raise (see ``gp.block_kernels``).
    :param mean_value: constant mean (defaults to the data mean).
    :param block_size: the data is padded with inert rows to a multiple of
        it, which must be a multiple of 128.
    :param cg_tol: relative residual the solves stop at.
    :param cg_maxiter: iteration cap of each solve.
    :param preconditioner_rank: rank m of the pivoted-Cholesky Woodbury
        preconditioner (0 disables it).
    :param preconditioner: ``"pivchol"``; ``"nystrom"`` raises, as in the
        JAX package's df64 tier.
    :param solver: ``"df64"``; ``"cg"`` and ``"mixed"`` are not ported yet.
    :param store_entries: ``"auto"`` (default) and ``True`` store the FP64
        entries once (kernel B5) and multiply them in every iteration
        (kernel B6), up to ``ops.df64.STORE_MAX_N`` padded rows; ``"f32"``
        stores them rounded to float32 (kernel B7), iterates on that store
        (kernel B8) in chunks of four and refreshes each chunk's residual
        through the fused kernel, which ``"auto"`` also does up to
        ``ops.df64.F32_STORE_MAX_N`` when its soundness guard allows;
        ``False`` evaluates the entries in every product (kernels B3/B4).
        See ``ops.df64.stored_entries_tier``.
    :param dtype: the JAX package's storage dtype of the tier's arrays:
        ``None``, ``"float32"`` or ``"float64"`` (or the numpy or torch
        dtype of either). It changes nothing here, because the port's df64
        tier is FP64 throughout; any other value raises ``ValueError``.
    :param mesh: not ported yet (ROADMAP A13).
    :param device: where the data and the computation live (default the
        card; raises when there is none, pass ``"cpu"`` for the CPU).
    """

    # query rows per K(q, x) block of the mean contraction (109 MB at 53,248)
    _DF64_MEAN_CHUNK = 256
    # right-hand sides per batched variance solve
    _DF64_VAR_COLS = 8
    # CG iterations between true-residual refreshes
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
        _check_dtype(dtype)
        self._setup(x, y, y_err, hyperpars, kernel, mean_value, block_size, preconditioner,
                    solver, store_entries, mesh, device)
        self._build_preconditioner(preconditioner_rank)
        self._build_compiled(cg_tol, cg_maxiter)
        self._set_alpha(self._solve_alpha())

    @classmethod
    def _from_solved(cls, x, y, y_err, hyperpars, alpha64, U, *, mean_value, block_size,
                     cg_tol, cg_maxiter, store_entries, device):
        """An instance whose training solve and preconditioner factor are
        given (``convert.large_scale_gp_from_state``): nothing is solved."""
        gp = cls.__new__(cls)
        gp._setup(x, y, y_err, hyperpars, SquaredExponential, mean_value, block_size,
                  "pivchol", "df64", store_entries, None, device)
        gp._build_preconditioner(0 if U is None else U.shape[1], U=U)
        gp._build_compiled(cg_tol, cg_maxiter)
        gp._set_alpha(torch.as_tensor(alpha64, **gp._f64))
        return gp

    def _setup(self, x, y, y_err, hyperpars, kernel, mean_value, block_size, preconditioner,
               solver, store_entries, mesh, device):
        """Validate the arguments, pad the data and stage it on the device."""
        if solver not in ("cg", "mixed", "df64"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'solver' must be 'cg', 'mixed' or "
                f"'df64', but '{solver}' was given."
            )
        self._bk = as_block_kernel(kernel, "LargeScaleGP")
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
        if solver != "df64":
            raise NotImplementedError(
                f"[ LargeScaleGP error ] solver='{solver}' (the float32 and "
                f"mixed-precision tiers) is not ported yet: ROADMAP A11, next "
                f"slice. Use solver='df64'."
            )
        if mesh is not None:
            raise NotImplementedError(
                "[ LargeScaleGP error ] device meshes are not ported yet "
                "(ROADMAP A13, the row-sharded df64 matmat)."
            )
        self.solver = solver
        self.store_entries = store_entries
        self.preconditioner = preconditioner
        self._device = resolve_device(device, "LargeScaleGP")
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
        if n_pad % _TJ != 0:
            raise ValueError(
                f"[ LargeScaleGP error ] solver='df64' needs the padded row "
                f"count to be a multiple of {_TJ}; use a block_size that is a "
                f"multiple of {_TJ}."
            )
        if preconditioner not in ("pivchol", "nystrom"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'preconditioner' must be 'pivchol' "
                f"or 'nystrom', but '{preconditioner}' was given."
            )
        if preconditioner == "nystrom":
            raise ValueError(
                "[ LargeScaleGP error ] solver='df64' requires the 'pivchol' "
                "preconditioner: its factor is built AND applied in float64 "
                "(the f32-built, f32-applied Nystrom factor stalls the "
                "small-noise solve this solver exists for)."
            )
        self._n_padded = n_pad
        self._mask = np.zeros(n_pad)
        self._mask[: self.n_points] = 1.0
        # the storage decision, before any O(N m^2) work
        self._tier = stored_entries_tier(n_pad, store_entries)
        self.mean_value = float(np.mean(y[: self.n_points])) if mean_value is None else mean_value

        self._x_host = x
        self._y_host = y
        self._sig_host = y_err**2
        self._x = torch.as_tensor(x, **self._f64)
        self._mask_dev = torch.as_tensor(self._mask, **self._f64)
        self._theta = torch.as_tensor(hyperpars, **self._f64)
        self._amp2 = self._bk.amp2_host(hyperpars)

    # ------------------------------------------------------------------ #
    # preconditioner
    # ------------------------------------------------------------------ #
    def _pivoted_cholesky(self, rank: int, return_pivots: bool = False):
        """Greedy pivoted Cholesky of the masked kernel matrix on the
        device in FP64: ``rank`` steps, each pivoting on the largest
        residual diagonal (the first one, as ``np.argmax``), evaluating
        that point's kernel column and subtracting its projection on the
        factors found so far. Returns U (n, rank) with K ~ U U^T (and the
        pivots). The JAX package's ``_pivoted_cholesky_host``, step for
        step; no host round trip per step."""
        xs = self._x / torch.exp(self._theta[1:])[None, :]
        mask = self._mask_dev
        n = xs.shape[0]
        diag = self._amp2 * mask
        Ut = torch.zeros((rank, n), **self._f64)  # U transposed: rows are factors
        pivots = torch.empty(rank, dtype=torch.long, device=self._device)
        tiny = torch.finfo(torch.float64).tiny
        for i in range(rank):
            j = torch.argmax(diag, dim=0, keepdim=True)
            pivots[i : i + 1] = j
            d2 = ((xs - xs.index_select(0, j)) ** 2).sum(dim=1)
            col = self._amp2 * torch.exp(-0.5 * d2) * mask * mask.index_select(0, j)
            proj = Ut[:i].T @ Ut[:i].index_select(1, j)[:, 0]
            root = torch.sqrt(torch.clamp(diag.index_select(0, j), min=tiny))
            u = (col - proj) / root
            Ut[i] = u
            diag = torch.clamp(diag - u * u, min=0.0) * mask
        U = Ut.T.contiguous()
        return (U, pivots) if return_pivots else U

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
        """The FP64 Woodbury preconditioner ``(D + U U^T)^{-1}``, D the
        noise and jitter diagonal, from the pivoted Cholesky factor (or a
        given factor ``U``): ``self._precond64 = (U, C^{-1}, 1/d)``, or
        None for rank 0 or rank >= n_points."""
        if rank <= 0 or rank >= self.n_points:
            self._precond64 = None
            return
        U = self._pivoted_cholesky(rank) if U is None else torch.as_tensor(U, **self._f64)
        d64 = torch.as_tensor(self._sig_host + self._amp2 * 1e-12, **self._f64)
        G = (U / d64[:, None]).T @ U
        Cinv = self._core_inverse_host(G.cpu().numpy())
        self._precond64 = (U, torch.as_tensor(Cinv, **self._f64), 1.0 / d64)

    @staticmethod
    def _woodbury64(V, U64, Cinv, dinv):
        return woodbury_apply(V, U64, dinv, Cinv, core_chol=False)

    # ------------------------------------------------------------------ #
    # the system operator
    # ------------------------------------------------------------------ #
    def _prepare_df64(self):
        """Split the scaled coordinates into a float32 pair (the kernels'
        signature; host float64) and, when the storage policy says so,
        store the entries once: in FP64 (kernel B5) or rounded to float32
        (kernel B7)."""
        ls64 = np.exp(np.asarray(self.hyperpars[1:], np.float64))
        uh, ul = split_f64(self._x_host / ls64[None, :])
        self._us_hi = torch.as_tensor(uh, device=self._device)
        self._us_lo = torch.as_tensor(ul, device=self._device)
        self._sig64 = torch.as_tensor(self._sig_host, **self._f64)
        self._entries = None
        self._entries_f32 = None
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
        """Operands of the system operator: the stored entries, or the
        scaled-coordinate pair."""
        if self._entries is not None:
            return (self._entries,)
        return (self._us_hi, self._us_lo)

    def _diag64(self):
        return self._sig64 + self._amp2 * 1e-12

    def _matvec64_pair(self, v32, *op):
        """System matvec: float32 vector in, float64 ``(K + diag(sig) +
        jitter I) v`` out: kernel B6 on the stored entries or kernel B3,
        and the diagonal in float64."""
        return _system_matvec(self._amp2, self._diag64(), v32, *op)

    def _matmat64_pair(self, V32, *op):
        """System matmat on a float32 (n, q) block: kernel B6 or B4."""
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
        """The solvers' operands, for a ``Df64Solver`` (``kind`` "matvec")
        or a ``Df64MultiSolver`` ("matmat"); over the float32 store the
        iterations' operator (B8) is the fast one. The operators are
        partials over tensors, not bound methods: a solver that held the
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
        """The df64 training solver. Nothing is compiled here (the name is
        the JAX package's): the solver is a host loop over torch
        operations."""
        self._cg_tol, self._cg_maxiter = cg_tol, cg_maxiter
        self._prepare_df64()
        op, kw = self._solver_kwargs("matvec")
        self._df64_solver = Df64Solver(op, **kw)

    def _solve_rhs(self, rhs):
        """The checked df64 training solve of ``A x = rhs``: warns when it
        stops above ``cg_tol`` and returns the best iterate."""
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
        """The training solve, its right-hand side from the float64 host
        data."""
        return self._solve_rhs(
            torch.as_tensor((self._y_host - self.mean_value) * self._mask, **self._f64)
        )

    def _set_alpha(self, alpha):
        """The training solve's iterate: ``alpha`` (device FP64) and
        ``alpha64`` (host float64, as in the JAX package)."""
        self.alpha = alpha
        self.alpha64 = alpha.cpu().numpy()

    def fit(self, *args, **kwargs):
        """The matrix-free stochastic-gradient fit is not ported yet."""
        raise NotImplementedError(
            "[ LargeScaleGP error ] fit() (Hutchinson-trace stochastic LML "
            "gradients through batched CG) is not ported yet: ROADMAP A11, "
            "next slice."
        )

    # ------------------------------------------------------------------ #
    # prediction
    # ------------------------------------------------------------------ #
    def __call__(self, points, with_variance: bool = False):
        """Predictive means, and with ``with_variance`` standard deviations,
        at the given points: FP64 cross-covariances on the device, the
        means contracted with ``alpha``, each block of eight query points'
        variances from one batched df64 solve."""
        q_host = np.atleast_2d(np.asarray(points, dtype=float))
        if q_host.shape[1] != self.n_dimensions:
            q_host = q_host.reshape(-1, self.n_dimensions)
        if with_variance:
            mu, var = self._predict_var_df64(q_host, self.alpha, return_mean=True)
            return mu, np.sqrt(np.abs(var))
        return self._predict_mean_df64(q_host)

    def _kqx(self, q64):
        """FP64 cross-covariance rows ``K(q, x)`` on the device (query
        block x padded points, padded columns masked to zero)."""
        q = torch.as_tensor(q64, **self._f64)
        return self._bk.rows(q, self._x, self._theta) * self._mask_dev[None, :]

    def _predict_mean_df64(self, q_host):
        """Posterior means: ``K(q, x) alpha + mean`` in FP64, in query
        blocks of ``_DF64_MEAN_CHUNK``."""
        q64 = np.atleast_2d(np.asarray(q_host, np.float64))
        step = self._DF64_MEAN_CHUNK
        mu = [self._kqx(q64[s : s + step]) @ self.alpha for s in range(0, q64.shape[0], step)]
        return torch.cat(mu).cpu().numpy() + self.mean_value

    def _predict_var_df64(self, q_host, alpha, return_mean: bool = False):
        """Posterior variances ``amp^2 - K(q, x) A^{-1} K(x, q)``: one batched
        df64 solve per block of ``_DF64_VAR_COLS`` query points (zero
        columns pad the last block and converge at once), the quadratic
        form in FP64. With ``return_mean`` the same cross-covariance block
        also gives the means."""
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

    def _residual64(self, alpha64, backend: str):
        """``A alpha`` in float64: ``"df64"`` through the tier's accurate
        operator (kernel B6, or B3 for the fused and the float32-store tiers)
        on an exact hi/lo split of alpha, ``"host"`` through blocked host
        numpy."""
        if backend == "df64":
            ah = alpha64.astype(np.float32)
            al = (alpha64 - ah.astype(np.float64)).astype(np.float32)
            op = self._df64_op_args()
            dev = lambda a: torch.as_tensor(a, device=self._device)
            return (self._matvec64_pair(dev(ah), *op)
                    + self._matvec64_pair(dev(al), *op)).cpu().numpy()
        if backend == "host":
            return self._host_matvec64(alpha64)
        raise ValueError(
            f"[ LargeScaleGP error ] residual_backend must be 'auto', 'df64' "
            f"or 'host', got {backend!r} (the JAX package's 'device', an "
            f"emulated-float64 program, has no job where 'df64' is FP64)."
        )

    def _resolve_residual_backend(self, residual_backend: str) -> str:
        """``"auto"`` is ``"df64"``: the FP64 operator of the tier itself,
        on every device. ``refine()`` and ``residual_norm_f64`` resolve
        identically."""
        return "df64" if residual_backend == "auto" else residual_backend

    def refine(self, rounds: int = None, target: float = 1e-9, max_rounds: int = 40,
               residual_backend: str = "auto"):
        """Iterative refinement of the training solve: the float64 residual
        ``r = b - A alpha`` (``residual_backend``), a df64 solve of ``A d =
        r``, ``alpha += d``. With ``rounds=None`` it stops at ``target``,
        on stagnation (contraction worse than 0.9 per round) or after
        ``max_rounds``; it keeps the best-residual iterate. Returns
        ``self``."""
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
            d = self._solve_rhs(torch.as_tensor(r64, **self._f64))
            alpha64 = alpha64 + d.cpu().numpy()
        else:
            r64 = (b64 - self._residual64(alpha64, residual_backend)) * self._mask
            res = float(np.linalg.norm(r64)) / max(b_norm, 1e-300)
            if res < best_res:
                best_alpha, best_res = alpha64, res
        self._set_alpha(torch.as_tensor(best_alpha, **self._f64))
        return self

    def residual_norm(self) -> float:
        """Relative residual of the training solve over the real (unpadded)
        rows, ``|(K alpha - (y - m)) mask| / |(y - m) mask|``: a CG
        convergence check. The JAX package evaluates it with its float32
        system matmat; the port's system product is FP64 (kernel B6 on the
        FP64 store, else B3 on the coordinates, applied to an exact hi/lo
        split of alpha), so this is ``residual_norm_f64("df64")``."""
        return self.residual_norm_f64("df64")

    def residual_norm_f64(self, residual_backend: str = "auto") -> float:
        """Relative residual of the training solve, evaluated in float64."""
        residual_backend = self._resolve_residual_backend(residual_backend)
        b64 = (np.asarray(self._y_host) - self.mean_value) * self._mask
        r = (b64 - self._residual64(self.alpha64, residual_backend)) * self._mask
        return float(np.linalg.norm(r) / max(np.linalg.norm(b64), 1e-300))
