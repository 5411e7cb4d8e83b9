"""Gaussian-process regression.

Port of ``inference_tpu.gp.regression.GpRegressor`` with the same
constructor, methods and results: ``__call__`` (batched predictive means
and standard deviations), ``gradient``, ``spatial_derivatives``,
``build_posterior``, ``loo_predictions``, ``marginal_likelihood(_gradient)``
and ``loo_likelihood(_gradient)``, and hyperparameter fits by multistart
L-BFGS-B (``"bfgs"``) or differential evolution (``"diffev"``), both on the
host with the objective on the device.

- Gradients come from autograd through the factorisation, or with
  ``cholesky="analytic"`` from the closed form ``Q = (alpha alpha^T -
  K^-1)/2`` (Rasmussen & Williams eq. 5.9) in a ``torch.autograd.Function``.
- The squared-exponential covariance of N >= 2048 points is assembled by
  kernel B2 (``ops.pairwise``) on a CUDA device.
- A failed factorisation pins the likelihood to a large negative floor
  without a host round trip, so optimizers retreat.
- ``pad_to`` pads the data with masked rows that decouple from the real
  ones; results equal the unpadded computation.

- ``optimizer="device"`` (``fit_device``) runs every start of the fit at
  once on the device: ``utils.optimize.minimize_bfgs`` (JAX's BFGS,
  batched over starts) on sigmoid-mapped hyperparameters, the objective of
  all starts in one call (``_batched_objective``), the winner refined by a
  second BFGS.

``dtype=None`` takes ``utils.dtypes.default_float()``. The keyword
``device=`` places the data; it is the one addition to the JAX
constructor.
"""

from copy import copy
from inspect import isclass
from warnings import warn

import numpy as np
import torch
from scipy.optimize import differential_evolution, fmin_l_bfgs_b

from ..ops.linalg import (
    add_diagonal,
    blocked_cholesky,
    blocked_tril_inverse,
    cholesky_or_nan,
    identity_like,
    tril_gram,
)
from ..ops.pairwise import _PALLAS_MIN_N
from ..utils.device import resolve_device
from ..utils.dtypes import default_float
from ..utils.optimize import minimize_bfgs, refined_multistart, scored_starts
from .covariance import CovarianceFunction, SquaredExponential
from .mean import ConstantMean, MeanFunction

_INV_BLOCK = 2048  # panel width of the analytic backward's K^-1
# the fit's relative diagonal jitter in float32 (fit_device only): in
# float32 a line search probing extreme hyperparameters makes K singular and
# the NaN factorisation poisons the gradients; float64 fits the exact
# objective
_FIT_JITTER_F32 = 1e-6


def _tril_solve(L, b, upper=False):
    """Triangular solve against a vector or a matrix right-hand side."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(L, b[:, None], upper=upper)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=upper)


def _floor(dtype):
    """Likelihood of a failed factorisation: large, negative and finite in
    the working dtype (-1e50 overflows float32)."""
    return torch.finfo(dtype).min / 4


def _factor_or_identity(L):
    """``(L, ok)``, with L replaced by the identity where it is not finite."""
    ok = torch.isfinite(L).all()
    return torch.where(ok, L, identity_like(L)), ok


class _AnalyticLml(torch.autograd.Function):
    """The log-marginal likelihood with a closed-form backward: the gradient
    with respect to the covariance matrix is ``Q = (alpha alpha^T - K^-1)/2``
    and with respect to the residual ``-alpha``. ``K^-1 = L^-T L^-1`` comes
    from ``blocked_tril_inverse`` and ``tril_gram``; the pullback of (Q,
    -alpha) to the inputs re-runs the assembly under autograd (for the
    squared exponential, ``SqexpCovariance``'s backward). Inputs that need
    no gradient get ``None``; the others get their true gradient."""

    @staticmethod
    def forward(ctx, gp, theta, x, y, sig, m, jitter=0.0):
        K, r = gp._assemble(theta, x, y, sig, m, jitter)
        L, ok = _factor_or_identity(cholesky_or_nan(K))
        del K
        v = _tril_solve(L, r)
        value = -0.5 * (v @ v) - torch.log(torch.diagonal(L)).sum()
        ctx.gp, ctx.jitter = gp, jitter
        ctx.save_for_backward(theta, x, y, sig, m, L, v, ok)
        return torch.where(ok, value, _floor(value.dtype))

    @staticmethod
    def backward(ctx, g):
        theta, x, y, sig, m, L, v, ok = ctx.saved_tensors
        need = ctx.needs_input_grad[1:6]
        alpha = _tril_solve(L.T, v, upper=True)
        iK = tril_gram(blocked_tril_inverse(L, block=_INV_BLOCK), block=_INV_BLOCK)
        Q = torch.outer(alpha, alpha).sub_(iK).mul_(0.5)
        del iK
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip((theta, x, y, sig, m), need)]
            K, r = ctx.gp._assemble(*inputs, ctx.jitter)
            outs = [(o, c) for o, c in ((K, Q), (r, -alpha)) if o.requires_grad]
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wanted, [c for _, c in outs], allow_unused=True
            ))
        result = [None]  # gp
        for n in need:
            gr = next(grads) if n else None
            result.append(None if gr is None else torch.where(ok, gr, 0.0) * g)
        result.append(None)  # jitter
        return tuple(result[: len(ctx.needs_input_grad)])


class _PerStart(torch.autograd.Function):
    """``objective`` at each row of ``thetas`` (S, p), one row at a time:
    each row's gradient is taken at once and kept, so one start's graph is
    alive at a time, and the backward scales the kept gradients."""

    @staticmethod
    def forward(ctx, thetas, objective):
        values, grads = [], []
        for t in thetas:
            with torch.enable_grad():
                t = t.detach().requires_grad_(True)
                value = objective(t)
                (grad,) = torch.autograd.grad(value, t)
            values.append(value.detach())
            grads.append(grad)
        ctx.save_for_backward(torch.stack(grads))
        return torch.stack(values)

    @staticmethod
    def backward(ctx, g):
        (grads,) = ctx.saved_tensors
        return g[:, None] * grads, None


class GpRegressor:
    """
    Gaussian-process regression in any number of dimensions.

    :param x: x-data, a 2D array of shape (n_points, n_dimensions) or any
        array-like convertible to one.
    :param y: y-data values as a 1D array.
    :param y_err: optional standard deviations of the y-data (1D array).
    :param y_cov: optional full covariance matrix of the y-data (instead of
        ``y_err``).
    :param hyperpars: optional hyperparameter values; when omitted they are
        fitted by maximising the model-selection objective.
    :param kernel: covariance-function class or instance (default
        ``SquaredExponential``).
    :param mean: mean-function class or instance (default ``ConstantMean``).
    :param cross_val: select hyperparameters by the leave-one-out
        likelihood instead of the marginal likelihood.
    :param optimizer: ``"bfgs"`` (host multistart L-BFGS-B), ``"diffev"``
        (differential evolution) or ``"device"`` (every start optimised at
        once on the device, ``fit_device``).
    :param n_processes: accepted for API compatibility; ignored.
    :param n_starts: number of L-BFGS-B starting positions.
    :param pad_to: optional bucket size: the data is padded to the next
        multiple of ``pad_to`` with masked rows, which become identity rows
        of the covariance and contribute exactly zero to the likelihood.
    :param dtype: working dtype (a ``torch.dtype`` or its name); default
        ``utils.dtypes.default_float()``.
    :param cholesky: factorisation of the N x N training matrix: ``"auto"``
        (default) or ``"xla"``, the native ``torch.linalg`` factorisation
        with autograd; ``"blocked"`` or an int panel width,
        ``ops.linalg.blocked_cholesky``; ``"analytic"``, the native forward
        with the closed-form marginal-likelihood backward.
    :param device: where the data and the computation live (default the
        card; raises when there is none, pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        x,
        y,
        y_err=None,
        y_cov=None,
        hyperpars=None,
        kernel: CovarianceFunction = SquaredExponential,
        mean: MeanFunction = ConstantMean,
        cross_val: bool = False,
        optimizer: str = "bfgs",
        n_processes: int = 1,
        n_starts: int = None,
        pad_to: int = None,
        dtype=None,
        cholesky="auto",
        device="cuda",
    ):
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self._dtype = dtype if dtype is not None else default_float()
        self._device = resolve_device(device, "GpRegressor")
        if cholesky not in ("auto", "xla", "blocked", "analytic") and not (
            isinstance(cholesky, int) and not isinstance(cholesky, bool) and cholesky > 0
        ):
            raise ValueError(
                f"[ GpRegressor error ] 'cholesky' must be 'auto', 'xla', "
                f"'blocked', 'analytic' or a positive panel width (int), "
                f"but {cholesky!r} was given."
            )
        self._cholesky = cholesky
        self.cov = kernel() if isclass(kernel) else kernel
        self.mean = mean() if isclass(mean) else mean
        # user-specified bounds persist across data updates; estimated
        # bounds are recomputed from the data each time
        self._cov_bounds_user = self.cov.bounds is not None
        self._mean_bounds_user = getattr(self.mean, "bounds", None) is not None
        self.pad_to = pad_to

        self._ingest_data(x, y, y_err, y_cov)

        self.cross_val = cross_val
        if hyperpars is None:
            hyperpars = self.fit(optimizer=optimizer, n_starts=n_starts, n_processes=n_processes)
        self.set_hyperparameters(hyperpars)

    # ------------------------------------------------------------------ #
    # data handling
    # ------------------------------------------------------------------ #
    def _ingest_data(self, x, y, y_err, y_cov):
        """Validate and pad the training data and stage it on the device."""
        self.x = x if isinstance(x, np.ndarray) else np.array(x)
        self.y = np.asarray(y).squeeze()
        if self.y.ndim != 1:
            raise ValueError(
                f"[ GpRegressor error ] 'y' argument must be a 1D array, but "
                f"instead has shape {self.y.shape}"
            )
        self.n_points = self.y.size
        if self.x.ndim == 2:
            self.n_dimensions = self.x.shape[1]
        elif self.x.ndim <= 1:
            self.n_dimensions = 1
            self.x = self.x.reshape([self.x.size, 1])
        else:
            raise ValueError(
                f"[ GpRegressor error ] 'x' argument must be a 2D array, but "
                f"instead has {self.x.ndim} dimensions and shape {self.x.shape}."
            )
        if self.x.shape[0] != self.n_points:
            raise ValueError(
                f"[ GpRegressor error ] The first dimension of the 'x' array "
                f"must be equal in size to the 'y' array. 'x' has shape "
                f"{self.x.shape}, but 'y' has size {self.y.size}."
            )

        self.sig = self.check_error_data(y_err, y_cov)

        self.cov.pass_spatial_data(self.x)
        self.mean.pass_spatial_data(self.x)
        if not self._cov_bounds_user:
            self.cov.estimate_hyperpar_bounds(self.y)
        if not self._mean_bounds_user:
            self.mean.estimate_hyperpar_bounds(self.y)
        self.hp_bounds = copy(self.mean.bounds)
        self.hp_bounds.extend(copy(self.cov.bounds))

        # shape padding: bounds above come from the real data; the kernel
        # and mean objects are re-pointed at the padded arrays. Padded rows
        # sit at the data centroid, which keeps centred means exact
        if self.pad_to is not None:
            self._n_padded = max(-(-self.n_points // self.pad_to) * self.pad_to, self.pad_to)
        else:
            self._n_padded = self.n_points
        n_extra = self._n_padded - self.n_points
        if n_extra > 0:
            centroid = self.x.mean(axis=0, keepdims=True)
            x_padded = np.concatenate([self.x, np.repeat(centroid, n_extra, axis=0)], axis=0)
            y_padded = np.concatenate([self.y, np.zeros(n_extra)])
            n_params_before = self.cov.n_params
            self.cov.pass_spatial_data(x_padded)
            self.mean.pass_spatial_data(x_padded)
            if self.cov.n_params != n_params_before:
                raise ValueError(
                    "[ GpRegressor error ] 'pad_to' cannot be used with "
                    "data-sized kernels such as HeteroscedasticNoise "
                    "(their hyperparameter count would track the padded "
                    "shape); construct with pad_to=None."
                )
        else:
            x_padded, y_padded = self.x, self.y
        mask = np.zeros(self._n_padded)
        mask[: self.n_points] = 1.0
        self._x_padded, self._y_padded, self._mask = x_padded, y_padded, mask

        self.n_hyperpars = len(self.hp_bounds)
        self.mean_slice = slice(0, self.mean.n_params)
        self.cov_slice = slice(self.mean.n_params, self.n_hyperpars)
        self.hyperpar_labels = [*self.mean.hyperpar_labels, *self.cov.hyperpar_labels]

        # device copies; a diagonal error model keeps only its variances
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=self._dtype,
                                        device=self._device)
        self._x_dev = dev(x_padded)
        self._y_dev = dev(y_padded)
        self._mask_dev = dev(mask)
        if self._sig_is_diag:
            sig = np.zeros(self._n_padded)
            sig[: self.n_points] = np.diagonal(self.sig)
        else:
            sig = np.zeros([self._n_padded, self._n_padded])
            sig[: self.n_points, : self.n_points] = self.sig
        self._sig_dev = dev(sig)

    def update_data(self, x, y, y_err=None, y_cov=None, set_state=True):
        """
        Replace the training data without rebuilding the model.
        Hyperparameters are not refit: call ``fit``/``set_hyperparameters``
        afterwards. ``set_state=False`` skips recomputing the factorisation
        at the old hyperparameters, for callers that refit at once;
        predictions then raise until the state is set again.
        """
        old_n_hyperpars = self.n_hyperpars
        self._ingest_data(x, y, y_err, y_cov)
        if self.n_hyperpars != old_n_hyperpars:
            raise ValueError(
                f"[ GpRegressor error ] 'update_data' changed the number of "
                f"hyperparameters ({old_n_hyperpars} -> {self.n_hyperpars}); "
                f"this happens with data-sized kernels such as "
                f"HeteroscedasticNoise. This instance's data state has "
                f"already been replaced and is now inconsistent with its "
                f"hyperparameters — discard it and construct a new "
                f"GpRegressor."
            )
        if set_state and getattr(self, "hyperpars", None) is not None:
            self.set_hyperparameters(self.hyperpars)
        else:
            self._state_stale = True

    def _require_current_state(self):
        if getattr(self, "_state_stale", False):
            raise RuntimeError(
                "[ GpRegressor error ] predictions requested while the "
                "factorisation state (L, alpha) is stale: 'update_data' "
                "was called with set_state=False and no "
                "'set_hyperparameters' / refit has run since. Call "
                "'set_hyperparameters' (or fit) before predicting."
            )

    def fit(self, optimizer: str = "bfgs", n_starts: int = None, n_processes: int = 1):
        """Select hyperparameters by maximising the model-selection
        objective; returns the optimised vector (does not set it)."""
        if optimizer not in ["bfgs", "diffev", "device"]:
            optimizer = "bfgs"
            warn(
                "An invalid option was passed to the 'optimizer' keyword "
                "argument. The default option 'bfgs' was used instead. "
                "Valid options are 'bfgs', 'diffev' and 'device'."
            )
        if optimizer == "diffev":
            return self.differential_evo()
        if optimizer == "device":
            return self.fit_device(starts=n_starts if n_starts is not None else 16)
        return self.multistart_bfgs(n_processes=n_processes, starts=n_starts)

    # ------------------------------------------------------------------ #
    # objectives
    # ------------------------------------------------------------------ #
    def _data(self):
        return self._x_dev, self._y_dev, self._sig_dev, self._mask_dev

    def _factor(self, K):
        """Cholesky factor of the training matrix by the configured
        factorisation, NaN where it fails."""
        if self._cholesky in ("auto", "xla", "analytic"):
            return cholesky_or_nan(K)
        block = self._cholesky if isinstance(self._cholesky, int) else 2048
        return blocked_cholesky(K, block=block)

    def _assemble(self, theta, x, y, sig, m, jitter=0.0):
        """The training covariance (error model added, padded rows
        decoupled as identity rows) and the masked residual ``y - mu``.
        A non-zero ``jitter`` (the float32 fit only) adds ``jitter *
        mean(diag K)`` to the diagonal."""
        K = self.cov.matrix(x, theta[self.cov_slice])
        K = add_diagonal(K, sig) if sig.ndim == 1 else K + sig
        r = y - self.mean.vector(x, theta[self.mean_slice])
        if self._n_padded != self.n_points:
            K = add_diagonal(K * (m[:, None] * m[None, :]), 1.0 - m)
            r = r * m
        if jitter:
            K = add_diagonal(K, jitter * torch.diagonal(K).mean())
        return K, r

    def _lml_of(self, theta, jitter=0.0):
        K, r = self._assemble(theta, *self._data(), jitter)
        L, ok = _factor_or_identity(self._factor(K))
        v = _tril_solve(L, r)
        value = -0.5 * (v @ v) - torch.log(torch.diagonal(L)).sum()
        return torch.where(ok, value, _floor(value.dtype))

    def _loo_of(self, theta, jitter=0.0):
        K, r = self._assemble(theta, *self._data(), jitter)
        L, ok = _factor_or_identity(self._factor(K))
        if self._cholesky == "analytic":
            iK = tril_gram(blocked_tril_inverse(L, block=_INV_BLOCK), block=_INV_BLOCK)
        else:
            iK = torch.cholesky_inverse(L)
        alpha = iK @ r
        var = 1.0 / torch.diagonal(iK)
        value = -0.5 * (var * alpha**2 + torch.log(var)).sum()
        return torch.where(ok, value, _floor(value.dtype))

    def _theta(self, theta, requires_grad=False):
        return torch.tensor(np.asarray(theta, dtype=float), dtype=self._dtype,
                            device=self._device, requires_grad=requires_grad)

    def _value_and_grad(self, objective, theta):
        t = self._theta(theta, requires_grad=True)
        value = objective(t)
        (grad,) = torch.autograd.grad(value, t)
        return float(value.detach()), grad.cpu().numpy()

    def marginal_likelihood(self, theta) -> float:
        """Log-marginal likelihood (Rasmussen & Williams eq. 5.8)."""
        with torch.no_grad():
            return float(self._lml_of(self._theta(theta)))

    def _lml_grad_objective(self, theta, jitter=0.0):
        """The LML on the route its gradient takes: the closed-form
        backward with ``cholesky="analytic"``, autograd otherwise."""
        if self._cholesky == "analytic":
            return _AnalyticLml.apply(self, theta, *self._data(), jitter)
        return self._lml_of(theta, jitter)

    def marginal_likelihood_gradient(self, theta):
        """The log-marginal likelihood and its hyperparameter gradient."""
        return self._value_and_grad(self._lml_grad_objective, theta)

    def loo_likelihood(self, theta) -> float:
        """Leave-one-out log-likelihood (R&W eqs. 5.10-5.12)."""
        with torch.no_grad():
            return float(self._loo_of(self._theta(theta)))

    def loo_likelihood_gradient(self, theta):
        """The leave-one-out likelihood and its gradient by autograd."""
        return self._value_and_grad(self._loo_of, theta)

    # The fit's objective, chosen by ``cross_val`` at each call. Properties,
    # not bound methods stored on the instance: a stored bound method is a
    # reference cycle that keeps a deleted model's device tensors alive until
    # the garbage collector runs.
    @property
    def model_selector(self):
        return self.loo_likelihood if self.cross_val else self.marginal_likelihood

    @property
    def model_selector_gradient(self):
        return (self.loo_likelihood_gradient if self.cross_val
                else self.marginal_likelihood_gradient)

    def _batched_objective(self, thetas, jitter=0.0):
        """The model-selection objective (LOO with ``cross_val``, else the
        LML on its gradient's route) at every row of ``thetas`` (S, p),
        differentiable: each row's value and gradient are those of the
        single-start objective at that row.

        Blocks below ``_PALLAS_MIN_N`` rows take the matmul form, which
        ``torch.func.vmap`` maps over the rows in one call. From
        ``_PALLAS_MIN_N`` rows each start's covariance is a kernel-B2 block
        (``SqexpCovariance``, which ``vmap`` cannot enter), and with
        ``cholesky="analytic"`` the closed-form backward cannot be mapped
        either: there ``_PerStart`` evaluates one start at a time on the
        single-start route, B2 launched once per start and evaluation."""
        single = self._loo_of if self.cross_val else self._lml_grad_objective
        if self._n_padded >= _PALLAS_MIN_N or self._cholesky == "analytic":
            return _PerStart.apply(thetas, lambda t: single(t, jitter))
        return torch.func.vmap(lambda t: single(t, jitter))(thetas)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #
    def set_hyperparameters(self, hyperpars):
        """Update the hyperparameters and the factorisation state (the
        training covariance, mean, Cholesky factor and ``alpha``)."""
        hyperpars = np.asarray(hyperpars, dtype=float)
        if hyperpars.size != self.n_hyperpars:
            raise ValueError(
                f"[ GpRegressor error ] An incorrect number of hyper-parameter "
                f"values were passed via the 'hyperpars' keyword argument: "
                f"there are {self.n_hyperpars} hyper-parameters but "
                f"{hyperpars.size} values were given."
            )
        self._adopt_state(hyperpars, self._theta(hyperpars))

    def _fit_state(self, theta):
        """The training covariance, prior mean, Cholesky factor and
        ``alpha`` at the hyperparameter tensor ``theta``, on the device."""
        with torch.no_grad():
            x, y, sig, m = self._data()
            K, r = self._assemble(theta, x, y, sig, m)
            mu = self.mean.vector(x, theta[self.mean_slice])
            L = self._factor(K)
            alpha = _tril_solve(L.T, _tril_solve(L, r), upper=True)
        return K, mu, L, alpha

    def _adopt_state(self, hyperpars, theta, state=None):
        """Take ``hyperpars`` (numpy) and its tensor ``theta`` as the model's
        hyperparameters, with ``state`` (``_fit_state(theta)`` unless given)."""
        self.hyperpars = np.asarray(hyperpars, dtype=float)
        self.mean_hyperpars = self.hyperpars[self.mean_slice]
        self.cov_hyperpars = self.hyperpars[self.cov_slice]
        if state is None:
            state = self._fit_state(theta)
        self.K_xx, self.mu, self.L, self.alpha = state
        self._cov_pars_dev = theta[self.cov_slice]
        self._mean_pars_dev = theta[self.mean_slice]
        self._state_stale = False

    def _state(self):
        """The prediction state the state-taking predictor reads: x, L,
        alpha, the covariance and mean parameters and the mask."""
        return (self._x_dev, self.L, self.alpha, self._cov_pars_dev, self._mean_pars_dev,
                self._mask_dev)

    def check_error_data(self, y_err, y_cov):
        self._sig_is_diag = y_cov is None
        if y_cov is not None:
            if type(y_cov) in (list, tuple):
                y_cov = np.array(y_cov).squeeze()
            elif not isinstance(y_cov, np.ndarray):
                raise TypeError(
                    f"[ GpRegressor error ] The 'y_cov' keyword argument should "
                    f"be given as a numpy array: expected {np.ndarray} but "
                    f"{type(y_cov)} was given."
                )
            if y_cov.shape != (self.n_points, self.n_points):
                raise ValueError(
                    "[ GpRegressor error ] 'y_cov' must be a 2D array of shape "
                    "(N, N), where N is the number of given y-data values."
                )
            if not (y_cov == y_cov.T).all():
                raise ValueError(
                    "[ GpRegressor error ] The covariance matrix passed to the "
                    "'y_cov' keyword argument is not symmetric."
                )
            if y_err is not None:
                warn(
                    "[ GpRegressor warning ] Only one of the 'y_err' and "
                    "'y_cov' keyword arguments should be specified. Only the "
                    "input to 'y_cov' will be used - the input to 'y_err' "
                    "will be ignored."
                )
            return y_cov

        if y_err is not None:
            if type(y_err) in (list, tuple):
                y_err = np.array(y_err).squeeze()
            elif not isinstance(y_err, np.ndarray):
                raise TypeError(
                    f"[ GpRegressor error ] The 'y_err' keyword argument should "
                    f"be given as a numpy array: expected {np.ndarray} but "
                    f"{type(y_err)} was given."
                )
            if y_err.shape != (self.n_points,):
                raise ValueError(
                    "[ GpRegressor error ] 'y_err' must be a 1D array of length "
                    "N, where N is the number of given y-data values."
                )
            return np.diag(y_err**2)

        return np.zeros([self.n_points, self.n_points])

    def process_points(self, points) -> np.ndarray:
        x = points if isinstance(points, np.ndarray) else np.array(points)
        if x.ndim <= 1 and self.n_dimensions == 1:
            x = x.reshape([x.size, 1])
        elif x.ndim == 1 and x.size == self.n_dimensions:
            x = x.reshape([1, x.size])
        elif x.ndim > 2:
            raise ValueError(
                f"[ GpRegressor error ] 'points' argument must be a 2D array, "
                f"but given array has {x.ndim} dimensions and shape {x.shape}."
            )
        if x.shape[1] != self.n_dimensions:
            raise ValueError(
                f"[ GpRegressor error ] The second dimension of the 'points' "
                f"array must have size equal to the number of dimensions of "
                f"the input data. The input data have {self.n_dimensions} "
                f"dimensions but 'points' has shape {x.shape}."
            )
        return x

    # ------------------------------------------------------------------ #
    # prediction
    # ------------------------------------------------------------------ #
    def _points(self, points):
        self._require_current_state()
        return torch.as_tensor(np.ascontiguousarray(self.process_points(points)),
                               dtype=self._dtype, device=self._device)

    def _mean_at(self, q):
        """Prior mean at each row of ``q``."""
        return torch.func.vmap(lambda p: self.mean.point(p, self._mean_pars_dev, self._x_dev))(q)

    def _k_diag(self, q):
        """Prior variance ``k(q_i, q_i)`` at each row of ``q``."""
        cov_pars = self._cov_pars_dev
        return torch.func.vmap(lambda p: self.cov(p[None, :], p[None, :], cov_pars)[0, 0])(q)

    def _predict_single(self, q, x, L, alpha, cov_pars, mean_pars, m):
        """Predictive mean and variance at one point ``q`` (D,) under the
        state given (``_state()`` for the model's own), so that a caller
        can score points under another fit's state."""
        K_qx = self.cov(q[None, :], x, cov_pars)[0] * m
        mu = K_qx @ alpha + self.mean.point(q, mean_pars, x)
        v = _tril_solve(L, K_qx)
        kqq = self.cov(q[None, :], q[None, :], cov_pars)[0, 0]
        return mu, kqq - v @ v

    def __call__(self, points):
        """Predictive means and standard deviations at the given points,
        in one batched computation."""
        q = self._points(points)
        with torch.no_grad():
            K_qx = self.cov(q, self._x_dev, self._cov_pars_dev) * self._mask_dev[None, :]
            mu = K_qx @ self.alpha + self._mean_at(q)
            v = _tril_solve(self.L, K_qx.T)
            var = self._k_diag(q) - (v**2).sum(dim=0)
        return mu.cpu().numpy(), torch.sqrt(torch.abs(var)).cpu().numpy()

    def gradient(self, points):
        """
        Mean and covariance of the gradient of the regression estimate at
        the given points. The derivative kernels come from autodiff of the
        covariance function, so any kernel works.
        """
        q = self._points(points)
        x, m, alpha, L = self._x_dev, self._mask_dev, self.alpha, self.L
        cov_pars, mean_pars = self._cov_pars_dev, self._mean_pars_dev

        def grad_single(p):
            dK = torch.func.jacfwd(lambda s: self.cov(s[None, :], x, cov_pars)[0] * m)(p)
            dmu = dK.T @ alpha + torch.func.grad(lambda s: self.mean.point(s, mean_pars, x))(p)
            pair = lambda a, b: self.cov(a[None, :], b[None, :], cov_pars)[0, 0]
            R = torch.func.jacfwd(torch.func.grad(pair, argnums=0), argnums=1)(p, p)
            Qm = _tril_solve(L, dK)
            return dmu, R - Qm.T @ Qm

        mu_g, cov_g = torch.func.vmap(grad_single)(q)
        return mu_g.detach().cpu().numpy().squeeze(), cov_g.detach().cpu().numpy().squeeze()

    def spatial_derivatives(self, points):
        """Gradients of the predictive mean and variance at the given
        points, by autodiff of the predictor."""
        q = self._points(points)
        st = self._state()
        dmu = torch.func.vmap(torch.func.grad(lambda p: self._predict_single(p, *st)[0]))(q)
        dvar = torch.func.vmap(torch.func.grad(lambda p: self._predict_single(p, *st)[1]))(q)
        return dmu.detach().cpu().numpy().squeeze(), dvar.detach().cpu().numpy().squeeze()

    def build_posterior(self, points, mean_only=False):
        """Full posterior mean vector (and covariance matrix) at the given
        points."""
        v = self._points(points)
        with torch.no_grad():
            K_qx = self.cov(v, self._x_dev, self._cov_pars_dev) * self._mask_dev[None, :]
            mu = K_qx @ self.alpha + torch.func.vmap(
                lambda p: self.mean(p, self._mean_pars_dev))(v)
            if mean_only:
                return mu.cpu().numpy()
            K_qq = self.cov(v, v, self._cov_pars_dev)
            Q = _tril_solve(self.L, K_qx.T)
            sigma = K_qq - Q.T @ Q
        return mu.cpu().numpy(), sigma.cpu().numpy()

    def loo_predictions(self):
        """Leave-one-out predictions for each data point (R&W eq. 5.12)."""
        self._require_current_state()
        with torch.no_grad():
            iK = torch.cholesky_inverse(self.L)
            var = 1.0 / torch.diagonal(iK)
            alpha = iK @ ((self._y_dev - self.mu) * self._mask_dev)
            mu = self._y_dev - alpha * var
        n = self.n_points
        return mu.cpu().numpy()[:n], torch.sqrt(var).cpu().numpy()[:n]

    # ------------------------------------------------------------------ #
    # hyperparameter optimisation
    # ------------------------------------------------------------------ #
    def differential_evo(self):
        opt_result = differential_evolution(
            func=lambda x: -self.model_selector(x), bounds=self.hp_bounds
        )
        return opt_result.x

    def bfgs_cost_func(self, theta):
        y, grad_y = self.model_selector_gradient(theta)
        return -y, -np.asarray(grad_y, dtype=float)

    def launch_bfgs(self, x0):
        return fmin_l_bfgs_b(
            func=self.bfgs_cost_func, x0=x0, approx_grad=False, bounds=self.hp_bounds
        )

    def _hp_box(self):
        """The hyperparameter bounds as two tensors of the working dtype."""
        lwr, upr = (torch.tensor([b[i] for b in self.hp_bounds], dtype=self._dtype,
                                 device=self._device) for i in (0, 1))
        return lwr, upr

    def _fit_starts(self, starts: int, seed: int) -> torch.Tensor:
        """``fit_device``'s starts in sigmoid coordinates: ``starts - 1``
        uniform in the middle 90% of the box (``default_rng(seed)``), and
        the box centre."""
        rng = np.random.default_rng(seed)
        u = rng.uniform(0.05, 0.95, size=(max(starts - 1, 0), self.n_hyperpars))
        z0 = np.concatenate([np.log(u / (1 - u)), np.zeros((1, self.n_hyperpars))])
        return torch.as_tensor(z0, dtype=self._dtype, device=self._device)

    def _fit_device_z(self, z0, refine=True):
        """Every start of ``z0`` (S, p) by the batched BFGS (250 iterations)
        on the model-selection objective of ``lo + (hi - lo) sigmoid(z)``;
        a start whose iterate is not finite keeps its start, scored +inf.
        With ``refine`` the winner (the box centre if every start failed) is
        refined (500 iterations, gtol 1e-8) and the refined point adopted
        where it is finite and no worse (``utils.optimize.refined_multistart``).
        Returns ``(zs, fs, z_best)`` on the device, ``z_best`` None without
        ``refine``; no host read but the BFGS loops' own."""
        lo, hi = self._hp_box()
        jitter = _FIT_JITTER_F32 if self._dtype == torch.float32 else 0.0
        neg = lambda z: -self._batched_objective(lo + (hi - lo) * torch.sigmoid(z), jitter)
        if not refine:
            return (*scored_starts(minimize_bfgs(neg, z0, maxiter=250), z0), None)
        return refined_multistart(neg, z0, 250, 500, 1e-8)[:3]

    def fit_device(self, starts: int = 16, seed: int = 0, polish="device"):
        """
        Hyperparameter fit with every start optimised at once on the
        device: ``starts`` BFGS runs of the model-selection objective (the
        LML, or the LOO likelihood with ``cross_val=True``) batched by
        ``utils.optimize.minimize_bfgs``, on hyperparameters mapped into
        their bounds by a sigmoid, so the optimiser is unconstrained.

        :param starts: number of starting positions (``starts - 1`` drawn
            from ``default_rng(seed)``, and the box centre).
        :param seed: seed of the start positions.
        :param polish: ``"device"`` (default) refines the winner with a
            second, tighter device BFGS; ``"host"`` (or True) runs one host
            L-BFGS-B from the winner; False or None skips refinement.
        :return: the optimised hyperparameter vector (numpy array).
        """
        lwr = np.array([b[0] for b in self.hp_bounds], dtype=float)
        upr = np.array([b[1] for b in self.hp_bounds], dtype=float)
        zs, fs, z_best = self._fit_device_z(self._fit_starts(starts, seed),
                                            refine=polish == "device")
        if polish == "device":
            z = z_best.cpu().numpy().astype(float)
        else:
            zs, fs = zs.cpu().numpy().astype(float), fs.cpu().numpy().astype(float)
            z = zs[int(np.nanargmin(np.where(np.isfinite(fs), fs, np.inf)))]
        theta = lwr + (upr - lwr) / (1.0 + np.exp(-z))
        if polish in ("host", True):
            theta, _, _ = self.launch_bfgs(theta)
        return np.asarray(theta, dtype=float)

    def multistart_bfgs(self, starts: int = None, n_processes: int = 1):
        if starts is None:
            starts = int(2 * np.sqrt(len(self.hp_bounds))) + 1
        lwr, upr = [np.array([k[i] for k in self.hp_bounds]) for i in [0, 1]]
        rng = np.random.default_rng()
        starting_positions = [
            lwr + (upr - lwr) * rng.random(size=len(self.hp_bounds))
            for _ in range(max(starts - 1, 0))
        ]
        starting_positions.append(0.5 * (lwr + upr))
        # n_processes is ignored: the starts run one after another, each
        # objective evaluation on the device
        results = [self.launch_bfgs(x0) for x0 in starting_positions]
        return sorted(results, key=lambda x: x[1])[0][0]

    def __str__(self):
        pad = max(len(label) for label in self.hyperpar_labels) + 2
        strings = ["\n[ GpRegressor hyperparameters ]\n"]
        for label, val in zip(self.hyperpar_labels, self.hyperpars):
            strings.append(f"{label:>{pad}} = {val:.4}\n")
        return "".join(strings)
