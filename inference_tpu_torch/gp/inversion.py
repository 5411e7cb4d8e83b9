"""Gaussian-process linear inversion.

Port of ``inference_tpu.gp.inversion.GpLinearInverter``: linear-Gaussian
inverse problems (tomography, deconvolution) with a GP prior over the
model parameters. The posterior and the data-space marginal likelihood run
as torch operations on the chosen device, the likelihood's gradient comes
from autograd, and the hyperparameters are fitted on the host by scipy's
Nelder-Mead. The keyword ``device=`` is the one addition to the JAX
constructor; the working dtype is ``utils.dtypes.default_float()``.
"""

from inspect import isclass

import numpy as np
import torch
from scipy.optimize import minimize

from ..ops.linalg import add_diagonal, cholesky_or_nan
from ..utils.device import resolve_device
from ..utils.dtypes import default_float
from .covariance import CovarianceFunction, SquaredExponential
from .mean import ConstantMean, MeanFunction
from .regression import _factor_or_identity, _floor, _tril_solve


class GpLinearInverter:
    """
    Bayesian solution of linear inverse problems with a Gaussian-process
    prior over the model parameters.

    :param y: data values as a 1D array.
    :param y_err: data standard deviations as a 1D array.
    :param model_matrix: linear forward model as a 2D array.
    :param parameter_spatial_positions: 2D array of the model parameters'
        positions in the space over which their values are correlated.
    :param prior_covariance_function: covariance class or instance for the
        prior (default SquaredExponential).
    :param prior_mean_function: mean class or instance for the prior
        (default ConstantMean).
    :param device: where the model and the computation live (default the
        card; raises when there is none, pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        y,
        y_err,
        model_matrix,
        parameter_spatial_positions,
        prior_covariance_function: CovarianceFunction = SquaredExponential,
        prior_mean_function: MeanFunction = ConstantMean,
        device="cuda",
    ):
        y = np.asarray(y)
        y_err = np.asarray(y_err)
        model_matrix = np.asarray(model_matrix)
        positions = np.asarray(parameter_spatial_positions)

        if model_matrix.ndim != 2:
            raise ValueError(
                "[ GpLinearInverter error ] 'model_matrix' argument must be "
                "a 2D numpy.ndarray"
            )
        if y.ndim != 1 or y_err.ndim != 1 or y.size != y_err.size:
            raise ValueError(
                "[ GpLinearInverter error ] 'y' and 'y_err' arguments must be "
                "1D numpy.ndarray of equal size."
            )
        if model_matrix.shape[0] != y.size:
            raise ValueError(
                f"[ GpLinearInverter error ] The size of the first dimension "
                f"of 'model_matrix' must equal the size of 'y', however they "
                f"have shapes {model_matrix.shape}, {y.shape} respectively."
            )
        if positions.ndim != 2:
            raise ValueError(
                "[ GpLinearInverter error ] 'parameter_spatial_positions' "
                "must be a 2D numpy.ndarray with first dimension equal to the "
                "number of model parameters."
            )
        if model_matrix.shape[1] != positions.shape[0]:
            raise ValueError(
                f"[ GpLinearInverter error ] The size of the second dimension "
                f"of 'model_matrix' must equal the size of the first dimension "
                f"of 'parameter_spatial_positions', however they have shapes "
                f"{model_matrix.shape}, {positions.shape} respectively."
            )

        self._dtype = default_float()
        self._device = resolve_device(device, "GpLinearInverter")
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=self._dtype,
                                        device=self._device)
        self.A = dev(model_matrix)
        self.y = dev(y)

        self.cov = prior_covariance_function
        self.cov = self.cov() if isclass(self.cov) else self.cov
        self.cov.pass_spatial_data(positions)
        if self.cov.bounds is None:
            self.cov.bounds = [(None, None)] * self.cov.n_params

        self.mean = prior_mean_function
        self.mean = self.mean() if isclass(self.mean) else self.mean
        self.mean.pass_spatial_data(positions)
        if self.mean.bounds is None:
            self.mean.bounds = [(None, None)] * self.mean.n_params

        self.n_hyperpars = self.mean.n_params + self.cov.n_params
        self.mean_slice = slice(0, self.mean.n_params)
        self.cov_slice = slice(self.mean.n_params, self.n_hyperpars)
        self.hyperpar_labels = [*self.mean.hyperpar_labels, *self.cov.hyperpar_labels]

        self._sigma_diag = dev(y_err) ** 2
        self.sigma = torch.diag(self._sigma_diag)
        self.inv_sigma = torch.diag(dev(y_err) ** -2.0)
        self.I = torch.eye(self.A.shape[1], dtype=self._dtype, device=self._device)

    def _theta(self, theta, requires_grad=False):
        return torch.tensor(np.asarray(theta, dtype=float), dtype=self._dtype,
                            device=self._device, requires_grad=requires_grad)

    def _posterior(self, theta):
        A, y = self.A, self.y
        inv_sigma_diag = 1.0 / self._sigma_diag
        K = self.cov.build_covariance(theta[self.cov_slice])
        prior_mean = self.mean.build_mean(theta[self.mean_slice])
        W = A.T @ (inv_sigma_diag[:, None] * A)
        u = A.T @ (inv_sigma_diag * (y - A @ prior_mean))
        posterior_cov = torch.linalg.solve(add_diagonal(K @ W, 1.0), K)
        return posterior_cov @ u + prior_mean, posterior_cov

    def _lml_of(self, theta):
        A = self.A
        K = self.cov.build_covariance(theta[self.cov_slice])
        prior_mean = self.mean.build_mean(theta[self.mean_slice])
        J = add_diagonal(A @ K @ A.T, self._sigma_diag)
        L, ok = _factor_or_identity(cholesky_or_nan(J))
        v = _tril_solve(L, self.y - A @ prior_mean)
        value = -0.5 * (v @ v) - torch.log(torch.diagonal(L)).sum()
        return torch.where(ok, value, _floor(value.dtype))

    def calculate_posterior(self, theta):
        """Posterior mean and covariance for the given hyperparameters."""
        with torch.no_grad():
            mu, cov = self._posterior(self._theta(theta))
        return mu.cpu().numpy(), cov.cpu().numpy()

    def calculate_posterior_mean(self, theta):
        """Posterior mean for the given hyperparameters."""
        return self.calculate_posterior(theta)[0]

    def marginal_likelihood(self, theta) -> float:
        """Log-marginal likelihood in data space."""
        with torch.no_grad():
            return float(self._lml_of(self._theta(theta)))

    def marginal_likelihood_gradient(self, theta):
        """The log-marginal likelihood and its hyperparameter gradient by
        autograd."""
        t = self._theta(theta, requires_grad=True)
        value = self._lml_of(t)
        (grad,) = torch.autograd.grad(value, t)
        return float(value.detach()), grad.cpu().numpy()

    def optimize_hyperparameters(self, initial_guess):
        """Maximise the marginal likelihood by Nelder-Mead from the given
        initial guess."""
        initial_guess = np.asarray(initial_guess)
        if initial_guess.size != self.n_hyperpars:
            raise ValueError(
                f"[ GpLinearInverter error ] There are a total of "
                f"{self.n_hyperpars} hyper-parameters, but "
                f"{initial_guess.size} values were given in 'initial_guess'."
            )
        hp_bounds = [*self.mean.bounds, *self.cov.bounds]
        result = minimize(
            fun=lambda t: -self.marginal_likelihood(t),
            x0=initial_guess,
            method="Nelder-Mead",
            bounds=hp_bounds,
        )
        return result.x
