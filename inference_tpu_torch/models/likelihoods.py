"""Likelihood functors (Gaussian, Cauchy, Logistic) and the linear forward
model.

Port of ``inference_tpu.models.likelihoods``:

- ``__call__(theta)`` returns the log-likelihood given model parameters;
- ``gradient(theta)`` returns d(logL)/d(theta): through the user's
  ``forward_model_jacobian`` by the chain rule where one is given, as the
  reference does, otherwise by ``torch.func.grad`` through the forward
  model;
- ``cost`` / ``cost_gradient`` negations.

The data live as tensors on an explicit device (default the card) in
``utils.dtypes.default_float()``. The forward model is the user's torch
callable ``(P,) -> (n_data,)``; it must compute on that device. Every
method is torch arithmetic, so an instance works under ``torch.func.vmap``
and ``grad`` and can be passed as the ``posterior`` of the samplers.

``LinearForwardModel(M, offset)`` is the forward model ``M @ theta +
offset`` as a callable that keeps its matrix readable: a likelihood over it
(in a ``Posterior`` with the priors of ``models``) is what
``ChainArray(fused=True)`` hands to the fused kernel's model route
(``ops.hmc_model``), which cannot call a Python function. The JAX package
reaches the same matrix through the closure of the user's function; the
port's own counterpart has no JAX name.
"""

from abc import ABC, abstractmethod
import math

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.dtypes import default_float


def _as_theta(theta, like):
    """``theta`` as a tensor in ``like``'s dtype and on its device (a tensor,
    batched under ``vmap`` or not, is taken as it is)."""
    if isinstance(theta, torch.Tensor):
        return theta
    return torch.as_tensor(np.asarray(theta, dtype=float), dtype=like.dtype, device=like.device)


class LinearForwardModel:
    """
    The forward model ``F(theta) = M @ theta + offset``: ``(P,)`` positions
    give ``(N,)`` predictions, ``(K, P)`` give ``(K, N)``. Plain torch
    arithmetic, so it works under ``torch.func.vmap`` and ``grad``.

    :param M: the ``(N, P)`` model matrix.
    :param offset: optional ``(N,)`` predictions at ``theta = 0``.
    :param device: where ``M`` and ``offset`` live (default the card; pass
        ``"cpu"`` for the CPU), in ``utils.dtypes.default_float()``.
    """

    def __init__(self, M, offset=None, device="cuda"):
        self.device = resolve_device(device, "LinearForwardModel")
        self.dtype = default_float()
        as_tensor = lambda x: (x.detach() if isinstance(x, torch.Tensor)
                               else torch.as_tensor(np.asarray(x, dtype=float))).to(
            device=self.device, dtype=self.dtype)
        self.M = as_tensor(M).contiguous()
        if self.M.ndim != 2:
            raise ValueError(f"M must be a 2D (N, P) matrix, got shape {tuple(self.M.shape)}")
        self.n_data, self.n_parameters = self.M.shape
        self.offset = None
        if offset is not None:
            self.offset = as_tensor(offset).reshape(-1).contiguous()
            if self.offset.shape[0] != self.n_data:
                raise ValueError(f"offset has {self.offset.shape[0]} elements, M has "
                                 f"{self.n_data} rows")

    def __call__(self, theta):
        theta = _as_theta(theta, self.M)
        predictions = theta @ self.M.T
        return predictions if self.offset is None else predictions + self.offset


class Likelihood(ABC):
    """
    Base class for likelihood functors.

    :param y_data: measured data as a 1D array.
    :param uncertainties: positive standard deviations / uncertainties per datum.
    :param uncertainties_name: attribute name for the uncertainties.
    :param forward_model: torch callable mapping parameters -> predictions of
        y_data.
    :param forward_model_jacobian: optional torch callable returning the
        (n_data, n_params) jacobian of the forward model. If omitted,
        gradients are computed by ``torch.func.grad`` of ``forward_model``.
    :param device: where the data live (default the card; pass ``"cpu"``
        for the CPU).
    """

    def __init__(
        self,
        y_data,
        uncertainties,
        uncertainties_name: str,
        forward_model: callable,
        forward_model_jacobian: callable = None,
        device="cuda",
    ):
        if not callable(forward_model):
            raise ValueError("Given forward_model object must be callable")
        if forward_model_jacobian is not None and not callable(forward_model_jacobian):
            raise ValueError("Given forward_model_jacobian object must be callable")

        y = np.atleast_1d(np.asarray(y_data, dtype=float).squeeze())
        errs = np.atleast_1d(np.asarray(uncertainties, dtype=float).squeeze())

        if y.size != errs.size:
            raise ValueError(
                f"y_data and {uncertainties_name} arguments must have the same "
                f"number of elements"
            )
        if y.ndim > 1 or errs.ndim > 1:
            raise ValueError(
                f"y_data and {uncertainties_name} arguments must have either "
                f"0 or 1 dimensions"
            )
        if (errs <= 0).any():
            raise ValueError(
                f"All values in {uncertainties_name} argument must be greater "
                f"than zero"
            )

        self.device = resolve_device(device, self.__class__.__name__)
        self.dtype = default_float()
        self.y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        setattr(self, uncertainties_name,
                torch.as_tensor(errs, dtype=self.dtype, device=self.device))
        self.model = forward_model
        self.model_jacobian = forward_model_jacobian
        self.n_data = int(y.size)

    @abstractmethod
    def _log_likelihood(self, predictions):
        pass

    @abstractmethod
    def _dL_dF(self, predictions):
        """Derivative of the log-likelihood w.r.t. the model predictions."""

    def __call__(self, theta):
        """Log-likelihood value for the given model parameters."""
        return self._log_likelihood(self.model(_as_theta(theta, self.y)))

    def gradient(self, theta):
        """
        Gradient of the log-likelihood with respect to the model parameters:
        the user's jacobian by the chain rule where given (as the reference
        does), otherwise ``torch.func.grad`` through the forward model.
        """
        theta = _as_theta(theta, self.y)
        if self.model_jacobian is not None:
            predictions = self.model(theta)
            return self._dL_dF(predictions) @ self.model_jacobian(theta)
        return torch.func.grad(lambda t: self._log_likelihood(self.model(t)))(theta)

    def cost(self, theta):
        return -self.__call__(theta)

    def cost_gradient(self, theta):
        return -self.gradient(theta)


class GaussianLikelihood(Likelihood):
    r"""
    Gaussian likelihood: ``logL = -0.5 sum(((y - F)/sigma)^2) + const``
    (reference: inference/likelihoods.py:122-167).
    """

    def __init__(self, y_data, sigma, forward_model, forward_model_jacobian=None, device="cuda"):
        super().__init__(y_data, sigma, "sigma", forward_model, forward_model_jacobian, device)
        self.inv_sigma = 1.0 / self.sigma
        self.inv_sigma_sqr = self.inv_sigma**2
        self.normalisation = (
            -torch.log(self.sigma).sum() - 0.5 * math.log(2 * math.pi) * self.n_data
        )

    def _log_likelihood(self, predictions):
        z = (self.y - predictions) * self.inv_sigma
        return -0.5 * (z**2).sum() + self.normalisation

    def _dL_dF(self, predictions):
        return (self.y - predictions) * self.inv_sigma_sqr


class CauchyLikelihood(Likelihood):
    r"""
    Cauchy likelihood: ``logL = -sum(log(1 + z^2)) + const`` with
    ``z = (y - F)/gamma`` (reference: inference/likelihoods.py:170-215).
    """

    def __init__(self, y_data, gamma, forward_model, forward_model_jacobian=None, device="cuda"):
        super().__init__(y_data, gamma, "gamma", forward_model, forward_model_jacobian, device)
        self.inv_gamma = 1.0 / self.gamma
        self.normalisation = -torch.log(math.pi * self.gamma).sum()

    def _log_likelihood(self, predictions):
        z = (self.y - predictions) * self.inv_gamma
        return -torch.log1p(z**2).sum() + self.normalisation

    def _dL_dF(self, predictions):
        z = (self.y - predictions) * self.inv_gamma
        return 2 * self.inv_gamma * z / (1 + z**2)


class LogisticLikelihood(Likelihood):
    r"""
    Logistic likelihood with scale ``sigma * sqrt(3)/pi`` so that ``sigma``
    is the distribution standard deviation
    (reference: inference/likelihoods.py:218-264).
    """

    def __init__(self, y_data, sigma, forward_model, forward_model_jacobian=None, device="cuda"):
        super().__init__(y_data, sigma, "sigma", forward_model, forward_model_jacobian, device)
        self.scale = self.sigma * (math.sqrt(3.0) / math.pi)
        self.inv_scale = 1.0 / self.scale
        self.normalisation = -torch.log(self.scale).sum()

    def _log_likelihood(self, predictions):
        z = (self.y - predictions) * self.inv_scale
        return z.sum() - 2 * torch.logaddexp(torch.zeros_like(z), z).sum() + self.normalisation

    def _dL_dF(self, predictions):
        z = (self.y - predictions) * self.inv_scale
        return (2 / (1 + torch.exp(-z)) - 1) * self.inv_scale
