"""Covariance functions for Gaussian-process regression.

Port of ``inference_tpu.gp.covariance``, with the same classes and public
methods (``pass_spatial_data``, ``estimate_hyperpar_bounds``,
``__call__``, ``build_covariance``, ``matrix``,
``covariance_and_gradients``, composition with ``+``):

- pairwise squared distances are assembled on the fly, never as an
  N x N x D tensor; the squared-exponential block goes through
  ``ops.pairwise.sqexp_covariance`` (kernel B2 for large blocks);
- ``covariance_and_gradients`` is ``torch.func.jacfwd`` of
  ``build_covariance`` on the matmul form; the fitting path never calls
  it, it differentiates the scalar likelihood in reverse mode;
- bounds are host statistics in numpy, computed from the same subsample
  as in the JAX package, so both packages estimate the same bounds.

Hyperparameters arrive as tensors; stored data is converted to their dtype
and device where it is used.
"""

from abc import ABC, abstractmethod
from collections.abc import Sequence
from inspect import isclass
from itertools import chain

import numpy as np
import torch

from ..ops import pairwise
from ..ops.linalg import add_diagonal
from ..ops.pairwise import scaled_sq_distances, sqexp_covariance


def _on(a, theta):
    """``a`` as a tensor with the dtype and device of ``theta``."""
    return torch.as_tensor(a, dtype=theta.dtype, device=theta.device)


def _distance_bounds(x):
    """Per-dimension lengthscale bounds from the pairwise coordinate
    differences of at most 2000 rows (a fixed-seed subsample beyond)."""
    x = np.asarray(x)
    if x.shape[0] > 2000:
        idx = np.random.default_rng(0).choice(x.shape[0], 2000, replace=False)
        x = x[idx]
    dx = x[:, None, :] - x[None, :, :]
    return [
        (float(np.log(np.abs(dx[:, :, i]).mean())) - 4, float(np.log(dx[:, :, i].max())) + 2)
        for i in range(x.shape[1])
    ]


class CovarianceFunction(ABC):
    """Abstract base class for covariance functions."""

    @abstractmethod
    def pass_spatial_data(self, x):
        pass

    @abstractmethod
    def estimate_hyperpar_bounds(self, y):
        pass

    @abstractmethod
    def __call__(self, u, v, theta):
        pass

    @abstractmethod
    def build_covariance(self, theta):
        pass

    def matrix(self, x, theta):
        """Data covariance of the explicitly passed rows ``x``."""
        return self(x, x, theta)

    def covariance_and_gradients(self, theta):
        """The data covariance matrix and its gradient with respect to each
        hyperparameter, by forward-mode autodiff on the matmul form."""
        theta = torch.as_tensor(theta)
        K = self.build_covariance(theta)
        with pairwise._matmul_form():
            jac = torch.func.jacfwd(self.build_covariance)(theta)
        return K, [jac[..., i] for i in range(theta.numel())]

    def __add__(self, other):
        K1 = self.components if isinstance(self, CompositeCovariance) else [self]
        K2 = other.components if isinstance(other, CompositeCovariance) else [other]
        return CompositeCovariance([*K1, *K2])

    def gradient_terms(self, v, x, theta):
        raise NotImplementedError(
            f"Gradient calculations are not yet available for the "
            f"{type(self)} covariance function."
        )


class CompositeCovariance(CovarianceFunction):
    """Sum of covariance components with per-component hyperparameter
    slices."""

    def __init__(self, covariance_components):
        self.components = covariance_components
        self.bounds = None

    def pass_spatial_data(self, x):
        for comp in self.components:
            comp.pass_spatial_data(x)
        self.slices = slice_builder([c.n_params for c in self.components])
        self.hyperpar_labels = []
        for i, comp in enumerate(self.components):
            self.hyperpar_labels.extend(f"K{i + 1}: {s}" for s in comp.hyperpar_labels)
        self.n_params = sum(c.n_params for c in self.components)

    def estimate_hyperpar_bounds(self, y):
        for comp in self.components:
            if comp.bounds is None:
                comp.estimate_hyperpar_bounds(y)
        self.bounds = []
        for comp in self.components:
            self.bounds.extend(comp.bounds)

    def __call__(self, u, v, theta):
        theta = torch.as_tensor(theta)
        return sum(comp(u, v, theta[slc]) for comp, slc in zip(self.components, self.slices))

    def build_covariance(self, theta):
        theta = torch.as_tensor(theta)
        return sum(
            comp.build_covariance(theta[slc])
            for comp, slc in zip(self.components, self.slices)
        )

    def matrix(self, x, theta):
        theta = torch.as_tensor(theta)
        return sum(comp.matrix(x, theta[slc]) for comp, slc in zip(self.components, self.slices))


class WhiteNoise(CovarianceFunction):
    """Independent identically distributed Gaussian noise:
    ``K(x_i, x_j) = delta_ij sigma_n^2`` with hyperparameter ``ln sigma_n``.
    Use as part of a composite kernel, e.g. ``SquaredExponential() +
    WhiteNoise()``."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds
        self.n_params = 1
        self.hyperpar_labels = ["WhiteNoise log-sigma"]

    def pass_spatial_data(self, x):
        self.n_data = int(x.shape[0])

    def estimate_hyperpar_bounds(self, y):
        s = float(np.log(np.ptp(np.asarray(y))))
        self.bounds = [(s - 8, s + 2)]

    def __call__(self, u, v, theta):
        theta = torch.as_tensor(theta)
        return theta.new_zeros((u.shape[0], v.shape[0]))

    def build_covariance(self, theta):
        theta = torch.as_tensor(theta)
        return torch.diag(torch.exp(2 * theta[0]).expand(self.n_data))

    def matrix(self, x, theta):
        theta = torch.as_tensor(theta)
        return torch.diag(torch.exp(2 * theta[0]).expand(x.shape[0]))

    def get_bounds(self):
        return self.bounds


class SquaredExponential(CovarianceFunction):
    """Squared-exponential kernel ``K(u, v) = A^2 exp(-1/2 sum_i ((u_i -
    v_i)/l_i)^2)`` with hyperparameters ``[ln A, ln l_1, ..., ln l_n]``."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        self.x = np.asarray(x) if not torch.is_tensor(x) else x
        d = self.x.shape[1]
        self.n_params = d + 1
        self.hyperpar_labels = ["SqrExp log-amplitude"]
        self.hyperpar_labels.extend(f"SqrExp log-scale {i}" for i in range(d))

    def estimate_hyperpar_bounds(self, y):
        s = float(np.log(np.asarray(y).std()))
        self.bounds = [(s - 4, s + 4)] + _distance_bounds(_host(self.x))

    def __call__(self, u, v, theta):
        theta = torch.as_tensor(theta)
        return sqexp_covariance(_on(u, theta), _on(v, theta), torch.exp(theta[0]),
                                torch.exp(theta[1:]))

    def build_covariance(self, theta):
        theta = torch.as_tensor(theta)
        return self.matrix(_on(self.x, theta), theta)

    def matrix(self, x, theta):
        theta = torch.as_tensor(theta)
        a = torch.exp(theta[0])
        K = sqexp_covariance(x, x, a, torch.exp(theta[1:]))
        # diagonal jitter scaled by the amplitude
        return add_diagonal(K, a**2 * 1e-12)

    def gradient_terms(self, v, x, theta):
        """Kernel-specific terms for predictive-gradient calculations."""
        theta = torch.as_tensor(theta)
        a = torch.exp(theta[0])
        L = torch.exp(theta[1:])
        A = (_on(x, theta) - _on(v, theta)[None, :]) / L[None, :] ** 2
        return A.T, torch.diag((a / L) ** 2)

    def get_bounds(self):
        return self.bounds


class RationalQuadratic(CovarianceFunction):
    """Rational-quadratic kernel ``K(u, v) = A^2 (1 + Z/alpha)^(-alpha)``
    with ``Z = 1/2 sum_i ((u_i - v_i)/l_i)^2`` and hyperparameters
    ``[ln A, ln alpha, ln l_1, ..., ln l_n]``."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        self.x = np.asarray(x) if not torch.is_tensor(x) else x
        d = self.x.shape[1]
        self.n_params = d + 2
        self.hyperpar_labels = ["RQ log-amplitude", "RQ log-alpha"]
        self.hyperpar_labels.extend(f"RQ log-scale {i}" for i in range(d))

    def estimate_hyperpar_bounds(self, y):
        s = float(np.log(np.asarray(y).std()))
        self.bounds = [(s - 4, s + 4), (-2, 6)] + _distance_bounds(_host(self.x))

    def __call__(self, u, v, theta):
        theta = torch.as_tensor(theta)
        a = torch.exp(theta[0])
        k = torch.exp(theta[1])
        Z = 0.5 * scaled_sq_distances(_on(u, theta), _on(v, theta), torch.exp(theta[2:]))
        return (a**2) * (1 + Z / k) ** (-k)

    def build_covariance(self, theta):
        theta = torch.as_tensor(theta)
        return self.matrix(_on(self.x, theta), theta)

    def matrix(self, x, theta):
        theta = torch.as_tensor(theta)
        a = torch.exp(theta[0])
        k = torch.exp(theta[1])
        Z = 0.5 * scaled_sq_distances(x, x, torch.exp(theta[2:]))
        return add_diagonal((a**2) * (1 + Z / k) ** (-k), a**2 * 1e-12)

    def get_bounds(self):
        return self.bounds


class HeteroscedasticNoise(CovarianceFunction):
    """Heteroscedastic (per-data-point) Gaussian noise:
    ``K(x_i, x_j) = delta_ij sigma_i^2`` with one ``ln sigma_i``
    hyperparameter per data value. Its gradients are built lazily, one
    matrix at a time."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        self.n_params = int(x.shape[0])
        self.hyperpar_labels = [f"log_sigma_{i + 1}" for i in range(self.n_params)]

    def estimate_hyperpar_bounds(self, y):
        s = float(np.log(np.ptp(np.asarray(y))))
        self.bounds = [(s - 8, s + 2) for _ in range(self.n_params)]

    def __call__(self, u, v, theta):
        theta = torch.as_tensor(theta)
        return theta.new_zeros((u.shape[0], v.shape[0]))

    def build_covariance(self, theta):
        return torch.diag(torch.exp(2 * torch.as_tensor(theta)))

    def matrix(self, x, theta):
        return self.build_covariance(theta)

    def covariance_and_gradients(self, theta):
        """``dK/dtheta_i = 2 sigma_i^2 e_i e_i^T``, as a lazy sequence that
        builds each (n, n) matrix on access."""
        theta = torch.as_tensor(theta)
        sigma_sq = torch.exp(2 * theta)
        n = self.n_params

        class _LazyDiagGrads(Sequence):
            def __len__(self):
                return n

            def __getitem__(self, i):
                if not 0 <= i < n:
                    raise IndexError(i)
                g = theta.new_zeros((n, n))
                g[i, i] = 2.0 * sigma_sq[i]
                return g

        return torch.diag(sigma_sq), _LazyDiagGrads()

    def get_bounds(self):
        return self.bounds


class ChangePoint(CovarianceFunction):
    """Change-point kernel: the input space is divided along one axis into
    regions, each modelled by its own kernel and blended by logistic
    weights whose locations and widths are hyperparameters.

    :param kernels: tuple of kernel objects or classes ``(K1, K2, ...)``.
    :param axis: the spatial axis over which transitions occur.
    :param location_bounds: optional bounds for the change-point locations.
    :param width_bounds: optional bounds for the change-point widths.
    """

    def __init__(
        self,
        kernels: Sequence,
        axis: int = 0,
        location_bounds: Sequence = None,
        width_bounds: Sequence = None,
    ):
        self.cov = [
            K() if isclass(K) and issubclass(K, CovarianceFunction) else K for K in kernels
        ]
        for K in self.cov:
            if not isinstance(K, CovarianceFunction):
                raise TypeError(
                    "[ ChangePoint error ] Each of the specified covariance "
                    "kernels must be an instance of a class inheriting from "
                    "the 'CovarianceFunction' abstract base-class."
                )
        self.n_kernels = len(kernels)
        self.location_bounds = self._checked(location_bounds, "location_bounds")
        self.width_bounds = self._checked(width_bounds, "width_bounds")
        self.axis = axis
        self.bounds = None

    def _checked(self, bounds, name):
        if bounds is None:
            return None
        if len(bounds) != self.n_kernels - 1:
            raise ValueError(
                f"[ ChangePoint error ] The length of '{name}' must be one "
                "less than the number of kernels"
            )
        return [check_bounds(b) for b in bounds]

    def pass_spatial_data(self, x):
        for K in self.cov:
            K.pass_spatial_data(x)
        param_counts = [K.n_params for K in self.cov] + [2] * (self.n_kernels - 1)
        self.n_params = sum(param_counts)
        slices = slice_builder(param_counts)
        self.cov_slc = slices[: self.n_kernels]
        self.cp_slc = slices[self.n_kernels :]

        labels = []
        for i, K in enumerate(self.cov):
            labels.extend(f"ChngPnt K{i}: {lab}" for lab in K.hyperpar_labels)
        for i in range(self.n_kernels - 1):
            labels.extend([f"ChngPnt{i} location", f"ChngPnt{i} width"])
        self.hyperpar_labels = labels
        self.x_cp = _host(x)[:, self.axis]

    def estimate_hyperpar_bounds(self, y):
        xr = (float(self.x_cp.min()), float(self.x_cp.max()))
        dx = xr[1] - xr[0]
        self.bounds = []
        for cov in self.cov:
            if cov.bounds is None:
                cov.estimate_hyperpar_bounds(y)
            self.bounds.extend(cov.bounds)
        if self.location_bounds is None:
            self.location_bounds = [xr] * (self.n_kernels - 1)
        if self.width_bounds is None:
            self.width_bounds = [(5e-3 * dx, 0.5 * dx)] * (self.n_kernels - 1)
        self.bounds.extend(chain.from_iterable(zip(self.location_bounds, self.width_bounds)))

    @staticmethod
    def logistic(x, theta):
        z = (x - theta[0]) / theta[1]
        return 1.0 / (1.0 + torch.exp(-z))

    def _kernel_coefficients(self, w_list):
        """Blending weights from per-change-point logistic values."""
        coeffs = [1.0]
        for w_u, w_v in w_list:
            w1 = (1 - w_u)[:, None] * (1 - w_v)[None, :]
            w2 = w_u[:, None] * w_v[None, :]
            coeffs[-1] = coeffs[-1] * w1
            coeffs.append(w2)
        return coeffs

    def _blend(self, parts, w_list):
        coeffs = self._kernel_coefficients(w_list)
        return sum(parts[i] * coeffs[i] for i in range(self.n_kernels))

    def __call__(self, u, v, theta):
        theta = torch.as_tensor(theta)
        u, v = _on(u, theta), _on(v, theta)
        w_list = [
            (self.logistic(u[:, self.axis], theta[slc]), self.logistic(v[:, self.axis], theta[slc]))
            for slc in self.cp_slc
        ]
        parts = [self.cov[i](u, v, theta[self.cov_slc[i]]) for i in range(self.n_kernels)]
        return self._blend(parts, w_list)

    def build_covariance(self, theta):
        theta = torch.as_tensor(theta)
        x_cp = _on(self.x_cp, theta)
        w_list = [(self.logistic(x_cp, theta[slc]),) * 2 for slc in self.cp_slc]
        parts = [self.cov[i].build_covariance(theta[self.cov_slc[i]]) for i in range(self.n_kernels)]
        return self._blend(parts, w_list)

    def matrix(self, x, theta):
        theta = torch.as_tensor(theta)
        x_cp = x[:, self.axis]
        w_list = [(self.logistic(x_cp, theta[slc]),) * 2 for slc in self.cp_slc]
        parts = [self.cov[i].matrix(x, theta[self.cov_slc[i]]) for i in range(self.n_kernels)]
        return self._blend(parts, w_list)

    def get_bounds(self):
        return self.bounds


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def slice_builder(lengths) -> list:
    slices = [slice(0, lengths[0])]
    for L in lengths[1:]:
        last = slices[-1].stop
        slices.append(slice(last, last + L))
    return slices


def check_bounds(bounds):
    if bounds is not None:
        if type(bounds) not in (list, tuple, np.ndarray) or len(bounds) != 2:
            raise ValueError(f"bounds must be a (lower, upper) pair, got {bounds!r}")
        if not bounds[1] > bounds[0]:
            raise ValueError(f"bounds must have upper > lower, got {bounds!r}")
    return bounds
