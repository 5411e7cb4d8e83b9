"""Mean functions for Gaussian-process regression.

Port of ``inference_tpu.gp.mean``, with the same classes and methods
(``pass_spatial_data``, ``estimate_hyperpar_bounds``, ``__call__``,
``build_mean``, ``vector``, ``point``, ``mean_and_gradients``). Bounds are
host statistics in numpy, computed as the JAX package computes them.
Hyperparameters arrive as tensors; the stored data is converted to their
dtype and device where it is used.
"""

from abc import ABC, abstractmethod

import numpy as np
import torch


def _on(a, theta):
    """``a`` as a tensor with the dtype and device of ``theta``."""
    return torch.as_tensor(a, dtype=theta.dtype, device=theta.device)


class MeanFunction(ABC):
    """Abstract base class for mean functions."""

    @abstractmethod
    def pass_spatial_data(self, x):
        pass

    @abstractmethod
    def estimate_hyperpar_bounds(self, y):
        pass

    @abstractmethod
    def __call__(self, q, theta):
        pass

    @abstractmethod
    def build_mean(self, theta):
        pass

    def vector(self, x, theta):
        """Mean vector at the explicitly passed data rows ``x``."""
        return torch.func.vmap(lambda q: self(q, theta))(x)

    def point(self, q, theta, x):
        """Mean at a single query point; ``x`` provides the data context
        (e.g. the centroid for centred means)."""
        return self(q, theta)

    def mean_and_gradients(self, theta):
        """Mean vector and per-hyperparameter gradients by forward-mode
        autodiff."""
        theta = torch.as_tensor(theta)
        mu = self.build_mean(theta)
        jac = torch.func.jacfwd(self.build_mean)(theta)
        return mu, [jac[:, i] for i in range(theta.numel())]


class ConstantMean(MeanFunction):
    """Constant mean with one hyperparameter."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds
        self.n_params = 1
        self.hyperpar_labels = ["ConstantMean"]

    def pass_spatial_data(self, x):
        self.n_data = int(x.shape[0])

    def estimate_hyperpar_bounds(self, y):
        y = np.asarray(y)
        w = float(y.max() - y.min())
        self.bounds = [(float(y.min()) - w, float(y.max()) + w)]

    def __call__(self, q, theta):
        return torch.as_tensor(theta)[0]

    def build_mean(self, theta):
        theta = torch.as_tensor(theta)
        return theta[0].expand(self.n_data)

    def vector(self, x, theta):
        return torch.as_tensor(theta)[0].expand(x.shape[0])

    def point(self, q, theta, x):
        return torch.as_tensor(theta)[0]


class LinearMean(MeanFunction):
    """Linear mean over centred coordinates."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        x = np.asarray(x)
        self.x_mean = x.mean(axis=0)
        self.dx = x - self.x_mean[None, :]
        self.n_data = int(x.shape[0])
        self.n_params = 1 + int(x.shape[1])
        self.hyperpar_labels = ["LinearMean background"]
        self.hyperpar_labels.extend(f"LinearMean gradient {i}" for i in range(x.shape[1]))

    def estimate_hyperpar_bounds(self, y):
        y = np.asarray(y)
        w = float(y.max() - y.min())
        grad_bounds = 10 * w / (self.dx.max(axis=0) - self.dx.min(axis=0))
        self.bounds = [(float(y.min()) - 2 * w, float(y.max()) + 2 * w)]
        self.bounds.extend((-float(b), float(b)) for b in grad_bounds)

    def __call__(self, q, theta):
        theta = torch.as_tensor(theta)
        return theta[0] + ((_on(q, theta) - _on(self.x_mean, theta)) @ theta[1:]).squeeze()

    def build_mean(self, theta):
        theta = torch.as_tensor(theta)
        return theta[0] + _on(self.dx, theta) @ theta[1:]

    def vector(self, x, theta):
        # padded rows sit exactly at the real data's centroid, so the mean
        # over the padded rows is the real centroid: exact under padding
        theta = torch.as_tensor(theta)
        return theta[0] + (x - x.mean(dim=0)[None, :]) @ theta[1:]

    def point(self, q, theta, x):
        theta = torch.as_tensor(theta)
        return theta[0] + ((q - x.mean(dim=0)) @ theta[1:]).squeeze()


class QuadraticMean(MeanFunction):
    """Quadratic mean without cross terms."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        x = np.asarray(x)
        n = int(x.shape[1])
        self.x_mean = x.mean(axis=0)
        self.dx = x - self.x_mean[None, :]
        self.dx_sqr = self.dx**2
        self.n_data = int(x.shape[0])
        self.n_params = 1 + 2 * n
        self.hyperpar_labels = ["mean_background"]
        self.hyperpar_labels.extend(f"mean_linear_coeff_{i}" for i in range(n))
        self.hyperpar_labels.extend(f"mean_quadratic_coeff_{i}" for i in range(n))
        self.lin_slc = slice(1, n + 1)
        self.quad_slc = slice(n + 1, 2 * n + 1)

    def estimate_hyperpar_bounds(self, y):
        y = np.asarray(y)
        w = float(y.max() - y.min())
        grad_bounds = 10 * w / (self.dx.max(axis=0) - self.dx.min(axis=0))
        self.bounds = [(float(y.min()) - 2 * w, float(y.max()) + 2 * w)]
        self.bounds.extend((-float(b), float(b)) for b in grad_bounds)
        self.bounds.extend((-float(b), float(b)) for b in grad_bounds)

    def _at(self, d, theta):
        lin = (d @ theta[self.lin_slc]).squeeze()
        quad = ((d**2) @ theta[self.quad_slc]).squeeze()
        return theta[0] + lin + quad

    def __call__(self, q, theta):
        theta = torch.as_tensor(theta)
        return self._at(_on(q, theta) - _on(self.x_mean, theta), theta)

    def build_mean(self, theta):
        theta = torch.as_tensor(theta)
        return (theta[0] + _on(self.dx, theta) @ theta[self.lin_slc]
                + _on(self.dx_sqr, theta) @ theta[self.quad_slc])

    def vector(self, x, theta):
        theta = torch.as_tensor(theta)
        d = x - x.mean(dim=0)[None, :]
        return theta[0] + d @ theta[self.lin_slc] + d**2 @ theta[self.quad_slc]

    def point(self, q, theta, x):
        theta = torch.as_tensor(theta)
        return self._at(q - x.mean(dim=0), theta)
