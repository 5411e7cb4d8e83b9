"""Particle-mass abstractions for the HMC kinetic energy.

Port of ``inference_tpu.mcmc.hmc.mass``, and the one owner of the port's
mass maps: ``HamiltonianChain`` and the batched transition of
``ChainArray`` (``parallel._kinds.build_mass_maps``) both use these
classes. Validation happens on the host at construction. The maps are
written for a leading batch axis, so each one takes ``(P,)`` or ``(K,
P)``: ``get_velocity`` applies the inverse mass to momenta, and
``momentum`` maps standard normals ``z`` to momenta whose covariance is
the mass. ``sample_momentum`` draws those normals from a
``torch.Generator``, or takes them as given, where the JAX package takes
a key. Like the port's other entry points, each runs on the card unless
the caller passes ``device="cpu"``, and raises without a card.
"""

from abc import ABC, abstractmethod

import numpy as np
import torch
from scipy.linalg import issymmetric, solve_triangular

from ...utils.device import resolve_device


class ParticleMass(ABC):
    inv_mass = None
    kind: str

    def __init__(self, n_parameters: int, dtype, device):
        self.n_parameters = n_parameters
        self.dtype = dtype
        self.device = resolve_device(device, type(self).__name__)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @abstractmethod
    def get_velocity(self, r):
        """Map momenta to velocities (apply the inverse mass)."""

    @abstractmethod
    def momentum(self, z):
        """Map standard normals to momenta drawn from the kinetic-energy
        density."""

    def sample_momentum(self, generator=None, z=None):
        """One ``(P,)`` momentum from ``generator``'s standard normals, or
        from the given normals ``z`` of any batch shape ``(..., P)``."""
        if z is None:
            z = torch.randn(self.n_parameters, generator=generator, dtype=self.dtype,
                            device=self.device)
        return self.momentum(z)


class ScalarMass(ParticleMass):
    kind = "scalar"

    def __init__(self, inv_mass: float, n_parameters: int, dtype=torch.float64, device="cuda"):
        super().__init__(n_parameters, dtype, device)
        self.inv_mass = float(inv_mass)
        if not self.inv_mass > 0.0:
            raise ValueError(
                f"[ ScalarMass error ] The inverse mass must be positive, got {self.inv_mass}."
            )
        self.sqrt_mass = 1.0 / np.sqrt(self.inv_mass)

    def get_velocity(self, r):
        return r * self.inv_mass

    def momentum(self, z):
        return z * self.sqrt_mass


class VectorMass(ParticleMass):
    kind = "vector"

    def __init__(self, inv_mass, n_parameters: int, dtype=torch.float64, device="cuda"):
        super().__init__(n_parameters, dtype, device)
        inv_mass = np.asarray(inv_mass, dtype=float)
        valid = (
            inv_mass.ndim == 1
            and inv_mass.size == n_parameters
            and (inv_mass > 0.0).all()
        )
        if not valid:
            raise ValueError(
                f"[ VectorMass error ] The inverse-mass vector must be a 1D array "
                f"of size equal to the number of model parameters "
                f"({n_parameters}) containing only positive values."
            )
        self.inv_mass = inv_mass
        self._inv_mass_dev = self._tensor(inv_mass)
        self._sqrt_mass_dev = 1.0 / torch.sqrt(self._inv_mass_dev)

    def get_velocity(self, r):
        return r * self._inv_mass_dev

    def momentum(self, z):
        return z * self._sqrt_mass_dev


class MatrixMass(ParticleMass):
    kind = "matrix"

    def __init__(self, inv_mass, n_parameters: int, dtype=torch.float64, device="cuda"):
        super().__init__(n_parameters, dtype, device)
        inv_mass = np.asarray(inv_mass, dtype=float)
        valid = (
            inv_mass.ndim == 2
            and inv_mass.shape[0] == inv_mass.shape[1]
            and issymmetric(inv_mass)
        )
        if not valid:
            raise ValueError(
                "[ MatrixMass error ] The given inverse-mass matrix must be a "
                "valid covariance matrix, i.e. 2 dimensional, square and symmetric."
            )
        if inv_mass.shape[0] != n_parameters:
            raise ValueError(
                f"[ MatrixMass error ] The dimensions of the given inverse-mass "
                f"matrix {inv_mass.shape} do not match the given number of model "
                f"parameters ({n_parameters})."
            )
        self.inv_mass = inv_mass
        # momentum covariance is M = (M^-1)^-1; sample r = L z with
        # L = inv(chol(M^-1))^T (reference: hmc/mass.py:86-88)
        iL = np.linalg.cholesky(inv_mass)  # raises if not positive-definite
        self.L = solve_triangular(iL, np.eye(n_parameters), lower=True).T
        self._inv_mass_dev = self._tensor(inv_mass)
        self._L_dev = self._tensor(self.L)

    def get_velocity(self, r):
        # M^-1 r for every row of a batch
        return r @ self._inv_mass_dev.T

    def momentum(self, z):
        return z @ self._L_dev.T


def get_particle_mass(inverse_mass, n_parameters: int, dtype=torch.float64,
                      device="cuda") -> ParticleMass:
    """Dispatch scalar / 1D / 2D inverse-mass specifications, with the maps'
    tensors in ``dtype`` on ``device``."""
    if np.isscalar(inverse_mass):
        return ScalarMass(float(inverse_mass), n_parameters, dtype, device)

    inverse_mass = np.asarray(inverse_mass)
    if inverse_mass.ndim == 0:
        return ScalarMass(float(inverse_mass), n_parameters, dtype, device)
    if inverse_mass.ndim == 1:
        return VectorMass(inverse_mass, n_parameters, dtype, device)
    return MatrixMass(inverse_mass, n_parameters, dtype, device)
