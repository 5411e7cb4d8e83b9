"""Rectangular parameter bounds with infinite-reflection maps.

Port of ``inference_tpu.utils.bounds``. Validation happens on the host at
construction; the reflection maps are torch functions over positions of
any batch shape ``(..., P)``, used inside the bounded leapfrog integrator.
They compute in the dtype and on the device of the positions they are
given, with the bounds copied there once per (device, dtype).

``jnp.divmod`` floors, so the quotient here is ``torch.div(...,
rounding_mode="floor")`` and the remainder ``torch.remainder`` (not
``torch.fmod``): negative offsets and ``q % 2`` reflect as in the JAX
package.
"""

import numpy as np
import torch


class Bounds:
    """
    Rectangular bounds on parameter values.

    :param lower: lower bounds for each parameter as a 1D array.
    :param upper: upper bounds for each parameter as a 1D array.
    """

    def __init__(self, lower, upper, error_source: str = "Bounds"):
        lo = np.atleast_1d(np.asarray(lower, dtype=float).squeeze())
        up = np.atleast_1d(np.asarray(upper, dtype=float).squeeze())

        if lo.ndim > 1 or up.ndim > 1:
            raise ValueError(
                f"[ {error_source} error ] Lower and upper bounds must be "
                f"one-dimensional arrays, but instead have dimensions "
                f"{lo.ndim} and {up.ndim} respectively."
            )
        if lo.size != up.size:
            raise ValueError(
                f"[ {error_source} error ] Lower and upper bounds must be arrays "
                f"of equal size, but have sizes {lo.size} and {up.size}."
            )
        if (lo >= up).any():
            raise ValueError(
                f"[ {error_source} error ] All given upper bounds must be larger "
                f"than the corresponding lower bounds."
            )

        # host copies for validation and checkpoints
        self.lower = lo
        self.upper = up
        self.width = up - lo
        self.n_bounds = self.width.size
        self._copies = {}  # (device, dtype) -> (lower, upper, width) tensors

    def _on(self, theta):
        """The bounds as tensors on ``theta``'s device and in its dtype."""
        key = (theta.device, theta.dtype)
        if key not in self._copies:
            as_t = lambda x: torch.as_tensor(x, dtype=theta.dtype, device=theta.device)
            self._copies[key] = (as_t(self.lower), as_t(self.upper), as_t(self.width))
        return self._copies[key]

    def validate_start_point(self, start, error_source: str = "Bounds"):
        start = np.asarray(start)
        if self.n_bounds != start.size:
            raise ValueError(
                f"[ {error_source} error ] The number of parameters ({start.size}) "
                f"does not match the given number of bounds ({self.n_bounds})."
            )
        if not self.inside(start):
            raise ValueError(
                f"[ {error_source} error ] Starting location for the chain is "
                f"outside specified bounds."
            )

    def reflect(self, theta):
        """Map arbitrary positions into the bounds by infinite reflection."""
        lo, _, w = self._on(theta)
        return _reflect(theta, lo, w)[0]

    def reflect_momenta(self, theta):
        """
        Reflect positions into the bounds, also returning the +-1 sign flips
        to apply to the conjugate momenta (for the HMC bounded leapfrog).
        """
        lo, _, w = self._on(theta)
        return _reflect(theta, lo, w)

    def inside(self, theta) -> bool:
        theta = np.asarray(theta)
        return bool(((theta >= self.lower) & (theta <= self.upper)).all())

    def inside_device(self, theta):
        """``inside`` for tensors: a boolean tensor over the last axis, so a
        ``(K, P)`` batch gives one flag per chain."""
        lo, up, _ = self._on(theta)
        return ((theta >= lo) & (theta <= up)).all(dim=-1)


def _reflect(theta, lower, width):
    """Positions reflected into ``[lower, lower + width]`` and the +-1 flips
    of their momenta. ``jnp.divmod``'s floored quotient and the remainder
    with the sign of ``width``, then an odd quotient mirrors."""
    offset = theta - lower
    q = torch.div(offset, width, rounding_mode="floor")
    rem = torch.remainder(offset, width)
    n = torch.remainder(q, 2)
    reflection = n.mul(-2).add_(1)
    # lower + reflection * rem + n * width, whose products are exact (a
    # sign, or 0 or the width), in three launches instead of five
    return torch.addcmul(lower, reflection, rem).addcmul_(n, width), reflection


def reflect_to_bounds(theta, lower, upper):
    """
    Functional infinite-reflection map with per-parameter bound tensors
    (no ``Bounds`` object required).
    """
    return _reflect(theta, lower, upper - lower)[0]
