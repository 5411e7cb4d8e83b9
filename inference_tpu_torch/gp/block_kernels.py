"""Kernel adapters for the matrix-free GP tiers.

Port of ``inference_tpu.gp.block_kernels``. ``LargeScaleGP`` and
``LargeScaleGpLinearInverter`` never form the covariance matrix; they need
a kernel's cross-covariance rows, its prior point variance and any
white-noise variance it adds to the data diagonal, as maps over one flat
hyperparameter vector, on tensors (differentiable, for ``fit()``) and on
the host in float64. ``BlockKernel`` packages those:

- ``SqExpBlock``, the squared exponential, theta ``[ln A, ln l_1..l_D]``:
  its rows are kernel B2 (``ops.pairwise.SqexpCovariance``), and it is the
  one kernel of the df64 tier;
- ``RQBlock``, the rational quadratic, theta ``[ln A, ln alpha, ln
  l_1..l_D]``: plain torch arithmetic on the matmul-form distances, as in
  the JAX package (no TPU kernel there, none here);
- ``NoisyBlock``: either of them ``+ WhiteNoise()``, whose ``ln sigma_w``
  folds into the system diagonal, in the dense composite's slice order.

``as_block_kernel`` resolves a dense-path covariance (class or instance)
as the JAX function does, with its ``ValueError`` for the other kernels.
"""

import numpy as np
import torch

from ..ops.pairwise import SqexpCovariance, scaled_sq_distances
from .covariance import (
    CompositeCovariance,
    CovarianceFunction,
    RationalQuadratic,
    SquaredExponential,
    WhiteNoise,
)


def sqexp_rows_host64(q, x, hyperpars):
    """Float64 host squared-exponential rows ``K(q, x)`` by the sq-norm and
    matmul form (its cancellation is about 1e-14 in host float64): the JAX
    package's host kernel-row evaluation (``gp.large_scale``)."""
    h = np.asarray(hyperpars, np.float64)
    ls = np.exp(h[1:])
    qs = np.asarray(q, np.float64) / ls[None, :]
    xs = np.asarray(x, np.float64) / ls[None, :]
    d2 = (qs**2).sum(axis=1)[:, None] + (xs**2).sum(axis=1)[None, :] - 2.0 * (qs @ xs.T)
    np.maximum(d2, 0.0, out=d2)
    return float(np.exp(2.0 * h[0])) * np.exp(-0.5 * d2)


class BlockKernel:
    """Flat-theta kernel maps for the blocked matrix-free solvers:
    ``name``, ``supports_df64``, ``n_params(d)``, the tensor maps ``rows``,
    ``amp2`` and ``noise_variance`` (torch, differentiable in theta), and
    the host float64 maps ``rows_host64``, ``amp2_host`` and
    ``noise_variance_host``."""

    supports_df64 = False

    def n_params(self, n_dims: int) -> int:
        raise NotImplementedError

    def rows(self, xa, xb, theta):
        """Cross-covariance block K(xa, xb), white noise excluded."""
        raise NotImplementedError

    def amp2(self, theta):
        """Prior point variance K(x, x), white noise excluded (a tensor)."""
        raise NotImplementedError

    def noise_variance(self, theta):
        """White-noise variance added to the data diagonal (a tensor); 0
        without a noise component."""
        theta = torch.as_tensor(theta)
        return torch.zeros((), dtype=theta.dtype, device=theta.device)

    def rows_host64(self, q, x, theta) -> np.ndarray:
        """Host float64 cross-covariance rows (numpy in, numpy out)."""
        raise NotImplementedError

    def amp2_host(self, theta) -> float:
        """Prior point variance K(x, x), white noise excluded."""
        raise NotImplementedError

    def noise_variance_host(self, theta) -> float:
        """White-noise variance added to the data diagonal; 0 without a
        noise component."""
        return 0.0


class SqExpBlock(BlockKernel):
    name = "SquaredExponential"
    supports_df64 = True

    def n_params(self, n_dims):
        return n_dims + 1

    def rows(self, xa, xb, theta):
        """Kernel B2 at every block size (its plain version on the CPU):
        exact coordinate differences, where the JAX package took the
        matmul form below 2048 rows."""
        theta = torch.as_tensor(theta)
        return SqexpCovariance.apply(xa.contiguous(), xb.contiguous(), torch.exp(theta[0]),
                                     torch.exp(theta[1:]))

    def amp2(self, theta):
        return torch.exp(2.0 * torch.as_tensor(theta)[0])

    def rows_host64(self, q, x, theta):
        return sqexp_rows_host64(q, x, theta)

    def amp2_host(self, theta):
        return float(np.exp(2.0 * np.asarray(theta, np.float64)[0]))


class RQBlock(BlockKernel):
    name = "RationalQuadratic"

    def n_params(self, n_dims):
        return n_dims + 2

    def rows(self, xa, xb, theta):
        """``A^2 (1 + Z / alpha)^(-alpha)``, ``Z`` half the matmul-form
        scaled squared distance, clamped at 0 so that the fractional power
        stays real."""
        theta = torch.as_tensor(theta)
        a = torch.exp(theta[0])
        k = torch.exp(theta[1])
        Z = 0.5 * scaled_sq_distances(xa, xb, torch.exp(theta[2:]))
        return (a**2) * (1.0 + torch.clamp(Z, min=0.0) / k) ** (-k)

    def amp2(self, theta):
        return torch.exp(2.0 * torch.as_tensor(theta)[0])

    def rows_host64(self, q, x, theta):
        h = np.asarray(theta, np.float64)
        k = float(np.exp(h[1]))
        ls = np.exp(h[2:])
        qs = np.asarray(q, np.float64) / ls[None, :]
        xs = np.asarray(x, np.float64) / ls[None, :]
        d2 = (qs**2).sum(axis=1)[:, None] + (xs**2).sum(axis=1)[None, :] - 2.0 * (qs @ xs.T)
        np.maximum(d2, 0.0, out=d2)
        return float(np.exp(2.0 * h[0])) * (1.0 + 0.5 * d2 / k) ** (-k)

    def amp2_host(self, theta):
        return float(np.exp(2.0 * np.asarray(theta, np.float64)[0]))


class NoisyBlock(BlockKernel):
    """A smooth base kernel plus a WhiteNoise component. The flat theta
    follows the dense ``CompositeCovariance`` slice order: the base's
    parameters occupy their component's slice, the noise ``ln sigma_w`` its
    own, so hyperparameter vectors are interchangeable between the dense
    and matrix-free paths."""

    def __init__(self, base: BlockKernel, base_first: bool = True):
        self.base = base
        self.base_first = base_first
        self.name = f"{base.name}+WhiteNoise" if base_first else f"WhiteNoise+{base.name}"

    def n_params(self, n_dims):
        return self.base.n_params(n_dims) + 1

    def _split(self, theta):
        theta = torch.as_tensor(theta)
        return (theta[:-1], theta[-1]) if self.base_first else (theta[1:], theta[0])

    def _split_host(self, theta):
        h = np.asarray(theta, np.float64)
        return (h[:-1], float(h[-1])) if self.base_first else (h[1:], float(h[0]))

    def rows(self, xa, xb, theta):
        return self.base.rows(xa, xb, self._split(theta)[0])

    def amp2(self, theta):
        return self.base.amp2(self._split(theta)[0])

    def noise_variance(self, theta):
        return torch.exp(2.0 * self._split(theta)[1])

    def rows_host64(self, q, x, theta):
        return self.base.rows_host64(q, x, self._split_host(theta)[0])

    def amp2_host(self, theta):
        return self.base.amp2_host(self._split_host(theta)[0])

    def noise_variance_host(self, theta):
        return float(np.exp(2.0 * self._split_host(theta)[1]))


def _base_block(component):
    if isinstance(component, SquaredExponential):
        return SqExpBlock()
    if isinstance(component, RationalQuadratic):
        return RQBlock()
    return None


_SUPPORTED = (
    "Supported kernels: SquaredExponential, RationalQuadratic, and either + "
    "WhiteNoise; use the dense GpRegressor for other kernels."
)


def as_block_kernel(kernel, error_source: str) -> BlockKernel:
    """Resolve a dense-path kernel (class or instance) to its
    ``BlockKernel`` adapter, or raise the JAX package's ``ValueError``."""
    if isinstance(kernel, BlockKernel):
        return kernel
    if isinstance(kernel, type):
        if issubclass(kernel, BlockKernel):
            return kernel()
        if issubclass(kernel, CovarianceFunction):
            try:
                kernel = kernel()
            except TypeError:
                # a kernel that needs constructor arguments (ChangePoint) is
                # unsupported either way: report that
                raise ValueError(
                    f"[ {error_source} error ] Kernel {kernel.__name__!r} is not "
                    f"supported by the matrix-free solver tiers. {_SUPPORTED}"
                ) from None
    if isinstance(kernel, CompositeCovariance):
        comps = kernel.components
        smooth = [c for c in comps if _base_block(c) is not None]
        noise = [c for c in comps if isinstance(c, WhiteNoise)]
        if len(smooth) == 1 and len(noise) == 1 and len(comps) == 2:
            return NoisyBlock(_base_block(smooth[0]), base_first=comps[0] is smooth[0])
        names = " + ".join(type(c).__name__ for c in comps)
        raise ValueError(
            f"[ {error_source} error ] Unsupported kernel composition {names} for "
            f"the matrix-free solver tiers. Supported: SquaredExponential, "
            f"RationalQuadratic, and either of those + WhiteNoise. Other kernels "
            f"remain available on the dense GpRegressor path."
        )
    blk = _base_block(kernel) if isinstance(kernel, CovarianceFunction) else None
    if blk is not None:
        return blk
    raise ValueError(
        f"[ {error_source} error ] Kernel {type(kernel).__name__!r} is not "
        f"supported by the matrix-free solver tiers (its blocked row evaluation "
        f"is not implemented). {_SUPPORTED}"
    )
