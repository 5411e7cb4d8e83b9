"""Kernel adapters for the matrix-free GP tier.

Port of ``inference_tpu.gp.block_kernels``. ``LargeScaleGP`` never forms
the covariance matrix; it needs a kernel's cross-covariance rows, its
prior point variance and any white-noise variance it adds to the data
diagonal, as maps over one flat hyperparameter vector. ``BlockKernel``
packages those; ``SqExpBlock`` is the squared exponential, theta ``[ln A,
ln l_1..l_D]``, the one kernel of the df64 tier.

``as_block_kernel`` resolves a dense-path covariance (class or instance).
``RationalQuadratic`` and the ``+ WhiteNoise`` compositions, which only the
JAX package's float32 and mixed solver tiers take (its df64 tier refuses
them too), raise ``NotImplementedError`` until those tiers are ported
(ROADMAP A11, next slice); other kernels raise the JAX package's
``ValueError``.
"""

import numpy as np
import torch

from ..ops.pairwise import SqexpCovariance
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
    ``name``, ``n_params(d)``, the cross-covariance ``rows`` on tensors,
    and the host float64 maps ``rows_host64``, ``amp2_host`` and
    ``noise_variance_host``. (The JAX package's tensor forms of the prior
    and noise variances serve its float32 tiers and ``fit()``, which are
    not ported yet; its ``supports_df64`` flag has no job while the squared
    exponential is the one adapter.)"""

    def n_params(self, n_dims: int) -> int:
        raise NotImplementedError

    def rows(self, xa, xb, theta):
        """Cross-covariance block K(xa, xb), white noise excluded."""
        raise NotImplementedError

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

    def n_params(self, n_dims):
        return n_dims + 1

    def rows(self, xa, xb, theta):
        """Kernel B2 at every block size (its plain version on the CPU):
        exact coordinate differences, where the JAX package took the
        matmul form below 2048 rows."""
        theta = torch.as_tensor(theta)
        return SqexpCovariance.apply(xa.contiguous(), xb.contiguous(), torch.exp(theta[0]),
                                     torch.exp(theta[1:]))

    def rows_host64(self, q, x, theta):
        return sqexp_rows_host64(q, x, theta)

    def amp2_host(self, theta):
        return float(np.exp(2.0 * np.asarray(theta, np.float64)[0]))


_SUPPORTED = (
    "Supported kernels: SquaredExponential (RationalQuadratic and the + "
    "WhiteNoise compositions come with the float32/mixed tiers); use the "
    "dense GpRegressor for other kernels."
)


def _not_ported(name, error_source):
    return NotImplementedError(
        f"[ {error_source} error ] the {name} block kernel serves the float32 "
        f"and mixed solver tiers, which are not ported yet (ROADMAP A11, next "
        f"slice); the df64 tier takes the SquaredExponential only."
    )


def as_block_kernel(kernel, error_source: str) -> BlockKernel:
    """Resolve a dense-path kernel (class or instance) to its
    ``BlockKernel`` adapter, or raise."""
    if isinstance(kernel, BlockKernel):
        return kernel
    if isinstance(kernel, type):
        if issubclass(kernel, BlockKernel):
            return kernel()
        if issubclass(kernel, CovarianceFunction):
            try:
                kernel = kernel()
            except TypeError:
                raise ValueError(
                    f"[ {error_source} error ] Kernel {kernel.__name__!r} is not "
                    f"supported by the matrix-free solver tiers. {_SUPPORTED}"
                ) from None
    if isinstance(kernel, CompositeCovariance):
        comps = kernel.components
        smooth = [c for c in comps if isinstance(c, (SquaredExponential, RationalQuadratic))]
        noise = [c for c in comps if isinstance(c, WhiteNoise)]
        if len(smooth) == 1 and len(noise) == 1 and len(comps) == 2:
            raise _not_ported(f"{type(smooth[0]).__name__} + WhiteNoise", error_source)
        names = " + ".join(type(c).__name__ for c in comps)
        raise ValueError(
            f"[ {error_source} error ] Unsupported kernel composition {names} "
            f"for the matrix-free solver tiers. {_SUPPORTED}"
        )
    if isinstance(kernel, SquaredExponential):
        return SqExpBlock()
    if isinstance(kernel, RationalQuadratic):
        raise _not_ported("RationalQuadratic", error_source)
    raise ValueError(
        f"[ {error_source} error ] Kernel {type(kernel).__name__!r} is not "
        f"supported by the matrix-free solver tiers (its blocked row "
        f"evaluation is not implemented). {_SUPPORTED}"
    )
