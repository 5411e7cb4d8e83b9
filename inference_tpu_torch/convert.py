"""Move HMC chain state and posteriors between the JAX package and this one.

The JAX package's batched ``HmcState`` flattens (``jax.tree.flatten``) to 11
leaves, in this order: theta ``(K, P)``, logp ``(K,)``, the five step-size
fields ``eps.value``/``avg``/``var``/``num``/``chk_int`` ``(K,)``, the
PRNG key ``(K, 2)`` uint32, failed ``(K,)`` bool, inv_temp ``(K,)`` and
steps ``(K,)`` int32. This module reads and writes that list as numpy
arrays. The key leaf is read and ignored: the two packages' random streams
differ by design.
"""

import numpy as np
import torch

from .mcmc._kernels.common import AdaptiveScale
from .mcmc._kernels.hmc import HmcState
from .ops.hmc_fused import GaussianForm

N_HMC_LEAVES = 11


def hmc_state_from_jax(leaves, device="cpu", dtype=None) -> HmcState:
    """The port's ``HmcState`` from the 11 leaves of a JAX ``HmcState``.
    Floating leaves take ``dtype`` (default: theta's own dtype)."""
    if len(leaves) != N_HMC_LEAVES:
        raise ValueError(
            f"an HmcState has {N_HMC_LEAVES} leaves, got {len(leaves)}"
        )
    theta, logp, ev, ea, evr, en, ec, _key, failed, inv_temp, steps = (
        np.asarray(x) for x in leaves
    )
    dtype = dtype or torch.as_tensor(theta).dtype
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return HmcState(
        theta=f(theta),
        logp=f(logp),
        eps=AdaptiveScale(f(ev), f(ea), f(evr), i(en), i(ec)),
        failed=torch.tensor(failed, dtype=torch.bool, device=device),
        inv_temp=f(inv_temp),
        steps=i(steps),
    )


def hmc_state_to_jax_leaves(state: HmcState, key) -> list:
    """The 11 leaves of a JAX ``HmcState`` as numpy arrays, with ``key`` (a
    ``(K, 2)`` uint32 array) as the key leaf."""
    host = lambda x: x.detach().cpu().numpy()
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (state.theta.shape[0], 2):
        raise ValueError(f"the key leaf must be (K, 2), got {key.shape}")
    return [
        host(state.theta),
        host(state.logp),
        *(host(x) for x in state.eps),
        key,
        host(state.failed),
        host(state.inv_temp),
        host(state.steps),
    ]


def gaussian_form_from_numpy(icov, mean=None) -> GaussianForm:
    """The posterior ``-1/2 (theta - mean)^T icov (theta - mean)`` as a
    ``GaussianForm`` in torch's default dtype."""
    return GaussianForm(
        torch.as_tensor(np.asarray(icov, dtype=float)),
        None if mean is None else torch.as_tensor(np.asarray(mean, dtype=float)),
    )
