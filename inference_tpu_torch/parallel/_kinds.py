"""Per-kind sampler construction for the scale-out layer.

Port of ``inference_tpu.parallel._kinds`` for the "hmc" kind: the batched
``init`` and ``step`` of one sampler family, with the scalar, diagonal or
full inverse-mass maps. The other kinds raise and name the ROADMAP queue
item that ports them.
"""

import torch

from ..mcmc._kernels import hmc as hmc_kernel
from ..mcmc.hmc.mass import get_particle_mass

KINDS = ("hmc", "nuts", "gibbs", "metropolis", "pca", "ensemble")

# ROADMAP queue A item that ports each kind not yet in this package
_QUEUE = {
    "nuts": "A12",
    "gibbs": "A12",
    "metropolis": "A12",
    "pca": "A12",
    "ensemble": "A12",
}


def require_ported(kind: str):
    """Raise ``ValueError`` unless ``kind`` is ported to this package,
    naming the ROADMAP queue item of a kind that is not."""
    if kind in _QUEUE:
        raise ValueError(
            f"the {kind!r} kind is not ported to inference_tpu_torch yet "
            f"(ROADMAP queue {_QUEUE[kind]}); only 'hmc' is available"
        )
    if kind != "hmc":
        raise ValueError(f"unknown chain kind: {kind!r} (options: {KINDS})")


def build_mass_maps(n_parameters, dtype, device, inverse_mass=None):
    """
    Batched inverse-mass application ``r -> velocity`` and momentum map
    ``z -> r`` from standard normals ``z``, both over ``(K, P)``, for a
    scalar, vector (diagonal) or full-matrix inverse mass: the maps of
    ``mcmc.hmc.mass``. None is unit mass.
    """
    if inverse_mass is None:
        return (lambda r: r, lambda z: z)
    mass = get_particle_mass(inverse_mass, n_parameters, dtype, device)
    return mass.get_velocity, mass.momentum


def build_kind(
    kind: str,
    logp_fn,
    n_parameters: int,
    dtype,
    device,
    *,
    epsilon: float = 0.1,
    steps: int = 50,
    inverse_mass=None,
    bounds=None,
    retry: bool = False,
):
    """
    Build ``(init, step)`` for one sampler family:

    - ``init(theta0, logp0, inv_temp)`` initialises a batch of chains from
      ``(K, P)`` positions and ``(K,)`` log-probabilities;
    - ``step(state, generator)`` is the batched transition.

    ``logp_fn`` is the per-chain ``(P,) -> ()`` posterior; it is batched
    with ``torch.func.vmap`` and differentiated with ``torch.func.grad``.

    :param bounds: optional ``utils.Bounds``: reflecting boundaries of the
        bounded leapfrog.
    """
    require_ported(kind)
    mass_velocity, mass_sample = build_mass_maps(
        n_parameters, dtype, device, inverse_mass
    )
    step = hmc_kernel.make_hmc_step(
        torch.func.vmap(logp_fn),
        torch.func.vmap(torch.func.grad(logp_fn)),
        mass_velocity=mass_velocity,
        mass_sample=mass_sample,
        bounds_reflect=None if bounds is None else bounds.reflect_momenta,
        retry=retry,
    )

    def init(theta0, logp0, inv_temp=1.0):
        return hmc_kernel.init_hmc_state(
            theta0, logp0, epsilon, inv_temp=inv_temp, steps=steps
        )

    return init, step
