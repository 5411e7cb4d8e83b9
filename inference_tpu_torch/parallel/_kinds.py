"""Per-kind sampler construction for the scale-out layer.

Port of ``inference_tpu.parallel._kinds`` for every kind ("hmc", "nuts",
"gibbs", "metropolis", "pca" and "ensemble"): the batched ``init`` and
``step`` of one sampler family, with the scalar, diagonal or full
inverse-mass maps of HMC and NUTS, the per-parameter proposal modes of the
Metropolis family and the stretch moves of an ensemble per chain.
"""

import numpy as np
import torch

from ..mcmc._kernels import common
from ..mcmc._kernels import ensemble as ens_kernel
from ..mcmc._kernels import hmc as hmc_kernel
from ..mcmc._kernels import metropolis as met_kernel
from ..mcmc._kernels import nuts as nuts_kernel
from ..mcmc.hmc.mass import get_particle_mass
from ..utils.wrap import DeviceLogp

KINDS = ("hmc", "nuts", "gibbs", "metropolis", "pca", "ensemble")


def check_kind(kind: str):
    """Raise ``ValueError`` unless ``kind`` is one of ``KINDS``."""
    if kind not in KINDS:
        raise ValueError(f"unknown chain kind: {kind!r} (options: {KINDS})")


def build_proposal_modes(n_parameters, dtype, device, non_negative=None, boundaries=None):
    """
    Per-parameter proposal behaviour masks of the Metropolis family
    (reference: gibbs.py:88-122), as data on ``device``.

    :param non_negative: bool, or a (P,) boolean array: parameters whose
        proposals are folded to non-negative values with ``abs``.
    :param boundaries: optional ``(lower, upper)`` arrays giving reflecting
        boundaries applied to every parameter.
    """
    nn = np.zeros(n_parameters, bool)
    if non_negative is not None:
        nn[...] = np.asarray(non_negative, bool)
    bounded = np.zeros(n_parameters, bool)
    lower = np.zeros(n_parameters)
    upper = np.ones(n_parameters)
    if boundaries is not None:
        lo, up = boundaries
        lower[...] = np.asarray(lo, float)
        upper[...] = np.asarray(up, float)
        if (lower >= upper).any():
            raise ValueError(
                "[ boundaries error ] all upper bounds must exceed the "
                "corresponding lower bounds"
            )
        bounded[...] = True
    if (nn & bounded).any():
        raise ValueError(
            "a parameter cannot be both non-negative and reflecting-bounded"
        )
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    return met_kernel.ProposalModes(
        non_negative=as_t(nn, torch.bool),
        bounded=as_t(bounded, torch.bool),
        lower=as_t(lower, dtype),
        upper=as_t(upper, dtype),
    )


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
    widths=None,
    epsilon: float = 0.1,
    steps: int = 50,
    inverse_mass=None,
    non_negative=None,
    boundaries=None,
    bounds=None,
    alpha: float = 2.0,
    n_walkers: int = None,
    retry: bool = False,
    max_depth: int = 10,
):
    """
    Build ``(init, step)`` for one sampler family:

    - ``init(theta0, logp0, inv_temp)`` initialises a batch of chains from
      ``(K, P)`` positions and ``(K,)`` log-probabilities (for "ensemble",
      ``(K, W, P)`` and ``(K, W)``: each chain is a sub-ensemble of W
      walkers);
    - ``step(state, generator)`` is the batched transition.

    ``logp_fn`` is the posterior on its route (``utils.wrap.DeviceLogp``),
    or a per-chain torch callable ``(P,) -> ()``: its ``batched`` form
    evaluates the chains, and the hmc and nuts kinds differentiate its
    torch form by ``mcmc._kernels.common.value_and_grad``.

    :param widths: initial proposal widths (gibbs/metropolis/pca), a scalar
        or ``(P,)``; ``ChainArray`` writes per-chain widths into the state.
    :param non_negative: parameters folded non-negative (gibbs/metropolis).
    :param boundaries: ``(lower, upper)`` reflecting proposal boundaries
        (gibbs/metropolis).
    :param bounds: optional ``utils.Bounds``: reflecting boundaries of the
        bounded leapfrog (hmc) or of every proposal (pca, ensemble).
    :param alpha: stretch-move scale parameter (ensemble).
    :param n_walkers: walkers per chain (ensemble).
    :param max_depth: maximum trajectory doublings per transition (nuts).
    """
    check_kind(kind)
    if not isinstance(logp_fn, DeviceLogp):
        logp_fn = DeviceLogp(logp_fn, host=False)
    if kind == "ensemble":
        return _build_ensemble_kind(logp_fn, n_parameters, alpha=alpha, n_walkers=n_walkers,
                                    bounds=bounds, retry=retry)
    if kind in ("gibbs", "metropolis", "pca"):
        return _build_metropolis_kind(
            kind, logp_fn, n_parameters, dtype, device, widths=widths,
            non_negative=non_negative, boundaries=boundaries, bounds=bounds, retry=retry,
        )
    if logp_fn.host:
        raise ValueError(
            f"[ ChainArray error ] the batched {kind!r} kind needs a torch posterior: its "
            "gradient is autograd of the posterior, and a posterior evaluated on "
            "the host (numpy) has none. Write the posterior with torch operations, or "
            "use the gibbs, metropolis or pca kind, or HamiltonianChain or NutsChain "
            "(which take a finite-difference gradient of a host posterior)."
        )
    mass_velocity, mass_sample = build_mass_maps(
        n_parameters, dtype, device, inverse_mass
    )
    if kind == "nuts":
        return _build_nuts_kind(logp_fn, epsilon, max_depth, bounds, mass_velocity,
                                mass_sample)
    value_and_grad = common.value_and_grad(logp_fn)
    step = hmc_kernel.make_hmc_step(
        logp_fn.batched,
        lambda t: value_and_grad(t)[1],
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


def _build_nuts_kind(logp_fn, epsilon, max_depth, bounds, mass_velocity, mass_sample):
    """``(init, step)`` of the nuts kind; ``init`` computes the tempered
    gradients the state caches."""
    if bounds is not None:
        raise ValueError(
            "the nuts kind does not support reflecting bounds — "
            "reparameterise the posterior or use the hmc kind"
        )
    step = nuts_kernel.make_nuts_step(
        logp_fn, max_depth=max_depth, mass_velocity=mass_velocity, mass_sample=mass_sample,
    )

    def init(theta0, logp0, inv_temp=1.0):
        grad0 = inv_temp * common.value_and_grad(logp_fn)(theta0)[1]
        return nuts_kernel.init_nuts_state(theta0, logp0, epsilon, inv_temp=inv_temp,
                                           grad0=grad0)

    return init, step


def _build_metropolis_kind(kind, logp_fn, n_parameters, dtype, device, *, widths=None,
                           non_negative=None, boundaries=None, bounds=None, retry=False):
    """``(init, step)`` of the gibbs, metropolis and pca kinds."""
    if kind == "pca":
        step = met_kernel.make_pca_step(
            logp_fn.batched,
            bounds_reflect=None if bounds is None else bounds.reflect,
            retry=retry,
        )
    else:
        modes = build_proposal_modes(n_parameters, dtype, device, non_negative, boundaries)
        factory = met_kernel.make_gibbs_step if kind == "gibbs" else met_kernel.make_metropolis_step
        step = factory(logp_fn.batched, modes, retry=retry)
    w = widths if widths is not None else 1.0
    w_arr = torch.as_tensor(np.broadcast_to(np.asarray(w, float), (n_parameters,)).copy(),
                            dtype=dtype, device=device)

    def init(theta0, logp0, inv_temp=1.0):
        if kind == "pca":
            eye = torch.eye(n_parameters, dtype=dtype, device=device)
            return met_kernel.init_pca_state(theta0, logp0, w_arr, eye, inv_temp=inv_temp)
        return met_kernel.init_metropolis_state(theta0, logp0, w_arr, inv_temp=inv_temp)

    return init, step


def _build_ensemble_kind(logp_fn, n_parameters, *, alpha, n_walkers, bounds, retry):
    """``(init, step)`` of the ensemble kind."""
    if n_walkers is None:
        raise ValueError("the ensemble kind requires n_walkers")
    if n_walkers < 2 * (n_parameters + 1):
        raise ValueError(
            f"the ensemble kind needs n_walkers >= 2 * (n_parameters + 1) "
            f"= {2 * (n_parameters + 1)}, got {n_walkers}"
        )
    step = ens_kernel.make_ensemble_step(
        logp_fn.batched,
        n_walkers=n_walkers,
        alpha=alpha,
        bounds_reflect=None if bounds is None else bounds.reflect,
        retry=retry,
    )

    def init(walkers0, logps0, inv_temp=1.0):
        return ens_kernel.init_ensemble_state(walkers0, logps0, inv_temp=inv_temp)

    return init, step


def positions_of(state):
    """The swap-exchangeable position and log-probability tensors of a
    state."""
    if isinstance(state, ens_kernel.EnsembleState):
        return state.walkers, state.logps
    return state.theta, state.logp


def with_positions(state, pos, logp):
    """Replace the swap-exchangeable tensors of a state."""
    if isinstance(state, ens_kernel.EnsembleState):
        return state._replace(walkers=pos, logps=logp)
    return state._replace(theta=pos, logp=logp)
