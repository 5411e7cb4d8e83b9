"""No-U-Turn sampler: one chain.

Port of ``inference_tpu.mcmc.nuts``, with the same constructor arguments
plus ``device=`` (default the card; pass ``"cpu"`` for the CPU). Trajectories
double until the path turns back on itself (the No-U-Turn criterion), with
the step size adapted as in ``HamiltonianChain``, whose machinery the chain
shares: the lazy device history, the epsilon change-point log, the mass
handling and the gradient routes (autograd of a torch posterior, a user
``grad``, or forward differences of a host posterior). A transition is the
port's batched NUTS transition (``mcmc/_kernels/nuts.py``) run with one
chain; its state caches the tempered gradient at its position, which
``replace_last`` and the tempering swaps keep in step with the position.

``save`` and ``load`` use the JAX package's ``.npz`` keys (the
``HamiltonianChain`` items without ``steps``, with ``tree_depths``,
``divergent``, ``divergences`` and ``max_depth``), so a checkpoint of
either package loads in the other. ``plot_diagnostics`` raises until
ROADMAP queue A14(b) ports the plotting.
"""

import numpy as np
import torch

from ._kernels.nuts import NutsState, init_nuts_state, make_nuts_step, run_steps
from .hmc import HamiltonianChain

__all__ = ["NutsChain"]


class NutsChain(HamiltonianChain):
    """
    No-U-Turn sampling with automatic step-size adaptation.

    Accepts the same arguments as ``HamiltonianChain`` except ``bounds``
    (reflecting bounds break the U-turn criterion: reparameterise the
    posterior instead), with ``max_depth`` in place of the ``steps``
    attribute: the trajectory length of each transition is chosen
    automatically, up to ``2^max_depth - 1`` leapfrog steps.

    :param posterior: \
        A callable which takes the vector of model parameters as a ``(P,)``
        tensor and returns the posterior log-probability, written with torch
        operations (each leaf is one evaluation and its backward pass), or
        a numpy callable, evaluated on the host.

    :param start: \
        Parameter vector at which the chain starts.

    :param grad: \
        A callable returning the gradient of the log-posterior (torch or
        numpy). If omitted, the gradient is autograd of ``posterior``, or
        its forward differences for a numpy posterior.

    :param epsilon: \
        Initial guess for the leapfrog time-step.

    :param temperature: \
        Chain temperature (used by parallel tempering).

    :param inverse_mass: \
        Scalar, vector (diagonal) or matrix inverse-mass.

    :param max_depth: \
        Maximum number of trajectory doublings per transition.

    :param display_progress: \
        Whether to print progress/ETA messages during sampling.

    :param seed: \
        Optional integer seed of the chain's ``torch.Generator`` (fresh OS
        entropy when omitted).

    :param device: \
        The device the chain runs on (default the card; raises when there
        is none, pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        posterior: callable,
        start,
        grad: callable = None,
        epsilon: float = 0.1,
        temperature: float = 1.0,
        inverse_mass=None,
        max_depth: int = 10,
        display_progress=True,
        seed=None,
        device="cuda",
    ):
        self.max_depth = int(max_depth)
        super().__init__(
            posterior=posterior,
            start=start,
            grad=grad,
            epsilon=epsilon,
            temperature=temperature,
            bounds=None,
            inverse_mass=inverse_mass,
            display_progress=display_progress,
            seed=seed,
            device=device,
        )
        if start is not None:
            # swap the HMC state built by the parent for a NUTS state
            hs = self._state
            self._state = init_nuts_state(
                hs.theta, hs.logp, epsilon, inv_temp=self.inv_temp,
                grad0=self._tempered_state_grad(hs.theta),
            )
            self._depth_chunks = [np.array([0], dtype=int)]
            self._div_chunks = [np.array([False])]

    def _tempered_state_grad(self, theta):
        """The tempered log-posterior gradient at the one-row ``theta``
        ``(1, P)``, by the chain's gradient route: the integration start
        the kernel caches in its state."""
        with torch.no_grad():
            return self.inv_temp * self._gradient_fn(theta[0])(theta[0]).reshape(1, -1)

    def _refresh_state_grad(self):
        """Recompute the state's cached gradient after the position was
        rewritten from outside (host tempering swaps between rungs of
        different classes, where the partner carries no gradient)."""
        if self._state is not None:
            self._state = self._state._replace(grad=self._tempered_state_grad(self._state.theta))

    def replace_last(self, theta):
        # the kernel integrates from the cached gradient: a rewritten
        # position must refresh it, or the next trajectory's first
        # half-step uses the old position's gradient
        super().replace_last(theta)
        self._refresh_state_grad()

    # ------------------------------------------------------------------ #
    # the transition
    # ------------------------------------------------------------------ #
    def _get_step(self):
        config = (self.max_depth, id(self.mass))
        if self._step is None or self._step_config != config:
            logp = self._logp
            # a torch posterior with no user gradient takes the batched
            # kernels' route (_kernels.common.value_and_grad, as the cached
            # gradient does); a user gradient or a host posterior takes
            # HamiltonianChain's gradient route
            if self.user_grad is None and not logp.host:
                grad_fn = None
            else:
                grad_fn = self._gradient_fn(self._state.theta[0])
            self._step = make_nuts_step(
                logp,
                grad_fn,
                max_depth=self.max_depth,
                mass_velocity=self.mass.get_velocity,
                mass_sample=self.mass.momentum,
            )
            self._step_config = config
        return self._step

    @torch.no_grad()
    def _run_chunk(self, n: int):
        if self.posterior is None or self._logp is None:
            raise ValueError(
                "[ NutsChain error ] Cannot advance a chain loaded without "
                "a 'posterior' callable."
            )
        state, outs = run_steps(self._get_step(), self._state, n, True, self._generator)
        self._state = state
        self._absorb_outputs(outs)
        eps = state.eps
        self.ES.sync_counters(eps.avg, eps.var, eps.num, eps.chk_int)

    def _absorb_outputs(self, outs):
        self._depth_chunks.append(outs.tree_depth[:, 0])
        self._div_chunks.append(outs.divergent[:, 0])
        # the parent reads theta, logp, leapfrog_steps and epsilon, all on
        # NutsOutput, and manages the device-history budget
        super()._absorb_outputs(outs)

    def _fetch_history(self):
        if self._device_history_bytes > 0:
            host = lambda c: c.cpu().numpy() if isinstance(c, torch.Tensor) else c
            self._depth_chunks = [host(c) for c in self._depth_chunks]
            self._div_chunks = [host(c) for c in self._div_chunks]
        super()._fetch_history()

    # ------------------------------------------------------------------ #
    # NUTS history views
    # ------------------------------------------------------------------ #
    @property
    def tree_depths(self) -> np.ndarray:
        """Doublings performed at each chain step."""
        self._fetch_history()
        if len(self._depth_chunks) > 1:
            self._depth_chunks = [np.concatenate(self._depth_chunks)]
        return self._depth_chunks[0]

    @property
    def divergent_steps(self) -> np.ndarray:
        """Boolean flags marking transitions that hit a divergence."""
        self._fetch_history()
        if len(self._div_chunks) > 1:
            self._div_chunks = [np.concatenate(self._div_chunks)]
        return self._div_chunks[0]

    @property
    def n_divergences(self) -> int:
        """Total number of divergent transitions so far."""
        if self._state is None:
            return int(np.asarray(self.divergent_steps).sum())
        return int(self._state.divergences[0])

    # ------------------------------------------------------------------ #
    # checkpointing (the JAX package's NutsChain .npz keys)
    # ------------------------------------------------------------------ #
    def _checkpoint_items(self) -> dict:
        items = super()._checkpoint_items()
        del items["steps"]
        items.update(
            tree_depths=self.tree_depths,
            divergent=self.divergent_steps,
            divergences=self.n_divergences,
            max_depth=self.max_depth,
        )
        return items

    @classmethod
    def from_items(cls, D, posterior=None, grad=None, seed=None, device="cuda"):
        """A chain from checkpoint items (an ``np.load`` of either package's
        ``NutsChain`` ``.npz``), on ``device``. With a posterior it
        continues from the last stored step with the stored step-size
        adaptation state and divergence count."""
        chain, head = cls._restored(D, posterior, grad, seed, device)
        chain.max_depth = int(D["max_depth"])
        chain.steps = 50          # unused; kept for the shared diagnostics code
        chain.max_attempts = 200  # unused
        chain.bounds = None
        chain._depth_chunks = [np.asarray(D["tree_depths"], dtype=int)]
        chain._div_chunks = [np.asarray(D["divergent"], dtype=bool)]
        if head is not None:
            start, logp, eps = head
            chain._state = NutsState(
                theta=start, logp=logp, grad=chain._tempered_state_grad(start), eps=eps,
                divergences=torch.tensor([int(D["divergences"])], dtype=torch.int32,
                                         device=chain.device),
                inv_temp=torch.tensor([chain.inv_temp], dtype=start.dtype, device=chain.device),
            )
        return chain
