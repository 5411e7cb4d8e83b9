"""Hamiltonian Monte-Carlo sampler: one chain.

Port of ``inference_tpu.mcmc.hmc``, with the same constructor arguments
plus ``device=`` (default the card; pass ``"cpu"`` for the CPU). A
transition is the port's batched transition (``mcmc/_kernels/hmc.py``)
run with one chain, ``retry=True`` (repeat until accept) and at most
``max_attempts`` (200) proposals; a chain that exhausts them raises the
JAX package's error. A torch posterior over ``(P,)`` tensors is
differentiated by autograd; a posterior written with numpy runs on the host
(``utils.wrap``) and, without a ``grad``, takes the JAX package's
forward-difference gradient, h = 1e-6 max(|t|, 1) with P + 1 evaluations.
A user ``grad`` runs on its route too: a torch callable on the device, a
numpy one on the host.

History chunks stay on the device until a host view is requested or
``utils.history.DEVICE_HISTORY_LIMIT`` is passed; the per-step epsilon
trace is drained into the host ``EpsilonSelector`` lazily. Changing
``steps`` changes the state, not the step function. ``save`` and ``load``
use the reference's ``.npz`` key layout, so a checkpoint of the JAX
package's ``HamiltonianChain`` loads here and the other way round.
Importing this module does not import matplotlib: ``plot_diagnostics``
imports it when it draws.
"""

import copy

import numpy as np
import torch
from torch import nn

from ...utils import (
    Bounds,
    ChainProgressPrinter,
    default_float,
    make_generator,
    resolve_device,
)
from ...utils.history import DEVICE_HISTORY_LIMIT
from ...utils.wrap import host_call, runs_under_vmap
from ..base import MarkovChain
from .._kernels.common import AdaptiveScale, value_and_grad
from .._kernels.hmc import HmcState, init_hmc_state, make_hmc_step, run_steps
from .epsilon import EpsilonSelector
from .mass import MatrixMass, ParticleMass, ScalarMass, VectorMass, get_particle_mass

__all__ = [
    "HamiltonianChain",
    "EpsilonSelector",
    "ParticleMass",
    "ScalarMass",
    "VectorMass",
    "MatrixMass",
    "get_particle_mass",
]


def fd_gradient(batched_logp, t):
    """The JAX package's forward-difference gradient of a host posterior at
    ``t`` (``(P,)``): h = 1e-6 max(|t|, 1), g_i = (logp(t + h_i e_i) -
    logp(t)) / h_i, from one batch of the P + 1 positions (t, then t with
    h_i added to element i)."""
    h = 1e-6 * torch.clamp(t.abs(), min=1.0)
    p = batched_logp(torch.cat([t[None], t[None] + torch.diag(h)]))
    return (p[1:] - p[0]) / h


class HamiltonianChain(MarkovChain):
    """
    Hamiltonian Monte-Carlo sampling with automatic step-size adaptation.

    :param posterior: \
        A callable which takes the vector of model parameters as a ``(P,)``
        tensor and returns the posterior log-probability as a scalar
        tensor, written with torch operations (an ``nn.Module`` is copied
        onto ``device``), or a numpy callable, evaluated on the host.

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

    :param bounds: \
        A ``Bounds`` instance or ``(lower, upper)`` arrays; a reflecting
        leapfrog integrator is used when given.

    :param inverse_mass: \
        Scalar, vector (diagonal) or matrix inverse-mass.

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
        bounds=None,
        inverse_mass=None,
        display_progress=True,
        seed=None,
        device="cuda",
    ):
        self.device = resolve_device(device, "HamiltonianChain")
        self.posterior = self._on_device(posterior)
        self.user_grad = grad
        self.temperature = temperature
        self.inv_temp = 1.0 / temperature
        self.steps = 50
        self.max_attempts = 200
        self.ES = EpsilonSelector(epsilon)
        self._generator = make_generator(seed, self.device)
        self._state = None
        self._step = None
        self._step_config = None
        self.chain_length = 1
        self._pending_eps = []
        self._device_history_bytes = 0

        if bounds is None or isinstance(bounds, Bounds):
            self.bounds = bounds
        else:
            self.bounds = Bounds(
                lower=bounds[0], upper=bounds[1], error_source="HamiltonianChain"
            )

        if start is not None:
            start = np.array(start, dtype=float)  # the caller's array is not aliased
            if start.ndim != 1:
                raise ValueError(
                    "[ HamiltonianChain error ] 'start' must be a 1D array of "
                    f"parameter values, got shape {start.shape}."
                )
            dtype = default_float()
            start_dev = torch.as_tensor(start, dtype=dtype, device=self.device)
            self._logp = self._validate_posterior(posterior=self.posterior, start=start_dev)
            self.n_parameters = start.size
            self.mass = get_particle_mass(
                inverse_mass=inverse_mass if inverse_mass is not None else 1.0,
                n_parameters=self.n_parameters, dtype=dtype, device=self.device,
            )
            if self.bounds is not None:
                self.bounds.validate_start_point(start, error_source="HamiltonianChain")

            with torch.no_grad():
                p0 = float(self._logp(start_dev)) * self.inv_temp
            self._state = init_hmc_state(
                start_dev[None], torch.tensor([p0], dtype=dtype), epsilon,
                inv_temp=self.inv_temp, steps=self.steps,
            )
            # history: host or device chunks, concatenated lazily
            self._theta_chunks = [start.reshape(1, -1).copy()]  # not the state's memory
            self._prob_chunks = [np.array([p0])]
            self._leapfrog_chunks = [np.array([0], dtype=int)]
        else:
            self._logp = None

        self.display_progress = display_progress
        self.ProgressPrinter = ChainProgressPrinter(
            display=self.display_progress, leading_msg="advancing chain:"
        )

    def _on_device(self, posterior):
        """An ``nn.Module`` posterior copied onto the chain's device and
        dtype; any other callable as given."""
        if isinstance(posterior, nn.Module):
            return copy.deepcopy(posterior).to(device=self.device, dtype=default_float())
        return posterior

    # ------------------------------------------------------------------ #
    # the transition
    # ------------------------------------------------------------------ #
    def _gradient_fn(self, start):
        """The gradient of one chain, ``(P,) -> (P,)``: the user's on its
        route (``torch.func.vmap`` of it over two rows of ``start`` gives
        ``(2, P)``: on the device; else on the host), the batched kernels'
        route on a batch of one for a torch posterior
        (``_kernels.common.value_and_grad``), or forward differences of a
        host posterior."""
        P = start.numel()
        if self.user_grad is not None:
            grad = self.user_grad
            if runs_under_vmap(lambda t: torch.as_tensor(grad(t)).reshape(P), start, (P,)):
                return lambda t: torch.as_tensor(grad(t)).reshape(t.shape).to(t.dtype)
            return lambda t: host_call(grad, t, (P,))
        logp = self._logp
        if logp.host:
            return lambda t: fd_gradient(logp.batched, t)
        one = value_and_grad(logp)
        return lambda t: one(t[None])[1][0]

    def _get_step(self):
        # 'steps' is deliberately absent: it lives in the state, so changing
        # it does not rebuild the step
        config = (self.max_attempts, id(self.mass), id(self.bounds))
        if self._step is None or self._step_config != config:
            start = self._state.theta[0]
            logp, grad = self._logp, self._gradient_fn(start)
            self._step = make_hmc_step(
                lambda t: logp(t[0]).reshape(1),
                lambda t: grad(t[0]).reshape(1, -1),
                max_attempts=self.max_attempts,
                mass_velocity=self.mass.get_velocity,
                mass_sample=self.mass.momentum,
                bounds_reflect=None if self.bounds is None else self.bounds.reflect_momenta,
                retry=True,
            )
            self._step_config = config
        return self._step

    @torch.no_grad()
    def _run_chunk(self, n: int):
        if self.posterior is None or self._logp is None:
            raise ValueError(
                "[ HamiltonianChain error ] Cannot advance a chain loaded without "
                "a 'posterior' callable."
            )
        step = self._get_step()
        # the (possibly user-modified) steps attribute goes into the state
        self._state = self._state._replace(
            steps=torch.full((1,), int(self.steps), dtype=torch.int32, device=self.device)
        )
        state, outs = run_steps(step, self._state, n, True, self._generator)
        if bool(state.failed.any()):
            raise ValueError(
                f"[ HamiltonianChain error ] Failed to take step within maximum "
                f"allowed attempts of {self.max_attempts}"
            )
        self._state = state
        self._absorb_outputs(outs)
        eps = self._state.eps
        self.ES.sync_counters(eps.avg, eps.var, eps.num, eps.chk_int)

    def _absorb_outputs(self, outs):
        """Append a chunk of outputs (``(n, 1, ...)`` tensors) to the
        history. Chunks stay on the device until a host view is requested or
        the device-history budget is passed."""
        start_step = self.chain_length
        self._theta_chunks.append(outs.theta[:, 0])
        self._prob_chunks.append(outs.logp[:, 0])
        self._leapfrog_chunks.append(outs.leapfrog_steps[:, 0])
        self.chain_length += int(outs.logp.shape[0])
        self._pending_eps.append((outs.epsilon[:, 0], start_step))
        self._device_history_bytes += (
            outs.theta.nelement() * outs.theta.element_size()
            + outs.logp.nelement() * outs.logp.element_size()
        )
        if self._device_history_bytes > DEVICE_HISTORY_LIMIT:
            self._consolidated_theta()
            self._consolidated_probs()
            self._drain_epsilon_trace()

    def _fetch_history(self):
        """Move any device-held history chunks to the host."""
        if self._device_history_bytes > 0:
            host = lambda c: c.cpu().numpy() if isinstance(c, torch.Tensor) else c
            self._theta_chunks = [host(c) for c in self._theta_chunks]
            self._prob_chunks = [host(c) for c in self._prob_chunks]
            self._leapfrog_chunks = [host(c) for c in self._leapfrog_chunks]
            self._device_history_bytes = 0

    def _drain_epsilon_trace(self):
        """Record the deferred per-step epsilon traces in the host-side
        ``EpsilonSelector`` change-point log."""
        if not self._pending_eps:
            return
        pending, self._pending_eps = self._pending_eps, []
        for eps, start_step in pending:
            self.ES.record_trace(eps.cpu().numpy(), int(start_step))

    # ------------------------------------------------------------------ #
    # host history views
    # ------------------------------------------------------------------ #
    @property
    def theta(self):
        """Chain positions as a list of parameter vectors."""
        return [v for v in self._consolidated_theta()]

    @property
    def probs(self):
        """Tempered log-probabilities for each chain step."""
        return list(self._consolidated_probs())

    @property
    def leapfrog_steps(self):
        self._fetch_history()
        return list(np.concatenate(self._leapfrog_chunks))

    def _consolidated_theta(self) -> np.ndarray:
        self._fetch_history()
        if len(self._theta_chunks) > 1:
            self._theta_chunks = [
                np.concatenate(self._theta_chunks, axis=0).astype(float, copy=False)
            ]
        return self._theta_chunks[0]

    def _consolidated_probs(self) -> np.ndarray:
        self._fetch_history()
        if len(self._prob_chunks) > 1:
            self._prob_chunks = [np.concatenate(self._prob_chunks).astype(float, copy=False)]
        return self._prob_chunks[0]

    def get_last(self) -> np.ndarray:
        return self._consolidated_theta()[-1]

    def replace_last(self, theta):
        theta = np.asarray(theta, dtype=float)
        arr = self._consolidated_theta()
        arr[-1, :] = theta
        self._state = self._state._replace(
            theta=torch.as_tensor(theta, dtype=self._state.theta.dtype,
                                  device=self.device).reshape(1, -1)
        )

    def replace_last_probability(self, logp: float):
        arr = self._consolidated_probs()
        arr[-1] = logp
        self._state = self._state._replace(
            logp=torch.full((1,), float(logp), dtype=self._state.logp.dtype, device=self.device)
        )

    def get_parameter(self, index: int, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return sample values for a chosen parameter with burn/thin slicing."""
        return self._consolidated_theta()[burn::thin, index].squeeze()

    def get_probabilities(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the log-probability for each step with burn/thin slicing."""
        return self._consolidated_probs()[burn::thin].copy()

    def get_sample(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the sample as an (n_samples, n_parameters) array."""
        return self._consolidated_theta()[burn::thin].copy()

    def mode(self) -> np.ndarray:
        """Return the sample with the highest posterior probability."""
        probs = self._consolidated_probs()
        return self._consolidated_theta()[probs.argmax()].squeeze()

    # ------------------------------------------------------------------ #
    # adaptation utilities
    # ------------------------------------------------------------------ #
    def estimate_mass(self, burn=1, thin=1, diagonal=True):
        """Re-estimate the inverse mass from the chain variance/covariance."""
        sample = self._consolidated_theta()[burn::thin]
        if diagonal:
            inverse_mass = np.var(sample, axis=0)
        else:
            inverse_mass = np.cov(sample.T)
        self.mass = get_particle_mass(
            inverse_mass=inverse_mass, n_parameters=self.n_parameters,
            dtype=default_float(), device=self.device,
        )

    def estimate_burn_in(self) -> int:
        """
        Estimate burn-in as the later of (a) the first step in the top 1% of
        log-probabilities and (b) the step-size stabilisation point, capped
        at 90% of the chain (reference: hmc/__init__.py:399-408).
        """
        self._drain_epsilon_trace()
        probs = self._consolidated_probs()
        prob_estimate = np.argmax(probs > np.percentile(probs, 99))
        epsl = np.abs(
            (np.array(self.ES.epsilon_values)[::-1] / self.ES.epsilon) - 1.0
        )
        chks = np.array(self.ES.epsilon_checks)[::-1]
        epsl_estimate = chks[np.argmax(epsl > 0.15)]
        return int(min(max(prob_estimate, epsl_estimate), 0.9 * self.chain_length))

    def plot_diagnostics(self, show=True, filename=None, burn=None):
        """
        Plot the log-probability history, the step-size adjustment summary,
        and per-parameter effective sample sizes
        (reference: hmc/__init__.py:245-359).
        """
        import matplotlib.pyplot as plt

        from ...utils import effective_sample_size
        from ...utils.figures import (
            ess_panel,
            finish_figure,
            logprob_history_panel,
            summary_text_panel,
        )

        self._drain_epsilon_trace()
        if burn is None:
            burn = self.estimate_burn_in()
        param_ESS = [
            effective_sample_size(np.atleast_1d(self.get_parameter(i, burn=burn)))
            for i in range(self.n_parameters)
        ]
        probs = self._consolidated_probs()

        fig = plt.figure(figsize=(12, 9))
        logprob_history_panel(
            fig.add_subplot(221), probs, burn,
            half_floor_from=self.chain_length // 2,
        )

        # the one HMC-specific panel: leapfrog step-size adaptation
        ax2 = fig.add_subplot(222)
        ax2.plot(
            np.array(self.ES.epsilon_checks) * 1e-3, self.ES.epsilon_values, ".-"
        )
        ax2.set_xlabel("chain step number ($10^3$)", fontsize=12)
        ax2.set_ylabel("Leapfrog step-size", fontsize=12)
        ax2.set_title("Simulation time-step adjustment summary")
        ax2.set_yscale("log")
        ax2.grid()

        ess_panel(fig.add_subplot(223), param_ESS, histogram_above=50)
        summary_text_panel(
            fig.add_subplot(224),
            [
                ("Estimated burn-in:", f"{burn:.5G}"),
                ("Average ESS:", f"{int(np.mean(param_ESS)):.5G}"),
                ("Lowest ESS:", f"{int(np.min(param_ESS)):.5G}"),
            ],
        )
        finish_figure(fig, plt, show, filename)

    # ------------------------------------------------------------------ #
    # checkpointing (.npz key layout of the reference and the JAX package,
    # reference: hmc/__init__.py:410-469)
    # ------------------------------------------------------------------ #
    def _checkpoint_items(self) -> dict:
        """The checkpoint's items, keyed as in the ``.npz`` file."""
        self._drain_epsilon_trace()
        self._fetch_history()
        items = {
            "inv_mass": self.mass.inv_mass,
            "inv_temp": self.inv_temp,
            "theta": self._consolidated_theta(),
            "probs": self._consolidated_probs(),
            "leapfrog_steps": np.concatenate(self._leapfrog_chunks),
            "n_parameters": self.n_parameters,
            "chain_length": self.chain_length,
            "steps": self.steps,
            "display_progress": self.display_progress,
        }
        if self.bounds is not None:
            items["lower_bounds"] = self.bounds.lower
            items["upper_bounds"] = self.bounds.upper
        items.update(self.ES.get_items())
        return items

    def save(self, filename, compressed=False):
        items = self._checkpoint_items()
        if compressed:
            np.savez_compressed(filename, **items)
        else:
            np.savez(filename, **items)

    @classmethod
    def load(cls, filename: str, posterior=None, grad=None, seed=None, device="cuda"):
        return cls.from_items(np.load(filename), posterior, grad, seed, device)

    @classmethod
    def from_items(cls, D, posterior=None, grad=None, seed=None, device="cuda"):
        """A chain from checkpoint items (an ``np.load`` of either package's
        ``.npz``), on ``device``. With a posterior it
        continues from the last stored step with the stored step-size
        adaptation state."""
        if all(k in D for k in ["lower_bounds", "upper_bounds"]):
            bounds = Bounds(
                lower=D["lower_bounds"],
                upper=D["upper_bounds"],
                error_source="HamiltonianChain",
            )
        else:
            bounds = None
        chain, head = cls._restored(D, posterior, grad, seed, device)
        chain.steps = int(D["steps"])
        chain.max_attempts = 200
        chain.bounds = bounds
        if head is not None:
            start, logp, eps = head
            like = lambda x, dt: torch.tensor([x], dtype=dt, device=chain.device)
            chain._state = HmcState(
                theta=start, logp=logp, eps=eps,
                failed=torch.zeros(1, dtype=torch.bool, device=chain.device),
                inv_temp=like(chain.inv_temp, start.dtype),
                steps=like(chain.steps, torch.int32),
            )
        return chain

    @classmethod
    def _restored(cls, D, posterior, grad, seed, device):
        """A chain of ``cls`` on ``device`` holding the checkpoint items
        every chain of this family stores (history, mass, step-size
        adaptation, display), and the state's head: with a posterior, its
        one-row start, log-probability and adaptation state as tensors
        (the posterior validated at the start), else None and no state."""
        device = resolve_device(device, cls.__name__)
        theta = np.asarray(D["theta"], dtype=float)
        chain = cls.__new__(cls)
        chain.device = device
        chain.posterior = None if posterior is None else chain._on_device(posterior)
        chain.user_grad = grad
        chain.inv_temp = float(D["inv_temp"])
        chain.temperature = 1.0 / chain.inv_temp
        chain.n_parameters = int(D["n_parameters"])
        chain.chain_length = int(D["chain_length"])
        dtype = default_float()
        inv_mass = np.asarray(D["inv_mass"])
        chain.mass = get_particle_mass(
            inverse_mass=inv_mass.squeeze() if inv_mass.ndim > 0 else float(inv_mass),
            n_parameters=chain.n_parameters, dtype=dtype, device=chain.device,
        )
        chain._theta_chunks = [theta]
        chain._prob_chunks = [np.asarray(D["probs"], dtype=float)]
        chain._pending_eps = []
        chain._device_history_bytes = 0
        chain._leapfrog_chunks = [np.asarray(D["leapfrog_steps"], dtype=int)]
        chain.ES = EpsilonSelector(1.0)
        chain.ES.load_items(D)
        chain._generator = make_generator(seed, chain.device)
        chain._step = None
        chain._step_config = None
        chain.display_progress = bool(D["display_progress"])
        chain.ProgressPrinter = ChainProgressPrinter(
            display=chain.display_progress, leading_msg="advancing chain:"
        )
        chain._state = None
        if posterior is None:
            chain._logp = None
            return chain, None
        as_dev = lambda x, dt=dtype: torch.tensor([x], dtype=dt, device=chain.device)
        start = torch.as_tensor(theta[-1], dtype=dtype, device=chain.device)
        chain._logp = chain._validate_posterior(chain.posterior, start)
        eps = AdaptiveScale(
            value=as_dev(chain.ES.epsilon),
            avg=as_dev(chain.ES.avg),
            var=as_dev(chain.ES.var),
            num=as_dev(int(chain.ES.num), torch.int32),
            chk_int=as_dev(chain.ES.chk_int, torch.int32),
        )
        return chain, (start[None], as_dev(chain._prob_chunks[0][-1]), eps)
