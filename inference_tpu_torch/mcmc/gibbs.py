"""Metropolis-Hastings and Gibbs samplers: one chain.

Port of ``inference_tpu.mcmc.gibbs`` (``MetropolisChain``, ``GibbsChain``),
with the same constructor arguments plus ``device=`` (default the card;
pass ``"cpu"`` for the CPU). A step is the port's batched transition
(``mcmc/_kernels/metropolis.py``) run with one chain and ``retry=True``
(repeat until accept), as in the JAX package. The posterior is a torch
callable over ``(P,)`` tensors, or a numpy posterior evaluated on the host
with the chain's state on its device (``utils.wrap``).

History chunks and the per-step width traces stay on the device until a
host view is requested or ``utils.history.DEVICE_HISTORY_LIMIT`` is passed;
the widths' change points (``sigma_values`` / ``sigma_checks``) are then
rebuilt on the host from the traces, at step granularity as in the JAX
package. ``save`` and ``load`` use the reference's ``param_{i}...`` key
layout, so a checkpoint of the JAX package's chains loads here and the other
way round. Importing this module does not import matplotlib:
``plot_diagnostics`` imports it when it draws.
"""

import copy
from warnings import warn

import numpy as np
import torch
from torch import nn

from ..utils import ChainProgressPrinter, default_float, make_generator, resolve_device
from ..utils.history import DEVICE_HISTORY_LIMIT
from ._kernels.common import AdaptiveScale
from ._kernels.metropolis import (
    GIBBS_TARGET,
    MAX_TRIES,
    MH_TARGET,
    WIDTH_GROWTH,
    WIDTH_POWER,
    MetropolisState,
    ProposalModes,
    init_metropolis_state,
    make_gibbs_step,
    make_metropolis_step,
    run_steps,
)
from .base import MarkovChain


class MetropolisChain(MarkovChain):
    """
    Metropolis-Hastings sampling with an adaptive multivariate-normal
    proposal distribution.

    :param posterior: \
        A callable which takes the vector of model parameters as a ``(P,)``
        tensor and returns the posterior log-probability, written with torch
        operations (an ``nn.Module`` is copied onto ``device``), or a numpy
        callable, evaluated on the host.

    :param start: \
        Parameter vector at which the chain starts.

    :param widths: \
        Initial proposal-distribution standard deviations per parameter.
        Defaults to 5% of the starting values (or 1 where a start value
        is zero).

    :param temperature: \
        Chain temperature (used by parallel tempering).

    :param display_progress: \
        Whether to print progress/ETA messages during sampling.

    :param seed: \
        Optional integer seed of the chain's ``torch.Generator``.

    :param device: \
        The device the chain runs on (default the card; raises when there
        is none, pass ``"cpu"`` for the CPU).
    """

    target_rate = MH_TARGET

    def __init__(
        self,
        posterior: callable,
        start,
        widths=None,
        temperature: float = 1.0,
        display_progress: bool = True,
        seed=None,
        device="cuda",
    ):
        self.device = resolve_device(device, self.__class__.__name__)
        self.inv_temp = 1.0 / temperature
        self.temperature = temperature
        self._generator = make_generator(seed, self.device)
        self._step = None
        self._state = None
        self.chain_length = 1
        self.max_tries = MAX_TRIES
        self._pending_sigmas = []
        self._device_history_bytes = 0

        if posterior is not None:
            self.posterior = self._on_device(posterior)
            start = np.asarray(start, dtype=float).flatten()
            dtype = default_float()
            start_dev = torch.as_tensor(start, dtype=dtype, device=self.device)
            self._logp = self._validate_posterior(posterior=self.posterior, start=start_dev)
            if widths is None:
                widths = np.array([abs(v) * 0.05 if v != 0 else 1.0 for v in start])
            else:
                # scalars broadcast to all parameters
                widths = np.broadcast_to(
                    np.asarray(widths, dtype=float).flatten(), start.shape
                ).copy()

            self.n_parameters = start.size
            self._init_modes()
            with torch.no_grad():
                p0 = float(self._logp(start_dev)) * self.inv_temp
            if not np.isfinite(p0):
                raise ValueError(
                    f"[ {self.__class__.__name__} error ] The posterior "
                    f"log-probability is non-finite at the given start point."
                )
            self._state = init_metropolis_state(
                start_dev[None],
                torch.tensor([p0], dtype=dtype, device=self.device),
                torch.as_tensor(widths, dtype=dtype, device=self.device)[None],
                inv_temp=self.inv_temp,
            )
            self._theta_chunks = [start.reshape(1, -1).copy()]  # not the state's memory
            self._prob_chunks = [np.array([p0])]
            self._last_widths = widths.copy()
            self.sigma_values = [[w] for w in widths]
            self.sigma_checks = [[0.0] for _ in widths]
        else:
            self.posterior = None
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
    # proposal modes
    # ------------------------------------------------------------------ #
    def _init_modes(self):
        self._non_negative = np.zeros(self.n_parameters, bool)
        self._bounded = np.zeros(self.n_parameters, bool)
        self._lower = np.zeros(self.n_parameters)
        self._upper = np.ones(self.n_parameters)

    def _device_modes(self) -> ProposalModes:
        dtype = default_float()
        as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=self.device)
        return ProposalModes(
            non_negative=as_t(self._non_negative, torch.bool),
            bounded=as_t(self._bounded, torch.bool),
            lower=as_t(self._lower, dtype),
            upper=as_t(self._upper, dtype),
        )

    def set_non_negative(self, parameter: int, flag=True):
        """Constrain a particular parameter to non-negative values."""
        if not isinstance(flag, bool):
            warn("non_negative must have a boolean value")
            return
        self._non_negative[parameter] = flag
        self._step = None

    def set_boundaries(self, parameter: int, boundaries, remove=False):
        """Constrain a particular parameter to reflecting boundaries."""
        if remove:
            self._bounded[parameter] = False
            self._lower[parameter] = 0.0
            self._upper[parameter] = 1.0
        else:
            lower, upper = boundaries
            if lower < upper:
                self._bounded[parameter] = True
                self._lower[parameter] = lower
                self._upper[parameter] = upper
            else:
                warn("Upper limit must be greater than lower limit")
                return
        self._step = None

    # ------------------------------------------------------------------ #
    # the transition
    # ------------------------------------------------------------------ #
    def _build_step(self):
        return make_metropolis_step(self._logp.batched, self._device_modes())

    def _get_step(self):
        if self._step is None:
            self._step = self._build_step()
        return self._step

    @torch.no_grad()
    def _run_chunk(self, n: int):
        if self.posterior is None or self._logp is None:
            raise ValueError(
                f"[ {self.__class__.__name__} error ] Cannot advance a chain "
                f"loaded without a 'posterior' callable."
            )
        state, outs = run_steps(self._get_step(), self._state, n, True, self._generator)
        self._state = state
        self._absorb_outputs(outs)

    def _absorb_outputs(self, outs):
        """Append a chunk of outputs (``(n, 1, ...)`` tensors) to the
        history. Chunks stay on the device until a host view is requested or
        the device-history budget is passed."""
        start_step = self.chain_length
        self._theta_chunks.append(outs.theta[:, 0])
        self._prob_chunks.append(outs.logp[:, 0])
        self.chain_length += int(outs.logp.shape[0])
        self._pending_sigmas.append((outs.sigmas[:, 0], start_step))
        self._device_history_bytes += (
            outs.theta.nelement() * outs.theta.element_size()
            + outs.logp.nelement() * outs.logp.element_size()
        )
        if self._device_history_bytes > DEVICE_HISTORY_LIMIT:
            self._consolidated_theta()
            self._consolidated_probs()
            self._drain_width_trace()

    def _fetch_history(self):
        """Move any device-held history chunks to the host."""
        if self._device_history_bytes > 0:
            host = lambda c: c.cpu().numpy() if isinstance(c, torch.Tensor) else c
            self._theta_chunks = [host(c) for c in self._theta_chunks]
            self._prob_chunks = [host(c) for c in self._prob_chunks]
            self._device_history_bytes = 0

    def _drain_width_trace(self):
        """Record the deferred per-step width traces in the host-side
        ``sigma_values`` / ``sigma_checks`` change-point logs."""
        if not self._pending_sigmas:
            return
        pending, self._pending_sigmas = self._pending_sigmas, []
        for sigmas, start_step in pending:
            self._record_width_trace(sigmas.cpu().numpy(), int(start_step))

    def _record_width_trace(self, sigmas: np.ndarray, start_step: int):
        """Absorb the per-step width trace, logging change points."""
        for i in range(self.n_parameters):
            prev = self._last_widths[i]
            col = sigmas[:, i]
            changed = np.nonzero(col != np.concatenate([[prev], col[:-1]]))[0]
            for j in changed:
                self.sigma_values[i].append(float(col[j]))
                self.sigma_checks[i].append(float(start_step + j + 1))
            self._last_widths[i] = col[-1]

    # ------------------------------------------------------------------ #
    # host history views
    # ------------------------------------------------------------------ #
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

    @property
    def probs(self):
        return list(self._consolidated_probs())

    def get_last(self) -> np.ndarray:
        return self._consolidated_theta()[-1].astype(np.float64)

    def replace_last(self, theta):
        theta = np.asarray(theta, dtype=float)
        self._consolidated_theta()[-1, :] = theta
        self._state = self._state._replace(
            theta=torch.as_tensor(theta, dtype=self._state.theta.dtype,
                                  device=self.device).reshape(1, -1)
        )

    def replace_last_probability(self, logp: float):
        self._consolidated_probs()[-1] = logp
        self._state = self._state._replace(
            logp=torch.full((1,), float(logp), dtype=self._state.logp.dtype, device=self.device)
        )

    def get_parameter(self, index: int, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return sample values for a chosen parameter with burn/thin slicing."""
        return self._consolidated_theta()[burn::thin, index].copy()

    def get_probabilities(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the log-probability for each step with burn/thin slicing."""
        return self._consolidated_probs()[burn::thin].copy()

    def get_sample(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the sample as an (n_samples, n_parameters) array."""
        return self._consolidated_theta()[burn::thin].copy()

    def mode(self) -> np.ndarray:
        """Return the sample with the highest posterior probability."""
        probs = self._consolidated_probs()
        return self._consolidated_theta()[probs.argmax()]

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #
    def estimate_burn_in(self) -> int:
        """
        Burn-in estimate: the later of the first step in the top 1% of
        log-probabilities and the proposal-width stabilisation point
        (reference: gibbs.py:577-592).
        """
        self._drain_width_trace()
        probs = self._consolidated_probs()
        prob_estimate = np.argmax(probs > np.percentile(probs, 99))
        width_estimates = []
        for i in range(self.n_parameters):
            vals = np.abs(
                (np.array(self.sigma_values[i])[::-1] / self._last_widths[i]) - 1.0
            )
            chks = np.array(self.sigma_checks[i])[::-1]
            width_estimates.append(chks[np.argmax(vals > 0.15)])
        return int(max(prob_estimate, float(np.mean(width_estimates))))

    def plot_diagnostics(self, show=True, filename=None):
        """
        Plot the log-probability history, proposal-width adjustment summary
        and per-parameter effective sample sizes
        (reference: gibbs.py:405-519).
        """
        import matplotlib.pyplot as plt

        from ..utils import effective_sample_size
        from ..utils.figures import (
            ess_panel,
            finish_figure,
            logprob_history_panel,
            percent_change_panel,
            summary_text_panel,
        )

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
        percent_change_panel(
            fig.add_subplot(222),
            self.sigma_values,
            self.sigma_checks,
            self.chain_length,
        )
        ess_panel(fig.add_subplot(223), param_ESS, histogram_above=10**9)
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
    # reference: gibbs.py:162-217,521-575)
    # ------------------------------------------------------------------ #
    def _param_items(self, i, avg, var, num, chk, tries, modes=True) -> dict:
        """The ``param_{i}...`` items of parameter i."""
        p = f"param_{i}"
        return {
            f"{p}samples": self._consolidated_theta()[:, i],
            f"{p}sigma": self._last_widths[i],
            f"{p}avg": avg[i],
            f"{p}var": var[i],
            f"{p}num": num[i],
            f"{p}sigma_values": self.sigma_values[i],
            f"{p}sigma_checks": self.sigma_checks[i],
            f"{p}try_count": tries[i],
            f"{p}last_update": 0,
            f"{p}target_rate": self.target_rate,
            f"{p}max_tries": self.max_tries,
            f"{p}chk_int": chk[i],
            f"{p}growth_factor": WIDTH_GROWTH,
            f"{p}adjust_rate": WIDTH_POWER,
            f"{p}_non_negative": self._non_negative[i] if modes else False,
            f"{p}bounded": self._bounded[i] if modes else False,
            f"{p}upper": self._upper[i] if modes else 0.0,
            f"{p}lower": self._lower[i] if modes else 0.0,
            f"{p}width": self._upper[i] - self._lower[i] if modes and self._bounded[i] else 0.0,
        }

    def _checkpoint_items(self, modes=True) -> dict:
        """The checkpoint's items, keyed as in the ``.npz`` file."""
        self._drain_width_trace()
        widths = self._state.widths
        host = lambda x: x[0].cpu().numpy()
        avg, var, num, chk = (host(x) for x in (widths.avg, widths.var, widths.num,
                                                 widths.chk_int))
        tries = host(self._state.try_count)
        items = {
            "chain_length": self.chain_length,
            "n_parameters": self.n_parameters,
            "probs": self._consolidated_probs(),
            "inv_temp": self.inv_temp,
            "display_progress": self.display_progress,
        }
        for i in range(self.n_parameters):
            items |= self._param_items(i, avg, var, num, chk, tries, modes)
        return items

    def save(self, filename: str):
        np.savez(filename, **self._checkpoint_items())

    @classmethod
    def load(cls, filename: str, posterior=None, seed=None, device="cuda"):
        """A chain from a checkpoint of either package, on ``device``. With a
        posterior it continues from the last stored step with the stored
        width adaptation."""
        return cls.from_items(np.load(filename), posterior, seed, device)

    @classmethod
    def from_items(cls, D, posterior=None, seed=None, device="cuda"):
        """A chain from checkpoint items (an ``np.load`` of either package's
        ``.npz``), on ``device``."""
        chain = cls(
            posterior=None,
            start=None,
            widths=None,
            display_progress=bool(D["display_progress"]),
            seed=seed,
            device=device,
        )
        chain.posterior = None if posterior is None else chain._on_device(posterior)
        chain.chain_length = int(D["chain_length"])
        chain.n_parameters = int(D["n_parameters"])
        chain.inv_temp = float(D["inv_temp"])
        chain.temperature = 1.0 / chain.inv_temp
        chain._prob_chunks = [np.asarray(D["probs"], dtype=float)]

        n = chain.n_parameters
        theta = np.stack(
            [np.asarray(D[f"param_{i}samples"], dtype=float) for i in range(n)],
            axis=1,
        )
        chain._theta_chunks = [theta]
        chain._init_modes()
        chain._last_widths = np.array([float(D[f"param_{i}sigma"]) for i in range(n)])
        chain.sigma_values = [list(D[f"param_{i}sigma_values"]) for i in range(n)]
        chain.sigma_checks = [list(D[f"param_{i}sigma_checks"]) for i in range(n)]
        for i in range(n):
            chain._non_negative[i] = bool(D[f"param_{i}_non_negative"])
            chain._bounded[i] = bool(D[f"param_{i}bounded"])
            if chain._bounded[i]:
                chain._lower[i] = float(D[f"param_{i}lower"])
                chain._upper[i] = float(D[f"param_{i}upper"])

        dtype = default_float()
        row = lambda key, dt=dtype, f=float: torch.tensor(
            [[f(D[f"param_{i}{key}"]) for i in range(n)]], dtype=dt, device=chain.device
        )
        as_int = lambda x: int(float(x))
        chain._state = MetropolisState(
            theta=torch.as_tensor(theta[-1:], dtype=dtype, device=chain.device),
            logp=torch.tensor([chain._prob_chunks[0][-1]], dtype=dtype, device=chain.device),
            widths=AdaptiveScale(
                value=torch.as_tensor(chain._last_widths[None], dtype=dtype,
                                      device=chain.device),
                avg=row("avg"),
                var=row("var"),
                num=row("num", torch.int32, as_int),
                chk_int=row("chk_int", torch.int32, as_int),
            ),
            try_count=row("try_count", torch.int32, as_int),
            inv_temp=torch.tensor([chain.inv_temp], dtype=dtype, device=chain.device),
        )
        if posterior is not None:
            start = torch.as_tensor(theta[-1], dtype=dtype, device=chain.device)
            chain._logp = chain._validate_posterior(chain.posterior, start)
        return chain


class GibbsChain(MetropolisChain):
    """
    Gibbs sampling: each step is a sweep of one-dimensional
    Metropolis-Hastings updates, one per parameter, with per-parameter
    proposal-width adaptation targeting a 50% acceptance rate (reference:
    gibbs.py:595-656).

    Constructor arguments are identical to ``MetropolisChain``.
    """

    target_rate = GIBBS_TARGET

    def _build_step(self):
        return make_gibbs_step(
            self._logp.batched,
            self._device_modes(),
            target_rate=self.target_rate,
        )
