"""Affine-invariant ensemble sampler.

Port of ``inference_tpu.mcmc.ensemble`` (``EnsembleSampler``), with the same
constructor arguments plus ``device=`` (default the card; pass ``"cpu"`` for
the CPU). An iteration is the port's batched red/black stretch move
(``mcmc/_kernels/ensemble.py``) over one ensemble. The posterior is a torch
callable over ``(P,)`` tensors, evaluated for all walkers at once, or a
numpy posterior evaluated on the host (``utils.wrap``).

``retry=True`` (the default, as in the JAX package and the reference)
repeats each walker's move until it accepts. That update does not leave the
posterior invariant: on a Gaussian its sample covariance comes out below
the true one (``tests/test_torch_ensemble.py`` holds it there).
``retry=False`` is the standard Goodman & Weare update, whose samples have
the posterior's covariance.

History chunks and the per-iteration proposal counts stay on the device
until a host view is requested or ``utils.history.DEVICE_HISTORY_LIMIT`` is
passed. ``save`` and ``load`` use the reference's ``.npz`` key layout, so a
checkpoint of the JAX package's sampler loads here and the other way round.
Importing this module does not import matplotlib: ``plot_diagnostics``
raises until ROADMAP queue A14(b) ports the plotting.
"""

from time import time
from warnings import warn

import numpy as np
import torch

from ..utils import (
    Bounds,
    ChainProgressPrinter,
    as_device_logp,
    default_float,
    make_generator,
    resolve_device,
)
from ..utils.history import DEVICE_HISTORY_LIMIT
from ._kernels.ensemble import init_ensemble_state, make_ensemble_step, run_steps
from .base import MarkovChain


def _host(x):
    """A numpy copy of a tensor (never a view of a CPU tensor's memory), or
    a host array as it is."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    return x.cpu().numpy() if x.device.type != "cpu" else x.numpy().copy()


class EnsembleSampler(MarkovChain):
    """
    Affine-invariant ensemble sampler (Goodman & Weare stretch moves).

    :param posterior: \
        A callable which takes the vector of model parameters as a ``(P,)``
        tensor and returns the posterior log-probability, written with torch
        operations, or a numpy callable, evaluated on the host.

    :param starting_positions: \
        Starting positions of each walker as a 2D array of shape
        ``(n_walkers, n_parameters)``.

    :param alpha: \
        Stretch-distance distribution parameter; must be greater than 1.

    :param bounds: \
        A ``Bounds`` instance or ``(lower, upper)`` arrays; proposals are
        reflected into the bounds when given.

    :param display_progress: \
        Whether to print progress/ETA messages during sampling.

    :param seed: \
        Optional integer seed of the sampler's ``torch.Generator``.

    :param retry: \
        Repeat-until-accept walker updates (the reference semantics) when
        True; standard single-proposal Goodman & Weare updates when False.

    :param device: \
        The device the walkers live on (default the card; raises when there
        is none, pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        posterior: callable,
        starting_positions,
        alpha: float = 2.0,
        bounds=None,
        display_progress=True,
        seed=None,
        retry: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device, "EnsembleSampler")
        self.posterior = posterior
        self._generator = make_generator(seed, self.device)
        self._step = None
        self._state = None
        self.max_attempts = 100
        self.retry = retry

        if not alpha > 1.0:
            raise ValueError(
                "[ EnsembleSampler error ] The given value of the 'alpha' "
                "parameter must be greater than 1."
            )
        self.alpha = alpha
        self.x_lwr = np.sqrt(2.0 / self.alpha)
        self.x_width = np.sqrt(2.0 * self.alpha) - self.x_lwr

        if bounds is None or isinstance(bounds, Bounds):
            self.bounds = bounds
        else:
            self.bounds = Bounds(lower=bounds[0], upper=bounds[1], error_source="EnsembleSampler")

        if starting_positions is not None:
            positions = self.__validate_starting_positions(starting_positions)
            self.n_walkers, self.n_parameters = positions.shape
            if self.n_walkers < 2 * (self.n_parameters + 1):
                warn(
                    f"[ EnsembleSampler ] {self.n_walkers} walkers for "
                    f"{self.n_parameters} parameters: the red/black "
                    f"half-ensemble update needs each half to span the "
                    f"space, so n_walkers >= 2 * (n_parameters + 1) = "
                    f"{2 * (self.n_parameters + 1)} is strongly "
                    f"recommended (the reference's sequential update only "
                    f"needed n_parameters + 1)."
                )
            if self.bounds is not None:
                for v in positions:
                    self.bounds.validate_start_point(v, error_source="EnsembleSampler")

            dev_positions = torch.tensor(positions, dtype=default_float(), device=self.device)
            self._logp = as_device_logp(posterior, dev_positions[0], "EnsembleSampler")
            with torch.no_grad():
                logps = self._logp.batched(dev_positions)
            self.walker_positions = positions
            self.walker_probs = _host(logps).astype(float)
            self._state = init_ensemble_state(dev_positions[None], logps[None])

            self.n_iterations = 0
            self.chain_length = 0
            self.total_proposals = [[] for _ in range(self.n_walkers)]
            self.failed_updates = []
        else:
            self._logp = None

        self._sample_chunks = []   # device or host (n, W, P) chunks
        self._prob_chunks = []     # device or host (n, W) chunks
        self._pending_stats = []   # deferred (attempts, failures) chunks
        self._device_history_bytes = 0
        self.display_progress = display_progress
        self.ProgressPrinter = ChainProgressPrinter(
            display=self.display_progress, leading_msg="EnsembleSampler:"
        )

    @staticmethod
    def __validate_starting_positions(positions):
        """Start validation of the reference (reference: ensemble.py:113-180)."""
        if not isinstance(positions, np.ndarray):
            raise ValueError(
                f"[ EnsembleSampler error ] 'starting_positions' should be a "
                f"numpy.ndarray, but instead has type: {type(positions)}"
            )
        theta = (
            positions.reshape([positions.size, 1]) if positions.ndim == 1 else positions
        ).astype(float)

        if theta.ndim != 2 or theta.shape[0] < (theta.shape[1] + 1):
            raise ValueError(
                f"[ EnsembleSampler error ] 'starting_positions' should be a "
                f"numpy.ndarray with shape (n_walkers, n_parameters), where "
                f"n_walkers >= n_parameters + 1. Instead, the given array has "
                f"shape {positions.shape}."
            )
        if not np.isfinite(theta).all():
            raise ValueError(
                "[ EnsembleSampler error ] The given 'starting_positions' array "
                "contains at least one value which is non-finite."
            )
        if theta.shape[1] == 1:
            if np.var(theta) == 0:
                raise ValueError(
                    "[ EnsembleSampler error ] The values given in "
                    "'starting_positions' have zero variance, and therefore the "
                    "walkers are unable to move."
                )
        else:
            covar = np.cov(theta.T)
            std_dev = np.sqrt(np.diag(covar))
            if (std_dev == 0).any():
                raise ValueError(
                    "[ EnsembleSampler error ] For one or more variables, the "
                    "values given in 'starting_positions' have zero variance, "
                    "and therefore the walkers are unable to move in those "
                    "variables."
                )
            correlation = covar / (std_dev[:, None] * std_dev[None, :])
            if (np.abs(np.triu(correlation, k=1)) > 0.999).any():
                raise ValueError(
                    "[ EnsembleSampler error ] The values given in "
                    "'starting_positions' are approximately co-linear for one "
                    "or more pair of variables. This will prevent the walkers "
                    "from moving properly in those variables."
                )
        return theta

    # ------------------------------------------------------------------ #
    # the transition
    # ------------------------------------------------------------------ #
    def _get_step(self):
        if self._step is None:
            self._step = make_ensemble_step(
                self._logp.batched,
                n_walkers=self.n_walkers,
                alpha=self.alpha,
                max_attempts=self.max_attempts,
                bounds_reflect=None if self.bounds is None else self.bounds.reflect,
                retry=self.retry,
            )
        return self._step

    @torch.no_grad()
    def _run_chunk(self, n: int):
        """Advance ``n`` iterations; the history stays on the device until a
        host view is requested or the device-history budget is passed."""
        if self._logp is None:
            raise ValueError(
                "[ EnsembleSampler error ] Cannot advance a sampler loaded without "
                "a 'posterior' callable."
            )
        state, outs = run_steps(self._get_step(), self._state, n, True, self._generator)
        self._state = state
        # the final walker set as device views, converted on first access
        self._walker_positions = state.walkers[0]
        self._walker_probs = state.logps[0]
        self._pending_stats.append((outs.attempts[:, 0], outs.failures[:, 0]))
        self.n_iterations += n
        self.chain_length += n * self.n_walkers

        self._sample_chunks.append(outs.walkers[:, 0])  # (n, W, P)
        self._prob_chunks.append(outs.logps[:, 0])      # (n, W)
        self._device_history_bytes += (
            outs.walkers.nelement() * outs.walkers.element_size()
            + outs.logps.nelement() * outs.logps.element_size()
        )
        if self._device_history_bytes > DEVICE_HISTORY_LIMIT:
            _ = self.sample      # moves walkers and logps to the host
            self._drain_stats()  # and the deferred proposal counts

    @property
    def walker_positions(self) -> np.ndarray:
        """Current walker positions, shape (n_walkers, P). A device view is
        converted to (mutable) numpy on first access."""
        if not isinstance(self._walker_positions, np.ndarray):
            self._walker_positions = _host(self._walker_positions)
        return self._walker_positions

    @walker_positions.setter
    def walker_positions(self, value):
        self._walker_positions = value

    @property
    def walker_probs(self) -> np.ndarray:
        if not isinstance(self._walker_probs, np.ndarray):
            self._walker_probs = _host(self._walker_probs)
        return self._walker_probs

    @walker_probs.setter
    def walker_probs(self, value):
        self._walker_probs = value

    def _drain_stats(self):
        """Record the deferred per-iteration proposal and failure counts."""
        if not self._pending_stats:
            return
        pending, self._pending_stats = self._pending_stats, []
        for attempts, failures in pending:
            attempts = _host(attempts)
            for i in range(self.n_walkers):
                self.total_proposals[i].extend(attempts[:, i].tolist())
            self.failed_updates.extend(_host(failures).tolist())

    def _consolidate_history(self):
        """Move both histories to the host, flattened to ((n_iter * W, P),
        (n_iter * W,))."""
        def needs_work(chunks):
            return len(chunks) > 1 or (chunks and not isinstance(chunks[0], np.ndarray))

        if needs_work(self._sample_chunks) or needs_work(self._prob_chunks):
            self._sample_chunks = [np.concatenate(
                [_host(c).reshape(-1, self.n_parameters) for c in self._sample_chunks]
            )] if self._sample_chunks else []
            self._prob_chunks = [np.concatenate(
                [_host(c).reshape(-1) for c in self._prob_chunks]
            )] if self._prob_chunks else []
            self._device_history_bytes = 0

    @property
    def sample(self) -> np.ndarray:
        """All stored samples, shape (n_iterations * n_walkers, P)."""
        if not self._sample_chunks:
            return None
        self._consolidate_history()
        return self._sample_chunks[0]

    @sample.setter
    def sample(self, value):
        self._sample_chunks = [] if value is None else [np.asarray(value)]

    @property
    def sample_probs(self) -> np.ndarray:
        if not self._prob_chunks:
            return None
        self._consolidate_history()
        return self._prob_chunks[0]

    @sample_probs.setter
    def sample_probs(self, value):
        self._prob_chunks = [] if value is None else [np.asarray(value)]

    def advance(self, iterations: int):
        """
        Advance the ensemble sampler a chosen number of iterations. Each
        iteration stores one set of walker positions, so the total number of
        samples generated is ``iterations * n_walkers``.
        """
        t_start = time()
        self.ProgressPrinter.iterations_initial(iterations)
        # ~20 progress groups, each run as power-of-two chunks
        groups = max(min(iterations, 20), 1)
        per_group = iterations // groups
        done = 0
        for k in range(groups):
            todo = per_group if k < groups - 1 else iterations - done
            if todo > 0:
                self._advance_n(todo)
                done += todo
            self.ProgressPrinter.iterations_progress(t_start, done - 1, iterations)
        self.ProgressPrinter.iterations_final(iterations)

    # ------------------------------------------------------------------ #
    # host history views
    # ------------------------------------------------------------------ #
    def mode(self) -> np.ndarray:
        """Return the sample with the highest posterior probability."""
        return self.sample[self.sample_probs.argmax(), :]

    def get_parameter(self, index: int, burn=0, thin=1) -> np.ndarray:
        """Return sample values for a chosen parameter with burn/thin slicing."""
        return self.sample[burn::thin, index]

    def get_probabilities(self, burn=0, thin=1) -> np.ndarray:
        """Return the log-probability for each sample with burn/thin slicing."""
        return self.sample_probs[burn::thin]

    def get_sample(self, burn=0, thin=1) -> np.ndarray:
        """Return the sample as an (n_samples, n_parameters) array."""
        return self.sample[burn::thin, :]

    def plot_diagnostics(self, show=True, filename=None):
        """The diagnostics figure: needs the plotting module (ROADMAP queue
        A14(b))."""
        self._not_ported("plot_diagnostics")

    # ------------------------------------------------------------------ #
    # checkpointing (.npz key layout of the reference and the JAX package,
    # reference: ensemble.py:355-411)
    # ------------------------------------------------------------------ #
    def save(self, filename):
        self._drain_stats()
        D = {
            "walker_positions": np.asarray(self.walker_positions),
            "n_parameters": self.n_parameters,
            "n_walkers": self.n_walkers,
            "walker_probs": np.asarray(self.walker_probs),
            "n_iterations": self.n_iterations,
            "total_proposals": np.array(self.total_proposals),
            "alpha": self.alpha,
            "max_attempts": self.max_attempts,
            "display_progress": self.display_progress,
        }
        if self.bounds is not None:
            D["lower_bounds"] = self.bounds.lower
            D["upper_bounds"] = self.bounds.upper
        if self.sample is not None:
            D["sample"] = self.sample
            D["sample_probs"] = self.sample_probs
        np.savez(filename, **D)

    @classmethod
    def load(cls, filename, posterior=None, seed=None, device="cuda"):
        """A sampler from a checkpoint of either package, on ``device``. With
        a posterior it continues from the stored walkers."""
        return cls.from_items(np.load(filename), posterior, seed, device)

    @classmethod
    def from_items(cls, D, posterior=None, seed=None, device="cuda", inv_temp=1.0):
        """A sampler from checkpoint items (an ``np.load`` of either
        package's ``.npz``), on ``device``, its walkers at ``inv_temp``."""
        if all(k in D for k in ["lower_bounds", "upper_bounds"]):
            bounds = Bounds(lower=D["lower_bounds"], upper=D["upper_bounds"],
                            error_source="EnsembleSampler")
        else:
            bounds = None

        sampler = cls(
            posterior=posterior,
            starting_positions=None,
            bounds=bounds,
            alpha=float(D["alpha"]),
            display_progress=bool(D["display_progress"]),
            seed=seed,
            device=device,
        )
        sampler.walker_positions = np.asarray(D["walker_positions"], dtype=float)
        sampler.n_parameters = int(D["n_parameters"])
        sampler.n_walkers = int(D["n_walkers"])
        sampler.walker_probs = np.asarray(D["walker_probs"], dtype=float)
        sampler.n_iterations = int(D["n_iterations"])
        sampler.total_proposals = [list(v) for v in D["total_proposals"]]
        sampler.max_attempts = int(D["max_attempts"])
        sampler.failed_updates = []
        sampler.chain_length = 0

        if "sample" in D:
            sampler.sample = np.asarray(D["sample"], dtype=float)
            sampler.sample_probs = np.asarray(D["sample_probs"], dtype=float)
            sampler.chain_length = sampler.sample_probs.size

        if posterior is not None:
            as_dev = lambda x: torch.tensor(x, dtype=default_float(), device=sampler.device)
            walkers = as_dev(sampler.walker_positions)
            sampler._logp = as_device_logp(posterior, walkers[0], "EnsembleSampler")
            sampler._state = init_ensemble_state(walkers[None],
                                                 as_dev(sampler.walker_probs)[None], inv_temp)
        return sampler
