"""Shared host-side facade for the single-chain samplers.

Port of ``inference_tpu.mcmc.base``: the ``MarkovChain`` base class with
``advance``, ``run_for``, ``take_step``, burn/thin slicing of the history
getters and the removed ``burn``/``thin`` attribute errors. ``advance(m)``
splits the run into 100 progress groups like the reference
(reference: base.py:31-46), each run as power-of-two chunks of steps
(``_run_chunk``). ``get_marginal`` returns a ``pdf`` density estimator of
one parameter on the chain's device and ``get_interval`` the samples inside
a highest-density interval; the ``matrix_plot`` and ``trace_plot`` wrappers
raise until ROADMAP queue A14(b) ports the plotting module.
"""

from abc import ABC, abstractmethod
from copy import copy
from time import time

import numpy as np

from ..utils.progress import ChainProgressPrinter
from ..utils.wrap import validate_posterior

_MAX_CHUNK = 2048


class MarkovChain(ABC):
    chain_length: int
    n_parameters: int
    device: "torch.device"
    ProgressPrinter: ChainProgressPrinter

    @abstractmethod
    def get_parameter(self, index: int, burn: int = 1, thin: int = 1) -> np.ndarray:
        pass

    @abstractmethod
    def get_probabilities(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        pass

    @abstractmethod
    def get_sample(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        pass

    @abstractmethod
    def _run_chunk(self, n: int):
        """Advance the chain ``n`` steps and append the history."""

    def take_step(self):
        """Advance the chain by a single step."""
        self._advance_n(1)

    def _advance_n(self, n: int):
        """Advance ``n`` steps in power-of-two chunks of at most
        ``_MAX_CHUNK`` steps, as the JAX package does."""
        remaining = int(n)
        while remaining > 0:
            chunk = min(1 << (remaining.bit_length() - 1), _MAX_CHUNK)
            self._run_chunk(chunk)
            remaining -= chunk

    def advance(self, m: int):
        """
        Advances the chain by taking ``m`` new steps.

        :param int m: Number of steps the chain will advance.
        """
        t_start = time()
        if not getattr(self, "display_progress", True):
            # no progress display: run the fewest chunks
            self._advance_n(m)
            self.ProgressPrinter.percent_final(t_start, m)
            return

        k = 100  # divide chain steps into k progress groups
        group = m // k
        for j in range(k):
            if group > 0:
                self._advance_n(group)
            self.ProgressPrinter.percent_progress(t_start, j, k)
        if m % k != 0:
            self._advance_n(m % k)
        self.ProgressPrinter.percent_final(t_start, m)

    def run_for(self, minutes=0, hours=0, days=0):
        """
        Advances the chain for a chosen amount of wall-clock time
        (reference: base.py:48-73).

        :param minutes: number of minutes for which to run the chain.
        :param hours: number of hours for which to run the chain.
        :param days: number of days for which to run the chain.
        """
        update_interval = 20  # small initial guess for the update interval
        start_length = copy(self.chain_length)

        run_time = ((days * 24.0 + hours) * 60.0 + minutes) * 60.0
        start_time = time()
        current_time = start_time
        end_time = start_time + run_time
        steps_taken = 0

        while current_time < end_time:
            self._advance_n(update_interval)
            steps_taken = self.chain_length - start_length
            current_time = time()
            # aim for roughly one update per second, rounded to a power of two
            rate = max(int(steps_taken / max(current_time - start_time, 1e-9)), 1)
            update_interval = 1 << (rate.bit_length() - 1)
            self.ProgressPrinter.countdown_progress(end_time, steps_taken)
        self.ProgressPrinter.countdown_final(run_time, steps_taken)

    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"[ {self.__class__.__name__} error ] {what} is not ported to "
            "inference_tpu_torch yet (ROADMAP queue A14(b): plotting)."
        )

    def get_marginal(self, index: int, burn: int = 1, thin: int = 1, unimodal=False):
        """
        Estimate the 1D marginal distribution of a chosen parameter, returning
        a ``GaussianKDE`` (default) or ``UnimodalPdf`` density estimator on the
        chain's device (reference: base.py:75-107).
        """
        from ..pdf import GaussianKDE, UnimodalPdf

        samples = self.get_parameter(index, burn=burn, thin=thin)
        estimator = UnimodalPdf if unimodal else GaussianKDE
        return estimator(samples, device=self.device)

    def get_interval(
        self, interval: float = 0.95, burn: int = 1, thin: int = 1, samples: int = None,
        rng=None,
    ):
        """
        Return the samples from the chain which lie inside a chosen
        highest-density interval, with their log-probabilities (reference:
        base.py:109-162). With ``samples``, the kept set is thinned to about
        that many and trimmed to it at random by ``rng`` (a numpy
        ``Generator``; a fresh one when None; the JAX package draws from
        numpy's global stream).
        """
        probs = self.get_probabilities(burn=burn)
        if samples is not None:
            thin = max(probs.size // samples, 1)

        sample = self.get_sample(burn=burn, thin=thin)
        probs = probs[::thin]

        sorter = probs.argsort()
        sample = sample[sorter, :]
        probs = probs[sorter]
        cutoff = int(probs.size * (1 - interval))
        sample = sample[cutoff:, :]
        probs = probs[cutoff:]

        if samples is not None:
            n_trim = probs.size - samples
            if n_trim > 0:
                rng = rng if rng is not None else np.random.default_rng()
                keep = np.sort(rng.permutation(probs.size)[n_trim:])
                sample = sample[keep, :]
                probs = probs[keep]

        return sample, probs

    def matrix_plot(self, params=None, burn: int = 0, thin: int = 1, **kwargs):
        """A matrix plot of the marginals: needs the plotting module
        (ROADMAP queue A14(b))."""
        self._not_ported("matrix_plot")

    def trace_plot(self, params=None, burn: int = 0, thin: int = 1, **kwargs):
        """A trace plot of the parameters: needs the plotting module
        (ROADMAP queue A14(b))."""
        self._not_ported("trace_plot")

    @property
    def burn(self):
        self.__burn_thin_error()

    @burn.setter
    def burn(self, val):
        self.__burn_thin_error()

    @property
    def thin(self):
        self.__burn_thin_error()

    @thin.setter
    def thin(self, val):
        self.__burn_thin_error()

    def __burn_thin_error(self):
        raise AttributeError(
            f"[ {self.__class__.__name__} error ] The 'burn' and 'thin' instance "
            f"attributes of mcmc samplers were removed - burn and thin values "
            f"should now be passed explicitly to any methods with 'burn' and "
            f"'thin' keyword arguments."
        )

    def _validate_posterior(self, posterior, start):
        """The posterior as a scalar log-probability over ``(P,)`` tensors,
        after checking it at ``start`` (a tensor); see
        ``utils.wrap.validate_posterior``."""
        return validate_posterior(posterior, start, error_source=self.__class__.__name__)
