"""Posterior composition of a likelihood and a prior.

Port of ``inference_tpu.models.posterior``. The composed object is torch
arithmetic throughout, so it works under ``torch.func.vmap`` and ``grad``
and can be handed straight to ``ChainArray`` and ``HamiltonianChain``.
"""

import numpy as np


class Posterior:
    """
    :param likelihood: callable returning the log-likelihood for parameters.
    :param prior: callable returning the log-prior for parameters.
    """

    def __init__(self, likelihood, prior):
        self.likelihood = likelihood
        self.prior = prior

    def __call__(self, theta):
        """Log-posterior probability for the given model parameters."""
        return self.likelihood(theta) + self.prior(theta)

    def gradient(self, theta):
        """Gradient of the log-posterior with respect to the parameters."""
        return self.likelihood.gradient(theta) + self.prior.gradient(theta)

    def cost(self, theta):
        """Negative log-posterior probability."""
        return -(self.likelihood(theta) + self.prior(theta))

    def cost_gradient(self, theta):
        """Gradient of the negative log-posterior."""
        return -(self.likelihood.gradient(theta) + self.prior.gradient(theta))

    def generate_initial_guesses(self, n_guesses: int = 1, prior_samples: int = 100, rng=None):
        """
        Draw ``prior_samples`` samples from the prior (with the numpy
        ``Generator`` ``rng``, a fresh one when None) and return the
        ``n_guesses`` with the highest posterior log-probability
        (reference: posterior.py:75-105).
        """
        if not isinstance(n_guesses, int) or not isinstance(prior_samples, int):
            raise TypeError("'n_guesses' and 'prior_samples' must both be integers")
        if n_guesses < 1 or prior_samples < 1:
            raise ValueError(
                "'n_guesses' and 'prior_samples' must both be greater than zero"
            )
        if n_guesses >= prior_samples:
            raise ValueError(
                "The value of 'n_guesses' must be less than that of 'prior_samples'"
            )
        rng = np.random.default_rng() if rng is None else rng
        samples = [np.asarray(self.prior.sample(rng)) for _ in range(prior_samples)]
        samples.sort(key=lambda s: float(self.cost(s)))
        return samples[:n_guesses]
