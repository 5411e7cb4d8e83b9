"""Parametric unimodal density estimation.

Port of ``inference_tpu.pdf.unimodal``: a 6-parameter skew-warped
generalised Student-t model ``z = z0 * exp(-f * tanh(z0 / k))``,
``log p = -(1 + v)/2 * log(1 + |z|^q / v)``, normalised by 128-node
Chebyshev quadrature on an infinite-interval transform and fitted by MAP
with Nelder-Mead from a moment-based grid of starts. The objective is torch
on the sample's device (the card unless the caller passes ``"cpu"``) in
float64; the simplex runs on the host, one device
evaluation and host read a step. The 72 starts are ranked in one batched
evaluation.
"""

from itertools import product

import numpy as np
import torch
from scipy.integrate import simpson
from scipy.optimize import minimize

from ..utils.device import resolve_device
from .base import DensityEstimator
from .hdi import sample_hdi


class UnimodalPdf(DensityEstimator):
    """
    Robust parametric estimate of a univariate, unimodal PDF from a sample,
    based on a heavily-modified Student-t distribution.

    :param sample: 1D array of samples.
    :param device: the device of the sample and the objective (default the
        card; pass ``"cpu"`` for the CPU).
    """

    def __init__(self, sample, device="cuda"):
        self.device = resolve_device(device, "UnimodalPdf")
        self.sample = np.asarray(sample, dtype=float).flatten()
        self.n_samps = self.sample.size

        # Chebyshev quadrature weights and nodes (reference: unimodal.py:28-33)
        self.sd = 0.2
        self.n_nodes = 128
        k = np.linspace(1, self.n_nodes, self.n_nodes)
        t = np.cos(0.5 * np.pi * ((2 * k - 1) / self.n_nodes))
        self.u = self._tensor(t / (1.0 - t**2))
        self.w = self._tensor(
            (np.pi / self.n_nodes) * (1 + t**2) / (self.sd * (1 - t**2) ** 1.5)
        )
        # Gauss-Legendre rule for the vectorised CDF quadrature
        gl_nodes, gl_weights = np.polynomial.legendre.leggauss(64)
        self._gl_rule = (self._tensor(gl_nodes), self._tensor(gl_weights))

        # first fit on a reduced sample slice if the sample is large
        self.cutoff = 2000
        self.skip = max(self.n_samps // self.cutoff, 1)
        self.fitted_samples = self._tensor(self.sample[:: self.skip])

        guesses, self.bounds = self.generate_guesses_and_bounds()
        costs = self._neg_posterior(self._tensor(np.array(guesses)), self.fitted_samples)
        guesses = [guesses[i] for i in np.argsort(costs.cpu().numpy(), kind="stable")]

        opt_method = "Nelder-Mead"
        self.min_result = minimize(
            fun=self._cost, x0=guesses[0], bounds=self.bounds, method=opt_method
        )
        self.MAP = self.min_result.x
        self.mode = self.MAP[0]

        if self.skip > 1:
            self.fitted_samples = self._tensor(self.sample)
            self.min_result = minimize(
                fun=self._cost, x0=self.MAP, bounds=self.bounds, method=opt_method
            )
            self.MAP = self.min_result.x
            self.mode = self.MAP[0]

        self.map_lognorm = float(torch.log(self._norm_device(self._tensor(self.MAP))))

        # bounds for the confidence-limits calculation
        x0, s0, v, f, k, q = self.MAP
        self.upr_limit = x0 + s0 * (4 * np.exp(f) + 1)
        self.lwr_limit = x0 - s0 * (4 * np.exp(-f) + 1)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def _cost(self, theta) -> float:
        """The simplex's objective: the negative log-posterior of the
        parameters at the fitted sample."""
        return float(self._neg_posterior(self._tensor(theta), self.fitted_samples))

    def generate_guesses_and_bounds(self):
        mu, sigma, skew = self.sample_moments(self.fitted_samples.cpu().numpy())
        lwr, upr = sample_hdi(sample=self.sample, fraction=0.5)

        bounds = [
            (lwr, upr),
            (sigma * 0.1, sigma * 10),
            (0.0, 5.0),
            (-3.0, 3.0),
            (1e-2, 20.0),
            (1.0, 6.0),
        ]
        x0 = [lwr * (1 - f) + upr * f for f in (0.3, 0.5, 0.7)]
        s0 = [sigma, sigma * 2]
        ln_v = [0.25, 2.0]
        f = [0.5 * skew, skew]
        k = [1.0, 4.0, 8.0]
        q = [2.0]
        return [np.array(g) for g in product(x0, s0, ln_v, f, k, q)], bounds

    @staticmethod
    def sample_moments(samples):
        mu = samples.mean()
        x2 = samples**2
        x3 = x2 * samples
        sig = np.sqrt(x2.mean() - mu**2)
        skew = (x3.mean() - 3 * mu * sig**2 - mu**3) / sig**3
        return mu, sig, skew

    # ------------------------------------------------------------------ #
    # device model functions; theta is (6,) or a batch (G, 6)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _log_model(x, theta):
        x0, s0, ln_v, f, k, q = (theta[..., i, None] for i in range(6))
        v = torch.exp(ln_v)
        z0 = (x - x0) / s0
        z = z0 * torch.exp(-f * torch.tanh(z0 / k))
        return -(0.5 * (1 + v)) * torch.log(1 + (torch.abs(z) ** q) / v)

    def _norm_device(self, theta):
        shape_pars = torch.cat(
            [self._tensor([0.0, self.sd]).expand(*theta.shape[:-1], 2), theta[..., 2:]], dim=-1
        )
        v = torch.exp(self._log_model(self.u, shape_pars))
        return (self.w * v).sum(dim=-1) * theta[..., 1]

    def _posterior_device(self, theta, samples):
        normalisation = samples.numel() * torch.log(self._norm_device(theta))
        return self._log_model(samples, theta).sum(dim=-1) - normalisation

    def _neg_posterior(self, theta, samples):
        return -self._posterior_device(theta, samples)

    # ------------------------------------------------------------------ #
    # public surface
    # ------------------------------------------------------------------ #
    def posterior(self, theta) -> float:
        """Log-posterior of the model parameters given the fitted sample."""
        return float(self._posterior_device(self._tensor(theta), self.fitted_samples))

    def __call__(self, x):
        """Evaluate the PDF estimate at the given locations."""
        x = self._tensor(np.atleast_1d(np.asarray(x, dtype=float)))
        vals = torch.exp(self._log_model(x, self._tensor(self.MAP)) - self.map_lognorm)
        vals = vals.cpu().numpy()
        return vals if vals.size > 1 else vals[0]

    def cdf(self, x):
        """CDF at the given locations as one batched quadrature on the
        device: the PDF between consecutive sorted points is integrated with
        64-node Gauss-Legendre rules (reference: pdf/unimodal.py:141-156
        integrates each interval with ``scipy.integrate.quad``)."""
        x = np.atleast_1d(np.asarray(x, dtype=float))
        sorter = x.argsort()
        inverse_sort = sorter.argsort()
        v = x[sorter]
        # interval edges: [lwr_limit -> v_0], then [v_{i-1} -> v_i]; every
        # edge is clipped at the lower limit, so queries below it add no mass
        a = np.maximum(np.concatenate([[self.lwr_limit], v[:-1]]), self.lwr_limit)
        b = np.maximum(v, self.lwr_limit)
        intervals = self._gl_intervals(self._tensor(a), self._tensor(b),
                                       self._tensor(self.MAP)).cpu().numpy()
        integral = intervals.cumsum()[inverse_sort]
        return integral if x.size > 1 else integral[0]

    def _gl_intervals(self, a, b, theta):
        nodes, weights = self._gl_rule
        mid = 0.5 * (a + b)
        half = 0.5 * (b - a)
        pts = mid[:, None] + half[:, None] * nodes[None, :]
        vals = torch.exp(self._log_model(pts, theta) - self.map_lognorm)
        return (vals * weights[None, :]).sum(dim=1) * half

    def evaluate_model(self, x, theta):
        theta = self._tensor(theta)
        out = torch.exp(self._log_model(self._tensor(x), theta)) / self._norm_device(theta)
        return out.cpu().numpy()

    def moments(self):
        """Mean, variance, skewness and excess kurtosis of the estimate."""
        s = self.MAP[1]
        f = self.MAP[3]
        lwr = self.mode - 5 * max(np.exp(-f), 1.0) * s
        upr = self.mode + 5 * max(np.exp(f), 1.0) * s
        x = np.linspace(lwr, upr, 1000)
        p = np.asarray(self(x))

        mu = simpson(p * x, x=x)
        var = simpson(p * (x - mu) ** 2, x=x)
        skw = simpson(p * (x - mu) ** 3, x=x) / var**1.5
        kur = (simpson(p * (x - mu) ** 4, x=x) / var**2) - 3.0
        return mu, var, skw, kur
