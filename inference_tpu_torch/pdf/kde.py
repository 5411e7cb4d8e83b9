"""Gaussian kernel-density estimation.

Port of ``inference_tpu.pdf.kde`` (``GaussianKDE``, ``KDE2D``). A density or
distribution is a dense kernel sum on the sample's device over chunks of
4,096 query points; the sample axis is cut into blocks too, so a block holds
at most 2^24 kernel values whatever the sample's size, and the partial sums
add up. The bandwidth is Silverman's rule, or the maximum of the
leave-one-out cross-validation log-probability (quadratic in the sample,
capped at ``max_cv_samples``) over a self-extending, refined grid in
``log h``.

The estimators hold their sample on ``device`` (the card unless the caller
passes ``"cpu"``) in float64, as the JAX package's run under x64; the
bandwidth search and the mode's bounded scalar
minimisation run on the host, one device evaluation a step. The
cross-validation's subsample above ``max_cv_samples`` is drawn from ``rng``
(a numpy ``Generator``; a fresh one when None, as the JAX package does).
"""

import math

import numpy as np
import torch
from scipy.integrate import simpson
from scipy.optimize import minimize_scalar

from ..utils.device import resolve_device
from .base import DensityEstimator
from .hdi import sample_hdi

_CHUNK = 4096        # query points a chunk of the dense kernel sum
_BLOCK = 1 << 24     # kernel values a block (query chunk x sample block)
_DTYPE = torch.float64


def _block_sum(x, sample, term):
    """``sum_j term(x[:, None] - sample[None, j])`` over the sample, in
    blocks of at most ``_BLOCK`` kernel values: ``(M,)``."""
    step = max(1, _BLOCK // max(x.shape[0], 1))
    out = torch.zeros_like(x)
    for s in range(0, sample.shape[0], step):
        out = out + term(x[:, None] - sample[None, s:s + step]).sum(dim=1)
    return out


def _kde_pdf(x, sample, q, norm):
    return _block_sum(x, sample, lambda dx: torch.exp(-((dx * q) ** 2))) * norm


def _kde_cdf(x, sample, q):
    return _block_sum(x, sample, lambda dx: 0.5 * (1.0 + torch.erf(dx * q))) / sample.shape[0]


def _loo_cv_logprob(sample, h, c=0.99):
    """Leave-one-out cross-validation log-probability for bandwidth ``h``
    (a 0-d tensor; reference: kde.py:195-208)."""
    n = sample.shape[0]
    z = (sample[:, None] - sample[None, :]) / h
    log_norm = torch.log(n * h * math.sqrt(2 * math.pi))
    log_pdf = torch.logsumexp(-0.5 * z**2, dim=1) - log_norm
    d = math.log(c) - log_norm - log_pdf
    log_probs = log_pdf + torch.log(1 - torch.exp(d))
    return log_probs.sum()


def _evaluate(fn, x, device):
    """``fn`` of each chunk of the query points ``x`` (host values) on the
    device, the chunks' results read back in one copy: a numpy array, or a
    float for one point."""
    x = torch.as_tensor(np.atleast_1d(np.asarray(x, dtype=float)).ravel(), dtype=_DTYPE,
                        device=device)
    out = torch.cat([fn(x[i:i + _CHUNK]) for i in range(0, x.shape[0], _CHUNK)])
    out = out.cpu().numpy()
    return out if out.size > 1 else out[0]


class GaussianKDE(DensityEstimator):
    """
    Gaussian kernel-density estimate of a 1D sample's PDF.

    :param sample: 1D array of samples.
    :param bandwidth: optional fixed kernel bandwidth; estimated from the
        data when omitted.
    :param cross_validation: select the bandwidth by leave-one-out
        cross-validation instead of Silverman's rule.
    :param max_cv_samples: cap on the number of samples used in the
        cross-validation (cost is quadratic in the sample count).
    :param rng: numpy ``Generator`` of the cross-validation's subsample
        (above ``max_cv_samples``); a fresh one when None.
    :param device: the device the sample and the kernel sums live on
        (default the card; pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        sample,
        bandwidth: float = None,
        cross_validation: bool = False,
        max_cv_samples: int = 5000,
        rng=None,
        device="cuda",
    ):
        self.device = resolve_device(device, "GaussianKDE")
        self.sample = np.sort(np.asarray(sample, dtype=float).flatten())
        self.max_cvs = max_cv_samples
        self.rng = rng

        if self.sample.size < 3:
            raise ValueError(
                "[ GaussianKDE error ] Not enough samples were given to "
                "estimate the PDF. At least 3 samples are required."
            )

        if bandwidth is None:
            self.h = self.simple_bandwidth_estimator()
            if cross_validation:
                self.h = self.cross_validation_bandwidth_estimator(self.h)
        else:
            self.h = float(bandwidth)

        self.norm = 1.0 / (len(self.sample) * np.sqrt(2 * np.pi) * self.h)
        self.cutoff = self.h * 4
        self.q = 1.0 / (np.sqrt(2) * self.h)
        self.lwr_limit = self.sample[0] - self.cutoff * 0.5
        self.upr_limit = self.sample[-1] + self.cutoff * 0.5

        self._sample_dev = self._tensor(self.sample)
        self.mode = self.locate_mode()

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=_DTYPE, device=self.device)

    def __call__(self, x):
        """Evaluate the PDF estimate at the given locations."""
        return _evaluate(lambda c: _kde_pdf(c, self._sample_dev, self.q, self.norm), x,
                         self.device)

    def cdf(self, x):
        """Evaluate the CDF estimate at the given locations."""
        return _evaluate(lambda c: _kde_cdf(c, self._sample_dev, self.q), x, self.device)

    def simple_bandwidth_estimator(self) -> float:
        """Silverman's rule-of-thumb bandwidth (reference: kde.py:135-137)."""
        return 1.06 * float(self.sample.std()) / (self.sample.size**0.2)

    def cross_validation_bandwidth_estimator(self, initial_h: float) -> float:
        """
        Maximise the LOO-CV log-probability over a self-extending grid in
        log-bandwidth, followed by recursive refinement around the maximum.
        """
        if len(self.sample) > self.max_cvs:
            rng = self.rng if self.rng is not None else np.random.default_rng()
            idx = rng.choice(self.sample.size, self.max_cvs, replace=False)
            samples = self._tensor(self.sample[idx])
        else:
            samples = self._tensor(self.sample)

        def cv(log_h):
            return float(_loo_cv_logprob(samples, torch.exp(self._tensor(log_h))))

        dh = 0.5
        log_h = [np.log(initial_h) + m * dh for m in (-2, -1, 0, 1, 2)]
        log_p = [cv(h) for h in log_h]

        # extend the grid if the maximum is at an edge
        for _ in range(5):
            max_ind = int(np.argmax(log_p))
            if 0 < max_ind < len(log_h) - 1:
                break
            if max_ind == 0:
                new_h = log_h[0] - dh
                log_h.insert(0, new_h)
                log_p.insert(0, cv(new_h))
            else:
                new_h = log_h[-1] + dh
                log_h.append(new_h)
                log_p.append(cv(new_h))

        # recursive refinement around the maximum
        for _ in range(6):
            max_ind = int(np.argmax(log_p))
            max_ind = min(max(max_ind, 1), len(log_h) - 2)
            lwr_h = 0.5 * (log_h[max_ind - 1] + log_h[max_ind])
            upr_h = 0.5 * (log_h[max_ind] + log_h[max_ind + 1])
            log_h.insert(max_ind, lwr_h)
            log_p.insert(max_ind, cv(lwr_h))
            log_h.insert(max_ind + 2, upr_h)
            log_p.insert(max_ind + 2, cv(upr_h))

        return float(np.exp(log_h[int(np.argmax(log_p))]))

    def locate_mode(self) -> float:
        """Find the PDF mode by bounded scalar minimisation over the 20% HDI
        (reference: kde.py:220-230)."""
        if self.sample.size > 50:
            lwr, upr = sample_hdi(self.sample, 0.2)
        else:
            lwr, upr = self.sample[0], self.sample[-1]
        if lwr == upr:
            return float(lwr)
        result = minimize_scalar(
            lambda x: -float(self(x)), bounds=[lwr, upr], method="bounded"
        )
        return float(result.x)

    def moments(self):
        """
        Mean, variance, skewness and excess kurtosis of the estimated PDF,
        by Simpson integration of the estimate itself.
        """
        N = int(5 * (self.upr_limit - self.lwr_limit) / self.h)
        x = np.linspace(self.lwr_limit, self.upr_limit, N)
        p = np.asarray(self(x))

        mu = simpson(p * x, x=x)
        dx = x - mu
        I = p * dx**2
        var = simpson(I, x=x)
        I *= dx
        skw = simpson(I, x=x) / var**1.5
        I *= dx
        kur = (simpson(I, x=x) / var**2) - 3.0
        return mu, var, skw, kur

    def interval(self, fraction: float = 0.95):
        return super().interval(fraction)


class KDE2D:
    """
    Simple 2D product-kernel KDE with correlation-corrected bandwidths,
    used by the matrix-plot contouring (reference: kde.py:256-280): a dense
    kernel sum over all query points on ``device`` (the card unless the
    caller passes ``"cpu"``), in float64.
    """

    def __init__(self, x, y, device="cuda"):
        self.device = resolve_device(device, "KDE2D")
        self.x = np.asarray(x, dtype=float)
        self.y = np.asarray(y, dtype=float)
        s_x, s_y = self.estimate_bandwidth(self.x, self.y)
        self.q_x = 1.0 / (np.sqrt(2) * s_x)
        self.q_y = 1.0 / (np.sqrt(2) * s_y)
        self.norm = 1.0 / (len(self.x) * np.sqrt(2 * np.pi) * s_x * s_y)
        self._xy_dev = torch.as_tensor(np.stack([self.x, self.y]), dtype=_DTYPE,
                                       device=self.device)

    def __call__(self, x_vals, y_vals):
        xq = np.atleast_1d(np.asarray(x_vals, dtype=float)).ravel()
        yq = np.atleast_1d(np.asarray(y_vals, dtype=float)).ravel()
        # one query tensor (M, 2) through the chunked evaluation
        q = np.stack([xq, yq], axis=1)
        out = [self._density(torch.as_tensor(q[i:i + _CHUNK], dtype=_DTYPE,
                                             device=self.device))
               for i in range(0, q.shape[0], _CHUNK)]
        out = torch.cat(out).cpu().numpy()
        return out if out.size > 1 else out[0]

    def _density(self, q):
        step = max(1, _BLOCK // q.shape[0])
        out = torch.zeros(q.shape[0], dtype=_DTYPE, device=self.device)
        for s in range(0, self._xy_dev.shape[1], step):
            z_x = ((self._xy_dev[0, None, s:s + step] - q[:, :1]) * self.q_x) ** 2
            z_y = ((self._xy_dev[1, None, s:s + step] - q[:, 1:]) * self.q_y) ** 2
            out = out + torch.exp(-z_x - z_y).sum(dim=1)
        return out * self.norm

    def density(self, x, y):
        return self.__call__(x, y)

    @staticmethod
    def estimate_bandwidth(x, y):
        S = np.cov(x, y)
        p = S[0, 1] / np.sqrt(S[0, 0] * S[1, 1])
        return 1.06 * np.sqrt(np.diag(S) * (1 - p**2)) / (len(x) ** 0.2)
