"""Acquisition functions for Gaussian-process optimisation.

Port of ``inference_tpu.gp.acquisition``: ``ExpectedImprovement`` (the
two-branch log-domain formula on ``log_ndtr``),
``UpperConfidenceBound`` and ``MaxVariance``, with spatial gradients by
autograd of the objective. Each objective takes a query point and the GP
state explicitly (``gp_state``), so a point can be scored under the state
of an earlier fit; multistart clouds are scored in one batched call
(``torch.func.vmap`` over the points). The clouds draw from the generator
``rng`` that each acquisition holds (default ``np.random.default_rng()``).
"""

import math

import numpy as np
import torch

# multistart seeding policy, shared by the host path
# (AcquisitionFunction.starting_positions) and the fused device path
# (GpOptimiser._candidate_clouds)
CLOUD_SIZE = 20  # candidates per observed data point
CLOUD_INSET = 0.01  # bounds inset, as a fraction of the box width
CLOUD_WIDTH = 0.02  # cloud half-width, as a fraction of the box width


def candidate_cloud(x0, lwr_in, upr_in, widths, rng) -> np.ndarray:
    """A ``CLOUD_SIZE``-point multistart cloud around an observed point
    lying inside the inset bounds, or uniform draws over the inset box
    when it does not (``x0`` may be None for pure padding rows)."""
    L = widths.size
    if x0 is not None and ((x0 >= lwr_in) & (x0 <= upr_in)).all():
        return np.clip(
            x0[None, :] + CLOUD_WIDTH * widths * (2 * rng.random((CLOUD_SIZE, L)) - 1),
            lwr_in,
            upr_in,
        )
    return lwr_in + (upr_in - lwr_in) * rng.random((CLOUD_SIZE, L))


def _log_ndtr(z):
    """``log Phi(z)``, from ``erfcx`` below 0 and ``erfc`` above: the same
    values as ``torch.special.log_ndtr``, which has no ``vmap`` batching
    rule (``vmap`` would loop over the points one launch each)."""
    t = z / math.sqrt(2.0)
    neg = torch.clamp(t, max=0.0)
    pos = torch.clamp(t, min=0.0)
    low = torch.log(0.5 * torch.special.erfcx(-neg)) - neg * neg
    high = torch.log1p(-0.5 * torch.special.erfc(pos))
    return torch.where(z < 0, low, high)


class AcquisitionFunction:
    gp = None
    mu_max: float

    def __init__(self, rng=None):
        self.rng = rng if rng is not None else np.random.default_rng()

    def starting_positions(self, bounds):
        """
        Multistart seeds: the best of a small random cloud around each
        observed data point inside the bounds, plus a uniform draw for each
        point outside. Every cloud is scored in one batched call.
        """
        lwr, upr = [np.array([k[i] for k in bounds], dtype=float) for i in [0, 1]]
        widths = upr - lwr
        lwr = lwr + widths * CLOUD_INSET
        upr = upr - widths * CLOUD_INSET
        rng = self.rng
        L = len(widths)

        starts = []
        groups = []  # index into starts of each inside point's cloud
        candidates = []
        for x0 in self.gp.x:
            if ((x0 >= lwr) & (x0 <= upr)).all():
                groups.append(len(starts))
                candidates.append(candidate_cloud(x0, lwr, upr, widths, rng))
                starts.append(None)  # filled in after batch scoring
            else:
                starts.append(lwr + (upr - lwr) * rng.random(L))

        if candidates:
            cand = np.concatenate(candidates, axis=0)  # (CLOUD_SIZE * n_inside, L)
            with torch.no_grad():
                scores = self.score(self._tensor(cand), self.gp_state()).cpu().numpy()
            c = CLOUD_SIZE
            for g, start_idx in enumerate(groups):
                block = scores[g * c : (g + 1) * c]
                starts[start_idx] = cand[g * c + int(np.argmin(block))]
        return starts

    def update_gp(self, gp):
        """Point the acquisition at (fresh or refit) GP state."""
        self.gp = gp
        self.mu_max = gp.y.max()

    def gp_state(self):
        """The GP state the objectives take: the fitted model's x, L,
        alpha, covariance and mean parameters and mask, and the best
        observed value."""
        gp = self.gp
        return (*gp._state(), torch.as_tensor(self.mu_max, dtype=gp.L.dtype, device=gp.L.device))

    def _mu_var(self, q, st):
        """Predictive mean and variance at a single point under ``st``."""
        return self.gp._predict_single(q, *st[:6])

    def _objective(self, q, st):
        raise NotImplementedError

    def score(self, q, st):
        """The objective at each row of ``q`` (M, D) under ``st``."""
        return torch.func.vmap(self._objective, in_dims=(0, None))(q, st)

    def _value_from_objective(self, v: float) -> float:
        """Map a raw ``_objective`` value back to the acquisition value
        (the quantity ``__call__`` returns) without another evaluation."""
        return -v

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=self.gp._dtype,
                               device=self.gp._device)

    def opt_func(self, x) -> float:
        with torch.no_grad():
            return float(self._objective(self._tensor(x).flatten(), self.gp_state()))

    def opt_func_gradient(self, x):
        q = self._tensor(x).flatten().requires_grad_(True)
        value = self._objective(q, self.gp_state())
        (grad,) = torch.autograd.grad(value, q)
        return (np.asarray(float(value.detach()), dtype=float),
                grad.cpu().numpy().astype(float).squeeze())


class ExpectedImprovement(AcquisitionFunction):
    r"""
    Expected improvement
    ``EI(x) = (z F(z) + P(z)) sigma(x)`` with
    ``z = (mu(x) - y_max) / sigma(x)``, computed in the log domain for
    numerical stability at strongly negative ``z``.
    """

    def __init__(self, rng=None):
        super().__init__(rng)
        self.name = "Expected improvement"
        self.convergence_description = (
            r"$\mathrm{EI}_{\mathrm{max}} \; / \; (y_{\mathrm{max}} - "
            r"y_{\mathrm{min}})$"
        )

    def _log_ei(self, q, st):
        mu, var = self._mu_var(q, st)
        sig = torch.sqrt(torch.abs(var))
        z = (mu - st[-1]) / sig
        # EI = sig (z Phi(z) + phi(z)), branched for stability at both
        # tails: for z >= 0 the direct form never overflows (Phi <= 1, phi
        # <= 0.4); for z < 0 the log-domain form log phi + log(1 + z
        # Phi/phi) avoids underflow. A single formula exp(log_ndtr -
        # log_phi) ~ e^{z^2/2} overflows float32 for z > ~13
        pos = z >= 0
        z_pos = torch.clamp(z, min=0.0)
        z_neg = torch.clamp(z, max=0.0)
        log_2pi = math.log(2 * math.pi)
        log_phi_pos = -0.5 * (z_pos**2 + log_2pi)
        direct = z_pos * torch.exp(_log_ndtr(z_pos)) + torch.exp(log_phi_pos)
        log_ei_pos = torch.log(torch.clamp(direct, min=1e-300))

        log_phi_neg = -0.5 * (z_neg**2 + log_2pi)
        ratio = torch.exp(_log_ndtr(z_neg) - log_phi_neg)  # <= ~0.8 for z <= 0
        h = torch.clamp(1.0 + z_neg * ratio, min=1e-300)
        log_ei_neg = log_phi_neg + torch.log(h)

        return torch.log(sig) + torch.where(pos, log_ei_pos, log_ei_neg)

    def _objective(self, q, st):
        return -self._log_ei(q, st)

    def _value_from_objective(self, v: float) -> float:
        return float(np.exp(-v))

    def __call__(self, x) -> float:
        return float(np.exp(-self.opt_func(x)))

    def convergence_metric(self, x) -> float:
        return self.convergence_from_acquisition(self.__call__(x))

    def convergence_from_acquisition(self, value: float, mu_max=None, y_min=None) -> float:
        """Convergence metric derived from an already-computed acquisition
        value. ``mu_max``/``y_min`` override the live attributes, for
        deferred history entries that must use the values current when the
        point was evaluated."""
        mu_max = self.mu_max if mu_max is None else mu_max
        y_min = float(self.gp.y.min()) if y_min is None else y_min
        return value / (mu_max - y_min)


class UpperConfidenceBound(AcquisitionFunction):
    r"""
    Upper confidence bound ``UCB(x) = mu(x) + kappa * sigma(x)``.
    """

    def __init__(self, kappa: float = 2.0, rng=None):
        super().__init__(rng)
        self.kappa = kappa
        self.name = "Upper confidence bound"
        self.convergence_description = r"$\mathrm{UCB}_{\mathrm{max}} - y_{\mathrm{max}}$"

    def _objective(self, q, st):
        mu, var = self._mu_var(q, st)
        return -(mu + self.kappa * torch.sqrt(torch.abs(var)))

    def __call__(self, x) -> float:
        return -self.opt_func(x)

    def convergence_metric(self, x) -> float:
        return self.convergence_from_acquisition(self.__call__(x))

    def convergence_from_acquisition(self, value: float, mu_max=None, y_min=None) -> float:
        return value - (self.mu_max if mu_max is None else mu_max)


class MaxVariance(AcquisitionFunction):
    r"""
    Pure-exploration acquisition: maximises the predictive variance.
    """

    def __init__(self, rng=None):
        super().__init__(rng)
        self.name = "Max variance"
        self.convergence_description = r"$\sqrt{\mathrm{Var}\left[x\right]}$"

    def _objective(self, q, st):
        _, var = self._mu_var(q, st)
        return -var

    def __call__(self, x) -> float:
        return -self.opt_func(x)

    def convergence_metric(self, x) -> float:
        return self.convergence_from_acquisition(self.__call__(x))

    def convergence_from_acquisition(self, value: float, mu_max=None, y_min=None) -> float:
        return float(np.sqrt(value))
