"""Gaussian-process (Bayesian) optimisation.

Port of ``inference_tpu.gp.optimisation.GpOptimiser`` with the same API:
``propose_evaluation`` maximises the acquisition by multistart L-BFGS-B on
the host (``"bfgs"``), differential evolution (``"diffev"``) or every
start at once on the device (``"device"``, ``utils.optimize.minimize_bfgs``),
``add_evaluation`` appends the new datum and refits the GP, and
``plot_results`` shows the convergence history.

With ``optimizer="device"`` the refit is deferred: ``add_evaluation``
records it, and the next ``propose_evaluation`` does in one call the
acquisition value of the added point under the state that proposed it,
the 16-start hyperparameter fit and its refinement, the new factor and
``alpha``, the scoring of the candidate clouds and the acquisition
multistart with its refinement. The state stays on the device; the host
reads only the BFGS loops' done flags and, at the end, theta, that
acquisition value and the proposal.
"""

from collections.abc import Sequence
from inspect import isclass

import numpy as np
import torch
from scipy.optimize import differential_evolution, fmin_l_bfgs_b

from ..utils.optimize import minimize_bfgs, refined_multistart
from .acquisition import (
    CLOUD_INSET,
    CLOUD_SIZE,
    AcquisitionFunction,
    ExpectedImprovement,
    candidate_cloud,
)
from .covariance import CovarianceFunction, SquaredExponential
from .mean import ConstantMean, MeanFunction
from .regression import GpRegressor

_FIT_STARTS = 16  # hyperparameter starts of the deferred refit (fit_device's default)
_START_BUCKET = 16  # acquisition starts and clouds are padded to a multiple of this


def _logit_starts(starts, lwr, span):
    """Start positions mapped into sigmoid coordinates, kept off the
    boundary where the reparameterisation's gradient vanishes."""
    frac = torch.clamp((starts - lwr) / span, 0.01, 0.99)
    return torch.log(frac / (1.0 - frac))


class GpOptimiser:
    """
    Gaussian-process optimisation in one or more dimensions, for objective
    functions that are expensive to evaluate.

    :param x: initial evaluation positions, shape (n_points, n_dims).
    :param y: objective values at ``x``.
    :param bounds: iterable of (lower, upper) tuples per dimension.
    :param y_err: optional Gaussian errors on the y values.
    :param hyperpars: optional fixed hyperparameter values.
    :param kernel: covariance-function class or instance.
    :param mean: mean-function class or instance.
    :param cross_val: use LOO-CV instead of marginal likelihood.
    :param acquisition: acquisition-function class or instance
        (default ExpectedImprovement).
    :param optimizer: "bfgs" (host multistart L-BFGS-B), "diffev"
        (differential evolution), or "device" (every start optimised at
        once on the device, the refit deferred into the next proposal).
    :param n_processes: accepted for API compatibility; ignored.
    :param dtype: working dtype of the GP (default
        ``utils.dtypes.default_float()``).
    :param device: where the GP and the optimisation live (default the
        card; raises when there is none, pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        x,
        y,
        bounds: Sequence,
        y_err=None,
        hyperpars=None,
        kernel: CovarianceFunction = SquaredExponential,
        mean: MeanFunction = ConstantMean,
        cross_val: bool = False,
        acquisition: AcquisitionFunction = ExpectedImprovement,
        optimizer: str = "bfgs",
        n_processes: int = 1,
        dtype=None,
        device="cuda",
    ):
        self.x = x if isinstance(x, np.ndarray) else np.array(x)
        if self.x.ndim == 1:
            self.x = self.x.reshape([self.x.size, 1])
        self.y = y if isinstance(y, np.ndarray) else np.array(y)
        self.y_err = (
            y_err if isinstance(y_err, (np.ndarray, type(None))) else np.array(y_err)
        )

        self.bounds = bounds
        self.kernel = kernel
        self.mean = mean
        self.cross_val = cross_val
        self.n_processes = n_processes
        self.optimizer = optimizer

        # the loop refits on a growing data set; padding to a bucket keeps
        # the shapes fixed within it
        self.pad_to = 64
        self.gp = GpRegressor(
            x=self.x,
            y=self.y,
            y_err=self.y_err,
            hyperpars=hyperpars,
            kernel=kernel,
            mean=mean,
            cross_val=cross_val,
            optimizer=self.optimizer,
            n_processes=self.n_processes,
            pad_to=self.pad_to,
            dtype=dtype,
            device=device,
        )

        self.acquisition = acquisition() if isclass(acquisition) else acquisition
        self.acquisition.update_gp(self.gp)
        self.mu_max = self.y.max()

        self._acq_max_history = []
        self._conv_metric_history = []
        self._iter_history = []
        self._pending = None  # deferred-refit record (device optimizer)

    # The histories are public attributes users poll in stopping criteria;
    # with the deferred device refit they are filled one call later, so
    # plain reads settle the pending record first: a user loop never sees
    # a list one entry short.
    @property
    def acquisition_max_history(self):
        self._ensure_current()
        return self._acq_max_history

    @property
    def convergence_metric_history(self):
        self._ensure_current()
        return self._conv_metric_history

    @property
    def iteration_history(self):
        self._ensure_current()
        return self._iter_history

    def __call__(self, x):
        self._ensure_current()
        return self.gp(x)

    def add_evaluation(self, new_x, new_y, new_y_err=None):
        """
        Add the latest evaluation to the data set and re-train the
        Gaussian process (a full refit, including hyperparameters).

        With ``optimizer="device"`` the refit is deferred into the next
        ``propose_evaluation``, which does it with the proposal in one
        call. ``self.gp`` is stale between the two calls; the public
        surfaces (``__call__``, ``plot_results``, the history attributes,
        the next ``add_evaluation``) settle the pending refit first, so
        call one of them (or ``propose_evaluation``) before touching
        ``self.gp`` directly.
        """
        new_x = new_x if isinstance(new_x, np.ndarray) else np.array(new_x)
        if new_x.shape != (1, self.x.shape[1]):
            new_x = new_x.reshape((1, self.x.shape[1]))
        new_y = new_y if isinstance(new_y, np.ndarray) else np.array(new_y)
        good_type = isinstance(new_y_err, (np.ndarray, type(None)))
        new_y_err = new_y_err if good_type else np.array(new_y_err)

        deferred = self.optimizer == "device"
        if deferred and self._pending is not None:
            # two adds without a proposal between them: settle the first
            self._ensure_current()

        if not deferred:
            # one acquisition evaluation serves both history entries
            acq_value = self.acquisition(new_x.squeeze())
            self._acq_max_history.append(acq_value)
            self._conv_metric_history.append(
                self.acquisition.convergence_from_acquisition(acq_value)
            )
            self._iter_history.append(self.y.size + 1)
        else:
            # the acquisition value at new_x under the state that proposed
            # it is computed in the next proposal; keep what its history
            # entries need
            self._pending = {
                "new_x": np.asarray(new_x, dtype=float).ravel(),
                "old_state": self.acquisition.gp_state(),
                "mu_max": float(self.mu_max),
                "y_min": float(self.y.min()),
            }

        self.x = np.append(self.x, new_x, axis=0)
        self.y = np.append(self.y, new_y)

        if self.y_err is not None:
            if new_y_err is not None:
                self.y_err = np.append(self.y_err, new_y_err)
            else:
                raise ValueError(
                    "[ GpOptimiser error ] 'new_y_err' argument of the "
                    "'add_evaluation' method must be specified if the 'y_err' "
                    "argument was specified when the instance of GpOptimiser "
                    "was initialised."
                )

        self.gp.update_data(self.x, self.y, y_err=self.y_err, set_state=not deferred)
        if not deferred:
            self.gp.set_hyperparameters(
                self.gp.fit(optimizer=self.optimizer, n_processes=self.n_processes)
            )
            self.mu_max = self.y.max()
            self.acquisition.update_gp(self.gp)

    def _old_objective(self, pending):
        """The acquisition objective at the added point under the state
        that proposed it (a device scalar)."""
        with torch.no_grad():
            return self.acquisition._objective(self.acquisition._tensor(pending["new_x"]),
                                               pending["old_state"])

    def _ensure_current(self):
        """Settle a deferred refit without proposing: the history entry,
        the fit and the state, for callers that need the GP now."""
        pending = self._pending
        if pending is None:
            return
        obj_old = float(self._old_objective(pending))
        if not pending.get("history_done"):
            self._append_history(pending, obj_old)
            pending["history_done"] = True
        self.gp.set_hyperparameters(
            self.gp.fit(optimizer=self.optimizer, n_processes=self.n_processes)
        )
        self.mu_max = self.y.max()
        self.acquisition.update_gp(self.gp)
        # cleared only after the refit succeeded
        self._pending = None

    def _append_history(self, pending, obj_old: float):
        acq_value = self.acquisition._value_from_objective(obj_old)
        self._acq_max_history.append(acq_value)
        self._conv_metric_history.append(
            self.acquisition.convergence_from_acquisition(
                acq_value, mu_max=pending["mu_max"], y_min=pending["y_min"]
            )
        )
        self._iter_history.append(self.y.size)

    def diff_evo(self):
        opt_result = differential_evolution(self.acquisition.opt_func, self.bounds, popsize=30)
        solution = opt_result.x
        funcval = opt_result.fun
        if hasattr(funcval, "__len__"):
            funcval = funcval[0]
        return solution, funcval

    def launch_bfgs(self, x0):
        return fmin_l_bfgs_b(
            self.acquisition.opt_func_gradient,
            x0,
            approx_grad=False,
            bounds=self.bounds,
            pgtol=1e-10,
        )

    def multistart_bfgs(self):
        starting_positions = self.acquisition.starting_positions(self.bounds)
        results = [self.launch_bfgs(x0) for x0 in starting_positions]
        best_result = sorted(results, key=lambda x: float(x[1]))[0]
        return best_result[0], float(best_result[1])

    def _box(self):
        """The search box as tensors of the GP's dtype: lower bounds and
        widths."""
        lwr = self.acquisition._tensor([b[0] for b in self.bounds])
        upr = self.acquisition._tensor([b[1] for b in self.bounds])
        return lwr, upr - lwr

    def _acq_neg(self, lwr, span, st):
        """The acquisition objective under ``st`` at sigmoid coordinates
        (S, D), row by row."""
        return lambda z: self.acquisition.score(lwr + span * torch.sigmoid(z), st)

    def multistart_device(self):
        """
        Maximise the acquisition with every start at once on the device:
        the batched BFGS over sigmoid-bounded coordinates (150 iterations),
        then a second, tighter BFGS (400 iterations, gtol 1e-10) from the
        winner, adopted where it is no worse.
        """
        lwr, span = self._box()
        starts = self.acquisition._tensor(
            np.asarray(self.acquisition.starting_positions(self.bounds)))
        z0 = _logit_starts(starts, lwr, span)
        # the start count padded to a bucket, as the JAX package does
        n_pad = -len(z0) % _START_BUCKET
        if n_pad:
            z0 = torch.cat([z0, z0[:1].expand(n_pad, -1)])
        neg = self._acq_neg(lwr, span, self.acquisition.gp_state())
        res = minimize_bfgs(neg, z0, maxiter=150)
        zs, fs = res.x, res.fun
        best = torch.argmin(torch.where(torch.isfinite(fs), fs, torch.inf))
        ref = minimize_bfgs(neg, zs[best][None], maxiter=400, gtol=1e-10)
        better = ref.fun[0] <= fs[best]
        z_best = torch.where(better, ref.x[0], zs[best])
        f_best = torch.where(better, ref.fun[0], fs[best])
        out = torch.cat([z_best, f_best[None]]).cpu().numpy().astype(float)
        return self._to_box(out[:-1]), float(out[-1])

    def _to_box(self, z):
        lwr = np.array([b[0] for b in self.bounds], dtype=float)
        upr = np.array([b[1] for b in self.bounds], dtype=float)
        return np.clip(lwr + (upr - lwr) / (1.0 + np.exp(-z)), lwr, upr)

    # ------------------------------------------------------------------ #
    # the deferred device iteration
    # ------------------------------------------------------------------ #
    def _candidate_clouds(self, bucket: int = _START_BUCKET):
        """The acquisition multistart's clouds, one per data point, drawn
        from the acquisition's ``rng`` by ``acquisition.candidate_cloud``.
        Padded to a ``bucket`` multiple of clouds; out-of-bounds points and
        padding rows take uniform draws instead (harmless extra starts)."""
        lwr = np.array([b[0] for b in self.bounds], dtype=float)
        upr = np.array([b[1] for b in self.bounds], dtype=float)
        widths = upr - lwr
        lwr_in = lwr + widths * CLOUD_INSET
        upr_in = upr - widths * CLOUD_INSET
        rng = self.acquisition.rng

        n = self.x.shape[0]
        S = -(-n // bucket) * bucket
        cand = np.empty((S, CLOUD_SIZE, lwr.size))
        for idx in range(S):
            x0 = self.x[idx] if idx < n else None
            cand[idx] = candidate_cloud(x0, lwr_in, upr_in, widths, rng)
        return cand

    def _fused_step(self, cand, new_x, old_state):
        """The deferred iteration on the device: the objective at ``new_x``
        under ``old_state``, the 16-start refit and its refinement, the new
        state, the clouds ``cand`` (C, CLOUD_SIZE, D) scored under it and
        the acquisition multistart from each cloud's best point, refined.
        Returns ``(theta, (K_xx, mu, L, alpha), obj_old, z_prop, f_prop)``
        as device tensors."""
        gp, acq = self.gp, self.acquisition
        with torch.no_grad():
            obj_old = acq._objective(new_x, old_state)
        lo_f, hi_f = gp._hp_box()
        _, _, z_fit = gp._fit_device_z(gp._fit_starts(_FIT_STARTS, 0))
        theta = lo_f + (hi_f - lo_f) * torch.sigmoid(z_fit)
        state, st = self._state_at(theta)
        z_prop, f_prop = self._cloud_multistart(cand, st)
        return theta, state, obj_old, z_prop, f_prop

    def _state_at(self, theta):
        """The GP's state at the hyperparameters ``theta`` (a device
        tensor), ``(K_xx, mu, L, alpha)``, and the acquisition's state
        tuple built from it."""
        gp = self.gp
        state = gp._fit_state(theta)
        _, _, L, alpha = state
        m = gp._mask_dev
        mu_max = torch.max(torch.where(m > 0, gp._y_dev, -torch.inf))
        return state, (gp._x_dev, L, alpha, theta[gp.cov_slice], theta[gp.mean_slice], m,
                       mu_max)

    def _cloud_multistart(self, cand, st):
        """The acquisition multistart of the deferred iteration under the
        state ``st``: the clouds ``cand`` (C, CLOUD_SIZE, D) scored, a
        batched BFGS (150 iterations) from each cloud's best point, a
        non-finite iterate scored +inf, the winner (the box centre if all
        failed) refined (400 iterations, gtol 1e-10) and adopted where
        finite and no worse. Returns ``(z, f)`` on the device."""
        lwr, span = self._box()
        C, P, D = cand.shape
        with torch.no_grad():
            scores = self.acquisition.score(cand.reshape(C * P, D), st).reshape(C, P)
        winners = cand[torch.arange(C, device=cand.device), torch.argmin(scores, dim=1)]
        z0 = _logit_starts(winners, lwr, span)
        return refined_multistart(self._acq_neg(lwr, span, st), z0, 150, 400, 1e-10)[2:]

    def _fused_propose(self):
        pending = self._pending
        gp, acq = self.gp, self.acquisition
        theta, state, obj_old, z_prop, f_prop = self._fused_step(
            acq._tensor(self._candidate_clouds()), acq._tensor(pending["new_x"]),
            pending["old_state"])
        # one read of the small results; the state stays on the device
        small = torch.cat([theta, obj_old[None], z_prop, f_prop[None]]).cpu().numpy()
        small = small.astype(float)
        p, d = theta.numel(), z_prop.numel()
        gp._adopt_state(small[:p], theta, state)

        if not pending.get("history_done"):
            self._append_history(pending, float(small[p]))
            pending["history_done"] = True
        self.mu_max = float(self.y.max())
        acq.update_gp(gp)
        # only now is the deferred refit settled: clearing _pending earlier
        # would mark stale state current if the step had raised
        self._pending = None
        return self._to_box(small[p + 1 : p + 1 + d]), float(small[-1])

    def propose_evaluation(self, optimizer=None):
        """
        Propose the next evaluation location by maximising the acquisition
        function.
        """
        opt = optimizer if optimizer is not None else self.optimizer
        if opt == "device" and self._pending is not None:
            proposed_ev, _ = self._fused_propose()
        else:
            self._ensure_current()
            if opt == "bfgs":
                proposed_ev, _ = self.multistart_bfgs()
            elif opt == "device":
                proposed_ev, _ = self.multistart_device()
            else:
                proposed_ev, _ = self.diff_evo()
        if hasattr(proposed_ev, "__len__") and len(proposed_ev) == 1:
            proposed_ev = proposed_ev[0]
        return proposed_ev

    def plot_results(self, filename: str = None, show_plot=True):
        """Two-panel summary: running best and raw evaluations on the left,
        the acquisition convergence metric (log scale) on the right."""
        self._ensure_current()
        import matplotlib.pyplot as plt

        from ..utils.figures import finish_figure, series_with_markers_panel

        fig = plt.figure(figsize=(10, 4))
        maxvals = np.maximum.accumulate(self.y)
        pad = np.ptp(maxvals) * 0.1 if np.ptp(maxvals) > 0 else 1.0
        series_with_markers_panel(
            fig.add_subplot(121),
            np.arange(len(self.y)) + 1,
            line=(maxvals, dict(c="red", alpha=0.6, label="max observed value")),
            markers=(self.y, dict(label="function evaluations", markersize=10)),
            ylabel="function value",
            ylim=[maxvals.min() - pad, maxvals.max() + pad],
            legend_kwargs=dict(loc=4),
        )
        series_with_markers_panel(
            fig.add_subplot(122),
            self.iteration_history,
            line=(self.convergence_metric_history, dict(c="C0", alpha=0.35)),
            markers=(
                self.convergence_metric_history,
                dict(
                    c="C0",
                    label=self.acquisition.convergence_description,
                    markersize=10,
                ),
            ),
            ylabel="acquisition function value",
            title="Convergence summary",
            yscale="log",
            xlim=[0, None],
        )
        finish_figure(fig, plt, show_plot, filename)
