"""PCA-Gibbs sampler: one chain.

Port of ``inference_tpu.mcmc.pca`` (``PcaChain``), with ``device=`` (default
the card; pass ``"cpu"`` for the CPU): Gibbs sweeps along the eigenvectors
of the sample covariance. The sweep runs on the chain's device
(``make_pca_step``); the covariance re-estimation (blended with the last
one) and its eigendecomposition (reference: pca.py:96-126) run on the host
between advances. ``advance`` stops at each scheduled update (100, 250,
475, ... steps: an interval of 100 growing by 1.5), re-estimates the
directions, which live in the state, and resumes. Importing this module
does not import matplotlib; ``directions_diagnostics`` imports it when it
plots.
"""

from copy import copy
from warnings import warn

import numpy as np
import torch
from scipy.linalg import eigh

from ..utils import Bounds
from ._kernels.metropolis import GIBBS_TARGET, PcaState, make_pca_step
from .gibbs import MetropolisChain


class PcaChain(MetropolisChain):
    """
    Gibbs sampling over the eigenvectors of the sample covariance
    ('principal component analysis' directions), improving performance for
    linearly-correlated posteriors.

    Constructor arguments match ``GibbsChain``, plus:

    :param bounds: \
        A ``Bounds`` instance or ``(lower, upper)`` arrays; proposals are
        reflected into the bounds when given.
    """

    target_rate = GIBBS_TARGET

    def __init__(self, *args, bounds=None, **kwargs):
        super().__init__(*args, **kwargs)

        if hasattr(self, "n_parameters"):
            self.directions = np.eye(self.n_parameters)
            if self._state is not None:
                self._state = PcaState(*self._state, directions=self._directions_on_device())
        else:
            self.directions = None

        # PCA update settings (reference: pca.py:69-72)
        self.dir_update_interval = 100
        self.dir_growth_factor = 1.5
        self.last_update = 0
        self.next_update = copy(self.dir_update_interval)
        self.covar = None

        # PCA convergence tracking
        self.angles_history = []
        self.update_history = []

        if bounds is None or isinstance(bounds, Bounds):
            self.bounds = bounds
        else:
            self.bounds = Bounds(lower=bounds[0], upper=bounds[1], error_source="PcaChain")

        if self.bounds is not None and self._state is not None:
            self.bounds.validate_start_point(start=self.get_last(), error_source="PcaChain")

    def _directions_on_device(self):
        """The host directions as the state's ``(1, P, P)`` tensor."""
        return torch.as_tensor(self.directions[None], dtype=self._state.theta.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ #
    # the transition, with host-side direction updates
    # ------------------------------------------------------------------ #
    def _build_step(self):
        reflect = None if self.bounds is None else self.bounds.reflect
        return make_pca_step(
            self._logp.batched,
            target_rate=self.target_rate,
            bounds_reflect=reflect,
        )

    def _advance_n(self, n: int):
        remaining = int(n)
        while remaining > 0:
            if self.chain_length >= self.next_update:
                # catches schedules at or behind the current length too;
                # update_directions always reschedules
                self.update_directions()
            to_update = self.next_update - self.chain_length
            run = min(remaining, to_update) if to_update > 0 else remaining
            super()._advance_n(run)
            remaining -= run
        if self.chain_length >= self.next_update:
            self.update_directions()

    def update_directions(self):
        """
        Re-estimate the sample covariance (exponentially blended with the
        previous estimate) and switch the sweep directions to its
        eigenvectors (reference: pca.py:96-126).
        """
        theta = self._consolidated_theta()
        data = theta[1:][self.last_update :].T  # (n_params, n_new_samples)
        if data.shape[1] < 2:
            # too few new samples for a covariance: reschedule, or the
            # trigger in _advance_n would never fire again
            self.next_update = self.chain_length + self.dir_update_interval
            return

        if self.covar is not None:
            nu = min(2 * self.dir_update_interval / max(self.last_update, 1), 0.5)
            self.covar = self.covar * (1 - nu) + nu * np.cov(data)
        else:
            self.covar = np.cov(data)

        w, V = eigh(self.covar)

        # sine of the angle between old and new eigenvectors for convergence
        angles = [
            float(np.sqrt(max(1.0 - np.dot(V[:, i], self.directions[:, i]) ** 2, 0.0)))
            for i in range(self.n_parameters)
        ]
        self.angles_history.append(angles)
        self.update_history.append(copy(self.chain_length))

        self.directions = V.copy()
        self.last_update = copy(self.chain_length)
        self.dir_update_interval = int(self.dir_update_interval * self.dir_growth_factor)
        self.next_update = self.last_update + self.dir_update_interval
        self._state = self._state._replace(directions=self._directions_on_device())

    def directions_diagnostics(self):
        """Plot the eigenvector-angle convergence history (imports
        matplotlib here)."""
        import matplotlib.pyplot as plt

        for i in range(self.n_parameters):
            prods = [v[i] for v in self.angles_history]
            plt.plot(self.update_history, prods, ".-")
        plt.plot(
            [self.update_history[0], self.update_history[-1]],
            [1e-2, 1e-2],
            ls="dashed",
            c="black",
            lw=2,
        )
        plt.yscale("log")
        plt.ylim([1e-4, 1.0])
        plt.xlim([0, self.update_history[-1]])
        plt.ylabel(r"$|\sin{(\Delta \theta)}|$", fontsize=13)
        plt.xlabel(r"update step number", fontsize=13)
        plt.grid()
        plt.tight_layout()
        plt.show()

    # ------------------------------------------------------------------ #
    # disabled per-parameter constraints (reference: pca.py:280-296)
    # ------------------------------------------------------------------ #
    def set_non_negative(self, *args, **kwargs):
        warn(
            "The set_non_negative method is not available for PcaChain: "
            "Limits on parameters should instead be set using the bounds "
            "keyword argument."
        )

    def set_boundaries(self, *args, **kwargs):
        warn(
            "The set_boundaries method is not available for PcaChain: "
            "Limits on parameters should instead be set using the bounds "
            "keyword argument."
        )

    # ------------------------------------------------------------------ #
    # checkpointing (reference: pca.py:185-278)
    # ------------------------------------------------------------------ #
    def save(self, filename: str):
        items = self._checkpoint_items(modes=False)
        items |= {
            "dir_update_interval": self.dir_update_interval,
            "dir_growth_factor": self.dir_growth_factor,
            "last_update": self.last_update,
            "next_update": self.next_update,
            "angles_history": np.array(self.angles_history),
            "update_history": np.array(self.update_history),
            "directions": self.directions.T,  # rows = directions (the reference's layout)
            "covar": self.covar if self.covar is not None else np.eye(self.n_parameters),
        }
        if self.bounds is not None:
            items |= {"lower_bounds": self.bounds.lower, "upper_bounds": self.bounds.upper}
        np.savez(filename, **items)

    @classmethod
    def from_items(cls, D, posterior=None, seed=None, device="cuda"):
        """A chain from checkpoint items (an ``np.load`` of either package's
        ``.npz``), on ``device``, with its directions, blended covariance,
        update schedule and bounds."""
        chain = super().from_items(D, posterior, seed, device)
        if all(k in D for k in ["lower_bounds", "upper_bounds"]):
            chain.bounds = Bounds(lower=D["lower_bounds"], upper=D["upper_bounds"],
                                  error_source="PcaChain")
        chain.dir_update_interval = int(D["dir_update_interval"])
        chain.dir_growth_factor = float(D["dir_growth_factor"])
        chain.last_update = int(D["last_update"])
        chain.next_update = int(D["next_update"])
        chain.angles_history = [list(v) for v in np.atleast_2d(D["angles_history"])]
        chain.update_history = list(D["update_history"])
        chain.directions = np.asarray(D["directions"]).T.copy()
        chain.covar = np.asarray(D["covar"])
        chain._state = PcaState(*chain._state, directions=chain._directions_on_device())
        chain._step = None
        return chain
