"""Abstract base class of the 1D density estimators.

Port of ``inference_tpu.pdf.base``: ``interval`` refines a sample-HDI seed
by Nelder-Mead over (centre, width), and ``plot_summary`` draws the estimate
beside its summary statistics. matplotlib, which the card's machine lacks,
is imported inside ``plot_summary`` only.
"""

from abc import ABC, abstractmethod

import numpy as np
from scipy.optimize import minimize

from .hdi import sample_hdi


class DensityEstimator(ABC):
    sample: np.ndarray
    mode: float

    @abstractmethod
    def __call__(self, x):
        pass

    @abstractmethod
    def cdf(self, x):
        pass

    @abstractmethod
    def moments(self) -> tuple:
        pass

    def interval(self, fraction: float):
        """
        The highest-density interval: the shortest single interval
        containing ``fraction`` of the total probability. A sample-based
        HDI seeds a Nelder-Mead refinement over the interval's centre and
        width, minimising a cost that balances equal endpoint densities
        against the enclosed-mass error (reference: pdf/base.py:28-72).
        """
        if not 0.0 < fraction < 1.0:
            raise ValueError(
                f"[ {self.__class__.__name__} error ] The 'fraction' argument "
                f"must have a value greater than zero and less than one, but "
                f"the value given was {fraction}."
            )
        seed_lo, seed_hi = sample_hdi(self.sample, fraction=fraction)
        centre = 0.5 * (seed_lo + seed_hi)
        width = seed_hi - seed_lo
        density_weight = 0.2 / float(self(self.mode))

        def cost(params):
            c, w = params
            edges = np.array([c - 0.5 * w, c + 0.5 * w])
            p_lo, p_hi = np.atleast_1d(self(edges))
            mass = np.diff(np.atleast_1d(self.cdf(edges)))[0]
            balance_term = (density_weight * (p_lo - p_hi)) ** 2
            mass_term = (mass - fraction) ** 2
            return balance_term + mass_term

        start_simplex = np.array(
            [
                [centre, width],
                [centre, 0.95 * width],
                [centre - 0.05 * width, width],
            ]
        )
        result = minimize(
            cost,
            start_simplex[0],
            method="Nelder-Mead",
            options={"initial_simplex": start_simplex},
        )
        c, w = result.x
        return c - 0.5 * w, c + 0.5 * w

    def _plot_range(self, two_sigma, peak_density):
        """Extend the axis range until the density is negligible."""
        lo, hi = two_sigma
        step = 0.1 * (hi - lo)
        lo, hi = lo - step, hi + step
        while float(self(lo)) > 5e-3 * peak_density:
            lo -= step
        while float(self(hi)) > 5e-3 * peak_density:
            hi += step
        return lo, hi

    def plot_summary(self, filename=None, show=True, label=None):
        """Plot the estimated PDF alongside a panel of summary statistics."""
        import matplotlib.pyplot as plt

        one_sigma = self.interval(fraction=0.68268)
        two_sigma = self.interval(fraction=0.95449)
        mean, variance, skewness, kurtosis = self.moments()
        peak = float(self(self.mode))
        lo, hi = self._plot_range(two_sigma, peak)

        fig, (ax_pdf, ax_stats) = plt.subplots(
            ncols=2, figsize=(10, 6), gridspec_kw={"width_ratios": [2, 1]}
        )

        grid = np.linspace(lo, hi, 500)
        density = np.asarray(self(grid))
        ax_pdf.plot(grid, density, lw=1, c="C0")
        ax_pdf.fill_between(grid, density, color="C0", alpha=0.1)
        ax_pdf.plot([self.mode, self.mode], [0.0, peak], c="red", ls="dashed")
        ax_pdf.set_xlabel(label if label is not None else "argument", fontsize=13)
        ax_pdf.set_ylabel("probability density", fontsize=13)
        ax_pdf.set_ylim([0.0, None])
        ax_pdf.grid()

        # statistics panel: (title | name:value | interval) rows top-down
        rows = [
            ("title", "Basics"),
            ("value", "Mode", self.mode),
            ("value", "Mean", mean),
            ("value", "Standard dev", np.sqrt(variance)),
            ("skip",),
            ("title", "Highest-density intervals"),
            ("range", "1-sigma:", one_sigma),
            ("range", "2-sigma:", two_sigma),
            ("skip",),
            ("title", "Higher moments"),
            ("value", "Variance", variance),
            ("value", "Skewness", skewness),
            ("value", "Kurtosis", kurtosis),
        ]
        y, dy = 0.95, 0.05
        left_col, right_col = 0.35, 0.40
        for row in rows:
            kind = row[0]
            if kind == "skip":
                y -= dy
                continue
            if kind == "title":
                ax_stats.text(0.0, y, row[1], ha="left", fontweight="bold")
            elif kind == "value":
                ax_stats.text(left_col, y, f"{row[1]}:", ha="right")
                ax_stats.text(right_col, y, f"{row[2]:.5G}", ha="left")
            else:  # range
                lo_v, hi_v = row[2]
                ax_stats.text(left_col, y, row[1], ha="right")
                ax_stats.text(
                    right_col,
                    y,
                    rf"{lo_v:.5G} $\rightarrow$ {hi_v:.5G}",
                    ha="left",
                )
            y -= dy
        ax_stats.axis("off")

        plt.tight_layout()
        if filename is not None:
            plt.savefig(filename)
        if show:
            plt.show()
        return fig, (ax_pdf, ax_stats)
