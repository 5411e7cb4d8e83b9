"""Visualisation of samples and diagnostics.

Port of ``inference_tpu.plotting``: corner ("matrix") plots of 1D and 2D
marginals, trace plots, highest-density-interval band plots and
transition-matrix heatmaps, with the JAX package's signatures, checks and
messages.

The data of a matrix plot is computed apart from its drawing, by
``matrix_panels``, on ``device`` (the card unless the caller passes
``"cpu"``): each parameter's plot range from its 98% highest-density
interval (``sample_hdi_device``), the diagonal panels' curves from
``GaussianKDE`` and the pair panels' grids (and the "hdi" style's levels)
from ``KDE2D``. matplotlib is imported inside the drawing calls only, so
this module imports on a machine without it.
"""

from itertools import product, cycle
from collections.abc import Sequence
from warnings import warn

import numpy as np
import torch

from .pdf.hdi import sample_hdi, sample_hdi_device
from .pdf.kde import GaussianKDE, KDE2D
from .utils.device import resolve_device

_GRID_RESOLUTION = 200
_STYLES = ("contour", "hdi", "histogram", "scatter")


def _get_cmap(name, fallback):
    from matplotlib import colormaps

    if name in colormaps:
        return colormaps[name]
    warn(f"'{name}' is not a valid colormap from matplotlib.colormaps")
    return colormaps[fallback]


def _default_labels(n):
    prefix = "p" if n >= 10 else "param "
    return [f"{prefix}{i}" for i in range(n)]


def _marginal_axis(sample, device):
    """Plot limits and evaluation grid from the 98% HDI, padded by 30%; the
    interval is found on ``device``."""
    s = torch.as_tensor(np.asarray(sample, dtype=float), device=device)
    lo, hi = (float(v) for v in sample_hdi_device(s, 0.98).cpu())
    span = hi - lo
    limits = [lo - 0.3 * span, hi + 0.3 * span]
    grid = np.linspace(lo - 0.35 * span, hi + 0.35 * span, _GRID_RESOLUTION)
    return limits, grid


def _diagonal_curve(sample, grid, device):
    """The diagonal panel's curve: the KDE on ``grid``, scaled to peak at 0.9."""
    density = np.asarray(GaussianKDE(np.asarray(sample), device=device)(grid))
    return 0.9 * density / density.max()


def _eval_kde2d_grid(x, y, x_grid, y_grid, device):
    pdf = KDE2D(x=x, y=y, device=device)
    X, Y = np.meshgrid(x_grid, y_grid)
    Z = np.asarray(pdf(X.flatten(), Y.flatten())).reshape(X.shape)
    return pdf, X, Y, Z


def _hdi_levels(pdf, x, y, Z, hdi_fractions):
    """The "hdi" style's contour levels: the density at the samples' own
    positions, at the percentiles that leave each fraction above."""
    at_samples = np.asarray(pdf(x, y))
    return sorted(
        list(np.percentile(at_samples, [100 * (1 - f) for f in hdi_fractions]))
        + [Z.max()]
    )


def matrix_panels(samples, plot_style: str = "contour", hdi_fractions=(0.35, 0.65, 0.95),
                  device="cuda"):
    """
    The data a matrix plot draws, computed on ``device``: per parameter its
    plot limits, its grid and its diagonal curve (``limits``, ``grids``,
    ``curves``); per pair (row, col) below the diagonal, for the "contour"
    and "hdi" styles, the KDE2D grid ``(X, Y, Z)`` on every fourth grid
    point (``pairs``) and, for "hdi", its contour levels (``levels``).
    """
    device = resolve_device(device, "matrix_plot")
    n_par = len(samples)
    per_param = [_marginal_axis(s, device) for s in samples]
    grids = [p[1] for p in per_param]
    out = {"limits": [p[0] for p in per_param], "grids": grids,
           "curves": [_diagonal_curve(s, g, device) for s, g in zip(samples, grids)],
           "pairs": {}, "levels": {}}
    if plot_style in ("contour", "hdi"):
        for row in range(n_par):
            for col in range(row):
                x, y = np.asarray(samples[col]), np.asarray(samples[row])
                pdf, X, Y, Z = _eval_kde2d_grid(x, y, grids[col][::4], grids[row][::4], device)
                out["pairs"][(row, col)] = (X, Y, Z)
                if plot_style == "hdi":
                    out["levels"][(row, col)] = _hdi_levels(pdf, x, y, Z, hdi_fractions)
    return out


def _draw_diagonal_panel(ax, grid, curve, color, reference_value):
    """1D marginal: normalised KDE curve with fill."""
    ax.plot(grid, curve, lw=1, color=color)
    ax.fill_between(grid, curve, color=color, alpha=0.1)
    if reference_value is not None:
        ax.plot([reference_value] * 2, [0, 1], lw=1.5, ls="dashed", color="red")
    ax.set_ylim([0, 1])


def _draw_pair_panel(ax, x, y, panel, levels, style, cmap, color, point_colors, point_size):
    """2D marginal in the chosen style."""
    if style == "contour":
        X, Y, Z = panel
        ax.set_facecolor(cmap(256 // 20))
        ax.contourf(X, Y, Z, 10, cmap=cmap)
    elif style == "hdi":
        X, Y, Z = panel
        ax.contourf(X, Y, Z, levels=levels, cmap=cmap)
        ax.contour(X, Y, Z, levels=levels, alpha=0.2)
    elif style == "histogram":
        ax.set_facecolor(cmap(0))
        ax.hexbin(x, y, gridsize=35, cmap=cmap)
    else:  # scatter
        if point_colors is None:
            ax.scatter(x, y, color=color, s=point_size)
        else:
            ax.scatter(x, y, c=point_colors, s=point_size, cmap=cmap)


def _draw_reference_marker(ax, rx, ry):
    for edge_color, edge_width in (("white", 3.5), ("red", 2)):
        ax.plot(
            rx,
            ry,
            marker="o",
            markersize=7,
            markerfacecolor="none",
            markeredgecolor=edge_color,
            markeredgewidth=edge_width,
        )


def matrix_plot(
    samples,
    labels=None,
    show: bool = True,
    reference: Sequence = None,
    filename: str = None,
    plot_style: str = "contour",
    colormap: str = "Blues",
    show_ticks: bool = None,
    point_colors: Sequence = None,
    hdi_fractions=(0.35, 0.65, 0.95),
    point_size: int = 1,
    label_size: int = 10,
    device="cuda",
):
    """
    Corner plot of all 1D and 2D marginal distributions for a set of
    parameter samples.

    :param samples: list of per-parameter sample arrays.
    :param labels: axis label per parameter.
    :param show: display the figure.
    :param reference: reference values over-plotted per parameter.
    :param filename: save path (not saved if omitted).
    :param plot_style: 'contour', 'hdi', 'histogram' or 'scatter'.
    :param colormap: matplotlib colormap name.
    :param show_ticks: force tick visibility (default: shown for < 6 params).
    :param point_colors: per-point colour data for the scatter style.
    :param hdi_fractions: probability fractions for 'hdi' contouring.
    :param point_size: marker size for the scatter style.
    :param label_size: axis-label font size.
    :param device: where the density estimates and intervals are computed
        (default the card; pass ``"cpu"`` for the CPU).
    """
    n_par = len(samples)
    if labels is None:
        labels = _default_labels(n_par)
    elif len(labels) != n_par:
        raise ValueError(
            "[ matrix_plot error ] The number of labels given does not match "
            "the number of plotted parameters."
        )

    if reference is not None and len(reference) != n_par:
        raise ValueError(
            "[ matrix_plot error ] The number of reference values given does "
            "not match the number of plotted parameters."
        )

    if plot_style not in _STYLES:
        plot_style = "contour"
        warn(
            "'plot_style' must be set as either 'contour', 'hdi', 'histogram' "
            "or 'scatter'"
        )

    if not hasattr(hdi_fractions, "__iter__") or not all(
        0 < f < 1 for f in hdi_fractions
    ):
        raise ValueError(
            "[ matrix_plot error ] The 'hdi_fractions' argument must be given "
            "as an iterable of floats, each in the range [0, 1]."
        )

    if show_ticks is None:
        show_ticks = n_par < 6

    data = matrix_panels(samples, plot_style, hdi_fractions, device)

    import matplotlib.pyplot as plt

    cmap = _get_cmap(colormap, "Blues")
    # darker colormap end for the 1D marginal curves
    marginal_color = min((cmap(10), cmap(245)), key=lambda c: sum(c[:-1]))
    limits = data["limits"]

    fig = plt.figure(figsize=(8, 8))

    # create the lower-triangular grid of axes; walking anti-diagonals from
    # the bottom-left corner guarantees each panel's share-target (bottom
    # row for x, left column for y) exists before the panel itself
    cells = [(n_par - 1, 0)]
    for stripe in range(1, n_par):
        cells.extend((n_par - 1 - k, stripe - k) for k in range(stripe + 1))

    axes = {}
    for row, col in cells:
        share_x = axes.get((n_par - 1, col)) if row < n_par - 1 else None
        share_y = axes.get((row, 0)) if (col > 0 and row != col) else None
        axes[(row, col)] = plt.subplot2grid(
            (n_par, n_par), (row, col), sharex=share_x, sharey=share_y
        )

    for (row, col), ax in axes.items():
        if row == col:
            _draw_diagonal_panel(
                ax,
                data["grids"][row],
                data["curves"][row],
                marginal_color,
                None if reference is None else reference[row],
            )
        else:
            _draw_pair_panel(
                ax,
                np.asarray(samples[col]),
                np.asarray(samples[row]),
                data["pairs"].get((row, col)),
                data["levels"].get((row, col)),
                plot_style,
                cmap,
                marginal_color,
                point_colors,
                point_size,
            )
            if reference is not None:
                _draw_reference_marker(ax, reference[col], reference[row])

        bottom_row = row == n_par - 1
        left_col = col == 0 and row != 0
        if bottom_row:
            ax.set_xlabel(labels[col], fontsize=label_size)
            ax.set_xlim(limits[col])
        if left_col:
            ax.set_ylabel(labels[row], fontsize=label_size)
            ax.set_ylim(limits[row])

        if not show_ticks:
            ax.set_xticks([])
            ax.set_yticks([])
        else:
            if not bottom_row:
                plt.setp(ax.get_xticklabels(), visible=False)
            if col > 0:
                plt.setp(ax.get_yticklabels(), visible=False)
            if row == col:
                ax.set_yticks([])

    fig.tight_layout()
    fig.subplots_adjust(wspace=0.0, hspace=0.0)
    if filename is not None:
        plt.savefig(filename)
    if show:
        plt.show()
    return fig


def trace_plot(samples, labels=None, show=True, filename=None):
    """
    Grid of per-parameter value-vs-step-number traces.

    :param samples: list of per-parameter sample arrays.
    :param labels: axis label per parameter.
    :param show: display the figure.
    :param filename: save path (not saved if omitted).
    """
    n_par = len(samples)
    if labels is None:
        labels = _default_labels(n_par)
    elif len(labels) != n_par:
        raise ValueError(
            "number of labels must match the number of plotted parameters"
        )

    import matplotlib.pyplot as plt

    # smallest grid with at most twice as many rows as columns
    n_cols = int(np.ceil(np.sqrt(0.5 * n_par)))
    n_rows = int(np.ceil(n_par / n_cols))

    fig = plt.figure(figsize=(12, 8))
    first_ax = None
    palette = cycle(["C0", "C1", "C2", "C3", "C4"])

    for (series, name, (row, col), colour) in zip(
        samples, labels, product(range(n_rows), range(n_cols)), palette
    ):
        ax = plt.subplot2grid((n_rows, n_cols), (row, col), sharex=first_ax)
        if first_ax is None:
            first_ax = ax

        series = np.asarray(series)
        ax.plot(series, ".", markersize=4, alpha=0.15, c=colour)
        ax.set_ylabel(name)

        # y-limits from the 99% HDI, ticks anchored on the 10%-HDI midpoint
        lo, hi = sample_hdi(series, fraction=0.99)
        mid = float(np.sum(sample_hdi(series, fraction=0.10))) / 2
        ax.set_ylim([lo - 0.7 * (mid - lo), hi + 0.7 * (hi - mid)])
        ax.set_yticks([lo - 0.5 * (mid - lo), mid, hi + 0.5 * (hi - mid)])

        if row == n_rows - 1:
            ax.set_xlabel("chain step #")
        else:
            plt.setp(ax.get_xticklabels(), visible=False)

    fig.tight_layout()
    if filename is not None:
        plt.savefig(filename)
    if show:
        plt.show()
    return fig


def hdi_plot(
    x,
    sample,
    intervals: Sequence = (0.65, 0.95),
    colormap: str = "Blues",
    axis=None,
    label_intervals=True,
    color_levels=None,
):
    """
    Filled highest-density-interval bands over ``x`` from a set of model
    realisations.

    :param x: x-axis locations, shape (len(x),).
    :param sample: realisations, shape (n, len(x)).
    :param intervals: probability fractions per band.
    :param colormap: matplotlib colormap name.
    :param axis: existing matplotlib axis to draw on.
    :param label_intervals: add legend labels per band.
    :param color_levels: explicit colormap levels (0-255) per band.
    """
    fractions = np.sort(np.asarray(intervals))[::-1]  # widest band first
    if not ((fractions > 0.0) & (fractions < 1.0)).all():
        raise ValueError("All intervals must be greater than 0 and less than 1")

    realisations = np.array(sample)
    if realisations.shape[1] != len(x):
        if realisations.shape[0] == len(x):
            realisations = realisations.T
        else:
            raise ValueError('"x" and "sample" have incompatible dimensions')
    realisations.sort(axis=0)

    cmap = _get_cmap(colormap, "Blues")
    if color_levels is None:
        color_levels = 255 * (0.8 * (1 - fractions) + 0.2)
    band_colors = [cmap(int(level)) for level in color_levels]

    if axis is None:
        import matplotlib.pyplot as plt

        _, axis = plt.subplots()

    for fraction, colour in zip(fractions, band_colors):
        lo, hi = sample_hdi(realisations, fraction=fraction)
        name = f"{int(100 * fraction)}% HDI" if label_intervals else None
        axis.fill_between(x, lo, hi, color=colour, label=name)

    return axis


def transition_matrix_plot(
    axis=None,
    matrix=None,
    colormap: str = "viridis",
    exclude_diagonal: bool = False,
    upper_triangular=False,
):
    """
    Rectangle-patch heatmap of a Markov-chain transition (or swap-rate)
    matrix with percentage text overlays.

    :param axis: existing matplotlib axis to draw on.
    :param matrix: 2D square array of probabilities in [0, 1].
    :param colormap: matplotlib colormap name.
    :param exclude_diagonal: omit the diagonal cells.
    :param upper_triangular: plot only the upper triangle.
    """
    if not isinstance(matrix, np.ndarray):
        raise TypeError("given matrix must be a numpy.ndarray")
    if matrix.ndim != 2:
        raise ValueError("given matrix must have exactly two dimensions")
    if matrix.shape[0] != matrix.shape[1]:
        raise ValueError("given matrix must be square")
    if matrix.shape[0] == 1:
        raise ValueError("given matrix must be at least of size 2x2")

    import matplotlib.patheffects as path_effects
    import matplotlib.pyplot as plt
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Rectangle

    n = matrix.shape[0]
    cells = [
        (i, j)
        for i in range(n)
        for j in range(n)
        if (not upper_triangular or i <= j)
        and (not exclude_diagonal or i != j)
    ]

    cmap = _get_cmap(colormap, "viridis")
    peak = matrix.max()
    patches = PatchCollection(
        [Rectangle((i + 0.5, j + 0.5), 1, 1) for i, j in cells],
        facecolors=[cmap(matrix[i, j] / peak) for i, j in cells],
        edgecolors=["black"] * n,
    )

    if axis is None:
        _, axis = plt.subplots()
    axis.add_collection(patches)
    xs = [c[0] for c in cells]
    ys = [c[1] for c in cells]
    axis.set_xlim([min(xs) + 0.5, max(xs) + 1.5])
    axis.set_ylim([min(ys) + 0.5, max(ys) + 1.5])

    if n < 11:  # percentage labels only readable for small matrices
        outline = [
            path_effects.Stroke(linewidth=1.5, foreground="black"),
            path_effects.Normal(),
        ]
        for i, j in cells:
            axis.text(
                i + 1,
                j + 1,
                f"{int(matrix[i, j] * 100)}%",
                ha="center",
                va="center",
                color="white",
                fontsize=20 - n,
            ).set_path_effects(outline)

    return axis
