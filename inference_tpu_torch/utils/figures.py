"""Shared building blocks for the diagnostic figures.

Port of ``inference_tpu.utils.figures``, unchanged: a log-probability
history with a burn-in marker, an adaptation summary, effective-sample-size
bars (or a histogram for many parameters), a text summary and the
line-plus-markers panel of ``GpOptimiser.plot_results``, each rendered
from plain data. It imports only numpy; the callers import matplotlib
inside their plotting calls and pass it in.
"""

import numpy as np

__all__ = [
    "finish_figure",
    "logprob_history_panel",
    "ess_panel",
    "summary_text_panel",
    "percent_change_panel",
    "trace_bundle_panel",
    "series_with_markers_panel",
]


def series_with_markers_panel(
    ax,
    x,
    *,
    line,
    markers,
    ylabel,
    title=None,
    yscale=None,
    ylim=None,
    xlim=None,
    xlabel="iteration",
    legend_kwargs=None,
):
    """A line series plus a marker series on the same axis — the two
    Bayesian-optimisation summary panels are both this shape. ``line``
    and ``markers`` are ``(y, style_kwargs)`` pairs."""
    y_line, line_style = line
    y_marks, mark_style = markers
    ax.plot(x, y_line, **line_style)
    ax.plot(x, y_marks, ".", **mark_style)
    if yscale is not None:
        ax.set_yscale(yscale)
    if ylim is not None:
        ax.set_ylim(ylim)
    if xlim is not None:
        ax.set_xlim(xlim)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title is not None:
        ax.set_title(title)
    ax.legend(**(legend_kwargs or {}))
    ax.grid()

_LABEL_FONTSIZE = 12


def finish_figure(fig, plt, show, filename):
    """The shared tail of every diagnostics plot: tight layout, optional
    save, then show or close."""
    fig.tight_layout()
    if filename is not None:
        plt.savefig(filename)
    if show:
        plt.show()
    else:
        fig.clear()
        plt.close(fig)


def logprob_history_panel(ax, probs, burn, half_floor_from=None):
    """Scatter of the chain's log-probability trace with a dashed red
    burn-in marker. The y-window floors at the second-half minimum (so
    early-transient values don't crush the axis) and pads the top by 10%
    of the range."""
    probs = np.asarray(probs)
    n = len(probs)
    half = n // 2 if half_floor_from is None else half_floor_from
    step_ax = np.arange(n) * 1e-3
    ax.plot(step_ax, probs, marker=".", ls="none", markersize=3)
    ax.set_xlabel("chain step number ($10^3$)", fontsize=_LABEL_FONTSIZE)
    ax.set_ylabel("posterior log-probability", fontsize=_LABEL_FONTSIZE)
    ax.set_title("Chain log-probability history")
    lo = probs[half:].min()
    ylims = [lo, probs.max() * 1.1 - 0.1 * lo]
    ax.plot([burn * 1e-3, burn * 1e-3], ylims, c="red", ls="dashed", lw=2)
    ax.set_ylim(ylims)
    ax.grid()


def ess_panel(ax, param_ESS, histogram_above: int = 50):
    """Per-parameter effective sample sizes: colour-cycled bars for few
    parameters, a 20-bin histogram above ``histogram_above``."""
    n = len(param_ESS)
    if n < histogram_above:
        ax.bar(range(n), param_ESS, color=["C0", "C1", "C2", "C3", "C4"])
        ax.set_xlabel("parameter", fontsize=_LABEL_FONTSIZE)
        ax.set_ylabel("effective sample size", fontsize=_LABEL_FONTSIZE)
        ax.set_title("Parameter effective sample size estimate")
        ax.set_xticks(range(n))
    else:
        ax.hist(param_ESS, bins=20)
        ax.set_xlabel("effective sample size", fontsize=_LABEL_FONTSIZE)
        ax.set_ylabel("frequency", fontsize=_LABEL_FONTSIZE)
        ax.set_title("Parameter effective sample size estimates")


def summary_text_panel(ax, rows):
    """An axis-less panel of right-aligned labels and left-aligned values,
    one ``(label, value)`` pair per row."""
    gap, h, x1, x2, fntsiz = 0.1, 0.85, 0.5, 0.55, 14
    for label, value in rows:
        ax.text(x1, h, label, ha="right", fontsize=fntsiz)
        ax.text(x2, h, value, ha="left", fontsize=fntsiz)
        h -= gap
    ax.axis("off")


def trace_bundle_panel(
    ax,
    x,
    traces,
    aggregate,
    aggregate_label,
    *,
    title,
    ylabel,
    scatter=False,
    alpha=0.05,
    ylim=None,
    xlabel="iteration",
):
    """A faint bundle of per-walker traces (lines, or a scatter cloud
    when ``scatter``) under a bold red aggregate line — the ensemble
    sampler's two diagnostic panels are both this shape."""
    traces = np.asarray(traces)
    if scatter:
        ax.plot(x, traces, marker=".", ls="none", c="C0", alpha=alpha)
    else:
        for row in traces:
            ax.plot(x, row, lw=0.5, c="C0", alpha=alpha)
    ax.plot(x, aggregate, lw=2, c="red", label=aggregate_label)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.grid()
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)


def percent_change_panel(ax, series_values, series_checks, chain_length):
    """Percent change between successive adaptation values of each series
    (one line per parameter), with dashed +-5% guides — the proposal-width
    adjustment summary."""
    for values, checks in zip(series_values, series_checks):
        y = np.asarray(values, dtype=float)
        x = np.asarray(checks[1:], dtype=float) * 1e-3
        if y.size > 1:
            ax.plot(x, 1e2 * np.diff(y) / y[:-1], marker="D", markersize=3)
    for guide in (5.0, -5.0):
        ax.plot(
            [0.0, chain_length * 1e-3],
            [guide, guide],
            ls="dashed",
            lw=2,
            color="black",
        )
    ax.set_xlabel("chain step number ($10^3$)", fontsize=_LABEL_FONTSIZE)
    ax.set_ylabel("% change in proposal widths", fontsize=_LABEL_FONTSIZE)
    ax.set_title("Parameter proposal widths adjustment summary")
    ax.set_ylim([-50, 50])
    ax.grid()
