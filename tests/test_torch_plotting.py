"""The port's plotting (``inference_tpu_torch.plotting``) against the JAX
package's on the CPU (matplotlib's Agg backend): each of the four functions
on one set of samples draws as many axes and the same data within 1e-10
(line data, ``fill_between`` paths, contour levels, the HDI bands' vertices,
the transition matrix's patch colours and labels), with JAX's validation
messages. Every chain class's plot views draw on a short run, and both
``swap_diagnostics`` draw what JAX's draw from the same swap counts.
Importing the module leaves matplotlib unimported.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.collections import PatchCollection, PolyCollection  # noqa: E402
from matplotlib.contour import ContourSet  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from inference_tpu import plotting as jax_plotting  # noqa: E402
from inference_tpu.mcmc import GibbsChain as JaxGibbs  # noqa: E402
from inference_tpu.mcmc import ParallelTempering as JaxTempering  # noqa: E402
from inference_tpu.parallel import ShardedTempering as JaxShardedTempering  # noqa: E402
from inference_tpu.parallel import tempering_mesh as jax_tempering_mesh  # noqa: E402
from inference_tpu_torch import plotting  # noqa: E402
from inference_tpu_torch.mcmc import (EnsembleSampler, GibbsChain, HamiltonianChain,  # noqa: E402
                                      MetropolisChain, NutsChain, ParallelTempering, PcaChain)
from inference_tpu_torch.parallel import ShardedTempering, tempering_mesh  # noqa: E402

RTOL = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(autouse=True, scope="module")
def _float64():
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dt)


def make_samples(n_params=3, n=500, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=n)
    return [base * (i + 1) + rng.normal(0, 0.5, n) for i in range(n_params)]


def _close(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= RTOL * max(np.abs(b).max(initial=0.0), 1.0)


def _drawn(ax):
    """The data an axis draws: its lines' x and y data, its fill_between
    paths, its contour levels, its patch colours, its texts and limits."""
    out = {"lines": [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float))
                     for ln in ax.get_lines()],
           "fills": [], "levels": [], "patches": [],
           "texts": [t.get_text() for t in ax.texts],
           "limits": (ax.get_xlim(), ax.get_ylim())}
    for c in ax.collections:
        if isinstance(c, ContourSet):
            out["levels"].append(np.asarray(c.levels))
        elif isinstance(c, PatchCollection):
            out["patches"].append(np.asarray(c.get_facecolors()))
        elif isinstance(c, PolyCollection):
            out["fills"].append([p.vertices for p in c.get_paths()])
    return out


def _same_drawing(fig_a, fig_b):
    """Two figures draw the same: as many axes, each the same data."""
    assert len(fig_a.axes) == len(fig_b.axes)
    for ax_a, ax_b in zip(fig_a.axes, fig_b.axes):
        a, b = _drawn(ax_a), _drawn(ax_b)
        assert a["texts"] == b["texts"]
        _close(a["limits"], b["limits"])
        for key in ("lines", "fills"):
            assert len(a[key]) == len(b[key])
            for pa, pb in zip(a[key], b[key]):
                for xa, xb in zip(pa, pb):
                    _close(xa, xb)
        for key in ("levels", "patches"):
            assert len(a[key]) == len(b[key])
            for xa, xb in zip(a[key], b[key]):
                _close(xa, xb)


@pytest.mark.parametrize("style", ["contour", "hdi", "histogram", "scatter"])
def test_matrix_plot_draws_jax_data(style):
    samples = make_samples()
    kw = dict(show=False, plot_style=style, reference=[0.0, 0.0, 0.0])
    ours = plotting.matrix_plot(samples, device="cpu", **kw)
    theirs = jax_plotting.matrix_plot(samples, **kw)
    assert len(ours.axes) == 6  # lower triangle of a 3x3 grid
    _same_drawing(ours, theirs)
    if style in ("contour", "hdi"):
        assert any(_drawn(ax)["levels"] for ax in ours.axes)


def test_matrix_panels_hold_the_drawn_data():
    """``matrix_panels`` computes what matrix_plot draws: the diagonal
    curves, the pair grids and the "hdi" levels."""
    samples = make_samples()
    data = plotting.matrix_panels(samples, "hdi", device="cpu")
    fig = plotting.matrix_plot(samples, show=False, plot_style="hdi", device="cpu")
    diag = {(r, c): ax for (r, c), ax in zip(_cells(3), fig.axes)}
    for i in range(3):
        _close(diag[(i, i)].get_lines()[0].get_ydata(), data["curves"][i])
    assert sorted(data["pairs"]) == [(1, 0), (2, 0), (2, 1)]
    for key, (X, Y, Z) in data["pairs"].items():
        assert X.shape == Y.shape == Z.shape == (50, 50)
        _close(_drawn(diag[key])["levels"][0], data["levels"][key])


def _cells(n_par):
    """matrix_plot's order of axis creation (anti-diagonals from the
    bottom-left corner)."""
    cells = [(n_par - 1, 0)]
    for stripe in range(1, n_par):
        cells.extend((n_par - 1 - k, stripe - k) for k in range(stripe + 1))
    return cells


def test_matrix_plot_validation_matches_jax():
    samples = make_samples()
    for kw in (dict(labels=["a"]), dict(reference=[0.0]), dict(hdi_fractions=(1.5,))):
        with pytest.raises(ValueError) as ours:
            plotting.matrix_plot(samples, show=False, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jax_plotting.matrix_plot(samples, show=False, **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.warns(UserWarning, match="plot_style"):
        plotting.matrix_plot(samples, show=False, plot_style="bars", device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_matrix_plot_on_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        plotting.matrix_plot(make_samples(), show=False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        plotting.matrix_panels(make_samples())


def test_trace_plot_draws_jax_data():
    samples = make_samples(n_params=5)
    ours, theirs = plotting.trace_plot(samples, show=False), jax_plotting.trace_plot(samples,
                                                                                     show=False)
    assert len(ours.axes) == 5
    _same_drawing(ours, theirs)
    for a, b in zip(ours.axes, theirs.axes):
        _close(a.get_yticks(), b.get_yticks())
    with pytest.raises(ValueError) as info:
        plotting.trace_plot(samples, labels=["a"], show=False)
    with pytest.raises(ValueError) as ref:
        jax_plotting.trace_plot(samples, labels=["a"], show=False)
    assert str(info.value) == str(ref.value)


def test_hdi_plot_draws_jax_bands():
    rng = np.random.default_rng(1)
    x = np.linspace(0, 1, 20)
    sample = x[None, :] + rng.normal(0, 0.1, size=(500, 20))
    ours = plotting.hdi_plot(x, sample, intervals=(0.65, 0.95))
    theirs = jax_plotting.hdi_plot(x, sample.T, intervals=(0.65, 0.95))
    assert len(ours.collections) == 2
    _same_drawing(ours.figure, theirs.figure)
    assert [t.get_label() for t in ours.collections] == ["95% HDI", "65% HDI"]
    for args in ((x, sample, (1.5,)), (x, np.zeros([7, 9]), (0.65,))):
        with pytest.raises(ValueError) as info:
            plotting.hdi_plot(args[0], args[1], intervals=args[2])
        with pytest.raises(ValueError) as ref:
            jax_plotting.hdi_plot(args[0], args[1], intervals=args[2])
        assert str(info.value) == str(ref.value)


def test_transition_matrix_plot_draws_jax_colours():
    matrix = np.array([[0.0, 0.5, 0.2], [0.0, 0.0, 0.4], [0.0, 0.0, 0.0]])
    for kw in (dict(exclude_diagonal=True, upper_triangular=True), {}):
        ours = plotting.transition_matrix_plot(matrix=matrix, **kw)
        theirs = jax_plotting.transition_matrix_plot(matrix=matrix, **kw)
        _same_drawing(ours.figure, theirs.figure)
    bad = ((TypeError, [[0, 1], [1, 0]]), (ValueError, np.zeros([2, 3])),
           (ValueError, np.zeros([1, 1])), (ValueError, np.zeros(3)))
    for error, m in bad:
        with pytest.raises(error) as info:
            plotting.transition_matrix_plot(matrix=m)
        with pytest.raises(error) as ref:
            jax_plotting.transition_matrix_plot(matrix=m)
        assert str(info.value) == str(ref.value)


def _gauss(t):
    return -0.5 * (t * t).sum()


@pytest.mark.parametrize("cls", [GibbsChain, MetropolisChain, PcaChain, HamiltonianChain,
                                 NutsChain])
def test_chain_views_draw(cls):
    """matrix_plot, trace_plot and plot_diagnostics of each chain class on
    a short run, with JAX's checks of burn and thin."""
    kw = dict(display_progress=False, seed=0, device="cpu")
    if cls is NutsChain:
        kw["max_depth"] = 4
    chain = cls(_gauss, start=np.array([0.5, -0.5]), **kw)
    with pytest.raises(ValueError, match="no samples have been produced"):
        chain.matrix_plot()
    chain.advance(300)
    chain.matrix_plot(show=False)
    chain.trace_plot(show=False, burn=10)
    with pytest.raises(ValueError, match="insufficient samples to generate the trace plot"):
        chain.trace_plot(burn=chain.chain_length - 1, show=False)
    plt.close("all")
    chain.plot_diagnostics(show=True)  # Agg: shows nothing, keeps the figure
    assert plt.get_fignums() == [1] and len(plt.gcf().axes) == 4


@pytest.mark.parametrize("retry", [True, False])
def test_ensemble_views_draw(retry):
    starts = np.random.default_rng(0).normal(size=(20, 2))
    es = EnsembleSampler(_gauss, starts, retry=retry, display_progress=False, seed=1,
                         device="cpu")
    es.advance(30)
    es.plot_diagnostics(show=True)
    fig = plt.gcf()
    assert len(fig.axes) == 2 and len(fig.axes[0].get_lines()) == 21
    es.matrix_plot(show=False, plot_style="scatter")


def _swap_counts(n, seed=0):
    rng = np.random.default_rng(seed)
    attempted = np.triu(rng.integers(5, 50, (n, n)).astype(float), 1) + np.identity(n)
    return attempted, np.floor(attempted * rng.uniform(0, 1, (n, n))) * (1 - np.identity(n))


def test_parallel_tempering_swap_diagnostics_draws_jax_data():
    temps = [1.0, 3.0, 10.0, 30.0]
    port = ParallelTempering([GibbsChain(_gauss, start=np.array([0.5]), temperature=T,
                                         display_progress=False, seed=i, device="cpu")
                              for i, T in enumerate(temps)])
    ref = JaxTempering([JaxGibbs(lambda t: -0.5 * jnp.sum(t * t), start=np.array([0.5]),
                                 temperature=T, display_progress=False, seed=i)
                        for i, T in enumerate(temps)])
    attempted, successful = _swap_counts(4)
    figs = []
    for pt in (port, ref):
        pt.attempted_swaps, pt.successful_swaps = attempted.copy(), successful.copy()
        assert pt.swap_diagnostics() is None
        figs.append(plt.gcf())
    _same_drawing(*figs)
    heights = [[p.get_height() for p in f.axes[1].patches] for f in figs]
    np.testing.assert_array_equal(*heights)


def test_sharded_tempering_swap_diagnostics_draws_jax_data():
    temps = [1.0, 3.0, 10.0, 30.0]
    port = ShardedTempering(_gauss, np.zeros(2), temps, 4, tempering_mesh(4, 8, device="cpu"),
                            steps=2)
    ref = JaxShardedTempering(lambda t: -0.5 * jnp.sum(t * t), np.zeros(2), temps, 4,
                              jax_tempering_mesh(4), steps=2)
    attempted, successful = _swap_counts(4, seed=1)
    figs = []
    for st in (port, ref):
        st.attempted_swaps, st.successful_swaps = attempted.copy(), successful.copy()
        figs.append(st.swap_diagnostics(show=False))
    _same_drawing(*figs)
    heights = [[p.get_height() for p in f.axes[1].patches] for f in figs]
    np.testing.assert_array_equal(*heights)


def test_import_leaves_matplotlib_out():
    code = ("import sys, inference_tpu_torch.plotting, inference_tpu_torch.approx, "
            "inference_tpu_torch.utils.profiling; "
            "sys.exit(1 if any(m.split('.')[0] == 'matplotlib' for m in sys.modules) else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
