"""Conditional-distribution approximations of a posterior.

Port of ``inference_tpu.approx.conditional``: 1D conditional slices of a
posterior around a point, sampled and summarised through a piecewise-linear
inverse-transform sampler with a numerically stable trapezium branch.

The numerics are the JAX package's: an 8-nat drop from the mode bounds
the region of non-negligible mass; 16 search points plus the conditioning
point; 6 rounds of mode refinement; both bracket edges bisected together
(tolerance 0.05, at most 20 rounds); a 64-point grid normalised by
Simpson's rule; cell masses ``means * dx`` (DELTAS.md #21).

A posterior takes the route ``utils.wrap.as_device_logp`` gives it on the
conditioning point's device. On the torch route one ``torch.func.vmap`` of
it serves every variable: each row of a batch is the conditioning point
with one coordinate replaced, the coordinate chosen by an index tensor
(the counterpart of the JAX package's traced index). On the host route (a
posterior written with numpy) it is called on the host once a point.

``get_conditionals`` advances all variables together: each round of the
procedure (the search, each refinement, each bisection round, the grid) is
one batched call over the rows of every variable, and a variable whose
bisection has finished is frozen by masks. Each variable's procedure and
arithmetic stay those of the JAX package's loop over the variables. The
bisection runs all its 20 rounds (the JAX package stops a variable's once
both its edges are found; the frozen rounds change nothing), so a call
makes 28 batched posterior calls whatever the number of variables or the
data.
"""

import numpy as np
import torch
from scipy.integrate import simpson

from ..utils.device import resolve_device
from ..utils.wrap import as_device_logp

_DTYPE = torch.float64
_THRESHOLD = 8.0       # nats below the mode that bound the conditional's range
_SEARCH_POINTS = 16
_REFINE_ROUNDS = 6
# batched posterior calls of every Conditional in this process
COUNTS = {"calls": 0}


class Conditional:
    """Functor pinning all but one variable of a posterior.

    :param posterior: the log-posterior, a torch function or one written
        with numpy.
    :param theta: the conditioning point.
    :param variable_index: the free variable of ``__call__`` and ``batch``.
    :param device: where the rows are built and, on the torch route, the
        posterior evaluated (default the card; pass ``"cpu"`` for the CPU).
    """

    def __init__(self, posterior, theta, variable_index: int, device="cuda"):
        self.device = resolve_device(device, "Conditional")
        self.posterior = posterior
        self.theta = np.asarray(theta, dtype=float)
        self.variable_index = variable_index
        self._base = torch.as_tensor(self.theta, dtype=_DTYPE, device=self.device)
        self._logp = as_device_logp(posterior, self._base, "Conditional")

    @property
    def host(self) -> bool:
        """True on the host route (the posterior is called once a point)."""
        return self._logp.host

    def __call__(self, x) -> float:
        t = self.theta.copy()
        t[self.variable_index] = x
        return float(self.posterior(t))

    def batch_at(self, index, xs) -> np.ndarray:
        """The posterior at the conditioning point with coordinate
        ``index[k]`` set to ``xs[k]``, for every k, in one batched call."""
        xs = torch.as_tensor(np.asarray(xs, dtype=float), dtype=_DTYPE, device=self.device)
        index = torch.as_tensor(np.asarray(index), dtype=torch.long, device=self.device)
        rows = self._base.expand(xs.shape[0], -1).clone()
        rows[torch.arange(xs.shape[0], device=self.device), index] = xs
        COUNTS["calls"] += 1
        return self._logp.batched(rows).cpu().numpy()

    def batch(self, xs) -> np.ndarray:
        """Evaluate the conditional at many points."""
        xs = np.asarray(xs, dtype=float)
        return self.batch_at(np.full(xs.size, self.variable_index), xs)


def _trapezium_quantile(u, dh):
    """
    Quantile function of the linear ("trapezium") density on [0, 1] whose
    value at t=1 exceeds the uniform density by ``dh``:
    f(t) = 1 + dh*(2t - 1), so F(t) = dh*t^2 + (1 - dh)*t and the quantile
    is the positive root of that quadratic. Where ``dh`` is tiny the
    quadratic formula cancels catastrophically; a first-order series in
    ``dh`` takes over, selected branchlessly.
    """
    u = np.asarray(u, dtype=float)
    dh = np.asarray(dh, dtype=float)
    near_zero = np.abs(dh) < 1e-5
    dh_safe = np.where(near_zero, 1.0, dh)
    b = dh - 1.0
    root = (b + np.sqrt(b * b + 4.0 * u * dh_safe)) / (2.0 * dh_safe)
    series = u + (1.0 - u) * u * dh
    return np.where(near_zero, series, root)


def piecewise_linear_sample(x, probability_density, n_samples: int, rng=None) -> np.ndarray:
    """
    Sample a 1D distribution evaluated on a grid by approximating the
    density as piecewise-linear: cells are drawn by inverse-CDF over the
    cumulative trapezium-rule masses, then positions within each cell by
    the closed-form trapezium quantile. The draws come from ``rng`` (a numpy
    ``Generator``; a fresh one when None).
    """
    x = np.asarray(x, dtype=float)
    density = np.asarray(probability_density, dtype=float)
    dx = np.diff(x)
    if (dx <= 0.0).any():
        raise ValueError(
            "[ piecewise_linear_sample error ] The 'x' argument must be "
            "given in strictly ascending order."
        )
    if (density < 0).any():
        raise ValueError(
            "[ piecewise_linear_sample error ] All values in the given "
            "'probability_density' array must be non-negative."
        )

    p_lo, p_hi = density[:-1], density[1:]
    mass = 0.5 * (p_lo + p_hi) * dx  # trapezium-rule mass per cell
    cdf = np.cumsum(mass)
    if not np.isfinite(cdf[-1]) or cdf[-1] <= 0.0:
        raise ValueError(
            "[ piecewise_linear_sample error ] The given "
            "'probability_density' has zero or non-finite total mass — "
            "the distribution cannot be sampled."
        )
    rng = rng if rng is not None else np.random.default_rng()
    cdf /= cdf[-1]
    cells = np.searchsorted(cdf, rng.random(n_samples), side="right")
    cells = np.minimum(cells, dx.size - 1)

    mid = 0.5 * (p_lo[cells] + p_hi[cells])
    # density slope relative to the cell's uniform level; zero-mass cells
    # are (almost surely) never drawn but must not divide by zero
    dh = 0.5 * (p_hi[cells] - p_lo[cells]) / np.where(mid > 0, mid, 1.0)
    t = _trapezium_quantile(rng.random(n_samples), dh)
    return x[cells] + t * dx[cells]


def _refine_edges(
    batch_eval, target, x1, x2, y1, active, tol=0.05, max_itr=20
) -> np.ndarray:
    """
    Vectorised bisection for several threshold crossings at once: all
    brackets step together, each round costing one batched conditional
    evaluation, with converged or inactive rows frozen by masks (a frozen
    row's bracket and midpoint no longer change). ``target`` is a scalar or
    one value a row; ``x1``/``y1`` is the edge kept when the crossing lies
    in the lower half. Every one of the ``max_itr`` rounds runs, also once
    all rows are done (they stay frozen), so the number of calls does not
    depend on the data. Returns the final midpoints (rows where ``active``
    is False are meaningless and ignored by the caller).
    """
    x1 = np.array(x1, dtype=float)
    x2 = np.array(x2, dtype=float)
    y1 = np.array(y1, dtype=float)
    done = ~np.asarray(active, dtype=bool)
    xm = 0.5 * (x1 + x2)
    for _ in range(max_itr):
        xm = np.where(done, xm, 0.5 * (x1 + x2))
        ym = batch_eval(xm)
        newly_done = ~done & (np.abs(ym - target) < tol)
        crossing_low = ((y1 < target) & (target < ym)) | (
            (ym < target) & (target < y1)
        )
        step = ~done & ~newly_done
        x2 = np.where(step & crossing_low, xm, x2)
        x1 = np.where(step & ~crossing_low, xm, x1)
        y1 = np.where(step & ~crossing_low, ym, y1)
        done |= newly_done
    return xm


def _evaluate_variables(func: Conditional, indices, points, grid_size: int = 64):
    """``evaluate_conditional`` for the variables ``indices`` of ``func``
    together, variable ``indices[k]`` searched from ``points[k]``: each round
    one batched call over the rows of every variable. Returns the grids and
    normalised densities, each (grid_size, len(indices))."""
    indices = np.asarray(indices, dtype=int)
    pairs = np.repeat(indices, 2)
    xs = [np.asarray(pts, dtype=float).copy() for pts in points]
    flat = func.batch_at(np.repeat(indices, [x.size for x in xs]), np.concatenate(xs))
    ps = np.split(flat, np.cumsum([x.size for x in xs])[:-1])

    # iteratively add points around each maximum to refine the mode position
    for _ in range(_REFINE_ROUNDS):
        inds = [min(max(int(p.argmax()), 1), p.size - 2) for p in ps]
        new = np.array([[0.5 * (x[i - 1] + x[i]), 0.5 * (x[i + 1] + x[i])]
                        for x, i in zip(xs, inds)])
        vals = func.batch_at(pairs, new.ravel()).reshape(-1, 2)
        for k, i in enumerate(inds):
            xs[k] = np.insert(xs[k], [i, i + 1], new[k])
            ps[k] = np.insert(ps[k], [i, i + 1], vals[k])

    p_mode = np.array([p.max() for p in ps])
    p_target = p_mode - _THRESHOLD
    lwr, upr, need = [], [], []
    for x, p, target in zip(xs, ps, p_target):
        inds = (p > target).nonzero()[0]
        lwr_ind = max(inds[0] - 1, 0)
        upr_ind = min(inds[-1] + 1, p.size - 1)
        lwr.append(lwr_ind)
        upr.append(upr_ind)
        need.append([p[lwr_ind] < target, p[upr_ind] < target])

    # both threshold crossings of every variable bisected together: one
    # batched evaluation of (variables x 2) rows a round
    edges = _refine_edges(
        lambda xm: func.batch_at(pairs, xm),
        np.repeat(p_target, 2),
        x1=[v for x, lo, hi in zip(xs, lwr, upr) for v in (x[lo + 1], x[hi - 1])],
        x2=[v for x, lo, hi in zip(xs, lwr, upr) for v in (x[lo], x[hi])],
        y1=[v for p, lo, hi in zip(ps, lwr, upr) for v in (p[lo + 1], p[hi - 1])],
        active=np.ravel(need),
    ).reshape(-1, 2)

    axes = np.stack([
        np.linspace(e[0] if n[0] else x[lo], e[1] if n[1] else x[hi], grid_size)
        for x, lo, hi, e, n in zip(xs, lwr, upr, edges, need)
    ], axis=1)
    probs = func.batch_at(np.repeat(indices, grid_size), axes.T.ravel())
    probs = np.exp(probs.reshape(-1, grid_size).T - p_mode)
    for k in range(indices.size):
        probs[:, k] /= simpson(probs[:, k], x=axes[:, k])
    return axes, probs


def evaluate_conditional(func: Conditional, points, grid_size: int = 64):
    """
    Refine the mode estimate, bracket the region of non-negligible
    probability mass (an 8-nat drop from the mode), and evaluate the
    normalised conditional on a uniform grid over it.
    """
    axes, probs = _evaluate_variables(func, [func.variable_index], [points], grid_size)
    return axes[:, 0], probs[:, 0]


def get_conditionals(posterior, bounds, conditioning_point, grid_size: int = 64,
                     device="cuda"):
    """
    Evaluate each 1D conditional distribution of the posterior around a
    given point, each on a uniform grid over the range containing
    non-negligible probability; all variables advance together, one
    batched posterior call a round.

    :param device: where the posterior is evaluated on the torch route
        (default the card; pass ``"cpu"`` for the CPU).
    :return: (axes, probabilities) arrays of shape (grid_size, n_variables).
    """
    conditioning_point = np.asarray(conditioning_point, dtype=float)
    conditional = Conditional(
        posterior=posterior, theta=conditioning_point, variable_index=0, device=device
    )
    points = []
    for i in range(conditioning_point.size):
        search_points = np.linspace(*bounds[i], _SEARCH_POINTS)
        if (search_points != conditioning_point[i]).all():
            index = np.searchsorted(search_points, conditioning_point[i])
            search_points = np.insert(search_points, index, conditioning_point[i])
        points.append(search_points)
    return _evaluate_variables(conditional, np.arange(conditioning_point.size), points,
                               grid_size)


def conditional_sample(posterior, bounds, conditioning_point, n_samples: int, rng=None,
                       device="cuda"):
    """
    Sample each 1D conditional and combine into approximate posterior
    samples, shape (n_samples, n_parameters). A reasonable approximation
    when the posterior is close to conditionally independent. The draws
    come from ``rng`` (a numpy ``Generator``; a fresh one when None), the
    variables in turn.
    """
    axes, probs = get_conditionals(
        posterior=posterior, bounds=bounds, conditioning_point=conditioning_point,
        device=device,
    )
    rng = rng if rng is not None else np.random.default_rng()
    grid_size, n_params = probs.shape
    samples = np.zeros([n_samples, n_params])
    for i in range(n_params):
        samples[:, i] = piecewise_linear_sample(axes[:, i], probs[:, i], n_samples, rng=rng)
    return samples


def conditional_moments(posterior, bounds, conditioning_point, device="cuda"):
    """
    Means and variances of the 1D conditional distributions of the
    posterior around a given point.
    """
    axes, probs = get_conditionals(
        posterior=posterior, bounds=bounds, conditioning_point=conditioning_point,
        device=device,
    )
    grid_size, n_params = probs.shape
    means = np.zeros(n_params)
    variances = np.zeros(n_params)
    for i in range(n_params):
        means[i] = simpson(y=axes[:, i] * probs[:, i], x=axes[:, i])
        variances[i] = simpson(
            y=(axes[:, i] - means[i]) ** 2 * probs[:, i], x=axes[:, i]
        )
    return means, variances
