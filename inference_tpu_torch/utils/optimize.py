"""BFGS batched over a leading axis of starting points.

The counterpart of ``jax.scipy.optimize.minimize(method="BFGS")`` (JAX's
``minimize_bfgs`` with its strong-Wolfe zoom line search), ``vmap``ped over
starts, which the JAX package's on-device fits run. The algorithm and its
constants are JAX's: an identity initial inverse Hessian, ``gtol`` 1e-5 on
the inf-norm of the gradient, ``old_old_fval = f0 + |g0|_2 / 2``, a line
search of at most 10 bracketing steps with c1 = 1e-4 and c2 = 0.9, each
zoom at most 30 steps (failing once its interval is below 1e-10, 1e-5 in
float32), a float32 step floor of 1e-8, an update skipped where ``rho`` is
not finite, and JAX's ``status`` codes: 0 converged, 1 ``maxiter`` reached,
``2 + s`` a failed line search of status ``s`` (1 zoom failed, 3 its
``maxiter`` reached), -1 otherwise.

Every row runs independently and a row that has converged or failed keeps
its state, which is what ``vmap`` of JAX's while loops does, so a batched
run equals one run per row. The nested loops (BFGS iterations, line-search
brackets, zoom steps) are flattened into rounds: in each round every row
takes the one objective evaluation its own phase asks for, all rows in one
call of ``fun``, then advances its own state. The host reads the rows'
done flags once every ``CHECK_EVERY`` (8) rounds and at no other point, so
the loop runs on the device without a sync a round; rows that finish
between two reads wait, their state held. A round is one evaluation of
``fun``, and a BFGS iteration takes one round or more.
"""

from typing import NamedTuple

import torch

CHECK_EVERY = 8  # rounds between two host reads of the rows' done flags
# rounds and host reads of every run in this process (the loop adds to them)
COUNTS = {"rounds": 0, "host_reads": 0}
_C1, _C2 = 1e-4, 0.9  # the strong Wolfe constants of JAX's line search
_ZOOM_MAXITER = 30  # zoom steps before JAX's zoom gives up

_BRACKET, _ZOOM, _DONE = 0, 1, 2  # a row's phase


class BfgsResult(NamedTuple):
    """Per row: ``x`` (S, n), ``fun`` (S,), ``jac`` (S, n), ``nit``,
    ``status`` and ``nfev`` (S,) int64 tensors on the device of ``x0``.
    ``rounds`` is the batched evaluations made, ``host_reads`` the reads of
    the done flags."""

    x: torch.Tensor
    fun: torch.Tensor
    jac: torch.Tensor
    nit: torch.Tensor
    status: torch.Tensor
    nfev: torch.Tensor
    rounds: int
    host_reads: int


def value_and_grad(fun, x):
    """``fun(x)`` (S,) and its gradient in each row, by autograd of the sum
    (the rows are independent)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g.detach()


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through (a, fa) with slope fpa, (b, fb)
    and (c, fc) (JAX's ``_cubicmin``); NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    e0 = fb - fa - C * db
    e1 = fc - fa - C * dc
    A = (dc**2 * e0 + (-(db**2)) * e1) / denom
    B = ((-(dc**3)) * e0 + db**3 * e1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The minimiser of the quadratic through (a, fa) with slope fpa and
    (b, fb) (JAX's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _put(mask, new, old):
    """``new`` where ``mask`` (S,) holds, else ``old``; any trailing shape."""
    m = mask.reshape(mask.shape + (1,) * (old.ndim - 1))
    return torch.where(m, new, old)


def minimize_bfgs(fun, x0, maxiter=None, gtol=1e-5, line_search_maxiter=10):
    """Minimise ``fun`` from every row of ``x0`` (S, n) by BFGS.

    ``fun`` maps (S, n) to (S,), row by row; its gradient comes from
    autograd. ``maxiter`` defaults to 200 n, as in JAX. Returns a
    ``BfgsResult``."""
    if x0.ndim != 2:
        raise ValueError(f"x0 must be (starts, n), got shape {tuple(x0.shape)}")
    S, n = x0.shape
    if maxiter is None:
        maxiter = 200 * n
    dt, dev = x0.dtype, x0.device
    full = lambda v: torch.full((S,), v, dtype=dt, device=dev)
    ints = lambda v: torch.full((S,), v, dtype=torch.int64, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    threshold = 1e-10 if dt == torch.float64 else 1e-5
    short = torch.finfo(dt).bits != 64

    x = x0.detach().clone()
    f, g = value_and_grad(fun, x)
    nfev = ints(1)
    H = eye.expand(S, n, n).clone()
    old_old = f + torch.linalg.vector_norm(g, dim=1) / 2
    k = ints(0)
    converged = torch.linalg.vector_norm(g, ord=float("inf"), dim=1) < gtol
    failed = torch.zeros(S, dtype=torch.bool, device=dev)
    ls_status = ints(0)

    # line-search state, set by start_search and used where the phase says
    phase = ints(_DONE)
    p = torch.zeros_like(x)
    phi0, dphi0, start = full(0.0), full(0.0), full(0.0)
    i = ints(1)
    a1, phi1, dphi1 = full(0.0), full(0.0), full(0.0)
    s_a, s_phi, s_dphi, s_g = full(0.0), full(0.0), full(0.0), torch.zeros_like(x)
    ls_failed = torch.zeros_like(failed)  # a zoom failed inside the line search
    # zoom state
    lo_a, lo_phi, lo_dphi = full(0.0), full(0.0), full(0.0)
    hi_a, hi_phi, hi_dphi = full(0.0), full(0.0), full(0.0)
    rec_a, rec_phi = full(0.0), full(0.0)
    j = ints(0)
    z_failed = torch.zeros_like(failed)

    def start_search(mask):
        """Begin a line search in the rows of ``mask`` from (x, f, g, H)."""
        nonlocal phase, p, phi0, dphi0, start, i, a1, phi1, dphi1
        nonlocal s_a, s_phi, s_dphi, s_g, ls_failed
        p_new = -torch.einsum("sij,sj->si", H, g)
        d0 = (g * p_new).sum(dim=1)
        cand = 1.01 * 2 * (f - old_old) / d0
        phase = torch.where(mask, _BRACKET, phase)
        p = _put(mask, p_new, p)
        phi0 = torch.where(mask, f, phi0)
        dphi0 = torch.where(mask, d0, dphi0)
        start = torch.where(mask, torch.where(cand > 1, torch.ones_like(cand), cand), start)
        i = torch.where(mask, 1, i)
        a1 = torch.where(mask, 0.0, a1)
        phi1 = torch.where(mask, f, phi1)
        dphi1 = torch.where(mask, d0, dphi1)
        s_a = torch.where(mask, 0.0, s_a)
        s_phi = torch.where(mask, f, s_phi)
        s_dphi = torch.where(mask, d0, s_dphi)
        s_g = _put(mask, g, s_g)
        ls_failed = ls_failed & ~mask

    start_search(~converged & (k < maxiter))

    def one_round():
        nonlocal x, f, g, H, old_old, k, converged, failed, ls_status, nfev, phase
        nonlocal i, a1, phi1, dphi1, s_a, s_phi, s_dphi, s_g, ls_failed
        nonlocal lo_a, lo_phi, lo_dphi, hi_a, hi_phi, hi_dphi, rec_a, rec_phi, j, z_failed
        bracket, zoom = phase == _BRACKET, phase == _ZOOM
        busy = bracket | zoom

        # the zoom's trial step (cubic, quadratic or bisection) and its
        # interval check, from the state before the evaluation
        dalpha = hi_a - lo_a
        lo_end, hi_end = torch.minimum(hi_a, lo_a), torch.maximum(hi_a, lo_a)
        cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
        a_cubic = _cubicmin(lo_a, lo_phi, lo_dphi, hi_a, hi_phi, rec_a, rec_phi)
        use_cubic = (j > 0) & (a_cubic > lo_end + cchk) & (a_cubic < hi_end - cchk)
        a_quad = _quadmin(lo_a, lo_phi, lo_dphi, hi_a, hi_phi)
        use_quad = ~use_cubic & (a_quad > lo_end + qchk) & (a_quad < hi_end - qchk)
        a_zoom = torch.where(use_cubic, a_cubic, rec_a)
        a_zoom = torch.where(use_quad, a_quad, a_zoom)
        a_zoom = torch.where(~use_cubic & ~use_quad, (lo_a + hi_a) / 2.0, a_zoom)
        a_bracket = torch.where(i == 1, start, a1 * 2.0)
        a = torch.where(zoom, a_zoom, torch.where(bracket, a_bracket, torch.zeros_like(a1)))

        phi, gj = value_and_grad(fun, _put(busy, x + a[:, None] * p, x))
        dphi = (gj * p).sum(dim=1)
        nfev = nfev + busy.long()
        wolfe_one = lambda at, ph: ph > phi0 + _C1 * at * dphi0
        wolfe_two = lambda dph: torch.abs(dph) <= -_C2 * dphi0

        # bracketing step
        to_zoom1 = wolfe_one(a, phi) | ((phi >= phi1) & (i > 1))
        to_star = wolfe_two(dphi) & ~to_zoom1
        to_zoom2 = (dphi >= 0.0) & ~to_zoom1 & ~to_star
        enter1, enter2 = bracket & to_zoom1, bracket & to_zoom2
        entering = enter1 | enter2
        b_star = bracket & to_star

        # zoom step
        z_failed_now = z_failed | (dalpha <= threshold)
        hi_to_j = wolfe_one(a, phi) | (phi >= lo_phi)
        star_to_j = wolfe_two(dphi) & ~hi_to_j
        hi_to_lo = (dphi * (hi_a - lo_a) >= 0.0) & ~hi_to_j & ~star_to_j
        lo_to_j = ~hi_to_j & ~star_to_j
        z_hi_j, z_star, z_hi_lo = zoom & hi_to_j, zoom & star_to_j, zoom & hi_to_lo
        z_rec_lo, z_lo_j = zoom & lo_to_j & ~hi_to_lo, zoom & lo_to_j
        n_rec_a = torch.where(z_hi_j | z_hi_lo, hi_a, torch.where(z_rec_lo, lo_a, rec_a))
        n_rec_phi = torch.where(z_hi_j | z_hi_lo, hi_phi, torch.where(z_rec_lo, lo_phi, rec_phi))
        n_hi_a = torch.where(z_hi_j, a, torch.where(z_hi_lo, lo_a, hi_a))
        n_hi_phi = torch.where(z_hi_j, phi, torch.where(z_hi_lo, lo_phi, hi_phi))
        n_hi_dphi = torch.where(z_hi_j, dphi, torch.where(z_hi_lo, lo_dphi, hi_dphi))
        n_lo_a = torch.where(z_lo_j, a, lo_a)
        n_lo_phi = torch.where(z_lo_j, phi, lo_phi)
        n_lo_dphi = torch.where(z_lo_j, dphi, lo_dphi)
        n_j = j + zoom.long()
        z_failed_now = z_failed_now | (n_j >= _ZOOM_MAXITER)
        zoom_end = zoom & (star_to_j | z_failed_now)

        # a zoom entered this round starts from its bracket and a star of
        # (1, phi_lo, dphi_lo, g_k), as JAX's zoom does
        e_lo_a = torch.where(enter1, a1, a)
        e_lo_phi = torch.where(enter1, phi1, phi)
        e_lo_dphi = torch.where(enter1, dphi1, dphi)
        e_hi_a = torch.where(enter1, a, a1)
        e_hi_phi = torch.where(enter1, phi, phi1)
        e_hi_dphi = torch.where(enter1, dphi, dphi1)
        lo_a = torch.where(entering, e_lo_a, n_lo_a)
        lo_phi = torch.where(entering, e_lo_phi, n_lo_phi)
        lo_dphi = torch.where(entering, e_lo_dphi, n_lo_dphi)
        hi_a = torch.where(entering, e_hi_a, n_hi_a)
        hi_phi = torch.where(entering, e_hi_phi, n_hi_phi)
        hi_dphi = torch.where(entering, e_hi_dphi, n_hi_dphi)
        rec_a = torch.where(entering, (e_lo_a + e_hi_a) / 2.0, n_rec_a)
        rec_phi = torch.where(entering, (e_lo_phi + e_hi_phi) / 2.0, n_rec_phi)
        j = torch.where(entering, 0, n_j)
        z_failed = torch.where(entering, False, torch.where(zoom, z_failed_now, z_failed))

        s_a = torch.where(b_star | z_star, a, torch.where(entering, 1.0, s_a))
        s_phi = torch.where(b_star | z_star, phi, torch.where(entering, e_lo_phi, s_phi))
        s_dphi = torch.where(b_star | z_star, dphi, torch.where(entering, e_lo_dphi, s_dphi))
        s_g = _put(b_star | z_star, gj, _put(entering, g, s_g))
        ls_failed = ls_failed | (zoom_end & z_failed_now)

        i = i + bracket.long()
        a1 = torch.where(bracket, a, a1)
        phi1 = torch.where(bracket, phi, phi1)
        dphi1 = torch.where(bracket, dphi, dphi1)
        out_of_steps = bracket & ~entering & ~to_star & (i > line_search_maxiter)
        ended = b_star | zoom_end | out_of_steps
        phase = torch.where(entering, _ZOOM, phase)

        # the BFGS update of the rows whose line search ended
        searched = b_star | zoom_end  # the search found a point (done)
        status_now = torch.where(ls_failed, 1, torch.where(i > line_search_maxiter, 3, 0))
        a_k = s_a
        if short:
            a_k = torch.where(torch.abs(a_k) < 1e-8, torch.sign(a_k) * 1e-8, a_k)
        step = a_k[:, None] * p
        y = s_g - g
        rho = 1.0 / (y * step).sum(dim=1)
        w = eye - rho[:, None, None] * (step[:, :, None] * y[:, None, :])
        H_new = (w @ H @ w.transpose(1, 2)
                 + rho[:, None, None] * (step[:, :, None] * step[:, None, :]))
        H = _put(ended & torch.isfinite(rho), H_new, H)
        old_old = torch.where(ended, f, old_old)
        x = _put(ended, x + step, x)
        f = torch.where(ended, s_phi, f)
        g = _put(ended, s_g, g)
        converged = converged | (ended & (torch.linalg.vector_norm(s_g, ord=float("inf"),
                                                                   dim=1) < gtol))
        failed = failed | (ended & (ls_failed | ~searched))
        ls_status = torch.where(ended, status_now, ls_status)
        k = k + ended.long()
        phase = torch.where(ended, _DONE, phase)
        start_search(ended & ~converged & ~failed & (k < maxiter))

    rounds = reads = 0
    while True:
        for _ in range(CHECK_EVERY):
            one_round()
        rounds += CHECK_EVERY
        reads += 1
        COUNTS["rounds"] += CHECK_EVERY
        COUNTS["host_reads"] += 1
        if not bool((phase != _DONE).any()):
            break

    status = torch.where(converged, 0, torch.where(
        k == maxiter, 1, torch.where(failed, 2 + ls_status, -1)))
    return BfgsResult(x, f, g, k, status, nfev, rounds, reads)


def scored_starts(res, z0):
    """A batched run's iterates and values with a non-finite iterate put
    back at its start and scored +inf, so that it cannot win an argmin."""
    ok = torch.isfinite(res.x).all(dim=1)
    return (torch.where(ok[:, None], res.x, z0),
            torch.where(ok & torch.isfinite(res.fun), res.fun, torch.inf))


def refined_multistart(fun, z0, maxiter, refine_maxiter, refine_gtol):
    """Every start of ``z0`` by ``minimize_bfgs`` (``maxiter``), scored by
    ``scored_starts``; the winner (the origin if every start failed) refined
    by a second run (``refine_maxiter``, ``refine_gtol``) and the refined
    point adopted where it is finite and no worse. Returns ``(zs, fs, z,
    f)`` on the device: the starts' ends and values, the adopted point and
    its value. The JAX package's fits compose the same two solves."""
    zs, fs = scored_starts(minimize_bfgs(fun, z0, maxiter=maxiter), z0)
    best = torch.argmin(fs)
    z_start = torch.where(torch.isfinite(fs[best]), zs[best], torch.zeros_like(zs[best]))
    ref = minimize_bfgs(fun, z_start[None], maxiter=refine_maxiter, gtol=refine_gtol)
    improved = (ref.fun[0] <= fs[best]) & torch.isfinite(ref.x[0]).all()
    return (zs, fs, torch.where(improved, ref.x[0], z_start),
            torch.where(improved, ref.fun[0], fs[best]))
