"""Preconditioned conjugate gradients: the solvers of the matrix-free GP
tiers.

Port of ``inference_tpu.ops.solvers`` and of the one library solver the JAX
package calls:

- ``cg``: plain preconditioned CG, ``jax.scipy.sparse.linalg.cg`` step for
  step (its recursive residual, its scalars in the vector dtype, its stopping
  rule), for ``solver="cg"``;
- ``mixed_pcg`` and ``pcg_multi``: restarted PCG with float64 scalar
  recurrences and a true residual every ``restart_every`` iterations, for
  one right-hand side (``solver="mixed"``) and a block of them (predictive
  variances, ``fit()``);
- ``Df64MultiSolver``, ``Df64Solver`` and ``df64_pcg``: float64 iterates
  over a float32-direction operator, for ``solver="df64"``.

Every loop is a plain Python loop of torch operations (nothing is
compiled) with one host read of its stopping test a trip; the arithmetic
is the JAX package's. Its watchdog-sized chunk length
(``df64_chunk_iters``) is not ported: a GPU has no dispatch watchdog, so
callers pass ``restart_every`` (the tiers use 50, the length the JAX policy
gives at test sizes).
"""

import numpy as np
import torch


def _colsum(U, V):
    return (U * V).sum(dim=0)


def _identity(v):
    return v


def cg(matvec, b, M=None, tol=1e-5, atol=0.0, maxiter=None):
    """Solve ``A x = b`` (A symmetric positive-definite, applied by
    ``matvec``) by preconditioned CG from ``x = 0``, as
    ``jax.scipy.sparse.linalg.cg`` does: the residual by recursion, every
    scalar in ``b``'s dtype, and the loop runs while ``rs > max(tol^2 b.b,
    atol^2)`` and fewer than ``maxiter`` iterations (default ``10 n``) have
    run, ``rs`` being ``gamma = r.z`` without a preconditioner and ``r.r``
    with one. The first residual is ``b`` itself (the JAX function's ``b -
    A 0``, without the product).

    Returns ``(x, iterations)``: the JAX function returns no count, so the
    second value is the port's own."""
    if maxiter is None:
        maxiter = 10 * b.numel()
    preconditioned = M is not None
    M = _identity if M is None else M
    dot = lambda u, v: (u * v).sum()
    atol2 = torch.clamp(tol**2 * dot(b, b), min=atol**2)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    gamma = dot(r, z).to(p.dtype)
    k = 0
    while k < maxiter and bool((dot(r, r) if preconditioned else gamma) > atol2):
        Ap = matvec(p)
        alpha = gamma / dot(p, Ap).to(p.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = dot(r, z).to(p.dtype)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


def mixed_pcg(matvec, b, M=None, tol=1e-6, maxiter=1000, restart_every=50):
    """Solve ``A x = b`` (A symmetric positive-definite, applied by
    ``matvec``) by preconditioned CG with float64 scalar recurrences and a
    true residual ``b - A x`` every ``restart_every`` iterations, after
    which the direction restarts from steepest descent (the float32
    recurrence's direction is no longer conjugate to the fresh residual).
    Vectors stay in ``b``'s dtype. A non-positive ``p.Ap`` (total loss of
    precision) stops the loop with the current iterate.

    Returns ``(x, info)``: ``info = 0`` on convergence, else the iteration
    count."""
    M = _identity if M is None else M
    vdtype = b.dtype
    dot64 = lambda u, v: (u.double() * v.double()).sum()
    atol2 = (tol * torch.sqrt(dot64(b, b))) ** 2
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = dot64(r, z)
    rr = dot64(r, r)
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    i = 0
    while i < maxiter and bool(ok & (rr > atol2)):
        Ap = matvec(p)
        pAp = dot64(p, Ap)
        ok = ok & (pAp > 0.0)
        alpha = torch.where(pAp > 0.0, rz / pAp, 0.0).to(vdtype)
        x = x + alpha * p
        restart = (i % restart_every) == (restart_every - 1)
        r = b - matvec(x) if restart else r - alpha * Ap
        z = M(r)
        rz_new = dot64(r, z)
        rr = dot64(r, r)
        if restart:
            beta = torch.zeros_like(rz)
        else:
            beta = torch.where(rz != 0.0, rz_new / rz, 0.0)
        p = z + beta.to(vdtype) * p
        rz = rz_new
        i += 1
    info = 0 if bool(dot64(r, r) <= atol2) else i
    return x, info


def pcg_multi(matvec, B, M=None, tol=1e-6, maxiter=1000, restart_every=50):
    """Preconditioned CG over the columns of ``B`` (n, q) at once: each
    iteration applies one shared ``matvec(P)`` to all q systems. Scalar
    recurrences are per column and float64; a column freezes once its
    residual is below ``tol`` of its right-hand side or its ``p.Ap`` turns
    non-positive. The true residual ``B - A X`` is recomputed every
    ``restart_every`` iterations with the directions reset to steepest
    descent, as in ``mixed_pcg``.

    Returns ``(X, iterations)``."""
    M = _identity if M is None else M
    dtype = B.dtype
    colsum = lambda U, V: (U.double() * V.double()).sum(dim=0)
    atol2 = (tol**2) * colsum(B, B)
    X = torch.zeros_like(B)
    R = B
    Z = M(R)
    P = Z
    rz = colsum(R, Z)
    active = colsum(R, R) > atol2
    i = 0
    while i < maxiter and bool(active.any()):
        AP = matvec(P)
        pAp = colsum(P, AP)
        ok = active & (pAp > 0.0)
        alpha = torch.where(ok, rz / torch.where(pAp > 0.0, pAp, 1.0), 0.0)
        X = X + alpha[None, :].to(dtype) * P
        restart = (i % restart_every) == (restart_every - 1)
        R = B - matvec(X) if restart else R - alpha[None, :].to(dtype) * AP
        Z = M(R)
        rz_new = colsum(R, Z)
        active = ok & (colsum(R, R) > atol2)
        if restart:
            beta = torch.zeros_like(rz)
        else:
            beta = torch.where(active & (rz != 0.0), rz_new / torch.where(rz != 0.0, rz, 1.0), 0.0)
        P = Z + beta[None, :].to(dtype) * P
        rz = rz_new
        i += 1
    return X, i


class Df64MultiSolver:
    """
    Chunked preconditioned CG over a (n, q) block of systems, with float64
    iterate and residual vectors and per-column float64 scalar recurrences,
    through a ``matmat64`` operator that maps a float32 (n, q) block to the
    float64 result of ``A V`` (e.g. ``ops.df64.sqexp_matmat_df64`` plus
    diagonal terms). A column whose pAp turns non-positive freezes (its ok
    flag drops) while the others iterate; the host loop stops when every
    column has converged or is frozen.

    - Search directions are applied in float32 (a direction needs only
      float32 relative accuracy); everything else is float64.
    - Each chunk of ``restart_every`` iterations ends with a true residual
      ``B - A X_hi - A X_lo`` (X split into a float32 pair), so the
      recurrence never drifts beyond the operator's own accuracy. The
      direction carries across the refresh: it is a perturbation of one
      Krylov process, not a restart.
    - The preconditioner ``M`` receives the float64 residual and its result
      is used in float64 (a Woodbury application at sigma ~ 1e-2 cancels
      about eight digits).
    - ``matmat_fast``, when given, runs the iteration products while
      ``matmat64`` anchors the refreshes: mixed-precision iterative
      refinement, each chunk a short inner solve on the cheaper operator
      (the float32 entry store of ``store_entries="f32"``, kernel B8) that
      restarts from steepest descent after its refresh.
    """

    def __init__(
        self,
        matmat64,
        M=None,
        M_args=(),
        matmat_args=(),
        restart_every: int = 50,
        matmat_fast=None,
        matmat_fast_args=(),
        _label: str = "Df64MultiSolver",
    ):
        """``matmat64(V, *matmat_args)`` maps a float32 (n, q) block to
        the float64 (n, q) ``A V``; ``M(R, *M_args)`` applies the
        preconditioner to the float64 residual block. ``matmat_fast(V,
        *matmat_fast_args)`` is a cheaper application of (an approximation
        of) the same operator for the iterations; the refreshes always go
        through ``matmat64``."""
        self._label = _label
        self.matmat64 = matmat64
        self.M = M if M is not None else (lambda V: V)
        self.M_args = tuple(M_args)
        self.matmat_args = tuple(matmat_args)
        self.matmat_fast = matmat_fast
        self.matmat_fast_args = tuple(matmat_fast_args)
        self.restart_every = int(restart_every)
        self.chunks_run = 0

    def _chunk(self, B64, X, R, Z, P, rz, ok, M_args, mm_args, fast_args):
        """``restart_every`` PCG iterations, then the true-residual refresh.
        Returns ``(X, R, Z, P, rz, ok, rr)``."""
        f64 = torch.float64
        M = lambda V: self.M(V, *M_args)
        matmat64 = lambda V: self.matmat64(V, *mm_args)
        fast = self.matmat_fast
        matmat_iter = matmat64 if fast is None else (lambda V: fast(V, *fast_args))
        for _ in range(self.restart_every):
            P32 = P.float()
            AP = matmat_iter(P32)
            P_applied = P32.to(f64)
            pAp = _colsum(P_applied, AP)
            # per-column breakdown latch
            ok = ok & (pAp > 0.0)
            alpha = torch.where(ok, rz / torch.where(pAp > 0.0, pAp, 1.0), 0.0)
            X = X + alpha[None, :] * P_applied
            R = R - alpha[None, :] * AP
            Z = M(R).to(f64)
            rz_new = _colsum(R, Z)
            beta = torch.where(ok & (rz != 0.0), rz_new / torch.where(rz != 0.0, rz, 1.0), 0.0)
            P = Z + beta[None, :] * P
            rz = rz_new
        Xh = X.float()
        Xl = (X - Xh.to(f64)).float()
        if fast is None:
            R = B64 - matmat64(Xh) - matmat64(Xl)
        else:
            # the low split word rides the fast operator: its relative error
            # on |Xl| ~ eps32 |X| is far below the accurate operator's floor
            R = B64 - matmat64(Xh) - matmat_iter(Xl)
        Z = M(R).to(f64)
        rz = _colsum(R, Z)
        rr = _colsum(R, R)
        if fast is not None:
            # iterations ran on the fast operator: restart steepest descent
            P = Z
        return X, R, Z, P, rz, ok, rr

    def solve(self, B64, tol=1e-10, maxiter=2000, verbose=False):
        """Returns ``(X, info)`` with float64 (n, q) ``X``; ``info = 0``
        when every column converged, else the iteration count reached.

        The host loop's safeguard (the JAX package's, measured there at
        N = 50,000, sigma = 0.01): each column keeps its best state. A
        troubled chunk (the pAp latch fired, the residual went non-finite,
        or it grew 1000x in norm past the best) restores the column to its
        best state when worse and resets it to steepest descent; two
        consecutive setbacks without progress freeze it. The returned ``X``
        is every column's best iterate."""
        B64 = torch.as_tensor(B64).to(torch.float64)
        bb = _colsum(B64, B64)
        bb_host = bb.cpu().numpy()
        atol2 = (float(tol) ** 2) * bb_host
        X = torch.zeros_like(B64)
        R = B64
        Z = self.M(R, *self.M_args).to(torch.float64)
        P = Z
        rz = _colsum(R, Z)
        q = B64.shape[1]
        ok = torch.ones(q, dtype=torch.bool, device=B64.device)
        done = 0
        rr_host = bb_host
        # right-hand sides that are already converged (zero columns, a
        # refine round whose predecessor finished) run no chunk
        if np.all(rr_host <= atol2):
            return X, 0
        best = {"X": X, "R": R, "Z": Z, "rz": rz, "rr": rr_host.copy()}
        setbacks = np.zeros(q, np.int32)
        frozen = np.zeros(q, bool)
        on = lambda mask: torch.as_tensor(mask, device=B64.device)
        while done < maxiter:
            X, R, Z, P, rz, ok, rr = self._chunk(
                B64, X, R, Z, P, rz, ok, self.M_args, self.matmat_args, self.matmat_fast_args
            )
            self.chunks_run += 1
            done += self.restart_every
            rr_host = rr.cpu().numpy()
            ok_host = ok.cpu().numpy()
            finite = np.isfinite(rr_host)
            improved = finite & (rr_host < best["rr"])
            if improved.any():
                sel = on(improved)
                best["X"] = torch.where(sel[None, :], X, best["X"])
                best["R"] = torch.where(sel[None, :], R, best["R"])
                best["Z"] = torch.where(sel[None, :], Z, best["Z"])
                best["rz"] = torch.where(sel, rz, best["rz"])
                best["rr"] = np.where(improved, rr_host, best["rr"])
            converged = best["rr"] <= atol2
            # frozen columns no longer iterate: their cleared ok flag is not
            # a new breakdown
            trouble = ~converged & ~frozen & (
                ~ok_host | ~finite | (rr_host > 1e6 * np.maximum(best["rr"], atol2))
            )
            setbacks = np.where(improved, 0, setbacks + trouble)
            frozen |= setbacks >= 2
            if trouble.any():
                worse = trouble & (~finite | (rr_host > best["rr"]))
                sel = on(worse)
                X = torch.where(sel[None, :], best["X"], X)
                R = torch.where(sel[None, :], best["R"], R)
                Z = torch.where(sel[None, :], best["Z"], Z)
                rz = torch.where(sel, best["rz"], rz)
                # steepest descent for every troubled column
                P = torch.where(on(trouble)[None, :], Z, P)
                rr_host = np.where(worse, best["rr"], rr_host)
                if verbose:
                    print(f"  [ {self._label}: iteration {done}, {int(trouble.sum())} "
                          f"column(s) troubled (breakdown/divergence) — reset, "
                          f"{int(frozen.sum())} frozen ]", flush=True)
            # a latched column that is not frozen resumes
            ok = on(~frozen & ~converged)
            if verbose:
                rel = np.sqrt(rr_host / np.where(atol2 > 0, bb_host, 1.0))
                print(f"  [ {self._label}: iteration {done}, worst relative "
                      f"residual {rel.max():.3e} ]", flush=True)
            if np.all(converged | frozen):
                break
        final_rr = np.minimum(rr_host, best["rr"])
        X = torch.where(on(best["rr"] <= rr_host)[None, :], best["X"], X)
        info = 0 if np.all(final_rr <= atol2) else min(done, maxiter)
        return X, info


class Df64Solver:
    """Single right-hand-side form of ``Df64MultiSolver``: its ``q = 1``
    column block, so the chunked-PCG logic exists once. ``matvec64(v,
    *matvec_args)`` maps a float32 vector to the float64 ``A v``;
    ``M(r, *M_args)`` applies the preconditioner to the float64 residual."""

    def __init__(
        self,
        matvec64,
        M=None,
        M_args=(),
        matvec_args=(),
        restart_every: int = 50,
        matvec_fast=None,
        matvec_fast_args=(),
    ):
        column = lambda f: (lambda V, *args: f(V[:, 0], *args)[:, None])
        self._multi = Df64MultiSolver(
            column(matvec64),
            M=None if M is None else column(M),
            M_args=M_args,
            matmat_args=matvec_args,
            restart_every=restart_every,
            matmat_fast=None if matvec_fast is None else column(matvec_fast),
            matmat_fast_args=matvec_fast_args,
            _label="Df64Solver",
        )
        self.restart_every = self._multi.restart_every

    def solve(self, b64, tol=1e-10, maxiter=2000, verbose=False):
        """Returns ``(x, info)`` with float64 ``x``; ``info = 0`` on
        convergence, else the iteration count reached (chunk granularity,
        capped at ``maxiter``)."""
        b64 = torch.as_tensor(b64).to(torch.float64)
        X, info = self._multi.solve(b64[:, None], tol=tol, maxiter=maxiter, verbose=verbose)
        return X[:, 0], info


def df64_pcg(matvec64, b64, M=None, tol=1e-10, maxiter=2000, restart_every=50):
    """Functional form of ``Df64Solver``."""
    return Df64Solver(matvec64, M=M, restart_every=restart_every).solve(
        b64, tol=tol, maxiter=maxiter
    )
