"""Batched Hamiltonian Monte-Carlo transition.

Port of ``inference_tpu.mcmc._kernels.hmc``. Where the JAX package writes
one chain's step and vmaps it, this step is written over a batch of ``K``
chains at once: positions are ``(K, P)`` and every per-chain scalar is
``(K,)``.

- The leapfrog runs as a Python loop to the batch's largest jittered step
  count ``n = int(steps * (1 + (U - 0.5) * 0.2))``, with each chain masked
  once its own count is done (the per-proposal count is data-dependent).
  A count of zero is raised to one, which is what the JAX step takes.
- With ``retry=True`` the repeat-until-accept loop is a host loop over the
  chains that have not accepted yet, for at most ``max_attempts`` trips.
- Randomness comes from an explicit ``torch.Generator``. The standard
  normals ``z`` and the uniforms ``u_steps``/``u_acc`` may be passed in
  instead: ``(K, P)`` and ``(K,)`` for the one proposal of ``retry=False``,
  which is how the tests drive this step and the JAX package with the same
  numbers; with ``retry=True`` a leading axis of attempts, ``(A, K, P)``
  and ``(A, K)``, chain k's a-th proposal taking entry ``[a, k]``.
"""

from typing import NamedTuple

import torch

from .common import AdaptiveScale, init_adaptive_scale, submit_accept_prob

# epsilon adaptation constants (reference: hmc/epsilon.py:18-25,41-43)
EPS_TARGET = 0.65
EPS_CHK_INT = 15
EPS_GROWTH = 1.4
EPS_VAR_FLOOR = 0.03
EPS_POWER = 0.15
EPS_MIN_ADJ = 0.5
EPS_MAX_ADJ = 2.0


class HmcState(NamedTuple):
    theta: torch.Tensor       # (K, P) current positions
    logp: torch.Tensor        # (K,) tempered log-probabilities at theta
    eps: AdaptiveScale        # (K,) step-size adaptation state
    failed: torch.Tensor      # (K,) bool: max_attempts exhausted at some step
    inv_temp: torch.Tensor    # (K,) inverse temperatures
    steps: torch.Tensor       # (K,) int32 nominal leapfrog steps


class HmcOutput(NamedTuple):
    theta: torch.Tensor           # (K, P)
    logp: torch.Tensor            # (K,)
    leapfrog_steps: torch.Tensor  # (K,) int32 leapfrog steps this transition
    epsilon: torch.Tensor         # (K,) step size after this transition


def init_hmc_state(theta0, logp0, epsilon, inv_temp=1.0, steps=50) -> HmcState:
    """Batched initial state from positions ``(K, P)`` and log-probabilities
    ``(K,)``."""
    theta0 = torch.as_tensor(theta0)
    K = theta0.shape[0]
    like = dict(dtype=theta0.dtype, device=theta0.device)
    return HmcState(
        theta=theta0,
        logp=torch.as_tensor(logp0, **like),
        eps=init_adaptive_scale(torch.full((K,), float(epsilon), **like), EPS_CHK_INT),
        failed=torch.zeros(K, dtype=torch.bool, device=theta0.device),
        inv_temp=torch.full((K,), float(inv_temp), **like),
        steps=torch.full((K,), int(steps), dtype=torch.int32, device=theta0.device),
    )


def make_hmc_step(
    logp_fn,
    grad_fn,
    *,
    max_attempts: int = 200,
    mass_velocity=None,
    mass_sample=None,
    bounds_reflect=None,
    retry: bool = True,
):
    """
    Build the batched single-transition HMC step
    ``step(state, generator, z=None, u_steps=None, u_acc=None)``.

    :param logp_fn: batched ``(K, P) -> (K,)`` untempered log-probability.
    :param grad_fn: batched ``(K, P) -> (K, P)`` gradient of ``logp_fn``.
    :param max_attempts: proposal retries before flagging failure.
    :param mass_velocity: ``r -> velocity`` map (inverse-mass application).
    :param mass_sample: ``z -> momentum`` map from standard normals.
    :param bounds_reflect: optional batched ``theta -> (theta,
        reflections)`` map (``Bounds.reflect_momenta``) for the bounded
        leapfrog: after each drift the positions are reflected into the
        bounds and the momenta multiplied by the returned +-1.
    :param retry: repeat-until-accept proposals when True; the textbook
        duplicate-on-reject MH transition when False.
    """
    if mass_velocity is None:
        mass_velocity = lambda r: r
    if mass_sample is None:
        mass_sample = lambda z: z

    def kinetic_energy(r):
        return 0.5 * (r * mass_velocity(r)).sum(dim=-1)

    def leapfrog(t, r, n_steps, epsilon, inv_temp):
        r_step = (inv_temp * epsilon)[:, None]
        eps_col = epsilon[:, None]
        half = torch.full_like(epsilon, 0.5)
        one = torch.ones_like(epsilon)
        r = r + (0.5 * r_step) * grad_fn(t)
        for i in range(int(n_steps.max())):
            active = (i < n_steps)[:, None]
            kick = torch.where(i == n_steps - 1, half, one)[:, None]
            t2 = t + eps_col * mass_velocity(r)
            r2 = r
            if bounds_reflect is not None:
                t2, reflections = bounds_reflect(t2)
                r2 = r2 * reflections
            r2 = r2 + (kick * r_step) * grad_fn(t2)
            t = torch.where(active, t2, t)
            r = torch.where(active, r2, r)
        return t, r

    def propose(theta, logp, eps, inv_temp, steps, z, u_steps, u_acc):
        """One proposal for every chain of the (sub)batch."""
        r0 = mass_sample(z)
        h0 = kinetic_energy(r0) - logp
        n_steps = (steps.to(theta.dtype) * (1 + (u_steps - 0.5) * 0.2)).to(torch.int32)
        n_steps = torch.clamp(n_steps, min=1)

        t, r = leapfrog(theta, r0, n_steps, eps.value, inv_temp)

        p = logp_fn(t) * inv_temp
        h = kinetic_energy(r) - p
        accept_prob = torch.exp(h0 - h)
        submitted = torch.where(
            torch.isfinite(accept_prob),
            torch.clamp(accept_prob, max=1.0),
            torch.zeros_like(accept_prob),
        )
        eps = submit_accept_prob(
            eps,
            submitted,
            target=EPS_TARGET,
            growth_factor=EPS_GROWTH,
            adjust_power=EPS_POWER,
            adjust_min=EPS_MIN_ADJ,
            adjust_max=EPS_MAX_ADJ,
            var_floor=EPS_VAR_FLOOR,
        )
        accepted = (accept_prob >= 1.0) | (u_acc <= accept_prob)
        return t, p, eps, accepted, n_steps

    def draws(generator, like, m, P, z=None, u_steps=None, u_acc=None):
        kw = dict(generator=generator, dtype=like.dtype, device=like.device)
        if z is None:
            z = torch.randn((m, P), **kw)
        if u_steps is None:
            u_steps = torch.rand((m,), **kw)
        if u_acc is None:
            u_acc = torch.rand((m,), **kw)
        return z, u_steps, u_acc

    def step(state: HmcState, generator=None, z=None, u_steps=None, u_acc=None):
        K, P = state.theta.shape
        if not retry:
            z, u_steps, u_acc = draws(
                generator, state.theta, K, P, z, u_steps, u_acc
            )
            t, p, eps, accepted, n_steps = propose(
                state.theta, state.logp, state.eps, state.inv_temp,
                state.steps, z, u_steps, u_acc,
            )
            # duplicate-on-reject: a rejected proposal is a valid MH
            # transition, not a failure
            theta = torch.where(accepted[:, None], t, state.theta)
            logp = torch.where(accepted, p, state.logp)
            new_state = state._replace(theta=theta, logp=logp, eps=eps)
            return new_state, HmcOutput(theta, logp, n_steps, eps.value)

        for x, ndim in ((z, 3), (u_steps, 2), (u_acc, 2)):
            if x is not None and x.ndim != ndim:
                raise ValueError(
                    "injected draws without a leading axis of attempts drive a single "
                    "proposal: use retry=False, or pass (A, K, P) and (A, K) streams"
                )
        theta, logp, eps = state.theta.clone(), state.logp.clone(), state.eps
        steps_taken = torch.zeros(K, dtype=torch.int32, device=theta.device)
        pending = torch.arange(K, device=theta.device)
        for a in range(max_attempts):
            injected = (_attempt(x, a, pending) for x in (z, u_steps, u_acc))
            z_a, us_a, ua_a = draws(generator, theta, pending.numel(), P, *injected)
            t, p, sub_eps, accepted, n_steps = propose(
                state.theta[pending], state.logp[pending],
                AdaptiveScale(*(f[pending] for f in eps)),
                state.inv_temp[pending], state.steps[pending],
                z_a, us_a, ua_a,
            )
            eps = AdaptiveScale(
                *(f.index_copy(0, pending, g) for f, g in zip(eps, sub_eps))
            )
            steps_taken[pending] += n_steps
            won = pending[accepted]
            theta[won] = t[accepted]
            logp[won] = p[accepted]
            pending = pending[~accepted]
            if pending.numel() == 0:
                break
        failed = state.failed.clone()
        failed[pending] = True
        new_state = state._replace(theta=theta, logp=logp, eps=eps, failed=failed)
        return new_state, HmcOutput(theta, logp, steps_taken, eps.value)

    return step


def _attempt(stream, a, pending):
    """Attempt ``a``'s entries of an injected ``(A, K, ...)`` stream for the
    chains ``pending``."""
    if stream is None:
        return None
    if a >= stream.shape[0]:
        raise ValueError(
            f"an injected stream of {stream.shape[0]} attempts ran out: a chain "
            "proposed more often than the stream holds"
        )
    return stream[a][pending]


def run_steps(step, state, n_steps: int, store: bool = True, generator=None):
    """Run ``step`` for ``n_steps`` transitions. With ``store`` the per-step
    outputs are stacked to ``(n_steps, K, ...)``; without it only the final
    state is kept and the second result is None."""
    outs = []
    for _ in range(n_steps):
        state, out = step(state, generator)
        if store:
            outs.append(out)
    if not store:
        return state, None
    if not outs:
        K, P = state.theta.shape
        empty = lambda *shape, dtype=state.theta.dtype: torch.empty(
            shape, dtype=dtype, device=state.theta.device
        )
        return state, HmcOutput(
            empty(0, K, P), empty(0, K), empty(0, K, dtype=torch.int32), empty(0, K)
        )
    return state, HmcOutput(*(torch.stack(f) for f in zip(*outs)))
