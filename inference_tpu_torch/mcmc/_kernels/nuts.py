"""Batched No-U-Turn sampler transition.

Port of ``inference_tpu.mcmc._kernels.nuts``: the iterative
fixed-``max_depth`` tree builder (doublings of ``2^depth`` leapfrog steps in
a uniformly drawn direction, U-turn checks of every complete dyadic subtree
against a checkpoint per level, progressive multinomial sampling within a
subtree, biased progressive sampling between subtree and trajectory, one
fresh gradient a leaf), written over a batch of ``K`` chains as the port's
``_kernels/hmc.py`` is: positions are ``(K, P)`` and every per-chain scalar
is ``(K,)``.

The JAX package runs its two ``lax.while_loop`` under ``vmap``, each until
every lane is done, with the finished lanes selected away. Here both loops
are Python loops over the batch, with each lane's own conditions kept as
masks: a lane integrates while ``i < n_leaf`` and its subtree neither turned
nor diverged, and doubles while it has not stopped (``depth < max_depth``
holds for every lane still doubling). A lane that stopped never moves again:
its leapfrog state is frozen where it stopped, so the posterior and its
gradient see no position past the stop (past a divergence such positions
grow without bound, and a posterior may raise on them).
Leaving the doubling loop when every lane has stopped costs one host read a
doubling, so at most ``max_depth - 1`` a transition. Inside a doubling, the
flag "some lane is still integrating" is copied to pinned host memory behind
an event once every ``EXIT_EVERY`` leaves and read once the event has passed,
so a doubling ends early with no host sync; on the CPU the flag is read at
every leaf.

Randomness comes from an explicit ``torch.Generator``. The draws may be
injected instead, which is how the tests replay the JAX package's key tree:
``z`` ``(K, P)`` (the momentum is ``mass_sample(z)``), ``u_dir`` and
``u_merge`` ``(K, max_depth)``, and ``u_take`` ``(K, 2**max_depth - 1)``,
leaf ``j`` of doubling ``d`` taking column ``2**d - 1 + j``. Lane k's d-th
doubling always takes lane k's own entries, whatever the other lanes do.
"""

from typing import NamedTuple

import torch

from .common import AdaptiveScale, init_adaptive_scale, submit_accept_prob, value_and_grad
from .hmc import EPS_CHK_INT, EPS_GROWTH, EPS_MAX_ADJ, EPS_MIN_ADJ, EPS_POWER, EPS_VAR_FLOOR

# step-size adaptation: NUTS targets the canonical 0.8 acceptance statistic;
# the other constants are the HMC kernel's
NUTS_EPS_TARGET = 0.8
EXIT_EVERY = 8  # leaves between the posts of the early-exit flag on the card

# batch leaves run (each a fresh gradient for all K lanes, finished lanes
# masked) and blocking host reads of the doubling loop, since the last reset
COUNTS = {"leaves": 0, "reads": 0}


class NutsState(NamedTuple):
    theta: torch.Tensor        # (K, P) current positions
    logp: torch.Tensor         # (K,) tempered log-probabilities at theta
    grad: torch.Tensor         # (K, P) tempered gradients at theta (cached, so a
                               # transition starts without re-evaluating them;
                               # tempering swaps re-scale them like logp)
    eps: AdaptiveScale         # (K,) step-size adaptation state
    divergences: torch.Tensor  # (K,) int32 cumulative divergent transitions
    inv_temp: torch.Tensor     # (K,) inverse temperatures


class NutsOutput(NamedTuple):
    theta: torch.Tensor           # (K, P)
    logp: torch.Tensor            # (K,)
    leapfrog_steps: torch.Tensor  # (K,) int32 leapfrog steps this transition
    tree_depth: torch.Tensor      # (K,) int32 doublings performed
    epsilon: torch.Tensor         # (K,) step size after this transition
    divergent: torch.Tensor       # (K,) bool: the transition hit a divergence


def init_nuts_state(theta0, logp0, epsilon, inv_temp=1.0, grad0=None) -> NutsState:
    """Batched initial state from positions ``(K, P)``, log-probabilities
    ``(K,)`` and ``grad0``, the *tempered* gradients ``inv_temp *
    d(logp)/d(theta)`` at ``theta0`` ``(K, P)``: required, since the step
    integrates from the cached value rather than re-evaluating it every
    transition."""
    if grad0 is None:
        raise ValueError(
            "init_nuts_state requires grad0 (the tempered gradient of the "
            "log-posterior at theta0)"
        )
    theta0 = torch.as_tensor(theta0)
    K = theta0.shape[0]
    like = dict(dtype=theta0.dtype, device=theta0.device)
    return NutsState(
        theta=theta0,
        logp=torch.as_tensor(logp0, **like),
        grad=torch.as_tensor(grad0, **like).reshape(theta0.shape),
        eps=init_adaptive_scale(torch.full((K,), float(epsilon), **like), EPS_CHK_INT),
        divergences=torch.zeros(K, dtype=torch.int32, device=theta0.device),
        inv_temp=torch.full((K,), float(inv_temp), **like),
    )


def value_and_grad_fn(logp_fn, grad_fn=None):
    """The untempered log-probabilities and gradients of a batch,
    ``(K, P) -> ((K,), (K, P))``. Without ``grad_fn``, ``logp_fn`` is a
    torch callable over one chain's ``(P,)``, taken by
    ``common.value_and_grad``. With ``grad_fn`` (one chain's ``(P,) ->
    (P,)`` gradient), ``logp_fn`` is a ``utils.wrap.DeviceLogp``: the
    values by its ``batched`` and the gradients row by row."""
    if grad_fn is None:
        return value_and_grad(logp_fn)
    return lambda t: (logp_fn.batched(t), torch.stack([grad_fn(row) for row in t]))


def leaf_log_weight(h0, kinetic, logp):
    """A leaf's log multinomial weight ``h0 - H``; a non-finite one is
    ``-inf`` (the JAX step's ``where(isfinite(lw), lw, -inf)``)."""
    return torch.nan_to_num(h0 - (kinetic - logp), nan=-torch.inf, posinf=-torch.inf,
                            neginf=-torch.inf)


def multinomial_take(u, lse, lw):
    """A leaf of log weight ``lw`` joins a subtree of log-sum ``lse``: the
    new log-sum, and whether the leaf becomes the subtree's candidate
    (``u < exp(lw - lse)``, progressive multinomial sampling). A leaf of
    weight ``-inf`` joining an empty subtree is not taken: ``exp(-inf -
    -inf)`` is NaN, and ``u < NaN`` is False, as in the JAX step."""
    lse = torch.logaddexp(lse, lw)
    return lse, u < torch.exp(lw - lse)


class _ExitFlag:
    """Whether some lane may still be integrating, read without a host sync:
    on the card ``post`` copies the flag to pinned host memory behind an
    event and ``none_left`` reads it once the event has passed; on the CPU
    ``post`` reads it at once."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.host = None
        self.event = None

    def post(self, flag):
        if not self.cuda:
            self.host = flag
            return
        self.host = torch.empty((), dtype=torch.bool, pin_memory=True)
        self.host.copy_(flag, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def none_left(self) -> bool:
        if self.host is None or (self.cuda and not self.event.query()):
            return False
        return not bool(self.host)


def make_nuts_step(
    logp_fn,
    grad_fn=None,
    *,
    max_depth: int = 10,
    delta_max: float = 1000.0,
    mass_velocity=None,
    mass_sample=None,
):
    """
    Build the batched single-transition NUTS step ``step(state, generator,
    z=None, u_dir=None, u_merge=None, u_take=None)``.

    :param logp_fn: untempered log-probability of one chain's ``(P,)``
        position, a torch callable or (with ``grad_fn``) a
        ``utils.wrap.DeviceLogp``.
    :param grad_fn: optional gradient of one chain, ``(P,) -> (P,)``; when
        omitted, each leaf's values and gradients come from one batched
        evaluation and its backward pass (``common.value_and_grad``, the
        torch route of every gradient-based kernel). Supply it for a user
        gradient or a posterior evaluated on the host.
    :param max_depth: maximum number of trajectory doublings (the longest
        trajectory is ``2^max_depth - 1`` leapfrog steps).
    :param delta_max: energy error beyond which a leaf is divergent and
        the trajectory stops.
    :param mass_velocity: ``r -> velocity`` map (inverse-mass application).
    :param mass_sample: ``z -> momentum`` map from standard normals.
    """
    if mass_velocity is None:
        mass_velocity = lambda r: r
    if mass_sample is None:
        mass_sample = lambda z: z
    values_and_grads = value_and_grad_fn(logp_fn, grad_fn)

    def dot(a, b):
        return (a * b).sum(dim=-1)

    def build_subtree(t, r, g, d, direction, active, epsilon, h0, inv_temp, u_leaf, exit_flag):
        """Integrate ``2^d`` leapfrog steps from ``(t, r, g)`` for the lanes
        ``active``, checking every complete dyadic subtree for a U-turn and
        drawing a multinomial candidate among the new leaves (leaf j takes
        the uniform ``u_leaf[:, j]``).

        A lane that stops (it turned or diverged, or was not active) keeps
        its position, momentum and gradient where it stopped, and the batch
        evaluates it there again. Its endpoint, candidate and log-sum are
        read only for a subtree that neither turned nor diverged (``ok`` in
        ``step``), so beyond that freeze only its flags, its acceptance sum
        and its leaf count are masked, which saves a dozen launches a
        leaf."""
        K = t.shape[0]
        like = dict(dtype=t.dtype, device=t.device)
        half = (0.5 * direction * epsilon)[:, None]
        full = (direction * epsilon)[:, None]
        v = torch.zeros_like(t)
        cand_t, cand_logp, cand_g = t, torch.full((K,), -torch.inf, **like), g
        lse = torch.full((K,), -torch.inf, **like)
        diverging = torch.zeros(K, dtype=torch.bool, device=t.device)
        accept_sum = torch.zeros(K, **like)
        n_leaves = torch.zeros(K, dtype=torch.int32, device=t.device)
        # checkpoint of each level l = 1..d: the start (position, velocity)
        # of the current dyadic subtree of 2^l leaves; level 0 is never checked
        ckpt = [None] * (d + 1)
        running = active
        for j in range(2**d):
            if exit_flag.none_left():
                break
            live = running[:, None]
            r_half = torch.addcmul(r, half, g)
            t = torch.where(live, torch.addcmul(t, full, mass_velocity(r_half)), t)
            logp, g_new = values_and_grads(t)
            logp = logp * inv_temp
            g = torch.where(live, g_new * inv_temp[:, None], g)
            r = torch.where(live, torch.addcmul(r_half, half, g), r)
            v = mass_velocity(r)
            COUNTS["leaves"] += 1

            lw = leaf_log_weight(h0, 0.5 * dot(r, v), logp)
            # progressive multinomial candidate within the subtree
            lse, take = multinomial_take(u_leaf[:, j], lse, lw)
            take = take[:, None]
            cand_t = torch.where(take, t, cand_t)
            cand_logp = torch.where(take[:, 0], logp, cand_logp)
            cand_g = torch.where(take, g, cand_g)

            # levels whose dyadic subtree completes at leaf j compare their
            # checkpoint (the subtree start) against this leaf
            stop = lw < -delta_max
            diverging = diverging | (running & stop)
            for level in range(1, d + 1):
                if (j + 1) % 2**level == 0:
                    c_t, c_v = ckpt[level]
                    dtheta = direction[:, None] * (t - c_t)
                    stop = stop | (dot(dtheta, c_v) < 0.0) | (dot(dtheta, v) < 0.0)
            # then leaf j starts every level with j % 2^l == 0 (no level a
            # leaf starts is checked at that leaf)
            for level in range(1, d + 1):
                if j % 2**level == 0:
                    ckpt[level] = (t, v)

            accept_sum = accept_sum + torch.clamp(torch.exp(lw), max=1.0) * running
            n_leaves = n_leaves + running
            running = running & ~stop
            if exit_flag.cuda and (j + 1) % EXIT_EVERY or j + 1 == 2**d:
                continue
            exit_flag.post(running.any())
        # a lane that stopped without diverging turned (one that did both
        # stops all the same)
        turning = active & ~running & ~diverging
        return t, r, v, g, cand_t, cand_logp, cand_g, lse, turning, diverging, accept_sum, n_leaves

    def step(state: NutsState, generator=None, z=None, u_dir=None, u_merge=None, u_take=None):
        K, P = state.theta.shape
        kw = dict(generator=generator, dtype=state.theta.dtype, device=state.theta.device)
        if z is None:
            z = torch.randn((K, P), **kw)
        if u_dir is None:
            u_dir = torch.rand((K, max_depth), **kw)
        if u_merge is None:
            u_merge = torch.rand((K, max_depth), **kw)
        epsilon, inv_temp = state.eps.value, state.inv_temp
        theta, logp, g0 = state.theta, state.logp, state.grad

        r0 = mass_sample(z)
        v0 = mass_velocity(r0)
        h0 = 0.5 * dot(r0, v0) - logp

        t_minus, r_minus, v_minus, g_minus = theta, r0, v0, g0
        t_plus, r_plus, v_plus, g_plus = theta, r0, v0, g0
        prop_t, prop_logp, prop_g = theta, logp, g0
        lse_traj = torch.zeros_like(logp)
        stopped = torch.zeros(K, dtype=torch.bool, device=theta.device)
        divergent = torch.zeros_like(stopped)
        accept_sum = torch.zeros_like(logp)
        n_leaves = torch.zeros(K, dtype=torch.int32, device=theta.device)
        depth = torch.zeros_like(n_leaves)

        for d in range(max_depth):
            if d > 0:
                COUNTS["reads"] += 1
                if bool(stopped.all()):  # the doubling loop's one host read
                    break
            active = ~stopped
            u_leaf = (torch.rand((K, 2**d), **kw) if u_take is None
                      else u_take[:, 2**d - 1:2 ** (d + 1) - 1])
            direction = torch.where(u_dir[:, d] < 0.5, -1.0, 1.0).to(theta.dtype)
            backward = direction < 0
            col = backward[:, None]
            (s_t, s_r, s_v, s_g, c_t, c_logp, c_g, s_lse, s_turn, s_div, s_acc,
             s_n) = build_subtree(
                torch.where(col, t_minus, t_plus), torch.where(col, r_minus, r_plus),
                torch.where(col, g_minus, g_plus), d, direction, active, epsilon, h0,
                inv_temp, u_leaf, _ExitFlag(theta.device))

            ok = active & ~s_turn & ~s_div
            # biased progressive sampling between trajectory and subtree
            take_new = ok & (u_merge[:, d] < torch.exp(s_lse - lse_traj))
            prop_t = torch.where(take_new[:, None], c_t, prop_t)
            prop_logp = torch.where(take_new, c_logp, prop_logp)
            prop_g = torch.where(take_new[:, None], c_g, prop_g)
            lse_traj = torch.where(ok, torch.logaddexp(lse_traj, s_lse), lse_traj)

            # endpoints move only when the subtree is kept
            grow_minus = (ok & backward)[:, None]
            grow_plus = (ok & ~backward)[:, None]
            t_minus = torch.where(grow_minus, s_t, t_minus)
            r_minus = torch.where(grow_minus, s_r, r_minus)
            v_minus = torch.where(grow_minus, s_v, v_minus)
            g_minus = torch.where(grow_minus, s_g, g_minus)
            t_plus = torch.where(grow_plus, s_t, t_plus)
            r_plus = torch.where(grow_plus, s_r, r_plus)
            v_plus = torch.where(grow_plus, s_v, v_plus)
            g_plus = torch.where(grow_plus, s_g, g_plus)

            # whole-trajectory U-turn check on the merged endpoints
            dtheta = t_plus - t_minus
            turn_traj = (dot(dtheta, v_minus) < 0.0) | (dot(dtheta, v_plus) < 0.0)
            stopped = torch.where(active, s_turn | s_div | turn_traj, stopped)
            divergent = divergent | (active & s_div)
            accept_sum = accept_sum + s_acc
            n_leaves = n_leaves + s_n
            depth = depth + active.to(torch.int32)

        mean_accept = accept_sum / torch.clamp(n_leaves.to(theta.dtype), min=1.0)
        eps = submit_accept_prob(
            state.eps,
            mean_accept,
            target=NUTS_EPS_TARGET,
            growth_factor=EPS_GROWTH,
            adjust_power=EPS_POWER,
            adjust_min=EPS_MIN_ADJ,
            adjust_max=EPS_MAX_ADJ,
            var_floor=EPS_VAR_FLOOR,
        )
        new_state = NutsState(
            theta=prop_t,
            logp=prop_logp,
            grad=prop_g,
            eps=eps,
            divergences=state.divergences + divergent.to(torch.int32),
            inv_temp=state.inv_temp,
        )
        return new_state, NutsOutput(prop_t, prop_logp, n_leaves, depth, eps.value, divergent)

    return step


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
        like = dict(device=state.theta.device)
        empty = lambda *shape, dtype=state.theta.dtype: torch.empty(shape, dtype=dtype, **like)
        return state, NutsOutput(
            empty(0, K, P), empty(0, K), empty(0, K, dtype=torch.int32),
            empty(0, K, dtype=torch.int32), empty(0, K), empty(0, K, dtype=torch.bool),
        )
    return state, NutsOutput(*(torch.stack(f) for f in zip(*outs)))
