"""Batched affine-invariant ensemble (Goodman & Weare stretch-move) transition.

Port of ``inference_tpu.mcmc._kernels.ensemble``. Where the JAX package
writes one ensemble's step and vmaps it over ensembles, this step is
written over a batch of ``C`` ensembles of ``W`` walkers at once: walkers
are ``(C, W, P)``, their tempered log-probabilities ``(C, W)`` and the
inverse temperatures ``(C,)``. ``EnsembleSampler`` runs it with C = 1,
``ChainArray("ensemble")`` with one ensemble per chain.

- The update is the red/black half-ensemble variant: the first ``W // 2``
  walkers of each ensemble move against partners from the rest, then the
  rest against the updated first half. The stretch is ``z = 0.5 * (x_lwr
  + x_width * U)^2`` on [1/alpha, alpha].
- With ``retry=True`` each walker re-proposes until it accepts, for at
  most ``max_attempts`` proposals, as the JAX ``lax.while_loop`` does. Each
  attempt works on the walkers still pending only and reads the host once
  (the indices of the walkers that go on). Walkers that exhaust the
  attempts keep their position and count as failures. With ``retry=False``
  each walker makes one proposal, a rejection keeps its position, and the
  step reads nothing back to the host.
- Randomness comes from an explicit ``torch.Generator``. The draws may be
  passed in instead, per half: the partner indices ``j``, the stretch
  uniforms and the acceptance uniforms, each ``(A, C, h)`` for ``A``
  attempts of the ``h`` walkers of that half. A walker that makes its
  ``a``-th proposal takes entry ``a`` of its own column, which is the order
  in which the JAX kernel draws (``split(key, 3)`` for the two halves, then
  ``split(k, 4)`` for every attempt). That is how the tests drive this step
  and the JAX package with the same numbers.
"""

from typing import NamedTuple

import torch


class EnsembleState(NamedTuple):
    walkers: torch.Tensor   # (C, W, P) positions
    logps: torch.Tensor     # (C, W) tempered log-probabilities
    inv_temp: torch.Tensor  # (C,) inverse temperatures


class EnsembleOutput(NamedTuple):
    walkers: torch.Tensor   # (C, W, P)
    logps: torch.Tensor     # (C, W)
    attempts: torch.Tensor  # (C, W) int32 proposals made this iteration
    failures: torch.Tensor  # (C,) int32 walkers that exhausted max_attempts


def _sel(rows):
    return slice(None) if rows is None else rows


def init_ensemble_state(walkers, logps, inv_temp=1.0) -> EnsembleState:
    """Batched initial state from walkers ``(C, W, P)`` and their
    log-probabilities ``(C, W)``."""
    walkers = torch.as_tensor(walkers)
    like = dict(dtype=walkers.dtype, device=walkers.device)
    return EnsembleState(
        walkers=walkers,
        logps=torch.as_tensor(logps, **like),
        inv_temp=torch.full((walkers.shape[0],), float(inv_temp), **like),
    )


def make_ensemble_step(
    logp_fn,
    *,
    n_walkers: int,
    alpha: float = 2.0,
    max_attempts: int = 100,
    bounds_reflect=None,
    retry: bool = True,
):
    """
    Build the batched one-iteration update (every walker refreshed once):
    ``step(state, generator=None, draws=None)``.

    :param logp_fn: batched ``(M, P) -> (M,)`` untempered log-probability.
    :param bounds_reflect: optional ``theta -> theta`` map over ``(..., P)``
        (``Bounds.reflect``) applied to every proposal.
    :param retry: repeat-until-accept walker updates (the reference
        semantics) when True; one stretch move a walker, a rejection
        keeping its position, when False.
    :param draws: injected draws, one ``(j, u_stretch, u_accept)`` triple
        per half, each ``(A, C, h)``; with ``retry=False`` A = 1 is enough.
    """
    x_lwr = (2.0 / alpha) ** 0.5
    x_width = (2.0 * alpha) ** 0.5 - x_lwr
    half = n_walkers // 2

    def take(injected, a, pending, m, n_anchor, generator, like):
        """The partner indices and the two uniforms of attempt ``a`` for
        the ``m`` walkers ``pending`` (flat indices into ``(C, h)``, None
        for every walker)."""
        if injected is None:
            kw = dict(generator=generator, device=like.device)
            return (torch.randint(0, n_anchor, (m,), **kw),
                    torch.rand((m,), dtype=like.dtype, **kw),
                    torch.rand((m,), dtype=like.dtype, **kw))
        if a >= injected[0].shape[0]:
            raise ValueError(
                f"an injected stream of {injected[0].shape[0]} attempts ran out: a walker "
                "proposed more often than the stream holds"
            )
        return tuple(x[a].reshape(-1).to(like.device)[_sel(pending)] for x in injected)

    def update_half(movers, mover_logps, anchors, inv_temp, generator, injected):
        """Stretch moves of ``movers`` ``(C, h, P)`` against partners from
        ``anchors`` ``(C, n, P)``."""
        C, h, P = movers.shape
        n_anchor = anchors.shape[1]
        flat = movers.reshape(C * h, P).clone()
        logps = mover_logps.reshape(C * h).clone()
        attempts = torch.zeros(C * h, dtype=torch.int32, device=movers.device)
        owner = torch.arange(C, device=movers.device).repeat_interleave(h)
        it = inv_temp[owner]
        pending = None  # every walker
        for a in range(max_attempts if retry else 1):
            sel = _sel(pending)
            m = C * h if pending is None else pending.numel()
            j, u_z, u_acc = take(injected, a, pending, m, n_anchor, generator, movers)
            partners = anchors[owner[sel], j.long()]
            z = 0.5 * (x_lwr + x_width * u_z) ** 2
            # stretch move Y = X_j + z (X_k - X_j)
            prop = partners + z[:, None] * (flat[sel] - partners)
            if bounds_reflect is not None:
                prop = bounds_reflect(prop)
            p = logp_fn(prop) * it[sel]
            log_q = (P - 1) * torch.log(z) + p - logps[sel]
            accept = u_acc <= torch.exp(log_q)
            flat[sel] = torch.where(accept[:, None], prop, flat[sel])
            logps[sel] = torch.where(accept, p, logps[sel])
            attempts[sel] += 1
            if not retry:
                break
            rest = torch.nonzero(~accept).squeeze(1)  # the attempt's one host read
            pending = rest if pending is None else pending[rest]
            if pending.numel() == 0:
                break
        failures = torch.zeros(C, dtype=torch.int32, device=movers.device)
        if retry and pending is not None and pending.numel():
            failures.index_add_(0, owner[pending], torch.ones_like(pending, dtype=torch.int32))
        return flat.reshape(C, h, P), logps.reshape(C, h), attempts.reshape(C, h), failures

    def step(state: EnsembleState, generator=None, draws=None):
        walkers, logps, inv_temp = state.walkers, state.logps, state.inv_temp
        injected = (None, None) if draws is None else draws
        first, lp_first, att_a, fail_a = update_half(
            walkers[:, :half], logps[:, :half], walkers[:, half:], inv_temp, generator,
            injected[0],
        )
        second, lp_second, att_b, fail_b = update_half(
            walkers[:, half:], logps[:, half:], first, inv_temp, generator, injected[1],
        )
        walkers = torch.cat([first, second], dim=1)
        logps = torch.cat([lp_first, lp_second], dim=1)
        out = EnsembleOutput(walkers, logps, torch.cat([att_a, att_b], dim=1), fail_a + fail_b)
        return state._replace(walkers=walkers, logps=logps), out

    return step


def run_steps(step, state, n_steps: int, store: bool = True, generator=None):
    """Run ``step`` for ``n_steps`` iterations. With ``store`` the outputs
    are stacked to ``(n_steps, C, ...)``; without it only the final state is
    kept and the second result is None."""
    outs = []
    for _ in range(n_steps):
        state, out = step(state, generator)
        if store:
            outs.append(out)
    if not store:
        return state, None
    if not outs:
        C, W, P = state.walkers.shape
        like = dict(dtype=state.walkers.dtype, device=state.walkers.device)
        ints = dict(dtype=torch.int32, device=state.walkers.device)
        return state, EnsembleOutput(torch.empty((0, C, W, P), **like),
                                     torch.empty((0, C, W), **like),
                                     torch.empty((0, C, W), **ints),
                                     torch.empty((0, C), **ints))
    return state, EnsembleOutput(*(torch.stack(f) for f in zip(*outs)))
