"""Batched Metropolis, Gibbs and PCA-Gibbs transitions.

Port of ``inference_tpu.mcmc._kernels.metropolis``. Where the JAX package
writes one chain's step and vmaps it, these steps are written over a batch
of ``K`` chains at once: positions are ``(K, P)``, the per-parameter proposal
widths and try counts ``(K, P)`` and every per-chain scalar ``(K,)``.

- The Gibbs and PCA sweeps are a Python loop over the ``P`` parameters
  (directions), each a one-dimensional Metropolis update with its width's
  ``AdaptiveScale`` update on that column only.
- With ``retry=True`` (repeat until accept) each update is a host loop over
  the chains that have not accepted yet, as the JAX ``lax.while_loop`` is,
  with no cap: past ``MAX_TRIES`` tries the width is cut to a quarter on
  every further try, which forces an acceptance. With ``retry=False`` each
  update is one proposal, a rejection keeps the current point, and the step
  reads nothing back to the host.
- Randomness comes from an explicit ``torch.Generator``. The standard
  normals and the acceptance uniforms may be passed in instead, as one
  stream per chain consumed one entry per try across all parameters of the
  step, which is the order in which the JAX kernel draws (``split(key)``,
  then ``split(k, 3)`` for every try): normals ``(T, K)`` for Gibbs and
  PCA, ``(T, K, P)`` for Metropolis, uniforms ``(T, K)``. That is how the
  tests drive these steps and the JAX package with the same numbers.
"""

from typing import NamedTuple

import torch

from ...utils.bounds import _reflect
from .common import AdaptiveScale, init_adaptive_scale, rescale, submit_accept_prob

# width adaptation constants (reference: gibbs.py:42-46)
MH_TARGET = 0.25       # MetropolisChain target accept rate
GIBBS_TARGET = 0.5     # GibbsChain / PcaChain target accept rate
WIDTH_CHK_INT = 100
WIDTH_GROWTH = 1.75
WIDTH_POWER = 0.25
WIDTH_MIN_ADJ = 0.1
WIDTH_MAX_ADJ = 3.0
MAX_TRIES = 50         # tries before the width is cut to a quarter


class ProposalModes(NamedTuple):
    """Per-parameter proposal behaviour masks, ``(P,)`` each."""

    non_negative: torch.Tensor  # bool: proposals folded with abs
    bounded: torch.Tensor       # bool: proposals reflected into [lower, upper]
    lower: torch.Tensor
    upper: torch.Tensor


def default_modes(n_params, dtype, device="cpu"):
    return ProposalModes(
        non_negative=torch.zeros(n_params, dtype=torch.bool, device=device),
        bounded=torch.zeros(n_params, dtype=torch.bool, device=device),
        lower=torch.zeros(n_params, dtype=dtype, device=device),
        upper=torch.ones(n_params, dtype=dtype, device=device),
    )


class MetropolisState(NamedTuple):
    theta: torch.Tensor       # (K, P) current positions
    logp: torch.Tensor        # (K,) tempered log-probabilities
    widths: AdaptiveScale     # (K, P) per-parameter proposal width adaptation
    try_count: torch.Tensor   # (K, P) int32 proposals since the last accepted step
    inv_temp: torch.Tensor    # (K,) inverse temperatures


class MetropolisOutput(NamedTuple):
    theta: torch.Tensor   # (K, P)
    logp: torch.Tensor    # (K,)
    sigmas: torch.Tensor  # (K, P) proposal widths after this step


class PcaState(NamedTuple):
    theta: torch.Tensor
    logp: torch.Tensor
    widths: AdaptiveScale
    try_count: torch.Tensor
    inv_temp: torch.Tensor
    directions: torch.Tensor  # (K, P, P): chain k's sweep direction i in column i


def init_metropolis_state(theta0, logp0, widths, inv_temp=1.0) -> MetropolisState:
    """Batched initial state from positions ``(K, P)``, log-probabilities
    ``(K,)`` and widths broadcastable to ``(K, P)``."""
    theta0 = torch.as_tensor(theta0)
    like = dict(dtype=theta0.dtype, device=theta0.device)
    K = theta0.shape[0]
    widths = torch.as_tensor(widths, **like).expand(theta0.shape).clone()
    return MetropolisState(
        theta=theta0,
        logp=torch.as_tensor(logp0, **like),
        widths=init_adaptive_scale(widths, WIDTH_CHK_INT),
        try_count=torch.zeros(theta0.shape, dtype=torch.int32, device=theta0.device),
        inv_temp=torch.full((K,), float(inv_temp), **like),
    )


def init_pca_state(theta0, logp0, widths, directions, inv_temp=1.0) -> PcaState:
    """``init_metropolis_state`` with the sweep directions, ``(P, P)`` for
    every chain or ``(K, P, P)``."""
    base = init_metropolis_state(theta0, logp0, widths, inv_temp)
    K, P = base.theta.shape
    directions = torch.as_tensor(directions, dtype=base.theta.dtype, device=base.theta.device)
    return PcaState(*base, directions=directions.expand(K, P, P).clone())


def _apply_modes(prop, modes: ProposalModes, cols=slice(None)):
    """The non-negative and reflecting-boundary transforms of ``cols``'
    modes, elementwise on proposals over those columns (the JAX package's
    ``jnp.divmod`` reflection, ``utils.bounds._reflect``)."""
    nn, bounded = modes.non_negative[cols], modes.bounded[cols]
    lower, upper = modes.lower[cols], modes.upper[cols]
    prop = torch.where(nn, prop.abs(), prop)
    reflected = _reflect(prop, lower, upper - lower)[0]
    return torch.where(bounded, reflected, prop)


def _halve_on_max_tries(widths: AdaptiveScale, try_count):
    """One more try: increment the try counts and cut the widths to a
    quarter where they pass ``MAX_TRIES``. As in the reference the count is
    reset only by an accepted step, so past 50 tries the width is cut on
    every further try until one is accepted."""
    try_count = try_count + 1
    return rescale(widths, 0.25, mask=try_count > MAX_TRIES), try_count


def _submit(widths: AdaptiveScale, submitted, target_rate):
    return submit_accept_prob(
        widths,
        submitted,
        target=target_rate,
        growth_factor=WIDTH_GROWTH,
        adjust_power=WIDTH_POWER,
        adjust_min=WIDTH_MIN_ADJ,
        adjust_max=WIDTH_MAX_ADJ,
    )


def _accept(p_new, p_old, u):
    """(auto, accept probability, accepted) of the JAX kernels: an uphill
    proposal is taken outright, else with probability exp(p_new - p_old)."""
    auto = p_new > p_old
    accept_prob = torch.exp(torch.clamp(p_new - p_old, max=0.0))
    return auto, accept_prob, auto | (u < accept_prob)


class _Draws:
    """The normals and uniforms of each try: from the generator, or from
    injected per-chain streams, consumed one entry per try by the chains
    that make it."""

    def __init__(self, generator, like, event, normals=None, uniforms=None):
        self.generator, self.like, self.event = generator, like, tuple(event)
        self.normals, self.uniforms = normals, uniforms
        self.pos = None
        if normals is not None or uniforms is not None:
            self.pos = torch.zeros(like.shape[0], dtype=torch.long, device=like.device)

    def take(self, chains):
        """(normals (m, *event), uniforms (m,)) for ``chains``, an index
        tensor or None for every chain."""
        kw = dict(generator=self.generator, dtype=self.like.dtype, device=self.like.device)
        m = self.like.shape[0] if chains is None else chains.numel()
        if self.pos is not None:
            if chains is None:
                chains = torch.arange(m, device=self.like.device)
            idx = self.pos[chains]
            for stream in (self.normals, self.uniforms):
                if stream is not None and int(idx.max()) >= stream.shape[0]:
                    raise ValueError(
                        f"an injected stream of {stream.shape[0]} draws ran out: a chain "
                        "tried more often than the stream holds"
                    )
            self.pos[chains] = idx + 1
        z = (torch.randn((m, *self.event), **kw) if self.normals is None
             else self.normals[idx, chains])
        u = torch.rand((m,), **kw) if self.uniforms is None else self.uniforms[idx, chains]
        return z, u


def _until_accepted(retry, trial):
    """Run ``trial(chains) -> accepted`` on every chain (``chains`` None)
    and, with ``retry``, again on the chains that have not accepted (an
    index tensor), until all have. Each try with ``retry`` reads its count
    of acceptances on the host; without it nothing is read."""
    chains = None
    while True:
        accepted = trial(chains)
        if not retry:
            return
        n_acc = int(accepted.sum())
        if n_acc == accepted.numel():
            return
        if n_acc:
            rest = torch.nonzero(~accepted).squeeze(1)
            chains = rest if chains is None else chains[rest]


def _sel(chains):
    return slice(None) if chains is None else chains


def _gather(widths: AdaptiveScale, chains, col=slice(None)):
    return AdaptiveScale(*(f[_sel(chains), col] for f in widths))


def _scatter(widths: AdaptiveScale, chains, new: AdaptiveScale, col=slice(None)):
    for f, g in zip(widths, new):
        f[_sel(chains), col] = g


def _keep_accepted(theta, logp, chains, accepted, prop, p):
    """Write the accepted proposals into ``theta`` and ``logp``: by
    ``torch.where`` over every chain (no host read), else by index."""
    if chains is None:
        theta.copy_(torch.where(accepted[:, None], prop, theta))
        logp.copy_(torch.where(accepted, p, logp))
    else:
        won = chains[accepted]
        theta[won] = prop[accepted]
        logp[won] = p[accepted]


def make_metropolis_step(logp_fn, modes: ProposalModes, *, retry: bool = True):
    """
    Joint-proposal Metropolis-Hastings step (reference: gibbs.py:288-307):
    ``step(state, generator=None, normals=None, uniforms=None)``. Widths
    adapt only through the cut after ``MAX_TRIES``; the reference's
    ``MetropolisChain`` submits no acceptance statistics.

    :param logp_fn: batched ``(K, P) -> (K,)`` untempered log-probability.
    :param retry: repeat-until-accept when True; one proposal a step, a
        rejection keeping the current point, when False.
    """

    def step(state: MetropolisState, generator=None, normals=None, uniforms=None):
        P = state.theta.shape[1]
        theta, logp = state.theta.clone(), state.logp.clone()
        widths = AdaptiveScale(*(f.clone() for f in state.widths))
        try_count = state.try_count.clone()
        draws = _Draws(generator, state.theta, (P,), normals, uniforms)

        def trial(chains):
            sel = _sel(chains)
            w, tc = _halve_on_max_tries(_gather(widths, chains), try_count[sel])
            z, u = draws.take(chains)
            prop = _apply_modes(state.theta[sel] + w.value * z, modes)
            p = logp_fn(prop) * state.inv_temp[sel]
            _, _, accepted = _accept(p, state.logp[sel], u)
            _scatter(widths, chains, w)
            try_count[sel] = tc
            _keep_accepted(theta, logp, chains, accepted, prop, p)
            return accepted

        _until_accepted(retry, trial)
        new_state = state._replace(
            theta=theta, logp=logp, widths=widths, try_count=torch.zeros_like(try_count)
        )
        return new_state, MetropolisOutput(theta, logp, widths.value)

    return step


def _make_sweep(propose, logp_fn, target_rate, retry):
    """The Gibbs-type sweep shared by the Gibbs and PCA steps: for each
    parameter i, tries of ``propose(state, rows, sel, i, width, z) ->
    proposals`` (``rows`` the positions of the chains ``sel`` selects)
    accepted by Metropolis, each submitting its acceptance probability to
    width i's adaptation."""

    def step(state, generator=None, normals=None, uniforms=None):
        P = state.theta.shape[1]
        theta, logp = state.theta.clone(), state.logp.clone()
        widths = AdaptiveScale(*(f.clone() for f in state.widths))
        try_count = state.try_count.clone()
        draws = _Draws(generator, state.theta, (), normals, uniforms)

        for i in range(P):
            def trial(chains, i=i):
                sel = _sel(chains)
                w, tc = _halve_on_max_tries(_gather(widths, chains, i), try_count[sel, i])
                z, u = draws.take(chains)
                prop = propose(state, theta[sel], sel, i, w.value, z)
                p_new = logp_fn(prop) * state.inv_temp[sel]
                auto, accept_prob, accepted = _accept(p_new, logp[sel], u)
                submitted = torch.where(auto, 1.0, accept_prob)
                _scatter(widths, chains, _submit(w, submitted, target_rate), i)
                try_count[sel, i] = tc
                _keep_accepted(theta, logp, chains, accepted, prop, p_new)
                return accepted

            _until_accepted(retry, trial)

        new_state = state._replace(
            theta=theta, logp=logp, widths=widths, try_count=torch.zeros_like(try_count)
        )
        return new_state, MetropolisOutput(theta, logp, widths.value)

    return step


def make_gibbs_step(logp_fn, modes: ProposalModes, *, target_rate: float = GIBBS_TARGET,
                    retry: bool = True):
    """
    Componentwise Gibbs sweep (reference: gibbs.py:627-656): one
    one-dimensional Metropolis update per parameter per step, each try
    submitting its acceptance probability to that parameter's width
    adaptation. ``step(state, generator=None, normals=None, uniforms=None)``.

    :param logp_fn: batched ``(K, P) -> (K,)`` untempered log-probability.
    :param retry: repeat-until-accept when True; one proposal a parameter,
        a rejection keeping the current value, when False.
    """

    def propose(state, rows, sel, i, width, z):
        prop = rows.clone()
        prop[:, i] = _apply_modes(rows[:, i] + width * z, modes, i)
        return prop

    return _make_sweep(propose, logp_fn, target_rate, retry)


def make_pca_step(logp_fn, *, target_rate: float = GIBBS_TARGET, bounds_reflect=None,
                  retry: bool = True):
    """
    Gibbs sweep along each chain's direction vectors (the eigenvectors of
    its sample covariance, re-estimated on the host between advances;
    reference: pca.py:96-183), which live in the state.
    ``step(state, generator=None, normals=None, uniforms=None)``.

    :param bounds_reflect: optional batched ``theta -> theta`` map
        (``Bounds.reflect``) applied to every proposal.
    """

    def propose(state, rows, sel, i, width, z):
        v = state.directions[sel, :, i]
        prop = rows + v * (width * z)[:, None]
        return prop if bounds_reflect is None else bounds_reflect(prop)

    return _make_sweep(propose, logp_fn, target_rate, retry)


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
        empty = lambda *shape: torch.empty(shape, dtype=state.theta.dtype,
                                           device=state.theta.device)
        return state, MetropolisOutput(empty(0, K, P), empty(0, K), empty(0, K, P))
    return state, MetropolisOutput(*(torch.stack(f) for f in zip(*outs)))
