"""Shared branchless building blocks for the batched sampler kernels.

Port of ``inference_tpu.mcmc._kernels.common``: the acceptance-rate-driven
scale adaptation as fixed-shape ``torch.where`` updates, so one update
serves a whole batch of chains.
"""

from typing import NamedTuple

import torch


class AdaptiveScale(NamedTuple):
    """
    State of the acceptance-rate-driven scale adaptation (the HMC step
    size: target 0.65, check interval 15 growing x1.4, variance floor
    0.03, exponent 0.15, clip [0.5, 2]). Every field has the batch shape.
    """

    value: torch.Tensor      # the adapted scale (epsilon)
    avg: torch.Tensor        # running sum of submitted accept probabilities
    var: torch.Tensor        # running sum of p*(1-p) terms
    num: torch.Tensor        # int32 count of submissions since last reset
    chk_int: torch.Tensor    # int32 current check interval


def init_adaptive_scale(value, chk_int):
    value = torch.as_tensor(value)
    return AdaptiveScale(
        value=value,
        avg=torch.zeros_like(value),
        var=torch.zeros_like(value),
        num=torch.zeros(value.shape, dtype=torch.int32, device=value.device),
        chk_int=torch.full(
            value.shape, chk_int, dtype=torch.int32, device=value.device
        ),
    )


def submit_accept_prob(
    state: AdaptiveScale,
    p,
    *,
    target: float,
    growth_factor: float,
    adjust_power: float,
    adjust_min: float,
    adjust_max: float,
    var_floor: float = 0.0,
    mask=True,
):
    """
    Record an acceptance probability and, once the check interval is
    reached, either rescale ``value`` (when the observed rate is outside
    the 2-sigma band of the target) or grow the check interval. ``mask``
    gates the whole update.
    """
    fdtype = state.value.dtype
    p = torch.as_tensor(p, dtype=fdtype, device=state.value.device)
    mask = torch.as_tensor(mask, device=state.value.device)
    zero = torch.zeros((), dtype=fdtype, device=p.device)

    num = state.num + mask.to(torch.int32)
    avg = state.avg + torch.where(mask, p, zero)
    var_term = torch.clamp(p * (1 - p), min=var_floor)
    var = state.var + torch.where(mask, var_term, zero)

    due = mask & (num >= state.chk_int)

    nf = num.to(fdtype)
    denom = torch.clamp(nf, min=1.0)
    mu = torch.where(due, avg / denom, torch.full_like(avg, 0.5))
    std = torch.sqrt(torch.clamp(var, min=0.0)) / denom

    in_band = (mu - 2 * std < target) & (target < mu + 2 * std)
    adjust = due & ~in_band
    grow = due & in_band

    # mu is clipped slightly below 1 to keep log(mu) finite (in float32
    # the upper clip rounds to 1.0, as it does in the JAX package)
    mu_safe = torch.clamp(mu, 1e-12, 1.0 - 1e-12)
    log_target = torch.log(torch.tensor(target, dtype=fdtype, device=p.device))
    ratio = log_target / torch.log(mu_safe)
    adj = torch.clamp(ratio**adjust_power, adjust_min, adjust_max)

    new_value = torch.where(adjust, state.value * adj, state.value)
    # the reference's integer growth: int(growth * chk * 0.1) * 10
    grown = (
        torch.floor(growth_factor * state.chk_int.to(fdtype) * 0.1).to(torch.int32)
        * 10
    )
    new_chk = torch.where(grow, grown, state.chk_int)

    # counters reset only when the value was adjusted
    new_avg = torch.where(adjust, zero, avg)
    new_var = torch.where(adjust, zero, var)
    new_num = torch.where(adjust, torch.zeros_like(num), num)

    return AdaptiveScale(new_value, new_avg, new_var, new_num, new_chk)


def rescale(state: AdaptiveScale, ratio, mask=True):
    """Directly rescale ``value`` and reset the counters."""
    mask = torch.as_tensor(mask, device=state.value.device)
    zero = torch.zeros((), dtype=state.value.dtype, device=state.value.device)
    return AdaptiveScale(
        value=torch.where(mask, state.value * ratio, state.value),
        avg=torch.where(mask, zero, state.avg),
        var=torch.where(mask, zero, state.var),
        num=torch.where(mask, torch.zeros_like(state.num), state.num),
        chk_int=state.chk_int,
    )
