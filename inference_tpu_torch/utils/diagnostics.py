"""Cross-chain convergence diagnostics (split-R-hat family).

Port of ``inference_tpu.utils.diagnostics``: the classic split-R-hat
(Gelman et al., *Bayesian Data Analysis* 3rd ed., eq. 11.4) and the
rank-normalized, folded variant of Vehtari, Gelman, Simpson, Carpenter &
Bürkner (2021). Both take a ``(..., n_chains, n_steps)`` tensor and keep
its fixes: chains that are each constant but at different values report
+inf, and tied draws receive their average rank.
"""

import torch


def _split_chains(x):
    """(..., m, n) -> (..., 2m, n//2): split every chain in half, dropping
    a trailing odd sample."""
    m, n = x.shape[-2], x.shape[-1]
    half = n // 2
    if half < 2:
        raise ValueError(
            "[ split_rhat error ] chains must contain at least 4 samples "
            f"(got n_steps = {n})."
        )
    x = x[..., : 2 * half]
    return x.reshape(*x.shape[:-2], 2 * m, half)


def _rhat_of_splits(z):
    """Potential scale reduction of already-split chains (..., m, n)."""
    n = z.shape[-1]
    chain_means = z.mean(dim=-1)
    chain_vars = z.var(dim=-1, correction=1)
    w = chain_vars.mean(dim=-1)
    b_over_n = chain_means.var(dim=-1, correction=1)
    var_plus = (n - 1) / n * w + b_over_n
    # identical constant chains (w == 0, b == 0) are converged: 1. Chains
    # each constant at DIFFERENT values (w == 0, b > 0) are stuck: +inf.
    one = torch.ones_like(w)
    safe_w = torch.where(w > 0.0, w, one)
    stuck = torch.where(b_over_n > 0.0, torch.full_like(w, float("inf")), one)
    return torch.where(w > 0.0, torch.sqrt(var_plus / safe_w), stuck)


def split_rhat(x):
    """Split-R-hat over the last two axes of ``x`` (..., n_chains, n_steps).
    Returns a tensor of shape ``x.shape[:-2]``."""
    x = torch.as_tensor(x)
    if x.ndim < 2 or x.shape[-2] < 2:
        raise ValueError(
            "[ split_rhat error ] expected (..., n_chains, n_steps) with "
            f"at least 2 chains, got shape {tuple(x.shape)}."
        )
    return _rhat_of_splits(_split_chains(x))


def _rank_normalize(z):
    """Map pooled draws to normal scores over the last two axes, with the
    Blom offset (r - 3/8)/(S + 1/4) and average ranks for ties."""
    m, n = z.shape[-2], z.shape[-1]
    s = m * n
    flat = z.reshape(-1, s).contiguous()
    sorted_flat = torch.sort(flat, dim=-1).values
    left = torch.searchsorted(sorted_flat, flat, side="left")
    right = torch.searchsorted(sorted_flat, flat, side="right")
    ranks = 0.5 * (left + right + 1).to(z.dtype)
    scores = torch.special.ndtri((ranks - 0.375) / (s + 0.25))
    return scores.reshape(z.shape)


def _median_last_two(z):
    """Median over the last two axes, averaging the two middle values of
    an even count (``jnp.median``'s convention; ``torch.median`` returns
    the lower one)."""
    s = z.shape[-2] * z.shape[-1]
    flat = torch.sort(z.reshape(*z.shape[:-2], s), dim=-1).values
    med = 0.5 * (flat[..., (s - 1) // 2] + flat[..., s // 2])
    return med[..., None, None]


def rank_normalized_rhat(x):
    """Rank-normalized, folded split-R-hat (Vehtari et al. 2021): the
    elementwise maximum of the bulk R-hat of the rank-normal scores and
    the tail R-hat of ``|x - median(x)|``. Accepts (..., n_chains,
    n_steps); returns ``x.shape[:-2]``."""
    x = torch.as_tensor(x)
    if x.ndim < 2 or x.shape[-2] < 2:
        raise ValueError(
            "[ rank_normalized_rhat error ] expected (..., n_chains, "
            f"n_steps) with at least 2 chains, got shape {tuple(x.shape)}."
        )
    z = _split_chains(x)
    bulk = _rhat_of_splits(_rank_normalize(z))
    folded = torch.abs(z - _median_last_two(z))
    tail = _rhat_of_splits(_rank_normalize(folded))
    return torch.maximum(bulk, tail)
