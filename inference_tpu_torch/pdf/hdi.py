"""Highest-density intervals estimated from samples.

Port of ``inference_tpu.pdf.hdi``: the shortest interval containing a chosen
fraction of the samples, over the columns of a 2D input. ``sample_hdi``
sorts and slides its window in numpy on the host; ``sample_hdi_device`` does
the same with torch on the sample's own device.
"""

from typing import Sequence
from warnings import warn

import numpy as np
import torch


def sample_hdi(sample, fraction: float):
    """
    Estimate the highest-density interval(s) for a given sample: the
    shortest interval containing ``fraction`` of the elements.

    :param sample: \
        1D sample array, or 2D array of shape (m, n) for which intervals
        are computed per column and returned with shape (2, n). A tensor is
        copied to the host.

    :param fraction: \
        The fraction of the total probability to be contained by the
        interval (between 0 and 1).
    """
    if not 0.0 < fraction < 1.0:
        raise ValueError(
            f"[ sample_hdi error ] The 'fraction' argument must be a float "
            f"between 0 and 1, but the value given was {fraction}."
        )

    if isinstance(sample, np.ndarray):
        s = sample.copy()
    elif isinstance(sample, torch.Tensor):
        s = sample.detach().cpu().numpy().copy()
    elif isinstance(sample, Sequence):
        s = np.array(sample)
    else:
        raise ValueError(
            f"[ sample_hdi error ] The 'sample' argument should be an array "
            f"or a Sequence convertible to one, but instead has type "
            f"{type(sample)}."
        )

    if s.ndim > 2 or s.ndim == 0:
        raise ValueError(
            f"[ sample_hdi error ] The 'sample' argument should have either "
            f"one or two dimensions, but the given array has dimensionality "
            f"{s.ndim}."
        )

    one_dim = s.ndim == 1
    if one_dim:
        s = s.reshape([s.size, 1])

    n_samples, n_intervals = s.shape
    L = int(fraction * n_samples)

    if n_samples < 2:
        raise ValueError(
            "[ sample_hdi error ] The first dimension of the given 'sample' "
            "array must have a length of at least 2."
        )

    if n_samples <= L:
        warn(
            "[ sample_hdi warning ] The given number of samples is "
            "insufficient to estimate the interval for the given fraction."
        )
    elif n_samples - L < 20:
        warn(
            "[ sample_hdi warning ] n_samples * (1 - fraction) is small - "
            "calculated interval may be inaccurate."
        )

    s.sort(axis=0)
    hdi = np.zeros([2, n_intervals])
    if n_samples > L:
        widths = s[L:, :] - s[: n_samples - L, :]
        i = np.expand_dims(widths.argmin(axis=0), axis=0)
        hdi[0, :] = np.take_along_axis(s, i, 0).squeeze(axis=0)
        hdi[1, :] = np.take_along_axis(s, i + L, 0).squeeze(axis=0)
    else:
        hdi[0, :] = s[0, :]
        hdi[1, :] = s[-1, :]
    return hdi.squeeze() if one_dim else hdi


def sample_hdi_device(sample, fraction: float):
    """
    ``sample_hdi`` over the leading axis of a tensor, on its device:
    ``sample`` has shape (m,) or (m, n); returns shape (2,) or (2, n) on
    the same device (ties go to the first, smallest, window, as in numpy).
    """
    sample = torch.as_tensor(sample)
    one_dim = sample.ndim == 1
    s = torch.sort(sample.reshape(sample.shape[0], -1), dim=0).values
    n_samples = s.shape[0]
    L = int(fraction * n_samples)
    widths = s[L:, :] - s[: n_samples - L, :]
    i = widths.argmin(dim=0)
    lwr = torch.take_along_dim(s, i[None, :], 0)[0]
    upr = torch.take_along_dim(s, (i + L)[None, :], 0)[0]
    out = torch.stack([lwr, upr])
    # only a 1D input collapses to (2,): a 2D input keeps its column axis
    # even when n == 1 (as the host sample_hdi does)
    return out[:, 0] if one_dim else out
