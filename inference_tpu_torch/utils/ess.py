"""Effective-sample-size estimation via FFT autocorrelation.

The same estimator as ``inference_tpu.utils.ess``: autocorrelation from
``irfft(|rfft(x - mean)|^2)``, truncated at its first negative value, with
ESS = N / (sum(f) / f[0]). A host (numpy) version for single series and a
batched ``torch.fft`` version over many chains.
"""

import numpy as np
import torch


def effective_sample_size(x) -> int:
    """Estimate the effective sample size of a 1D series of samples."""
    x = np.asarray(x, dtype=float)
    f = np.fft.irfft(np.abs(np.fft.rfft(x - x.mean())) ** 2)
    f = f[: len(f) // 2]
    if f[0] <= 0.0:
        raise ValueError(
            "effective_sample_size requires a series with positive "
            "variance (a constant chain has no effective samples)"
            if f[0] == 0.0
            else "First element of the autocorrelation is negative"
        )
    cut = np.argmax(f < 0.0)
    if cut > 0:
        f = f[:cut]
    thin_factor = f.sum() / f[0]
    return int(len(x) / thin_factor)


def effective_sample_size_batched(x):
    """
    Batched ESS over the trailing axis: ``x`` has shape (..., N) and the
    result has shape (...), int32. Truncation at the first negative
    autocorrelation value is a cumulative mask, so the computation keeps
    fixed shapes. A constant (stuck) series gets 0.
    """
    x = torch.as_tensor(x)
    n = x.shape[-1]
    centred = x - x.mean(dim=-1, keepdim=True)
    f = torch.fft.irfft(torch.fft.rfft(centred, dim=-1).abs() ** 2, dim=-1)
    f = f[..., : f.shape[-1] // 2]
    keep = torch.cumprod((f >= 0.0).to(f.dtype), dim=-1)
    kept_sum = (f * keep).sum(dim=-1)
    f0 = f[..., 0]
    valid = f0 > 0.0
    thin_factor = kept_sum / torch.where(valid, f0, torch.ones_like(f0))
    ess = torch.where(
        valid & (thin_factor > 0.0), n / thin_factor, torch.zeros_like(f0)
    )
    return ess.to(torch.int32)
