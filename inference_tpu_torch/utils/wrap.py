"""Adapter between user posterior callables and the batched samplers.

The samplers evaluate the posterior under ``torch.func.vmap`` and take its
gradient with ``torch.func.grad``, so the callable must map a ``(P,)``
tensor to a scalar tensor using torch operations. Validation mirrors
``inference_tpu.utils.wrap.as_device_logp``: the posterior must return a
finite scalar at the example point. Posteriors written against numpy are
not wrapped in a host callback here (ROADMAP queue A1).
"""

import torch


def as_device_logp(fn, example):
    """
    Return ``fn`` as a scalar log-probability over ``(P,)`` tensors, after
    checking on ``example`` (a ``(P,)`` tensor) that it returns a finite
    scalar tensor.
    """
    if not callable(fn):
        raise ValueError("[ inference_tpu_torch ] the posterior is not callable.")
    try:
        out = fn(example)
    except (TypeError, AttributeError, RuntimeError) as err:
        raise ValueError(
            "[ inference_tpu_torch ] the posterior failed on a torch tensor "
            f"({type(err).__name__}: {err}). Write it with torch operations "
            "so that it runs on the device and can be differentiated by "
            "torch.func; numpy-only posteriors are not supported by this "
            "package yet (ROADMAP queue A1)."
        ) from err
    if not isinstance(out, torch.Tensor):
        raise ValueError(
            "[ inference_tpu_torch ] the posterior returned a "
            f"{type(out).__name__}, not a torch tensor. Write it with torch "
            "operations so that torch.func can differentiate it; numpy-only "
            "posteriors are not supported by this package yet (ROADMAP "
            "queue A1)."
        )
    if out.numel() != 1:
        raise ValueError(
            "[ inference_tpu_torch ] the posterior must return a scalar, "
            f"but returned shape {tuple(out.shape)}."
        )
    if not bool(torch.isfinite(out).all()):
        raise ValueError(
            "[ inference_tpu_torch ] the posterior must return a finite value "
            f"at the start point, but returned {float(out)}."
        )

    def logp(theta):
        return fn(theta).reshape(())

    return logp


def validate_posterior(posterior, start, error_source: str = "MarkovChain"):
    """
    Validate the posterior callable on the start point (a ``(P,)`` tensor)
    and return it as ``as_device_logp`` does: it must be callable and
    return a finite scalar tensor there. A numpy-only posterior raises,
    naming ROADMAP queue A1.
    """
    if not callable(posterior):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' is not a callable object."
        )
    return as_device_logp(posterior, start)
