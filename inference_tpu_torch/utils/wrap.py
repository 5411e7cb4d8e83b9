"""Adapters between user posterior callables and the batched samplers.

Port of ``inference_tpu.utils.wrap``. A posterior ``posterior(theta) ->
float`` takes one of two routes, decided once on the chain's device:

- **torch**: ``torch.func.vmap`` of it over a two-row batch of the example
  gives a ``(2,)`` tensor. It then runs on the device, batched by
  ``torch.func.vmap`` and differentiated by ``torch.func``.
- **host**: anything else, such as a posterior written with numpy (as the
  reference's users write them). It is called on the host with one chain's
  position as a numpy array in the chain's dtype, one call per chain, and
  its values are sent back to the chain's device in its dtype, as the JAX
  package's ``pure_callback`` with ``vmap_method="sequential"`` does. The
  chain's state stays on its device.

The route comes from the ``vmap`` check on both devices alike: on the CPU a
numpy posterior often accepts a tensor through ``__array__``, but not a
batched tensor under ``vmap``, so the CPU takes the route the card takes.
Validation follows ``inference_tpu.utils.wrap.validate_posterior``: the
posterior must be callable and return a finite float-like scalar at the
start point, with the JAX package's messages. The JAX package's probe of a
backend's host callbacks has no counterpart: a host function runs on the
host of any device here.
"""

import numpy as np
import torch


def runs_under_vmap(fn, example, out_shape=()) -> bool:
    """Whether ``torch.func.vmap(fn)`` over a two-row batch of ``example``
    returns a tensor of ``(2, *out_shape)`` values: the torch route's test."""
    try:
        out = torch.func.vmap(fn)(torch.stack([example, example]))
    except Exception:  # any failure under vmap means the host route
        return False
    return isinstance(out, torch.Tensor) and out.numel() == 2 * int(np.prod(out_shape)) \
        and out.shape[0] == 2


def host_call(fn, theta, out_shape=()):
    """``fn`` of one position ``theta`` (a tensor) called on the host with a
    numpy copy in its dtype, its value as a tensor of ``out_shape`` on
    ``theta``'s device in its dtype."""
    value = np.asarray(fn(theta.detach().cpu().numpy()), dtype=np.float64)
    return torch.as_tensor(value.reshape(out_shape), dtype=theta.dtype, device=theta.device)


def host_batch(fn, thetas, out_shape=()):
    """``fn`` of each row of ``thetas`` ``(K, P)``, called on the host one row
    at a time: ``(K, *out_shape)`` on their device in their dtype, with one
    copy to the host and one back."""
    rows = thetas.detach().cpu().numpy()
    values = np.stack([np.asarray(fn(r), dtype=np.float64).reshape(out_shape) for r in rows])
    return torch.as_tensor(values, dtype=thetas.dtype, device=thetas.device)


class DeviceLogp:
    """A posterior on its route: ``logp(theta)`` for one chain's ``(P,)``
    position gives a scalar tensor, ``logp.batched(thetas)`` for ``(K, P)``
    gives ``(K,)``, both on the positions' device and in their dtype.
    ``host`` is True on the host route. The samplers call ``batched``, so
    they never ``vmap`` a host function."""

    def __init__(self, fn, host: bool):
        self.fn = fn
        self.host = host

    def __call__(self, theta):
        if self.host:
            return host_call(self.fn, theta)
        return self.fn(theta).reshape(())

    def batched(self, thetas):
        if self.host:
            return host_batch(self.fn, thetas)
        if thetas.shape[0] == 1:  # one chain needs no vmap, and its overhead dominates
            return self(thetas[0]).reshape(1)
        return torch.func.vmap(self.__call__)(thetas)


def _check_value(prob, error_source):
    """The JAX package's rules for the value at the start point: a finite,
    float-like scalar."""
    try:
        prob = float(prob)
    except (TypeError, ValueError, RuntimeError):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' must return a scalar "
            f"float-like value, but the returned value has type {type(prob)}."
        )
    if not np.isfinite(prob):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' must return a finite "
            f"value for the given 'start' parameter values, but instead returns "
            f"{prob}."
        )
    return prob


def as_device_logp(fn, example, error_source: str = "inference_tpu_torch") -> DeviceLogp:
    """
    ``fn`` on its route (see the module docstring) as a ``DeviceLogp``,
    after checking at ``example`` (a ``(P,)`` tensor on the chain's device)
    that it returns a finite float-like scalar there.
    """
    if not callable(fn):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' is not a callable object."
        )
    host = not runs_under_vmap(fn, example)
    raw = fn(example.detach().cpu().numpy()) if host else fn(example)
    _check_value(raw, error_source)
    return DeviceLogp(fn, host)


def validate_posterior(posterior, start, error_source: str = "MarkovChain") -> DeviceLogp:
    """
    Validate the posterior callable on the start point (a ``(P,)`` tensor on
    the chain's device) with the JAX package's rules and messages: it must
    be callable and return a finite float-like scalar there. Returns it on
    its route (``as_device_logp``).
    """
    return as_device_logp(posterior, start, error_source)
