"""Fused whole-trajectory HMC transitions: kernel B1 and its plain version.

Port of ``inference_tpu.ops.hmc_fused``. The kernel
(``csrc/hmc_fused.cu``, CUDA C++ for Hopper) runs ``chunk`` (64)
duplicate-on-reject HMC transitions per launch with one thread per chain,
keeping the position, momentum and step-size adaptation state on the chip
through every leapfrog step of the chunk. ``_reference_chunk`` is its plain
PyTorch version: the same transition math (``_transition_math``) as
separate torch operations, masked to ``max_steps``.

Semantics are those of the ``retry=False`` transition of
``mcmc/_kernels/hmc.py``: the same +-10% leapfrog-step jitter, the same
step-size adaptation constants, the same tempering of log-probability and
force. A jittered step count of zero is raised to one, as that transition
does. The layout is ``(P, chains)``.

Random numbers are drawn outside the kernel: per chunk, ``_advance`` draws
the normals ``z (chunk, P, K)`` and the uniforms ``u_steps``/``u_acc``
``(chunk, K)`` from the caller's ``torch.Generator`` and streams them in,
which keeps the kernel comparable element by element with its plain
version on the same draws.

The posterior reaches the kernel as a ``GaussianForm``: a CUDA kernel
cannot call a Python callable, so the quadratic form's operands ``A`` and
``mu`` are passed to it and the kernel evaluates value and gradient itself.
Everywhere else a ``GaussianForm`` is an ordinary posterior module.

Restrictions of the kernel: ``retry=False``, no reflecting bounds,
unit/scalar/diagonal inverse mass, ``P <= 64``, float32, one device. On a
CPU tensor the plain version runs instead; on a CUDA tensor the kernel
launches or the wrapper raises.
"""

from typing import NamedTuple

import torch
from torch import nn

from ..mcmc._kernels.common import AdaptiveScale, submit_accept_prob
from ..mcmc._kernels.hmc import (
    EPS_GROWTH,
    EPS_MAX_ADJ,
    EPS_MIN_ADJ,
    EPS_POWER,
    EPS_TARGET,
    EPS_VAR_FLOOR,
)
from . import _build

_CHUNK = 64  # transitions per kernel launch
P_MAX = 64   # the kernel's largest instantiation

# launches of the CUDA kernel in this process; the wrapper adds one per launch
KERNEL_LAUNCHES = 0


class GaussianForm(nn.Module):
    """
    The log-density ``-1/2 (theta - mu)^T A (theta - mu)`` as a posterior
    module. ``A`` is symmetrised once here, so every path (kernel, plain
    version, autodiff of ``forward``) uses the same gradient ``-A (theta -
    mu)``. ``forward`` takes ``(P,)`` or ``(K, P)`` positions.
    """

    def __init__(self, A, mean=None):
        super().__init__()
        A = torch.as_tensor(A, dtype=torch.get_default_dtype())
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"A must be square, got shape {tuple(A.shape)}")
        n = A.shape[0]
        mu = (
            torch.zeros(n, dtype=A.dtype)
            if mean is None
            else torch.as_tensor(mean, dtype=A.dtype).reshape(n)
        )
        self.register_buffer("A", (0.5 * (A + A.T)).contiguous())
        self.register_buffer("mu", mu.contiguous())

    def forward(self, theta):
        d = theta - self.mu
        return -0.5 * ((d @ self.A) * d).sum(dim=-1)

    def value_cols(self, t):
        """Log-density of ``(P, K)`` column positions, shape ``(K,)``."""
        d = t - self.mu[:, None]
        return -0.5 * (d * (self.A @ d)).sum(dim=0)

    def grad_cols(self, t):
        """Gradient at ``(P, K)`` column positions, shape ``(P, K)``."""
        return -(self.A @ (t - self.mu[:, None]))


def _transition_math(value_cols, grad_cols, steps: int, max_steps: int):
    """The per-transition update on ``(P, K)`` positions and ``(K,)``
    per-chain scalars, as separate torch operations: the plain version of
    one transition of the kernel."""

    def transition(t, lp, eps: AdaptiveScale, inv_temp, z, u_steps, u_acc, im=None):
        """One duplicate-on-reject HMC transition. ``im`` is a ``(P, 1)``
        diagonal inverse mass or None (unit mass). Returns
        ``(t, lp, eps, accepted, n_steps)``."""
        if im is None:
            velocity = lambda r: r
            mom_scale = None
        else:
            velocity = lambda r: im * r
            mom_scale = 1.0 / torch.sqrt(im)

        def kinetic(r):
            return 0.5 * (r * velocity(r)).sum(dim=0)

        r0 = z if mom_scale is None else mom_scale * z
        h0 = kinetic(r0) - lp

        n_steps = (steps * (1.0 + (u_steps - 0.5) * 0.2)).to(torch.int32)
        n_steps = torch.clamp(n_steps, max=max_steps).clamp(min=1)

        epsilon = eps.value
        r_step = inv_temp * epsilon
        half = torch.full_like(epsilon, 0.5)
        one = torch.ones_like(epsilon)
        r = r0 + (0.5 * r_step) * grad_cols(t)
        tc = t
        for i in range(max_steps):
            active = i < n_steps
            kick = torch.where(i == n_steps - 1, half, one)
            t2 = tc + epsilon * velocity(r)
            r2 = r + (kick * r_step) * grad_cols(t2)
            tc = torch.where(active, t2, tc)
            r = torch.where(active, r2, r)

        p = value_cols(tc) * inv_temp
        h = kinetic(r) - p
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
        t_new = torch.where(accepted, tc, t)
        lp_new = torch.where(accepted, p, lp)
        return t_new, lp_new, eps, accepted, n_steps

    return transition


def _reference_chunk(
    theta, logp, eps, inv_temp, z, us, ua, *, form, steps, inv_mass_diag, store
):
    """The kernel's plain version: ``z.shape[0]`` transitions of ``(P, K)``
    positions with ``(K,)`` per-chain state, on any device and dtype.
    Returns ``(theta, logp, eps, history)``; the history is ``(theta (n, P,
    K), logp (n, K), n_steps (n, K), eps (n, K))`` or None without
    ``store``."""
    max_steps = max(int(steps * 1.1), 1)
    transition = _transition_math(form.value_cols, form.grad_cols, steps, max_steps)
    im = None if inv_mass_diag is None else inv_mass_diag.reshape(-1, 1)
    hist = []
    for i in range(z.shape[0]):
        theta, logp, eps, _, n_steps = transition(
            theta, logp, eps, inv_temp, z[i], us[i], ua[i], im
        )
        if store:
            hist.append((theta, logp, n_steps, eps.value))
    if not store:
        return theta, logp, eps, None
    return theta, logp, eps, tuple(torch.stack(h) for h in zip(*hist))


def _launch_chunk(
    theta, logp, eps, inv_temp, z, us, ua, *, form, steps, inv_mass_diag, store
):
    """Launch kernel B1 for ``z.shape[0]`` transitions on CUDA tensors, with
    the signature and results of ``_reference_chunk``. Raises on a tensor
    the kernel does not take (not float32 or int32, wrong device, shape or
    layout); it never casts."""
    global KERNEL_LAUNCHES
    P, K = theta.shape
    chunk = z.shape[0]
    dev = theta.device
    if P > P_MAX:
        raise ValueError(
            f"kernel B1 takes at most P = {P_MAX} parameters, got {P} "
            "(larger P is ROADMAP queue B1's open item)"
        )
    if chunk < 1 or K < 1:
        raise ValueError("kernel B1 needs at least one chain and one transition")
    im = (
        torch.ones(P, dtype=torch.float32, device=dev)
        if inv_mass_diag is None
        else inv_mass_diag
    )
    f32, i32 = torch.float32, torch.int32
    operands = [
        ("theta", theta, (P, K), f32),
        ("logp", logp, (K,), f32),
        ("eps.value", eps.value, (K,), f32),
        ("eps.avg", eps.avg, (K,), f32),
        ("eps.var", eps.var, (K,), f32),
        ("eps.num", eps.num, (K,), i32),
        ("eps.chk_int", eps.chk_int, (K,), i32),
        ("inv_temp", inv_temp, (K,), f32),
        ("z", z, (chunk, P, K), f32),
        ("u_steps", us, (chunk, K), f32),
        ("u_acc", ua, (chunk, K), f32),
        ("inv_mass", im, (P,), f32),
        ("A", form.A, (P, P), f32),
        ("mu", form.mu, (P,), f32),
    ]
    for name, x, shape, dtype in operands:
        if x.dtype != dtype:
            raise TypeError(
                f"kernel B1 takes {name} as {dtype}, got {x.dtype}; it has no "
                "float64 form, and the wrapper does not cast"
            )
        if x.device != dev:
            raise ValueError(f"kernel B1: {name} is on {x.device}, theta on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(
                f"kernel B1: {name} has shape {tuple(x.shape)}, expected {shape}"
            )
        if not x.is_contiguous():
            raise ValueError(f"kernel B1: {name} is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"kernel B1 runs on CUDA tensors, got {dev}")

    empty = lambda shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    outs = [empty((P, K)), empty((K,)), empty((K,)), empty((K,)), empty((K,)),
            empty((K,), i32), empty((K,), i32)]
    hist = (
        (empty((chunk, P, K)), empty((chunk, K)), empty((chunk, K), i32),
         empty((chunk, K)))
        if store
        else None
    )
    fn = _build.bind("hmc_fused", "hmc_fused_chunk", 25, 5)
    ptrs = [x.data_ptr() for _, x, _, _ in operands]
    ptrs += [x.data_ptr() for x in outs]
    ptrs += [x.data_ptr() for x in hist] if store else [None] * 4
    max_steps = max(int(steps * 1.1), 1)
    with torch.cuda.device(dev):
        rc = fn(*ptrs, P, K, chunk, int(steps), max_steps, _build.stream(dev))
    _build.raise_on(rc, "B1")
    KERNEL_LAUNCHES += 1
    t_o, lp_o, ev_o, ea_o, evr_o, en_o, ec_o = outs
    return t_o, lp_o, AdaptiveScale(ev_o, ea_o, evr_o, en_o, ec_o), hist


def _run_chunk(*args, **kw):
    """One chunk: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    device = args[0].device
    if device.type == "cuda":
        return _launch_chunk(*args, **kw)
    if device.type == "cpu":
        return _reference_chunk(*args, **kw)
    raise ValueError(f"no fused hmc path for device {device}")


class FusedHmc(NamedTuple):
    """Plan for fused advances over a ChainArray's HMC state. The
    posterior's operands live on ``form``; there is no global cache."""

    form: GaussianForm
    steps: int
    inv_mass_diag: object   # None | tuple of P floats
    chunk: int


def plan_fused_hmc(
    form, n_parameters: int, *, steps: int, inverse_mass=None, chunk: int = _CHUNK
):
    """Validate the configuration and build a fused-advance plan, or raise
    ``ValueError`` describing why the fused kernel cannot apply."""
    if not isinstance(form, GaussianForm):
        raise ValueError(
            "[ fused hmc ] the fused kernel evaluates the posterior itself "
            "and takes one form: GaussianForm(A, mean) for "
            "-1/2 (theta - mean)^T A (theta - mean); got "
            f"{type(form).__name__}."
        )
    if form.A.shape[0] != n_parameters:
        raise ValueError(
            f"[ fused hmc ] the GaussianForm has {form.A.shape[0]} parameters, "
            f"the chains have {n_parameters}."
        )
    if n_parameters > P_MAX:
        raise ValueError(
            f"[ fused hmc ] the fused kernel takes at most {P_MAX} "
            f"parameters, got {n_parameters} (larger P is ROADMAP queue "
            "B1's open item)."
        )
    im = None
    if inverse_mass is not None:
        im = torch.as_tensor(inverse_mass, dtype=torch.float64)
        if im.ndim == 0:
            im = im.expand(n_parameters)
        if im.ndim != 1 or im.shape[0] != n_parameters:
            raise ValueError(
                "[ fused hmc ] only unit/scalar/diagonal inverse mass is "
                "supported by the fused kernel."
            )
        if bool((im <= 0).any()):
            raise ValueError("inverse mass values must all be positive")
        im = tuple(im.tolist())
    return FusedHmc(form=form, steps=int(steps), inv_mass_diag=im, chunk=int(chunk))


def _advance(plan: FusedHmc, state, n: int, store: bool, generator, run_chunk):
    """Advance an ``HmcState`` batch ``n`` transitions in chunks of
    ``plan.chunk`` through ``run_chunk``. Returns ``(new_state, history or
    None)``, the history shaped like ``run_steps``' outputs: ``theta (n, K,
    P)``, ``logp (n, K)``, ``n_steps (n, K)``, ``eps (n, K)``."""
    K, P = state.theta.shape
    like = dict(dtype=state.theta.dtype, device=state.theta.device)
    im = (
        None
        if plan.inv_mass_diag is None
        else torch.tensor(plan.inv_mass_diag, **like)
    )
    theta = state.theta.T.contiguous()
    logp, eps = state.logp, state.eps
    hists = []
    done = 0
    while done < n:
        c = min(plan.chunk, n - done)
        z = torch.randn((c, P, K), generator=generator, **like)
        us = torch.rand((c, K), generator=generator, **like)
        ua = torch.rand((c, K), generator=generator, **like)
        theta, logp, eps, hist = run_chunk(
            theta, logp, eps, state.inv_temp, z, us, ua,
            form=plan.form, steps=plan.steps, inv_mass_diag=im, store=store,
        )
        if store:
            hists.append(hist)
        done += c
    new_state = state._replace(theta=theta.T.contiguous(), logp=logp, eps=eps)
    if not store:
        return new_state, None
    if not hists:
        empty = lambda *shape, dtype=like["dtype"]: torch.empty(
            shape, dtype=dtype, device=like["device"]
        )
        return new_state, (
            empty(0, K, P), empty(0, K), empty(0, K, dtype=torch.int32), empty(0, K)
        )
    ht, hp, hs, he = (torch.cat(h) for h in zip(*hists))
    return new_state, (ht.transpose(1, 2), hp, hs, he)


def fused_hmc_advance(plan: FusedHmc, state, n: int, store: bool, generator=None):
    """Advance ``n`` transitions through kernel B1 (its plain version for a
    state on the CPU). See ``_advance`` for the results."""
    return _advance(plan, state, n, store, generator, _run_chunk)


def _advance_mirror(plan: FusedHmc, state, n: int, store: bool, generator=None):
    """The same advance through the plain version on any device: with a
    generator in the same state it consumes the same draws as
    ``fused_hmc_advance``, so the two compare element by element."""
    return _advance(plan, state, n, store, generator, _reference_chunk)
