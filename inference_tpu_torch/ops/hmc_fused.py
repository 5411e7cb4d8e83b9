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
Everywhere else a ``GaussianForm`` is an ordinary posterior module. A
``Posterior`` of the library's models over a ``LinearForwardModel`` takes
the model route instead (``ops.hmc_model``: its ``ModelForm``, its own
kernel ``csrc/hmc_model.cu`` and launcher), with the same plain version and
the same chunked advance; ``plan_fused_hmc`` picks the route.

Up to ``P_NARROW`` (64) parameters the kernel is built once per parameter
count P and kind of mass, unit or diagonal (``kernel_variant``): one
library each in ``build/kernels/``, compiled at the first launch that needs
it, so every loop over P unrolls with no guards or padding and unit mass
skips its multiplies by 1. The form (``A``, ``mu`` and the inverse mass)
travels in each launch's kernel parameters, filled from host copies that
``_host_copy`` keeps. Above that one wide library serves every P and both
kinds of mass (the wide route), with the form as zero-padded device copies
(``wide_form``, built once per plan) and sizes that ``wide_plan`` chooses
per P and chain count: a block of chains shares each value of A it reads,
A resident in shared memory where it fits and streamed through a ring
above, or for the largest P one warp per chain.

Restrictions of the kernel, as of the JAX package's: ``retry=False``, no
reflecting bounds, unit/scalar/diagonal inverse mass, float32, one device.
On a CPU tensor the plain version runs instead; on a CUDA tensor the
kernel launches or the wrapper raises.
"""

import functools
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
from . import _build, hmc_model
from .hmc_model import ModelForm

_CHUNK = 64     # transitions per kernel launch
P_NARROW = 64  # the largest parameter count with a library of its own

# the wide route's tiled kernel (csrc/hmc_fused.cu, hmc_tile_kernel): a
# thread's tile of the gradient is TILE_ROWS rows by TILE_CHAINS chains
TILE_ROWS, TILE_CHAINS = 8, 4
TILE_THREADS = 256        # most threads of a block
TILE_CHAINS_MAX = 64      # most chains of a block
CHAIN_WORDS = 11          # shared-memory words per chain
SMEM_BLOCK = 232_448      # the 227 KB of shared memory a block may have
SMEM_HALF = 115_712       # the most a block may have for two blocks to share an SM
N_SMS = 132               # the H100's SMs: a plan keeps a block per SM where K allows
# the rings that stream A, (rows per stage, stages), in the order they are
# tried: the widest slabs first (the fewest barriers a product), then the
# deepest
RINGS = ((16, 3), (16, 2), (8, 3), (8, 2), (4, 3), (4, 2))
# the warp-per-chain kernel (hmc_wide_kernel), for P above the tiled kernel's reach
WARPS_MAX, SMEM_WARPS = 4, 200 * 1024

# launches of the CUDA kernel in this process; the wrapper adds one per launch
KERNEL_LAUNCHES = 0

# host copies of the form's device tensors: id -> (tensor, version, copy).
# Holding the tensor keeps its id unique; its version counter changes with
# every in-place write, which refreshes the copy.
_HOST_COPIES = {}
_HOST_COPIES_MAX = 16


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


def _reference_chunk(theta, logp, eps, inv_temp, z, us, ua, *, form, steps, inv_mass_diag, store):
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


def _host_copy(x):
    """A float32 host copy of ``x``, made once per tensor and version, so
    launches with an unchanged form read no device memory from the host
    (which would wait for the stream). An inference tensor has no version
    counter and is copied at every launch."""
    if x.is_inference():
        return x.detach().to("cpu", torch.float32).contiguous()
    hit = _HOST_COPIES.get(id(x))
    if hit is None or hit[1] != x._version:
        if hit is None and len(_HOST_COPIES) >= _HOST_COPIES_MAX:
            del _HOST_COPIES[next(iter(_HOST_COPIES))]  # the oldest
        hit = (x, x._version, x.detach().to("cpu", torch.float32).contiguous())
        _HOST_COPIES[id(x)] = hit
    return hit[2]


def kernel_variant(P: int, unit_mass: bool) -> tuple:
    """The nvcc defines of kernel B1's library for ``P`` parameters and
    unit (else diagonal) mass: one library per P and kind of mass up to
    ``P_NARROW``, the one wide library (``B1_P=0``) above."""
    if P > P_NARROW:
        return (("B1_P", 0),)
    return (("B1_P", P), ("B1_UNIT", int(unit_mass)))


def _ceil(x, m):
    return -(-x // m) * m


class WidePlan(NamedTuple):
    """Sizes of one wide-route launch (``wide_plan``)."""

    tiled: bool     # the tiled kernel, else one warp per chain
    chains: int     # chains per block
    rows: int       # P rounded up to 8: rows of the gradient, and of mu and the inverse mass
    depth: int      # rows of A a product walks
    slab: int       # rows of A per ring stage (0: A resident, or the warp kernel)
    stages: int     # ring stages (0: A resident, or the warp kernel)
    threads: int    # per block
    blocks: int
    smem: int       # bytes of shared memory per block


def _tile_smem(rows, depth, chains, slab, stages):
    """Shared memory of a tiled block in bytes, as ``tile_smem`` in
    ``csrc/hmc_fused.cu`` computes it: A (resident, or the ring), the centred
    tile and the positions, the partial sums, the form per row and the
    chains' words."""
    a = depth * rows if stages == 0 else stages * slab * rows
    return 4 * (a + 2 * depth * chains + 3 * (rows // TILE_ROWS) * chains + 3 * rows
                + CHAIN_WORDS * chains)


@functools.lru_cache(maxsize=None)
def wide_plan(P: int, K: int) -> WidePlan:
    """The wide route's sizes for ``P`` parameters and ``K`` chains, the
    same on any device (a pure function of the two).

    The tiled kernel's chains per block C are bounded by its threads (one
    8-row by 4-chain tile each, at most ``TILE_THREADS``), by
    ``TILE_CHAINS_MAX`` and by K (a block per SM where K allows). The
    largest such C (a multiple of 4) at which the block's tiles and A
    (resident) or a ring (the first of ``RINGS`` that fits) fit in half an
    SM's shared memory is taken, so two blocks share each SM and one hides
    the other's waits; where even C = 4 does not fit there, C = 4 with a
    whole SM's. A is resident exactly where it fits beside the tiles at
    that C. So C never grows as P grows. Where no tiled plan fits, one warp
    per chain (up to ``WARPS_MAX`` a block) takes any P up to 12,800;
    larger P raise ``ValueError``."""
    if P < 1 or K < 1:
        raise ValueError(f"the wide route takes P >= 1 and K >= 1, got P = {P}, K = {K}")
    rows = _ceil(P, TILE_ROWS)
    tile_rows = rows // TILE_ROWS
    top = min(TILE_CHAINS_MAX, TILE_CHAINS * (TILE_THREADS // tile_rows),
              _ceil(-(-K // N_SMS), TILE_CHAINS))
    tiles = [(_ceil(P, 4), 0, 0)] + [(_ceil(P, s), s, n) for s, n in RINGS]
    for budget, most in ((SMEM_HALF, top), (SMEM_BLOCK, min(top, TILE_CHAINS))):
        for C in range(most, TILE_CHAINS - 1, -TILE_CHAINS):
            threads = tile_rows * (C // TILE_CHAINS)
            for depth, slab, stages in tiles:
                smem = _tile_smem(rows, depth, C, slab, stages)
                if smem <= budget and C <= threads:
                    return WidePlan(True, C, rows, depth, slab, stages, threads, -(-K // C),
                                    smem)
    per_warp = 16 * rows
    if per_warp > SMEM_WARPS:
        raise ValueError(
            f"kernel B1's wide route takes at most {SMEM_WARPS // 16} parameters, got P = {P}"
        )
    warps = min(WARPS_MAX, SMEM_WARPS // per_warp)
    return WidePlan(False, warps, rows, rows, 0, 0, 32 * warps, -(-K // warps), warps * per_warp)


class WideForm(NamedTuple):
    """The wide route's form on the card, zero padded, so a padded row adds
    nothing to a product, a drift or an energy: A as ``(P rounded up to 16,
    P rounded up to 8)``, mu and the inverse mass (None: unit mass) as ``(P
    rounded up to 8,)`` float32 tensors."""

    A: torch.Tensor
    mu: torch.Tensor
    inv_mass: object


def wide_form(form, inv_mass_diag=None) -> WideForm:
    """``WideForm`` of a ``GaussianForm`` and a ``(P,)`` diagonal inverse
    mass (None: unit mass), on the form's device."""
    P = form.A.shape[0]
    rows = _ceil(P, TILE_ROWS)

    def pad(x, shape):
        out = torch.zeros(shape, dtype=torch.float32, device=form.A.device)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    im = None if inv_mass_diag is None else pad(inv_mass_diag.reshape(P), (rows,))
    return WideForm(pad(form.A, (_ceil(P, 16), rows)), pad(form.mu.reshape(P), (rows,)), im)


def _launch_chunk(
    theta, logp, eps, inv_temp, z, us, ua, *, form, steps, inv_mass_diag, store, padded=None
):
    """Launch kernel B1 for ``z.shape[0]`` transitions on CUDA tensors, with
    the signature and results of ``_reference_chunk``, through the library
    built for this P and kind of mass (the wide library above
    ``P_NARROW``, with the sizes of ``wide_plan``). Raises on a tensor the
    kernel does not take (not float32 or int32, wrong device, shape or
    layout; it never casts), and when that library fails to build, load or
    launch. The form's operands are checked on the card and launched from
    their host copies (``_host_copy``), or on the wide route from the padded
    device copies ``padded``, the ``WideForm`` of ``form`` and
    ``inv_mass_diag`` that a plan builds once (``plan_fused_hmc``); the wide
    route raises without it, the narrow one with it."""
    global KERNEL_LAUNCHES
    P, K = theta.shape
    chunk = z.shape[0]
    dev = theta.device
    if P < 1:
        raise ValueError(f"kernel B1 takes at least one parameter, got P = {P}")
    if chunk < 1 or K < 1:
        raise ValueError("kernel B1 needs at least one chain and one transition")
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
        ("A", form.A, (P, P), f32),
        ("mu", form.mu, (P,), f32),
    ]
    if inv_mass_diag is not None:  # None: unit mass, the kernel's own case
        operands.insert(11, ("inv_mass", inv_mass_diag, (P,), f32))
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
    wide = P > P_NARROW
    if (padded is None) == wide:
        raise ValueError(f"kernel B1 at P = {P} takes padded=" + (
            "wide_form(form, inv_mass_diag), the plan's padded form" if wide else "None"))
    if wide:
        rows = _ceil(P, TILE_ROWS)
        for name, x, shape in (("A", padded.A, (_ceil(P, 16), rows)), ("mu", padded.mu, (rows,)),
                               ("inv_mass", padded.inv_mass, (rows,))):
            if x is None:
                continue
            if x.dtype != f32 or x.device != dev or tuple(x.shape) != shape or not x.is_contiguous():
                raise ValueError(f"kernel B1: the padded {name} is not a contiguous float32 "
                                 f"{shape} tensor on {dev}")
        if (padded.inv_mass is None) != (inv_mass_diag is None):
            raise ValueError("kernel B1: the padded form's inverse mass does not match "
                             "inv_mass_diag")
    try:
        if wide:
            fn = _build.bind("hmc_fused", "hmc_fused_chunk_wide", 25, 10, kernel_variant(P, True))
        else:
            fn = _build.bind("hmc_fused", "hmc_fused_chunk", 25, 5,
                             kernel_variant(P, inv_mass_diag is None))
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"kernel B1 for P = {P} failed to build or load: {e}") from e
    max_steps = max(int(steps * 1.1), 1)
    sizes = (P, K, chunk, int(steps), max_steps)
    if wide:  # the form's operands (inv_mass, A, mu) as padded device copies
        form_ops = [padded.inv_mass, padded.A, padded.mu]
        plan = wide_plan(P, K)
        sizes += (plan.chains if plan.tiled else 0, plan.rows, plan.depth, plan.slab,
                  plan.stages)
    else:  # as host copies
        form_ops = [None if inv_mass_diag is None else _host_copy(inv_mass_diag),
                    _host_copy(form.A), _host_copy(form.mu)]
    ptrs = [x.data_ptr() for _, x, _, _ in operands[:11]]
    ptrs += [None if x is None else x.data_ptr() for x in form_ops]
    ptrs += [x.data_ptr() for x in outs]
    ptrs += [x.data_ptr() for x in hist] if store else [None] * 4
    with torch.cuda.device(dev):
        rc = fn(*ptrs, *sizes, _build.stream(dev))
    _build.raise_on(rc, f"B1 (P = {P}{', wide route' if wide else ''})")
    KERNEL_LAUNCHES += 1
    t_o, lp_o, ev_o, ea_o, evr_o, en_o, ec_o = outs
    return t_o, lp_o, AdaptiveScale(ev_o, ea_o, evr_o, en_o, ec_o), hist


def _run_chunk(*args, padded=None, **kw):
    """One chunk: the kernel on a CUDA tensor (with the plan's ``padded``
    form on the wide route and the model route), the plain version on a CPU
    tensor."""
    device = args[0].device
    if device.type == "cuda":
        if isinstance(kw["form"], ModelForm):
            return hmc_model._launch_model_chunk(*args, **kw, operands=padded)
        return _launch_chunk(*args, **kw, padded=padded)
    if device.type == "cpu":
        return _reference_chunk(*args, **kw)
    raise ValueError(f"no fused hmc path for device {device}")


class FusedHmc(NamedTuple):
    """Plan for fused advances over a ChainArray's HMC state. The
    posterior's operands live on ``form`` (a ``GaussianForm``, or the
    ``ModelForm`` of a model posterior), and on the card as the padded
    copies ``padded``, made once here, for the wide route (P >
    ``P_NARROW``, a float32 form on CUDA) and the model route (a form on
    CUDA); there is no global cache."""

    form: object            # GaussianForm | ModelForm
    steps: int
    inv_mass_diag: object   # None | tuple of P floats
    chunk: int
    padded: object = None   # None | WideForm | hmc_model.ModelOperands


def plan_fused_hmc(
    form, n_parameters: int, *, steps: int, inverse_mass=None, chunk: int = _CHUNK
):
    """Validate the configuration and build a fused-advance plan, or raise
    ``ValueError`` describing why the fused kernel cannot apply. ``form``
    is a ``GaussianForm``, or a ``Posterior`` (or a bare likelihood) that
    ``hmc_model.model_form`` takes: the model route."""
    if not isinstance(form, GaussianForm):
        form = hmc_model.model_form(form)
    size = form.A.shape[0] if isinstance(form, GaussianForm) else form.n_parameters
    if size != n_parameters:
        raise ValueError(
            f"[ fused hmc ] the {type(form).__name__} has {size} parameters, "
            f"the chains have {n_parameters}."
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
    padded = None
    if isinstance(form, ModelForm):
        if form.M.is_cuda:
            padded = hmc_model.model_operands(form, im)
    elif n_parameters > P_NARROW and form.A.is_cuda and form.A.dtype == torch.float32:
        diag = None if im is None else torch.tensor(im, dtype=torch.float32, device=form.A.device)
        padded = wide_form(form, diag)
    return FusedHmc(form=form, steps=int(steps), inv_mass_diag=im, chunk=int(chunk),
                    padded=padded)


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
    return _advance(plan, state, n, store, generator,
                    functools.partial(_run_chunk, padded=plan.padded))


def _advance_mirror(plan: FusedHmc, state, n: int, store: bool, generator=None):
    """The same advance through the plain version on any device: with a
    generator in the same state it consumes the same draws as
    ``fused_hmc_advance``, so the two compare element by element."""
    return _advance(plan, state, n, store, generator, _reference_chunk)
