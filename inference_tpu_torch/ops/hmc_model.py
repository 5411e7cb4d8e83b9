"""Kernel B1's model route: fused whole-trajectory HMC transitions of a
posterior of the library's own models.

The JAX package's fused kernel (``inference_tpu.ops.hmc_fused``) runs any
traceable posterior inside the kernel: it hoists the arrays of the user's
closure into operands and evaluates the posterior's jaxprs there. A CUDA
kernel cannot call a Python function, so the port reads the posterior
instead: a ``Posterior`` (or a bare likelihood) of ``models`` whose
likelihood is a ``GaussianLikelihood``, ``CauchyLikelihood`` or
``LogisticLikelihood`` over a ``LinearForwardModel(M, offset)``, with no
prior or ``GaussianPrior``, ``ExponentialPrior`` and ``UniformPrior``
components (alone or in a ``JointPrior``), becomes a ``ModelForm``
(``model_form``): M, y - offset, the per-datum inverse scale, the family,
the normalisation constants and the prior's per-variable parameters. Its
``value_cols``/``grad_cols`` are the plain version's posterior, the value
and the autodiff gradient of the posterior's ``__call__`` (not the
objects' ``.gradient()``: they differ outside an Exponential prior's
support, where autodiff of its ``where`` gives 0).

The kernel (``csrc/hmc_model.cu``, CUDA C++ for Hopper) runs a chunk of
transitions with the transition math of kernel B1 (``ops.hmc_fused``);
``_launch_model_chunk`` launches it with the sizes of ``model_plan`` on the
zero-padded float32 operands of ``model_operands``, which a plan builds
once. The plan takes one of two routes by shape alone (``model_route``):
the narrow one (P up to ``NARROW_P_MAX`` with M resident in shared memory:
a few lanes of a warp a chain) or the wide one (M streamed: a block of
chains, each thread one tile of their momenta in registers, or two where
P passes 2,048). Its plain
version is ``hmc_fused._reference_chunk`` driven by the form, which runs on
a CPU tensor; on a CUDA tensor the kernel launches or the wrapper raises.
One library per family, kind of mass and route, the narrow route's also
per P and the wide route's per tiles a thread (``kernel_variant``), built
at first use into ``build/kernels/``.
"""

import functools
import math
from typing import NamedTuple

import torch

from ..mcmc._kernels.common import AdaptiveScale
from ..models.likelihoods import (CauchyLikelihood, GaussianLikelihood, LinearForwardModel,
                                  LogisticLikelihood)
from ..models.posterior import Posterior
from ..models.priors import ExponentialPrior, GaussianPrior, JointPrior, UniformPrior
from . import _build

# launches of the CUDA kernel in this process; the wrapper adds one per launch
KERNEL_LAUNCHES = 0

FAMILIES = {GaussianLikelihood: 0, CauchyLikelihood: 1, LogisticLikelihood: 2}
FAMILY_NAMES = ("gaussian", "cauchy", "logistic")
# the prior's kinds per variable, as csrc/hmc_model.cu reads them (0: none)
PRIOR_KINDS = {GaussianPrior: 1, ExponentialPrior: 2, UniformPrior: 3}

TAKES = (
    "the fused kernel evaluates the posterior itself and takes a GaussianForm(A, mean), or a "
    "Posterior (or a bare likelihood) of the library's models: a GaussianLikelihood, "
    "CauchyLikelihood or LogisticLikelihood over a LinearForwardModel(M, offset), with no "
    "prior or GaussianPrior, ExponentialPrior and UniformPrior components (alone or in a "
    "JointPrior)"
)

# csrc/hmc_model.cu's launch: threads a block, the wide route's ring
# stages, rows of its momentum (gradient) and residual tiles (by 4 chains
# each), its momenta a block (one tile a thread; two tiles a thread, a
# library of its own, where 4 chains' momenta pass that) and words a chain,
# the shared memory a block may have and an SM has
THREADS, STAGES, TILE_ROWS, RES_ROWS, CHAIN_WORDS = 256, 3, 8, 4, 13
TILE_VALUES = TILE_ROWS * 4 * THREADS
WIDE_TILES_MAX = 2
SMEM_BLOCK = 232_448
SMEM_SM, SMEM_RESERVED = 233_472, 1_024  # an SM's 228 KB, and what the card keeps a block
N_SMS = 132            # the H100's SMs: a plan keeps a block per SM where K allows
RING_BYTES = 131_072   # the most the wide route's ring of slabs of M takes, but at 4 rows
SLAB_MAX = 256         # the most data rows a slab; M's rows are padded to a multiple
CHAINS_MAX = 64
# the narrow route: the most parameters, where the measurement puts it (its
# libraries are built per P; at 4,096 chains on an H100 it ran 21%, 13%
# and 6% faster than the wide route at P = 40, 44 and 48 with N = 1,024,
# and 3% and 6% at P = 48 and 52 with N = 768, even at 56 and 16% slower
# at 64, as its spills grow: PERF.md), resident rows a multiple of
# NARROW_ROWS
NARROW_P_MAX = 52
NARROW_ROWS = 32


def narrow_blocks_sm(P: int) -> int:
    """The most blocks of the narrow route an SM holds by its registers,
    as ``NARROW_BLOCKS_SM`` in ``csrc/hmc_model.cu``: two up to P = 16, one
    above."""
    return 2 if P <= 16 else 1


class ModelForm:
    """A posterior of the models as the kernel reads it. ``M`` ``(N, P)``,
    ``yo`` (y - offset) and ``w`` (the inverse scales) ``(N,)``, the
    family's index in ``FAMILY_NAMES``, the likelihood's normalisation
    ``lik_norm`` and the prior's components ``priors``: (kind, variable
    indices, parameter a, parameter b, normalisation), a and b being the
    mean and the inverse sigma (Gaussian), lambda and None (Exponential),
    the lower and upper bound (Uniform). Tensors on the posterior's device
    in its dtype. ``value_cols`` and ``grad_cols`` take ``(P, K)`` columns."""

    def __init__(self, M, yo, w, family, lik_norm, priors):
        self.M, self.yo, self.w = M, yo, w
        self.family = family
        self.lik_norm = lik_norm
        self.priors = priors
        self.n_data, self.n_parameters = M.shape
        self._outside = torch.tensor(-1e100, dtype=M.dtype, device=M.device)

    def to(self, dtype=None, device=None):
        """The same form with every tensor in ``dtype`` on ``device``."""
        cast = lambda x: None if x is None else x.to(
            device=device, dtype=dtype if x.is_floating_point() else x.dtype)
        return ModelForm(cast(self.M), cast(self.yo), cast(self.w), self.family,
                         cast(self.lik_norm),
                         [(k, cast(i), cast(a), cast(b), cast(n)) for k, i, a, b, n in self.priors])

    def _u(self, t):
        return (self.yo[:, None] - self.M @ t) * self.w[:, None]

    def value_cols(self, t):
        """Log-posterior of ``(P, K)`` column positions, shape ``(K,)``."""
        u = self._u(t)
        if self.family == 0:
            lik = -0.5 * (u**2).sum(dim=0)
        elif self.family == 1:
            lik = -torch.log1p(u**2).sum(dim=0)
        else:
            lik = u.sum(dim=0) - 2 * torch.logaddexp(torch.zeros_like(u), u).sum(dim=0)
        value = lik + self.lik_norm
        for kind, idx, a, b, norm in self.priors:
            x = t[idx]
            if kind == 1:
                z = (a[:, None] - x) * b[:, None]
                value = value + (-0.5 * (z**2).sum(dim=0) + norm)
            elif kind == 2:
                logp = -(a[:, None] * x).sum(dim=0) + norm
                value = value + torch.where((x < 0.0).any(dim=0), self._outside, logp)
            else:
                inside = ((a[:, None] <= x) & (x <= b[:, None])).all(dim=0)
                value = value + torch.where(inside, norm, self._outside)
        return value

    def grad_cols(self, t):
        """Gradient of ``value_cols`` by autodiff's rule, at ``(P, K)``
        column positions, shape ``(P, K)``."""
        u = self._u(t)
        w = self.w[:, None]
        if self.family == 0:
            dldf = u * w
        elif self.family == 1:
            dldf = 2 * w * u / (1 + u**2)
        else:
            dldf = (2 * torch.sigmoid(u) - 1) * w
        g = self.M.T @ dldf
        for kind, idx, a, b, _ in self.priors:
            x = t[idx]
            if kind == 1:
                g.index_add_(0, idx, (a[:, None] - x) * b[:, None] * b[:, None])
            elif kind == 2:
                lam = (-a[:, None]).expand_as(x)
                g.index_add_(0, idx, torch.where((x < 0.0).any(dim=0), torch.zeros_like(x), lam))
        return g


def _refuse(why):
    return ValueError(f"[ fused hmc ] {TAKES}; got {why}.")


def model_form(posterior) -> ModelForm:
    """The ``ModelForm`` of a ``Posterior`` or a bare likelihood the
    kernel takes, or ``ValueError`` naming what it takes."""
    if type(posterior) is Posterior:
        likelihood, prior = posterior.likelihood, posterior.prior
    elif type(posterior) in FAMILIES:
        likelihood, prior = posterior, None
    else:
        raise _refuse(f"{type(posterior).__name__} (a Python function, a numpy posterior or "
                      "another object, which the kernel cannot call)")
    if type(likelihood) not in FAMILIES:
        raise _refuse(f"the likelihood {type(likelihood).__name__}")
    model = likelihood.model
    if not isinstance(model, LinearForwardModel):
        raise _refuse(f"a forward model that is {type(model).__name__}, not a "
                      "LinearForwardModel")
    if model.n_data != likelihood.n_data:
        raise ValueError(f"[ fused hmc ] the LinearForwardModel has {model.n_data} rows, the "
                         f"likelihood {likelihood.n_data} data")
    like = dict(dtype=likelihood.y.dtype, device=likelihood.y.device)
    family = FAMILIES[type(likelihood)]
    w = getattr(likelihood, ("inv_sigma", "inv_gamma", "inv_scale")[family])
    yo = likelihood.y if model.offset is None else likelihood.y - model.offset.to(**like)
    components = [] if prior is None else (
        prior.components if type(prior) is JointPrior else [prior])
    priors = []
    for c in components:
        kind = PRIOR_KINDS.get(type(c))
        if kind is None:
            raise _refuse(f"the prior {type(c).__name__}")
        idx = torch.as_tensor(c.variables, dtype=torch.long, device=like["device"])
        if int(idx.max()) >= model.n_parameters:
            raise ValueError(f"[ fused hmc ] the prior {type(c).__name__} names variable "
                             f"{int(idx.max())}, the forward model has {model.n_parameters}")
        a, b = {1: ("mean", "inv_sigma"), 2: ("lam", None), 3: ("lower", "upper")}[kind]
        a, b = getattr(c, a), None if b is None else getattr(c, b)
        priors.append((kind, idx, a.to(**like), None if b is None else b.to(**like),
                       c.normalisation.to(**like)))
    return ModelForm(model.M.to(**like), yo.contiguous(), w.contiguous(), family,
                     likelihood.normalisation, priors)


def kernel_variant(family: int, unit_mass: bool, narrow_p: int = 0, tiles: int = 1) -> tuple:
    """The nvcc defines of the model route's library for a family (an
    index of ``FAMILY_NAMES``) and unit (else diagonal) mass: the narrow
    route's for ``narrow_p`` parameters, the wide route's for 0 with
    ``tiles`` momentum tiles a thread (``model_variant`` names the one a
    shape takes)."""
    return (("HM_FAMILY", int(family)), ("HM_UNIT", int(unit_mass)), ("HM_P", int(narrow_p)),
            ("HM_TILES", int(tiles)))


def wide_tiles(P: int) -> int:
    """The wide route's momentum tiles a thread at P: one while 4 chains'
    momenta fit one 8 x 4 tile a thread (P up to 2,048), else two."""
    return 1 if _ceil(P, TILE_ROWS) * 4 <= TILE_VALUES else 2


def model_variant(family: int, unit_mass: bool, P: int, N: int) -> tuple:
    """``kernel_variant`` of the library that runs P parameters and N data:
    the narrow route's for P, or the wide route's for its tiles a thread
    (``model_route``, ``wide_tiles``)."""
    if model_route(P, N) == "narrow":
        return kernel_variant(family, unit_mass, P)
    return kernel_variant(family, unit_mass, 0, wide_tiles(P))


def _ceil(x, m):
    return -(-x // m) * m


class ModelPlan(NamedTuple):
    """Sizes of one launch (``model_plan``)."""

    route: str    # "narrow" (T lanes a chain, M resident) or "wide" (M streamed)
    chains: int   # chains per block: 256 / lanes (narrow), a power of two from 4 to 64 (wide)
    lanes: int    # narrow: lanes of a warp a chain, a power of two from 1 to 32; wide: 0
    rows: int     # narrow: resident data rows, N rounded up to 32; wide: P rounded up to 8
    stride: int   # words a row of M in shared memory: narrow_width(P), or rows + 4 (the ring)
    slab: int     # wide: data rows per ring stage, a power of two from 4 to 256; narrow: 0
    ga: int       # wide: groups the residual's contraction over P is split in; narrow: 0
    gc: int       # wide: groups a pass's data rows are split in for the gradient; narrow: 0
    tiles: int    # wide: momentum tiles a thread, 1, or 2 past P = 2,048 (``wide_tiles``); narrow: 0
    blocks: int
    smem: int     # bytes of shared memory per block


def narrow_width(P: int) -> int:
    """Words of a resident row on the narrow route: M's P, y - offset and
    the inverse scale, zeros up to a multiple of 4 that is 4 mod 8 (so 8
    lanes reading 8 consecutive rows hit distinct banks), as
    ``narrow_width`` in ``csrc/hmc_model.cu``."""
    w = _ceil(P + 2, 4)
    return w + 4 if w % 8 == 0 else w


def _narrow_smem(rows, P):
    """Shared memory of a narrow block in bytes, as ``narrow_smem`` in
    ``csrc/hmc_model.cu`` computes it: the resident rows and the four
    per-variable words."""
    return 4 * (rows * narrow_width(P) + 4 * _ceil(P, TILE_ROWS))


def _wide_smem(rows, chains, slab, ga, gc):
    """Shared memory of a wide block in bytes, as ``wide_smem`` in
    ``csrc/hmc_model.cu`` computes it: the ring, the positions, psi's two
    buffers, the groups' partial sums, the owners' partial sums, the
    likelihood's and the chains' words (the per-variable words are read
    through L1)."""
    words = (STAGES * slab * (rows + 4) + rows * chains + 2 * slab * chains
             + (ga * slab * chains if ga > 1 else 0) + ((gc - 1) * rows * chains if gc > 1 else 0)
             + 3 * (rows // TILE_ROWS) * chains + 4 * THREADS + CHAIN_WORDS * chains)
    return 4 * words


def _pow2_at_least(x):
    return 1 << max(0, math.ceil(math.log2(max(x, 1))))


def model_route(P: int, N: int) -> str:
    """The route of P parameters and N data, by shape alone: "narrow" up to
    ``NARROW_P_MAX`` parameters where M, y - offset and the inverse scales
    fit a block's shared memory (N rounded up to 32 rows of
    ``narrow_width(P)`` words), else "wide"."""
    if P <= NARROW_P_MAX and _narrow_smem(_ceil(N, NARROW_ROWS), P) <= SMEM_BLOCK:
        return "narrow"
    return "wide"


@functools.lru_cache(maxsize=None)
def model_plan(P: int, K: int, N: int) -> ModelPlan:
    """The model route's sizes for P parameters, K chains and N data, the
    same on any device; the route from ``model_route``.

    Narrow: lanes a chain T, the largest power of two up to 32 whose blocks
    (256 / T chains each) all fit on the card at once, at most
    ``narrow_blocks_sm(P)`` per SM and as many as the resident rows let
    share one; 1 where K is larger.

    Wide: chains a block C, the smallest power of two that keeps a block
    per SM where K allows, from 4 to 64, halved while the block's momenta
    exceed one 8 x 4 tile a thread or its shared memory the block's; at 4
    chains, two tiles a thread where one does not hold them (P above
    2,048). Rows a slab: the largest power of two up to 256 (and up to N
    rounded up) whose ring of 3 stages takes at most ``RING_BYTES``, or 4.
    The residual's contraction over P is split in groups, none empty,
    until its 4 x 4 tiles fill the threads; a pass's data rows in groups
    until the gradient's tiles do. P beyond the wide block at 4 chains
    raises ``ValueError``."""
    if P < 1 or K < 1 or N < 1:
        raise ValueError(f"the model route takes P, K, N >= 1, got {P}, {K}, {N}")
    if model_route(P, N) == "narrow":
        rows = _ceil(N, NARROW_ROWS)
        smem = _narrow_smem(rows, P)
        per_sm = max(1, min(narrow_blocks_sm(P), SMEM_SM // (smem + SMEM_RESERVED)))
        lanes = 32
        while lanes > 1 and -(-K * lanes // THREADS) > N_SMS * per_sm:
            lanes //= 2
        chains = THREADS // lanes
        return ModelPlan("narrow", chains, lanes, rows, narrow_width(P), 0, 0, 0, 0,
                         -(-K // chains), smem)
    rows = _ceil(P, TILE_ROWS)
    chains = min(CHAINS_MAX, max(4, _pow2_at_least(-(-K // N_SMS))))
    while chains > 4 and rows * chains > TILE_VALUES:
        chains //= 2
    slab = min(SLAB_MAX, max(4, _pow2_at_least(N)))
    while slab > 4 and 4 * STAGES * slab * (rows + 4) > RING_BYTES:
        slab //= 2
    while rows * chains <= WIDE_TILES_MAX * TILE_VALUES:
        ga, gc, smem = _groups(rows, chains, slab)
        if smem <= SMEM_BLOCK:
            return ModelPlan("wide", chains, 0, rows, rows + 4, slab, ga, gc, wide_tiles(P),
                             -(-K // chains), smem)
        if chains == 4:
            break
        chains //= 2
    raise ValueError(f"kernel B1's model route takes at most {model_p_max()} parameters, got "
                     f"P = {P}")


def _groups(rows, chains, slab):
    """The contraction groups of each wide product (enough tiles to fill
    the block's threads, no residual group empty; none for the gradient
    where its tiles pass the threads) and the block's shared memory."""
    tiles_a, tiles_c = slab // RES_ROWS * chains // 4, rows // TILE_ROWS * chains // 4
    quads = rows // 4
    ga = max(1, min(THREADS // tiles_a, quads))
    ga = -(-quads // -(-quads // ga))  # as many groups as a group's share of quads leaves
    gc = max(1, min(THREADS // tiles_c, slab))
    return ga, gc, _wide_smem(rows, chains, slab, ga, gc)


@functools.lru_cache(maxsize=None)
def model_p_max() -> int:
    """The largest P the wide route takes: two 8 x 4 momentum tiles a
    thread at 4 chains, its block within a block's shared memory at 4 rows
    a slab."""
    lo, hi = 1, WIDE_TILES_MAX * TILE_VALUES // 4
    while lo < hi:
        mid = (lo + hi + 1) // 2
        fits = _groups(_ceil(mid, TILE_ROWS), 4, 4)[2] <= SMEM_BLOCK
        lo, hi = (mid, hi) if fits else (lo, mid - 1)
    return lo


class ModelOperands(NamedTuple):
    """The form on the card, float32 and zero padded, for the route of its
    P and N (``model_route``). ``M``: on the wide route ``(N rounded up to
    SLAB_MAX, P rounded up to 8, plus 4)``, the ring's rows, y - offset and
    the inverse scale in the words after the padded P; on the narrow route
    ``(N rounded up to 32, narrow_width(P))``, each row M's, then y - offset
    and the inverse scale. ``vec``: the inverse mass (ones for unit mass),
    the prior's kind, a and b per row (``P`` rounded up to 8 each), the
    whole normalisation, 3 words of padding. ``unit`` says which mass."""

    M: torch.Tensor
    vec: torch.Tensor
    unit: bool
    route: str


def _operand_shapes(P, N):
    """The shapes of ``ModelOperands``' M and vec for P and N."""
    rows = _ceil(P, TILE_ROWS)
    if model_route(P, N) == "narrow":
        return (_ceil(N, NARROW_ROWS), narrow_width(P)), (4 * rows + 4,)
    return (_ceil(N, SLAB_MAX), rows + 4), (4 * rows + 4,)


def model_operands(form: ModelForm, inv_mass_diag=None) -> ModelOperands:
    """``ModelOperands`` of a form and a ``(P,)`` diagonal inverse mass
    (None: unit mass), on the form's device."""
    N, P = form.M.shape
    rows = _ceil(P, TILE_ROWS)
    route = model_route(P, N)
    m_shape, _ = _operand_shapes(P, N)
    f32 = dict(dtype=torch.float32, device=form.M.device)
    M = torch.zeros(m_shape, **f32)
    M[:N, :P] = form.M
    at = P if route == "narrow" else rows  # the words of y - offset and the scale
    M[:N, at], M[:N, at + 1] = form.yo, form.w
    vec = torch.zeros(4 * rows + 4, **f32)
    vec[:rows] = 1.0
    if inv_mass_diag is not None:
        vec[:P] = torch.as_tensor(inv_mass_diag).reshape(P)
    norm = float(form.lik_norm)
    for kind, idx, a, b, c_norm in form.priors:
        vec[rows + idx] = float(kind)
        vec[2 * rows + idx] = a.to(torch.float32)
        if b is not None:
            vec[3 * rows + idx] = b.to(torch.float32)
        norm += float(c_norm)
    vec[4 * rows] = norm
    return ModelOperands(M, vec, inv_mass_diag is None, route)


def _launch_model_chunk(theta, logp, eps, inv_temp, z, us, ua, *, form, steps, inv_mass_diag,
                        store, operands):
    """Launch the model route for ``z.shape[0]`` transitions on CUDA
    tensors, with the signature and results of
    ``hmc_fused._reference_chunk`` driven by ``form``, on the padded
    ``operands`` a plan built once (``model_operands`` of the same form and
    mass), with the sizes of ``model_plan``. Raises on a tensor the kernel
    does not take (not float32 or int32, wrong device, shape or layout; it
    never casts), and when its library fails to build, load or launch."""
    global KERNEL_LAUNCHES
    P, K = theta.shape
    chunk = z.shape[0]
    dev = theta.device
    N = form.n_data
    if P != form.n_parameters:
        raise ValueError(f"the model route: theta has {P} parameters, the form "
                         f"{form.n_parameters}")
    if chunk < 1 or K < 1:
        raise ValueError("the model route needs at least one chain and one transition")
    f32, i32 = torch.float32, torch.int32
    checks = [
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
    ]
    for name, x, shape, dtype in checks:
        if x.dtype != dtype:
            raise TypeError(f"the model route takes {name} as {dtype}, got {x.dtype}; it has no "
                            "float64 form, and the wrapper does not cast")
        if x.device != dev:
            raise ValueError(f"the model route: {name} is on {x.device}, theta on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"the model route: {name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
        if not x.is_contiguous():
            raise ValueError(f"the model route: {name} is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"the model route runs on CUDA tensors, got {dev}")
    if operands is None:
        raise ValueError("the model route takes operands=model_operands(form, inv_mass_diag), "
                         "the plan's padded form")
    plan = model_plan(P, K, N)
    if operands.route != plan.route:
        raise ValueError(f"the model route: the padded form is the {operands.route} route's, "
                         f"the plan's is {plan.route}")
    for name, x, shape in zip(("M", "vec"), operands[:2], _operand_shapes(P, N)):
        if x.dtype != f32 or x.device != dev or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"the model route: the padded {name} is not a contiguous float32 "
                             f"{shape} tensor on {dev}")
    if operands.unit != (inv_mass_diag is None):
        raise ValueError("the model route: the padded form's inverse mass does not match "
                         "inv_mass_diag")

    empty = lambda shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    outs = [empty((P, K)), empty((K,)), empty((K,)), empty((K,)), empty((K,)),
            empty((K,), i32), empty((K,), i32)]
    hist = ((empty((chunk, P, K)), empty((chunk, K)), empty((chunk, K), i32), empty((chunk, K)))
            if store else None)
    try:
        fn = _build.bind("hmc_model", "hmc_model_chunk", 24, 14,
                         model_variant(form.family, operands.unit, P, N))
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the model route ({FAMILY_NAMES[form.family]}, {plan.route}, P = "
                           f"{P}) failed to build or load: {e}") from e
    ptrs = [x.data_ptr() for _, x, _, _ in checks]
    ptrs += [operands.M.data_ptr(), operands.vec.data_ptr()]
    ptrs += [x.data_ptr() for x in outs]
    ptrs += [x.data_ptr() for x in hist] if store else [None] * 4
    sizes = (P, K, N, chunk, int(steps), max(int(steps * 1.1), 1), plan.chains, plan.lanes,
             plan.rows, plan.stride, plan.slab, plan.ga, plan.gc, int(operands.unit))
    with torch.cuda.device(dev):
        rc = fn(*ptrs, *sizes, _build.stream(dev))
    _build.raise_on(rc, f"B1 model route ({FAMILY_NAMES[form.family]}, {plan.route}, P = {P}, "
                        f"N = {N})")
    KERNEL_LAUNCHES += 1
    t_o, lp_o, ev_o, ea_o, evr_o, en_o, ec_o = outs
    return t_o, lp_o, AdaptiveScale(ev_o, ea_o, evr_o, en_o, ec_o), hist
