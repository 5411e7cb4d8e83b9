"""Move HMC chain state, posteriors and GP models between the JAX package
and this one.

The JAX package's batched ``HmcState`` flattens (``jax.tree.flatten``) to 11
leaves, in this order: theta ``(K, P)``, logp ``(K,)``, the five step-size
fields ``eps.value``/``avg``/``var``/``num``/``chk_int`` ``(K,)``, the
PRNG key ``(K, 2)`` uint32, failed ``(K,)`` bool, inv_temp ``(K,)`` and
steps ``(K,)`` int32. This module reads and writes that list as numpy
arrays. The key leaf is read and ignored: the two packages' random streams
differ by design.

A ``GpRegressor`` crosses as its state: x, y, y_err or y_cov,
hyperparameters, ``pad_to`` as numpy values, and its kernel and mean as
class names (a kernel spec nests for ``CompositeCovariance`` and
``ChangePoint``). ``gp_state_of`` reads that state off a JAX model by its
attributes; ``gp_regressor_from_state`` builds the port's model from it.
A ``GpOptimiser`` crosses the same way, with its bounds, acquisition,
optimizer and histories (``gp_optimiser_state_of``,
``gp_optimiser_from_state``).
A solved ``LargeScaleGP`` of any tier crosses the same way
(``large_scale_state_of``, ``large_scale_gp_from_state``), with its
settings, training solve and preconditioner factor, so it is not solved
again; so does a solved ``LargeScaleGpLinearInverter``
(``large_inverter_state_of``, ``large_inverter_from_state``) with its
data-space solution. Only numpy values and names cross.

The JAX package's batched ``MetropolisState`` (the gibbs and metropolis
kinds) flattens to 10 leaves: theta ``(K, P)``, logp ``(K,)``, the five
width fields ``widths.value``/``avg``/``var``/``num``/``chk_int`` ``(K, P)``,
try_count ``(K, P)`` int32, the key ``(K, 2)`` uint32 and inv_temp
``(K,)``; its ``PcaState`` adds directions ``(K, P, P)`` as an 11th
(``metropolis_state_from_jax``, ``metropolis_state_to_jax_leaves``).

The JAX package's batched ``NutsState`` (the nuts kind) flattens to 11
leaves: theta ``(K, P)``, logp ``(K,)``, the cached tempered gradient
``(K, P)``, the five step-size fields ``(K,)``, the key ``(K, 2)`` uint32,
divergences ``(K,)`` int32 and inv_temp ``(K,)`` (``nuts_state_from_jax``,
``nuts_state_to_jax_leaves``).

The JAX package's batched ``EnsembleState`` (the ensemble kind) flattens
to 4 leaves: walkers ``(K, W, P)``, logps ``(K, W)``, the key ``(K, 2)``
uint32 and inv_temp ``(K,)`` (``ensemble_state_from_jax``,
``ensemble_state_to_jax_leaves``).

A ``HamiltonianChain``, ``NutsChain``, ``GibbsChain``, ``MetropolisChain``,
``PcaChain`` or ``EnsembleSampler`` crosses as its checkpoint items, the
``.npz`` keys both packages save (``hamiltonian_chain_from_jax``,
``nuts_chain_from_jax``, ``gibbs_chain_from_jax``,
``pca_chain_from_jax``, ``ensemble_sampler_from_jax``, which also carries
the sampler's inverse temperature and ``retry``); a ``ParallelTempering``
crosses as its chains (``parallel_tempering_from_jax``).
``bounds_from_numpy`` and ``mass_from_numpy`` build the port's ``Bounds``
and particle mass from numpy arrays.
"""

import io

import numpy as np
import torch

from . import gp as _gp
from .mcmc._kernels.common import AdaptiveScale
from .mcmc._kernels.ensemble import EnsembleState
from .mcmc._kernels.hmc import HmcState
from .mcmc._kernels.metropolis import MetropolisState, PcaState
from .mcmc._kernels.nuts import NutsState
from .mcmc.ensemble import EnsembleSampler
from .mcmc.gibbs import GibbsChain, MetropolisChain
from .mcmc.hmc import HamiltonianChain
from .mcmc.nuts import NutsChain
from .mcmc.parallel import ParallelTempering
from .mcmc.pca import PcaChain
from .mcmc.hmc.mass import get_particle_mass
from .ops.hmc_fused import GaussianForm
from .utils.bounds import Bounds
from .utils.device import resolve_device
from .utils.dtypes import default_float

N_HMC_LEAVES = 11
N_METROPOLIS_LEAVES = 10  # a PcaState has one more, its directions
N_ENSEMBLE_LEAVES = 4
N_NUTS_LEAVES = 11


def hmc_state_from_jax(leaves, device="cuda", dtype=None) -> HmcState:
    """The port's ``HmcState`` from the 11 leaves of a JAX ``HmcState``, on
    ``device`` (the card unless the caller passes ``"cpu"``). Floating
    leaves take ``dtype`` (default: theta's own dtype)."""
    device = resolve_device(device, "hmc_state_from_jax")
    if len(leaves) != N_HMC_LEAVES:
        raise ValueError(
            f"an HmcState has {N_HMC_LEAVES} leaves, got {len(leaves)}"
        )
    theta, logp, ev, ea, evr, en, ec, _key, failed, inv_temp, steps = (
        np.asarray(x) for x in leaves
    )
    dtype = dtype or torch.as_tensor(theta).dtype
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return HmcState(
        theta=f(theta),
        logp=f(logp),
        eps=AdaptiveScale(f(ev), f(ea), f(evr), i(en), i(ec)),
        failed=torch.tensor(failed, dtype=torch.bool, device=device),
        inv_temp=f(inv_temp),
        steps=i(steps),
    )


def hmc_state_to_jax_leaves(state: HmcState, key) -> list:
    """The 11 leaves of a JAX ``HmcState`` as numpy arrays, with ``key`` (a
    ``(K, 2)`` uint32 array) as the key leaf."""
    host = lambda x: x.detach().cpu().numpy()
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (state.theta.shape[0], 2):
        raise ValueError(f"the key leaf must be (K, 2), got {key.shape}")
    return [
        host(state.theta),
        host(state.logp),
        *(host(x) for x in state.eps),
        key,
        host(state.failed),
        host(state.inv_temp),
        host(state.steps),
    ]


def nuts_state_from_jax(leaves, device="cuda", dtype=None) -> NutsState:
    """The port's ``NutsState`` from the 11 leaves of a JAX batched
    ``NutsState``, on ``device`` (the card unless the caller passes
    ``"cpu"``). Floating leaves take ``dtype`` (default: theta's own dtype);
    the key leaf is read and ignored."""
    device = resolve_device(device, "nuts_state_from_jax")
    if len(leaves) != N_NUTS_LEAVES:
        raise ValueError(f"a NutsState has {N_NUTS_LEAVES} leaves, got {len(leaves)}")
    theta, logp, grad, ev, ea, evr, en, ec, _key, divergences, inv_temp = (
        np.asarray(x) for x in leaves
    )
    dtype = dtype or torch.tensor(theta[:0]).dtype
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return NutsState(
        theta=f(theta),
        logp=f(logp),
        grad=f(grad),
        eps=AdaptiveScale(f(ev), f(ea), f(evr), i(en), i(ec)),
        divergences=i(divergences),
        inv_temp=f(inv_temp),
    )


def nuts_state_to_jax_leaves(state: NutsState, key) -> list:
    """The 11 leaves of a JAX batched ``NutsState`` as numpy arrays, with
    ``key`` (a ``(K, 2)`` uint32 array) as the key leaf."""
    host = lambda x: x.detach().cpu().numpy()
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (state.theta.shape[0], 2):
        raise ValueError(f"the key leaf must be (K, 2), got {key.shape}")
    return [
        host(state.theta),
        host(state.logp),
        host(state.grad),
        *(host(x) for x in state.eps),
        key,
        host(state.divergences),
        host(state.inv_temp),
    ]


def metropolis_state_from_jax(leaves, device="cuda", dtype=None):
    """The port's ``MetropolisState`` from the 10 leaves of a JAX
    ``MetropolisState``, or its ``PcaState`` from the 11 of a JAX
    ``PcaState``, on ``device`` (the card unless the caller passes
    ``"cpu"``). Floating leaves take ``dtype`` (default: theta's own
    dtype); the key leaf is read and ignored."""
    device = resolve_device(device, "metropolis_state_from_jax")
    if len(leaves) not in (N_METROPOLIS_LEAVES, N_METROPOLIS_LEAVES + 1):
        raise ValueError(
            f"a MetropolisState has {N_METROPOLIS_LEAVES} leaves and a PcaState "
            f"{N_METROPOLIS_LEAVES + 1}, got {len(leaves)}"
        )
    leaves = [np.asarray(x) for x in leaves]
    theta, logp, wv, wa, wvr, wn, wc, tries, _key, inv_temp = leaves[:N_METROPOLIS_LEAVES]
    dtype = dtype or torch.tensor(theta[:0]).dtype
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    state = MetropolisState(
        theta=f(theta),
        logp=f(logp),
        widths=AdaptiveScale(f(wv), f(wa), f(wvr), i(wn), i(wc)),
        try_count=i(tries),
        inv_temp=f(inv_temp),
    )
    if len(leaves) == N_METROPOLIS_LEAVES:
        return state
    return PcaState(*state, directions=f(leaves[-1]))


def metropolis_state_to_jax_leaves(state, key) -> list:
    """The 10 leaves of a JAX ``MetropolisState`` (11 of a ``PcaState``) as
    numpy arrays, with ``key`` (a ``(K, 2)`` uint32 array) as the key
    leaf."""
    host = lambda x: x.detach().cpu().numpy()
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (state.theta.shape[0], 2):
        raise ValueError(f"the key leaf must be (K, 2), got {key.shape}")
    leaves = [
        host(state.theta),
        host(state.logp),
        *(host(x) for x in state.widths),
        host(state.try_count),
        key,
        host(state.inv_temp),
    ]
    if isinstance(state, PcaState):
        leaves.append(host(state.directions))
    return leaves


def ensemble_state_from_jax(leaves, device="cuda", dtype=None) -> EnsembleState:
    """The port's ``EnsembleState`` from the 4 leaves of a JAX batched
    ``EnsembleState``, on ``device`` (the card unless the caller passes
    ``"cpu"``). Floating leaves take ``dtype`` (default: the walkers' own
    dtype); the key leaf is read and ignored."""
    device = resolve_device(device, "ensemble_state_from_jax")
    if len(leaves) != N_ENSEMBLE_LEAVES:
        raise ValueError(
            f"an EnsembleState has {N_ENSEMBLE_LEAVES} leaves, got {len(leaves)}"
        )
    walkers, logps, _key, inv_temp = (np.asarray(x) for x in leaves)
    dtype = dtype or torch.tensor(walkers[:0]).dtype
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return EnsembleState(walkers=f(walkers), logps=f(logps), inv_temp=f(inv_temp))


def ensemble_state_to_jax_leaves(state: EnsembleState, key) -> list:
    """The 4 leaves of a JAX batched ``EnsembleState`` as numpy arrays, with
    ``key`` (a ``(K, 2)`` uint32 array) as the key leaf."""
    host = lambda x: x.detach().cpu().numpy()
    key = np.asarray(key, dtype=np.uint32)
    if key.shape != (state.walkers.shape[0], 2):
        raise ValueError(f"the key leaf must be (K, 2), got {key.shape}")
    return [host(state.walkers), host(state.logps), key, host(state.inv_temp)]


def _checkpoint_buffer(chain):
    """A JAX chain's ``.npz`` checkpoint, written into memory by its own
    ``save``."""
    buffer = io.BytesIO()
    chain.save(buffer)
    buffer.seek(0)
    return buffer


def gibbs_chain_from_jax(chain, posterior=None, seed=None, device="cuda"):
    """The port's ``GibbsChain`` (or ``MetropolisChain``, after the JAX
    chain's class) carrying a JAX chain's state on ``device`` (default the
    card): its history, width adaptation and trace, proposal modes and
    settings, read from the ``.npz`` items its own ``save`` writes. With
    ``posterior`` it continues from the last stored step."""
    cls = MetropolisChain if type(chain).__name__ == "MetropolisChain" else GibbsChain
    return cls.load(_checkpoint_buffer(chain), posterior=posterior, seed=seed, device=device)


def pca_chain_from_jax(chain, posterior=None, seed=None, device="cuda"):
    """The port's ``PcaChain`` carrying a JAX ``PcaChain``'s state on
    ``device`` (default the card), as ``gibbs_chain_from_jax`` does, with
    its directions, blended covariance, update schedule and bounds."""
    return PcaChain.load(_checkpoint_buffer(chain), posterior=posterior, seed=seed, device=device)


def ensemble_sampler_from_jax(sampler, posterior=None, seed=None, device="cuda"):
    """The port's ``EnsembleSampler`` carrying a JAX ``EnsembleSampler``'s
    state on ``device`` (default the card): its walkers and their
    log-probabilities, history, proposal counts and settings, read from the
    ``.npz`` items its own ``save`` writes, with its inverse temperature and
    ``retry``. With ``posterior`` it continues from the stored walkers."""
    state = getattr(sampler, "_state", None)
    inv_temp = 1.0 if state is None else float(np.asarray(state.inv_temp))
    port = EnsembleSampler.from_items(np.load(_checkpoint_buffer(sampler)), posterior, seed,
                                      device, inv_temp=inv_temp)
    port.retry = sampler.retry
    return port


def parallel_tempering_from_jax(pt, posterior, grad=None, seed=None, device="cuda"):
    """The port's ``ParallelTempering`` over the chains of a JAX
    ``ParallelTempering`` (its states synchronised first), each carried by
    its class's conversion above on ``device`` (default the card), at its
    temperature. ``posterior`` is the torch (or numpy) posterior of every
    rung; ``grad`` goes to the HMC and NUTS rungs; rung k's generator takes ``seed +
    k`` when a seed is given. The pairing stream ``rng`` starts afresh."""
    rungs = []
    for k, chain in enumerate(pt.return_chains()):
        kw = dict(seed=None if seed is None else seed + k, device=device)
        name = type(chain).__name__
        if name == "HamiltonianChain":
            rungs.append(hamiltonian_chain_from_jax(chain, posterior, grad=grad, **kw))
        elif name == "NutsChain":
            rungs.append(nuts_chain_from_jax(chain, posterior, grad=grad, **kw))
        elif name == "PcaChain":
            rungs.append(pca_chain_from_jax(chain, posterior, **kw))
        elif name in ("GibbsChain", "MetropolisChain"):
            rungs.append(gibbs_chain_from_jax(chain, posterior, **kw))
        else:
            raise ValueError(f"a {name} rung has no conversion in inference_tpu_torch yet")
    return ParallelTempering(rungs)


def gaussian_form_from_numpy(icov, mean=None) -> GaussianForm:
    """The posterior ``-1/2 (theta - mean)^T icov (theta - mean)`` as a
    ``GaussianForm`` in torch's default dtype."""
    return GaussianForm(
        torch.as_tensor(np.asarray(icov, dtype=float)),
        None if mean is None else torch.as_tensor(np.asarray(mean, dtype=float)),
    )


def hamiltonian_chain_from_jax(chain, posterior, grad=None, seed=None, device="cuda"):
    """The port's ``HamiltonianChain`` carrying a JAX ``HamiltonianChain``'s
    state on ``device`` (default the card): its history, step-size
    adaptation, mass, bounds and settings, read from the ``.npz`` items its
    own ``save`` writes (into memory). With ``posterior`` (a torch
    callable) it continues from the last stored step."""
    return HamiltonianChain.from_items(
        np.load(_checkpoint_buffer(chain)), posterior=posterior, grad=grad, seed=seed,
        device=device,
    )


def nuts_chain_from_jax(chain, posterior, grad=None, seed=None, device="cuda"):
    """The port's ``NutsChain`` carrying a JAX ``NutsChain``'s state on
    ``device`` (default the card): its history with the tree depths and
    divergence flags, step-size adaptation, mass, ``max_depth`` and
    divergence count, read from the ``.npz`` items its own ``save`` writes.
    With ``posterior`` it continues from the last stored step."""
    return NutsChain.from_items(
        np.load(_checkpoint_buffer(chain)), posterior=posterior, grad=grad, seed=seed,
        device=device,
    )


def bounds_from_numpy(lower, upper) -> Bounds:
    """The port's ``Bounds`` from numpy lower and upper bounds."""
    return Bounds(np.asarray(lower, dtype=float), np.asarray(upper, dtype=float))


def mass_from_numpy(inverse_mass, n_parameters: int, device="cuda", dtype=None):
    """The port's particle mass (scalar, diagonal or full matrix) from a
    numpy inverse mass, its maps in ``dtype`` (default
    ``default_float()``) on ``device`` (default the card)."""
    return get_particle_mass(
        np.asarray(inverse_mass, dtype=float), n_parameters,
        dtype=dtype or default_float(), device=resolve_device(device, "mass_from_numpy"),
    )


def _kernel_spec(cov):
    """A covariance object as nested names: ``"SquaredExponential"``,
    ``{"sum": [...]}`` or ``{"change_point": [...], "axis": a}``."""
    name = type(cov).__name__
    if name == "CompositeCovariance":
        return {"sum": [_kernel_spec(c) for c in cov.components]}
    if name == "ChangePoint":
        return {"change_point": [_kernel_spec(c) for c in cov.cov], "axis": int(cov.axis)}
    return name


def _kernel_from_spec(spec):
    if isinstance(spec, str):
        return getattr(_gp, spec)()
    if "sum" in spec:
        return _gp.CompositeCovariance([_kernel_from_spec(s) for s in spec["sum"]])
    return _gp.ChangePoint([_kernel_from_spec(s) for s in spec["change_point"]],
                           axis=spec["axis"])


def gp_state_of(gp) -> dict:
    """The state of a JAX ``GpRegressor`` as numpy values and names: x, y,
    y_err (diagonal error model) or y_cov, hyperpars, pad_to, kernel and
    mean. It reads attributes only and imports nothing of the JAX package."""
    sig = np.asarray(gp.sig)
    diag = bool(gp._sig_is_diag)
    return {
        "x": np.asarray(gp.x),
        "y": np.asarray(gp.y),
        "y_err": np.sqrt(np.diagonal(sig)) if diag else None,
        "y_cov": None if diag else sig,
        "hyperpars": np.asarray(gp.hyperpars, dtype=float),
        "pad_to": gp.pad_to,
        "kernel": _kernel_spec(gp.cov),
        "mean": type(gp.mean).__name__,
    }


def gp_regressor_from_state(state: dict, device="cuda", dtype=None, cholesky="auto"):
    """The port's ``GpRegressor`` with the state ``gp_state_of`` returns:
    the same data, error model, padding, kernel and mean classes and
    hyperparameters, on ``device`` (default the card)."""
    return _gp.GpRegressor(
        state["x"], state["y"], y_err=state["y_err"], y_cov=state["y_cov"],
        hyperpars=state["hyperpars"], kernel=_kernel_from_spec(state["kernel"]),
        mean=getattr(_gp, state["mean"]), pad_to=state["pad_to"],
        dtype=dtype, cholesky=cholesky, device=device,
    )


def gp_optimiser_state_of(opt) -> dict:
    """The state of a ``GpOptimiser`` of either package as numpy values and
    names: x, y, y_err, bounds, the GP's hyperparameters, kernel and mean
    specs, ``cross_val``, the acquisition's kind (and ``kappa``), the
    optimizer and the three histories. A pending deferred refit is settled
    first (reading a history does it). It reads attributes only and imports
    nothing of the JAX package."""
    histories = (np.asarray(opt.acquisition_max_history, dtype=float),
                 np.asarray(opt.convergence_metric_history, dtype=float),
                 np.asarray(opt.iteration_history, dtype=int))
    acq = opt.acquisition
    return {
        "x": np.asarray(opt.x, dtype=float),
        "y": np.asarray(opt.y, dtype=float),
        "y_err": None if opt.y_err is None else np.asarray(opt.y_err, dtype=float),
        "bounds": [(float(lo), float(hi)) for lo, hi in opt.bounds],
        "hyperpars": np.asarray(opt.gp.hyperpars, dtype=float),
        "kernel": _kernel_spec(opt.gp.cov),
        "mean": type(opt.gp.mean).__name__,
        "cross_val": bool(opt.cross_val),
        "acquisition": type(acq).__name__,
        "kappa": float(acq.kappa) if hasattr(acq, "kappa") else None,
        "optimizer": opt.optimizer,
        "acquisition_max_history": histories[0],
        "convergence_metric_history": histories[1],
        "iteration_history": histories[2],
    }


def gp_optimiser_from_state(state: dict, device="cuda", dtype=None):
    """The port's ``GpOptimiser`` with the state ``gp_optimiser_state_of``
    returns, on ``device`` (default the card): the same data, bounds,
    kernel, mean, acquisition and optimizer, the GP at the given
    hyperparameters (no refit) and the histories as they were."""
    kind = getattr(_gp, state["acquisition"])
    acq = kind(state["kappa"]) if state["kappa"] is not None else kind()
    opt = _gp.GpOptimiser(
        state["x"], state["y"], bounds=state["bounds"], y_err=state["y_err"],
        hyperpars=state["hyperpars"], kernel=_kernel_from_spec(state["kernel"]),
        mean=getattr(_gp, state["mean"]), cross_val=state["cross_val"], acquisition=acq,
        optimizer=state["optimizer"], dtype=dtype, device=device,
    )
    opt._acq_max_history = [float(v) for v in state["acquisition_max_history"]]
    opt._conv_metric_history = [float(v) for v in state["convergence_metric_history"]]
    opt._iter_history = [int(v) for v in state["iteration_history"]]
    return opt


def _block_kernel_spec(bk):
    """A JAX ``BlockKernel`` as the kernel spec of ``_kernel_spec``:
    ``"SquaredExponential"``, ``"RationalQuadratic"``, or a ``{"sum": ...}``
    of one of them and ``"WhiteNoise"`` in the composite's order."""
    base = getattr(bk, "base", None)
    if base is None:
        return bk.name
    parts = [base.name, "WhiteNoise"]
    return {"sum": parts if bk.base_first else parts[::-1]}


def large_scale_state_of(gp) -> dict:
    """The state of a solved JAX ``LargeScaleGP`` of any tier as numpy
    values and names: the unpadded x, y and y_err, hyperpars, the kernel
    spec, ``solver``, ``preconditioner``, the working ``dtype``,
    ``mean_value``, ``block_size``, ``preconditioner_rank``, ``cg_tol``,
    ``cg_maxiter``, ``store_entries``, the solved ``alpha64`` (``alpha`` in
    float64 where the instance has no ``alpha64``) and the preconditioner
    factor ``U`` (None without one). It reads attributes only and imports
    nothing of the JAX package."""
    n = gp.n_points
    pc = getattr(gp, "_precond64", None) or getattr(gp, "_precond", None)
    U = None if pc is None else np.array(pc[0], dtype=np.float64)
    return {
        "x": np.asarray(gp._x_host, dtype=np.float64)[:n],
        "y": np.asarray(gp._y_host, dtype=np.float64)[:n],
        "y_err": np.sqrt(np.asarray(gp._sig_host, dtype=np.float64)[:n]),
        "hyperpars": np.asarray(gp.hyperpars, dtype=np.float64),
        "kernel": _block_kernel_spec(gp._bk),
        "solver": gp.solver,
        "preconditioner": gp.preconditioner,
        "dtype": str(gp._x.dtype).rsplit(".", 1)[-1],
        "mean_value": float(gp.mean_value),
        "block_size": int(gp.block_size),
        "preconditioner_rank": 0 if U is None else U.shape[1],
        "cg_tol": float(gp._cg_tol),
        "cg_maxiter": int(gp._cg_maxiter),
        "store_entries": gp.store_entries,
        "alpha64": np.array(getattr(gp, "alpha64", gp.alpha), dtype=np.float64),
        "U": U,
    }


def large_scale_gp_from_state(state: dict, device="cuda"):
    """The port's ``LargeScaleGP`` with the state ``large_scale_state_of``
    returns, on ``device`` (default the card): the same data, padding,
    kernel, tier, hyperparameters and settings, with the solved ``alpha64``
    and the factor ``U`` taken as they are, so nothing is solved again.
    States written before the kernel, solver, preconditioner and dtype were
    carried are read as the df64 tier's squared exponential."""
    return _gp.LargeScaleGP._from_solved(
        state["x"], state["y"], state["y_err"], state["hyperpars"], state["alpha64"], state["U"],
        kernel=_kernel_from_spec(state.get("kernel", "SquaredExponential")),
        solver=state.get("solver", "df64"), preconditioner=state.get("preconditioner", "pivchol"),
        dtype=state.get("dtype"), mean_value=state["mean_value"],
        block_size=state["block_size"], cg_tol=state["cg_tol"], cg_maxiter=state["cg_maxiter"],
        store_entries=state["store_entries"], device=device,
    )


def large_inverter_state_of(inv, cg_tol=1e-6, cg_maxiter=1000) -> dict:
    """The state of a solved JAX ``LargeScaleGpLinearInverter`` as numpy
    values and names: y, y_err, the unpadded model matrix and positions,
    hyperpars, the kernel spec, ``prior_mean``, ``block_size``, ``solver``,
    ``store_entries``, the working ``dtype``, ``cg_tol``, ``cg_maxiter`` and
    the data-space solution ``z64`` (``z`` in float64 where the instance has
    no ``z64``). The JAX instance records ``cg_tol`` and ``cg_maxiter`` only
    in its df64 tier; for the others pass the values it was built with (the
    defaults are the constructor's). It reads attributes only and imports
    nothing of the JAX package."""
    n = inv.n_parameters
    return {
        "y": np.asarray(inv._y_host, dtype=np.float64),
        "y_err": np.sqrt(np.asarray(inv._sig_host, dtype=np.float64)),
        "model_matrix": np.array(inv._A, dtype=np.float64)[:, :n],
        "positions": np.array(getattr(inv, "_x_pad_host", inv._x), dtype=np.float64)[:n],
        "hyperpars": np.asarray(inv.hyperpars, dtype=np.float64),
        "kernel": _block_kernel_spec(inv._bk),
        "prior_mean": float(inv.prior_mean),
        "block_size": int(inv.block_size),
        "solver": inv.solver,
        "store_entries": inv.store_entries,
        "dtype": str(inv._x.dtype).rsplit(".", 1)[-1],
        "cg_tol": float(getattr(inv, "_cg_tol", cg_tol)),
        "cg_maxiter": int(getattr(inv, "_cg_maxiter", cg_maxiter)),
        "z64": np.array(getattr(inv, "z64", inv.z), dtype=np.float64),
    }


def large_inverter_from_state(state: dict, device="cuda"):
    """The port's ``LargeScaleGpLinearInverter`` with the state
    ``large_inverter_state_of`` returns, on ``device`` (default the card),
    with the solution ``z64`` taken as it is, so nothing is solved again."""
    return _gp.LargeScaleGpLinearInverter._from_solved(
        state["y"], state["y_err"], state["model_matrix"], state["positions"],
        state["hyperpars"], state["z64"], kernel=_kernel_from_spec(state["kernel"]),
        prior_mean=state["prior_mean"], block_size=state["block_size"], cg_tol=state["cg_tol"],
        cg_maxiter=state["cg_maxiter"], solver=state["solver"],
        store_entries=state["store_entries"], dtype=state["dtype"], device=device,
    )
