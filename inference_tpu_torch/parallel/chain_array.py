"""Batched arrays of independent chains.

Port of ``inference_tpu.parallel.chain_array`` for every kind ("hmc",
"nuts", "gibbs", "metropolis", "pca" and "ensemble"): one batched transition
advances every chain at once on one device, with the history kept on the
host as numpy arrays. An ensemble chain is a sub-ensemble of walkers, and its
diagnostics count every walker as a replicate chain.
With ``mesh=`` the chains are split over the cells of a mesh's
``axis_name`` axis (``parallel.mesh``): a process holds the chains of its
cells and advances them as one batch on its device, and the history,
positions and checkpoints are gathered from every process
(``_collectives.Layout``).
With ``fused=True`` the hmc advance runs through kernel B1
(``ops.hmc_fused``; for a posterior of the models over a
``LinearForwardModel``, its model route ``ops.hmc_model``), which keeps
every chain's state on the chip through whole chunks of transitions. A posterior written with numpy runs on the
host, one call per chain, with the chains' state on their device
(``utils.wrap``); the hmc and nuts kinds refuse it, as the JAX package's
kinds do.
"""

import copy

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..convert import (
    N_ENSEMBLE_LEAVES,
    N_HMC_LEAVES,
    N_METROPOLIS_LEAVES,
    N_NUTS_LEAVES,
    ensemble_state_from_jax,
    ensemble_state_to_jax_leaves,
    hmc_state_from_jax,
    hmc_state_to_jax_leaves,
    metropolis_state_from_jax,
    metropolis_state_to_jax_leaves,
    nuts_state_from_jax,
    nuts_state_to_jax_leaves,
)
from ..mcmc._kernels import ensemble as ens_kernel
from ..mcmc._kernels import hmc as hmc_kernel
from ..mcmc._kernels import metropolis as met_kernel
from ..mcmc._kernels import nuts as nuts_kernel
from ..utils import as_device_logp, default_float, make_generator, resolve_device
from ._collectives import Layout
from ._kinds import build_kind, check_kind, positions_of
from .mesh import Mesh, cell_grid
from .tempering import stream_seeds

METROPOLIS_KINDS = ("gibbs", "metropolis", "pca")


def _chain_layout(mesh, axis_name, n_chains):
    """The ``Layout`` of ``n_chains`` chains split over the cells of the
    mesh's ``axis_name`` axis (the cells at index 0 of any other axis)."""
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"[ ChainArray error ] the mesh has no axis {axis_name!r} (axes "
            f"{mesh.axis_names})."
        )
    axis = mesh.axis_names.index(axis_name)
    cells = np.moveaxis(mesh.devices, axis, 0).reshape(mesh.shape[axis_name], -1)[:, 0]
    if n_chains % len(cells) != 0:
        raise ValueError(
            f"[ ChainArray error ] n_chains ({n_chains}) must be a multiple of the mesh "
            f"{axis_name!r} axis size ({len(cells)})."
        )
    line = Mesh(cell_grid(list(cells), (len(cells),)), (axis_name,))
    return Layout(line, n_chains // len(cells), "ChainArray")


def _warmup_window_sizes(n_steps: int, n_windows: int) -> np.ndarray:
    """Expanding warmup windows (1x, 1x, 2x, 4x, ... of the base) summing to
    exactly ``n_steps`` with every window >= 2 (``warmup`` validates
    ``n_steps >= 2 * n_windows``): a rounding deficit goes to the final
    window, a clamping excess is taken from the latest windows that can
    still afford it."""
    weights = np.array(
        [1.0] + [float(1 << max(0, w - 1)) for w in range(1, n_windows)]
    )
    sizes = np.maximum((n_steps * weights / weights.sum()).astype(int), 2)
    excess = int(sizes.sum()) - n_steps
    i = len(sizes) - 1
    while excess > 0:
        take = min(excess, int(sizes[i]) - 2)
        sizes[i] -= take
        excess -= take
        i -= 1
    if excess < 0:
        sizes[-1] -= excess
    return sizes


class ChainArray:
    """
    A batch of ``n_chains`` independent chains advanced together on one
    device.

    :param kind: sampler family: "hmc", "nuts" (No-U-Turn trajectories,
        no ``steps`` to tune), "gibbs", "metropolis", "pca" (PCA-directed
        Gibbs sweeps; call ``update_directions()`` between advances to
        re-estimate each chain's principal directions from its own history)
        or "ensemble" (each chain is an independent stretch-move ensemble).
    :param posterior: log-probability callable over ``(P,)`` tensors, written
        with torch operations (an ``nn.Module`` is copied onto ``device``),
        or a numpy posterior, evaluated on the host (not for "hmc" or
        "nuts").
    :param starts: starting positions, shape (n_chains, n_parameters), or
        (n_chains, n_walkers, n_parameters) for the ensemble kind.
    :param widths: initial proposal widths (gibbs/metropolis/pca): a scalar,
        (P,) or (n_chains, P); by default 5% of each chain's own start, or 1
        where it is 0.
    :param epsilon: initial leapfrog step size (hmc, nuts).
    :param steps: nominal leapfrog steps per proposal (hmc).
    :param max_depth: maximum trajectory doublings per transition (nuts).
    :param inverse_mass: scalar, (P,) diagonal, or full (P, P) matrix
        inverse mass (hmc, nuts).
    :param non_negative: bool or (P,) bools: parameters whose proposals
        are folded non-negative (gibbs/metropolis).
    :param boundaries: optional (lower, upper) reflecting proposal
        boundaries (gibbs/metropolis).
    :param bounds: optional ``utils.Bounds`` for the bounded leapfrog (hmc)
        or the reflected proposals (pca, ensemble).
    :param alpha: stretch-move scale parameter (ensemble).
    :param retry: repeat-until-accept proposals (the reference semantics)
        when True; textbook duplicate-on-reject MH when False.
    :param fused: "auto" (default) / True / False. True runs the advance
        through the fused whole-trajectory kernel B1 (``ops.hmc_fused``;
        its plain version on the CPU); it requires ``retry=False``, no
        bounds and unit/scalar/diagonal inverse mass, as the JAX package's
        kernel does, and a posterior the kernel reads: a ``GaussianForm``,
        or a ``Posterior`` (or bare likelihood) of ``models`` over a
        ``LinearForwardModel`` (the model route, ``ops.hmc_model``).
        "auto" and False run the batched transition of
        ``mcmc/_kernels/hmc.py``, as the JAX package does.
    :param mesh: optional ``parallel.mesh.Mesh`` whose ``axis_name`` axis
        the chains are split over (``n_chains`` a multiple of its size); the
        chains then live on the cells' devices and ``device`` is not read.
    :param axis_name: mesh axis to split over (default "chains").
    :param seed: optional integer seed of the chains' ``torch.Generator``
        (another process of a mesh derives its own from it).
    :param device: the device every chain lives on (default the card;
        raises when there is none, pass ``"cpu"`` for the CPU).
    """

    def __init__(
        self,
        kind: str,
        posterior,
        starts,
        *,
        widths=None,
        epsilon: float = 0.1,
        steps: int = 50,
        max_depth: int = 10,
        inverse_mass=None,
        non_negative=None,
        boundaries=None,
        bounds=None,
        alpha: float = 2.0,
        retry: bool = True,
        fused="auto",
        mesh=None,
        axis_name: str = "chains",
        seed=None,
        device="cuda",
    ):
        check_kind(kind)
        starts = np.asarray(starts, dtype=float)
        if kind == "ensemble":
            if starts.ndim != 3:
                raise ValueError(
                    "the ensemble kind requires starts of shape "
                    "(n_chains, n_walkers, n_parameters)"
                )
            self.n_chains, self.n_walkers, self.n_parameters = starts.shape
        else:
            starts = np.atleast_2d(starts)
            self.n_chains, self.n_parameters = starts.shape
            self.n_walkers = None
        self.kind = kind
        self.mesh = mesh
        self.axis_name = axis_name
        self._layout = None
        if mesh is not None:
            self._layout = _chain_layout(mesh, axis_name, self.n_chains)
            self.device = self._layout.device
            starts = starts[self._layout.rows]
            if seed is not None and self._layout.rank > 0:
                seed = stream_seeds(int(seed) % 2**32, self._layout.rank)[1]
        else:
            self.device = resolve_device(device, "ChainArray")

        dtype = default_float()
        if isinstance(posterior, nn.Module):
            posterior = copy.deepcopy(posterior).to(device=self.device, dtype=dtype)
        self._posterior = posterior
        starts_dev = torch.as_tensor(starts, dtype=dtype, device=self.device)
        self._logp = as_device_logp(posterior, starts_dev.reshape(-1, self.n_parameters)[0],
                                    "ChainArray")
        self._generator = make_generator(seed, self.device)

        # kept so warmup()/set_inverse_mass() can rebuild the step with a
        # re-estimated mass while preserving the live state
        self._build_kwargs = dict(
            epsilon=epsilon,
            steps=steps,
            inverse_mass=inverse_mass,
            non_negative=non_negative,
            boundaries=boundaries,
            bounds=bounds,
            alpha=alpha,
            n_walkers=self.n_walkers,
            retry=retry,
            max_depth=max_depth,
        )
        init, self._step = build_kind(
            kind, self._logp, self.n_parameters, dtype, self.device,
            **self._build_kwargs,
        )
        with torch.no_grad():
            logp0 = self._logp.batched(starts_dev.reshape(-1, self.n_parameters))
        logp0 = logp0.reshape(starts_dev.shape[:-1])
        self._state = init(starts_dev, logp0, 1.0)
        if kind in METROPOLIS_KINDS:
            # per-chain initial widths: 5% of each chain's own start point
            # when unspecified (reference: gibbs.py:258-259)
            if widths is None:
                per_chain = np.where(starts != 0, np.abs(starts) * 0.05, 1.0)
            else:
                per_chain = np.asarray(widths, dtype=float)
                if self._layout is not None and per_chain.shape[:1] == (self.n_chains,) \
                        and per_chain.ndim == 2:
                    per_chain = self._layout.local_rows(per_chain)
                per_chain = np.broadcast_to(per_chain, starts.shape)
            value = torch.as_tensor(np.ascontiguousarray(per_chain), dtype=dtype,
                                    device=self.device)
            self._state = self._state._replace(
                widths=self._state.widths._replace(value=value)
            )
        self._run_steps = {"hmc": hmc_kernel.run_steps, "nuts": nuts_kernel.run_steps,
                           "ensemble": ens_kernel.run_steps}.get(kind, met_kernel.run_steps)

        self._history = []
        self._prob_history = []

        self._fused_plan = None
        self._fused_mode = fused
        self._rebuild_fused_plan(fused)

    def _rebuild_fused_plan(self, fused):
        """(Re)build the fused-advance plan. ``fused=True`` raises on a
        configuration the kernel does not take; "auto" and False keep the
        batched transition."""
        self._fused_plan = None
        if fused is not True:
            return
        if self.kind != "hmc":
            raise ValueError(
                "[ ChainArray error ] fused=True is only available "
                "for the 'hmc' kind."
            )
        from ..ops.hmc_fused import plan_fused_hmc

        kw = self._build_kwargs
        problems = []
        if kw["retry"]:
            problems.append("retry=True (repeat-until-accept)")
        if kw["bounds"] is not None:
            problems.append("reflecting bounds")
        if self.mesh is not None:
            problems.append("a device mesh")
        im = kw["inverse_mass"]
        if im is not None and np.asarray(im).ndim > 1:
            problems.append("a full-matrix inverse mass")
        if problems:
            raise ValueError(
                "[ ChainArray error ] the fused hmc kernel does not "
                "support: " + ", ".join(problems) + "."
            )
        self._fused_plan = plan_fused_hmc(
            self._posterior,
            self.n_parameters,
            steps=kw["steps"],
            inverse_mass=im,
        )

    @torch.no_grad()
    def advance(self, n: int, store: bool = True, thin: int = 1):
        """
        Advance every chain ``n`` steps. With ``store=False`` only the final
        state is kept (maximum throughput); otherwise every ``thin``-th
        step's positions are appended to the host history. Returns once the
        device has finished.
        """
        if self._fused_plan is not None:
            from ..ops.hmc_fused import fused_hmc_advance

            state, hist = fused_hmc_advance(
                self._fused_plan, self._state, n, store, self._generator
            )
            pos, logp = (hist[0], hist[1]) if store else (None, None)
        else:
            state, outs = self._run_steps(
                self._step, self._state, n, store, self._generator
            )
            pos, logp = (None, None)
            if store:
                pos, logp = (outs.walkers, outs.logps) if self.kind == "ensemble" else (
                    outs.theta, outs.logp)
        self._state = state
        if store:
            pos, logp = self._host([pos[::thin], logp[::thin]], axis=1)
            self._history.append(pos)  # (n/thin, K[, W], P)
            self._prob_history.append(logp)
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def set_inverse_mass(self, inverse_mass):
        """
        Rebuild the transition with a new inverse mass (scalar, (P,)
        diagonal, or (P, P) matrix), preserving the live chain state.
        """
        self._require_hmc("set_inverse_mass")
        self._build_kwargs["inverse_mass"] = inverse_mass
        _, self._step = build_kind(
            self.kind, self._logp, self.n_parameters,
            self._state.theta.dtype, self.device, **self._build_kwargs,
        )
        self._rebuild_fused_plan(self._fused_mode)
        return self

    def warmup(self, n_steps: int = 500, n_windows: int = 4, store: bool = False):
        """
        Windowed diagonal mass adaptation: advance in ``n_windows``
        expanding windows; after each, set the inverse mass to the
        per-parameter variance pooled over all chains and the window's
        steps. Step-size adaptation keeps running throughout. Warmup
        samples are discarded (``store=False``) by default.
        """
        self._require_hmc("warmup")
        if n_windows < 1 or n_steps < 2 * n_windows:
            raise ValueError(
                "[ ChainArray error ] warmup needs n_windows >= 1 and "
                "n_steps >= 2 * n_windows."
            )
        sizes = _warmup_window_sizes(n_steps, n_windows)
        mark = len(self._history)
        for size in sizes:
            self.advance(int(size), store=True)
            h = np.concatenate(self._history[mark:], axis=0)
            var = h.reshape(-1, self.n_parameters).var(axis=0)
            floor = 1e-12 * max(float(var.max()), 1e-30)
            self.set_inverse_mass(np.maximum(var, floor))
        if not store:
            del self._history[mark:]
            del self._prob_history[mark:]
        return self

    def _require_hmc(self, what):
        if self.kind not in ("hmc", "nuts"):
            raise ValueError(
                f"[ ChainArray error ] {what} applies to the 'hmc' and "
                "'nuts' kinds only."
            )

    def update_directions(self, last: int = None):
        """
        Re-estimate each chain's PCA sweep directions from its own stored
        history (optionally only the ``last`` steps): one batched
        ``torch.linalg.eigh`` over the per-chain sample covariances on the
        chains' device (reference: pca.py:96-134 does this per chain on the
        host). Below max(2 P, 3) stored steps the directions are left as
        they are.
        """
        if self.kind != "pca":
            raise ValueError(
                "[ ChainArray error ] update_directions is only available "
                "for kind='pca'."
            )
        if not self._history:
            return self
        h = np.concatenate(self._history, axis=0)  # (steps, K, P)
        if last is not None:
            h = h[-last:]
        if h.shape[0] < max(2 * self.n_parameters, 3):
            return self  # not enough samples for a stable covariance
        if self._layout is not None:
            h = self._layout.local_rows(h, axis=1)  # this process's chains
        h = torch.as_tensor(h, dtype=self._state.theta.dtype, device=self.device)
        centred = h - h.mean(dim=0, keepdim=True)
        covs = torch.einsum("skp,skq->kpq", centred, centred) / (h.shape[0] - 1)
        _, vecs = torch.linalg.eigh(covs)  # batched; columns are directions
        self._state = self._state._replace(directions=vecs)
        return self

    def _stored(self, burn: int, what: str) -> np.ndarray:
        if not self._history:
            raise ValueError(
                "[ ChainArray error ] no stored history - advance with "
                f"store=True before requesting {what}."
            )
        return np.concatenate(self._history, axis=0)[burn:]  # (steps, K, P)

    def effective_sample_size(self, burn: int = 0) -> np.ndarray:
        """Per-chain, per-parameter effective sample sizes, shape
        (n_chains, n_parameters), with a walker axis inserted for the
        ensemble kind: (n_chains, n_walkers, n_parameters); from one batched
        FFT autocorrelation."""
        from ..utils.ess import effective_sample_size_batched

        h = self._stored(burn, "effective sample sizes")
        series = torch.as_tensor(np.moveaxis(h, 0, -1))  # (K[, W], P, steps)
        return effective_sample_size_batched(series).numpy()

    def rhat(self, burn: int = 0, rank_normalized: bool = True) -> np.ndarray:
        """Per-parameter split-R-hat across the chain batch, shape
        (n_parameters,): the rank-normalized, folded variant of Vehtari et
        al. (2021) by default, the classic split statistic with
        ``rank_normalized=False``. For the ensemble kind every walker is a
        replicate chain. One batched program on the chains' device, as in
        the JAX package: the rank normalization sorts every parameter's
        pooled draws, which on the host takes seconds at 1e7 draws."""
        from ..utils.diagnostics import rank_normalized_rhat, split_rhat

        h = self._stored(burn, "rhat")
        if h.ndim == 4:  # ensemble kind: (steps, K, W, P) -> (steps, K * W, P)
            h = h.reshape(h.shape[0], -1, h.shape[-1])
        series = torch.as_tensor(h, device=self.device).permute(2, 1, 0)  # (P, K, steps)
        estimator = rank_normalized_rhat if rank_normalized else split_rhat
        return estimator(series).cpu().numpy()

    def _host(self, tensors, axis=0):
        """Host copies of tensors whose ``axis`` holds this process's chains,
        with every chain of a mesh gathered (one host read)."""
        if self._layout is None:
            return [t.cpu().numpy() for t in tensors]
        return self._layout.gather(tensors, axis)

    @property
    def theta(self) -> np.ndarray:
        """Current positions, shape (n_chains[, n_walkers], n_parameters)."""
        return self._host([positions_of(self._state)[0]])[0]

    @property
    def logp(self) -> np.ndarray:
        """Current log-probabilities, shape (n_chains[, n_walkers])."""
        return self._host([positions_of(self._state)[1]])[0]

    def get_sample(self, burn: int = 0, thin: int = 1) -> np.ndarray:
        """Pooled samples from all chains, shape (n_kept * K, P). ``burn``
        and ``thin`` apply to the step axis."""
        if not self._history:
            return np.empty([0, self.n_parameters])
        h = np.concatenate(self._history, axis=0)[burn::thin]
        return h.reshape(-1, self.n_parameters)

    def get_probabilities(self, burn: int = 0, thin: int = 1) -> np.ndarray:
        if not self._prob_history:
            return np.empty([0])
        h = np.concatenate(self._prob_history, axis=0)[burn::thin]
        return h.reshape(-1)

    # ------------------------------------------------------------------ #
    # checkpoint / resume in the JAX package's .npz layout
    # ------------------------------------------------------------------ #
    def _n_leaves(self):
        if self.kind == "hmc":
            return N_HMC_LEAVES
        if self.kind == "nuts":
            return N_NUTS_LEAVES
        if self.kind == "ensemble":
            return N_ENSEMBLE_LEAVES
        return N_METROPOLIS_LEAVES + (self.kind == "pca")

    def _leaf_codec(self):
        """(to leaves, from leaves) of this kind's state."""
        if self.kind == "hmc":
            return hmc_state_to_jax_leaves, hmc_state_from_jax
        if self.kind == "nuts":
            return nuts_state_to_jax_leaves, nuts_state_from_jax
        if self.kind == "ensemble":
            return ensemble_state_to_jax_leaves, ensemble_state_from_jax
        return metropolis_state_to_jax_leaves, metropolis_state_from_jax

    def save(self, filename: str):
        """Checkpoint the chain state in the JAX ``ChainArray`` layout
        (``leaf_0`` ... ``leaf_<n>``, kind, n_chains, n_parameters), so
        either package can restore it. The key leaf is drawn from this
        array's generator."""
        state = self._state
        if self._layout is not None:
            leaves, spec = tree_flatten(state)
            state = tree_unflatten([torch.as_tensor(h) for h in self._host(leaves)], spec)
        key = torch.randint(
            0, 2**32, (self.n_chains, 2), dtype=torch.int64,
            generator=self._generator, device=self.device,
        ).cpu().numpy().astype(np.uint32)
        leaves = self._leaf_codec()[0](state, key)
        items = {f"leaf_{i}": v for i, v in enumerate(leaves)}
        items["kind"] = self.kind
        items["n_chains"] = self.n_chains
        items["n_parameters"] = self.n_parameters
        np.savez(filename, **items)

    def restore(self, filename: str):
        """Restore a state saved by either package's ``ChainArray.save``
        into this ChainArray (constructed with the same configuration)."""
        D = np.load(filename)
        if str(D["kind"]) != self.kind or int(D["n_chains"]) != self.n_chains:
            raise ValueError(
                "[ ChainArray error ] checkpoint configuration does not match "
                "this ChainArray (kind / n_chains differ)."
            )
        n_saved = sum(1 for k in D.files if k.startswith("leaf_"))
        if n_saved != self._n_leaves():
            raise ValueError(
                f"[ ChainArray error ] checkpoint stores {n_saved} state "
                f"leaves but an '{self.kind}' state has {self._n_leaves()}."
            )
        leaves = [D[f"leaf_{i}"] for i in range(n_saved)]
        if self._layout is not None:  # this process's chains, back on its cells
            leaves = [self._layout.local_rows(x) for x in leaves]
        self._state = self._leaf_codec()[1](
            leaves,
            device=self.device,
            dtype=positions_of(self._state)[0].dtype,
        )
        return self
