"""Sharded parallel tempering: replica exchange over a mesh of cells.

Port of ``inference_tpu.parallel.tempering``. Temperature rungs lie along
the 'rungs' axis of a ('rungs', 'chains') mesh (``tempering_mesh``) and
each (rung, lane) pair holds an independent chain (for "ensemble", an
independent sub-ensemble of walkers); chain lanes are split over the
'chains' axis. Every sampler family of ``parallel._kinds`` runs on the
rungs ("hmc", "nuts", "gibbs", "metropolis", "pca", "ensemble"; one kind
for all rungs), with each row's inverse temperature in its state.

The cells a process holds advance as one batched step on its device: the
rows are its cells' lanes, in grid order (``_collectives.Layout``), so a
mesh of 16 cells on one card costs the launches of one ladder. Swaps use
the even-odd pairing of the JAX class: in phase 0 rungs (0, 1), (2, 3),
...; in phase 1 (1, 2), (3, 4), .... Partner rows come from
``_collectives.Exchange`` (an index within a process, one message each way
between processes, as ``lax.ppermute`` moves them), and both partners
reach the same Metropolis decision ``U <= exp(-d(beta) d(logP))`` from the
same uniform, so the accept bit needs no message. A cached tempered
gradient (the nuts kind) travels and re-tempers with its position.

The uniforms: a ``torch.Generator`` on the cells' device, seeded alike on
every process, draws one table a chunk of cycles over the global (rung,
lane) grid; a pair of rungs reads the row of its lower rung, so partners
read the same uniform with no message and distinct chain shards read
independent ones. One draw a chunk keeps the launches independent of the
number of cells. ``_swap`` also takes the uniforms as an operand, so it can
be held to the JAX class's element by element.

``advance`` chunks the cycles as the JAX class's compiled programs do:
supercycles of two swap phases (up to 256 a chunk), a one-cycle tail and a
swap-free remainder; the host reads the accepted flags and the chunk's
history once a chunk. The transitions draw from one generator per process.
"""

import copy
import os
import sys
from time import time

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..mcmc._kernels import ensemble as ens_kernel
from ..mcmc._kernels import hmc as hmc_kernel
from ..mcmc._kernels import metropolis as met_kernel
from ..mcmc._kernels import nuts as nuts_kernel
from ..utils import as_device_logp, default_float, make_generator
from ._collectives import Exchange, Layout
from ._kinds import build_kind, check_kind, positions_of, with_positions
from .mesh import process_info


def _even_odd_perm(n_rungs: int, phase: int):
    """Partner permutation for even-odd replica-exchange pairing."""
    perm = []
    partner = {}
    for i in range(n_rungs):
        j = i + 1 - 2 * (i % 2) if phase == 0 else i - 1 + 2 * (i % 2)
        if 0 <= j < n_rungs:
            partner[i] = j
        else:
            partner[i] = i
        perm.append((i, partner[i]))
    return perm, partner


def agreed_seed(seed) -> int:
    """``seed`` folded to 32 bits; without one, OS entropy, rank 0's in a
    process group so that every process starts from the same seed."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
        _, world = process_info()
        if world > 1:
            box = [seed]
            torch.distributed.broadcast_object_list(box, src=0)
            seed = box[0]
    return int(seed) % 2**32


def stream_seeds(seed, rank: int):
    """(shared, per-process) seeds derived from one agreed seed: the first
    equal on every process, the second distinct per rank."""
    shared = int(np.random.SeedSequence([seed, 0]).generate_state(1)[0])
    own = int(np.random.SeedSequence([seed, 1, rank]).generate_state(1)[0])
    return shared, own


class ShardedTempering:
    """
    Replica-exchange sampling over a ('rungs', 'chains') mesh of cells.

    :param posterior: log-probability callable over ``(P,)`` tensors written
        with torch operations (an ``nn.Module`` is copied onto the cells'
        device), or a numpy posterior evaluated on the host (not for "hmc"
        or "nuts").
    :param start: starting position, shape (n_parameters,).
    :param temperatures: increasing temperature ladder, one per rung; the
        number of rungs must match the mesh's 'rungs' axis.
    :param n_chains: independent chain lanes per rung, split over the
        mesh's 'chains' axis. For ``kind="ensemble"`` each lane is an
        independent sub-ensemble of ``n_walkers`` walkers.
    :param mesh: a ('rungs', 'chains') mesh (``parallel.tempering_mesh``).
    :param kind: sampler family per rung: "hmc" (default), "nuts", "gibbs",
        "metropolis", "pca" or "ensemble".
    :param widths: initial proposal widths (Metropolis family), or the
        walker-spread scale around ``start`` (ensemble).
    :param epsilon: initial leapfrog step size (hmc, nuts).
    :param steps: leapfrog steps per proposal (hmc).
    :param max_depth: maximum trajectory doublings per transition (nuts).
    :param inverse_mass: scalar, (P,) diagonal or (P, P) inverse mass.
    :param non_negative: per-parameter non-negative proposal folding
        (gibbs/metropolis).
    :param boundaries: (lower, upper) reflecting proposal boundaries
        (gibbs/metropolis).
    :param bounds: optional ``utils.Bounds``: bounded leapfrog (hmc) or
        reflected proposals (pca, ensemble).
    :param n_walkers: walkers per sub-ensemble (ensemble).
    :param alpha: stretch-move scale parameter (ensemble).
    :param retry: repeat-until-accept proposals when True; textbook
        duplicate-on-reject when False (default).
    :param seed: optional integer seed, equal on every process.
    :param display_progress: print progress lines in ``run_for``.
    """

    def __init__(
        self,
        posterior,
        start,
        temperatures,
        n_chains: int,
        mesh,
        kind: str = "hmc",
        *,
        widths=None,
        epsilon: float = 0.1,
        steps: int = 50,
        inverse_mass=None,
        non_negative=None,
        boundaries=None,
        bounds=None,
        n_walkers: int = None,
        alpha: float = 2.0,
        max_depth: int = 10,
        retry: bool = False,
        seed=None,
        display_progress: bool = True,
    ):
        start = np.asarray(start, dtype=float)
        self.n_parameters = start.size
        self.temperatures = np.asarray(temperatures, dtype=float)
        self.n_rungs = self.temperatures.size
        self.n_chains = n_chains
        self.mesh = mesh
        self.kind = kind
        self.display_progress = display_progress
        check_kind(kind)

        if mesh.shape["rungs"] != self.n_rungs:
            raise ValueError(
                f"the mesh 'rungs' axis ({mesh.shape['rungs']}) must match "
                f"the number of temperature rungs ({self.n_rungs})"
            )
        if n_chains % mesh.shape["chains"] != 0:
            raise ValueError(
                "n_chains must be divisible by the mesh 'chains' axis size"
            )
        self._layout = Layout(mesh, n_chains // mesh.shape["chains"], "ShardedTempering")
        self.device = device = self._layout.device

        dtype = default_float()
        if isinstance(posterior, nn.Module):
            posterior = copy.deepcopy(posterior).to(device=device, dtype=dtype)
        start_dev = torch.as_tensor(start, dtype=dtype, device=device)
        self._logp = as_device_logp(posterior, start_dev, "ShardedTempering")

        if kind in ("gibbs", "metropolis", "pca") and widths is None:
            # the reference's default: 5% of the start point per parameter
            # (reference: gibbs.py:258-259)
            widths = np.where(start != 0, np.abs(start) * 0.05, 1.0)

        seed = agreed_seed(seed)
        shared, own = stream_seeds(seed, self._layout.rank)
        self._swap_generator = make_generator(shared, device)
        self._generator = make_generator(own, device)

        init, self._step = build_kind(
            kind, self._logp, self.n_parameters, dtype, device, widths=widths,
            epsilon=epsilon, steps=steps, inverse_mass=inverse_mass,
            non_negative=non_negative, boundaries=boundaries, bounds=bounds,
            alpha=alpha, n_walkers=n_walkers, retry=retry, max_depth=max_depth,
        )
        self._run_steps = {"hmc": hmc_kernel.run_steps, "nuts": nuts_kernel.run_steps,
                           "ensemble": ens_kernel.run_steps}.get(kind, met_kernel.run_steps)

        # each local row's rung, and its inverse temperature
        rows = self._layout.rows
        self._row_rung = rows // n_chains
        inv_temps = torch.as_tensor(1.0 / self.temperatures, dtype=dtype, device=device)
        it = inv_temps[torch.as_tensor(self._row_rung, device=device)]
        K = self._layout.n_rows
        with torch.no_grad():
            if kind == "ensemble":
                spread = 0.05 * np.abs(start) + 0.01 if widths is None else widths
                spread = np.broadcast_to(np.asarray(spread, float), start.shape).copy()
                # the global walkers from the shared stream, so the start does
                # not depend on how the cells are laid out
                gen = make_generator(shared ^ 0x5EED, device)
                normal = torch.randn((self.n_rungs * n_chains, n_walkers, self.n_parameters),
                                     generator=gen, dtype=dtype, device=device)
                spread_t = torch.as_tensor(spread, dtype=dtype, device=device)
                walkers0 = start_dev + spread_t * normal[torch.as_tensor(rows, device=device)]
                logp0 = self._logp.batched(walkers0.reshape(-1, self.n_parameters))
                logp0 = logp0.reshape(K, n_walkers) * it[:, None]
                state = init(walkers0, logp0, 1.0)
            else:
                pos0 = start_dev.expand(K, self.n_parameters).clone()
                p0 = self._logp(start_dev)
                state = init(pos0, p0.expand(K) * it, 1.0)
                if hasattr(state, "grad"):
                    state = state._replace(grad=state.grad * it[:, None])
        self._state = state._replace(inv_temp=it)

        self._exchanges, self._uniform_rows = {}, {}
        shards = mesh.shape["chains"]
        for phase in (0, 1):
            _, partner = _even_odd_perm(self.n_rungs, phase)
            cells = [partner[f // shards] * shards + f % shards for f in range(self._layout.n_cells)]
            self._exchanges[phase] = Exchange(self._layout, cells)
            pair = np.minimum(self._row_rung, [partner[r] for r in self._row_rung])
            self._uniform_rows[phase] = torch.as_tensor(pair * n_chains + rows % n_chains,
                                                        device=device)
        self._phase = 0
        self.attempted_swaps = np.identity(self.n_rungs)
        self.successful_swaps = np.zeros((self.n_rungs, self.n_rungs))
        self._history = []
        self._prob_history = []
        self._raw_steps = 0  # unthinned steps stored so far (the thinning offset)

    # ------------------------------------------------------------------ #
    # the swap
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _swap(self, state, phase: int, uniforms):
        """One swap phase of ``state`` (this process's rows) with
        ``uniforms`` (``(K,)``, ``(K, W)`` for the ensemble kind; a pair's
        two rows must hold the same values): partners exchange position,
        log-probability, inverse temperature and cached gradient, and both
        accept when ``u <= exp(-(b - b') (p / b - p' / b'))``. Returns the
        new state and the accepted flags, with no host read."""
        exchange = self._exchanges[phase]
        pos, logp = positions_of(state)
        it = state.inv_temp
        K = it.shape[0]
        grad = getattr(state, "grad", None)
        fields = [pos.reshape(K, -1), logp.reshape(K, -1), it[:, None]]
        if grad is not None:
            fields.append(grad)
        widths = [f.shape[1] for f in fields]
        other = torch.split(exchange(torch.cat(fields, dim=1)), widths, dim=1)
        pos_o = other[0].reshape(pos.shape)
        logp_o = other[1].reshape(logp.shape)
        it_o = other[2][:, 0]

        # broadcast inv_temp (K,) against logp (K[, W])
        def expand(a):
            return a.reshape(a.shape + (1,) * (logp.ndim - a.ndim))

        it_e, it_o_e = expand(it), expand(it_o)
        d_beta = it_e - it_o_e
        d_logp = logp / it_e - logp_o / it_o_e
        accept_prob = torch.exp(-d_beta * d_logp)
        accept = expand(exchange.has_partner) & (uniforms <= accept_prob)

        new_pos = torch.where(accept[..., None], pos_o, pos)
        new_logp = torch.where(accept, (logp_o / it_o_e) * it_e, logp)
        new_state = with_positions(state, new_pos, new_logp)
        if grad is not None:
            # cached tempered gradients ride with the positions and
            # re-temper exactly like logp (grad = inv_temp * raw grad)
            grad_o = other[3]
            new_state = new_state._replace(grad=torch.where(
                accept[..., None], (grad_o / it_o[:, None]) * it[:, None], grad))
        return new_state, accept

    def _local_uniforms(self, table, phase: int):
        """This process's rows of a global uniform table ``(R, C[, W])``,
        each row reading its pair's lower rung."""
        flat = table.reshape((self.n_rungs * self.n_chains,) + tuple(table.shape[2:]))
        return flat[self._uniform_rows[phase]]

    @staticmethod
    def _patch_last(outs, state):
        """Write post-swap positions into the cycle's final recorded sample
        (an accepted swap replaces the last sample, as in the reference)."""
        pos, logp = positions_of(state)
        if isinstance(outs, ens_kernel.EnsembleOutput):
            outs.walkers[-1], outs.logps[-1] = pos, logp
        else:
            outs.theta[-1], outs.logp[-1] = pos, logp

    # ------------------------------------------------------------------ #
    # advancement
    # ------------------------------------------------------------------ #
    def _record_swaps(self, accept: np.ndarray, phase: int):
        """Accumulate lane-wise swap statistics for one swap phase."""
        _, partner = _even_odd_perm(self.n_rungs, phase)
        lanes = accept[0].size
        for i in range(self.n_rungs):
            j = partner[i]
            if j > i:
                self.attempted_swaps[i, j] += lanes
                self.successful_swaps[i, j] += accept[i].sum()

    def _global(self, a: np.ndarray, axis: int) -> np.ndarray:
        """A gathered array's row axis split into (n_rungs, n_chains)."""
        shape = a.shape[:axis] + (self.n_rungs, self.n_chains) + a.shape[axis + 1:]
        return a.reshape(shape)

    def _thinned(self, outs, thin: int):
        """The stored positions and log-probabilities of a chunk, thinned
        against a running global step offset (chunk lengths vary, so a
        per-chunk ``[::thin]`` would stride irregularly across chunks)."""
        pos, logp = (outs.walkers, outs.logps) if isinstance(outs, ens_kernel.EnsembleOutput) \
            else (outs.theta, outs.logp)
        offset = (-self._raw_steps) % thin
        self._raw_steps += pos.shape[0]
        return pos[offset::thin], logp[offset::thin]

    def _keep(self, pos, logp):
        self._history.append(self._global(pos, 1))
        self._prob_history.append(self._global(logp, 1))

    @torch.no_grad()
    def _cycles(self, n_cycles: int, interval: int, store: bool, thin: int, uniforms=None):
        """``n_cycles`` cycles of ``interval`` steps and a swap, the phases
        alternating from ``self._phase``; the uniforms of the whole chunk in
        one draw (or ``uniforms``, ``(n_cycles, R, C[, W])``), the accepted
        flags and the history read in one host read at the end. Returns
        the global flags ``(n_cycles, R, C[, W])``."""
        pos, _ = positions_of(self._state)
        if uniforms is None:
            shape = (n_cycles, self.n_rungs, self.n_chains) + tuple(pos.shape[1:-1])
            uniforms = torch.rand(shape, generator=self._swap_generator, dtype=pos.dtype,
                                  device=self.device)
        state, chunks, flags = self._state, [], []
        for c in range(n_cycles):
            phase = self._phase ^ (c & 1)
            state, outs = self._run_steps(self._step, state, interval, store, self._generator)
            state, accept = self._swap(state, phase, self._local_uniforms(uniforms[c], phase))
            if store:
                self._patch_last(outs, state)
                chunks.append(outs)
            flags.append(accept)
        self._state = state
        reads = [torch.stack(flags)]
        if store:
            reads.extend(self._thinned(type(chunks[0])(*(torch.cat(f) for f in zip(*chunks))),
                                       thin))
        host = self._layout.gather(reads, axis=1)
        if store:
            self._keep(host[1], host[2])
        return self._global(host[0], 1)

    def advance(self, n: int, swap_interval: int = 10, store: bool = True, thin: int = 1):
        """
        Advance all rungs exactly ``n`` steps, proposing even-odd replica
        swaps every ``swap_interval`` steps (any remainder runs as a
        swap-free tail, matching ``mcmc.ParallelTempering.advance``).
        Returns the stacked per-swap accept masks, shape
        (n_swaps, n_rungs, n_chains), with a walker axis appended for the
        ensemble kind.
        """
        if n <= 0:
            raise ValueError("advance requires n > 0")
        cycles, rem = divmod(int(n), int(swap_interval))
        accepts = []

        remaining = cycles
        while remaining >= 2:
            n_super = min(1 << ((remaining // 2).bit_length() - 1), 256)
            acc = self._cycles(2 * n_super, swap_interval, store, thin)
            for s in range(n_super):
                self._record_swaps(acc[2 * s], self._phase)
                self._record_swaps(acc[2 * s + 1], 1 - self._phase)
            accepts.append(acc)
            remaining -= 2 * n_super

        if remaining == 1:
            acc = self._cycles(1, swap_interval, store, thin)
            self._record_swaps(acc[0], self._phase)
            accepts.append(acc)
            self._phase ^= 1

        if rem > 0:
            with torch.no_grad():
                self._state, outs = self._run_steps(self._step, self._state, rem, store,
                                                    self._generator)
            if store:
                self._keep(*self._layout.gather(list(self._thinned(outs, thin)), axis=1))
            elif self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        if accepts:
            return np.concatenate(accepts, axis=0)
        empty = (0, self.n_rungs, self.n_chains)
        if self.kind == "ensemble":
            empty = empty + (positions_of(self._state)[1].shape[-1],)
        return np.zeros(empty)

    def run_for(self, minutes=0, hours=0, days=0, swap_interval: int = 10,
                store: bool = True, thin: int = 1):
        """
        Advance all rungs for a chosen amount of wall-clock time
        (reference: parallel.py:283-326): two timed cycles size a chunk of
        cycles for a status line about every 2 seconds. Long drives should
        pass ``thin`` (or ``store=False``): every stored step is steps x
        rungs x lanes of host memory.
        """
        run_time = ((days * 24.0 + hours) * 60.0 + minutes) * 60.0
        end_time = time() + run_time

        self.advance(swap_interval, swap_interval, store=store, thin=thin)
        t1 = time()
        self.advance(swap_interval, swap_interval, store=store, thin=thin)
        t2 = time()

        # cycles per chunk for a status line roughly every 2 seconds,
        # a power of two
        n = max(1, int(2.0 / max(t2 - t1, 1e-9)))
        n = 1 << (n.bit_length() - 1)

        while time() < end_time:
            chunk = min(n, 512)
            self.advance(chunk * swap_interval, swap_interval, store=store, thin=thin)
            if self.display_progress:
                seconds_remaining = max(end_time - time(), 0)
                m, s = divmod(seconds_remaining, 60)
                h, m = divmod(m, 60)
                sys.stdout.write(
                    f"\r  [ ShardedTempering - time remaining: "
                    f"{int(h)}:{int(m):02d}:{int(s):02d} ]    "
                )
                sys.stdout.flush()
        if self.display_progress:
            sys.stdout.write(
                "\r  [ ShardedTempering - run complete ]                  \n"
            )
            sys.stdout.flush()

    # ------------------------------------------------------------------ #
    # results & diagnostics
    # ------------------------------------------------------------------ #
    @property
    def theta(self) -> np.ndarray:
        """Positions: (n_rungs, n_chains, P), with a walker axis inserted
        before P for the ensemble kind."""
        return self._global(self._layout.gather([positions_of(self._state)[0]])[0], 0)

    @property
    def logp(self) -> np.ndarray:
        """Tempered log-probabilities, shape (n_rungs, n_chains[, W])."""
        return self._global(self._layout.gather([positions_of(self._state)[1]])[0], 0)

    def cold_chain_positions(self) -> np.ndarray:
        """Positions of the T=1 (first) rung."""
        return self.theta[0]

    def get_sample(self, rung: int = 0, burn: int = 0, thin: int = 1) -> np.ndarray:
        """
        Pooled stored samples of one rung, shape (n_kept * lanes, P).
        ``burn``/``thin`` apply to the stored step axis.
        """
        if not self._history:
            return np.empty([0, self.n_parameters])
        h = np.concatenate(self._history, axis=0)[burn::thin, rung]
        return h.reshape(-1, self.n_parameters)

    def get_probabilities(self, rung: int = 0, burn: int = 0, thin: int = 1) -> np.ndarray:
        """Pooled stored (tempered) log-probabilities of one rung."""
        if not self._prob_history:
            return np.empty([0])
        h = np.concatenate(self._prob_history, axis=0)[burn::thin, rung]
        return h.reshape(-1)

    def rhat(self, rung: int = 0, burn: int = 0, rank_normalized: bool = True) -> np.ndarray:
        """
        Per-parameter split-R-hat across one rung's chain lanes, shape
        (n_parameters,): the rank-normalized, folded estimator of Vehtari et
        al. (2021) by default; for the ensemble kind every walker counts as
        a replicate chain. One batched program on the cells' device.
        """
        from ..utils.diagnostics import rank_normalized_rhat, split_rhat

        if not self._history:
            raise ValueError(
                "[ ShardedTempering error ] no stored history - advance "
                "with store=True before requesting rhat."
            )
        h = np.concatenate(self._history, axis=0)[burn:, rung]
        if h.ndim == 4:  # ensemble kind: (steps, C, W, P) -> lanes merge
            h = h.reshape(h.shape[0], -1, h.shape[-1])
        series = torch.as_tensor(h, device=self.device).permute(2, 1, 0)  # (P, C, steps)
        estimator = rank_normalized_rhat if rank_normalized else split_rhat
        return estimator(series).cpu().numpy()

    def swap_rate_matrix(self) -> np.ndarray:
        """Per-rung-pair swap acceptance rates (upper-triangular)."""
        return self.successful_swaps / self.attempted_swaps.clip(min=1)

    def swap_diagnostics(self, show: bool = True):
        """Plot acceptance rates of position swaps between the rungs
        (reference: parallel.py:328-362)."""
        import matplotlib.pyplot as plt
        from ..plotting import transition_matrix_plot

        rate_matrix = self.swap_rate_matrix()
        total_swaps = self.successful_swaps.sum(axis=0) + self.successful_swaps.sum(axis=1)

        fig = plt.figure(figsize=(10, 5))
        ax1 = fig.add_subplot(121)
        transition_matrix_plot(
            axis=ax1,
            matrix=rate_matrix,
            exclude_diagonal=True,
            upper_triangular=True,
        )
        ax1.set_xlabel("rung number")
        ax1.set_ylabel("rung number")
        ax1.set_title("acceptance rate of rung position swaps")

        ax2 = fig.add_subplot(122)
        ax2.bar(range(1, self.n_rungs + 1), total_swaps)
        ax2.set_ylim([0, None])
        ax2.set_xlabel("rung number")
        ax2.set_ylabel("total successful position swaps")

        plt.tight_layout()
        if show:
            plt.show()
        return fig

    def update_directions(self, last: int = None):
        """
        Re-estimate PCA sweep directions per (rung, lane) from the stored
        history: one batched host eigendecomposition, as in the JAX class,
        then one copy of this process's rows to its device (pca kind only;
        requires stored history).
        """
        if self.kind != "pca":
            raise ValueError(
                "[ ShardedTempering error ] update_directions is only "
                "available for kind='pca'."
            )
        if not self._history:
            return self
        h = np.concatenate(self._history, axis=0)  # (steps, R, C, P)
        if last is not None:
            h = h[-last:]
        if h.shape[0] < max(2 * self.n_parameters, 3):
            return self
        centred = h - h.mean(axis=0, keepdims=True)
        covs = np.einsum("srcp,srcq->rcpq", centred, centred) / (h.shape[0] - 1)
        _, vecs = np.linalg.eigh(covs)
        P = self.n_parameters
        local = self._layout.local_rows(vecs.reshape(-1, P, P))
        self._state = self._state._replace(directions=torch.as_tensor(
            local, dtype=self._state.theta.dtype, device=self.device))
        return self

    # ------------------------------------------------------------------ #
    # checkpoint / resume in the JAX package's .npz layout
    # ------------------------------------------------------------------ #
    def _leaf_codec(self):
        from ..convert import (ensemble_state_from_jax, ensemble_state_to_jax_leaves,
                               hmc_state_from_jax, hmc_state_to_jax_leaves,
                               metropolis_state_from_jax, metropolis_state_to_jax_leaves,
                               nuts_state_from_jax, nuts_state_to_jax_leaves)

        return {"hmc": (hmc_state_to_jax_leaves, hmc_state_from_jax),
                "nuts": (nuts_state_to_jax_leaves, nuts_state_from_jax),
                "ensemble": (ensemble_state_to_jax_leaves, ensemble_state_from_jax)}.get(
            self.kind, (metropolis_state_to_jax_leaves, metropolis_state_from_jax))

    def global_state(self):
        """The state of every cell's rows on the host (CPU tensors, rows in
        global order), gathered in one host read."""
        leaves, spec = tree_flatten(self._state)
        host = self._layout.gather(leaves)
        return tree_unflatten([torch.as_tensor(h) for h in host], spec)

    def set_global_state(self, state):
        """Take this process's rows of a global state (rows in global
        order) onto the cells' device."""
        rows = torch.as_tensor(self._layout.rows)
        leaves, spec = tree_flatten(state)
        self._state = tree_unflatten([torch.as_tensor(x)[rows].to(self.device)
                                      for x in leaves], spec)

    def save(self, filename: str):
        """Checkpoint the replica-exchange state in the JAX class's layout
        (each state leaf ``(n_rungs, n_chains, ...)``, the key leaf from a
        fixed stream), so either package can restore it. Every process
        gathers the whole state and may write its own copy."""
        RC = self.n_rungs * self.n_chains
        key = np.random.default_rng(self._raw_steps).integers(0, 2**32, (RC, 2), dtype=np.uint32)
        leaves = self._leaf_codec()[0](self.global_state(), key)
        items = {f"leaf_{i}": self._global(np.asarray(v), 0) for i, v in enumerate(leaves)}
        items["temperatures"] = self.temperatures
        items["n_chains"] = self.n_chains
        items["kind"] = self.kind
        items["phase"] = self._phase
        items["attempted_swaps"] = self.attempted_swaps
        items["successful_swaps"] = self.successful_swaps
        np.savez(filename, **items)

    def restore(self, filename: str):
        """Restore a checkpoint saved by either package's ``save`` into this
        instance (same kind / temperatures / chain count), each process
        taking its rows."""
        D = np.load(filename)
        ck_kind = str(D["kind"]) if "kind" in D else self.kind
        if "phase" in D:
            ck_phase = int(D["phase"])
        elif "swap_counter" in D:
            ck_phase = int(D["swap_counter"]) % 2
        else:
            ck_phase = 0
        if (
            int(D["n_chains"]) != self.n_chains
            or ck_kind != self.kind
            or not np.allclose(D["temperatures"], self.temperatures)
        ):
            raise ValueError(
                "[ ShardedTempering error ] checkpoint configuration does "
                "not match this instance."
            )
        n_leaves = len(tree_flatten(self._state)[0]) + 1  # and the key leaf
        n_saved = sum(1 for k in D.files if k.startswith("leaf_"))
        if n_saved != n_leaves:
            raise ValueError(
                f"[ ShardedTempering error ] checkpoint stores {n_saved} "
                f"state leaves but the current '{self.kind}' state has "
                f"{n_leaves} — the checkpoint predates a kernel "
                f"state-layout change (e.g. the NUTS state gaining its "
                f"cached gradient); re-create it from the source run."
            )
        RC = self.n_rungs * self.n_chains
        leaves = [D[f"leaf_{i}"].reshape((RC,) + D[f"leaf_{i}"].shape[2:])
                  for i in range(n_saved)]
        state = self._leaf_codec()[1](leaves, device="cpu",
                                      dtype=positions_of(self._state)[0].dtype)
        self.set_global_state(state)
        self._phase = ck_phase
        if "attempted_swaps" in D:
            self.attempted_swaps = np.asarray(D["attempted_swaps"])
            self.successful_swaps = np.asarray(D["successful_swaps"])
        else:
            self.attempted_swaps = np.identity(self.n_rungs)
            self.successful_swaps = np.zeros((self.n_rungs, self.n_rungs))
        return self
