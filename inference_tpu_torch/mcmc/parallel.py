"""Parallel tempering and chain pools.

Port of ``inference_tpu.mcmc.parallel`` (``ParallelTempering``,
``ChainPool``). The rungs of one chain class with one configuration run as
one batch: their one-row states are stacked along the chain axis into one
R-row state (the inverse temperature is a state field, so rungs at
different temperatures share the step), and the class's batched transition
advances all rungs at once on the chains' device. ``HamiltonianChain``
rungs take an R-row HMC step built from the chain's posterior, gradient
route, mass, bounds and ``max_attempts`` (its own step evaluates one row);
``NutsChain`` rungs (a ``HamiltonianChain`` subclass, tested first) take
the chain's own NUTS step, which is batched, over R rows, and each rung's
cached tempered gradient travels and re-tempers with its position in every
swap.

Swap proposals use the reference's ``tight_pairs`` pairing and Metropolis
test ``U <= exp(-d(beta) d(logP))`` (reference: parallel.py:162-231). A
fused ``advance`` draws the pairs of all its cycles on the host up front
and the swap uniforms on the device, issues every cycle (``swap_interval``
steps, then ``_swap_on_device``) with no host read, and reads the accepted
flags once at the end, as the JAX package's one compiled program does. The
transitions' own retry loops (``retry=True``) still read the host once a
try (ROADMAP queue D2).

A ladder of mixed classes, of same-class rungs whose step settings differ,
or of one rung runs each rung through its own chain and swaps on the host
(``swap``); so does every ladder between the host-side direction updates
of ``PcaChain`` rungs. The batched path draws from one ``torch.Generator``
on the chains' device, seeded from ``self.rng`` as the JAX class seeds its
swap key. A posterior that is an ``nn.Module`` is copied onto each chain's
device, so rungs built from one module do not share it and take the
per-chain path.
"""

import sys
from time import time
from warnings import warn

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..utils import make_generator
from ._kernels import common
from ._kernels import hmc as hmc_kernel
from ._kernels import metropolis as met_kernel
from ._kernels import nuts as nuts_kernel
from .hmc import HamiltonianChain
from .nuts import NutsChain


class ChainPool:
    """
    Advancement of independent chains in turn (reference: parallel.py:15-30
    uses a multiprocessing.Pool; each chain here already runs on its
    device, so the pool drives them one after another; for thousands of
    homogeneous chains use ``inference_tpu_torch.parallel.ChainArray``).
    """

    def __init__(self, chains):
        self.chains = chains
        self.pool_size = len(self.chains)

    def advance(self, n: int):
        for chain in self.chains:
            chain._advance_n(n)


def _stack(states):
    """One R-row state from R one-row states."""
    return tree_map(lambda *xs: torch.cat(xs), *states)


def _swap_on_host(positions, probabilities, inv_temps, pairs, uniforms):
    """The swap of the JAX class's ``swap()`` on host arrays: for each pair
    (i, j) with its uniform u, exchange the positions when ``u <= exp(-(b_i
    - b_j) (p_i / b_i - p_j / b_j))``, re-tempering the log-probabilities at
    the receiving rung. Returns the new positions and log-probabilities, the
    permutation of rows and the accepted flags."""
    positions, probabilities = positions.copy(), probabilities.copy()
    perm = np.arange(len(inv_temps))
    accepted = []
    for (i, j), u in zip(pairs, uniforms):
        dt = inv_temps[i] - inv_temps[j]
        pi = probabilities[i] / inv_temps[i]
        pj = probabilities[j] / inv_temps[j]
        dp = pi - pj
        with np.errstate(over="ignore"):  # an overflow to inf accepts, as it should
            ok = bool(u <= np.exp(-dt * dp))
        if ok:
            pos_i = positions[i].copy()
            positions[i] = positions[j]
            positions[j] = pos_i
            probabilities[i] = pj * inv_temps[i]
            probabilities[j] = pi * inv_temps[j]
            perm[[i, j]] = perm[[j, i]]
        accepted.append(ok)
    return positions, probabilities, perm, accepted


def _swap_on_device(state, pairs, uniforms):
    """The swap of the fused advance on the R-row ``state``: ``pairs`` a
    ``(n, 2)`` long tensor of rung indices, ``uniforms`` ``(n,)``. Returns
    the swapped state and the accepted flags ``(n,)``, with no host read."""
    theta, logp, inv_t = state.theta, state.logp, state.inv_temp
    i, j = pairs[:, 0], pairs[:, 1]
    d_beta = inv_t[i] - inv_t[j]
    pi = logp[i] / inv_t[i]
    pj = logp[j] / inv_t[j]
    accept = uniforms <= torch.exp(-d_beta * (pi - pj))
    # the permutation realising the accepted swaps
    perm = torch.arange(theta.shape[0], device=theta.device)
    perm = perm.index_put((i,), torch.where(accept, j, i))
    perm = perm.index_put((j,), torch.where(accept, i, j))
    # probabilities are re-tempered at the receiving rung
    new_state = state._replace(theta=theta[perm], logp=(logp[perm] / inv_t[perm]) * inv_t)
    if hasattr(state, "grad"):
        # a cached tempered gradient rides with the position and re-tempers
        # like logp (grad = inv_temp * raw grad)
        new_state = new_state._replace(
            grad=(state.grad[perm] / inv_t[perm, None]) * inv_t[:, None]
        )
    return new_state, accept


def _hmc_rungs_step(chain):
    """The HMC transition of ``chain``'s configuration over any number of
    rows: its posterior batched, its gradient route (a torch posterior's
    by ``common.value_and_grad``; a user gradient or the forward
    differences of a host posterior row by row), its mass, bounds
    and ``max_attempts``, repeat until accept."""
    logp = chain._logp
    if chain.user_grad is None and not logp.host:
        value_and_grad = common.value_and_grad(logp)
        grad = lambda t: value_and_grad(t)[1]
    else:
        one = chain._gradient_fn(chain._state.theta[0])
        grad = lambda t: torch.stack([one(row) for row in t])
    return hmc_kernel.make_hmc_step(
        logp.batched,
        grad,
        max_attempts=chain.max_attempts,
        mass_velocity=chain.mass.get_velocity,
        mass_sample=chain.mass.momentum,
        bounds_reflect=None if chain.bounds is None else chain.bounds.reflect_momenta,
        retry=True,
    )


class ParallelTempering:
    """
    Replica-exchange ('parallel tempering') sampling over a list of chains
    covering a range of temperatures, sorted in increasing-temperature order.

    Chains of the same class and step settings (the common case) advance as
    one batch, with sampling and swaps fused into one host read per
    advance. A mixed list of classes is also supported (reference:
    parallel.py:21-60 accepts any chain types): each rung then advances
    through its own chain and swaps are performed on the host.

    :param chains: \
        A list of chain objects (``GibbsChain``, ``MetropolisChain``,
        ``PcaChain``, ``HamiltonianChain``, ``NutsChain``) sorted by
        increasing temperature, all on one device.
    """

    def __init__(self, chains):
        self.chains = list(chains)
        self.N_chains = len(self.chains)
        self.rng = np.random.default_rng()

        cls = type(self.chains[0])
        self._heterogeneous = not all(type(c) is cls for c in self.chains)
        n_params = {c.n_parameters for c in self.chains}
        if len(n_params) != 1:
            raise ValueError(
                "[ ParallelTempering error ] All chains must have the same "
                "number of parameters."
            )

        # the batched path builds ONE step (from chains[0]) for every rung:
        # any per-rung setting it would override routes the ladder through
        # the per-chain (heterogeneous) path
        if not self._heterogeneous and self.N_chains > 1:
            if not all(self._step_config_matches(self.chains[0], c) for c in self.chains[1:]):
                self._heterogeneous = True
        if self.N_chains < 2:
            # a single rung has no swap partners: run it as a plain chain
            self._heterogeneous = True

        self.temperatures = [1.0 / c.inv_temp for c in self.chains]
        self.inv_temps = [c.inv_temp for c in self.chains]

        self.attempted_swaps = np.identity(self.N_chains)
        self.successful_swaps = np.zeros([self.N_chains, self.N_chains])

        if sorted(self.temperatures) != self.temperatures:
            warn(
                "The list of chain objects passed to ParallelTempering should "
                "be sorted in order of increasing chain temperature."
            )

        self.device = self.chains[0].device
        if not self._heterogeneous:
            # stack the one-row states into one R-row state
            self._batched_state = _stack([self._rung_state(c) for c in self.chains])
            chain = self.chains[0]
            if isinstance(chain, HamiltonianChain) and not isinstance(chain, NutsChain):
                # a HamiltonianChain's own step evaluates one row
                self._vstep = _hmc_rungs_step(chain)
                self._run_steps = hmc_kernel.run_steps
            else:
                # the other classes' own steps are batched, NUTS's included
                # (a NutsChain is a HamiltonianChain: a NUTS ladder never
                # runs R-row HMC transitions)
                self._vstep = chain._get_step()
                self._run_steps = (nuts_kernel.run_steps if isinstance(chain, NutsChain)
                                   else met_kernel.run_steps)
        else:
            self._batched_state = None
            self._vstep = None
        self._generator = make_generator(int(self.rng.integers(0, 2**31 - 1)), self.device)
        # PCA rungs need host-side eigendecompositions mid-run, which rules
        # out fusing many cycles; a mixed list cannot be batched at all
        self._fusable = not self._heterogeneous and not any(
            hasattr(c, "next_update") for c in self.chains
        )

    @staticmethod
    def _rung_state(chain):
        """A chain's one-row state, with an HMC chain's ``steps`` attribute
        written into it as its own ``_run_chunk`` does."""
        state = chain._state
        if hasattr(state, "steps"):
            state = state._replace(steps=torch.full_like(state.steps, int(chain.steps)))
        return state

    @staticmethod
    def _step_config_matches(a, b) -> bool:
        """Whether two same-class chains share every setting the batched
        step is built from (posterior, bounds/modes, mass, caps): only the
        state (positions, widths, inv_temp) may differ."""
        if a.posterior is not b.posterior:
            return False
        for attr in ("steps", "max_attempts", "max_tries", "alpha", "retry", "max_depth"):
            if getattr(a, attr, None) != getattr(b, attr, None):
                return False
        ba, bb = getattr(a, "bounds", None), getattr(b, "bounds", None)
        if (ba is None) != (bb is None):
            return False
        if ba is not None and not (
            np.array_equal(ba.lower, bb.lower) and np.array_equal(ba.upper, bb.upper)
        ):
            return False
        for attr in ("_non_negative", "_bounded", "_lower", "_upper"):
            va, vb = getattr(a, attr, None), getattr(b, attr, None)
            if (va is None) != (vb is None):
                return False
            if va is not None and not np.array_equal(va, vb):
                return False
        ma, mb = getattr(a, "mass", None), getattr(b, "mass", None)
        if (ma is None) != (mb is None):
            return False
        if ma is not None and not np.array_equal(np.asarray(ma.inv_mass),
                                                 np.asarray(mb.inv_mass)):
            return False
        return True

    # ------------------------------------------------------------------ #
    # advancement
    # ------------------------------------------------------------------ #
    def _absorb(self, outs):
        """Hand each rung its row of a chunk of outputs (``(n, R, ...)``)."""
        for k, chain in enumerate(self.chains):
            chain._absorb_outputs(type(outs)(*(f[:, k:k + 1] for f in outs)))

    def _check_failed(self, state):
        if hasattr(state, "failed") and bool(state.failed.any()):
            raise ValueError(
                "[ ParallelTempering error ] A chain failed to take a step "
                "within its maximum allowed attempts."
            )

    @torch.no_grad()
    def _advance_fused(self, cycles: int, swap_interval: int):
        """Run ``cycles`` sample+swap cycles with one host read: the pairs
        of every cycle from ``tight_pairs()`` up front, the swap uniforms
        drawn on the device, the accepted flags read at the end."""
        pairs = np.array([self.tight_pairs() for _ in range(cycles)], dtype=np.int64)
        state = self._batched_state
        dev_pairs = torch.from_numpy(pairs)
        if self.device.type == "cuda":  # an asynchronous copy: no host sync
            dev_pairs = dev_pairs.pin_memory()
        dev_pairs = dev_pairs.to(self.device, non_blocking=True)
        uniforms = torch.rand(pairs.shape[:2], generator=self._generator,
                              dtype=state.logp.dtype, device=self.device)
        chunks, flags = [], []
        for c in range(cycles):
            state, outs = self._run_steps(self._vstep, state, swap_interval, True,
                                          self._generator)
            state, accepted = _swap_on_device(state, dev_pairs[c], uniforms[c])
            # an accepted swap replaces the cycle's last recorded sample
            # (reference: parallel.py:222-229)
            outs.theta[-1] = state.theta
            outs.logp[-1] = state.logp
            chunks.append(outs)
            flags.append(accepted)
        self._batched_state = state
        self._absorb(type(chunks[0])(*(torch.cat(f) for f in zip(*chunks))))

        accepted = torch.stack(flags).cpu().numpy()  # (cycles, pairs): the one host read
        for c in range(cycles):
            for p, (i, j) in enumerate(pairs[c]):
                self.attempted_swaps[i, j] += 1
                if accepted[c, p]:
                    self.successful_swaps[i, j] += 1
        self._check_failed(state)

    @torch.no_grad()
    def _run_batch(self, n: int):
        """Advance all rungs ``n`` steps as one batch."""
        state, outs = self._run_steps(self._vstep, self._batched_state, n, True,
                                      self._generator)
        self._batched_state = state
        self._absorb(outs)
        self._check_failed(state)

    def take_steps(self, n: int):
        """Advance all chains ``n`` steps without swap attempts."""
        if self._heterogeneous:
            # mixed classes: each rung advances through its own chain
            for c in self.chains:
                c._advance_n(n)
            return
        remaining = int(n)
        while remaining > 0:
            run = remaining
            # stop at PCA direction-update boundaries (host eigendecomposition)
            boundaries = [
                c.next_update - c.chain_length
                for c in self.chains
                if hasattr(c, "next_update") and c.next_update > c.chain_length
            ]
            if boundaries:
                run = min(run, min(boundaries))
            self._run_batch(run)
            remaining -= run
            for k, c in enumerate(self.chains):
                if hasattr(c, "next_update") and c.chain_length == c.next_update:
                    c.update_directions()
                    directions = self._batched_state.directions.clone()
                    directions[k] = torch.as_tensor(c.directions, dtype=directions.dtype,
                                                    device=self.device)
                    self._batched_state = self._batched_state._replace(directions=directions)

    # ------------------------------------------------------------------ #
    # swap moves (reference: parallel.py:154-231)
    # ------------------------------------------------------------------ #
    def uniform_pairs(self):
        """Random pairing with uniform sampling across all pairings."""
        proposed = self.rng.permutation(self.N_chains)
        return [p for p in zip(proposed[::2], proposed[1::2])]

    def tight_pairs(self):
        """
        Random pairing where almost all pairs are separated by at most two
        temperature rungs.
        """
        pairs = [(i, i + j) for i in range(self.N_chains - 1) for j in [1, 2]][:-1]
        sample = []
        while len(pairs) > 0:
            p = pairs[self.rng.integers(len(pairs))]
            pairs = [k for k in pairs if not any(j in k for j in p)]
            sample.append(p)
        remaining = len(sample) - self.N_chains // 2
        if remaining != 0:
            leftovers = [i for i in range(self.N_chains) if not any(i in p for p in sample)]
            self.rng.shuffle(leftovers)
            sample.extend(
                p if p[0] < p[1] else (p[1], p[0])
                for p in zip(leftovers[::2], leftovers[1::2])
            )
        return sample

    def swap(self):
        """Propose Metropolis position swaps between randomly-paired rungs,
        on the host: ``tight_pairs()``, then one ``self.rng.random()`` per
        pair, as the JAX class draws them."""
        if self._heterogeneous:
            positions = np.array([c._state.theta[0].cpu().numpy() for c in self.chains])
            probabilities = np.array([float(c._state.logp[0]) for c in self.chains])
        else:
            positions = self._batched_state.theta.cpu().numpy()
            probabilities = self._batched_state.logp.cpu().numpy()

        proposed_swaps = self.tight_pairs()
        for pair in proposed_swaps:
            self.attempted_swaps[pair] += 1
        uniforms = [self.rng.random() for _ in proposed_swaps]
        positions, probabilities, perm, accepted = _swap_on_host(
            positions, probabilities, self.inv_temps, proposed_swaps, uniforms
        )
        for (i, j), ok in zip(proposed_swaps, accepted):
            if ok:
                self.successful_swaps[i, j] += 1
        if not any(accepted):
            return

        if self._heterogeneous:
            for k, chain in enumerate(self.chains):
                dtype = chain._state.theta.dtype
                chain._state = chain._state._replace(
                    theta=torch.as_tensor(positions[k], dtype=dtype, device=chain.device)[None],
                    logp=torch.tensor([probabilities[k]], dtype=dtype, device=chain.device),
                )
                if perm[k] != k and hasattr(chain._state, "grad"):
                    # the partner rung may carry no gradient to hand over:
                    # recompute the cache at the new position
                    chain._refresh_state_grad()
        else:
            state = self._batched_state
            as_dev = lambda x: torch.as_tensor(x, dtype=state.theta.dtype, device=self.device)
            self._batched_state = state._replace(theta=as_dev(positions),
                                                 logp=as_dev(probabilities))
            if hasattr(state, "grad"):
                g = state.grad.cpu().numpy()
                inv_t = np.asarray(self.inv_temps, dtype=float)
                self._batched_state = self._batched_state._replace(
                    grad=as_dev((g[perm] / inv_t[perm, None]) * inv_t[:, None])
                )
        for k, chain in enumerate(self.chains):
            chain._consolidated_theta()[-1, :] = positions[k]
            chain._consolidated_probs()[-1] = probabilities[k]

    def advance(self, n: int, swap_interval: int = 10):
        """
        Advance each chain ``n`` steps, attempting swaps every
        ``swap_interval`` steps.
        """
        total_cycles = n // swap_interval

        if self._fusable and total_cycles > 0:
            # power-of-two cycle chunks, at most 512 cycles a host read
            remaining = total_cycles
            t_start = time()
            done = 0
            while remaining > 0:
                chunk = min(1 << (remaining.bit_length() - 1), 512)
                self._advance_fused(chunk, swap_interval)
                remaining -= chunk
                done += chunk
                dt = time() - t_start
                pct = int(100 * done / total_cycles)
                eta = int(dt * (total_cycles / done - 1))
                sys.stdout.write(
                    f"\r  [ Running ParallelTempering - {pct}% complete   "
                    f"ETA: {eta} sec ]    "
                )
                sys.stdout.flush()
        else:
            for _ in range(total_cycles):
                self.take_steps(swap_interval)
                self.swap()

        if n % swap_interval != 0:
            self.take_steps(n % swap_interval)

        sys.stdout.write("\r  [ Running ParallelTempering - complete! ]                    \n")
        sys.stdout.flush()

    def run_for(self, minutes=0, hours=0, swap_interval: int = 10):
        """Advance all chains for a chosen amount of wall-clock time."""
        run_time = (hours * 60.0 + minutes) * 60.0
        start_time = time()
        end_time = start_time + run_time

        t1 = time()
        if self._fusable:
            self._advance_fused(1, swap_interval)
        else:
            self.take_steps(swap_interval)
            self.swap()
        t2 = time()

        # cycles chosen to give a print-out roughly every 2 seconds, rounded
        # to a power of two
        N = max(1, int(2.0 / max(t2 - t1, 1e-9)))
        N = 1 << (N.bit_length() - 1)

        while time() < end_time:
            if self._fusable:
                self._advance_fused(min(N, 512), swap_interval)
            else:
                for _ in range(N):
                    self.take_steps(swap_interval)
                    self.swap()
            seconds_remaining = end_time - time()
            m, s = divmod(max(seconds_remaining, 0), 60)
            h, m = divmod(m, 60)
            sys.stdout.write(
                "\r  [ Running ParallelTempering - time remaining: "
                "%d:%02d:%02d ]    " % (h, m, s)
            )
            sys.stdout.flush()

        sys.stdout.write("\r  [ Running ParallelTempering - complete! ]                    \n")
        sys.stdout.flush()

    # ------------------------------------------------------------------ #
    # diagnostics & teardown
    # ------------------------------------------------------------------ #
    def swap_diagnostics(self):
        """Plot acceptance rates of position swaps between the chains."""
        import matplotlib.pyplot as plt
        from ..plotting import transition_matrix_plot

        rate_matrix = self.successful_swaps / self.attempted_swaps.clip(min=1)

        pairs = [
            (i, i + j)
            for j in range(1, self.N_chains)
            for i in range(self.N_chains - j)
        ]
        total_swaps = np.zeros(self.N_chains)
        for i, j in pairs:
            total_swaps[i] += self.successful_swaps[i, j]
            total_swaps[j] += self.successful_swaps[i, j]

        fig = plt.figure(figsize=(10, 5))
        ax1 = fig.add_subplot(121)
        transition_matrix_plot(
            axis=ax1,
            matrix=rate_matrix,
            exclude_diagonal=True,
            upper_triangular=True,
        )
        ax1.set_xlabel("chain number")
        ax1.set_ylabel("chain number")
        ax1.set_title("acceptance rate of chain position swaps")

        ax2 = fig.add_subplot(122)
        ax2.bar(range(1, self.N_chains + 1), total_swaps)
        ax2.set_ylim([0, None])
        ax2.set_xlabel("chain number")
        ax2.set_ylabel("total successful position swaps")

        plt.tight_layout()
        plt.show()

    def _sync_states(self):
        """Unstack the batched state back into the chain objects, each with
        its leading axis of 1, and mirror an HMC rung's step-size counters
        (no-op on the heterogeneous path, where each chain owns its live
        state)."""
        if self._batched_state is None:
            return
        for k, chain in enumerate(self.chains):
            chain._state = tree_map(lambda x, k=k: x[k:k + 1].clone(), self._batched_state)
            if hasattr(chain, "ES"):
                eps = chain._state.eps
                chain.ES.sync_counters(eps.avg, eps.var, eps.num, eps.chk_int)

    def return_chains(self):
        """Return the chain objects with their final states."""
        self._sync_states()
        return self.chains

    def shutdown(self):
        """Hand the batched state back to the chains (API parity: the
        reference terminates its worker processes here)."""
        self._sync_states()
