"""Drive the PyTorch port's main paths once on one CUDA GPU: batched HMC
(kernel B1, and its wide route for P > 64), the headline and dense HMC
benches, the single-chain HamiltonianChain, the Metropolis family
(ChainArray's gibbs, metropolis and pca kinds, GibbsChain, PcaChain),
posteriors written with numpy, parallel tempering (ParallelTempering) and
the ensemble sampler (EnsembleSampler, ChainArray's ensemble kind), NUTS
(NutsChain, ChainArray's nuts kind, NUTS ladders) and the 1D density
estimators (GaussianKDE, UnimodalPdf, a chain's get_marginal and
get_interval), dense GP regression (kernel
B2) with its on-device fit, Bayesian optimisation (GpOptimiser), the
matrix-free GP (its small-noise df64 tier through kernels B3-B8;
its cg and mixed tiers, fit() and the RQ and white-noise kernels through
B2; LargeScaleGpLinearInverter in all three tiers) and the probes P1-P3
that measure B3.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. device: a CUDA device is required; prints its name, the device count
   and ``nvidia-smi``'s name and power limit;
2. build: compiles kernel B1 (``inference_tpu_torch/ops/csrc/hmc_fused.cu``,
   one library per parameter count and kind of mass: P = 1, 2, 3, 10, 32,
   64 with unit mass, P = 32 with diagonal mass, and the wide library for
   any P > 64), B2
   (``.../sqexp.cu``, one library per D up to 5: D = 2 and 5, and the wide
   one for larger D), B3/B4 (``.../sqexp_fused.cu``), B5/B7
   (``.../sqexp_entries.cu``), B6/B8 (``.../sqexp_stored.cu``) and the
   probes P1 (``.../issue_probe.cu``), P2 (``.../sqexp_ablate.cu``) and P3
   (``.../sqexp_words_mma.cu``, one library per d: d = 2 and 20, and the
   streamed one at d = 1,000) with nvcc,
   one process each, started
   together; times each build and prints the ``-Xptxas -v`` registers
   and spills, and for each instantiation of B3/B4's kernels and each of
   B1's libraries the local-memory instructions in all and in its hot
   loop, and the SASS per entry and dimension of the distance loops of
   the wide B3, B4, B5 and B7 (cuobjdump);
3. kernel against plain version, on the card, in float32, on the same
   random draws: (a) P=10, K=65,536, one transition, bit for bit; (b) the
   same with 64 transitions and the history; (c) P=32, diagonal mass,
   inv_temp 0.5, K=4,096; (d-f) P=1, 32 and 64, one transition. The SASS
   mix of B1's leapfrog step at P=10 and 32; then one chunk at the main
   path's K timed at P=2, 10, 32 and 64 beside its bound (at P=10 beside
   the plain version too);
4. main path: ``ChainArray("hmc", GaussianForm, ..., fused=True)`` on the
   10-dim correlated Gaussian of ``bench.py`` at 65,536 chains: warm-up,
   a timed advance, a stored advance for the acceptance and a thinned one
   for the mixing checks; checks the launch count, the sample variances
   and R-hat; a ``torch.profiler`` breakdown of one more advance; then the
   port's headline bench (``inference_tpu_torch.bench.headline``:
   ``bench.py``'s chain sweep, 1,024 to 131,072 chains), its JSON line;
5. plain path: the same ChainArray with ``fused=False``, 16 transitions
   timed; then
   (a) kernel B1's wide route (P > 64): its plans (chains a block, A
   resident or streamed) and the SASS mix of each wide kernel's product
   loop, then against its plain version at P = 65, 100 and 256, timed at
   each beside its bound and the warp-per-chain design's time (quoted)
   with the steps its blocks take beyond the chains' own (modelled from
   the step draws), and
   ``ChainArray(fused=True)`` at P = 100 and
   256, 16,384 chains (attempts/s, launches, variances); (c) the
   dense HMC bench (``inference_tpu_torch.bench.dense_hmc``) at 4,096
   chains, both workloads checked (the Gaussian's variances; the forward
   model's means and variances against its exact FP64 posterior); (d)
   ``HamiltonianChain`` on the card, a bounded 10-dim problem for 1,000
   steps (10 leapfrog steps a proposal) against the same chain on the CPU
   for 1,000, its device operations per transition counted by
   ``torch.profiler``, and a save, load and advance; then the Metropolis
   family, which has no kernel of its own: (e) gibbs-10d,
   ``ChainArray`` on ``benchmarks/chain_batch_bench.py``'s 10-dim Gaussian,
   the gibbs kind at 1,024 and 65,536 chains with retry=True and False and
   the metropolis and pca kinds with retry=False timed in chain-steps/s
   after the bench's warm-up of 128 steps (each half of the timed window
   printed), stored runs at 1,024 chains of gibbs with retry=True and False
   and of metropolis and pca with retry=False held to the covariance
   (variances within 10%, R-hat < 1.05; each run's variance bias in
   standard errors printed), a ``torch.profiler`` reading of one retry=True
   advance at 65,536 chains (idle share, launches a sweep, tries a
   parameter, host syncs); (f) gibbs-rosenbrock, ``GibbsChain`` and
   ``PcaChain`` on ``demos/gibbs_chain_demo.py``'s posterior from [2, -4] on
   the card and on the CPU (steps/s), each facade's card chain held to its
   CPU chain by the one-chain check (means and variance ratios in
   standard errors from each chain's ESS), and two retry=False
   ``ChainArray``s of 1,024 chains (gibbs, pca) held to 2D grid quadrature;
   (g) a1-numpy, the same posterior written with numpy: ``GibbsChain`` on
   the card (host evaluations, state on the card) held to the torch
   ``GibbsChain``'s CPU chain by the same check, ``HamiltonianChain`` with
   the forward-difference gradient, ``ChainArray("gibbs")`` at 64 chains;
   their readings as one JSON line; then parallel tempering and the
   ensemble sampler, which have no kernel of their own either: (h)
   pt-bimodal-8, ``benchmarks/tempering_bench.py``'s 8 GibbsChain rungs
   (T = 1-128): a counted ``advance(2000)`` (the ladder's host reads, one
   per chunk of cycles, and its transitions', by torch's sync warnings),
   a timed ``advance(1000)`` (steps/s per rung), the lengths, swap counts and the cold
   rung's left-mode share held, the swap acceptance matrix, the device
   swap against the host swap on one float64 state, a profile; pt-demo-6
   (``demos/parallel_tempering_demo.py``'s ladder through ``run_for``),
   pt-hmc-2 (two HamiltonianChain rungs, the R-row HMC step) and pt-pca-4
   (four PcaChain rungs, their direction updates at a single chain's
   steps); (i) ensemble-4096, ``benchmarks/ensemble_bench.py``'s 4,096
   walkers: the facade's and the bare loop's walker-updates/s, a profile,
   retry=False's variances within 5% of the truth, retry=True's printed;
   ensemble-chains, ``ChainArray("ensemble")`` at 256 chains of 32
   walkers; their readings as one ``{"tempering_ensemble": ...}`` line;
   then NUTS and the density estimators, which have no kernel of their own
   either: (j) nuts-10d, ``bench.nuts`` (``benchmarks/nuts_bench.py``'s
   10-dim Gaussian, NUTS at epsilon 0.25, max_depth 8 beside HMC at 50
   steps) at 4,096, 16,384 and 65,536 chains (timed steps cut), its JSON
   line a tier; at 4,096 chains the host reads a transition (torch's sync
   warnings: the doubling loop's at most max_depth - 1), a stored run held
   to the covariance (variances within 10%, R-hat < 1.05) and a profile
   (launches a batch leaf, idle share); nuts-twin, 64 chains in float64 on
   one set of injected draws, 5 transitions on the card and the CPU
   (1e-12; depths, counts, flags equal); nuts-demo,
   ``demos/nuts_demo.py``'s ring with one ``NutsChain`` (its 6,000
   transitions cut to 400), radius and thickness within a CPU rehearsal's
   bands; pt-nuts-3, ``tests/mcmc/test_parallel.py:212-247``'s NUTS ladder,
   the cached gradients after the fused and the host swaps; (k)
   kde-marginal, nuts-10d's stored run as one chain on the card and the
   CPU: ``get_marginal(0)`` and a cross-validated ``GaussianKDE`` (bandwidth,
   pdf and cdf at 10,000 points, 1e-10), ``get_interval()`` and
   ``sample_hdi_device`` equal, ``UnimodalPdf`` held at the CPU's MAP
   (1e-12) and no worse there (1e-9); their readings as one
   ``{"nuts_pdf": ...}`` line;
6. kernel B2 against its plain version on the card, on the same inputs,
   each check printing the library and the store route it took: float64
   and float32 at 16,384 x 16,384 (D=2, gp-16k's data), a ragged float64
   case (3,001 x 2,500, D=5), D=17 and D=100 (the wide library) and an odd
   row pitch (scalar stores) in each dtype, and the autograd backward
   against autograd of the plain version at N=4,096; then both timed at
   16,384 x 16,384 in each dtype, beside ``torch.cdist`` and the exp and a
   ``fill_`` of an equal tensor, with the SASS instructions per entry of
   the launched kernel's hot loop and its registers;
7. GP main path (gp-16k): ``GpRegressor`` on ``benchmarks/gp_lml_bench.py``'s
   data and hyperparameters at N=16,384 in float64: LML+gradient
   evaluations per second and peak memory, the B2 launch count, the LML
   against an independent plain route (1e-10) and the gradient against
   central finite differences (1e-5); a ``torch.profiler`` breakdown of
   one evaluation (device time by operation, device idle share); the same
   with ``cholesky="analytic"``; one float32 evaluation;
8. GP fit and prediction at N=4,096 in float64: ``fit(optimizer="bfgs",
   n_starts=2)``, then ``__call__`` at 4,096 points against the plain
   route (1e-10);
8a. bfgs-card: ``utils.optimize.minimize_bfgs`` (JAX's BFGS batched over
   starts) on 64 starts of a 10-dim SPD quadratic and of the 2D Rosenbrock
   in float64, against the same code on the CPU: every quadratic row
   converged, each row's status the CPU's, x within 1e-10 / 1e-6;
8b. gp-fit-device-4k: ``GpRegressor.fit_device(starts=16)`` on phase 8's
   data: the batched objective against the single-start one at 4 thetas
   (1e-10), the fit's seconds, iterations and B2 launches (one per start
   and evaluation), its LML at least phase 8's less 1e-6 of it, one batched
   evaluation profiled (idle share, B2, the Cholesky and its backward);
8c. bo-warm-2d: ``bench.bo_warm`` (``benchmarks/bo_warm_bench.py``'s warm
   ``GpOptimiser`` iteration, optimizer="device"; float32 times
   ``BO_WARM_ITERATIONS_F32`` of its 10) in float64 and float32:
   warm-iteration seconds, host reads an iteration, one iteration profiled
   (device idle share, kernel launches); proposals in the bounds, the
   histories one entry per added point, the adopted state equal to an
   explicit refit (1e-10) after a fused proposal and after a public read;
   in float64 one fused proposal from one state held to the CPU's stage by
   stage (``BO_TWIN_RTOL``, ``BO_TWIN_LML_RTOL``);
8d. bo-demo-1d: ``demos/gp_optimisation_demo.py``'s loop (8 iterations),
   the best value within 0.05 of the grid maximum; their readings as one
   ``{"gp_optimisation": ...}`` JSON line;
9. kernels B3-B8 against their plain versions at full width, n = 53,248
   (gp-large-50k's padded data): B5 and B7 equal bit for bit, row block by
   row block; B6/B8's FP64 MMA on one 16 x 8 tile exactly; B3, B4, B6 and
   B8 (q = 1, 2, 8, 16) within 1e-13 of sum_j |E_ij| |V_jk|; B6 against B4
   on the same V, B8 against B6 within the float32 store's 2^-24; then each
   timed with CUDA events beside its plain version, B6 beside
   ``torch.matmul``, B4, B6 and B8 at every checked q (B4's q = 1 is B3);
   at n = 4,096 B3, B4 (q = 8), B5 and B7 at d = 17, 20, 33 and 100 (the
   wide kernels; B5 and B7 bit for bit; B4 also on a ragged row block at d
   = 20 and 100) and B4 and B6 at q = 20 (two launches each); then B3, B4
   (q = 8), B5 and B7 at n = 53,248, d = 20 in two turns with their plain
   versions, beside their flops bound and their FP64-issue time (a model),
   and each one output held against its plain version there (B5 and B7 bit
   for bit, B3 and B4 within 1e-13 of sum_j |E_ij| |V_jk|);
10. matrix-free GP main path (gp-large-50k): ``LargeScaleGP(solver="df64")``
    on ``benchmarks/df64_solve_bench.py``'s data at N=50,000 (sigma=0.01,
    rank 512, block 4096, cg_tol 1e-9) with ``store_entries="auto"`` (B5,
    then B6 in every iteration), ``False`` (B3 in every iteration) and
    ``"f32"`` (B7, then B8 in every iteration and B3 in every refresh):
    cold constructor and warm solve, chunks and iterations, the FP64
    residual by the port's kernel and by an independent plain route
    (<= 1e-9), 256 means and 16 variances (B6, B4 or B8 with q = 8), peak
    memory, launches per kernel (B6 and B8 also by q), and a
    ``torch.profiler`` breakdown of one warm solve with each store;
    gp-large-50k-d20: the same generator in 20 dimensions (x on [0, 7.5]^20,
    amplitude 1, lengthscale 5, y_err 0.1) with ``"auto"`` (the wide B5, then B6) and
    ``False`` (the wide B3, then the wide B4 for the predictions), the same
    readings, each profiled, the two tiers within 1e-7;
11. gp-large-16k: the same at N=16,384 against a dense FP64 Cholesky on
    the card: the training solve (1e-8 of max |alpha|), means (1e-6) and
    variances (1e-9) at 16 points;
11a. the rest of the matrix-free GP (ROADMAP A11): B2 as the cg tier launches
    it (a 4,096 x 53,248 float32 row block) against its plain version and
    timed beside its store bound (check 13a); gp-large-cg-50k,
    ``benchmarks/large_gp_bench.py``'s configuration (N = 50,000, y_err 0.1,
    block 4096, rank 4096, cg_tol 1e-4, float32) with ``solver="cg"`` and
    ``"mixed"`` (cold and warm solve, iterations, B2 launches a system
    product, the FP64 residual by the plain route <= 1e-3, the 256 means' rms,
    means within 1e-2 and 16 variances within 1e-3 of ``solver="df64"``'s on
    the same data; a warm cg solve profiled: idle share, B2 and the block
    products' shares); gp-large-fit-16k, ``benchmarks/large_gp_fit_bench.py``'s
    ``fit()`` (30 steps, the exact FP64 LML up by >= 10, no biased-step
    warning, a refit's residual and rms); rq-16k, ``RationalQuadratic() +
    WhiteNoise()`` through the cg tier in float64 on gp-16k's data, means
    within 1e-6 of the dense ``GpRegressor``; inv-50k, BASELINE configuration
    #5 (N = 50,000 local-averaging parameters, M = 4,096 data, y_err 0.02)
    through ``LargeScaleGpLinearInverter`` with ``solver="cg"``, ``"mixed"``
    (float32, B2) and ``"df64"`` with ``store_entries="auto"`` (B5, B6) and
    ``False`` (B3/B4; a warm solve timed in the cg tier only): the plain-route
    data-space residual (1e-3; df64 1e-9),
    the tiers' means and variances against df64's, predict_data's rms <= 3
    y_err; inv-8k, the same generator at N = 8,192 against the dense FP64
    ``GpLinearInverter`` (df64 1e-8, cg 1e-6) and a 30-step ``fit()`` that
    raises the exact data-space LML by >= 10. Each phase prints its seconds,
    peak memory and launches per kernel from 0, beside the card's name and
    power limit; their readings as one ``{"matrix_free_gp": ...}`` JSON line;
12. the probes at full width, n = 53,248, d = 2 (their own U[0, 10]^2
    generator, the distribution of gp-large-50k's coordinates): P1 bit for
    bit against its plain version in float32 and float64, every mode and
    chain count; every P2 variant against its plain version (1e-13 of
    sum|term||w|, d2exp32 1e-6, and again on coordinates shifted by 1e4,
    where a float32-distance control must fail that limit); P3 (one library
    per d) at d = 2 on that data and at d = 20 on gp-large-50k-d20's
    pre-scaled [0, 1.5]^20: the class sums and the parts of S of one 32 x 16 tile
    exactly (also on words of +-64), its matvec against its plain version
    (1e-13) and B3 (1e-11); the same checks of its streamed kernel (d above
    411) at d = 1,000, n = 512.
    Then each probe's own entry point, its launch count set to 0 before and
    read after: P1 under ``nvidia-smi``'s SM clock and power readings, every
    configuration timed with its bound; the SASS instruction mix of the hot
    loops of B3, B4 (q = 8), P2 and P3 (d = 2, 20) with the issue bounds it
    sets; P2 every variant and B3; P3 at d = 2 and 20 beside B3, against the
    float64 truth, with its bound (the larger of its FP64 flops and its
    int8 MACs over their data-sheet rates) and two models printed beside
    it, not in the JSON line: its FP64-issue time (its SASS's FP64
    instructions per entry at P1's measured clock) and tensor-core time;
    P3's hot loop must hold no inner loop and its issue time must stay
    below the measured time, or its SASS was misread; then the plain
    versions timed.

The second-to-last lines are a JSON object describing the kernels (each
with its bound, plain version and library call) and the ``nvidia-smi``
line; the last line is ``{"ok": true, "device": {...}}``.
"""

import copy
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from inference_tpu_torch import (Bounds, EnsembleSampler, GibbsChain, HamiltonianChain,
                                 NutsChain, ParallelTempering, PcaChain)
from inference_tpu_torch.bench import bo_warm, dense_hmc, headline
from inference_tpu_torch.bench import nuts as bench_nuts
from inference_tpu_torch.bench.headline import HMC_STEPS, N_DIM, make_cov
from inference_tpu_torch.convert import gp_optimiser_from_state, gp_optimiser_state_of
from inference_tpu_torch.gp import (GpLinearInverter, GpOptimiser, GpRegressor, LargeScaleGP,
                                    LargeScaleGpLinearInverter, RationalQuadratic, WhiteNoise)
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale, value_and_grad
from inference_tpu_torch.mcmc._kernels.ensemble import (init_ensemble_state, make_ensemble_step,
                                                        run_steps as run_ensemble_steps)
from inference_tpu_torch.mcmc._kernels import nuts as nuts_kernel
from inference_tpu_torch.mcmc.hmc import EpsilonSelector
from inference_tpu_torch.mcmc.parallel import _swap_on_device, _swap_on_host
from inference_tpu_torch.ops import _build, df64, hmc_fused, pairwise
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.parallel._kinds import build_kind
from inference_tpu_torch.pdf import GaussianKDE, sample_hdi, sample_hdi_device
from inference_tpu_torch.utils import effective_sample_size, optimize
from inference_tpu_torch.utils.optimize import minimize_bfgs
from inference_tpu_torch.probes import (EXP_FLOPS, FP32_FLOPS, FP64_FLOPS, bound, df64_ablate,
                                        fp64_issue_ms, time_events, vpu_probe)
from inference_tpu_torch.probes import df64_mxu_d2_experiment as words

N_CHAINS = 65_536
RTOL, ATOL = 1e-4, 1e-5  # per-chain kernel-vs-plain tolerance in float32
MIN_AGREE = 0.999        # share of chains that must agree


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] {name}, device count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    global SMI
    SMI = smi
    return name, smi


KERNELS = {"sqexp_fused": "B3/B4", "sqexp_entries": "B5/B7",
           "sqexp_stored": "B6/B8", "issue_probe": "P1",
           "sqexp_ablate": "P2"}  # and B1, B2 and P3, one library per variant below
# B1's libraries, (P, unit mass), those its checks and times use: unit mass
# at every P, diagonal mass at P = 32 (check 3c)
B1_BUILD = ((1, True), (2, True), (3, True), (10, True), (32, True), (32, False), (64, True),
            (65, True))  # P = 65: the wide library, which serves every P > 64
B1_TIME_P = (2, 10, 32, 64)  # P at which B1 is timed beside its bound
B1_WIDE_P = (65, 100, 256)   # P at which B1's wide route is checked and timed
# B2's libraries, by a D each serves among those its checks launch: its
# own library at D = 2 and 5, the wide one (D = 17 and 100)
B2_BUILD_D = (2, 5, 17)
# P3's libraries, one per d: its own data (d = 2) and gp-large-50k-d20's width
P3_D = (2, 20)
# the streamed P3 kernel (d above words.D_RESIDENT), checked at a small n
P3_STREAMED_D, P3_STREAMED_N = 1000, 512


def _b1_label(P, unit):
    if P > hmc_fused.P_NARROW:
        return "B1 wide (any P > 64, either mass)"
    return f"B1 P={P} {'unit' if unit else 'diagonal'} mass"


def _libraries():
    """(name, defines, label) of every library this script runs: one per
    kernel, and one per parameter count and kind of mass of B1."""
    b1 = [("hmc_fused", hmc_fused.kernel_variant(P, unit), _b1_label(P, unit))
          for P, unit in B1_BUILD]
    b2 = [("sqexp", pairwise.kernel_variant(d), _b2_label(d)) for d in B2_BUILD_D]
    p3 = [("sqexp_words_mma", words.kernel_variant(d), f"P3 d={d}")
          for d in P3_D + (P3_STREAMED_D,)]
    return b1 + b2 + p3 + [(name, (), label) for name, label in KERNELS.items()]


def _b2_label(d):
    (_, lib_d), = pairwise.kernel_variant(d)
    return f"B2 D={d}" if lib_d else f"B2 wide (D={d})"


def _timed_build(name, defines):
    cached = _build.library_path(name, defines).exists()
    t0 = time.perf_counter()
    _build.load(name, defines)
    return cached, time.perf_counter() - t0


def phase_build():
    """Build every library, one nvcc process each, all started together."""
    t0 = time.perf_counter()
    libs = _libraries()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = [pool.submit(_timed_build, name, defines) for name, defines, _ in libs]
        results = [f.result() for f in futures]
    for (name, defines, label), (cached, seconds) in zip(libs, results):
        print(f"[build] kernel {label} {'loaded from cache' if cached else 'built'} "
              f"in {seconds:.2f} s: {_build.library_path(name, defines).name}")
        for line in _build.build_log(name, defines).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"[build] {line.strip()}")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")
    _print_fp64_mix()
    _print_fused_local_memory()
    _print_wide_mix()
    _print_b1_local_memory()


@functools.lru_cache(maxsize=None)
def _sass(name, defines=()):
    """The SASS of ``name``'s library (in the variant ``defines``) by
    cuobjdump, or None without it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(_build.library_path(name, defines))],
                          capture_output=True, text=True, timeout=120).stdout


def _print_fp64_mix():
    """The FP64 instruction mix of B5's d = 2 kernel per entry (its unrolled
    body writes 8 entries), from cuobjdump where the toolkit has it: the
    basis of EXP_FLOPS."""
    sass = _sass("sqexp_entries")
    if sass is None:
        print("[build] cuobjdump not found; FP64 instruction mix not read")
        return
    body = sass.split("sqexp_entries_kernelIdLi2EE")[1].split("Function :")[0]
    mix = {op: len(re.findall(rf"\b{op}\b", body)) / 8 for op in ("DFMA", "DADD", "DMUL")}
    print(f"[build] B5 (d = 2) SASS, FP64 instructions per entry: {mix}")


def _random_state(P, K, seed, inv_temp):
    """A mid-adaptation state of K chains on a P-dim Gaussian form, so one
    transition exercises the adaptation's grow and adjust branches."""
    rng = np.random.default_rng(seed)
    if P == N_DIM:
        cov = make_cov()
    else:
        B = rng.normal(size=(P, P)) / np.sqrt(P)
        cov = B @ B.T + np.eye(P)
    form = GaussianForm(torch.as_tensor(np.linalg.inv(cov))).cuda()
    theta = torch.as_tensor(
        rng.multivariate_normal(np.zeros(P), cov, K).T.copy(), dtype=torch.float32
    ).cuda()
    num = rng.integers(0, 20, K)
    cuda = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt).cuda()
    eps = AdaptiveScale(
        value=cuda(rng.uniform(0.1, 0.3, K)),
        avg=cuda(num * rng.uniform(0.4, 0.9, K)),
        var=cuda(num * 0.2),
        num=cuda(num, torch.int32),
        chk_int=cuda(rng.choice([15, 20], K), torch.int32),
    )
    logp = form.value_cols(theta) * inv_temp
    return form, theta, logp.contiguous(), eps, torch.full((K,), inv_temp).cuda()


def _close(a, b):
    return torch.isclose(a, b.to(a.dtype), rtol=RTOL, atol=ATOL)


def _agreement(kernel, plain):
    """Per-chain agreement of two one-transition results: position, logp
    and step size within RTOL/ATOL, adaptation counters equal. Returns
    (share of chains that agree, max abs position error over those)."""
    (t1, lp1, e1, _), (t2, lp2, e2, _) = kernel, plain
    ok = _close(t1, t2).all(dim=0) & _close(lp1, lp2) & _close(e1.value, e2.value)
    ok &= (e1.num == e2.num) & (e1.chk_int == e2.chk_int)
    err = (t1 - t2).abs().amax(dim=0)
    share = float(ok.float().mean())
    max_err = float(err[ok].max()) if bool(ok.any()) else float("inf")
    return share, max_err


def _history_drift(h1, h2):
    """Share of chains whose stored positions still agree after 1, 8, 16,
    32 and all transitions of a chunk."""
    n = h1[0].shape[0]
    return {
        c: float(_close(h1[0][c - 1], h2[0][c - 1]).all(dim=0).float().mean())
        for c in sorted({1, 8, 16, 32, n})
        if c <= n
    }


def _compare(label, P, K, chunk, store, inv_temp, inv_mass, seed):
    """Kernel B1 against its plain version on the same state and draws.

    With one transition, every chain must agree (>= MIN_AGREE of them).
    Over a stored chunk, float32 roundoff makes single chains drift apart
    (a step size one ulp off moves a 50-step trajectory by ~n*omega*ulp,
    and the drift adds up over transitions), so the chunk is held to: the
    first transition and every transition's step count agree per chain,
    the accept fraction of every transition agrees to 1e-3, and the
    kernel drifts from the plain version no further than the plain
    version in float32 drifts from itself in float64."""
    form, theta, logp, eps, it = _random_state(P, K, seed, inv_temp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    z = torch.randn((chunk, P, K), generator=gen, device="cuda")
    us = torch.rand((chunk, K), generator=gen, device="cuda")
    ua = torch.rand((chunk, K), generator=gen, device="cuda")
    im = None if inv_mass is None else torch.as_tensor(inv_mass, dtype=torch.float32).cuda()
    kw = dict(form=form, steps=HMC_STEPS, inv_mass_diag=im, store=store)
    args = (theta, logp, eps, it, z, us, ua)
    padded = hmc_fused.wide_form(form, im) if P > hmc_fused.P_NARROW else None
    kernel = hmc_fused._launch_chunk(*args, **kw, padded=padded)
    plain = hmc_fused._reference_chunk(*args, **kw)
    torch.cuda.synchronize()
    where = f"[check {label}] P={P} K={K} chunk={chunk}"
    if not store:
        share, max_err = _agreement(kernel, plain)
        print(f"{where}: {share:.6f} of chains agree (disagree: {1 - share:.6f}), "
              f"max abs err on those {max_err:.3e}")
        if share < MIN_AGREE:
            raise RuntimeError(f"check {label}: only {share:.6f} of chains agree")
        return max_err

    hk, hp = kernel[3], plain[3]
    first = (_close(hk[0][0], hp[0][0]).all(dim=0) & _close(hk[1][0], hp[1][0])
             & _close(hk[3][0], hp[3][0]) & (hk[2] == hp[2]).all(dim=0))
    share = float(first.float().mean())
    print(f"{where}: {share:.6f} of chains agree on the first transition and on "
          f"every transition's step count (disagree: {1 - share:.6f})")
    if share < MIN_AGREE:
        raise RuntimeError(f"check {label}: only {share:.6f} of chains agree")

    accepted = lambda h, t0: (h[0] != torch.cat([t0[None], h[0][:-1]])).any(dim=1)
    fk = accepted(hk, theta).float().mean(dim=1)
    fp = accepted(hp, theta).float().mean(dim=1)
    worst = float((fk - fp).abs().max())
    print(f"{where}: accept fraction per transition: kernel mean "
          f"{float(fk.mean()):.4f}, plain mean {float(fp.mean()):.4f}, "
          f"max difference {worst:.2e}")
    if worst > 1e-3:
        raise RuntimeError(f"check {label}: accept fractions differ by {worst}")

    f64 = lambda x: x.double() if x.is_floating_point() else x
    form64 = GaussianForm(form.A.double()).double().cuda()
    wide = hmc_fused._reference_chunk(
        *(f64(x) for x in (theta, logp)), AdaptiveScale(*map(f64, eps)),
        *(f64(x) for x in (it, z, us, ua)),
        form=form64, steps=HMC_STEPS, inv_mass_diag=im, store=True,
    )
    drift_kp = _history_drift(hk, hp)
    drift_pw = _history_drift(hp, wide[3])
    print(f"{where}: share of chains still within tolerance after n transitions, "
          f"kernel vs plain {drift_kp}; plain float32 vs plain float64 {drift_pw}")
    if drift_kp[chunk] < drift_pw[chunk] - 0.01:
        raise RuntimeError(
            f"check {label}: the kernel drifts further from the plain version "
            f"({drift_kp[chunk]:.4f} agree) than float32 roundoff explains "
            f"({drift_pw[chunk]:.4f})"
        )


def _time_chunk(P, plain, K=N_CHAINS, reps=None, turns=2, shared=0):
    """CUDA-event times of one 64-transition chunk of K chains with P
    parameters, unit mass, without history: the kernel in ``turns`` turns
    (with the plain version on the same inputs between them, if
    ``plain``). Returns (kernel ms, plain ms or None, bound ms, bound by,
    the step-count draws), each time the lowest of its turns. On the wide
    route the plan's padded form is made once, as a plan holds it. With
    ``shared`` = C, each block of C neighbouring chains takes its first
    chain's step-count draws, so all its chains take each transition's
    steps together."""
    form, theta, logp, eps, it = _random_state(P, K, 7, 1.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    z = torch.randn((64, P, K), generator=gen, device="cuda")
    us = torch.rand((64, K), generator=gen, device="cuda")
    ua = torch.rand((64, K), generator=gen, device="cuda")
    if shared:
        us = us[:, torch.arange(K, device="cuda") // shared * shared].contiguous()
    kw = dict(form=form, steps=HMC_STEPS, inv_mass_diag=None, store=False)
    padded = hmc_fused.wide_form(form) if P > hmc_fused.P_NARROW else None
    args = (theta, logp, eps, it, z, us, ua)
    reps = reps or (10 if P <= 32 else 3)
    times = []
    for _ in range(turns):
        p_ms = time_events(lambda: hmc_fused._reference_chunk(*args, **kw), (), 1) if plain else None
        times.append((time_events(lambda: hmc_fused._launch_chunk(*args, **kw, padded=padded),
                                  (), reps), p_ms))
    bound_ms, bound_by = _b1_bound(us, P)
    ms = min(t for t, _ in times)
    p_ms = min(p for _, p in times) if plain else None
    print(f"[time] B1 one chunk (64 transitions, K={K}, P={P}"
          + (f", step draws shared by blocks of {shared}" if shared else "") + "): kernel "
          + " / ".join(f"{t:.4f}" for t, _ in times) + " ms"
          + (", plain version " + " / ".join(f"{p:.3f}" for _, p in times)
             + " ms (plain, kernel, ...)" if plain else "")
          + f"; bound {bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.2f}x")
    return ms, p_ms, bound_ms, bound_by, us


def _b1_step_flops(P, unit=True):
    """The flops of one leapfrog step: a drift of 2P (3P with diagonal
    mass, its velocity a multiply more), a centring of P, and a kick of a
    matvec (2P^2) and 2P."""
    return 2 * P * P + (5 if unit else 6) * P


def _step_counts(us, steps=HMC_STEPS):
    """Each chain's leapfrog steps per transition from its draws, the
    kernel's own rule."""
    n = (steps * (1.0 + (us.double() - 0.5) * 0.2)).to(torch.int64)
    return n.clamp(min=1, max=max(int(steps * 1.1), 1))


def _b1_bound(us, P=N_DIM, steps=HMC_STEPS, unit=True):
    """Kernel B1's bound for one chunk with these step-count draws: the
    flops the transition needs, not the kernel's. Per transition: the
    jittered step count n (the kernel's own rule) of ``_b1_step_flops``;
    a centring and a half kick (2P^2 + 3P); the two kinetic sums, 2P each
    (3P with diagonal mass, which also scales the momentum draw, P); the
    quadratic form from the last kick's matvec, 2P; and some 30 flops of
    energies and adaptation. Bytes: the normals and uniforms read once,
    the state read and written once."""
    chunk, K = us.shape
    n = _step_counts(us, steps)
    per_transition = 2 * P * P + (9 if unit else 12) * P + 30
    flops = float(n.sum()) * _b1_step_flops(P, unit) + chunk * K * per_transition
    n_bytes = 4 * chunk * K * (P + 2) + 2 * 4 * K * (P + 7)
    return bound(n_bytes, flops, FP32_FLOPS)


def phase_main_path():
    cov = make_cov()
    form = GaussianForm(torch.as_tensor(np.linalg.inv(cov)))
    starts = np.random.default_rng(0).normal(0, 0.1, size=(N_CHAINS, N_DIM))
    hmc_fused.KERNEL_LAUNCHES = 0
    ca = ChainArray(
        "hmc", form, starts, steps=HMC_STEPS, epsilon=0.25, retry=False,
        fused=True, device="cuda", seed=1,
    )
    ca.advance(64, store=False)
    t0 = time.perf_counter()
    ca.advance(640, store=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ca.advance(32, store=True)
    # R-hat of 32 consecutive transitions is biased upward by their
    # autocorrelation, so the mixing checks read a thinned window
    ca.advance(320, store=True, thin=10)
    launches = hmc_fused.KERNEL_LAUNCHES  # before the profiled advance, which adds 10

    theta = ca._history[0]
    accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
    attempts = N_CHAINS * 640 / seconds
    var = ca.get_sample().var(axis=0)
    rel = np.abs(var / np.diag(cov) - 1.0)
    rhat = ca.rhat(burn=32)
    print(f"[main path] fused=True, K={N_CHAINS}: advance(640) in {seconds:.4f} s, "
          f"{attempts:,.0f} attempts/s, acceptance {accept:.4f}, "
          f"{attempts * accept:,.0f} accepted samples/s")
    print(f"[main path] kernel launches {launches}, sample variance within "
          f"{rel.max():.4f} of the target's (relative), max rhat {rhat.max():.5f}")
    if launches == 0:
        raise RuntimeError("the main path launched kernel B1 no time")
    if not np.isfinite(theta).all() or theta.shape != (32, N_CHAINS, N_DIM):
        raise RuntimeError(f"bad history: shape {theta.shape}")
    if rel.max() > 0.10:
        raise RuntimeError(f"sample variance off by {rel.max():.3f} (limit 0.10)")
    if not rhat.max() < 1.05:
        raise RuntimeError(f"max rhat {rhat.max()} (limit 1.05)")
    _profile_advance(ca)
    return launches, attempts, accept


def _profile_advance(ca):
    """torch.profiler over one more ``advance(640, store=False)``: device
    time by kernel (B1, the normals, the uniforms), the device idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ca.advance(640, store=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[main path profile] advance(640): {wall:.3f} ms wall, {device:.3f} ms of device "
          f"kernels (device idle {100 * (1 - device / wall):.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        ms = e.self_device_time_total / 1e3
        print(f"[main path profile] {ms:10.3f} ms ({100 * ms / wall:5.2f}% of wall)  "
              f"{e.count:4d}x  {e.key[:90]}")


def phase_headline():
    """The port's headline bench (``inference_tpu_torch.bench.headline``):
    ``bench.py``'s chain sweep on the main path's ChainArray (P = 10,
    fused), its JSON line printed as it is. Returns (that line's object,
    {K: attempts/s})."""
    result, attempts = headline.measure("cuda")
    print("[headline] fused=True, P=10, attempts/s by K: "
          + ", ".join(f"{K}: {r:,.0f}" for K, r in attempts.items()))
    print(json.dumps(result))
    if not (np.isfinite(result["value"]) and result["value"] > 0
            and 0.0 < result["acceptance"] < 1.0):
        raise RuntimeError(f"headline bench: bad result {result}")
    return result, attempts


def phase_plain_path():
    form = GaussianForm(torch.as_tensor(np.linalg.inv(make_cov())))
    starts = np.random.default_rng(0).normal(0, 0.1, size=(N_CHAINS, N_DIM))
    ca = ChainArray(
        "hmc", form, starts, steps=HMC_STEPS, epsilon=0.25, retry=False,
        fused=False, device="cuda", seed=1,
    )
    ca.advance(4, store=False)
    t0 = time.perf_counter()
    ca.advance(16, store=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    attempts = N_CHAINS * 16 / seconds
    print(f"[plain path] fused=False, K={N_CHAINS}: advance(16) in {seconds:.4f} s, "
          f"{attempts:,.0f} attempts/s")
    if not np.isfinite(ca.theta).all():
        raise RuntimeError("plain path produced non-finite positions")
    return attempts


# ---------------------------------------------------------------------------
# kernel B1's wide route (P > 64), the dense HMC bench, HamiltonianChain
# ---------------------------------------------------------------------------


# the wide route's earlier design (one warp per chain for every P > 64), one
# chunk at K = 65,536, unit mass: PERF.md section 6 (NVIDIA H100 80GB HBM3,
# 700.00 W), quoted, not re-run
WARP_DESIGN_MS = {65: 272.3725, 100: 409.6335, 256: 2856.1372}


def _wide_plan_text(P, K):
    plan = hmc_fused.wide_plan(P, K)
    if not plan.tiled:
        return f"P={P} K={K}: one warp per chain, {plan.chains} a block"
    a = ("A resident" if plan.stages == 0 else
         f"A streamed, a ring of {plan.stages} stages of {plan.slab} rows")
    return (f"P={P} K={K}: C={plan.chains} chains a block, {plan.threads} threads of 8 x 4 tiles, "
            f"{a}, {plan.smem} bytes of shared memory, {plan.blocks} blocks")


def _wide_losses(us, P, steps=HMC_STEPS):
    """A model from one chunk's step draws, not a reading of the kernel:
    the steps the wide route's blocks take beyond the chains' own in
    lockstep per transition, the tiled kernel's design (sum over blocks and
    transitions of max(n) C over sum n), and had each chain moved to its
    next transition at its own pace, a design not shipped (sum over blocks
    of the largest sum of n + 1 over the chunk, times C, over the chains'
    sum of n + 1). Returns both ratios and the bytes of A the plan reads
    from the L2 (a product of each transition's max(n) + 1 streams all of
    A through a ring; a resident A is read once per block)."""
    chunk, K = us.shape
    plan = hmc_fused.wide_plan(P, K)
    C = plan.chains
    n = _step_counts(us, steps)
    pad = -K % C
    n = torch.nn.functional.pad(n, (0, pad)).reshape(chunk, -1, C)
    lockstep = float(n.amax(dim=2).sum() * C / n.sum())
    own = (n + (n > 0)).sum(dim=0)
    pace = float(own.amax(dim=1).sum() * C / own.sum())
    products = float((n.amax(dim=2) + 1).sum()) if plan.stages else plan.blocks
    return lockstep, pace, products * 4 * plan.rows * plan.depth


def _wide_chain_array(P, K, seed):
    """``ChainArray(fused=True)`` at P parameters and K chains on a random
    Gaussian: 64 transitions, then 64 stored (thinned by 8), timed on the
    host clock, launches counted from 0, sample variances against the
    covariance's diagonal. Returns (attempts/s, launches, worst relative
    variance error, max R-hat)."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(P, P)) / np.sqrt(P)
    cov = B @ B.T + np.eye(P)
    starts = rng.multivariate_normal(np.zeros(P), cov, K)
    hmc_fused.KERNEL_LAUNCHES = 0
    ca = ChainArray("hmc", GaussianForm(torch.as_tensor(np.linalg.inv(cov))), starts,
                    steps=HMC_STEPS, epsilon=0.2, retry=False, fused=True, device="cuda", seed=3)
    t0 = time.perf_counter()
    ca.advance(64, store=False)
    ca.advance(64, store=True, thin=8)
    seconds = time.perf_counter() - t0
    launches = hmc_fused.KERNEL_LAUNCHES
    rel = float(np.abs(ca.get_sample().var(axis=0) / np.diag(cov) - 1.0).max())
    rhat = float(ca.rhat().max())
    rate = K * 128 / seconds
    print(f"[b1 wide] ChainArray(fused=True), P={P}, K={K}: 128 transitions in {seconds:.3f} s "
          f"({rate:,.0f} attempts/s), {launches} launches of B1's wide route, sample "
          f"variances within {rel:.4f} of the covariance's (relative), max rhat {rhat:.5f}")
    if launches == 0:
        raise RuntimeError(f"the P = {P} ChainArray launched B1's wide route no time")
    if rel > 0.10:
        raise RuntimeError(f"P = {P}: sample variance off by {rel:.3f} (limit 0.10)")
    return rate, launches, rel, rhat


def phase_b1_wide():
    """Kernel B1's wide route: its plans, then against its plain version at
    P = 65, 100 and 256 (one transition; at P = 100 also a stored chunk,
    with diagonal mass and tempering), timed at each P at the main path's K
    beside its bound and the warp-per-chain design's time (at P = 100
    beside the plain version too), with the steps its blocks cost beyond
    the chains' own (modelled from the step draws), then
    driven through ``ChainArray(fused=True)`` at P = 100 and 256, 16,384
    chains, its launches counted from 0 and its sample variances held to
    the covariance's. Returns (max abs error of the one-transition checks,
    {P: (ms, plain ms, bound ms, bound by)}, {P: ChainArray results})."""
    for P, K in ((65, 16384), (100, 16384), (256, 16384), (100, 4096),
                 *((P, N_CHAINS) for P in B1_WIDE_P)):
        print(f"[b1 wide] plan {_wide_plan_text(P, K)}")
    _print_b1_wide_mix()
    im = np.random.default_rng(6).uniform(0.5, 2.0, 100)
    errs = [_compare("3g", 65, 16384, 1, False, 1.0, None, 17),
            _compare("3h", 100, 16384, 1, False, 0.5, im, 18),
            _compare("3i", 256, 16384, 1, False, 1.0, None, 19)]
    _compare("3j", 100, 4096, 64, True, 1.0, None, 20)
    times = {}
    for P in B1_WIDE_P:
        ms, p_ms, bound_ms, by, us = _time_chunk(P, plain=P == 100, reps=2)
        lockstep, pace, a_bytes = _wide_losses(us, P)
        C = hmc_fused.wide_plan(P, N_CHAINS).chains
        ms_shared, _, _, _, us_shared = _time_chunk(P, plain=False, reps=2, shared=C)
        per_step = ms / float(_step_counts(us).sum())
        per_step_shared = ms_shared / float(_step_counts(us_shared).sum())
        print(f"[b1 wide] P={P} K={N_CHAINS}: lockstep loss measured: {per_step * 1e6:.4f} ns a "
              f"chain-step with each chain's own draws, {per_step_shared * 1e6:.4f} ns with "
              f"each block's draws shared (no lockstep loss), {per_step / per_step_shared - 1:.4f} "
              f"more time a chain-step")
        print(f"[b1 wide] P={P} K={N_CHAINS}: {ms:.4f} ms, {ms / bound_ms:.2f}x its bound "
              f"{bound_ms:.4f} ms; the warp-per-chain design {WARP_DESIGN_MS[P]} ms (PERF.md, "
              f"quoted, not re-run), {WARP_DESIGN_MS[P] / ms:.2f}x this time; modelled from the "
              f"step draws: steps the blocks take over the chains' own {lockstep:.4f} in lockstep "
              f"per transition (this kernel; sum of max(n) C / sum n), {pace:.4f} had each chain "
              f"moved at its own pace (not shipped); bytes of A the plan reads from the L2 "
              f"{a_bytes / 1e9:.2f} GB over this time, {a_bytes / ms / 1e9:.3f} TB/s (a model, "
              f"not a profiler reading)")
        times[P] = (ms, p_ms, bound_ms, by)
    chains = {P: _wide_chain_array(P, 16384, seed) for P, seed in ((100, 21), (256, 22))}
    return max(errs), times, chains


DENSE_CHAINS = 4096
DENSE_WORK = 1 << 17  # chain-transitions: 32 warm-up and 32 timed transitions at 4,096 chains


def phase_dense_hmc():
    """``inference_tpu_torch.bench.dense_hmc``'s two workloads at 4,096
    chains, 32 transitions each as a warm-up and 32 timed (samples/s,
    TFLOP/s, share of the float32 peak; the bench itself times 512 at this
    count, but the plain path is host-bound, so the rate is the same), then
    32 more stored transitions of each, checked: the Gaussian's pooled variances
    within 10% of its covariance's diagonal; the forward model's posterior,
    Gaussian with covariance (A^T S^-1 A)^-1 computed in FP64 on the host,
    its pooled means within 5 standard errors (of the chains' means) of the
    exact mean and its variances within 10%; R-hat printed for both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for kind, (posterior, inverse_mass) in dense_hmc.workloads("cuda").items():
        row, ca = dense_hmc.run_one(kind, posterior, inverse_mass, DENSE_CHAINS, "cuda",
                                    DENSE_WORK)
        rows[kind] = row
        print(f"[dense {kind}] chains={DENSE_CHAINS}: {row['samples_per_s']:,.1f} samples/s "
              f"(acceptance {row['acceptance']:.4f}, {row['transitions']} transitions in "
              f"{row['seconds']:.3f} s), {row['tflops']:.4f} TFLOP/s, "
              f"{row['fp32_peak_pct']:.4f}% of the float32 peak")
        ca.advance(32, store=True)
        h = np.concatenate(ca._history, axis=0)[dense_hmc.ACCEPT_WINDOW:]  # (32, K, P)
        sample = h.reshape(-1, dense_hmc.P)
        rhat = ca.rhat(burn=dense_hmc.ACCEPT_WINDOW).max()
        if kind == "gaussian":
            _, cov = dense_hmc.correlated_gaussian()
            rel = np.abs(sample.var(axis=0) / np.diag(cov) - 1.0)
            print(f"[dense {kind}] pooled variances within {rel.max():.4f} of the covariance's "
                  f"diagonal (limit 0.10), max rhat {rhat:.5f}")
            if rel.max() > 0.10:
                raise RuntimeError(f"dense gaussian: variance off by {rel.max():.4f}")
        else:
            _, A, y, sigma = dense_hmc.forward_model("cpu")
            precision = A.T @ (A / sigma[:, None] ** 2)
            cov = np.linalg.inv(precision)
            mean = cov @ (A.T @ (y / sigma**2))
            chain_means = h.mean(axis=0)  # (K, P)
            se = chain_means.std(axis=0, ddof=1) / np.sqrt(DENSE_CHAINS)
            z = np.abs(sample.mean(axis=0) - mean) / se
            rel = np.abs(sample.var(axis=0) / np.diag(cov) - 1.0)
            print(f"[dense {kind}] pooled means within {z.max():.3f} standard errors of the exact "
                  f"posterior mean (limit 5), variances within {rel.max():.4f} (limit 0.10), "
                  f"max rhat {rhat:.5f}")
            if z.max() > 5.0 or rel.max() > 0.10:
                raise RuntimeError(f"dense forward model: {z.max():.3f} standard errors, "
                                   f"variance off by {rel.max():.4f}")
        if not np.isfinite(sample).all():
            raise RuntimeError(f"dense {kind}: non-finite samples")
    return rows


HC_STEPS_CARD, HC_STEPS_CPU = 1000, 1000  # the card's 2,000 cut for the script's time
HC_LEAPFROG = 10  # leapfrog steps per proposal (the chain's default is 50)


def _bounded_chain(device, seed, analytic=True):
    """HamiltonianChain on ``bench.py``'s 10-dim Gaussian with the first
    parameter's lower tail cut at half a standard deviation below the mean,
    every other bound 10 standard deviations out; ``HC_LEAPFROG`` leapfrog
    steps per proposal; the form's own gradient -A (t - mu) as ``grad``
    (as ``bench.py``'s reference run passes one), else autograd."""
    cov = make_cov()
    sd = np.sqrt(np.diag(cov))
    lower, upper = -10.0 * sd, 10.0 * sd
    lower[0] = -0.5 * sd[0]
    form = GaussianForm(torch.as_tensor(np.linalg.inv(cov))).to(device)
    grad = (lambda t: -(form.A @ (t - form.mu))) if analytic else None
    chain = HamiltonianChain(form, start=np.full(N_DIM, 0.1), grad=grad,
                             bounds=Bounds(lower, upper), display_progress=False, seed=seed,
                             device=device)
    chain.steps = HC_LEAPFROG
    return chain, lower, upper


def _moments(chain, burn):
    s = chain.get_sample(burn=burn)
    ess = np.array([effective_sample_size(s[:, i]) for i in range(N_DIM)])
    return s, s.mean(axis=0), s.var(axis=0), ess


def phase_hamiltonian():
    """HamiltonianChain on the card: the bounded 10-dim problem advanced
    1,000 steps (transitions/s), every sample inside the bounds; the same
    chain on the CPU for 1,000 steps (transitions/s); their moments after a
    burn-in of 200 held to each other: each mean within 5 joint standard
    errors (sd / sqrt(ESS) of each chain), each variance ratio within 5 x
    sqrt(2/ESS + 2/ESS) of 1; the card chain's device operations over 20
    more transitions counted; then save, load and advance 50 more on the
    card, and 100 steps on the card with the gradient by autograd. Returns
    {run: transitions/s}."""
    rates = {}
    chains = {}
    for device, n in (("cuda", HC_STEPS_CARD), ("cpu", HC_STEPS_CPU)):
        chain, lower, upper = _bounded_chain(device, seed=5)
        chain.advance(10)  # warm-up
        t0 = time.perf_counter()
        chain.advance(n)
        if device == "cuda":
            torch.cuda.synchronize()
        rates[device] = n / (time.perf_counter() - t0)
        chains[device] = chain
        s = chain.get_sample()
        inside = bool(((s >= lower) & (s <= upper)).all())
        print(f"[hamiltonian] {device}: {n} steps at {rates[device]:.2f} transitions/s, "
              f"{chain.chain_length} samples, all inside the bounds: {inside}, mean leapfrog "
              f"steps per transition {np.mean(chain.leapfrog_steps[1:]):.1f}")
        if not inside or not np.isfinite(s).all():
            raise RuntimeError(f"HamiltonianChain on {device}: samples outside the bounds")
    _, m1, v1, e1 = _moments(chains["cuda"], 200)
    _, m2, v2, e2 = _moments(chains["cpu"], 200)
    z = np.abs(m1 - m2) / np.sqrt(v1 / e1 + v2 / e2)
    r = np.abs(v1 / v2 - 1.0) / np.sqrt(2.0 / e1 + 2.0 / e2)
    print(f"[hamiltonian] card vs CPU: means within {z.max():.3f} joint standard errors, variance "
          f"ratios within {r.max():.3f} of theirs (limits 5); ESS card {e1.min()}-{e1.max()}, "
          f"CPU {e2.min()}-{e2.max()}; the cut parameter's mean {m1[0]:.4f} / {m2[0]:.4f}")
    if z.max() > 5.0 or r.max() > 5.0:
        raise RuntimeError("HamiltonianChain: the card's moments disagree with the CPU's")
    _profile_chain(chains["cuda"])
    path = _build.BUILD_DIR.parent / "chip_smoke_hamiltonian.npz"
    chains["cuda"].save(str(path))
    loaded = HamiltonianChain.load(str(path), posterior=chains["cuda"].posterior, device="cuda")
    path.unlink()
    loaded.advance(50)
    if loaded.chain_length != chains["cuda"].chain_length + 50:
        raise RuntimeError("HamiltonianChain: save, load and advance lost steps")
    print(f"[hamiltonian] save, load and advance(50) on the card: chain length "
          f"{loaded.chain_length}")
    chain, _, _ = _bounded_chain("cuda", seed=6, analytic=False)
    chain.advance(10)
    t0 = time.perf_counter()
    chain.advance(100)
    rates["cuda autograd"] = 100 / (time.perf_counter() - t0)
    print(f"[hamiltonian] cuda with the gradient by autograd: 100 steps at "
          f"{rates['cuda autograd']:.2f} transitions/s")
    return rates


def _trace(prof):
    """A profile's device events by name (count, ms) and its host events
    (operators, runtime calls) counted by name, summed from the raw trace:
    ``key_averages`` parses ~0.5 ms an event, 12-25 s for the ~3e4-5e4
    events of a launch-bound path's profile; the raw trace ~5 us an
    event."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ops = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            k = kernels.setdefault(e.name(), [0, 0.0])
            k[0] += 1
            k[1] += (e.end_ns() - e.start_ns()) / 1e6
        else:
            ops[e.name()] = ops.get(e.name(), 0) + 1
    return kernels, ops


def _top_kernels(kernels, n):
    """The ``n`` device events of ``_trace`` with the most device time."""
    return sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n]


def _profile_chain(chain, n=20):
    """torch.profiler over ``advance(n)`` of one chain on the card: device
    operations (kernels and copies) per transition and per leapfrog step,
    the steps of rejected attempts and each attempt's bookkeeping included."""
    done = chain.chain_length
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chain.advance(n)
        torch.cuda.synchronize()
    ops = sum(c for c, _ in _trace(prof)[0].values())
    leapfrog = int(np.sum(chain.leapfrog_steps[done:]))
    print(f"[hamiltonian] torch.profiler over advance({n}) on the card: {ops} device "
          f"operations, {ops / n:.1f} per transition, {ops / leapfrog:.1f} per leapfrog "
          f"step ({leapfrog} steps)")
    if ops == 0:
        raise RuntimeError("HamiltonianChain: the profiler saw no device operation")


# ---------------------------------------------------------------------------
# the Metropolis family and numpy posteriors (no kernel of their own):
# gibbs-10d, gibbs-rosenbrock, a1-numpy
# ---------------------------------------------------------------------------

GIBBS_CHAINS = (1024, 65_536)  # chain_batch_bench.py's default; bench-10d's count
# (warm-up, timed) steps of a gibbs or pca timing run: chain_batch_bench.py's
# warm-up of 128 (the widths adapt in it) cut to 32, its timed 512 cut to 64,
# to fit the script's time; the two halves of the timed window are timed apart
GIBBS_STEPS = (32, 64)
METROPOLIS_STEPS = (128, 512)  # one launch-bound proposal a step: the bench's counts
GIBBS_CHECK = 1024  # chains of the stored correctness runs
GIBBS_PROFILE_SWEEPS = 2  # sweeps of the profiled advance (4, cut: the profiler's processing dominates)
# steps of one chain by device after 200 warm-up steps (the demo's 150,000
# cut to the script's time: 2,000 and 5,000 until the matrix-free GP's rest
# joined the script); the held moments drop the warm-up
ROSEN_STEPS = {"cuda": 1200, "cpu": 3000}
ROSEN_WARM = 200
ROSEN_CHAINS = 1024  # chains of the ChainArray runs on the demo's posterior
A1_CHAINS = 64


def gauss10(t):
    """chain_batch_bench.py's 10-dim correlated Gaussian in torch: d = t -
    roll(t, 1) / 2, logp = -|d|^2 / 2."""
    d = t - 0.5 * torch.roll(t, 1, dims=-1)
    return -0.5 * (d * d).sum(-1)


def gauss10_cov():
    """Its covariance, inv((I - S/2)^T (I - S/2)) with S the cyclic shift."""
    M = np.eye(10) - 0.5 * np.roll(np.eye(10), 1, axis=0)
    return np.linalg.inv(M.T @ M)


def rosen_torch(t):
    """demos/gibbs_chain_demo.py's posterior in torch."""
    x, y = t[0], t[1]
    x2 = x**2
    return -x2 - 15.0 * (y - x2) ** 2 - 0.5 * (x2 + y**2) / 9.0


def rosen_numpy(t):
    """The same posterior written with numpy, as the reference's users write
    theirs: evaluated on the host."""
    x, y = float(t[0]), float(t[1])
    return -x * x - 15.0 * (y - x * x) ** 2 - 0.5 * (x * x + y * y) / 9.0


def rosen_quadrature():
    """Means and variances of x and y under the demo's density by 2D grid
    quadrature in float64 (x on [-6, 6], y on [-8, 40], steps 0.004 and
    0.008: the density is below 1e-30 of its peak at the edges)."""
    x = np.linspace(-6.0, 6.0, 3001)
    y = np.linspace(-8.0, 40.0, 6001)
    X, Y = np.meshgrid(x, y, indexing="ij")
    X2 = X * X
    logp = -X2 - 15.0 * (Y - X2) ** 2 - 0.5 * (X2 + Y * Y) / 9.0
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = np.array([(w * X).sum(), (w * Y).sum()])
    var = np.array([(w * (X - mean[0]) ** 2).sum(), (w * (Y - mean[1]) ** 2).sum()])
    return mean, var


def _timed_advance(ca, warm, timed):
    """``advance(warm)``, then the timed window as two ``advance(timed /
    2)``, all with ``store=False`` (an advance ends in a sync); chain-steps/s
    of the warm-up, of each half and of the window."""
    secs = []
    for n in (warm, timed // 2, timed - timed // 2):
        t0 = time.perf_counter()
        ca.advance(n, store=False)
        secs.append(time.perf_counter() - t0)
    K = ca.n_chains
    return {"warm": K * warm / secs[0], "first_half": K * (timed // 2) / secs[1],
            "second_half": K * (timed - timed // 2) / secs[2], "window": K * timed / sum(secs[1:])}


def _pooled(ca, burn):
    """Pooled means and variances of a ChainArray's stored steps after
    ``burn``, with standard errors from its K independent chains: the spread
    of the chains' own means (and of their variance terms) over sqrt(K),
    so an ESS of K var / var(chain means), with no autocorrelation
    estimate."""
    K, P = ca.n_chains, ca.n_parameters
    h = ca.get_sample(burn=burn).reshape(-1, K, P)
    m_k = h.mean(axis=0)
    mean = m_k.mean(axis=0)
    terms = h.var(axis=0) + (m_k - mean) ** 2
    return (mean, terms.mean(axis=0), m_k.std(axis=0, ddof=1) / np.sqrt(K),
            terms.std(axis=0, ddof=1) / np.sqrt(K))


def _gibbs10_check(label, ca, cov, steps, burn):
    """Advance a ChainArray ``steps`` stored steps and hold it: pooled
    variances within 10% of the covariance's diagonal, rank-normalized
    R-hat < 1.05 (PERF.md section 2), finite positions. Also prints, not
    held, the largest distance of the pooled variances from the diagonal in
    standard errors from the chains' spread (``_pooled``)."""
    ca.advance(steps)
    s = ca.get_sample(burn=burn)
    rel = np.abs(s.var(axis=0) / np.diag(cov) - 1.0)
    _, v, _, se_v = _pooled(ca, burn)
    z = (v - np.diag(cov)) / se_v
    zmax = float(z[np.argmax(np.abs(z))])
    rhat = ca.rhat(burn=burn)
    print(f"[gibbs-10d] {label}: {steps} stored steps, {ca.n_chains} chains, burn {burn}: "
          f"variances within {rel.max():.4f} of the truth (limit 0.10), max R-hat "
          f"{rhat.max():.4f} (limit 1.05); the pooled variance furthest from the truth "
          f"{zmax:+.2f} standard errors of the chains' spread, mean over the parameters "
          f"{z.mean():+.2f} (a reading)")
    if not np.isfinite(s).all() or rel.max() > 0.10 or not rhat.max() < 1.05:
        raise RuntimeError(f"gibbs-10d {label}: the statistical checks failed")
    return {"max_rel_var_err": float(rel.max()), "max_rhat": float(rhat.max()),
            "var_z_max": zmax, "var_z_mean": float(z.mean())}


def _profile_gibbs(ca, sweeps=4):
    """torch.profiler over ``advance(sweeps, store=False)`` of a retry=True
    ChainArray: device idle share, kernel launches per sweep, the host
    reads (one count of acceptances a try, ``aten::_local_scalar_dense``)
    and so the tries per parameter, and the host syncs
    (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ca.advance(sweeps, store=False)
        wall = (time.perf_counter() - t0) * 1e3
    kernels, ops = _trace(prof)
    device = sum(ms for _, ms in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    tries = ops.get("aten::_local_scalar_dense", 0)
    syncs = ops.get("cudaStreamSynchronize", 0) + ops.get("cudaDeviceSynchronize", 0)
    P = ca.n_parameters
    out = {"wall_ms": wall, "device_ms": device, "idle_pct": 100 * (1 - device / wall),
           "launches_per_sweep": launches / sweeps, "tries_per_parameter": tries / (sweeps * P),
           "syncs_per_sweep": syncs / sweeps}
    print(f"[gibbs-10d profile] K={ca.n_chains}, retry=True, advance({sweeps}): {wall:.3f} ms "
          f"wall, {device:.3f} ms of device kernels (device idle {out['idle_pct']:.1f}%); "
          f"{out['launches_per_sweep']:.0f} kernel launches a sweep, "
          f"{out['tries_per_parameter']:.2f} tries a parameter (host reads of the acceptance "
          f"count), {out['syncs_per_sweep']:.0f} host syncs a sweep")
    for name, (n, ms) in _top_kernels(kernels, 5):
        print(f"[gibbs-10d profile] {ms:10.3f} ms ({100 * ms / wall:5.2f}% of wall)  "
              f"{n:6d}x  {name[:80]}")
    if launches == 0 or tries == 0:
        raise RuntimeError("gibbs-10d: the profiler saw no launch or no try")
    return out


def phase_gibbs_10d(device="cuda", chains=GIBBS_CHAINS, check=GIBBS_CHECK):
    """gibbs-10d: ``ChainArray`` on chain_batch_bench.py's 10-dim Gaussian
    (its starts, seed 1, default widths). Chain-steps/s of the gibbs kind at
    each chain count with retry=True and False, of the metropolis (widths
    0.7) and pca kinds with retry=False, after the bench's warm-up
    (``_timed_advance``); stored correctness runs at ``check`` chains from
    widths of 1 (metropolis 0.7; pca: one ``update_directions()`` after the
    warm-up) of gibbs with retry=True and False and of metropolis and pca
    with retry=False; a profile of one advance at the largest count with
    retry=True, after its timed window. Returns the readings."""
    cov = gauss10_cov()
    out = {"rates": {}, "checks": {}}
    for K in chains:
        starts = np.random.default_rng(0).normal(size=(K, 10))
        for kind, retry in (("gibbs", True), ("gibbs", False), ("metropolis", False),
                            ("pca", False)):
            kw = dict(widths=0.7) if kind == "metropolis" else {}
            ca = ChainArray(kind, gauss10, starts, seed=1, retry=retry, device=device, **kw)
            warm, timed = METROPOLIS_STEPS if kind == "metropolis" else GIBBS_STEPS
            r = _timed_advance(ca, warm, timed)
            out["rates"][f"{kind} retry={retry} K={K}"] = r
            print(f"[gibbs-10d] {kind} retry={retry} K={K}: advance({warm}) at {r['warm']:,.0f} "
                  f"chain-steps/s, then advance({timed // 2}) twice at {r['first_half']:,.0f} "
                  f"and {r['second_half']:,.0f}, store=False: {r['window']:,.0f} chain-steps/s "
                  f"({r['window'] * 10:,.0f} parameter updates/s)")
            if not np.isfinite(ca.theta).all():
                raise RuntimeError(f"gibbs-10d {kind}: non-finite positions")
            if retry and K == chains[-1] and torch.device(device).type == "cuda":
                out["profile"] = _profile_gibbs(ca, sweeps=GIBBS_PROFILE_SWEEPS)
            del ca
    starts = np.random.default_rng(0).normal(size=(check, 10))
    for kind, retry, steps, burn in (("gibbs", True, 300, 100), ("gibbs", False, 600, 200),
                                     ("metropolis", False, 3000, 1000), ("pca", False, 400, 150)):
        ca = ChainArray(kind, gauss10, starts, seed=2, retry=retry, device=device,
                        widths=0.7 if kind == "metropolis" else 1.0)
        if kind == "pca":
            ca.advance(burn)
            ca.update_directions()
        out["checks"][f"{kind} retry={retry}"] = _gibbs10_check(
            f"{kind} retry={retry}", ca, cov, steps, burn if kind != "pca" else 2 * burn)
        if device == "cuda" and {t.device.type for t in
                                 torch.utils._pytree.tree_leaves(ca._state)} != {"cuda"}:
            raise RuntimeError(f"gibbs-10d {kind}: state left the card")
    return out


def _inside_box(s):
    """Finite, and inside the quadrature's box (the density there is below
    1e-30 of its peak outside it)."""
    return bool(np.isfinite(s).all() and (np.abs(s[:, 0]) < 6).all()
                and ((s[:, 1] > -8) & (s[:, 1] < 40)).all())


def _rosen_chain(cls, posterior, device, n, seed=0):
    """A chain of ``cls`` from [2, -4] (the demo's start, default widths):
    ``ROSEN_WARM`` warm steps, then a timed ``advance(n)``; (chain, steps/s,
    the samples after the warm-up)."""
    chain = cls(posterior=posterior, start=np.array([2.0, -4.0]), display_progress=False,
                seed=seed, device=device)
    chain.advance(ROSEN_WARM)
    t0 = time.perf_counter()
    chain.advance(n)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    s = chain.get_sample(burn=0)
    if not _inside_box(s):
        raise RuntimeError(f"{cls.__name__} on {device}: samples non-finite or outside the box")
    return chain, rate, s[ROSEN_WARM + 1:]


def _ess(x):
    """ESS of a series by its integrated autocorrelation time 1 + 2 sum_k
    rho_k (the library's ``effective_sample_size`` divides n by sum_k rho_k
    from k = 0, up to twice too many for a slow chain; so tau = 2 n / ess -
    1)."""
    return len(x) / (2.0 * len(x) / effective_sample_size(x) - 1.0)


def _mean_and_se(w):
    """Each column's mean and its standard error sd / sqrt(ESS) (``_ess``)."""
    return w.mean(axis=0), np.array([np.sqrt(w[:, i].var() / _ess(w[:, i]))
                                     for i in range(w.shape[1])])


def _chains_agree(label, s1, s2):
    """Hold two chains that sample the same target to each other: each
    mean, and each variance as the mean of the series (x - mean)^2, within 5
    joint standard errors (sd / sqrt(ESS) of each chain's series, the ESS by
    ``_ess``). Returns the readings."""
    (m1, se_m1), (m2, se_m2) = _mean_and_se(s1), _mean_and_se(s2)
    (v1, se_v1), (v2, se_v2) = _mean_and_se((s1 - m1) ** 2), _mean_and_se((s2 - m2) ** 2)
    z = np.abs(m1 - m2) / np.hypot(se_m1, se_m2)
    r = np.abs(v1 - v2) / np.hypot(se_v1, se_v2)
    print(f"[{label}] means {m1} / {m2}, variances {v1} / {v2}, the means' ESS "
          f"{(v1 / se_m1**2).round(1)} / {(v2 / se_m2**2).round(1)}: means within {z.max():.3f}, "
          f"variances within {r.max():.3f} joint standard errors (limits 5)")
    if z.max() > 5.0 or r.max() > 5.0:
        raise RuntimeError(f"{label}: the two chains' moments disagree")
    return {"z_mean": float(z.max()), "z_var": float(r.max())}


def phase_gibbs_rosenbrock(steps=ROSEN_STEPS, devices=("cuda", "cpu")):
    """gibbs-rosenbrock: the demo's posterior in torch. ``GibbsChain`` and
    ``PcaChain`` from [2, -4] on the card and on the CPU (``_rosen_chain``):
    steps/s of a warm timed advance (``steps`` by device), every sample
    finite and inside the quadrature's box, and each facade's card chain
    held to its CPU chain (``_chains_agree``), the same code with the same
    meaning. Then the gibbs and pca kinds of ``ChainArray`` with the textbook
    update (retry=False) at 1,024 chains on the card around the mode (widths
    0.5, 2,000 stored steps, the first 1,000 dropped; pca re-estimates its
    directions at 1,000), pooled means and variances held within 5 standard
    errors (from the 1,024 independent chains, ``_pooled``) of 2D grid
    quadrature of the density. The facades' distance to the quadrature is
    printed, not held: they run the reference's repeat-until-accept update,
    whose target is not the posterior (gibbs-10d's retry=True run shows its
    bias). Returns the readings and the CPU's GibbsChain samples (the
    longest torch chain)."""
    mean, var = rosen_quadrature()
    print(f"[gibbs-rosenbrock] quadrature: means {mean}, variances {var}")
    out = {}
    cpu_gibbs = None
    for cls in (GibbsChain, PcaChain):
        samples = {}
        for device in devices:
            n = steps[torch.device(device).type]
            _, rate, s = _rosen_chain(cls, rosen_torch, device, n)
            samples[device] = s
            label = f"{cls.__name__} {device}"
            print(f"[gibbs-rosenbrock] {label}: advance({n}) at {rate:,.2f} steps/s; finite and "
                  f"inside the box; means {s.mean(axis=0)}, variances {s.var(axis=0)} (the "
                  f"quadrature's {mean}, {var}: a reading)")
            out[label] = {"steps_per_s": rate}
        out[f"{cls.__name__} card vs CPU"] = _chains_agree(
            f"gibbs-rosenbrock {cls.__name__} {devices[0]} vs {devices[1]}", samples[devices[0]],
            samples[devices[1]])
        if cls is GibbsChain:
            cpu_gibbs = samples[devices[1]]
    starts = np.array([0.0, 0.4]) + np.random.default_rng(5).normal(0, 0.5, (ROSEN_CHAINS, 2))
    for kind in ("gibbs", "pca"):
        ca = ChainArray(kind, rosen_torch, starts, widths=0.5, retry=False, seed=6,
                        device=devices[0])
        t0 = time.perf_counter()
        ca.advance(1000)
        if kind == "pca":
            ca.update_directions()
        ca.advance(1000)
        rate = ROSEN_CHAINS * 2000 / (time.perf_counter() - t0)
        m, v, se_m, se_v = _pooled(ca, 1000)
        z_m, z_v = np.abs(m - mean) / se_m, np.abs(v - var) / se_v
        print(f"[gibbs-rosenbrock] ChainArray('{kind}', retry=False), {ROSEN_CHAINS} chains on "
              f"{devices[0]}: {rate:,.0f} chain-steps/s (stored); pooled means {m} (se {se_m}), "
              f"variances {v} (se {se_v}): means within {z_m.max():.3f}, variances within "
              f"{z_v.max():.3f} standard errors of the quadrature (limits 5)")
        if not np.isfinite(ca.get_sample()).all() or z_m.max() > 5.0 or z_v.max() > 5.0:
            raise RuntimeError(f"gibbs-rosenbrock: ChainArray('{kind}') is off the quadrature")
        out[f"ChainArray {kind} retry=False"] = {"chain_steps_per_s": rate,
                                                 "z_mean": float(z_m.max()),
                                                 "z_var": float(z_v.max())}
    return out, cpu_gibbs


def phase_a1_numpy(reference, steps=ROSEN_STEPS["cuda"], device="cuda"):
    """a1-numpy: the demo's posterior written with numpy. ``GibbsChain`` on
    the card (host evaluations, state on the card; another seed): steps/s,
    every sample finite and inside the quadrature's box, its stored
    log-probabilities those of the numpy function at its samples (float32
    rounding), and its moments held to ``reference``, the samples of the
    torch GibbsChain on the CPU, the longest (``_chains_agree``);
    ``HamiltonianChain`` with
    the forward-difference gradient, 200 transitions of 10 leapfrog steps,
    finite and inside the box; ``ChainArray("gibbs")`` at 64 chains (64 host
    calls a proposal), 200 steps with retry=False, its log-probabilities
    those of the numpy function."""
    out = {}
    chain, rate, s = _rosen_chain(GibbsChain, rosen_numpy, device, steps, seed=1)
    if not chain._logp.host or {t.device.type for t in torch.utils._pytree.tree_leaves(
            chain._state)} != {torch.device(device).type}:
        raise RuntimeError("a1-numpy: the numpy GibbsChain is not on the host route with its "
                           "state on the card")
    everything = chain.get_sample(burn=0)
    lp = np.array([rosen_numpy(t) for t in everything])
    err = float(np.abs(chain.get_probabilities(burn=0) - lp).max() / max(1.0, np.abs(lp).max()))
    print(f"[a1-numpy] GibbsChain {device} (host evaluations): advance({steps}) at {rate:,.2f} "
          f"steps/s; finite and inside the box; log-probabilities within {err:.3e} of the numpy "
          f"function's (relative to max(1, |logp|))")
    if err > 1e-5:
        raise RuntimeError("a1-numpy: the numpy GibbsChain's log-probabilities are off")
    agree = _chains_agree(f"a1-numpy GibbsChain numpy on {device} vs torch on the CPU", s,
                          reference)
    out[f"GibbsChain {device}"] = {"steps_per_s": rate, "logp_err": err, **agree}

    hmc = HamiltonianChain(rosen_numpy, start=np.array([0.5, 0.5]), display_progress=False,
                           seed=0, device=device)
    hmc.steps = 10
    t0 = time.perf_counter()
    hmc.advance(200)
    hmc_rate = 200 / (time.perf_counter() - t0)
    s = hmc.get_sample(burn=0)
    inside = _inside_box(s)
    print(f"[a1-numpy] HamiltonianChain {device}, forward-difference gradient: 200 transitions at "
          f"{hmc_rate:.2f} transitions/s, means {s[50:].mean(axis=0)}, finite and inside the "
          f"box: {inside}")
    if not inside:
        raise RuntimeError("a1-numpy: HamiltonianChain samples non-finite or outside the box")
    out[f"HamiltonianChain {device}"] = {"transitions_per_s": hmc_rate}

    starts = np.array([0.0, 0.5]) + np.random.default_rng(3).normal(0, 0.3, (A1_CHAINS, 2))
    ca = ChainArray("gibbs", rosen_numpy, starts, retry=False, seed=4, device=device)
    ca.advance(20, store=False)
    t0 = time.perf_counter()
    ca.advance(200)
    ca_rate = A1_CHAINS * 200 / (time.perf_counter() - t0)
    lp = np.array([rosen_numpy(t) for t in ca.theta])
    err = float(np.abs(ca.logp - lp).max())
    print(f"[a1-numpy] ChainArray('gibbs') {device}, {A1_CHAINS} chains: {ca_rate:,.1f} "
          f"chain-steps/s; log-probabilities within {err:.3e} of the numpy function's")
    if not np.isfinite(ca.get_sample()).all() or err > 1e-3 * max(1.0, np.abs(lp).max()):
        raise RuntimeError("a1-numpy: ChainArray('gibbs') on a numpy posterior is off")
    out[f"ChainArray gibbs {device}"] = {"chain_steps_per_s": ca_rate, "logp_err": err}
    return out


# ---------------------------------------------------------------------------
# parallel tempering (A13(a)) and the ensemble sampler (A12's first half)
# ---------------------------------------------------------------------------

PT_TEMPS = [2.0**k for k in range(8)]  # tempering_bench.py: 8 rungs, T = 1-128
PT_STEPS = 2000                        # tempering_bench.py's default n_steps
PT_TIMED_STEPS = 1000  # pt-bimodal-8's timed advance (the bench's 2,000, cut to fit the script's time)
PT_SWAP_INTERVAL = 10
PT_TWIN_TRIALS = 64
PT_PROFILE_STEPS = 20  # the profiler's processing of ~500 launches a step dominates
PT_HMC_LEAPFROG = 10   # pt-hmc-2's leapfrog steps a proposal (the chains' default 50, cut)
DEMO_TEMPS = [1.0, 3.0, 10.0, 30.0, 100.0, 300.0]  # demos/parallel_tempering_demo.py
DEMO_MINUTES = 0.1                     # the demo's run_for(minutes=0.5), cut
ENS_WALKERS, ENS_DIM, ENS_ITERS = 4096, 10, 100  # ensemble_bench.py's defaults
ENS_CHECK_ITERS, ENS_CHECK_BURN = 1000, 500
ENS_RETRY_ITERS, ENS_RETRY_BURN = 200, 100
ENS_VAR_RTOL = 0.05  # retry=False variances vs the truth (CPU rehearsal: within 0.010)
ENS_CHAINS, ENS_CHAIN_WALKERS = 256, 32


def bimodal_bench(t):
    """benchmarks/tempering_bench.py's posterior in torch: modes at -4 and
    4, sigma 0.5, weights 2:1."""
    x = t[0]
    return torch.logaddexp(-0.5 * ((x + 4.0) / 0.5) ** 2,
                           -0.5 * ((x - 4.0) / 0.5) ** 2 + np.log(0.5))


def demo_posterior(t):
    """demos/parallel_tempering_demo.py's posterior in torch: modes at -5
    and 5, sigma 0.6, weights 2:1."""
    x = t[0]
    return torch.logaddexp(-0.5 * ((x + 5.0) / 0.6) ** 2,
                           -0.5 * ((x - 5.0) / 0.6) ** 2 + np.log(0.5))


def curved(t):
    """tests/mcmc/test_parallel.py:98-116's posterior."""
    return -0.5 * (t[0] ** 2 + (t[1] - t[0] ** 2) ** 2)


def _fused_chunks(cycles):
    """The chunks of cycles a fused advance of ``cycles`` cycles runs
    (powers of two, at most 512 each): one host read each."""
    n = 0
    while cycles > 0:
        cycles -= min(1 << (cycles.bit_length() - 1), 512)
        n += 1
    return n


def _count_syncs(pt, run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing operations (host reads and blocking copies) the port's
    ladder code makes outside its transitions, by source line, those its
    transitions make (the retry loops' reads, ROADMAP D2), and those torch
    reports from its own files (``outside``)."""
    counts = {"ladder": 0, "steps": 0, "ladder_sites": {}, "outside": 0}
    where = ["ladder"]
    step = pt._vstep

    def counted(*args, **kw):
        where[0] = "steps"
        try:
            return step(*args, **kw)
        finally:
            where[0] = "ladder"

    def hook(message, category, filename, lineno, *args, **kw):
        if "synchroniz" not in str(message):
            return
        if "inference_tpu_torch" not in filename:  # torch's own, e.g. setting the mode
            counts["outside"] += 1
            return
        counts[where[0]] += 1
        if where[0] == "ladder":
            site = f"{os.path.basename(filename)}:{lineno}"
            counts["ladder_sites"][site] = counts["ladder_sites"].get(site, 0) + 1

    pt._vstep = counted
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            pt._vstep = step
    return counts


def _profile_run(label, run):
    """torch.profiler over ``run()``: wall and device-kernel ms, the device
    idle share, kernel launches, host reads (``aten::_local_scalar_dense``
    and ``aten::nonzero``) and the top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, ops = _trace(prof)
    device = sum(ms for _, ms in kernels.values())
    out = {"wall_ms": wall, "device_ms": device, "idle_pct": 100 * (1 - device / wall),
           "launches": sum(c for c, _ in kernels.values()),
           "reads": ops.get("aten::_local_scalar_dense", 0) + ops.get("aten::nonzero", 0)}
    print(f"[{label} profile] {wall:.3f} ms wall, {device:.3f} ms of device kernels (device idle "
          f"{out['idle_pct']:.1f}%), {out['launches']} kernel launches, {out['reads']} host "
          f"reads (item, nonzero) (card: {SMI})")
    for name, (n, ms) in _top_kernels(kernels, 5):
        print(f"[{label} profile] {ms:10.3f} ms  {n:6d}x  {name[:80]}")
    if out["launches"] == 0:
        raise RuntimeError(f"{label}: the profiler saw no kernel launch")
    return out


def _ladder(cls, posterior, temps, start, widths=None):
    """A ladder of ``cls`` rungs on the card at ``temps``, rung i seeded i."""
    kw = {} if widths is None else dict(widths=np.array([widths] * len(start)))
    return ParallelTempering([
        cls(posterior, start=np.array(start), temperature=T, display_progress=False,
            seed=i, device="cuda", **kw) for i, T in enumerate(temps)])


def _on_card(state):
    return {t.device.type for t in torch.utils._pytree.tree_leaves(state)} == {"cuda"}


def _swap_twin(pt, trials=PT_TWIN_TRIALS):
    """The card's ``_swap_on_device`` against the host arithmetic of
    ``swap()`` (``_swap_on_host``), from one copy of the ladder's state in
    float64 and the same pairs and uniforms (drawn from a copy of its rng):
    accepted flags and permutation equal, positions equal, logps within
    1e-12 relative. ``trials`` pairings of the same state."""
    state = torch.utils._pytree.tree_map(
        lambda x: x.double() if x.is_floating_point() else x, pt._batched_state)
    theta, logp = state.theta.cpu().numpy(), state.logp.cpu().numpy()
    rng = copy.deepcopy(pt.rng)
    probe = ParallelTempering.__new__(ParallelTempering)
    probe.N_chains, probe.rng = pt.N_chains, rng
    n_acc, err = 0, 0.0
    for _ in range(trials):
        pairs = probe.tight_pairs()
        uniforms = [rng.random() for _ in pairs]
        new, accepted = _swap_on_device(state, torch.tensor(pairs, device="cuda"),
                                        torch.tensor(uniforms, device="cuda"))
        pos, probs, perm, acc_host = _swap_on_host(theta, logp, pt.inv_temps, pairs, uniforms)
        card_perm = np.arange(pt.N_chains)
        for (i, j), ok in zip(pairs, accepted.cpu().tolist()):
            if ok:
                card_perm[[i, j]] = card_perm[[j, i]]
        if accepted.cpu().tolist() != acc_host or not np.array_equal(card_perm, perm) or \
                not np.array_equal(new.theta.cpu().numpy(), pos):
            raise RuntimeError("pt-bimodal-8: the card's swap differs from the host swap")
        err = max(err, float(np.abs(new.logp.cpu().numpy() / probs - 1.0).max()))
        n_acc += sum(acc_host)
    print(f"[pt-bimodal-8] twin: {trials} pairings of one float64 state on the card and on the "
          f"host: accepted flags, permutation and positions equal ({n_acc} of "
          f"{trials * (pt.N_chains // 2)} pairs accepted), logps within {err:.3e} relative "
          f"(limit 1e-12)")
    if err > 1e-12 or n_acc == 0:
        raise RuntimeError("pt-bimodal-8: the twin's logps differ or no pair was accepted")
    return {"max_rel_logp_err": err, "accepted": n_acc, "pairs": trials * (pt.N_chains // 2)}


def phase_pt_bimodal():
    """pt-bimodal-8: benchmarks/tempering_bench.py (its timed steps cut): 8 GibbsChain
    rungs at T = 1-128 on its bimodal posterior from 4 (widths 0.3, seeds
    0-7), swap_interval 10. ``advance(2000)`` counted (the ladder's host
    reads and its transitions'), then a timed ``advance(PT_TIMED_STEPS)``:
    steps/s per rung. Checks: every chain_length 3001, successful <= attempted swaps,
    the cold rung's left-mode share after 500 steps in [0.4, 0.9] (target
    2/3), the state on the card, the ladder's host reads one per chunk of
    cycles; the swap twin (``_swap_twin``); a profile of one
    ``advance(PT_PROFILE_STEPS)``."""
    pt = _ladder(GibbsChain, bimodal_bench, PT_TEMPS, [4.0], widths=0.3)
    if not pt._fusable:
        raise RuntimeError("pt-bimodal-8: the Gibbs ladder did not take the fused path")
    chunks = _fused_chunks(PT_STEPS // PT_SWAP_INTERVAL)
    t0 = time.perf_counter()
    syncs = _count_syncs(pt, lambda: pt.advance(PT_STEPS, swap_interval=PT_SWAP_INTERVAL))
    warm = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.advance(PT_TIMED_STEPS, swap_interval=PT_SWAP_INTERVAL)
    torch.cuda.synchronize()
    rate = PT_TIMED_STEPS / (time.perf_counter() - t0)
    chains = pt.return_chains()
    rates = pt.successful_swaps / pt.attempted_swaps.clip(min=1)
    adjacent = [float(rates[i, i + 1]) for i in range(pt.N_chains - 1)]
    left = float((chains[0].get_sample(burn=500)[:, 0] < 0).mean())
    print(f"[pt-bimodal-8] {pt.N_chains} GibbsChain rungs (T = 1-128): advance({PT_STEPS}) "
          f"counted in {warm:.3f} s, then advance({PT_TIMED_STEPS}) at {rate:,.1f} steps/s per rung ({rate * pt.N_chains:,.0f} "
          f"rung-steps/s) (card: {SMI}); host reads and blocking copies an advance: the ladder "
          f"{syncs['ladder']} ({chunks} chunks of cycles), its transitions {syncs['steps']} "
          f"(the retry loops' reads, {syncs['steps'] / PT_STEPS:.2f} a step; the ladder's at "
          f"{syncs['ladder_sites']}; torch's own {syncs['outside']}); cold rung's "
          f"left-mode share {left:.4f} (target 2/3, band [0.4, 0.9])")
    print(f"[pt-bimodal-8] swap acceptance of adjacent rungs: "
          f"{[round(r, 4) for r in adjacent]}; the matrix (successful / attempted):")
    for row in rates:
        print("[pt-bimodal-8]   " + " ".join(f"{v:6.3f}" for v in row))
    if any(c.chain_length != PT_STEPS + PT_TIMED_STEPS + 1 for c in chains) \
            or (pt.successful_swaps > pt.attempted_swaps).any() or not 0.4 < left < 0.9 \
            or not _on_card(pt._batched_state) or syncs["ladder"] != chunks:
        raise RuntimeError("pt-bimodal-8: lengths, swap counts, left-mode share, the state's "
                           "device or the ladder's host reads are off")
    twin = _swap_twin(pt)
    prof = _profile_run("pt-bimodal-8", lambda: pt.advance(PT_PROFILE_STEPS,
                                                           swap_interval=PT_SWAP_INTERVAL))
    return {"steps_per_s_per_rung": rate, "ladder_reads": syncs["ladder"],
            "step_reads": syncs["steps"], "chunks": chunks, "left_fraction": left,
            "adjacent_swap_rates": adjacent, "twin": twin, "profile": prof}


def phase_pt_demo():
    """pt-demo-6: demos/parallel_tempering_demo.py's posterior and ladder (6
    GibbsChain rungs, T = 1-300, from 5, widths 0.5, seeds 0-5) through
    ``run_for``, its half minute cut to ``DEMO_MINUTES``: steps, the cold
    rung's left-mode share against 2/3 (printed), equal lengths, finite."""
    pt = _ladder(GibbsChain, demo_posterior, DEMO_TEMPS, [5.0], widths=0.5)
    t0 = time.perf_counter()
    pt.run_for(minutes=DEMO_MINUTES, swap_interval=PT_SWAP_INTERVAL)
    seconds = time.perf_counter() - t0
    chains = pt.return_chains()
    s = chains[0].get_sample(burn=100)
    left = float((s[:, 0] < 0).mean())
    n = chains[0].chain_length
    print(f"[pt-demo-6] run_for({DEMO_MINUTES} min): {n - 1} steps a rung in {seconds:.1f} s "
          f"({(n - 1) / seconds:,.1f} steps/s per rung); cold rung's left-mode share {left:.4f} "
          f"(target 2/3, a reading); {int(pt.successful_swaps.sum())} swaps accepted of "
          f"{int(pt.attempted_swaps.sum()) - pt.N_chains} (card: {SMI})")
    if len({c.chain_length for c in chains}) != 1 or not np.isfinite(s).all():
        raise RuntimeError("pt-demo-6: unequal lengths or non-finite samples")
    return {"steps": n - 1, "seconds": seconds, "left_fraction": left}


def phase_pt_hmc():
    """pt-hmc-2: tests/mcmc/test_parallel.py:98-116, two HamiltonianChain
    rungs (T = 1, 5) on the curved posterior from [0.5, 0.5] with
    ``PT_HMC_LEAPFROG`` leapfrog steps, advance(100): lengths 101, the
    rung-batched HMC step, its host reads (the retry loop's, ROADMAP D2)."""
    chains = [HamiltonianChain(curved, start=np.array([0.5, 0.5]), temperature=T,
                               display_progress=False, seed=i, device="cuda")
              for i, T in enumerate([1.0, 5.0])]
    for c in chains:
        c.steps = PT_HMC_LEAPFROG
    pt = ParallelTempering(chains)
    if not pt._fusable:
        raise RuntimeError("pt-hmc-2: the HMC ladder did not take the fused path")
    t0 = time.perf_counter()
    syncs = _count_syncs(pt, lambda: pt.advance(100, swap_interval=PT_SWAP_INTERVAL))
    seconds = time.perf_counter() - t0
    chains = pt.return_chains()
    s = chains[0].get_sample(burn=0)
    print(f"[pt-hmc-2] advance(100) in {seconds:.2f} s ({100 / seconds:.1f} transitions/s per "
          f"rung); host reads and blocking copies: the ladder {syncs['ladder']}, the HMC retry "
          f"loops {syncs['steps']} ({syncs['steps'] / 100:.1f} a transition); "
          f"{int(pt.successful_swaps.sum())} swaps accepted (card: {SMI})")
    if any(c.chain_length != 101 for c in chains) or not np.isfinite(s).all() \
            or not _on_card(chains[1]._state):
        raise RuntimeError("pt-hmc-2: lengths, samples or state off")
    return {"seconds": seconds, "ladder_reads": syncs["ladder"], "step_reads": syncs["steps"]}


def phase_pt_pca():
    """pt-pca-4: four PcaChain rungs (T = 1-8) on gibbs-rosenbrock's
    posterior from [2, -4], advance(600): every rung re-estimates its
    directions at the chain lengths a single PcaChain does (100, 250, 475),
    and the batched state carries them."""
    pt = _ladder(PcaChain, rosen_torch, [1.0, 2.0, 4.0, 8.0], [2.0, -4.0])
    single = PcaChain(rosen_torch, start=np.array([2.0, -4.0]), display_progress=False, seed=0,
                      device="cuda")
    t0 = time.perf_counter()
    pt.advance(600, swap_interval=PT_SWAP_INTERVAL)
    seconds = time.perf_counter() - t0
    single.advance(600)
    chains = pt.return_chains()
    dirs_ok = all(np.allclose(pt._batched_state.directions[k].cpu().numpy(), c.directions,
                              atol=1e-6) for k, c in enumerate(chains))
    print(f"[pt-pca-4] advance(600) in {seconds:.2f} s ({600 / seconds:.1f} steps/s per rung); "
          f"updates at {[c.update_history for c in chains]}, a single PcaChain at "
          f"{single.update_history}; batched directions = the rungs': {dirs_ok} (card: {SMI})")
    if any(c.update_history != single.update_history for c in chains) or not dirs_ok \
            or not single.update_history:
        raise RuntimeError("pt-pca-4: the rungs' direction updates differ from a PcaChain's")
    return {"seconds": seconds, "updates": single.update_history}


def ensemble_problem(n_walkers, seed=0):
    """benchmarks/ensemble_bench.py::make_problem: the 10-dim correlated
    Gaussian (default_rng(42)) and starts N(0, 0.3) from ``seed``."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(ENS_DIM, ENS_DIM)) / np.sqrt(ENS_DIM)
    cov = A @ A.T + np.eye(ENS_DIM)
    starts = np.random.default_rng(seed).normal(0, 0.3, size=(n_walkers, ENS_DIM))
    return cov, starts


def _ensemble_logp(cov):
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device="cuda")
    return lambda t: -0.5 * t @ icov @ t


def phase_ensemble():
    """ensemble-4096: ensemble_bench.py unchanged (4,096 walkers, its 10-dim
    Gaussian, starts N(0, 0.3) seed 0, float32, retry=False, seed 1): the
    facade's walker-updates/s (advance(100) warm-up, then timed) and its
    history fetch, the bare ``run_steps`` loop's (history on the card);
    a profile of 20 facade iterations; then a retry=False run of 1,000
    iterations whose variances (after 500) must be within ``ENS_VAR_RTOL``
    of the truth, and a retry=True run whose shrink ratio is printed."""
    cov, starts = ensemble_problem(ENS_WALKERS)
    logp = _ensemble_logp(cov)
    es = EnsembleSampler(logp, starts, display_progress=False, seed=1, retry=False, device="cuda")
    es.advance(ENS_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es.advance(ENS_ITERS)
    torch.cuda.synchronize()
    facade = ENS_WALKERS * ENS_ITERS / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    sample = es.sample
    fetch = time.perf_counter() - t0
    step = make_ensemble_step(es._logp.batched, n_walkers=ENS_WALKERS, retry=False)
    sd = torch.as_tensor(starts, dtype=torch.float32, device="cuda")
    state = init_ensemble_state(sd[None], es._logp.batched(sd)[None])
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = run_ensemble_steps(step, state, ENS_ITERS, True, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run_ensemble_steps(step, state, ENS_ITERS, True, gen)
    torch.cuda.synchronize()
    bare = ENS_WALKERS * ENS_ITERS / (time.perf_counter() - t0)
    prof = _profile_run("ensemble-4096", lambda: es.advance(20))
    print(f"[ensemble-4096] {ENS_WALKERS} walkers, {ENS_DIM} dims, float32, retry=False: facade "
          f"{facade:,.0f} walker-updates/s, bare run_steps loop {bare:,.0f} (history on the "
          f"card; {ENS_ITERS} iterations timed after as many); history fetch "
          f"{sample.nbytes / 2**20:.0f} MB in {fetch:.3f} s (card: {SMI})")
    out = {"facade_walker_updates_per_s": facade, "bare_walker_updates_per_s": bare,
           "fetch_s": fetch, "profile": prof}
    for retry, n, burn in ((False, ENS_CHECK_ITERS, ENS_CHECK_BURN),
                           (True, ENS_RETRY_ITERS, ENS_RETRY_BURN)):
        es = EnsembleSampler(logp, starts, display_progress=False, seed=2, retry=retry,
                             device="cuda")
        t0 = time.perf_counter()
        es.advance(n)
        seconds = time.perf_counter() - t0
        s = es.get_sample(burn=burn * ENS_WALKERS)
        ratio = np.diag(np.cov(s.T)) / np.diag(cov)
        es._drain_stats()
        proposals = float(np.mean(es.total_proposals))
        print(f"[ensemble-4096] retry={retry}: {n} iterations in {seconds:.2f} s, "
              f"{proposals:.2f} proposals a walker-update; variances / truth after {burn}: "
              f"{ratio.round(4).tolist()} (mean {ratio.mean():.4f}); means "
              f"{np.abs(s.mean(0)).max():.4f} from 0 at most")
        out[f"retry={retry}"] = {"seconds": seconds, "var_ratio_min": float(ratio.min()),
                                 "var_ratio_max": float(ratio.max()),
                                 "var_ratio_mean": float(ratio.mean()),
                                 "proposals_per_update": proposals}
        if not np.isfinite(s).all() or not _on_card(es._state):
            raise RuntimeError(f"ensemble-4096 retry={retry}: non-finite or off the card")
        if not retry and np.abs(ratio - 1.0).max() > ENS_VAR_RTOL:
            raise RuntimeError("ensemble-4096: retry=False variances off the truth")
    return out


def phase_ensemble_chains():
    """ensemble-chains: ``ChainArray("ensemble")`` on the same Gaussian, 256
    chains of 32 walkers (starts N(0, 0.3), seed 3), retry=False:
    advance(100) warm-up, a timed stored advance(300), walker-updates/s,
    R-hat (every walker a replicate chain) and ESS after 100."""
    cov, starts = ensemble_problem(ENS_CHAINS * ENS_CHAIN_WALKERS, seed=3)
    ca = ChainArray("ensemble", _ensemble_logp(cov),
                    starts.reshape(ENS_CHAINS, ENS_CHAIN_WALKERS, ENS_DIM), retry=False, seed=4,
                    device="cuda")
    ca.advance(100, store=False)
    t0 = time.perf_counter()
    ca.advance(300)
    rate = ENS_CHAINS * ENS_CHAIN_WALKERS * 300 / (time.perf_counter() - t0)
    rhat = ca.rhat(burn=100)
    ess = ca.effective_sample_size(burn=100)
    var = ca.get_sample(burn=100).var(axis=0) / np.diag(cov)
    print(f"[ensemble-chains] {ENS_CHAINS} chains x {ENS_CHAIN_WALKERS} walkers: {rate:,.0f} "
          f"walker-updates/s (stored); R-hat max {rhat.max():.4f}, ESS per walker and parameter "
          f"mean {ess.mean():.1f} of 200, variances / truth {var.min():.3f}-{var.max():.3f} "
          f"(card: {SMI})")
    if not np.isfinite(ca.theta).all() or ess.shape != (ENS_CHAINS, ENS_CHAIN_WALKERS, ENS_DIM) \
            or not _on_card(ca._state):
        raise RuntimeError("ensemble-chains: non-finite, wrong ESS shape or off the card")
    return {"walker_updates_per_s": rate, "rhat_max": float(rhat.max()),
            "ess_mean": float(ess.mean()), "var_ratio_min": float(var.min()),
            "var_ratio_max": float(var.max())}


# ---------------------------------------------------------------------------
# NUTS (ROADMAP A12's second half) and the 1D density estimators (A14(a))
# ---------------------------------------------------------------------------

# nuts_bench.py's chain counts, each with its timed transitions: the
# bench's max(32, 2^21 // chains), 512 / 128 / 32, cut to fit the script's
# time; the hmc beside (~90 ms a transition) at the first count only
NUTS_TIERS = {4096: 64, 16384: 32, 65536: 32}
NUTS_HMC_TIER = 4096
# warm-up transitions: nuts to its adapted step size (a CPU rehearsal at
# 4,096 chains: epsilon 0.25 -> 0.78 and the batch's leaves a transition
# ~70 -> ~12 by the 72nd transition), hmc (whose transitions cost 50
# leapfrog steps at any step size) 8; the bench warms each for its timed
# count. The stored run: the bench's 64 cut to 32
NUTS_WARM, NUTS_HMC_WARM, NUTS_STORED = 72, 8, 32
NUTS_ROUTE_CALLS = 200  # calls a turn of each batched value-and-gradient route timed
NUTS_CHECK_CHAINS = 4096
NUTS_CHECK_BURN, NUTS_CHECK_STEPS = 32, 128
NUTS_READ_STEPS, NUTS_PROFILE_STEPS = 16, 4
NUTS_VAR_RTOL, NUTS_RHAT = 0.10, 1.05
NUTS_TWIN_CHAINS, NUTS_TWIN_STEPS, NUTS_TWIN_RTOL = 64, 5, 1e-12
NUTS_DEMO_STEPS, NUTS_DEMO_BURN = 300, 75  # demos/nuts_demo.py's 6,000 and 1,000, cut
# the bands of the demo's readings at this count: the range of CPU
# rehearsals of the same chain at seeds 0-7 (float32; ``rehearse_nuts_demo``)
# widened by 3 of their standard deviations each way: mean ring radius and
# z-thickness
NUTS_DEMO_RADIUS = (0.991, 1.016)  # rehearsals 0.9993-1.0076 (sd 0.0027)
NUTS_DEMO_THICK = (0.034, 0.058)   # rehearsals 0.0423-0.0501 (sd 0.0026)
PT_NUTS_TEMPS, PT_NUTS_DEPTH, PT_NUTS_STEPS, PT_NUTS_INTERVAL = [1.0, 3.0, 10.0], 5, 120, 5
KDE_SAMPLES, KDE_POINTS, KDE_RTOL = 8192, 10_000, 1e-10
UNIMODAL_OBJ_RTOL, UNIMODAL_MAP_RTOL = 1e-12, 1e-9


class Toroidal:
    """demos/nuts_demo.py's ToroidalGaussian in torch: a ring of radius 1
    and thickness 0.05."""

    coeff = -0.5 / 0.05**2

    def __call__(self, theta):
        r_sqr = theta[2] ** 2 + (torch.sqrt(theta[0] ** 2 + theta[1] ** 2) - 1.0) ** 2
        return self.coeff * r_sqr


def _host_reads(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing operations (host reads, blocking copies) by source line of
    the port's files, and the count torch reports from its own."""
    sites, outside = {}, [0]

    def hook(message, category, filename, lineno, *args, **kw):
        if "synchroniz" not in str(message):
            return
        if "inference_tpu_torch" not in filename:
            outside[0] += 1
            return
        site = f"{os.path.basename(filename)}:{lineno}"
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites, outside[0]


def _rel(a, b):
    """max |a - b| over max |b| (0 when both are 0)."""
    a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype=float) for x in (a, b))
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(np.abs(a - b).max())


def _grad_routes(icov):
    """Host ms a call, ended by a sync, of two batched value-and-gradient
    routes on nuts-10d's posterior at ``NUTS_CHECK_CHAINS`` chains in
    float32: the port's (``common.value_and_grad``: vmap of the values and
    one backward pass of their sum) and ``torch.func.vmap(torch.func
    .grad_and_value(...))``. ``NUTS_ROUTE_CALLS`` calls a turn, two turns
    alternated, the lower kept; the gradients' largest difference."""
    logp = bench_nuts.make_logp(icov, "cuda")
    theta = torch.as_tensor(np.random.default_rng(4).normal(size=(NUTS_CHECK_CHAINS,
                                                                  bench_nuts.N_DIM)),
                            dtype=torch.float32, device="cuda")
    func = torch.func.vmap(torch.func.grad_and_value(logp))
    routes = {"autograd_of_sum": value_and_grad(logp),
              "vmap_grad_and_value": lambda t: func(t)[::-1]}
    ms = {k: [] for k in routes}
    for _ in range(2):
        for k, f in routes.items():
            f(theta)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(NUTS_ROUTE_CALLS):
                f(theta)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3 / NUTS_ROUTE_CALLS)
    diff = float((routes["autograd_of_sum"](theta)[1] - func(theta)[0]).abs().max())
    out = {k: min(v) for k, v in ms.items()}
    print(f"[nuts-10d] a batched value and gradient at {NUTS_CHECK_CHAINS} chains, host ms a "
          f"call (the lower of two turns of {NUTS_ROUTE_CALLS}): the port's autograd of the sum "
          f"{out['autograd_of_sum']:.4f}, vmap(grad_and_value) {out['vmap_grad_and_value']:.4f}; "
          f"turns {ms}; gradients within {diff:.3g} (card: {SMI})")
    return {**out, "max_abs_grad_diff": diff}


def phase_nuts_10d():
    """nuts-10d: ``bench.nuts`` (nuts_bench.py's configuration: the 10-dim
    Gaussian, epsilon 0.25, max_depth 8; hmc beside at 50 leapfrog steps,
    retry=False; float32) at 4,096, 16,384 and 65,536 chains, its JSON line
    a tier: nuts warmed to its adapted step size (``NUTS_WARM``), hmc at
    ``NUTS_HMC_TIER`` only (``NUTS_HMC_WARM``), the timed transitions and the
    stored run cut (``NUTS_TIERS``, ``NUTS_STORED``), the batch's leaves a
    transition of the timed window beside the stored run's. The two
    batched value-and-gradient routes timed (``_grad_routes``). Then a
    ChainArray at 4,096 chains: ``NUTS_CHECK_BURN`` transitions of burn-in,
    the host reads of ``NUTS_READ_STEPS`` more (torch's sync warnings by
    source line: the doubling loop's must stay within max_depth - 1 a
    transition), a stored run of ``NUTS_CHECK_STEPS`` held to the covariance
    (pooled variances within 10% of diag(A A^T + I), rank-normalized R-hat <
    1.05; divergences printed), and a profile of a short advance (launches
    a batch leaf, device idle share). Returns the readings and the stored
    run's pooled sample and log-probabilities, thinned for kde-marginal."""
    icov, rng = bench_nuts.make_problem()
    cov = np.linalg.inv(icov)
    readings = {}
    for n_chains, steps in NUTS_TIERS.items():
        starts = rng.normal(0, 0.1, size=(n_chains, bench_nuts.N_DIM))
        t0 = time.perf_counter()
        row = bench_nuts.measure_tier(n_chains, icov, starts, "cuda", steps, NUTS_WARM,
                                      NUTS_STORED, kinds=("nuts",))
        if n_chains == NUTS_HMC_TIER:
            row["hmc"] = bench_nuts.measure_tier(n_chains, icov, starts, "cuda", steps,
                                                 NUTS_HMC_WARM, NUTS_STORED,
                                                 kinds=("hmc",))["hmc"]
        nuts_row = row["nuts"]
        hmc = (f"hmc {row['hmc']['transitions_per_s']:,.0f} transitions/s, ESS/s "
               f"{row['hmc']['ess_per_s']:,.0f}" if "hmc" in row else "hmc not run at this count")
        print(f"[nuts-10d] {n_chains} chains, {row['steps']} steps timed after {NUTS_WARM}, in "
              f"{time.perf_counter() - t0:.1f} s: nuts {nuts_row['transitions_per_s']:,.0f} "
              f"transitions/s ({nuts_row['timed_batch_leaves_per_transition']:.2f} batch leaves a "
              f"transition; the stored run {nuts_row['batch_leaves_per_transition']:.2f}); "
              f"leapfrog gradients/s of the stored run "
              f"{nuts_row['stored_lane_leapfrog_grads_per_s']:,.0f} "
              f"(lanes' own) / {nuts_row['stored_batch_leapfrog_grads_per_s']:,.0f} (the batch's, "
              f"masked); mean leapfrogs {nuts_row['mean_leapfrogs']:.2f}, mean depth "
              f"{nuts_row['mean_depth']:.3f}, slowest lane {nuts_row['slowest_lane_leapfrogs']:.1f} "
              f"a step; ESS/s nuts {nuts_row['ess_per_s']:,.0f} (at most the draw rate over "
              f"{NUTS_STORED} draws); {hmc}; divergences {nuts_row['divergences']} (card: {SMI})")
        print(json.dumps(row))
        readings[n_chains] = row
    routes = _grad_routes(icov)

    starts = np.random.default_rng(3).normal(0, 0.1, size=(NUTS_CHECK_CHAINS, bench_nuts.N_DIM))
    ca = ChainArray("nuts", bench_nuts.make_logp(icov, "cuda"), starts, epsilon=bench_nuts.EPSILON,
                    max_depth=bench_nuts.MAX_DEPTH, seed=2, device="cuda")
    ca.advance(NUTS_CHECK_BURN, store=False)
    nuts_kernel.COUNTS.update(leaves=0, reads=0)
    sites, outside = _host_reads(lambda: ca.advance(NUTS_READ_STEPS, store=False))
    doubling = nuts_kernel.COUNTS["reads"]
    in_nuts = sum(v for k, v in sites.items() if k.startswith("nuts.py"))
    per_step = in_nuts / NUTS_READ_STEPS
    leaves = nuts_kernel.COUNTS["leaves"] / NUTS_READ_STEPS
    print(f"[nuts-10d] host reads a transition at {NUTS_CHECK_CHAINS} chains: {per_step:.2f} in "
          f"the transition (the doubling loop's {doubling / NUTS_READ_STEPS:.2f}; max_depth "
          f"{bench_nuts.MAX_DEPTH}), {leaves:.1f} batch leaves; by site over {NUTS_READ_STEPS} "
          f"transitions: {sites}; torch's own {outside}")
    if in_nuts > doubling or doubling > (bench_nuts.MAX_DEPTH - 1) * NUTS_READ_STEPS:
        raise RuntimeError("nuts-10d: the transition read the host more than once a doubling")

    t0 = time.perf_counter()
    ca.advance(NUTS_CHECK_STEPS)
    seconds = time.perf_counter() - t0
    s = ca.get_sample()
    var = s.var(axis=0) / np.diag(cov)
    rhat = ca.rhat()
    divergences = int(ca._state.divergences.sum())
    print(f"[nuts-10d] stored run: {NUTS_CHECK_STEPS} transitions of {NUTS_CHECK_CHAINS} chains "
          f"in {seconds:.2f} s after {NUTS_CHECK_BURN + NUTS_READ_STEPS}; pooled variances / "
          f"truth {var.min():.4f}-{var.max():.4f}, R-hat max {rhat.max():.4f}, divergences "
          f"{divergences}")
    if np.abs(var - 1.0).max() > NUTS_VAR_RTOL or rhat.max() >= NUTS_RHAT \
            or not np.isfinite(s).all() or not _on_card(ca._state):
        raise RuntimeError("nuts-10d: variances, R-hat or the state off")
    nuts_kernel.COUNTS["leaves"] = 0
    prof = _profile_run("nuts-10d", lambda: ca.advance(NUTS_PROFILE_STEPS, store=False))
    prof["launches_per_leaf"] = prof["launches"] / max(nuts_kernel.COUNTS["leaves"], 1)
    print(f"[nuts-10d profile] {prof['launches_per_leaf']:.1f} kernel launches a batch leaf "
          f"({nuts_kernel.COUNTS['leaves']} leaves in {NUTS_PROFILE_STEPS} transitions)")
    thin = max(s.shape[0] // KDE_SAMPLES, 1)
    sample = (s[::thin][:KDE_SAMPLES], ca.get_probabilities()[::thin][:KDE_SAMPLES])
    return {"tiers": readings, "grad_routes": routes, "reads_per_transition": per_step,
            "read_sites": sites,
            "leaves_per_transition": leaves, "var_ratio_min": float(var.min()),
            "var_ratio_max": float(var.max()), "rhat_max": float(rhat.max()),
            "divergences": divergences, "stored_s": seconds, "profile": prof}, sample


def phase_nuts_twin():
    """nuts-twin: 64 chains of the nuts-10d Gaussian in float64 on one set
    of injected draws (numpy, seed 8), ``NUTS_TWIN_STEPS`` transitions on
    the card and on the CPU: positions, log-probabilities and cached
    gradients within 1e-12 (max |card - CPU| over max |CPU|), tree depths,
    leapfrog counts and divergence flags equal."""
    icov = bench_nuts.make_problem()[0]
    K, P, D = NUTS_TWIN_CHAINS, bench_nuts.N_DIM, bench_nuts.MAX_DEPTH
    rng = np.random.default_rng(8)
    starts = rng.normal(0, 1, size=(K, P))
    draws = [(rng.normal(size=(K, P)), rng.uniform(size=(K, D)), rng.uniform(size=(K, D)),
              rng.uniform(size=(K, 2**D - 1))) for _ in range(NUTS_TWIN_STEPS)]
    runs = []
    for device in ("cuda", "cpu"):
        A = torch.as_tensor(icov, dtype=F64, device=device)
        logp = lambda t, A=A: -0.5 * t @ A @ t
        init, step = build_kind("nuts", logp, P, F64, device, epsilon=bench_nuts.EPSILON,
                                max_depth=D)
        theta = torch.as_tensor(starts, dtype=F64, device=device)
        with torch.no_grad():
            state, outs = init(theta, torch.func.vmap(logp)(theta)), []
            for d in draws:
                state, out = step(state, None, *(torch.as_tensor(x, dtype=F64, device=device)
                                                 for x in d))
                outs.append(out)
        runs.append((state, outs))
    (sc, oc), (sh, oh) = runs
    errs = {f: _rel(getattr(sc, f), getattr(sh, f)) for f in ("theta", "logp", "grad")}
    errs["outputs"] = max(max(_rel(a.theta, b.theta), _rel(a.logp, b.logp))
                          for a, b in zip(oc, oh))
    equal = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                for a, b in zip(oc, oh) for f in ("tree_depth", "leapfrog_steps", "divergent"))
    depths = torch.stack([o.tree_depth for o in oh]).double()
    print(f"[nuts-twin] {K} chains x {NUTS_TWIN_STEPS} transitions, float64, card vs CPU: "
          f"relative differences {errs}; depths, leapfrog counts and divergence flags equal: "
          f"{equal} (mean depth {float(depths.mean()):.2f}, max {int(depths.max())})")
    if max(errs.values()) > NUTS_TWIN_RTOL or not equal:
        raise RuntimeError("nuts-twin: the card's NUTS transitions differ from the CPU's")
    return {"rel_err": errs, "discrete_equal": equal}


def _nuts_demo_run(device, seed=0):
    """demos/nuts_demo.py's chain cut to ``NUTS_DEMO_STEPS`` transitions:
    one NutsChain on the toroidal posterior from [1, 0.1, 0.1]. Returns the
    chain, its seconds, and the mean ring radius and z-thickness after
    ``NUTS_DEMO_BURN``."""
    chain = NutsChain(Toroidal(), start=np.array([1.0, 0.1, 0.1]), seed=seed,
                      display_progress=False, device=device)
    t0 = time.perf_counter()
    chain.advance(NUTS_DEMO_STEPS)
    seconds = time.perf_counter() - t0
    s = chain.get_sample(burn=NUTS_DEMO_BURN)
    return chain, seconds, float(np.hypot(s[:, 0], s[:, 1]).mean()), float(s[:, 2].std())


def rehearse_nuts_demo(seeds=range(8)):
    """The CPU rehearsals behind ``NUTS_DEMO_RADIUS`` and ``NUTS_DEMO_THICK``:
    ``_nuts_demo_run`` on the CPU in float32 at each seed, each reading
    printed, then the readings' range and standard deviation. Run as
    ``python -c "import chip_smoke; chip_smoke.rehearse_nuts_demo()"``."""
    torch.set_default_dtype(torch.float32)
    runs = np.array([_nuts_demo_run("cpu", seed)[2:] for seed in seeds])
    for seed, (radius, thick) in zip(seeds, runs):
        print(f"[nuts-demo rehearsal] seed {seed}: radius {radius:.4f}, thickness {thick:.4f}")
    for name, x in (("radius", runs[:, 0]), ("thickness", runs[:, 1])):
        print(f"[nuts-demo rehearsal] {name} {x.min():.4f}-{x.max():.4f} (sd {x.std(ddof=1):.4f})")


def phase_nuts_demo():
    """nuts-demo: ``_nuts_demo_run`` on the card, seed 0 (the demo's 6,000
    transitions cut to ``NUTS_DEMO_STEPS``; burn ``NUTS_DEMO_BURN``): the
    mean ring radius and the z-thickness within the CPU rehearsals' bands,
    the mean and largest depth and the divergences printed."""
    chain, seconds, radius, thick = _nuts_demo_run("cuda")
    depths = chain.tree_depths[NUTS_DEMO_BURN:]
    print(f"[nuts-demo] {NUTS_DEMO_STEPS} transitions in {seconds:.1f} s "
          f"({NUTS_DEMO_STEPS / seconds:.1f} transitions/s, "
          f"{np.sum(chain.leapfrog_steps) / seconds:,.0f} leapfrog "
          f"steps/s); mean ring radius {radius:.4f} (true 1.0, band {NUTS_DEMO_RADIUS}), "
          f"z-thickness {thick:.4f} (true 0.05, band {NUTS_DEMO_THICK}); depth mean "
          f"{depths.mean():.2f}, max {depths.max()}; divergences {chain.n_divergences} "
          f"(card: {SMI})")
    if not (NUTS_DEMO_RADIUS[0] < radius < NUTS_DEMO_RADIUS[1]
            and NUTS_DEMO_THICK[0] < thick < NUTS_DEMO_THICK[1]) or not _on_card(chain._state):
        raise RuntimeError("nuts-demo: the ring's radius or thickness is off")
    return {"seconds": seconds, "radius": radius, "thickness": thick,
            "depth_mean": float(depths.mean()), "depth_max": int(depths.max()),
            "divergences": chain.n_divergences}


def _grad_errors(pt):
    """Each rung's cached gradient against inv_temp x the posterior's
    gradient at its position (torch.func on the card): the largest
    |cache - expected| / (1e-5 |expected| + 1e-6), which must stay <= 1."""
    state = pt._batched_state
    with torch.no_grad():
        expected = torch.func.vmap(torch.func.grad(bimodal_bench))(state.theta)
    expected = expected * state.inv_temp[:, None]
    return float(((state.grad - expected).abs() / (1e-5 * expected.abs() + 1e-6)).max())


def phase_pt_nuts():
    """pt-nuts-3: tests/mcmc/test_parallel.py:212-247's ladder on the card:
    3 NutsChain rungs on the bimodal posterior at T = 1, 3, 10, max_depth 5,
    ``advance(120, swap_interval=5)`` through the R-row NUTS step. Checks:
    swaps accepted off the diagonal, each rung's cached gradient = inv_temp
    x grad logp at its position (rtol 1e-5, atol 1e-6) after the fused swaps
    and again after 10 host swap()s, every rung's depths recorded."""
    pt = ParallelTempering([
        NutsChain(bimodal_bench, start=np.array([4.0]), temperature=T, max_depth=PT_NUTS_DEPTH,
                  display_progress=False, seed=3 + i, device="cuda")
        for i, T in enumerate(PT_NUTS_TEMPS)])
    if pt._heterogeneous or pt._run_steps is not nuts_kernel.run_steps:
        raise RuntimeError("pt-nuts-3: the NUTS ladder did not take the R-row NUTS step")
    t0 = time.perf_counter()
    pt.advance(PT_NUTS_STEPS, swap_interval=PT_NUTS_INTERVAL)
    seconds = time.perf_counter() - t0
    off = float(pt.successful_swaps.sum() - np.trace(pt.successful_swaps))
    fused = _grad_errors(pt)
    for _ in range(10):
        pt.swap()
    host = _grad_errors(pt)
    chains = pt.return_chains()
    depths = [float(c.tree_depths[1:].mean()) for c in chains]
    print(f"[pt-nuts-3] advance({PT_NUTS_STEPS}, swap_interval={PT_NUTS_INTERVAL}) in "
          f"{seconds:.2f} s; {off:.0f} swaps accepted off the diagonal; cached gradients' "
          f"error / tolerance after the fused swaps {fused:.3g}, after 10 host swaps {host:.3g}; "
          f"mean depth by rung {[round(d, 3) for d in depths]} (card: {SMI})")
    if off <= 0 or fused > 1.0 or host > 1.0 \
            or any(c.tree_depths.shape != (PT_NUTS_STEPS + 1,) for c in chains):
        raise RuntimeError("pt-nuts-3: no swap, a stale cached gradient or missing depths")
    return {"seconds": seconds, "swaps_off_diagonal": off, "grad_err_fused": fused,
            "grad_err_host": host, "depth_means": depths}


def _chain_items(sample, probs):
    """A NutsChain's checkpoint items holding ``sample`` as its history."""
    n, P = sample.shape
    return {"inv_mass": 1.0, "inv_temp": 1.0, "theta": sample, "probs": probs,
            "leapfrog_steps": np.zeros(n, int), "tree_depths": np.zeros(n, int),
            "divergent": np.zeros(n, bool), "divergences": 0, "n_parameters": P,
            "chain_length": n, "max_depth": bench_nuts.MAX_DEPTH, "display_progress": False,
            **EpsilonSelector(bench_nuts.EPSILON).get_items()}


def phase_kde_marginal(sample, probs):
    """kde-marginal: nuts-10d's stored run (``KDE_SAMPLES`` pooled draws) as
    one chain's history on the card and on the CPU (``NutsChain.from_items``):
    ``get_marginal(0)`` (Silverman) and ``GaussianKDE(cross_validation=True)``
    on the same draws (subsample from one seed), card against CPU: the
    bandwidth, pdf and cdf at ``KDE_POINTS`` points within 1e-10 (max |card
    - CPU| over max |CPU|); ``get_interval()`` and ``sample_hdi_device``
    against ``sample_hdi`` equal; ``get_marginal(0, unimodal=True)``: at the
    CPU's MAP the card's objective within 1e-12 of the CPU's, and the card's
    MAP no worse than the CPU's by 1e-9 of the objective."""
    chains = {label: NutsChain.from_items(_chain_items(sample, probs), device=dev)
              for label, dev in (("card", "cuda"), ("cpu", "cpu"))}
    x = np.linspace(sample[:, 0].min() - 1.0, sample[:, 0].max() + 1.0, KDE_POINTS)
    out, timing = {}, {}
    for label, make in (
        ("silverman", lambda c: c.get_marginal(0)),
        ("cross_validation", lambda c: GaussianKDE(c.get_parameter(0), cross_validation=True,
                                                   rng=np.random.default_rng(0),
                                                   device=c.device)),
    ):
        kdes = {}
        for dev, c in chains.items():
            t0 = time.perf_counter()
            kdes[dev] = make(c)
            pdf, cdf = kdes[dev](x), kdes[dev].cdf(x)
            timing[f"{label} {dev}"] = time.perf_counter() - t0
            kdes[dev] = (kdes[dev], pdf, cdf)
        (kc, pc, cc), (kh, ph, ch) = kdes["card"], kdes["cpu"]
        out[label] = {"h": kc.h, "h_rel": abs(kc.h - kh.h) / kh.h, "pdf_rel": _rel(pc, ph),
                      "cdf_rel": _rel(cc, ch), "mode_card": kc.mode, "mode_cpu": kh.mode}
    s_card, p_card = chains["card"].get_interval()
    s_cpu, p_cpu = chains["cpu"].get_interval()
    interval_equal = np.array_equal(s_card, s_cpu) and np.array_equal(p_card, p_cpu)
    draws = torch.as_tensor(sample, dtype=F64, device="cuda")
    hdi_equal = all(np.array_equal(sample_hdi_device(draws[:, 0], f).cpu().numpy(),
                                   sample_hdi(sample[:, 0], f))
                    and np.array_equal(sample_hdi_device(draws, f).cpu().numpy(),
                                       sample_hdi(sample, f)) for f in (0.2, 0.6827, 0.95))
    unimodal = {}
    for dev, c in chains.items():
        t0 = time.perf_counter()
        unimodal[dev] = c.get_marginal(0, unimodal=True)
        timing[f"unimodal {dev}"] = time.perf_counter() - t0
    uc, uh = unimodal["card"], unimodal["cpu"]
    obj_rel = abs(uc.posterior(uh.MAP) - uh.posterior(uh.MAP)) / abs(uh.posterior(uh.MAP))
    best_card, best_cpu = uc.posterior(uc.MAP), uh.posterior(uh.MAP)
    map_ok = best_card >= best_cpu - UNIMODAL_MAP_RTOL * abs(best_cpu)
    print(f"[kde-marginal] {sample.shape[0]} draws of nuts-10d's stored run, {KDE_POINTS} "
          f"points: {json.dumps(out)}; get_interval() equal: {interval_equal} "
          f"({s_card.shape[0]} kept); sample_hdi_device = sample_hdi: {hdi_equal}")
    print(f"[kde-marginal] UnimodalPdf MAP card {np.round(uc.MAP, 8).tolist()}, CPU "
          f"{np.round(uh.MAP, 8).tolist()}; objective at the CPU's MAP card vs CPU {obj_rel:.3g}; "
          f"log-posterior at each MAP card {best_card:.12g}, CPU {best_cpu:.12g}; seconds "
          f"{ {k: round(v, 3) for k, v in timing.items()} } (card: {SMI})")
    worst = max(max(v["h_rel"], v["pdf_rel"], v["cdf_rel"]) for v in out.values())
    if worst > KDE_RTOL or not interval_equal or not hdi_equal \
            or obj_rel > UNIMODAL_OBJ_RTOL or not map_ok:
        raise RuntimeError("kde-marginal: the card's density estimates differ from the CPU's")
    return {**out, "interval_equal": interval_equal, "hdi_equal": hdi_equal,
            "unimodal_obj_rel": obj_rel, "unimodal_logp_card": best_card,
            "unimodal_logp_cpu": best_cpu, "seconds": timing}


# ---------------------------------------------------------------------------
# kernel B2 and the dense GP path (gp-16k)
# ---------------------------------------------------------------------------

GP_N = 16_384
GP_THETA = np.array([0.0, 0.0, 0.5, 0.5])  # gp_lml_bench.py: ConstantMean, SquaredExponential
GP_REPS = 3
# kernel B2 vs its plain version: the same operations in the same order
# (--fmad=false); only the exp may differ, by a few ulp
B2_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
F64, CUDA = torch.float64, "cuda"


def make_gp_data(n, d=2, seed=0):
    """``benchmarks/gp_lml_bench.py::make_data``: x uniform on [0, 10]^d,
    y = sin x0 cos x1 + N(0, 0.1) noise, y_err = 0.1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, d))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


def _gp_operands(x, dtype, theta=GP_THETA):
    """Rows, amplitude and lengthscales of the squared exponential at
    ``theta`` on the card."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=CUDA)
    return t(x), t(np.exp(theta[1])), t(np.exp(theta[2:]))


def _errors(kernel, plain):
    err = (kernel - plain).abs()
    return float(err.max()), float((err / plain.abs()).max())


def _b2_plan(u, v):
    """Kernel B2's plan for a launch on u and v on this card."""
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    return pairwise.sqexp_plan(u.shape[0], v.shape[0], u.shape[1], u.dtype, sms)


def _b2_compare(label, u, v, amp, ls):
    """Kernel B2 against its plain version on the same inputs; prints the
    library and the store route the launch took."""
    k = pairwise._launch_sqexp(u, v, amp, ls)
    p = pairwise._sqexp_reference(u, v, amp, ls)
    torch.cuda.synchronize()
    if k.shape != p.shape or not bool(torch.isfinite(k).all()):
        raise RuntimeError(f"check {label}: bad output, shape {tuple(k.shape)}")
    max_abs, max_rel = _errors(k, p)
    rtol = B2_RTOL[u.dtype]
    print(f"[check {label}] B2 {str(u.dtype)[6:]} {u.shape[0]}x{v.shape[0]} D={u.shape[1]} "
          f"({_b2_label(u.shape[1])} library, {_b2_plan(u, v).route} stores): max abs err "
          f"{max_abs:.3e}, max rel err {max_rel:.3e} (limit {rtol:g})")
    if not max_rel <= rtol:
        raise RuntimeError(f"check {label}: B2 disagrees with its plain version ({max_rel})")
    return max_abs, max_rel


# (label, dtype, M, N, D) of B2's checks beyond gp-16k's: D = 5 ragged, the
# library of D = 17 and the wide one (D = 100) on the vector route, and an
# odd row pitch (scalar stores) in each dtype
B2_CHECKS = (("6c", F64, 3001, 2500, 5), ("6e", F64, 3001, 2504, 17),
             ("6f", torch.float32, 3001, 2504, 17), ("6g", F64, 2048, 2056, 100),
             ("6h", torch.float32, 2048, 2056, 100), ("6i", F64, 3001, 2501, 2),
             ("6j", torch.float32, 3001, 2501, 2))


def phase_b2_checks(x16k):
    out = {}
    for label, dtype in (("6a", F64), ("6b", torch.float32)):
        u, amp, ls = _gp_operands(x16k, dtype)
        out[dtype] = _b2_compare(label, u, u, amp, ls)
        del u
        torch.cuda.empty_cache()
    rng = np.random.default_rng(6)
    for label, dtype, m, n, d in B2_CHECKS:
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=CUDA)
        u, v = t(rng.uniform(0, 3, (m, d))), t(rng.uniform(0, 3, (n, d)))
        # lengthscales grow with sqrt(D), so the entries stay of order one
        ls = t(rng.uniform(0.5, 2.0, d) * max(1.0, np.sqrt(d / 5)))
        errs = _b2_compare(label, u, v, t(1.3), ls)
        out[dtype] = tuple(max(a, b) for a, b in zip(out[dtype], errs))

    # the autograd.Function's backward against autograd of the plain version
    u, amp, ls = _gp_operands(x16k[:4096], F64)
    kbar = torch.as_tensor(np.random.default_rng(7).normal(size=(4096, 4096)), dtype=F64,
                           device=CUDA)
    grads = []
    for fn in (pairwise.SqexpCovariance.apply, pairwise._sqexp_reference):
        leaves = [a.clone().requires_grad_(True) for a in (u, amp, ls)]
        (fn(leaves[0], leaves[0], leaves[1], leaves[2]) * kbar).sum().backward()
        grads.append([a.grad for a in leaves])
    torch.cuda.synchronize()
    rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)]
    print(f"[check 6d] B2 backward vs autograd of the plain version, N=4096 float64: "
          f"max rel err (positions, amplitude, lengthscales) "
          f"{', '.join(f'{r:.3e}' for r in rels)} (limit 1e-10)")
    if not max(rels) <= 1e-10:
        raise RuntimeError(f"check 6d: the backward disagrees ({rels})")
    return out


def _cdist_exp(u, v, amplitude, lengthscales):
    """The nearest library yardstick of B2: ``torch.cdist`` of the scaled
    rows, then the square, scale, exp and amplitude as in-place passes (no
    single PyTorch call computes the squared exponential)."""
    us, vs = pairwise._scaled(u, v, lengthscales)
    return torch.cdist(us, vs).square_().mul_(-0.5).exp_().mul_(amplitude**2)


def _registers(name, defines, fragment):
    """Registers of the kernel whose name holds ``fragment`` in the build
    log of ``name``'s library in the variant ``defines``."""
    log = _build.build_log(name, defines)
    part = log[log.index(fragment):]
    return int(re.search(r"Used (\d+) registers", part).group(1))


def phase_b2_timing(x16k):
    """CUDA-event times of B2 and its plain version at 16,384 x 16,384, in
    turns (plain, kernel, plain, kernel), beside cdist and the exp and a
    ``fill_`` of an equal tensor (the card's store rate); the SASS of the
    launched kernel's hot loop per entry and its registers. Returns per
    dtype a dict of the kernels JSON line's numbers."""
    times = {}
    for dtype in (F64, torch.float32):
        u, amp, ls = _gp_operands(x16k, dtype)
        args = (u, u, amp, ls)
        plain = [time_events(pairwise._sqexp_reference, args, 3)]
        kern = [time_events(pairwise._launch_sqexp, args, 20)]
        plain.append(time_events(pairwise._sqexp_reference, args, 3))
        kern.append(time_events(pairwise._launch_sqexp, args, 20))
        lib = time_events(_cdist_exp, args, 5)
        filled = torch.empty((u.shape[0], u.shape[0]), dtype=dtype, device=CUDA)
        fill = time_events(lambda: filled.fill_(1.0), (), 20)
        del filled
        m, d = u.shape
        size = u.element_size()
        b_ms, b_by = bound(size * (m * m + 2 * m * d), m * m * (3 * d + 2 + EXP_FLOPS),
                           FP64_FLOPS if dtype == F64 else FP32_FLOPS)
        plan, variant = _b2_plan(u, u), pairwise.kernel_variant(d)
        kernel = f"sqexp_kernel<{'double' if dtype == F64 else 'float'}, {plan.route}>"
        frag = f"sqexp_kernelI{'d' if dtype == F64 else 'f'}Li{pairwise.ROUTES[plan.route]}EE"
        mix = _hot_loop_mix("sqexp", frag, plan.tile_m // 4 * (16 // size), variant,
                            "fp64" if dtype == F64 else "fp32")
        regs = _registers("sqexp", variant, frag)
        sass = "not read" if mix is None else (
            f"{mix['all']:g} ({mix['fp64' if dtype == F64 else 'fp32']:g} "
            f"{'FP64' if dtype == F64 else 'FP32'})")
        print(f"[time] B2 {str(dtype)[6:]} 16384x16384 D=2 ({kernel}, {_b2_label(d)} "
              f"library, {plan.blocks} blocks): kernel {kern[0]:.4f} / {kern[1]:.4f} ms, plain "
              f"version {plain[0]:.4f} / {plain[1]:.4f} ms (plain, kernel, plain, kernel); "
              f"cdist + exp {lib:.4f} ms; fill_ of an equal tensor {fill:.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}), kernel / bound {min(kern) / b_ms:.2f}; SASS "
              f"instructions per entry in the hot loop {sass}; {regs} registers")
        times[dtype] = {"ms": min(kern), "plain_ms": min(plain), "cdist_exp_ms": lib,
                        "bound_ms": b_ms, "bound_by": b_by, "fill_ms": fill, "kernel": kernel,
                        "route": plan.route, "variant": dict(variant), "registers": regs,
                        "sass_per_entry": None if mix is None else mix["all"]}
        del u
        torch.cuda.empty_cache()
    return times


def _plain_gp(x, y, err, theta):
    """The independent plain route: B2's plain version, jitter and noise on
    the diagonal, torch.linalg.cholesky; returns (L, residual, amp, ls)."""
    xs, amp, ls = _gp_operands(x, F64, theta)
    K = pairwise._sqexp_reference(xs, xs, amp, ls)
    K.diagonal().add_(amp**2 * 1e-12)
    K.diagonal().add_(torch.as_tensor(err**2, dtype=F64, device=CUDA))
    L = torch.linalg.cholesky(K)
    r = torch.as_tensor(y, dtype=F64, device=CUDA) - float(theta[0])
    return L, r, amp, ls


def _plain_lml(x, y, err, theta):
    L, r, _, _ = _plain_gp(x, y, err, theta)
    v = torch.linalg.solve_triangular(L, r[:, None], upper=False)[:, 0]
    return float(-0.5 * (v @ v) - torch.log(torch.diagonal(L)).sum())


def _time_lml_grad(gp):
    gp.marginal_likelihood_gradient(GP_THETA)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GP_REPS):
        value, grad = gp.marginal_likelihood_gradient(GP_THETA)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / GP_REPS, value, grad


def phase_gp_main(x, y, err):
    """gp-16k: GpRegressor at N=16,384 in float64 on the card."""
    torch.cuda.reset_peak_memory_stats()
    pairwise.KERNEL_LAUNCHES = 0
    gp = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA)
    seconds, lml, grad = _time_lml_grad(gp)
    launches = pairwise.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[gp main] N={GP_N} float64: {1 / seconds:.4f} LML+grad evals/s "
          f"({seconds * 1e3:.2f} ms each, mean of {GP_REPS}), peak device memory "
          f"{peak:.2f} GiB, kernel B2 launches {launches}")
    print(f"[gp main] LML {lml!r}, gradient {grad.tolist()}")
    if launches == 0:
        raise RuntimeError("the GP main path launched kernel B2 no time")
    if not (np.isfinite(lml) and grad.shape == (4,) and np.isfinite(grad).all()):
        raise RuntimeError(f"bad LML or gradient: {lml}, {grad}")

    plain = _plain_lml(x, y, err, GP_THETA)
    rel = abs(lml - plain) / abs(plain)
    print(f"[gp check a] LML against the independent plain route: {plain!r}, "
          f"rel diff {rel:.3e} (limit 1e-10)")
    if not rel <= 1e-10:
        raise RuntimeError(f"LML disagrees with the plain route ({rel})")

    h = 1e-4
    fd = np.empty(4)
    for i in range(4):
        tp, tm = GP_THETA.copy(), GP_THETA.copy()
        tp[i] += h
        tm[i] -= h
        fd[i] = (gp.marginal_likelihood(tp) - gp.marginal_likelihood(tm)) / (2 * h)
    rel_fd = float(np.abs(grad - fd).max() / np.abs(grad).max())
    print(f"[gp check b] gradient against central differences (h={h}): {fd.tolist()}, "
          f"max diff / max |grad| {rel_fd:.3e} (limit 1e-5)")
    if not rel_fd <= 1e-5:
        raise RuntimeError(f"gradient disagrees with finite differences ({rel_fd})")
    _profile_evaluation(gp)
    del gp
    torch.cuda.empty_cache()

    gp_a = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA,
                       cholesky="analytic")
    seconds_a, lml_a, grad_a = _time_lml_grad(gp_a)
    rel_a = float(np.abs(grad_a - grad).max() / np.abs(grad).max())
    print(f"[gp analytic] cholesky='analytic': {1 / seconds_a:.4f} LML+grad evals/s "
          f"({seconds_a * 1e3:.2f} ms each) against {seconds * 1e3:.2f} ms for 'auto'; "
          f"gradient max diff / max |grad| {rel_a:.3e}")
    if not rel_a <= 1e-8:
        raise RuntimeError(f"the analytic gradient disagrees ({rel_a})")
    del gp_a
    torch.cuda.empty_cache()

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the float32 evaluation needs them off")
    gp32 = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=torch.float32, device=CUDA)
    before = pairwise.KERNEL_LAUNCHES
    lml32, grad32 = gp32.marginal_likelihood_gradient(GP_THETA)
    print(f"[gp float32] LML {lml32!r} (float64 {lml!r}, rel diff "
          f"{abs(lml32 - lml) / abs(lml):.3e}), gradient {grad32.tolist()}")
    if pairwise.KERNEL_LAUNCHES == before or not np.isfinite([lml32, *grad32]).all():
        raise RuntimeError("the float32 evaluation did not run through B2 or is not finite")
    del gp32
    torch.cuda.empty_cache()
    return launches, 1 / seconds, 1 / seconds_a


def phase_gp_fit_predict():
    """fit(optimizer="bfgs", n_starts=2) and __call__ at N=4,096, float64."""
    x, y, err = make_gp_data(4096)
    gp = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA)
    lwr, upr = (np.array([b[i] for b in gp.hp_bounds]) for i in (0, 1))
    lml_centre = gp.marginal_likelihood(0.5 * (lwr + upr))
    t0 = time.perf_counter()
    theta = gp.fit(optimizer="bfgs", n_starts=2)
    seconds = time.perf_counter() - t0
    lml_fit = gp.marginal_likelihood(theta)
    print(f"[gp fit] N=4096: two L-BFGS-B starts in {seconds:.2f} s, LML {lml_fit!r} at "
          f"{theta.tolist()} (start centre {lml_centre!r})")
    if not lml_fit >= lml_centre:
        raise RuntimeError("the fit ended below the LML at the start centre")

    gp.set_hyperparameters(theta)
    q = np.random.default_rng(8).uniform(0, 10, (4096, 2))
    before = pairwise.KERNEL_LAUNCHES
    mu, sd = gp(q)
    if pairwise.KERNEL_LAUNCHES == before:
        raise RuntimeError("prediction at 4096 points did not launch kernel B2")
    L, r, amp, ls = _plain_gp(x, y, err, theta)
    alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
    K_qx = pairwise._sqexp_reference(_gp_operands(q, F64)[0], _gp_operands(x, F64)[0], amp, ls)
    mu_ref = (K_qx @ alpha + float(theta[0])).cpu().numpy()
    v = torch.linalg.solve_triangular(L, K_qx.T, upper=False)
    sd_ref = torch.sqrt(torch.abs(amp**2 - (v**2).sum(dim=0))).cpu().numpy()
    rel_mu = float(np.abs(mu - mu_ref).max() / np.abs(mu_ref).max())
    rel_sd = float(np.abs(sd - sd_ref).max() / np.abs(sd_ref).max())
    print(f"[gp predict] 4096 points: mean and sd against the plain route, max diff / "
          f"max value {rel_mu:.3e} and {rel_sd:.3e} (limit 1e-10)")
    if not (np.isfinite(mu).all() and np.isfinite(sd).all() and mu.shape == (4096,)):
        raise RuntimeError("bad predictions")
    if not max(rel_mu, rel_sd) <= 1e-10:
        raise RuntimeError(f"predictions disagree with the plain route ({rel_mu}, {rel_sd})")
    return lml_fit


def _profile_evaluation(gp):
    """torch.profiler over one LML+gradient evaluation: device time of the
    heaviest operations (nested ones included) and the device idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gp.marginal_likelihood_gradient(GP_THETA)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    device = sum(e.self_device_time_total for e in events if e.device_type == cuda) / 1e3
    print(f"[gp profile] one evaluation: {wall:.3f} ms wall, {device:.3f} ms of device "
          f"kernels (device idle {100 * (1 - device / wall):.1f}%)")
    ops = [e for e in events if e.device_type != cuda and e.device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:10]:
        print(f"[gp profile] {e.device_time_total / 1e3:10.3f} ms  {e.count:3d}x  {e.key[:90]}")


# ---------------------------------------------------------------------------
# kernels B3-B8 and the matrix-free small-noise GP (gp-large-50k, -16k)
# ---------------------------------------------------------------------------

LARGE_N = 50_000
LARGE_KW = dict(hyperpars=[0.0, 0.0, 0.0], block_size=4096, preconditioner_rank=512,
                solver="df64", cg_tol=1e-9, cg_maxiter=3000)
DF64_TOL = 1e-13  # B3/B4/B6/B8 vs plain, per entry of sum_j |E_ij| |V_jk|
STORED_Q = (1, 2, 8, 16)  # right-hand sides at which B6 and B8 are checked and timed
F32_STORE_TOL = 2.0**-24 + 1e-13  # B8 vs B6: the float32 store's rounding
D20 = 20  # gp-large-50k-d20's coordinate dimension
# amplitude 1, lengthscale 5 in every dimension: the pre-scaled coordinates on [0, 1.5]^20
D20_KW = dict(LARGE_KW, hyperpars=[0.0] + [float(np.log(5.0))] * D20)


def make_large_data(n, seed=0):
    """``benchmarks/df64_solve_bench.py``'s data: x uniform on [0, 10]^2,
    y = sin x0 cos x1 + N(0, 0.01^2), y_err = 0.01."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    return x, y, np.full(n, 0.01)


def make_d20_data(n, seed=0):
    """gp-large-50k's generator in 20 dimensions: x uniform on [0, 7.5]^20,
    y = sin x0 cos x1 + N(0, 0.01^2), y_err = 0.1. At y_err = 0.01 the
    training solve took more than cg_maxiter (3,000) iterations on the
    H100; y_err alone is raised (PERF.md section 4)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 7.5, size=(n, D20))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    return x, y, np.full(n, 0.1)


def _padded(x, block=4096):
    """x padded to a multiple of ``block`` with mean rows, as LargeScaleGP
    pads it."""
    extra = -(-len(x) // block) * block - len(x)
    return np.concatenate([x, np.repeat(x.mean(axis=0, keepdims=True), extra, axis=0)])


def _scaled_err(got, ref, scale):
    """(max abs error, max error over sum_j |E_ij| |V_jk|)."""
    err = (got - ref).abs()
    return float(err.max()), float((err / scale).max())


def _bit_for_bit(label, kernel, E, us, round_f32=False):
    """A stored entry matrix against its plain version, row block by row
    block, so the full matrix exists once; raises on any differing bit."""
    n = us.shape[0]
    mismatches, worst = 0, 0.0
    for blk in df64._row_blocks(n, n):
        ref = df64._entry_block(us[blk], us)
        diff = (E[blk] - (ref.float() if round_f32 else ref)).abs()
        mismatches += int((diff != 0).sum())
        worst = max(worst, float(diff.max()))
        del diff, ref
    print(f"[check {label}] {kernel} n={n}: {mismatches} of {n * n} entries differ from the "
          f"plain version, max abs err {worst:.3e} (bit for bit expected)")
    if mismatches:
        raise RuntimeError(f"check {label}: {kernel} differs from its plain version in "
                           f"{mismatches} entries")
    return worst


def phase_df64_checks(xpad):
    """Kernels B3-B8 against their plain versions at full width on the
    same inputs. Returns the max abs errors by kernel and the operands."""
    n = xpad.shape[0]
    uh, ul = (torch.as_tensor(a, device=CUDA) for a in df64.split_f64(xpad))
    us = uh.double() + ul.double()
    V = torch.as_tensor(np.random.default_rng(9).normal(size=(n, 16)).astype(np.float32),
                        device=CUDA)
    errs = {}
    E = df64.sqexp_entries_df64(uh, ul)
    errs["B5"] = _bit_for_bit("9a", "B5", E, us)
    E32 = df64.sqexp_entries_f32(uh, ul)
    errs["B7"] = _bit_for_bit("9f", "B7", E32, us, round_f32=True)

    def held(label, kernel, got, ref, scale, tol=DF64_TOL):
        max_abs, rel = _scaled_err(got, ref, scale)
        if tol == DF64_TOL:
            errs[kernel] = max(errs.get(kernel, 0.0), max_abs)
        print(f"[check {label}] max abs err {max_abs:.3e}, max err / sum|E||V| {rel:.3e} "
              f"(limit {tol:g})")
        if not (rel <= tol and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"check {label}: {kernel} disagrees ({rel})")

    A, B = (torch.as_tensor(np.random.default_rng(9).integers(-9, 10, shape), dtype=F64,
                            device=CUDA) for shape in ((16, 4), (4, 8)))
    tile = df64._launch_stored_mma_tile(A, B)
    torch.cuda.synchronize()
    print(f"[check 9i] B6/B8's m16n8k4 FP64 MMA on one 16 x 8 tile: "
          f"{int((tile != A @ B).sum())} of 128 differ from A @ B (exact expected)")
    if not torch.equal(tile, A @ B):
        raise RuntimeError("check 9i: the MMA fragment layout is wrong")
    for q in STORED_Q:
        Vq = V[:, :q].contiguous()
        scale = df64._stored_reference(E, Vq.abs())
        ref = df64._stored_reference(E, Vq)
        got = df64.sqexp_stored_matmat_df64(E, Vq)
        held(f"9b B6 q={q} vs plain", "B6", got, ref, scale)
        fused = df64.sqexp_matmat_df64(uh, ul, Vq)
        held(f"9c B4 q={q} vs plain", "B4", fused, df64._fused_reference(us, us, Vq), scale)
        held(f"9d B6 vs B4 q={q}", "B6", got, fused, scale)
        ref32 = df64._stored_reference(E32, Vq)
        scale32 = df64._stored_reference(E32, Vq.abs())
        got32 = df64.sqexp_stored_f32_matmat(E32, Vq)
        held(f"9g B8 q={q} vs plain", "B8", got32, ref32, scale32)
        held(f"9h B8 vs B6 q={q}", "B8", got32, got, scale, F32_STORE_TOL)
        del ref, ref32, scale32, fused
    scale1 = df64._stored_reference(E, V[:, :1].abs())[:, 0]
    held("9e B3 vs plain", "B3", df64.sqexp_matvec_df64(uh, ul, V[:, 0].contiguous()),
         df64._fused_reference(us, us, V[:, :1].contiguous())[:, 0], scale1)
    return errs, (uh, ul, us, V)


WIDE_D, WIDE_Q = 20, 20  # the wide kernels' (d > 16) timed width; q > 16's checks
WIDE_CHECK_D = (17, 20, 33, 100)  # widths of the wide kernels' checks: both ends of a
# padded step of 4, one and three staged chunks of B5/B7, one and seven of B3/B4
EXP_FP64 = 18  # FP64 instructions of CUDA's double exp: 14 DFMA, 3 DADD, 1 DMUL (EXP_FLOPS)


def _wide_coords(n, d, seed):
    """Pre-scaled coordinates as a float32 pair and in FP64, uniform on
    [0, 1.5 sqrt(20 / d)]^d (gp-large-50k-d20's [0, 1.5]^20 at d = 20), so
    that E is about as well filled at every d."""
    x = np.random.default_rng(seed).uniform(0, 1.5 * np.sqrt(WIDE_D / d), (n, d))
    uh, ul = (torch.as_tensor(a, device=CUDA) for a in df64.split_f64(x))
    return uh, ul, uh.double() + ul.double()


def phase_df64_wide_checks(n=4096):
    """B5 and B7 (bit for bit), B3 and B4 (q = 8; 1e-13 of sum_j |E_ij|
    |V_jk|) at each of WIDE_CHECK_D (the wide kernels), B4 on 4,224 rows (a
    ragged last row block) at d = 20 and 100, and B4 and B6 at q = 20 (two
    launches each), against their plain versions at n. Returns the max abs
    errors by kernel."""
    V = torch.as_tensor(np.random.default_rng(21).normal(size=(n, WIDE_Q)).astype(np.float32),
                        device=CUDA)
    errs = {}

    def held(label, kernel, got, rows, cols, Vq, E=None):
        ref = df64._fused_reference(rows, cols, Vq) if E is None else df64._stored_reference(E, Vq)
        scale = (df64._fused_reference(rows, cols, Vq.abs()) if E is None
                 else df64._stored_reference(E, Vq.abs()))
        max_abs, rel = _scaled_err(got, ref, scale)
        errs[kernel] = max(errs.get(kernel, 0.0), max_abs)
        print(f"[check {label}] max abs err {max_abs:.3e}, max err / sum|E||V| {rel:.3e} "
              f"(limit {DF64_TOL:g})")
        if not (rel <= DF64_TOL and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"check {label}: {kernel} disagrees ({rel})")

    V1, V8 = V[:, :1].contiguous(), V[:, :8].contiguous()
    sms = torch.cuda.get_device_properties(CUDA).multi_processor_count
    for d in WIDE_CHECK_D:
        uh, ul, us = _wide_coords(n, d, 20 + d)
        for kernel, label, fn, f32 in (("B5", "9j", df64.sqexp_entries_df64, False),
                                       ("B7", "9k", df64.sqexp_entries_f32, True)):
            errs[kernel] = max(errs.get(kernel, 0.0),
                               _bit_for_bit(label, f"{kernel} d={d}", fn(uh, ul), us, f32))
        held(f"9l B3 d={d} vs plain", "B3", df64.sqexp_matvec_df64(uh, ul, V1[:, 0])[:, None],
             us, us, V1)
        held(f"9m B4 d={d} q=8 vs plain ({df64.fused_wide_plan(n, n, d, 8, sms)})", "B4",
             df64.sqexp_matmat_df64(uh, ul, V8), us, us, V8)
        if d in (20, 100):
            rh, rl, rs = _wide_coords(n + 128, d, 40 + d)
            held(f"9m B4 d={d} q=8, 4,224 rows vs plain", "B4",
                 df64.sqexp_matmat_rect_df64(rh, rl, uh, ul, V8), rs, us, V8)
    xh, xl, xs = (a[:, :2].contiguous() * 4 for a in _wide_coords(n, WIDE_D, 20))  # [0, 6]^2
    held(f"9n B4 q={WIDE_Q} vs plain", "B4", df64.sqexp_matmat_df64(xh, xl, V), xs, xs, V)
    E = df64.sqexp_entries_df64(xh, xl)
    held(f"9o B6 q={WIDE_Q} vs plain", "B6", df64.sqexp_stored_matmat_df64(E, V), None, None, V, E)
    return errs


def phase_df64_wide_timing(n):
    """B3, B4 (q = 8), B5 and B7 at n, d = 20 (the wide kernels), each in two
    turns with its plain version (CUDA events), beside its flops bound (the
    convention of the kernels line) and its FP64-issue time (a model, from
    the FP64 instructions per entry, printed only); then one output of each
    held against its plain version at n: B5 and B7 bit for bit, B3 and B4
    within DF64_TOL of sum_j |E_ij| |V_jk|. Returns {kernel: {"ms",
    "plain_ms", "bound_ms", "bound_by", "max_abs_err"}}."""
    d = WIDE_D
    uh, ul, us = _wide_coords(n, d, 22)
    V = torch.as_tensor(np.random.default_rng(23).normal(size=(n, 8)).astype(np.float32),
                        device=CUDA)
    n2 = float(n) * n
    rows = {}

    def report(kernel, k, p, b, per_entry):
        issue = fp64_issue_ms(n, per_entry)  # a model: the boost clock, a count from the code
        print(f"[time] {kernel} n={n} d={d}: kernel {k[0]:.4f} / {k[1]:.4f} ms, plain "
              f"{p[0]:.4f} / {p[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; kernel / bound "
              f"{min(k) / b[0]:.2f}), FP64-issue model {issue:.4f} ms ({per_entry} FP64 "
              f"instructions per entry, not read from the SASS; kernel / model "
              f"{min(k) / issue:.2f})")
        rows[kernel] = {"ms": min(k), "plain_ms": min(p), "bound_ms": b[0], "bound_by": b[1]}

    def held(label, kernel, got, Vq):
        max_abs, rel = _scaled_err(got, df64._fused_reference(us, us, Vq),
                                   df64._fused_reference(us, us, Vq.abs()))
        rows[kernel]["max_abs_err"] = max_abs
        print(f"[check {label}] {kernel} n={n} d={d} q={Vq.shape[1]}: max abs err "
              f"{max_abs:.3e}, max err / sum|E||V| {rel:.3e} (limit {DF64_TOL:g})")
        if not (rel <= DF64_TOL and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"check {label}: {kernel} disagrees at n={n}, d={d} ({rel})")

    V1 = V[:, :1].contiguous()
    k, p = _turns(lambda v: df64.sqexp_matvec_df64(uh, ul, v),
                  lambda v: df64._fused_reference(us, us, v[:, None]), (V1[:, 0],), 3, 1)
    report("B3", k, p, _fused_bound(n, d, 1), 3 * d + 1 + EXP_FP64 + 1)
    held("9p", "B3", df64.sqexp_matvec_df64(uh, ul, V1[:, 0])[:, None], V1)
    k, p = _turns(lambda v: df64.sqexp_matmat_df64(uh, ul, v),
                  lambda v: df64._fused_reference(us, us, v), (V,), 3, 1)
    report("B4", k, p, _fused_bound(n, d, 8), 3 * d + 1 + EXP_FP64 + 8)
    held("9p", "B4", df64.sqexp_matmat_df64(uh, ul, V), V)
    entry = 3 * d + 1 + EXP_FLOPS
    for kernel, fn, plain, size, f32 in (
            ("B5", df64.sqexp_entries_df64, df64._entries_reference, 8, False),
            ("B7", df64.sqexp_entries_f32, df64._entries_f32_reference, 4, True)):
        torch.cuda.empty_cache()
        k, p = _turns(lambda: fn(uh, ul), lambda: plain(us), (), 2, 1)
        report(kernel, k, p, bound(size * n2 + 8 * n * d, n2 * entry, FP64_FLOPS),
               3 * d + 1 + EXP_FP64)
        torch.cuda.empty_cache()
        rows[kernel]["max_abs_err"] = _bit_for_bit("9q", f"{kernel} d={d}", fn(uh, ul), us, f32)
    torch.cuda.empty_cache()
    return rows


def _turns(kernel, plain, args, reps_kernel, reps_plain):
    """CUDA-event ms of a kernel and its plain version in turns (plain,
    kernel, plain, kernel); returns the two lists."""
    p = [time_events(plain, args, reps_plain)]
    k = [time_events(kernel, args, reps_kernel)]
    p.append(time_events(plain, args, reps_plain))
    k.append(time_events(kernel, args, reps_kernel))
    return k, p


def _fused_bound(n, d, q):
    """B3/B4's bound at n x n entries: the coordinates and v read, the
    result written once; per entry the distance, the exp and q fma."""
    return bound(8 * n * d + 4 * n * q + 8 * n * q, float(n) * n * (3 * d + 1 + EXP_FLOPS + 2 * q),
                 FP64_FLOPS)


def phase_df64_timing(operands):
    """B3, B4 (q = 2, 8, 16), B5, B6 (q = 1, 2, 8, 16), B7 and B8 (the same q) at
    full width with CUDA events, each beside its plain version and its bound;
    B6 beside torch.matmul, B5 beside cdist and the exp, B8 beside a float32
    torch.matmul (the nearest yardstick: no PyTorch call takes float32
    operands to their exact float64 product). Returns {kernel: row of the
    JSON line}."""
    uh, ul, us, V = operands
    n, d = us.shape
    n2 = float(n) * n
    entry = 3 * d + 1 + EXP_FLOPS
    V1 = V[:, :1].contiguous()
    rows = {}

    def report(kernel, label, k, p, b, lib=None):
        lib_txt = "" if lib is None else f", library {lib:.4f} ms"
        print(f"[time] {kernel} {label}: kernel {k[0]:.4f} / {k[1]:.4f} ms, plain "
              f"{p[0]:.4f} / {p[1]:.4f} ms{lib_txt}, bound {b[0]:.4f} ms ({b[1]}), "
              f"kernel / bound {min(k) / b[0]:.2f}")
        return {"ms": min(k), "plain_ms": min(p), "bound_ms": b[0], "bound_by": b[1],
                "library_ms": lib}

    k, p = _turns(lambda v: df64.sqexp_matvec_df64(uh, ul, v),
                  lambda v: df64._fused_reference(us, us, v[:, None]), (V1[:, 0],), 10, 1)
    rows["B3"] = report("B3", f"n={n}", k, p, _fused_bound(n, d, 1))
    for q in (2, 8, 16):
        k, p = _turns(lambda v: df64.sqexp_matmat_df64(uh, ul, v),
                      lambda v: df64._fused_reference(us, us, v), (V[:, :q].contiguous(),), 10, 1)
        rows[f"B4 q={q}"] = report("B4", f"n={n} q={q}", k, p, _fused_bound(n, d, q))
    k, p = _turns(lambda: df64.sqexp_entries_df64(uh, ul), lambda: df64._entries_reference(us),
                  (), 5, 1)
    ones = torch.ones((), dtype=torch.float64, device=CUDA)
    lib = time_events(_cdist_exp, (us, us, ones, torch.ones(d, dtype=torch.float64,
                                                                device=CUDA)), 2)
    row = report("B5", f"n={n} (cdist + exp {lib:.4f} ms)", k, p,
                 bound(8 * n2 + 8 * n * d, n2 * entry, FP64_FLOPS))
    rows["B5"] = {**row, "cdist_exp_ms": lib}
    torch.cuda.empty_cache()
    E = df64.sqexp_entries_df64(uh, ul)
    for q in STORED_Q:
        Vq = V[:, :q].contiguous()
        k, p = _turns(lambda v: df64.sqexp_stored_matmat_df64(E, v),
                      lambda v: df64._stored_reference(E, v), (Vq,), 10, 3)
        lib = time_events(torch.matmul, (E, Vq.double()), 10)
        rows[f"B6 q={q}"] = report("B6", f"n={n} q={q}", k, p,
                                   bound(8 * n2 + 12 * n * q, 2 * q * n2, FP64_FLOPS), lib)
    del E
    torch.cuda.empty_cache()
    k, p = _turns(lambda: df64.sqexp_entries_f32(uh, ul),
                  lambda: df64._entries_f32_reference(us), (), 5, 1)
    rows["B7"] = report("B7", f"n={n}", k, p, bound(4 * n2 + 8 * n * d, n2 * entry, FP64_FLOPS))
    E32 = df64.sqexp_entries_f32(uh, ul)
    for q in STORED_Q:
        Vq = V[:, :q].contiguous()
        k, p = _turns(lambda v: df64.sqexp_stored_f32_matmat(E32, v),
                      lambda v: df64._stored_reference(E32, v), (Vq,), 10, 3)
        yard = time_events(torch.matmul, (E32, Vq), 10)
        row = report("B8", f"n={n} q={q} (float32 torch.matmul {yard:.4f} ms)", k, p,
                     bound(4 * n2 + 12 * n * q, 2 * q * n2, FP64_FLOPS))
        rows[f"B8 q={q}"] = {**row, "matmul_f32_ms": yard}
    return rows


def _plain_residual(gp):
    """The FP64 relative residual of gp's training solve by an independent
    plain route: K alpha from B2's plain version (exact differences) in row
    blocks and torch matmuls, never kernels B3-B8."""
    t = lambda a: torch.as_tensor(a, dtype=F64, device=CUDA)
    xs, alpha, mask = t(gp._x_host), t(gp.alpha64), t(gp._mask)
    amp, ls = t(np.exp(gp.hyperpars[0])), t(np.exp(gp.hyperpars[1:]))
    Ka = torch.cat([pairwise._sqexp_reference(xs[blk], xs, amp, ls) @ alpha
                    for blk in df64._row_blocks(xs.shape[0], xs.shape[0])])
    diag = t(gp._sig_host + np.exp(2 * gp.hyperpars[0]) * 1e-12)
    b = t((gp._y_host - gp.mean_value) * gp._mask)
    return float(((b - Ka - diag * alpha) * mask).norm() / b.norm())


def _profile_solve(gp):
    """torch.profiler over one warm training solve: device idle share and
    the top kernels by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gp._solve_alpha()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[large profile] one warm solve: {wall:.3f} ms wall, {device:.3f} ms of device "
          f"kernels (device idle {100 * (1 - device / wall):.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[large profile] {e.self_device_time_total / 1e3:10.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def _free():
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def _large_run(label, x, y, err, q, store, profile, kw=LARGE_KW, n_var=16):
    """One LargeScaleGP(solver="df64") instance on the card (settings
    ``kw``): cold constructor + solve, a warm solve, residuals,
    predictions (``n_var`` of them with variances). Returns the instance,
    the readings and the kernel launches of the run."""
    print(f"[{label}] device memory allocated before the run: {_free():.2f} GiB")
    for k in df64.KERNEL_LAUNCHES:
        df64.KERNEL_LAUNCHES[k] = 0
    for by_q in df64.STORED_LAUNCHES_BY_Q.values():
        by_q.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = LargeScaleGP(x, y, err, store_entries=store, device=CUDA, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    solver = gp._df64_solver._multi
    chunks = solver.chunks_run
    t0 = time.perf_counter()
    gp._solve_alpha()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    warm_chunks = solver.chunks_run - chunks
    res_kernel = gp.residual_norm_f64()
    res_plain = _plain_residual(gp)
    t0 = time.perf_counter()
    mu = gp(q)
    mu16, sd16 = gp(q[:n_var], with_variance=True)
    torch.cuda.synchronize()
    pred = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(df64.KERNEL_LAUNCHES)
    launches.update({f"{k} by q": dict(sorted(v.items()))
                     for k, v in df64.STORED_LAUNCHES_BY_Q.items()})
    print(f"[{label}] store_entries={store!r} (tier {gp._tier}): cold constructor + solve "
          f"{cold:.3f} s, warm solve {warm:.3f} s ({warm_chunks} chunks of "
          f"{solver.restart_every} iterations; {solver.chunks_run} chunks in all), FP64 "
          f"relative residual {res_kernel:.3e} by the "
          f"tier's kernel, {res_plain:.3e} by the plain route; 256 means + {n_var} variances "
          f"{pred:.3f} s; peak device memory {peak:.2f} GiB; kernel launches {launches}")
    if not (res_plain <= 1e-9 and abs(res_kernel - res_plain) <= 1e-10):
        raise RuntimeError(f"{label}: residual {res_plain} (kernel {res_kernel}), limit 1e-9")
    if not (np.isfinite(mu).all() and mu.shape == (len(q),) and np.isfinite(sd16).all()
            and np.abs(mu16 - mu[:n_var]).max() <= 1e-9):
        raise RuntimeError(f"{label}: bad predictions")
    if profile:
        _profile_solve(gp)
    return gp, {"cold_s": cold, "warm_s": warm, "warm_chunks": warm_chunks,
                "residual": res_plain, "peak_gib": peak, "mu": mu, "sd16": sd16}, launches


def phase_large_main():
    """gp-large-50k: LargeScaleGP(solver="df64") at N=50,000 on the card,
    with the FP64 entry store, the fused kernel and the float32 store. Each
    run counts its kernel launches from 0."""
    x, y, err = make_large_data(LARGE_N)
    q = np.random.default_rng(1).uniform(0, 10, (256, 2))
    runs, launches = {}, {}
    for store, needs in (("auto", ("B5", "B6")), (False, ("B3", "B4")),
                         ("f32", ("B7", "B8", "B3"))):
        gp, runs[store], launches[store] = _large_run("gp-large-50k", x, y, err, q, store,
                                                      profile=store is not False)
        del gp
        if not all(launches[store][k] for k in needs):
            raise RuntimeError(f"store_entries={store!r} skipped a kernel: {launches[store]}")
    _free()
    total = {k: sum(run[k] for run in launches.values()) for k in df64.KERNEL_LAUNCHES}
    for k in df64.STORED_LAUNCHES_BY_Q:
        by_q = {}
        for run in launches.values():
            for q, count in run[f"{k} by q"].items():
                by_q[q] = by_q.get(q, 0) + count
        total[f"{k} by q"] = dict(sorted(by_q.items()))
    print(f"[gp-large-50k] kernel launches, all three runs: {total}")
    auto = runs["auto"]
    for store in (False, "f32"):
        other = runs[store]
        gap = max(np.abs(auto["mu"] - other["mu"]).max(),
                  np.abs(auto["sd16"] - other["sd16"]).max())
        print(f"[gp-large-50k] 'auto' against {store!r}: max difference of means and sds "
              f"{gap:.3e}; warm solve {auto['warm_s']:.3f} s against {other['warm_s']:.3f} s")
        if not gap <= 1e-7:
            raise RuntimeError(f"the tiers 'auto' and {store!r} disagree by {gap}")
    return total, runs


def phase_large_d20():
    """gp-large-50k-d20: LargeScaleGP(solver="df64") at N=50,000, d = 20 on
    the card with store_entries="auto" (the wide B5, then B6) and False (the
    wide B3, then the wide B4 for the predictions), each counting its
    launches from 0, "auto" profiled over one warm solve (False's profile,
    B3 98% of a warm solve, is in PERF.md; cut for the script's time); the
    two tiers' 256 means and 8 sds must agree within 1e-7 (16 sds cut to 8
    for the script's time)."""
    x, y, err = make_d20_data(LARGE_N)
    q = np.random.default_rng(3).uniform(0, 7.5, (256, D20))
    runs, launches = {}, {}
    for store, needs in (("auto", ("B5", "B6")), (False, ("B3", "B4"))):
        gp, runs[store], launches[store] = _large_run("gp-large-50k-d20", x, y, err, q, store,
                                                      profile=store == "auto", kw=D20_KW,
                                                      n_var=8)
        del gp
        wide = {k: launches[store][k] for k in needs}
        print(f"[gp-large-50k-d20] store_entries={store!r}: launches of the kernels at d = "
              f"{D20} {wide} ({', '.join(needs[:1])} through its wide kernel)")
        if not all(wide.values()):
            raise RuntimeError(f"gp-large-50k-d20 store_entries={store!r} skipped a kernel: "
                               f"{launches[store]}")
    _free()
    auto, fused = runs["auto"], runs[False]
    gap = max(np.abs(auto["mu"] - fused["mu"]).max(), np.abs(auto["sd16"] - fused["sd16"]).max())
    print(f"[gp-large-50k-d20] 'auto' against False: max difference of means and sds {gap:.3e} "
          f"(limit 1e-7); warm solve {auto['warm_s']:.3f} s against {fused['warm_s']:.3f} s, "
          f"cold {auto['cold_s']:.3f} s against {fused['cold_s']:.3f} s")
    if not gap <= 1e-7:
        raise RuntimeError(f"gp-large-50k-d20: the tiers 'auto' and False disagree by {gap}")
    return runs, launches


def phase_large_16k():
    """gp-large-16k: LargeScaleGP(solver="df64") at N=16,384 against a
    dense FP64 Cholesky on the card: training solve, means and variances at
    16 points."""
    n = 16_384
    x, y, err = make_large_data(n)
    q = np.random.default_rng(2).uniform(0, 10, (16, 2))
    t0 = time.perf_counter()
    gp = LargeScaleGP(x, y, err, device=CUDA, **LARGE_KW)
    mu, sd = gp(q, with_variance=True)
    seconds = time.perf_counter() - t0
    xs, qs = (torch.as_tensor(a, dtype=F64, device=CUDA) for a in (x, q))
    one, ls = torch.ones((), dtype=F64, device=CUDA), torch.ones(2, dtype=F64, device=CUDA)
    K = pairwise._sqexp_reference(xs, xs, one, ls)
    K.diagonal().add_(torch.as_tensor(err**2 + 1e-12, dtype=F64, device=CUDA))
    L = torch.linalg.cholesky(K)
    del K
    r = torch.as_tensor(y - gp.mean_value, dtype=F64, device=CUDA)
    alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
    Kq = pairwise._sqexp_reference(qs, xs, one, ls)
    mu_ref = (Kq @ alpha).cpu().numpy() + gp.mean_value
    v = torch.linalg.solve_triangular(L, Kq.T, upper=False)
    var_ref = (1.0 - (v * v).sum(dim=0)).cpu().numpy()
    d_alpha = float(np.abs(gp.alpha64 - alpha.cpu().numpy()).max() / alpha.abs().max())
    d_mu = float(np.abs(mu - mu_ref).max())
    d_var = float(np.abs(sd**2 - var_ref).max())
    print(f"[gp-large-16k] N={n}: constructor + 16 means and variances {seconds:.3f} s; against "
          f"the dense FP64 Cholesky: alpha max diff / max |alpha| {d_alpha:.3e} (limit "
          f"1e-8), means "
          f"{d_mu:.3e} (limit 1e-6), variances {d_var:.3e} (limit 1e-9; truth "
          f"{var_ref.min():.3e} to {var_ref.max():.3e})")
    if not (d_alpha <= 1e-8 and d_mu <= 1e-6 and d_var <= 1e-9):
        raise RuntimeError(f"gp-large-16k disagrees with the dense truth ({d_alpha}, {d_mu}, "
                           f"{d_var})")
    del gp, L
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# the rest of the matrix-free GP (gp-large-cg-50k, gp-large-fit-16k, rq-16k,
# inv-50k, inv-8k): the cg and mixed tiers, fit(), the RQ and white-noise
# kernels and LargeScaleGpLinearInverter
# ---------------------------------------------------------------------------

# benchmarks/large_gp_bench.py's settings (N = 50,000, sigma = 0.1)
CG_KW = dict(hyperpars=[0.0, 0.0, 0.0], block_size=4096, preconditioner_rank=4096, cg_tol=1e-4,
             cg_maxiter=500, dtype="float32")
# benchmarks/large_gp_fit_bench.py's settings (N = 16,384, a poor start)
FIT_N, FIT_THETA0 = 16_384, np.array([0.5, 1.2, 1.2])
FIT_KW = dict(block_size=4096, preconditioner_rank=512, cg_tol=1e-4, cg_maxiter=400,
              dtype="float32")
FIT_ARGS = dict(n_steps=30, learning_rate=0.1, n_probes=8, seed=0, fit_tol=1e-3, fit_maxiter=150)
# rq-16k: [ln A, ln alpha, ln l1, ln l2] of the RQ, then ln sigma_w of the white noise
RQ_THETA = np.array([0.0, 0.5, 0.5, 0.5, np.log(0.05)])
# BASELINE configuration #5 (inv-50k) and its small twin (inv-8k)
INV_ERR = 0.02
INV_CG_KW = dict(block_size=4096, cg_tol=1e-4, cg_maxiter=2000, dtype="float32")
INV_DF64_KW = dict(block_size=4096, cg_tol=1e-10, cg_maxiter=6000)
INV_VARIANCES = 8  # variances of the cg and df64 "auto" runs (16, cut to fit the script's time)
SMI = ""  # nvidia-smi's name and power limit, set by phase_device


def _reset_launches():
    """Every kernel's launch count (and B6/B8's by q) to 0, and the peak
    memory statistic."""
    pairwise.KERNEL_LAUNCHES = 0
    for k in df64.KERNEL_LAUNCHES:
        df64.KERNEL_LAUNCHES[k] = 0
    for by_q in df64.STORED_LAUNCHES_BY_Q.values():
        by_q.clear()
    torch.cuda.reset_peak_memory_stats()


def _launches():
    """The launches since ``_reset_launches`` of every kernel launched."""
    counts = {"B2": pairwise.KERNEL_LAUNCHES, **df64.KERNEL_LAUNCHES}
    return {k: v for k, v in counts.items() if v}


def _phase_line(label, seconds, text=""):
    """A phase's closing line: its seconds, peak memory and launches, and
    the card and its power limit."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] {text}{seconds:.3f} s, peak device memory {peak:.2f} GiB, kernel "
          f"launches {_launches()} (card: {SMI})")
    return peak


def _counted_products(model, name):
    """Count the calls of ``model``'s system product ``name`` (an instance
    attribute over the method); returns the one-element list of the count."""
    calls = [0]
    product = getattr(model, name)

    def counted(*args):
        calls[0] += 1
        return product(*args)

    setattr(model, name, counted)
    return calls


def _mixed_iterations(products, restart_every=50):
    """mixed_pcg's iterations from its system products: one an iteration and
    one more at each true-residual restart (iteration i with i % 50 ==
    49)."""
    it = 0
    while it + it // restart_every < products:
        it += 1
    return it


def _profile_shares(label, run):
    """torch.profiler over ``run()``: wall and device-kernel ms, the device
    idle share, and the shares of kernel B2 and of the block products
    (cuBLAS GEMM/GEMV) in the device time; the top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    share = lambda *keys: sum(e.self_device_time_total for e in kernels
                              if any(k in e.key.lower() for k in keys)) / 1e3
    b2, products = share("sqexp_kernel"), share("gemm", "gemv", "dot_kernel")
    print(f"[{label} profile] {wall:.3f} ms wall, {device:.3f} ms of device kernels (device "
          f"idle {100 * (1 - device / wall):.1f}%); B2 {b2:.3f} ms "
          f"({100 * b2 / max(device, 1e-9):.1f}% of device time), block products (GEMM/GEMV) "
          f"{products:.3f} ms ({100 * products / max(device, 1e-9):.1f}%) (card: {SMI})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{label} profile] {e.self_device_time_total / 1e3:10.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return {"wall_ms": wall, "device_ms": device, "b2_ms": b2, "products_ms": products}


def phase_b2_cg_block():
    """Kernel B2 as the cg and mixed tiers launch it: a 4,096 x 53,248 row
    block in float32 (gp-large-cg-50k's data), against its plain version,
    then both timed in turns beside the bound (its 0.87 GB store) and cdist
    and the exp. Returns the numbers of the kernels line's ``cg_block``."""
    rng = np.random.default_rng(0)
    x = _padded(rng.uniform(0, 10, (LARGE_N, 2)))
    u, amp, ls = _gp_operands(x, torch.float32, np.zeros(4))
    blk = u[:4096].contiguous()
    k = pairwise._launch_sqexp(blk, u, amp, ls)
    p = pairwise._sqexp_reference(blk, u, amp, ls)
    max_abs, max_rel = _errors(k, p)
    print(f"[check 13a] B2 float32 4096x{u.shape[0]} (the cg tier's row block): max abs err "
          f"{max_abs:.3e}, max rel err {max_rel:.3e} (limit {B2_RTOL[torch.float32]:g})")
    if not (max_rel <= B2_RTOL[torch.float32] and bool(torch.isfinite(k).all())):
        raise RuntimeError(f"check 13a: B2 disagrees on the cg tier's block ({max_rel})")
    del k, p
    args = (blk, u, amp, ls)
    kern, plain = _turns(pairwise._launch_sqexp, pairwise._sqexp_reference, args, 20, 3)
    lib = time_events(_cdist_exp, args, 5)
    m, n, d = blk.shape[0], u.shape[0], u.shape[1]
    b_ms, b_by = bound(4 * (m * n + (m + n) * d), m * n * (3 * d + 2 + EXP_FLOPS), FP32_FLOPS)
    print(f"[time] B2 float32 {m}x{n} D={d} (the cg tier's row block): kernel {kern[0]:.4f} / "
          f"{kern[1]:.4f} ms, plain {plain[0]:.4f} / {plain[1]:.4f} ms, cdist + exp {lib:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}), kernel / bound {min(kern) / b_ms:.2f} "
          f"(card: {SMI})")
    torch.cuda.empty_cache()
    return {"ms": min(kern), "plain_ms": min(plain), "bound_ms": b_ms, "bound_by": b_by,
            "cdist_exp_ms": lib, "max_abs_err": max_abs, "shape": [m, n]}


def phase_large_cg():
    """gp-large-cg-50k: benchmarks/large_gp_bench.py's configuration, unchanged
    (N = 50,000, x on [0, 10]^2, y = sin x0 cos x1 + N(0, 0.1^2), y_err 0.1,
    theta 0, block 4096, rank 4096, cg_tol 1e-4, cg_maxiter 500, float32)
    with solver="cg" and "mixed": cold constructor, warm solve, iterations,
    B2 launches a system product (13: 53,248 / 4,096), the FP64 residual by
    the plain route (<= 1e-3), the 256 means' rms against the generating
    function; the means within 1e-2 (relative) and 16 variances within 1e-3
    of solver="df64"'s (FP64 store, rank 512, cg_tol 1e-9) on the same data.
    One warm cg solve profiled. Returns the readings and launches by tier."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (LARGE_N, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, LARGE_N)
    err = np.full(LARGE_N, 0.1)
    q = rng.uniform(1, 9, (256, 2))
    truth = np.sin(q[:, 0]) * np.cos(q[:, 1])
    per_block = -(-LARGE_N // CG_KW["block_size"])
    runs, launches = {}, {}
    for solver in ("cg", "mixed"):
        _free()
        _reset_launches()
        t_phase = t0 = time.perf_counter()
        gp = LargeScaleGP(x, y, err, solver=solver, device=CUDA, **CG_KW)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        products = _counted_products(gp, "_system_matmat")
        b2_before = pairwise.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        gp._set_alpha(gp._solve_alpha())
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        warm_b2, warm_products = pairwise.KERNEL_LAUNCHES - b2_before, products[0]
        its = gp.cg_iterations_estimate if solver == "cg" else _mixed_iterations(warm_products)
        res = _plain_residual(gp)
        t0 = time.perf_counter()
        mu = gp(q)
        mu16, sd16 = gp(q[:16], with_variance=True)
        torch.cuda.synchronize()
        pred = time.perf_counter() - t0
        rms = float(np.sqrt(np.mean((mu - truth) ** 2)))
        prof = _profile_shares("gp-large-cg-50k cg warm solve", gp._solve_alpha) \
            if solver == "cg" else None
        peak = _phase_line("gp-large-cg-50k", time.perf_counter() - t_phase, (
            f"solver={solver!r}: cold constructor + solve {cold:.3f} s, warm solve {warm:.3f} s "
            f"({its} iterations, {warm_products} system products, "
            f"{warm_b2 / max(warm_products, 1):g} B2 launches a product, {per_block} expected), "
            f"FP64 relative residual by the plain route {res:.3e} (limit 1e-3), 256 means rms "
            f"against sin x0 cos x1 {rms:.4f}, 256 means + 16 variances {pred:.3f} s; phase "))
        launches[solver] = _launches()
        if warm_b2 != per_block * warm_products or not res <= 1e-3:
            raise RuntimeError(f"gp-large-cg-50k {solver}: {warm_b2} B2 launches for "
                               f"{warm_products} products, residual {res}")
        if not (np.isfinite(mu).all() and np.isfinite(sd16).all() and mu.shape == (256,)):
            raise RuntimeError(f"gp-large-cg-50k {solver}: bad predictions")
        runs[solver] = {"cold_s": cold, "warm_s": warm, "iterations": its, "residual": res,
                        "rms": rms, "peak_gib": peak, "mu": mu, "var16": sd16**2,
                        "profile": prof}
        del gp
    _free()
    _reset_launches()
    t0 = time.perf_counter()
    gp = LargeScaleGP(x, y, err, device=CUDA, **LARGE_KW)
    mu64 = gp(q)
    _, sd64 = gp(q[:16], with_variance=True)
    res64 = _plain_residual(gp)
    torch.cuda.synchronize()
    _phase_line("gp-large-cg-50k", time.perf_counter() - t0,
                f"reference solver='df64' (FP64 store, rank 512, cg_tol 1e-9): residual "
                f"{res64:.3e}; constructor + predictions ")
    launches["df64"] = _launches()
    del gp
    _free()
    scale = np.abs(mu64).max()
    for solver, run in runs.items():
        d_mu = float(np.abs(run["mu"] - mu64).max() / scale)
        d_var = float(np.abs(run["var16"] - sd64**2).max())
        run.update(mean_gap=d_mu, var_gap=d_var)
        print(f"[gp-large-cg-50k] solver={solver!r} against 'df64': means {d_mu:.3e} of max "
              f"|mean| (limit 1e-2), 16 variances {d_var:.3e} (limit 1e-3) (card: {SMI})")
        if not (d_mu <= 1e-2 and d_var <= 1e-3):
            raise RuntimeError(f"gp-large-cg-50k {solver} disagrees with df64 ({d_mu}, {d_var})")
        del run["mu"], run["var16"]
    return runs, launches


def _dense_lml(x, y, err, theta, mean):
    """The exact FP64 log marginal likelihood of the squared exponential at
    theta with a constant mean, by a dense Cholesky on the card (B2's plain
    version builds K)."""
    xs = torch.as_tensor(x, dtype=F64, device=CUDA)
    amp = torch.as_tensor(np.exp(theta[0]), dtype=F64, device=CUDA)
    ls = torch.as_tensor(np.exp(theta[1:]), dtype=F64, device=CUDA)
    K = pairwise._sqexp_reference(xs, xs, amp, ls)
    K.diagonal().add_(torch.as_tensor(err**2 + np.exp(2 * theta[0]) * 1e-12, dtype=F64,
                                      device=CUDA))
    L = torch.linalg.cholesky(K)
    del K
    r = torch.as_tensor(y - mean, dtype=F64, device=CUDA)
    v = torch.linalg.solve_triangular(L, r[:, None], upper=False)
    value = -0.5 * float((v * v).sum()) - float(torch.log(L.diagonal()).sum())
    del L
    torch.cuda.empty_cache()
    return value - 0.5 * len(y) * np.log(2 * np.pi)


def _fit_run(x, y, err, dtype):
    """One LargeScaleGP.fit() of gp-large-fit-16k in ``dtype``, its inner
    solves' residuals recorded. Returns (theta, seconds, biased-step
    warnings, worst inner relative residual of each step, launches)."""
    import warnings

    gp = LargeScaleGP(x, y, err, hyperpars=FIT_THETA0, device=CUDA, **dict(FIT_KW, dtype=dtype))
    resid = []
    worst = LargeScaleGP._fit_step

    def recorded(*args, **kw):
        out = worst(*args, **kw)
        resid.append(float(out[4]))
        return out

    launches = dict(_launches())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        LargeScaleGP._fit_step = recorded
        try:
            t0 = time.perf_counter()
            theta = gp.fit(**FIT_ARGS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            LargeScaleGP._fit_step = worst
    biased = [w for w in caught if "substantially biased" in str(w.message)]
    launched = {k: v - launches.get(k, 0) for k, v in _launches().items()}
    del gp
    _free()
    return theta, seconds, len(biased), resid, launched


def phase_large_fit():
    """gp-large-fit-16k: benchmarks/large_gp_fit_bench.py's configuration
    (N = 16,384, theta0 [0.5, 1.2, 1.2], rank 512, cg_tol 1e-4, cg_maxiter
    400, float32): fit(n_steps=30, learning_rate=0.1, n_probes=8, seed=0,
    fit_tol=1e-3, fit_maxiter=150) with seconds a step and each step's inner
    relative residual; the exact FP64 LML (dense Cholesky on the card) at
    theta_fit at least 10 above theta0's; a refit at theta_fit (cg_tol
    1e-6): its residual and its 256 means' rms against the generating
    function. The same fit in float64 must raise no biased-step warning and
    land within 1e-2 of the float32 theta: in float32 the inner solves sit
    at the floor of a float32 solution vector, about eps32 times the
    system's condition (3e-2 to 6e-2 once amp^2 nears 10, measured on an
    H100), which straddles the warning's 0.05, so the float32 run's
    warnings are counted and printed, and the float64 twin shows that they
    did not bias the fit."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (FIT_N, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, FIT_N)
    err = np.full(FIT_N, 0.1)
    _free()
    _reset_launches()
    t_phase = time.perf_counter()
    theta, seconds, biased, resid, fit_launches = _fit_run(x, y, err, "float32")
    theta64, seconds64, biased64, resid64, _ = _fit_run(x, y, err, "float64")
    mean_value = float(np.mean(y))
    lml0 = _dense_lml(x, y, err, FIT_THETA0, mean_value)
    lml1 = _dense_lml(x, y, err, theta, mean_value)
    gp2 = LargeScaleGP(x, y, err, hyperpars=theta, device=CUDA, **dict(FIT_KW, cg_tol=1e-6))
    q = rng.uniform(1, 9, (256, 2))
    rms = float(np.sqrt(np.mean((gp2(q) - np.sin(q[:, 0]) * np.cos(q[:, 1])) ** 2)))
    res2 = gp2.residual_norm()
    del gp2
    gap = float(np.abs(theta - theta64).max())
    peak = _phase_line("gp-large-fit-16k", time.perf_counter() - t_phase, (
        f"fit: 30 steps {seconds:.3f} s ({seconds / 30:.3f} s a step), theta {FIT_THETA0} -> "
        f"{np.round(theta, 4)}; inner relative residuals {min(resid):.2e} to {max(resid):.2e} "
        f"(biased-step warnings {biased}); the float64 twin {seconds64:.3f} s, residuals "
        f"{min(resid64):.2e} to {max(resid64):.2e}, warnings {biased64} (limit 0), theta "
        f"{np.round(theta64, 4)}, {gap:.2e} from float32's (limit 1e-2); exact FP64 LML "
        f"{lml0:.3f} -> {lml1:.3f} (+{lml1 - lml0:.3f}, limit +10); float32 fit launches "
        f"{fit_launches}; refit at theta_fit: residual {res2:.3e}, 256 means rms against sin "
        f"x0 cos x1 {rms:.4f}; phase "))
    if not (lml1 >= lml0 + 10.0 and biased64 == 0 and gap <= 1e-2
            and np.isfinite(theta).all()):
        raise RuntimeError(f"gp-large-fit-16k: LML {lml0} -> {lml1}, float64 twin's warnings "
                           f"{biased64}, theta gap {gap}")
    _free()
    return {"s_per_step": seconds / 30, "lml_gain": lml1 - lml0, "theta": theta.tolist(),
            "inner_residual_max": max(resid), "biased_steps": biased,
            "float64_s_per_step": seconds64 / 30, "float64_theta_gap": gap,
            "refit_residual": res2, "rms": rms, "peak_gib": peak, "launches": fit_launches}


def phase_rq():
    """rq-16k: LargeScaleGP(kernel=RationalQuadratic() + WhiteNoise(),
    solver="cg", dtype="float64", cg_tol=1e-10) on gp-16k's data; its 256
    means within 1e-6 (relative to max |mean|) of the port's dense
    GpRegressor with the same kernel and hyperparameters (FP64, the card).
    The RQ rows are plain torch arithmetic: no kernel is launched."""
    x, y, err = make_gp_data(GP_N)
    q = np.random.default_rng(4).uniform(1, 9, (256, 2))
    kernel = lambda: RationalQuadratic() + WhiteNoise()
    _free()
    _reset_launches()
    t0 = time.perf_counter()
    gp = LargeScaleGP(x, y, err, kernel=kernel(), hyperpars=RQ_THETA, solver="cg",
                      dtype="float64", cg_tol=1e-10, cg_maxiter=3000, block_size=4096,
                      preconditioner_rank=512, device=CUDA)
    mu = gp(q)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    its, mean_value = gp.cg_iterations_estimate, gp.mean_value
    del gp
    _free()
    dense = GpRegressor(x, y, y_err=err, hyperpars=[mean_value, *RQ_THETA], kernel=kernel(),
                        dtype=F64, device=CUDA)
    mu_d, _ = dense(q)
    del dense
    gap = float(np.abs(mu - mu_d).max() / np.abs(mu_d).max())
    _phase_line("rq-16k", time.perf_counter() - t0, (
        f"RQ + WhiteNoise, cg, float64: constructor + 256 means {seconds:.3f} s ({its} "
        f"iterations); means against the dense GpRegressor {gap:.3e} of max |mean| (limit "
        f"1e-6); phase "))
    if not gap <= 1e-6:
        raise RuntimeError(f"rq-16k: the means disagree with the dense GpRegressor by {gap}")
    _free()
    return {"seconds": seconds, "iterations": its, "mean_gap": gap}


def make_inversion_data(n, m, seed=0):
    """BASELINE configuration #5's generator: n parameter positions uniform
    on [0, 10]^2, m data by tests/gp/test_GpLinearInverter.py's local-
    averaging model (centres uniform on [0, 10]^2, weights exp(-d^2 / (2 *
    0.5)), each row summing to 1; the matrix built on the card in FP64),
    truth sin x0 cos(x1 / 2), y_err INV_ERR."""
    rng = np.random.default_rng(seed)
    xp = rng.uniform(0, 10, (n, 2))
    centres = rng.uniform(0, 10, (m, 2))
    c, p = (torch.as_tensor(a, dtype=F64, device=CUDA) for a in (centres, xp))
    A = torch.exp(-0.5 * torch.cdist(c, p) ** 2 / 0.5)
    A = (A / A.sum(dim=1, keepdim=True)).cpu().numpy()
    truth = np.sin(xp[:, 0]) * np.cos(0.5 * xp[:, 1])
    y = A @ truth + rng.normal(0, INV_ERR, m)
    return xp, A, y, np.full(m, INV_ERR)


def _plain_data_residual(inv, A):
    """The data-space relative residual |r - (Sigma + A K A^T) z| / |r| in
    FP64 by an independent plain route, on the exact model matrix ``A``:
    K's rows by B2's plain version in row blocks and torch matmuls, never
    B2-B8."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64, device=CUDA)
    n = A.shape[1]
    xs, A, z = t(inv._x_pad_host[:n]), t(A), t(inv.z64)
    amp, ls = t(np.exp(inv.hyperpars[0])), t(np.exp(inv.hyperpars[1:]))
    p = A.T @ z
    Kp = torch.cat([pairwise._sqexp_reference(xs[blk], xs, amp, ls) @ p
                    for blk in df64._row_blocks(n, n)])
    r = t(inv._rhs64())
    return float((r - t(inv._sig_host) * z - A @ Kp).norm() / r.norm())


def _inverter_run(label, y, err, A, xp, idx, warm=True, **kw):
    """One LargeScaleGpLinearInverter on the card (settings ``kw``): cold
    constructor and solve, a warm solve (unless ``warm`` is False), the
    plain-route residual, the posterior mean, variances at ``idx`` (none
    where ``idx`` is empty) and predict_data. Returns the readings and the
    launches of the run."""
    _free()
    _reset_launches()
    t_phase = t0 = time.perf_counter()
    inv = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], device=CUDA, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    if warm:
        inv._set_z(inv._solve_data_space())
        torch.cuda.synchronize()
    warm = time.perf_counter() - t0 if warm else None
    res = _plain_data_residual(inv, A)
    t0 = time.perf_counter()
    mean = inv.calculate_posterior_mean()
    var = inv.posterior_variances(idx) if len(idx) else np.zeros(0)
    pred = inv.predict_data()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rms = float(np.sqrt(np.mean((pred - y) ** 2)))
    tier = kw["solver"]
    if tier == "df64":
        tier += f" store_entries={kw['store_entries']!r}"
    peak = _phase_line(label, time.perf_counter() - t_phase, (
        f"{tier}: cold {cold:.3f} s, warm solve "
        f"{'not run' if warm is None else f'{warm:.3f} s'} ({inv.cg_iterations_estimate} cg "
        f"iterations where counted), FP64 data-space residual by the plain route {res:.3e}, "
        f"mean field + {len(idx)} variances + predict_data {seconds:.3f} s, predict_data rms "
        f"against y {rms:.4f} (limit {3 * INV_ERR:g}); run "))
    out = {"cold_s": cold, "warm_s": warm, "residual": res, "rms": rms, "peak_gib": peak,
           "mean": mean, "var": var}
    launches = _launches()
    del inv
    _free()
    return out, launches


def phase_inversion_50k():
    """inv-50k (BASELINE configuration #5): N = 50,000 parameters (padded to
    53,248), M = 4,096 local-averaging data, y_err 0.02, theta 0, block 4096;
    tiers cg and mixed in float32 (B2 rows, cg_tol 1e-4, cg_maxiter 2,000)
    and df64 with store_entries "auto" (B5 once, then B6) and False (B3/B4)
    at cg_tol 1e-10. Checks: the plain-route data-space residual (1e-3 for
    cg, 1e-9 for df64), the cg means within 1e-2 of df64's (relative), the
    two df64 stores' means within 1e-7, ``INV_VARIANCES`` variances (cg,
    df64 "auto")
    positive, at most the prior variance and cg's within 1e-3 of df64's,
    predict_data's rms against y at most 3 y_err for every tier. The mixed
    tier (the JAX package's mixed_pcg: the direction reset to steepest
    descent at every true-residual restart, 50 iterations apart) is printed
    but not held to the residual and the means: on this system, which has
    only the noise diagonal to precondition it (condition ~5e5), it stood at
    a relative residual of 1e-2 to 6e-2 after 6,000 iterations, where the
    unrestarted float32 CG bottoms out at 7.5e-4 (measured on an H100). Its
    variances are cg's (the same ``pcg_multi`` on the same operator, equal
    bit for bit on the card) and the fused store's cost as much as the
    FP64 store's, so neither is solved again (the script's time). For the
    same reason only the cg tier times a warm solve; the others' (17.3,
    27.3 and 20.4 s on an H100, PR 15) equal their cold solves less the
    constructor's set-up."""
    xp, A, y, err = make_inversion_data(LARGE_N, 4096)
    idx = np.random.default_rng(5).choice(len(xp), INV_VARIANCES, replace=False)
    runs, launches = {}, {}
    for name, kw, needs, limit, sel in (
            ("cg", dict(INV_CG_KW, solver="cg"), ("B2",), 1e-3, idx),
            ("mixed", dict(INV_CG_KW, solver="mixed"), ("B2",), None, idx[:0]),
            ("df64 auto", dict(INV_DF64_KW, solver="df64", store_entries="auto"), ("B5", "B6"),
             1e-9, idx),
            ("df64 fused", dict(INV_DF64_KW, solver="df64", store_entries=False), ("B4",),
             1e-9, idx[:0])):
        runs[name], launches[name] = _inverter_run("inv-50k", y, err, A, xp, sel,
                                                   warm=name == "cg", **kw)
        run = runs[name]
        if not ((limit is None or run["residual"] <= limit) and run["rms"] <= 3 * INV_ERR):
            raise RuntimeError(f"inv-50k {name}: residual {run['residual']} (limit {limit}), "
                               f"rms {run['rms']}")
        if not all(launches[name].get(k) for k in needs):
            raise RuntimeError(f"inv-50k {name} skipped a kernel: {launches[name]}")
        if not ((run["var"] > 0).all() and (run["var"] <= 1.0).all()):
            raise RuntimeError(f"inv-50k {name}: variances outside (0, prior]: {run['var']}")
    ref = runs["df64 auto"]
    scale = np.abs(ref["mean"]).max()
    for name, mean_limit, var_limit in (("df64 fused", 1e-7, None), ("cg", 1e-2, 1e-3),
                                        ("mixed", None, None)):
        run = runs[name]
        d_mu = float(np.abs(run["mean"] - ref["mean"]).max() / scale)
        d_var = float(np.abs(run["var"] - ref["var"]).max()) if var_limit else None
        run.update(mean_gap=d_mu, var_gap=d_var)
        print(f"[inv-50k] {name} against df64 auto: means {d_mu:.3e} of max |mean| (limit "
              f"{mean_limit or 'none, see the docstring'}), variances "
              f"{'not solved' if d_var is None else f'{d_var:.3e}'} (limit {var_limit}) "
              f"(card: {SMI})")
        if (mean_limit and d_mu > mean_limit) or (var_limit and d_var > var_limit):
            raise RuntimeError(f"inv-50k {name} disagrees with df64 auto ({d_mu}, {d_var})")
    for run in runs.values():
        del run["mean"], run["var"]
    return runs, launches


def phase_inversion_8k():
    """inv-8k: the same generator at N = 8,192, M = 1,024 against the port's
    dense GpLinearInverter in FP64 on the card: the df64 means within 1e-8
    and the float64 cg means within 1e-6 (relative to max |mean|); then
    fit(n_steps=30, learning_rate=0.1, n_probes=8, seed=0) from [1.5, 1.5,
    1.5] (cg tier, float64) must raise the exact dense data-space LML by at
    least 10."""
    xp, A, y, err = make_inversion_data(8192, 1024, seed=1)
    default = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    try:
        _free()
        _reset_launches()
        t0 = time.perf_counter()
        dense = GpLinearInverter(y, err, A, xp, device=CUDA)
        mean_ref = dense.calculate_posterior_mean([0.0, 0.0, 0.0, 0.0])
        gaps = {}
        for name, kw, limit in (("df64", dict(INV_DF64_KW, solver="df64"), 1e-8),
                                ("cg", dict(INV_DF64_KW, solver="cg", dtype="float64"), 1e-6)):
            inv = LargeScaleGpLinearInverter(y, err, A, xp, [0.0, 0.0, 0.0], device=CUDA, **kw)
            gaps[name] = float(np.abs(inv.calculate_posterior_mean() - mean_ref).max()
                               / np.abs(mean_ref).max())
            del inv
            if not gaps[name] <= limit:
                raise RuntimeError(f"inv-8k {name}: means {gaps[name]} from the dense FP64 "
                                   f"inverter (limit {limit})")
        theta0 = np.array([1.5, 1.5, 1.5])
        inv = LargeScaleGpLinearInverter(y, err, A, xp, theta0, solver="cg", dtype="float64",
                                         block_size=INV_CG_KW["block_size"], device=CUDA)
        t_fit = time.perf_counter()
        theta = inv.fit(n_steps=30, learning_rate=0.1, n_probes=8, seed=0)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t_fit
        del inv
        lml0 = dense.marginal_likelihood([0.0, *theta0])
        lml1 = dense.marginal_likelihood([0.0, *theta])
        del dense
    finally:
        torch.set_default_dtype(default)
    _phase_line("inv-8k", time.perf_counter() - t0, (
        f"means against the dense FP64 GpLinearInverter: df64 {gaps['df64']:.3e} (limit 1e-8), "
        f"cg float64 {gaps['cg']:.3e} (limit 1e-6); fit 30 steps {t_fit:.3f} s, theta "
        f"{theta0} -> {np.round(theta, 4)}, dense data-space LML {lml0:.3f} -> {lml1:.3f} "
        f"(+{lml1 - lml0:.3f}, limit +10); phase "))
    if not lml1 >= lml0 + 10.0:
        raise RuntimeError(f"inv-8k: the fit raised the LML by {lml1 - lml0} only")
    _free()
    return {"mean_gaps": gaps, "fit_s": t_fit, "lml_gain": lml1 - lml0, "theta": theta.tolist()}


# ---------------------------------------------------------------------------
# the probes P1-P3: kernel B3's measurement harnesses
# ---------------------------------------------------------------------------

SASS_CLASSES = {"fp64": ("DFMA", "DADD", "DMUL"), "fp32": ("FFMA", "FMUL", "FADD"),
                "int": ("IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "IMNMX",
                        "IABS"),
                "compare": ("DSETP", "FSETP"), "move": ("MOV", "UMOV", "CS2R", "S2R"),
                "shared": ("LDS", "STS"), "shuffle": ("SHFL",),
                "tensor": ("IMMA", "HMMA", "DMMA", "IGMMA"),
                "convert": ("I2F", "F2I", "F2F", "I2I"), "branch": ("BRA", "BSSY", "BSYNC"),
                "local": ("LDL", "STL"), "call": ("CALL", "RET")}


def _hot_span(body, cls="fp64", least=4, ops=None):
    """The innermost loop that holds at least ``least`` instructions of the
    class ``cls`` (or of the opcodes ``ops``) in one kernel's SASS
    ``body``: the smallest span from a backward branch's target to the
    branch, as a list of (address, opcode, operands), or None."""
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^ ;]*([^;]*);", body)]
    where = {a: k for k, (a, _, _) in enumerate(ins)}
    loops = []
    for k, (a, op, rest) in enumerate(ins):
        target = _back_target(a, op, rest)
        if target is not None and target in where:
            loop = ins[where[target]:k + 1]
            if sum(o in (ops or SASS_CLASSES[cls]) for _, o, _ in loop) >= least:
                loops.append(loop)
    return min(loops, key=len) if loops else None


def _back_target(address, op, operands):
    """The target of a backward branch at ``address``, else None."""
    target = re.search(r"0x([0-9a-f]+)", operands) if op == "BRA" else None
    return int(target.group(1), 16) if target and int(target.group(1), 16) < address else None


def _hot_loop(body, cls="fp64", least=4, ops=None):
    """``_hot_span`` as a list of (opcode, operands), or None."""
    span = _hot_span(body, cls, least, ops)
    return None if span is None else [(o, r) for _, o, r in span]


def _hot_loop_mix(name, symbol, entries, defines=(), cls="fp64"):
    """Instructions per entry of the hot loop (``_hot_loop``, at least 4 of
    the class ``cls``) of one kernel of ``name``'s library in the variant
    ``defines``, read off its SASS with cuobjdump; ``entries`` is the number
    of entries one thread evaluates per trip. Returns {class: count per
    entry, "all": every instruction, "inner_loops": the backward branches
    inside it, whose loops this count takes once a trip} or None without
    cuobjdump."""
    sass = _sass(name, defines)
    if sass is None:
        return None
    span = _hot_span(sass.split(symbol)[1].split("Function :")[0], cls)
    if span is None:
        return None
    loop = [o for _, o, _ in span]
    mix = {c: sum(o in names for o in loop) / entries for c, names in SASS_CLASSES.items()}
    mix["other"] = len(loop) / entries - sum(mix.values())
    mix["all"] = len(loop) / entries
    mix["inner_loops"] = sum(_back_target(*x) is not None for x in span[:-1])
    return mix


# P3's matvec kernel, sqexp_words_mma_kernel(const int8_t*, const int8_t*,
# const double*, const float*, double, double*, int, int) in the file's
# anonymous namespace (whose mangled name carries a tag of the file): its hot
# loop, the one that holds its MMAs, takes one 16 x 16 sub-tile of a warp a
# trip, 8 entries of each thread
P3_SYMBOL, P3_ENTRIES = "22sqexp_words_mma_kernelEPKaS1_PKdPKfdPdii", 8
# (label, library, mangled-name fragment, entries per thread per trip of the
# hot loop, defines, the class of instruction that marks the hot loop): B3 and
# B4 at q = 8 at d = 2 (two trips unrolled, each over the thread's rows), and
# the P2 and P3 kernels whose loops differ from B3's
HOT_LOOPS = (("B3", "sqexp_fused", f"sqexp_fused_kernelILi2ELi1ELi{df64.FUSED_RPT[1]}EE",
              2 * df64.FUSED_RPT[1], (), "fp64"),
             ("B4 q=8", "sqexp_fused", f"sqexp_fused_kernelILi2ELi8ELi{df64.FUSED_RPT[8]}EE",
              2 * df64.FUSED_RPT[8], (), "fp64"),
             ("P2 d2", "sqexp_ablate", "sqexp_ablate_kernelILi0ELi1ELb0EE", 2, (), "fp64"),
             ("P2 full", "sqexp_ablate", "sqexp_ablate_kernelILi4ELi1ELb0EE", 2, (), "fp64"),
             ("P2 fullb", "sqexp_ablate", "sqexp_ablate_kernelILi4ELi1ELb1EE", 4, (), "fp64"),
             ("P2 fulls4", "sqexp_ablate", "sqexp_ablate_kernelILi4ELi4ELb0EE", 8, (), "fp64"),
             *((f"P3 d={d}", "sqexp_words_mma", P3_SYMBOL, P3_ENTRIES, words.kernel_variant(d),
                "tensor") for d in P3_D))


def _print_fused_local_memory():
    """Each instantiation of B3/B4's kernels: its local-memory (spill)
    instructions in all and in its hot loop, from cuobjdump's SASS."""
    sass = _sass("sqexp_fused")
    if sass is None:
        print("[sass] B3/B4: cuobjdump not found; local memory not read")
        return
    for part in sass.split("Function : ")[1:]:
        name = re.match(r"\S+", part).group(0)
        wide = re.search(r"sqexp_fused_wide_kernelILi(\d+)EE", name)
        label = (f"sqexp_fused_wide_kernel<QMAX={wide[1]}>" if wide
                 else "sqexp_fused_kernel<DT={}, QMAX={}, RPT={}>".format(
                     *re.search(r"sqexp_fused_kernelILi(\d+)ELi(\d+)ELi(\d+)EE", name).groups()))
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part)
        loop = [o for o, _ in _hot_loop(part) or []]
        local = SASS_CLASSES["local"] + SASS_CLASSES["call"]
        print(f"[sass] {label}: {sum(o in local for o in ops)} local-memory or call instructions, "
              f"{sum(o in local for o in loop)} in the hot loop of {len(loop)}")


# the wide kernels' distance loops: (label, library, mangled-name fragment,
# entries and dimensions one thread covers per trip): B3/B4's kernel at q = 1
# and 8 (1 row x 16 columns, WIDE_KC dimensions a trip), B5/B7's (16 rows x
# 2 columns, 4 dimensions a trip)
WIDE_LOOPS = (
    ("B3 wide", "sqexp_fused", "sqexp_fused_wide_kernelILi1EE", 16, df64.WIDE_KC),
    ("B4 wide q=8", "sqexp_fused", "sqexp_fused_wide_kernelILi8EE", 16, df64.WIDE_KC),
    ("B5 wide", "sqexp_entries", "sqexp_entries_wide_kernelIdE", 32, 4),
    ("B7 wide", "sqexp_entries", "sqexp_entries_wide_kernelIfE", 32, 4),
)


def _print_wide_mix():
    """The SASS of each wide kernel's distance loop (the innermost loop with
    a DMUL per entry and dimension of a trip) per entry and dimension (3 FP64
    instructions are the work; the rest is issue beside it), and its
    local-memory instructions, from cuobjdump."""
    for label, lib, fragment, entries, dims in WIDE_LOOPS:
        sass = _sass(lib)
        body = next((part for part in (sass or "").split("Function : ")[1:]
                     if fragment in part.split()[0]), None)
        loop = _hot_loop(body, least=entries * dims, ops=("DMUL",)) if body else None
        if not loop:
            print(f"[sass] {label}: distance loop not read (no cuobjdump or no loop found)")
            continue
        ops = [o for o, _ in loop]
        per = entries * dims
        mix = {c: sum(o in names for o in ops) / per for c, names in SASS_CLASSES.items()}
        local = len(re.findall(r"\b(?:LDL|STL)\b", body))
        print(f"[sass] {label} distance loop, instructions per entry and dimension: "
              f"all {len(ops) / per:g}; " + ", ".join(f"{k} {v:g}" for k, v in mix.items() if v)
              + f"; local-memory instructions in the kernel: {local}")


def _b1_kernel(P, unit):
    """The SASS body of the kernel in B1's library for P parameters and
    unit (else diagonal) mass (the wide library's resident tiled kernel
    above P = 64), or None without cuobjdump."""
    if P > hmc_fused.P_NARROW:
        return _wide_body(WIDE_KERNELS[0][1])
    sass = _sass("hmc_fused", hmc_fused.kernel_variant(P, unit))
    if sass is None:
        return None
    return next(p for p in sass.split("Function : ")[1:] if "hmc_chunk_kernel" in p.split()[0])


def _b1_leapfrog(P, body):
    """The leapfrog loop of one B1 kernel for P parameters (the innermost
    loop with a whole matvec, P^2 FFMA) as (opcode, operands) pairs, and
    the leapfrog steps one trip of it runs; for the wide route's resident
    tiled kernel its product loop (128 FFMA a trip: 4 rows of A against a
    thread's 8 x 4 tile) and 0 steps."""
    if P > hmc_fused.P_NARROW:
        return _hot_loop(body, "fp32", 64), 0
    loop = _hot_loop(body, "fp32", P * P)
    if loop is None:
        return None, 0
    return loop, sum(o == "FFMA" for o, _ in loop) // (P * P)


def _print_b1_local_memory():
    """Each of B1's libraries: registers and spills are in the build log
    above; here the local-memory (spill) instructions of its kernel in all
    and in its leapfrog loop, and its calls (the slow paths of the division
    and the exp)."""
    local, call = SASS_CLASSES["local"], SASS_CLASSES["call"]
    for P, unit in B1_BUILD:
        body = _b1_kernel(P, unit)
        if body is None:
            print("[sass] B1: cuobjdump not found; local memory not read")
            return
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        loop, _ = _b1_leapfrog(P, body)
        loop = loop or []
        print(f"[sass] {_b1_label(P, unit)}: {sum(o in local for o in ops)} local-memory "
              f"instructions, {sum(o in local for o, _ in loop)} in the leapfrog loop of "
              f"{len(loop)}; {sum(o in call for o in ops)} call or return instructions")


WIDE_KERNELS = (("tiled, A resident", "hmc_tile_kernelILi0EE"),
                ("tiled, ring of 2", "hmc_tile_kernelILi2EE"),
                ("tiled, ring of 3", "hmc_tile_kernelILi3EE"),
                ("one warp per chain", "hmc_wide_kernel"))


def _wide_body(fragment):
    """The SASS body of the wide library's kernel whose name holds
    ``fragment``, or None without cuobjdump."""
    sass = _sass("hmc_fused", hmc_fused.kernel_variant(B1_WIDE_P[0], True))
    if sass is None:
        return None
    return next(p for p in sass.split("Function : ")[1:] if fragment in p.split()[0])


def _print_b1_wide_mix():
    """The instruction mix of each wide kernel's product loop, per FFMA:
    the tiled kernels' unrolled loop over j (4 rows of A a trip, 32 FFMA
    each: 128), the warp kernel's (16 FFMA a trip); its loads of A and D
    (LDS, or LDG for the warp kernel's A) beside the multiply-adds."""
    for label, fragment in WIDE_KERNELS:
        body = _wide_body(fragment)
        loop = _hot_loop(body, "fp32", 16 if "warp" in label else 64) if body else None
        if not loop:
            print(f"[sass] B1 wide {label}: product loop not read (no cuobjdump or no loop found)")
            continue
        ffma = sum(o == "FFMA" for o, _ in loop)
        count = lambda ops: sum(o in ops for o, _ in loop)
        print(f"[sass] B1 wide {label}, product loop: {len(loop)} instructions for {ffma} FFMA "
              f"({len(loop) / ffma:.3f} per FFMA): LDS {count(('LDS',))}, LDG {count(('LDG',))}, "
              f"other {len(loop) - ffma - count(('LDG', 'LDS'))}")


UNIFORM_REGISTER = re.compile(r"\bUR\d")
OTHER_BANK = re.compile(r"c\[0x[1-9a-f]")  # a constant bank other than the parameters'


def _print_b1_leapfrog_mix(P):
    """The instruction mix of one leapfrog step of B1's main-path kernel
    (unit mass) for P parameters, read off its SASS: FFMA, FMUL/FADD,
    shared and global loads, and where the operands come from: the
    constant bank of the kernel's parameters (c[0x0], which holds the
    form) or the uniform registers the assembler loads constants into.
    Beside it the bound's flops per step and their FMA equivalents (an FMA
    is two flops), the count the instructions are held to."""
    body = _b1_kernel(P, True)
    loop, steps = _b1_leapfrog(P, body) if body else (None, 0)
    if not steps:
        print(f"[sass] B1 P={P}: leapfrog loop not read (no cuobjdump or no loop found)")
        return
    count = lambda pred: sum(map(pred, loop)) / steps
    flops = _b1_step_flops(P)
    print(f"[sass] B1 P={P} leapfrog step ({steps} per trip of the loop): "
          f"{len(loop) / steps:g} instructions; FFMA {count(lambda x: x[0] == 'FFMA'):g}, "
          f"FMUL/FADD {count(lambda x: x[0] in ('FMUL', 'FADD')):g}, "
          f"LDS {count(lambda x: x[0] == 'LDS'):g}, LDG {count(lambda x: x[0] == 'LDG'):g}; "
          f"instructions with an operand from the parameters' constant bank (c[0x0]) "
          f"{count(lambda x: 'c[0x0]' in x[1]):g}, from another bank "
          f"{count(lambda x: OTHER_BANK.search(x[1]) is not None):g}, "
          f"from a uniform register "
          f"{count(lambda x: UNIFORM_REGISTER.search(x[1]) is not None):g}; the bound's "
          f"flops per step {flops:g}, {flops / 2:g} FMA equivalents")


def _issue_ms(n, per_entry, clock_hz):
    """The SMs' issue time (ms) of n^2 entries of ``per_entry`` instructions
    each, one warp instruction a cycle on each of the 4 schedulers of 132
    SMs at ``clock_hz``: a lower bound where the count is right."""
    return float(n) * n / 32 * per_entry / (4 * 132 * clock_hz) * 1e3


def _print_hot_loops(n, clock_hz):
    """Print each HOT_LOOPS kernel's instructions per entry and two issue
    bounds for n^2 entries: the SMs issuing one warp instruction per cycle
    on each of the 4 schedulers of 132 SMs at ``clock_hz``, and the FP64
    pipe taking 2 cycles per warp instruction. Bounds from a static count,
    not times: they stay out of the kernels JSON line. Returns the mixes by
    label (None where not read)."""
    mixes = {}
    for label, lib, symbol, entries, defines, cls in HOT_LOOPS:
        mix = mixes[label] = _hot_loop_mix(lib, symbol, entries, defines, cls)
        if mix is None:
            print(f"[sass] {label}: hot loop not read (no cuobjdump or no loop found)")
            continue
        issue_ms = _issue_ms(n, mix["all"], clock_hz)
        fp64_ms = float(n) * n / 32 * mix["fp64"] * 2 / (4 * 132 * clock_hz) * 1e3
        print(f"[sass] {label} hot loop, instructions per entry: "
              + ", ".join(f"{k} {c:g}" for k, c in mix.items())
              + f"; issue bound {issue_ms:.4f} ms at n={n}, FP64 pipe bound {fp64_ms:.4f} ms")
    return mixes


def _f32_distance_control(us64, v):
    """d2exp32 with the distance formed in float32, as a kernel that lost
    the FP64 distance would form it: the control check 12b's limit must
    reject. Plain torch, row block by row block."""
    u32, out = us64.float(), torch.empty(len(v), dtype=torch.float32, device=v.device)
    for blk in df64._row_blocks(len(v), len(v)):
        dist = sum((u32[blk, k][:, None] - u32[:, k][None, :]) ** 2 for k in range(u32.shape[1]))
        out[blk] = torch.exp(-0.5 * dist) @ v
    return out


D2EXP32_TOL = 1e-6  # P2 d2exp32 vs plain, per entry of sum_j |e_ij| |v_j|
D2EXP32_SHIFT = 1e4  # added to the coordinates by check 12b's distance test


def phase_probe_checks(n):
    """P1-P3 against their plain versions on the card: P1 bit for bit in
    every dtype, mode and chain count at the copies its path launches;
    every P2 variant at n, and d2exp32 again on coordinates shifted by
    D2EXP32_SHIFT, where only an FP64 distance keeps it within its limit;
    P3's class sums on one 16 x 8 tile exactly, then its matvec at n against
    its plain version and against B3. Returns the max abs errors by kernel."""
    mismatches, p1_err = 0, 0.0
    for dtype in vpu_probe.DTYPES:
        x = vpu_probe.make_tile(dtype, CUDA)
        for mode in vpu_probe.MODES:
            for n_chains in vpu_probe.CHAINS:
                k = vpu_probe.issue_probe(x, 128, n_chains, mode)
                p = vpu_probe._probe_reference(x, 128, n_chains, mode)
                both_nan = k.isnan() & p.isnan()
                mismatches += int((~((k == p) | both_nan)).sum())
                diff = (k.double() - p.double()).abs()[~both_nan]
                p1_err = max(p1_err, float(diff.max()) if diff.numel() else 0.0)
    torch.cuda.synchronize()
    print(f"[check 12a] P1 at {vpu_probe.REPS} copies: {mismatches} of {2 * 4 * 4 * 128 * 128} "
          f"values differ from the plain version over 2 dtypes x 4 modes x 4 chain counts, max "
          f"abs err {p1_err:.3e} (bit for bit expected)")
    if mismatches or p1_err != 0.0:
        raise RuntimeError(f"check 12a: P1 differs from its plain version in {mismatches} values "
                           f"(max abs err {p1_err})")

    errs = {"P1": p1_err}
    uh, ul, us, v = df64_ablate.make_inputs(n, CUDA)
    worst = {}
    for fn in ("d2", "d2exp32", "d2exp", "noexp", "full"):
        ref = df64_ablate._ablate_reference(us, v, fn)
        scale = df64_ablate._ablate_reference(us, v.abs(), fn)
        tol = D2EXP32_TOL if fn == "d2exp32" else DF64_TOL
        for variant in df64_ablate.VARIANTS:
            if df64_ablate.function_of(variant) != fn:
                continue
            got = df64_ablate.sqexp_ablate(us, v, variant)
            max_abs, rel = _scaled_err(got, ref, scale)
            worst[variant] = (max_abs, rel)
            if not (rel <= tol and bool(torch.isfinite(got).all())):
                raise RuntimeError(f"check 12b: P2 {variant} disagrees with its plain version "
                                   f"({rel}, limit {tol:g})")
        if fn == "d2exp32":
            # the shift moves the FP64 distances by ~1e-12, so the plain
            # version's result stands; float32 holds a coordinate near 1e4
            # only to 5e-4
            shifted = df64_ablate.sqexp_ablate(us + D2EXP32_SHIFT, v, fn)
            _, shift_rel = _scaled_err(shifted, ref, scale)
            _, control_rel = _scaled_err(_f32_distance_control(us + D2EXP32_SHIFT, v), ref, scale)
            print(f"[check 12b] P2 d2exp32 on coordinates shifted by {D2EXP32_SHIFT:g}: max err / "
                  f"sum|e||v| {shift_rel:.3e}; the float32-distance control {control_rel:.3e} "
                  f"(limit {D2EXP32_TOL:g}: the kernel within, the control beyond)")
            if not (shift_rel <= D2EXP32_TOL < control_rel):
                raise RuntimeError(f"check 12b: d2exp32 shifted {shift_rel}, control "
                                   f"{control_rel}, limit {D2EXP32_TOL:g}")
        del ref, scale
    print(f"[check 12b] P2 n={n}, max err / sum|term||w| (max abs err) by variant, limit "
          f"{DF64_TOL:g} (d2exp32 {D2EXP32_TOL:g}): "
          + ", ".join(f"{k} {r:.2e} ({a:.2e})" for k, (a, r) in worst.items()))
    errs["P2"] = worst["full"][0]

    errs["P3"] = {}
    for d in P3_D:
        if d == 2:
            p3_in = (uh, ul, us, v)
        else:
            wh, wl, ws = _wide_coords(n, d, 24)
            p3_in = (wh, wl, ws, v)
        errs["P3"][d] = _p3_checks(n, d, *p3_in)
    _p3_checks(P3_STREAMED_N, P3_STREAMED_D,
               *words.make_coords(P3_STREAMED_N, P3_STREAMED_D, CUDA, seed=3))
    return errs


def _p3_checks(n, d, uh, ul, us, v):
    """Checks 12c and 12d of P3 at n and d: the class sums and the parts of
    S of one 32 x 16 tile exactly, on the data and on words of +-64; the matvec
    within DF64_TOL of sum|E||v| of its plain version and 1e-11 of B3.
    Returns the max abs error against the plain version."""
    ops = words.prepare(us.cpu().numpy(), CUDA)
    W = np.random.default_rng(d).choice([-64, 64], (32, words.NW * d))
    big = dict(ops, **{k: torch.as_tensor(a, device=CUDA)
                       for k, a in zip(("rows", "cols"), words._operands(W, d))})
    differ, values = 0, 0
    for o in (ops, big):
        for got, ref in zip(words._launch_tile(o), words._tile_reference(o)):
            differ += int((got != ref).sum())
            values += ref.numel()
    torch.cuda.synchronize()
    print(f"[check 12c] P3 d={d}: one 32 x 16 tile of the 7 class sums and the "
          f"{len(words.parts(d))} parts of S, on the data and on words of +-64: {differ} of "
          f"{values} differ (exact expected)")
    if differ:
        raise RuntimeError(f"check 12c: P3's fragments or fold are wrong at d={d}")
    got = words.words_matvec(ops, v)
    scale = df64._fused_reference(us, us, v.abs()[:, None])[:, 0]
    b3 = df64.sqexp_matvec_df64(uh, ul, v)
    max_abs, rel = _scaled_err(got, words._words_reference(ops, v), scale)
    b3_abs, b3_rel = _scaled_err(got, b3, scale)
    print(f"[check 12d] P3 n={n} d={d}: against its plain version max abs err {max_abs:.3e}, max "
          f"err / sum|E||v| {rel:.3e} (limit {DF64_TOL:g}); against B3 {b3_abs:.3e}, {b3_rel:.3e} "
          f"(limit 1e-11)")
    if not (rel <= DF64_TOL and b3_rel <= 1e-11 and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"check 12d: P3 disagrees at d={d} ({rel}, against B3 {b3_rel})")
    return max_abs


def phase_probe_paths(n):
    """The probes' own entry points, each with its launch count set to 0
    just before and read just after: P1 (the SM clock under load, then every
    dtype, mode and chain count at 512 copies of the tile), P2 (every variant
    and B3 at n) and P3 (the error against the float64 truth and the time
    beside B3 at n). Then the plain versions timed on the same inputs."""
    vpu_probe.KERNEL_LAUNCHES = 0
    mhz, watts, samples = vpu_probe.sm_clock_under_load()
    p1 = vpu_probe.run(CUDA, clock_hz=mhz * 1e6)
    launches = {"P1": vpu_probe.KERNEL_LAUNCHES}
    print(f"[probe P1] SM clock under the float64 load {mhz:.0f} MHz (median of {samples} "
          f"nvidia-smi samples), power draw up to {watts:.1f} W")
    mixes = _print_hot_loops(n, mhz * 1e6)
    for r in p1:
        print(f"[probe P1] {r['dtype']} {r['mode']:9s} chains={r['chains']}: {r['ms']:.4f} ms, "
              f"{r['gflops']:.1f} GFLOP/s, {r['cycles_per_warp_instr']:.3f} SM cycles per warp "
              f"instruction, bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%})")

    df64_ablate.KERNEL_LAUNCHES = 0
    p2 = df64_ablate.run(n, CUDA)
    launches["P2"] = df64_ablate.KERNEL_LAUNCHES
    p3 = {}
    for d in P3_D:
        words.KERNEL_LAUNCHES = 0
        p3[d] = words.run(n, CUDA, d=d)
        launches[f"P3 d={d}"] = words.KERNEL_LAUNCHES
    print(f"[probe] launches on the probes' paths: {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a probe's path launched its kernel no time: {launches}")

    uh, ul, us, v = df64_ablate.make_inputs(n, CUDA)
    plain = {fn: time_events(df64_ablate._ablate_reference, (us, v, fn), 1)
             for fn in ("d2", "d2exp32", "d2exp", "noexp", "full")}
    for r in p2:
        fn = "full" if r["variant"] == "B3" else df64_ablate.function_of(r["variant"])
        r["plain_ms"] = plain[fn]
        print(f"[probe P2] {r['variant']:8s}: {r['ms']:.4f} ms ({r['ps_per_entry']:.4f} ps/entry), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['ms'] / r['bound_ms']:.2f}x; "
              f"plain version {r['plain_ms']:.4f} ms")
    for d in P3_D:
        r = p3[d]
        mix = mixes[f"P3 d={d}"]
        if mix is None or mix["inner_loops"]:
            raise RuntimeError(f"P3 d={d}: the hot loop's SASS was not read, or holds an inner "
                               f"loop ({P3_SYMBOL}: {mix})")
        r["fp64_per_entry"] = mix["fp64"]
        r["fp64_issue_ms"] = fp64_issue_ms(n, mix["fp64"], mhz * 1e6)
        issue = _issue_ms(n, mix["all"], mhz * 1e6)
        r["plan"] = words.plan(n, d, CUDA)
        _, _, us_d, v_d = words.make_coords(n, d, CUDA)
        r["plain_ms"] = time_events(words._words_reference, (words.prepare(us_d.cpu().numpy(),
                                                                            CUDA), v_d), 1)
        print(f"[probe P3] n={n} d={d}: {r['ms']:.4f} ms beside B3's {r['b3_ms']:.4f} ms "
              f"({r['ms'] / r['b3_ms']:.3f}x); flops bound {r['bound_ms']:.4f} ms "
              f"({words.words_bound(n, d)[0]:.4f} ms of FP64 flops; {r['ms'] / r['bound_ms']:.2f}x); "
              f"models, not times: FP64-issue time {r['fp64_issue_ms']:.4f} ms "
              f"({r['fp64_per_entry']:g} FP64 instructions per entry from the SASS, "
              f"{mhz:.0f} MHz; {r['ms'] / r['fp64_issue_ms']:.2f}x), issue time of the hot loop "
              f"{issue:.4f} ms ({mix['all']:g} instructions per entry), tensor-core time "
              f"{r['tensor_ms']:.4f} ms ({words.layout(d)[2]} int8 MACs per entry at 989.5e12 "
              f"MAC/s; {r['ms'] / r['tensor_ms']:.2f}x); plain version {r['plain_ms']:.4f} ms; "
              f"error against the float64 truth {r['err']:.3e} (B3 {r['b3_err']:.3e}) of max "
              f"|y|; words built on the host in {r['build_s']:.3f} s; plan {r['plan']}")
        if issue > r["ms"]:
            raise RuntimeError(f"P3 d={d}: the hot loop's issue time {issue} ms exceeds the "
                               f"measured {r['ms']} ms, so its SASS was misread")
        if not r["err"] <= 1e-11:
            raise RuntimeError(f"P3 is {r['err']} off the float64 truth at d={d}")
    x = vpu_probe.make_tile(torch.float64, CUDA)
    p1_plain = time_events(vpu_probe._probe_reference, (x, 128, 8, "vv", vpu_probe.REPS), 1)
    print(f"[probe P1] plain version, float64 vv 8 chains at {vpu_probe.REPS} copies: "
          f"{p1_plain:.4f} ms")
    return {"P1": p1, "P2": p2, "P3": p3, "p1_plain_ms": p1_plain, "launches": launches,
            "clock_mhz": mhz, "power_w": watts}


# ---------------------------------------------------------------------------
# A10: the batched BFGS, the on-device GP fit and Bayesian optimisation
# ---------------------------------------------------------------------------

BFGS_STARTS = 64
FIT_N = 4096  # gp-fit-device-4k: phase 8's data
FIT_STARTS = 16
# the card's fused proposal against the CPU's, from one state, held stage by
# stage where each stage is well posed. The fit's starts end where JAX's zoom
# line search fails, on a surface so flat that roundoff alone moves the
# argmax: y scaled by 1 + 1e-15 moves theta and the proposal's acquisition
# objective on the CPU alone by as much as the card moves them, so both are
# readings, printed beside that CPU spread. Held: the card's
# fit no worse in LML than the CPU's (BO_TWIN_LML_RTOL of it); at the card's
# theta, the CPU's L and alpha, the acquisition at the card's proposal and
# the history entry under the old state (BO_TWIN_RTOL); the card's proposal
# no worse than the CPU's multistart from the same clouds under that state
# (BO_TWIN_RTOL of it)
BO_TWIN_RTOL, BO_TWIN_LML_RTOL = 1e-10, 1e-9
# timed warm iterations in float32 (the bench's 10, cut to fit the script's
# time); float64 keeps 10: its twin is held at that state
BO_WARM_ITERATIONS_F32 = 5
BO_TWIN_Y_SCALE = 1.0 + 1e-15


def _bfgs_problems(device):
    """bfgs-card's problems on ``device`` in float64: 64 starts (uniform on
    [-2, 2]^2) of the 2D Rosenbrock and 64 (standard normal) of a 10-dim SPD
    quadratic with eigenvalues 0.5-1.5."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(10, 10)))
    t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
    A, b = t(Q @ np.diag(np.linspace(0.5, 1.5, 10)) @ Q.T), t(rng.normal(size=10))
    rosen = lambda X: (1 - X[:, 0]) ** 2 + 100 * (X[:, 1] - X[:, 0] ** 2) ** 2
    quad = lambda X: 0.5 * ((X @ A) * X).sum(dim=1) - X @ b
    return {"quadratic": (quad, t(rng.normal(size=(BFGS_STARTS, 10)))),
            "rosenbrock": (rosen, t(rng.uniform(-2, 2, (BFGS_STARTS, 2))))}


def phase_bfgs_card():
    """bfgs-card: ``utils.optimize.minimize_bfgs`` on the card against the
    same code on the CPU, 64 starts of each problem. Every quadratic row
    converges (status 0); on Rosenbrock JAX's BFGS, which the port follows
    step for step, ends rows with status 3 where its zoom fails, so there
    each row's status must equal the CPU's. x within 1e-10 (quadratic) and
    1e-6 (Rosenbrock) of the CPU's."""
    t_phase = time.perf_counter()
    _reset_launches()
    card, cpu = _bfgs_problems(CUDA), _bfgs_problems("cpu")
    out = {}
    for name, tol in (("quadratic", 1e-10), ("rosenbrock", 1e-6)):
        fn, x0 = card[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = minimize_bfgs(fn, x0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ref = minimize_bfgs(*cpu[name])
        status, status_cpu = res.status.cpu().numpy(), ref.status.numpy()
        dx = float((res.x.cpu() - ref.x).abs().max())
        counts = {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))}
        print(f"[bfgs-card] {name}, {BFGS_STARTS} starts: {seconds:.3f} s, iterations max "
              f"{int(res.nit.max())} (mean {float(res.nit.double().mean()):.1f}), evaluations "
              f"max {int(res.nfev.max())}, {res.rounds} rounds, {res.host_reads} host reads; "
              f"status counts {counts} (CPU {status_cpu.tolist() == status.tolist()}), max "
              f"|x - x_cpu| {dx:.3e} (limit {tol:g}) (card: {SMI})")
        if not (status == status_cpu).all():
            raise RuntimeError(f"bfgs-card {name}: statuses differ from the CPU's")
        if name == "quadratic" and not (status == 0).all():
            raise RuntimeError(f"bfgs-card quadratic: statuses {counts}, all 0 expected")
        if not dx <= tol:
            raise RuntimeError(f"bfgs-card {name}: x differs from the CPU's by {dx}")
        out[name] = {"seconds": seconds, "nit_max": int(res.nit.max()),
                     "nfev_max": int(res.nfev.max()), "rounds": res.rounds,
                     "host_reads": res.host_reads, "status": counts, "max_dx_cpu": dx}
    _phase_line("bfgs-card", time.perf_counter() - t_phase)
    return out


def _profile_batched_evaluation(gp, thetas):
    """torch.profiler over one batched LML+gradient evaluation: wall and
    device ms, the device idle share, and the shares of B2, the Cholesky
    and its backward in the device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        optimize.value_and_grad(gp._batched_objective, thetas)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events if e.device_type == cuda) / 1e3
    b2 = sum(e.self_device_time_total for e in events
             if e.device_type == cuda and "sqexp" in e.key.lower()) / 1e3
    op = lambda key: sum(e.device_time_total for e in events
                         if e.device_type != cuda and e.key == key) / 1e3
    chol = op("aten::linalg_cholesky_ex")
    chol_bwd = sum(e.device_time_total for e in events if e.device_type != cuda
                   and "evaluate_function: LinalgCholeskyExBackward0" in e.key) / 1e3
    share = lambda v: 100 * v / max(device, 1e-9)
    print(f"[gp-fit-device-4k profile] one batched evaluation of {thetas.shape[0]} starts: "
          f"{wall:.3f} ms wall, {device:.3f} ms of device kernels (device idle "
          f"{100 * (1 - device / wall):.1f}%); B2 {b2:.3f} ms ({share(b2):.1f}%), the Cholesky "
          f"{chol:.3f} ms ({share(chol):.1f}%), its backward {chol_bwd:.3f} ms "
          f"({share(chol_bwd):.1f}%) (card: {SMI})")
    return {"wall_ms": wall, "device_ms": device, "b2_ms": b2, "cholesky_ms": chol,
            "cholesky_backward_ms": chol_bwd}


def phase_fit_device(lml_bfgs):
    """gp-fit-device-4k: ``fit_device(starts=16)`` at N = 4,096 in float64 on
    phase 8's data. The batched objective against the single-start one at
    4 thetas (1e-10), then the fit: its seconds, B2 launches (one per start
    and evaluation), iterations per start, peak memory, and the winner's
    LML at least phase 8's L-BFGS-B fit's less 1e-6 of it."""
    t_phase = time.perf_counter()
    x, y, err = make_gp_data(FIT_N)
    gp = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA)
    lo, hi = gp._hp_box()
    z = torch.as_tensor(np.random.default_rng(4).uniform(-1.5, 1.5, (4, 4)), dtype=F64,
                        device=CUDA)
    thetas = lo + (hi - lo) * torch.sigmoid(z)
    f, g = optimize.value_and_grad(gp._batched_objective, thetas)
    worst = 0.0
    for r in range(4):
        v1, g1 = gp.marginal_likelihood_gradient(thetas[r].cpu().numpy())
        worst = max(worst, abs(float(f[r]) - v1) / abs(v1),
                    float(np.abs(g[r].cpu().numpy() - g1).max() / np.abs(g1).max()))
    print(f"[gp-fit-device-4k check] the batched objective at 4 thetas against "
          f"marginal_likelihood_gradient one start at a time: max rel diff {worst:.3e} "
          f"(limit 1e-10)")
    if not worst <= 1e-10:
        raise RuntimeError(f"the batched objective disagrees with the single start ({worst})")

    runs = []
    real = optimize.minimize_bfgs

    def recording(*args, **kw):
        runs.append(real(*args, **kw))
        return runs[-1]

    _reset_launches()
    optimize.minimize_bfgs = recording  # the fit's two runs, by refined_multistart
    try:
        t0 = time.perf_counter()
        theta = gp.fit_device(starts=FIT_STARTS)
        seconds = time.perf_counter() - t0
    finally:
        optimize.minimize_bfgs = real
    launches = pairwise.KERNEL_LAUNCHES
    expected = sum(r.x.shape[0] * (r.rounds + 1) for r in runs)
    lml = gp.marginal_likelihood(theta)
    nit = runs[0].nit.cpu().numpy()
    print(f"[gp-fit-device-4k] fit_device(starts={FIT_STARTS}) at N={FIT_N}: {seconds:.3f} s, "
          f"LML {lml!r} at {theta.tolist()} (phase 8's L-BFGS-B fit {lml_bfgs!r}); "
          f"iterations per start {nit.tolist()}, statuses {runs[0].status.cpu().tolist()}, "
          f"refinement {int(runs[1].nit[0])} iterations; rounds {[r.rounds for r in runs]}, "
          f"host reads {[r.host_reads for r in runs]}; B2 launches {launches} (starts x "
          f"evaluations: {expected})")
    if launches == 0 or launches != expected:
        raise RuntimeError(f"fit_device launched B2 {launches} times, {expected} expected")
    if not lml >= lml_bfgs - 1e-6 * abs(lml_bfgs):
        raise RuntimeError(f"fit_device's LML {lml} is below the L-BFGS-B fit's {lml_bfgs}")
    peak = _phase_line("gp-fit-device-4k", time.perf_counter() - t_phase)
    prof = _profile_batched_evaluation(gp, (lo + (hi - lo) * torch.sigmoid(torch.zeros(
        FIT_STARTS, 4, dtype=F64, device=CUDA))).contiguous())
    del gp
    _free()
    return {"seconds": seconds, "lml": lml, "lml_bfgs": lml_bfgs, "theta": theta.tolist(),
            "b2_launches": launches, "nit": nit.tolist(), "refine_nit": int(runs[1].nit[0]),
            "rounds": [r.rounds for r in runs], "host_reads": [r.host_reads for r in runs],
            "peak_gib": peak, "batched_vs_single_rel": worst, "profile": prof,
            "b2": _time_fit_block(x, theta)}


def _time_fit_block(x, theta):
    """B2 at the fit's block (4,096 x 4,096, D = 2, float64, the fit's
    theta) in turns with its plain version (plain, kernel, plain, kernel),
    beside cdist and the exp and its store bound; the kernel held to the
    plain version (B2_RTOL). These launches come after the fit's count."""
    u, amp, ls = _gp_operands(x, F64, theta)
    args = (u, u, amp, ls)
    err = _errors(pairwise._launch_sqexp(*args), pairwise._sqexp_reference(*args))
    plain = [time_events(pairwise._sqexp_reference, args, 5)]
    kern = [time_events(pairwise._launch_sqexp, args, 50)]
    plain.append(time_events(pairwise._sqexp_reference, args, 5))
    kern.append(time_events(pairwise._launch_sqexp, args, 50))
    lib = time_events(_cdist_exp, args, 10)
    m, d = u.shape
    b_ms, b_by = bound(8 * (m * m + 2 * m * d), m * m * (3 * d + 2 + EXP_FLOPS), FP64_FLOPS)
    print(f"[gp-fit-device-4k time] B2 at the fit's block, {m}x{m} D={d} float64: kernel "
          f"{kern[0]:.4f} / {kern[1]:.4f} ms, plain version {plain[0]:.4f} / {plain[1]:.4f} ms "
          f"(plain, kernel, plain, kernel), cdist + exp {lib:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), kernel / bound {min(kern) / b_ms:.2f}; against the plain version max abs "
          f"{err[0]:.3e}, max rel {err[1]:.3e} (limit {B2_RTOL[F64]:g}) (card: {SMI})")
    if not err[1] <= B2_RTOL[F64]:
        raise RuntimeError(f"B2 at the fit's block disagrees with its plain version ({err})")
    return {"ms": min(kern), "plain_ms": min(plain), "cdist_exp_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err[0], "max_rel_err": err[1]}


def _profile_bo_iteration(opt):
    """torch.profiler over one warm BO iteration: wall and device ms, the
    device idle share and the device events (kernels, copies) it ran. Device
    activity only, summed from the raw trace: the ~9e4 events of an
    iteration took ``key_averages`` ~25 s to parse (PR 16, call 2)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bo_warm.iterate(opt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    device = sum(e.end_ns() - e.start_ns() for e in events) / 1e6
    return {"wall_ms": wall, "device_ms": device, "idle_pct": 100 * (1 - device / wall),
            "kernel_launches": len(events)}


def _state_vs_refit(opt):
    """Max relative difference of the GP's adopted L and alpha from an
    explicit set_hyperparameters at the same theta."""
    L, alpha = opt.gp.L.clone(), opt.gp.alpha.clone()
    opt.gp.set_hyperparameters(opt.gp.hyperpars.copy())
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    return max(rel(L, opt.gp.L), rel(alpha, opt.gp.alpha))


def _bo_twin_check(opt):
    """The fused proposal from one state on the card and on the CPU: the
    state read off ``opt``, one evaluation added to each twin, their clouds
    from one seeded generator. Held stage by stage (``BO_TWIN_RTOL``,
    ``BO_TWIN_LML_RTOL``): the fit's LML, then the CPU at the card's theta
    (L and alpha, its multistart from the same clouds, the acquisition at
    the card's proposal) and the history entry. Theta and the proposal are
    printed beside a second CPU run on y scaled by ``BO_TWIN_Y_SCALE``."""
    state = gp_optimiser_state_of(opt)
    xq = np.array([2.0, 4.0])
    yq = bo_warm.objective(xq)

    def propose(dev, y_scale=1.0):
        twin = gp_optimiser_from_state(dict(state, y=state["y"] * y_scale), device=dev,
                                       dtype=F64)
        twin.add_evaluation(xq, yq)
        twin.acquisition.rng = np.random.default_rng(99)
        x_prop, f_prop = twin._fused_propose()
        return twin, twin.gp.hyperpars.copy(), x_prop, f_prop

    card, theta_c, x_c, f_c = propose(CUDA)
    cpu, theta_h, x_h, f_h = propose("cpu")
    _, theta_p, x_p, f_p = propose("cpu", BO_TWIN_Y_SCALE)
    rel = lambda a, b: float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())

    # the fit: the card's optimum no worse than the CPU's
    lml_c, lml_h = (cpu.gp.marginal_likelihood(t) for t in (theta_c, theta_h))
    lml_short = (lml_h - lml_c) / abs(lml_h)
    # the CPU at the card's theta: the state, its multistart from the same
    # clouds, the acquisition at the card's proposal
    with torch.no_grad():
        (_, _, L_h, alpha_h), st_h = cpu._state_at(torch.as_tensor(theta_c, dtype=F64))
        state_rel = max(rel(card.gp.L.cpu().numpy(), L_h.numpy()),
                        rel(card.gp.alpha.cpu().numpy(), alpha_h.numpy()))
        cpu.acquisition.rng = np.random.default_rng(99)
        cand = cpu.acquisition._tensor(cpu._candidate_clouds())
        f_at_c = float(cpu.acquisition.score(cpu.acquisition._tensor(x_c)[None], st_h)[0])
    f_ms = float(cpu._cloud_multistart(cand, st_h)[1])
    at_rel = abs(f_at_c - f_c) / abs(f_c)
    f_short = (f_c - f_ms) / abs(f_ms)
    hist_rel = rel(card.acquisition_max_history[-1], cpu.acquisition_max_history[-1])
    readings = {"theta_rel": rel(theta_c, theta_h), "theta_rel_cpu_spread": rel(theta_p, theta_h),
                "objective_rel": abs(f_c - f_h) / abs(f_h),
                "objective_rel_cpu_spread": abs(f_p - f_h) / abs(f_h)}
    print(f"[bo-warm-2d twin] one fused proposal from one state, card vs CPU: the fit's LML "
          f"{lml_c!r} / {lml_h!r} (card short by {lml_short:.3e}, limit {BO_TWIN_LML_RTOL:g}); at "
          f"the card's theta, L and alpha {state_rel:.3e}, the acquisition at the card's "
          f"proposal {f_at_c!r} / {f_c!r} ({at_rel:.3e}), the CPU's multistart from the same "
          f"clouds {f_ms!r} (card short by {f_short:.3e}); the history entry {hist_rel:.3e} "
          f"(limits {BO_TWIN_RTOL:g}). Readings: theta card {theta_c.tolist()} CPU "
          f"{theta_h.tolist()} (max rel diff {readings['theta_rel']:.3e}; the CPU on y x "
          f"(1 + 1e-15) {readings['theta_rel_cpu_spread']:.3e}), the proposal's objective "
          f"{f_c!r} / {f_h!r} ({readings['objective_rel']:.3e}; the CPU on y x (1 + 1e-15) "
          f"{readings['objective_rel_cpu_spread']:.3e}), proposals {x_c.tolist()} / "
          f"{x_h.tolist()} / {x_p.tolist()}")
    if not (lml_short <= BO_TWIN_LML_RTOL
            and max(state_rel, at_rel, f_short, hist_rel) <= BO_TWIN_RTOL):
        raise RuntimeError(f"the card's fused proposal differs from the CPU's (LML short by "
                           f"{lml_short}, state {state_rel}, acquisition {at_rel}, multistart "
                           f"short by {f_short}, history {hist_rel})")
    return {"lml_short": lml_short, "state_rel": state_rel, "acquisition_rel": at_rel,
            "multistart_short": f_short, "history_rel": hist_rel, **readings}


def phase_bo_warm():
    """bo-warm-2d: ``bench.bo_warm`` (``benchmarks/bo_warm_bench.py``'s
    configuration) on the card in float64, then float32 (the fit's jitter
    path): warm-iteration seconds, kernel launches and host reads an
    iteration, one iteration profiled; every proposal inside the bounds,
    the histories one entry per added point, the adopted state equal to an
    explicit refit (1e-10, float64) after a fused proposal and after a
    public read, and in float64 one fused proposal held to the CPU's."""
    out = {}
    for dtype in (F64, torch.float32):
        t_phase = time.perf_counter()
        _reset_launches()
        reads0 = optimize.COUNTS["host_reads"]
        iterations = bo_warm.ITERATIONS if dtype == F64 else BO_WARM_ITERATIONS_F32
        result, opt = bo_warm.measure(CUDA, iterations=iterations, dtype=dtype)
        n_iter = bo_warm.WARMUP + iterations
        reads = (optimize.COUNTS["host_reads"] - reads0) / n_iter
        prof = _profile_bo_iteration(opt)
        added = opt.x[bo_warm.N_START:]
        if not ((added >= 0.0) & (added <= 6.0)).all():
            raise RuntimeError("a proposal left the bounds")
        opt.propose_evaluation()  # the fused proposal settles the last add
        fused_rel = _state_vs_refit(opt)
        xq = np.array([1.0, 5.0])
        opt.add_evaluation(xq, bo_warm.objective(xq))
        n_hist = len(opt.iteration_history)  # a public read settles the refit
        read_rel = _state_vs_refit(opt)
        hist_ok = (n_hist == opt.y.size - bo_warm.N_START == len(opt.acquisition_max_history)
                   == len(opt.convergence_metric_history)
                   and opt.iteration_history[-1] == opt.y.size)
        label = str(dtype).rsplit(".", 1)[-1]
        w = result["warm_iteration_s"]
        print(f"[bo-warm-2d {label}] warm iteration median {w['median']:.3f} s, min "
              f"{w['min']:.3f} s, max {w['max']:.3f} s over {iterations}; best objective "
              f"{result['best_objective']!r}; host reads an iteration {reads:.1f}; one iteration "
              f"profiled: {prof['wall_ms']:.1f} ms wall, {prof['device_ms']:.1f} ms of device "
              f"kernels (idle {prof['idle_pct']:.1f}%), {prof['kernel_launches']} kernel "
              f"launches; state vs an explicit refit after a fused proposal {fused_rel:.3e}, "
              f"after a public read {read_rel:.3e}; histories {n_hist} entries for "
              f"{opt.y.size - bo_warm.N_START} added points ({hist_ok})")
        if not hist_ok:
            raise RuntimeError("the histories do not hold one entry per added point")
        if dtype == F64 and not max(fused_rel, read_rel) <= 1e-10:
            raise RuntimeError(f"the adopted state differs from an explicit refit "
                               f"({fused_rel}, {read_rel})")
        twin = _bo_twin_check(opt) if dtype == F64 else None
        _phase_line(f"bo-warm-2d {label}", time.perf_counter() - t_phase)
        out[label] = {**result, "host_reads_per_iteration": reads, "profile": prof,
                      "state_vs_refit": [fused_rel, read_rel], "twin": twin}
        del opt
        _free()
    return out


def phase_bo_demo():
    """bo-demo-1d: ``demos/gp_optimisation_demo.py``'s loop on the card (3
    points, 8 iterations, optimizer="device", the default dtype); the best
    value within 0.05 of the grid maximum (``tests/gp/test_GpOptimiser.py``'s
    limit)."""
    t_phase = time.perf_counter()

    def expensive_objective(x):
        return -np.sin(3 * x) - 0.4 * (x - 2.0) ** 2 + 2.0

    x = np.array([0.5, 2.0, 3.8])
    opt = GpOptimiser(x, expensive_objective(x), bounds=[(0.0, 4.0)], optimizer="device",
                      device=CUDA)
    for _ in range(8):
        new_x = float(np.atleast_1d(opt.propose_evaluation())[0])
        opt.add_evaluation(np.array([new_x]), np.array([expensive_objective(new_x)]))
    best, true_max = float(opt.y.max()), float(expensive_objective(np.linspace(0, 4, 2000)).max())
    seconds = time.perf_counter() - t_phase
    print(f"[bo-demo-1d] 8 iterations ({str(opt.gp._dtype)[6:]}): best {best!r}, grid maximum "
          f"{true_max!r} (limit 0.05 below), proposals {opt.x[3:, 0].tolist()}")
    if not best > true_max - 0.05:
        raise RuntimeError(f"the demo's loop ended at {best}, grid maximum {true_max}")
    _phase_line("bo-demo-1d", seconds)
    return {"seconds": seconds, "best": best, "grid_max": true_max}


def _probe_rows(probe, errs):
    """The probes' entries of the kernels JSON line: each headline (P1 float64
    vv with 8 chains, P2 full, P3) with every configuration beside it."""
    src = "inference_tpu_torch/ops/csrc/"
    p1 = next(r for r in probe["P1"] if r["dtype"] == "float64" and r["mode"] == "vv"
              and r["chains"] == 8)
    full = next(r for r in probe["P2"] if r["variant"] == "full")
    p3 = probe["P3"]
    return [{
        "name": "issue_probe_kernel<double, vv, 8 chains>", "route": "cuda",
        "source": src + "issue_probe.cu", "replaces": "benchmarks/vpu_probe.py:37",
        "launches": probe["launches"]["P1"], "max_abs_err": errs["P1"], "ms": p1["ms"],
        "plain_ms": probe["p1_plain_ms"], "bound_ms": p1["bound_ms"], "bound_by": "operations",
        "library_ms": None, "sm_clock_mhz": probe["clock_mhz"], "power_w": probe["power_w"],
        "configs": [{k: r[k] for k in ("dtype", "mode", "chains", "ms", "bound_ms",
                                       "cycles_per_warp_instr")} for r in probe["P1"]],
    }, {
        "name": "sqexp_ablate_kernel<full>", "route": "cuda", "source": src + "sqexp_ablate.cu",
        "replaces": "benchmarks/df64_ablate.py:46", "launches": probe["launches"]["P2"],
        "max_abs_err": errs["P2"], "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"], "library_ms": None,
        "variants": {r["variant"]: {k: r[k] for k in ("ms", "bound_ms", "plain_ms")}
                     for r in probe["P2"]},
    }, {
        "name": "sqexp_words_mma_kernel", "route": "cuda", "source": src + "sqexp_words_mma.cu",
        "replaces": "benchmarks/df64_mxu_d2_experiment.py:72",
        "launches": sum(probe["launches"][f"P3 d={d}"] for d in P3_D),
        "max_abs_err": max(errs["P3"].values()), "ms": p3[2]["ms"], "plain_ms": p3[2]["plain_ms"],
        "bound_ms": p3[2]["bound_ms"], "bound_by": p3[2]["bound_by"], "library_ms": None,
        "per_d": {d: {"launches": probe["launches"][f"P3 d={d}"], "max_abs_err": errs["P3"][d],
                      **{k: p3[d][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "b3_ms", "err", "plan")}}
                  for d in P3_D},
    }]


def main():
    t_start = time.perf_counter()
    name, smi = phase_device()
    torch.set_default_dtype(torch.float32)
    phase_build()
    max_err = _compare("3a", N_DIM, N_CHAINS, 1, False, 1.0, None, 11)
    if max_err != 0.0:
        raise RuntimeError(f"check 3a: B1 differs from its plain version by {max_err} "
                           "(bit for bit expected)")
    _compare("3b", N_DIM, N_CHAINS, 64, True, 1.0, None, 12)
    im = np.random.default_rng(5).uniform(0.5, 2.0, 32)
    _compare("3c", 32, 4096, 1, False, 0.5, im, 13)
    _compare("3d", 1, N_CHAINS, 1, False, 1.0, None, 14)
    _compare("3e", 32, N_CHAINS, 1, False, 1.0, None, 15)
    _compare("3f", 64, 16384, 1, False, 1.0, None, 16)
    for P in (10, 32):
        _print_b1_leapfrog_mix(P)
    b1 = {P: _time_chunk(P, plain=P == N_DIM)[:4] for P in B1_TIME_P}
    ms, plain_ms, b1_bound, b1_by = b1[N_DIM]
    launches, attempts, accept = phase_main_path()
    _, sweep = phase_headline()
    plain_attempts = phase_plain_path()
    print(f"[summary] attempts/s: kernel path {attempts:,.0f}, plain path "
          f"{plain_attempts:,.0f} ({attempts / plain_attempts:.2f}x)")
    t_new = time.perf_counter()
    wide_err, wide, wide_chains = phase_b1_wide()
    t_dense = time.perf_counter()
    dense = phase_dense_hmc()
    t_chain = time.perf_counter()
    hc_rates = phase_hamiltonian()
    t_end = time.perf_counter()
    print(f"[summary] B1 wide {t_dense - t_new:.1f} s, dense HMC {t_chain - t_dense:.1f} s, "
          f"HamiltonianChain {t_end - t_chain:.1f} s; HamiltonianChain transitions/s: card "
          f"{hc_rates['cuda']:.2f}, CPU {hc_rates['cpu']:.2f}")
    gibbs10 = phase_gibbs_10d()
    t_rosen = time.perf_counter()
    rosen, cpu_gibbs = phase_gibbs_rosenbrock()
    t_a1 = time.perf_counter()
    a1 = phase_a1_numpy(cpu_gibbs)
    t_metro = time.perf_counter()
    print(f"[summary] the Metropolis family: gibbs-10d {t_rosen - t_end:.1f} s, gibbs-rosenbrock "
          f"{t_a1 - t_rosen:.1f} s, a1-numpy {t_metro - t_a1:.1f} s ({t_metro - t_end:.1f} s in "
          f"all)")
    print(json.dumps({"metropolis_family": {"gibbs-10d": gibbs10, "gibbs-rosenbrock": rosen,
                                            "a1-numpy": a1}}))
    _free()
    t_pt = time.perf_counter()
    tempering = {"pt-bimodal-8": phase_pt_bimodal(), "pt-demo-6": phase_pt_demo(),
                 "pt-hmc-2": phase_pt_hmc(), "pt-pca-4": phase_pt_pca()}
    t_ens = time.perf_counter()
    ensemble = {"ensemble-4096": phase_ensemble(), "ensemble-chains": phase_ensemble_chains()}
    print(json.dumps({"tempering_ensemble": {**tempering, **ensemble}}, default=float))
    print(f"[summary] parallel tempering {t_ens - t_pt:.1f} s, the ensemble sampler "
          f"{time.perf_counter() - t_ens:.1f} s (card: {SMI})")
    _free()
    t_nuts = time.perf_counter()
    nuts10, kde_draws = phase_nuts_10d()
    nuts = {"nuts-10d": nuts10, "nuts-twin": phase_nuts_twin(), "nuts-demo": phase_nuts_demo(),
            "pt-nuts-3": phase_pt_nuts()}
    t_kde = time.perf_counter()
    kde_marginal = phase_kde_marginal(*kde_draws)
    print(json.dumps({"nuts_pdf": {**nuts, "kde-marginal": kde_marginal}}, default=float))
    print(f"[summary] NUTS (nuts-10d, nuts-twin, nuts-demo, pt-nuts-3) {t_kde - t_nuts:.1f} s, "
          f"kde-marginal {time.perf_counter() - t_kde:.1f} s (card: {SMI})")
    del kde_draws
    _free()

    x16k, y16k, err16k = make_gp_data(GP_N)
    b2_err = phase_b2_checks(x16k)
    b2_ms = phase_b2_timing(x16k)
    b2_launches, evals, evals_a = phase_gp_main(x16k, y16k, err16k)
    lml_bfgs = phase_gp_fit_predict()
    print(f"[summary] gp-16k float64 LML+grad evals/s: {evals:.4f} (cholesky='auto'), "
          f"{evals_a:.4f} (cholesky='analytic')")
    _free()
    t_a10 = time.perf_counter()
    bo = {"bfgs-card": phase_bfgs_card(), "gp-fit-device-4k": phase_fit_device(lml_bfgs),
          "bo-warm-2d": phase_bo_warm(), "bo-demo-1d": phase_bo_demo()}
    print(json.dumps({"gp_optimisation": bo}, default=float))
    print(f"[summary] A10 (bfgs-card, gp-fit-device-4k, bo-warm-2d, bo-demo-1d) in "
          f"{time.perf_counter() - t_a10:.1f} s (card: {SMI})")
    print(f"[summary] HMC and dense GP phases done at {time.perf_counter() - t_start:.1f} s")

    print(f"[summary] device memory allocated after those phases: {_free():.2f} GiB")
    xpad = _padded(make_large_data(LARGE_N)[0])
    df64_err, operands = phase_df64_checks(xpad)
    for kernel, err in phase_df64_wide_checks().items():
        df64_err[kernel] = max(df64_err[kernel], err)
    df64_ms = phase_df64_timing(operands)
    del operands
    torch.cuda.empty_cache()
    wide_ms = phase_df64_wide_timing(len(xpad))
    large_launches, runs = phase_large_main()
    d20_runs, d20_launches = phase_large_d20()
    phase_large_16k()
    t_a11 = time.perf_counter()
    b2_cg = phase_b2_cg_block()
    cg_runs, cg_launches = phase_large_cg()
    fit16k = phase_large_fit()
    rq = phase_rq()
    inv_runs, inv_launches = phase_inversion_50k()
    inv8k = phase_inversion_8k()
    print(json.dumps({"matrix_free_gp": {
        "gp-large-cg-50k": cg_runs, "gp-large-fit-16k": fit16k, "rq-16k": rq,
        "inv-50k": inv_runs, "inv-8k": inv8k}}, default=float))
    print(f"[summary] the cg/mixed tiers, fit(), RQ and the inverter (gp-large-cg-50k, "
          f"gp-large-fit-16k, rq-16k, inv-50k, inv-8k) in {time.perf_counter() - t_a11:.1f} s "
          f"(card: {SMI})")
    t_probes = time.perf_counter()
    probe_err = phase_probe_checks(len(xpad))
    probe = phase_probe_paths(len(xpad))
    print(f"[summary] probes P1-P3 in {time.perf_counter() - t_probes:.1f} s")
    print(f"[summary] gp-large-50k warm solve: {runs['auto']['warm_s']:.3f} s with the FP64 "
          f"store (B6), {runs[False]['warm_s']:.3f} s fused (B3), {runs['f32']['warm_s']:.3f} s "
          f"with the float32 store (B8, B3 refreshes); gp-large-50k-d20 warm solve "
          f"{d20_runs['auto']['warm_s']:.3f} s with the FP64 store, "
          f"{d20_runs[False]['warm_s']:.3f} s fused (the wide B3), cold "
          f"{d20_runs['auto']['cold_s']:.3f} s with the store (the wide B5); all phases done "
          f"at {time.perf_counter() - t_start:.1f} s")

    df64_rows = []
    for kernel, fn, src, line in (
        ("B3", "sqexp_fused_kernel (q = 1)", "sqexp_fused.cu", 472),
        ("B4", "sqexp_fused_kernel", "sqexp_fused.cu", 591),
        ("B5", "sqexp_entries_kernel<double>", "sqexp_entries.cu", 828),
        ("B6", "sqexp_stored_kernel<double> (TMA ring, FP64 MMA)", "sqexp_stored.cu", 971),
        ("B7", "sqexp_entries_kernel<float>", "sqexp_entries.cu", 1088),
        ("B8", "sqexp_stored_kernel<float> (TMA ring, FP64 MMA)", "sqexp_stored.cu", 1180),
    ):
        timing = df64_ms[{"B4": "B4 q=8", "B6": "B6 q=1", "B8": "B8 q=1"}.get(kernel, kernel)]
        row = {"name": fn, "route": "cuda", "source": f"inference_tpu_torch/ops/csrc/{src}",
               "replaces": f"inference_tpu/ops/df64.py:{line}",
               "launches": large_launches[kernel], "max_abs_err": df64_err[kernel], **timing}
        if kernel in ("B6", "B8"):
            row["launches_by_q"] = large_launches[f"{kernel} by q"]
            row["q8"] = df64_ms[f"{kernel} q=8"]
            row["per_q"] = {q: df64_ms[f"{kernel} q={q}"] for q in STORED_Q}
        if kernel == "B4":
            row["per_q"] = {q: df64_ms[f"B4 q={q}"] for q in (2, 8, 16)}
        if kernel in wide_ms:
            w = wide_ms[kernel]
            row.update({f"d{WIDE_D}_ms": w["ms"], f"d{WIDE_D}_bound_ms": w["bound_ms"],
                        f"d{WIDE_D}_plain_ms": w["plain_ms"],
                        f"d{WIDE_D}_max_abs_err": w["max_abs_err"]})
        row[f"d{WIDE_D}_launches"] = sum(run[kernel] for run in d20_launches.values())
        row["launches_inv_50k"] = sum(run.get(kernel, 0) for run in inv_launches.values())
        df64_rows.append(row)
    print(json.dumps({"kernels": [{
        "name": "hmc_fused_chunk",
        "kernel": "hmc_chunk_kernel<P=10, unit mass>",
        "route": "cuda",
        "source": "inference_tpu_torch/ops/csrc/hmc_fused.cu",
        "replaces": "inference_tpu/ops/hmc_fused.py:347",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b1_bound,
        "bound_by": b1_by,
        "library_ms": None,
        "P": N_DIM,
        "variant": dict(hmc_fused.kernel_variant(N_DIM, True)),
        "per_P": {P: {"ms": t[0], "bound_ms": t[2]} for P, t in b1.items()},
        "chain_sweep_attempts_per_s": sweep,
    }, {
        "name": "hmc_fused_chunk_wide",
        "kernel": "hmc_tile_kernel (a block of C chains shares each row of A; A resident in "
                  "shared memory where it fits, else a cp.async ring; transitions in lockstep)",
        "route": "cuda",
        "source": "inference_tpu_torch/ops/csrc/hmc_fused.cu",
        "replaces": "inference_tpu/ops/hmc_fused.py:347",
        "launches": wide_chains[100][1],
        "max_abs_err": wide_err,
        "ms": wide[100][0],
        "plain_ms": wide[100][1],
        "bound_ms": wide[100][2],
        "bound_by": wide[100][3],
        "library_ms": None,
        "P": 100,
        "variant": dict(hmc_fused.kernel_variant(100, True)),
        "per_P": {P: {"ms": t[0], "bound_ms": t[2], "bound_by": t[3],
                      "plan": hmc_fused.wide_plan(P, N_CHAINS)._asdict()}
                  for P, t in wide.items()},
        "chain_array": {P: {"attempts_per_s": c[0], "launches": c[1], "max_rel_var_err": c[2],
                            "max_rhat": c[3]} for P, c in wide_chains.items()},
        "dense_hmc_4096": dense,
    }, {
        "name": "sqexp_kernel",
        "kernel": b2_ms[F64]["kernel"],
        "route": "cuda",
        "source": "inference_tpu_torch/ops/csrc/sqexp.cu",
        "replaces": "inference_tpu/ops/pairwise.py:69",
        "launches": b2_launches,
        "max_abs_err": b2_err[F64][0],
        "ms": b2_ms[F64]["ms"],
        "plain_ms": b2_ms[F64]["plain_ms"],
        "bound_ms": b2_ms[F64]["bound_ms"],
        "bound_by": b2_ms[F64]["bound_by"],
        "library_ms": None,
        "cdist_exp_ms": b2_ms[F64]["cdist_exp_ms"],
        "cg_block": b2_cg,
        "launches_fit_device": bo["gp-fit-device-4k"]["b2_launches"],
        "fit_device_4k": {k: bo["gp-fit-device-4k"][k] for k in ("seconds", "nit", "profile",
                                                                   "b2")},
        "launches_cg_path": {**{f"gp-large-cg-50k {k}": v.get("B2", 0)
                                for k, v in cg_launches.items()},
                             "gp-large-fit-16k": fit16k["launches"].get("B2", 0),
                             **{f"inv-50k {k}": v.get("B2", 0) for k, v in inv_launches.items()}},
        "variant": b2_ms[F64]["variant"],
        "store_route": b2_ms[F64]["route"],
        "per_dtype": {
            str(dt)[6:]: {"max_abs_err": b2_err[dt][0], "max_rel_err": b2_err[dt][1],
                          **{k: b2_ms[dt][k] for k in ("ms", "plain_ms", "cdist_exp_ms",
                                                       "bound_ms", "fill_ms", "route",
                                                       "registers", "sass_per_entry")}}
            for dt in (F64, torch.float32)
        },
    }, *df64_rows, *_probe_rows(probe, probe_err)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
