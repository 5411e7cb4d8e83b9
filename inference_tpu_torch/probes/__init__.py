"""Measurement probes for the card: the counterparts of the JAX package's
Pallas probes in ``benchmarks/``, each a hand kernel in CUDA C++ with a
plain PyTorch version and a ``main()``.

- ``vpu_probe`` (P1, ``ops/csrc/issue_probe.cu``): the FP32 and FP64
  multiply/add issue rate of the CUDA cores, for chains of dependent
  operations whose operands come from constants, registers or shared
  memory.
- ``df64_ablate`` (P2, ``ops/csrc/sqexp_ablate.cu``): kernel B3 stripped
  stage by stage (distance, exp, accumulate), and B3 with its column
  operands moved from shared-memory broadcasts to shuffles or with more
  rows per thread.
- ``df64_mxu_d2_experiment`` (P3, ``ops/csrc/sqexp_words_mma.cu``): B3's
  function with the distance's cross term from exact integer matmuls on
  the tensor cores.

Run one on the card with ``python -m inference_tpu_torch.probes.<name>``,
or on the CPU (the plain versions, small sizes) with ``--device cpu``.

This module also holds the data-sheet rates of one H100 SXM that the
probes and ``chip_smoke.py`` state their bounds against.
"""

import torch

# NVIDIA's data sheet for the H100 SXM, at the 700 W limit: device memory,
# float32 and float64 outside the tensor cores (an FMA counted as two
# flops; 132 SMs x 64 FP64 lanes x 2 x 1.98 GHz = 33.5 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 33.5e12
SMS = 132
BOOST_CLOCK_HZ = 1.98e9
# lanes per SM that issue one float32 or float64 multiply or add per cycle
LANES = {"float32": 128, "float64": 64}
# FP64 flops of one double exp as CUDA 12.8 compiles it, an FMA counted as
# two: 14 DFMA, 3 DADD and 1 DMUL per entry beyond the distance, read off
# the SASS of kernel B5's d = 2 instantiation (chip_smoke.py prints it)
EXP_FLOPS = 32


def bound(n_bytes, flops, peak_flops):
    """The least time (ms) for the work, and what bounds it: bytes over the
    memory rate or operations over the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_events(fn, args=(), reps=10):
    """Mean ms of ``fn(*args)`` over ``reps`` calls between two CUDA
    events, after one warm-up call."""
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
