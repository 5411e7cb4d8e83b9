"""Probe P1: the float32 and float64 multiply/add issue rate of the card's
CUDA cores.

Port of ``benchmarks/vpu_probe.py``, which timed chains of dependent and
independent multiplies and adds on a (128, 128) float32 tile inside a Pallas
kernel to find the TPU vector unit's attainable rate. Here the same chains
run in a hand kernel (``ops/csrc/issue_probe.cu``) in float32 and in float64,
the type kernel B3 computes in, with the modes mapped to where a CUDA core
takes its operands from: constants (``scalar``), registers (``vv``), a
shared-memory broadcast read (``bcast``, the read B3 makes for every column
coordinate) and a shared-memory matrix (``bcast_mat``). The TPU grid of 512
steps over one tile becomes 512 copies of the tile computed at once.

``issue_probe`` launches the kernel for a tile on a CUDA device and runs
the plain version ``_probe_reference`` (the same chains as torch
elementwise operations, one at a time) for a tile on the CPU. Both give the
same bits. ``run`` times every configuration with CUDA events and states
each against its bound, instructions over 132 SMs x the lanes of the type x
the clock; ``KERNEL_LAUNCHES`` counts the kernel's launches.

    python -m inference_tpu_torch.probes.vpu_probe [n_ops] [--modes scalar,vv]
    python -m inference_tpu_torch.probes.vpu_probe 16 --device cpu
"""

import argparse
import subprocess
import time

import numpy as np
import torch

from ..ops import _build
from . import BOOST_CLOCK_HZ, LANES, SMS, time_events

T = 128  # the tile's side
REPS = 512  # copies of the tile per launch (the TPU probe's grid)
MODES = ("scalar", "vv", "bcast", "bcast_mat")
CHAINS = (1, 2, 4, 8)
DTYPES = (torch.float32, torch.float64)

KERNEL_LAUNCHES = 0  # launches of the kernel in this process


def make_tile(dtype, device="cuda", seed=0):
    """The probe's input: a (128, 128) tile of standard normals from
    ``seed``, as ``benchmarks/vpu_probe.py`` draws it."""
    x = np.random.default_rng(seed).normal(size=(T, T))
    return torch.as_tensor(x, dtype=dtype, device=device)


def _check(x, n_ops, n_chains, mode):
    if mode not in MODES:
        raise ValueError(f"[ issue_probe error ] mode must be one of {MODES}, got {mode!r}.")
    if n_chains not in CHAINS:
        raise ValueError(f"[ issue_probe error ] n_chains must be one of {CHAINS}, got {n_chains}.")
    if n_ops < 0:
        raise ValueError(f"[ issue_probe error ] n_ops must be >= 0, got {n_ops}.")
    if x.shape != (T, T) or x.dtype not in DTYPES:
        raise TypeError(f"[ issue_probe error ] x must be a ({T}, {T}) float32 or float64 "
                        f"tile, got {x.dtype} {tuple(x.shape)}.")


def _probe_reference(x, n_ops, n_chains, mode, reps=1):
    """The kernel's plain version: ``reps`` copies of the tile through the
    same chains, each multiply and add one torch operation, so nothing is
    fused. Returns the (128, 128) result (every copy's is the same)."""
    const = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    c_mul, c_add, c_small = const(0.9999999), const(1e-7), const(1e-9)
    if mode == "scalar":
        a, b = c_mul, c_add
    elif mode == "vv":
        a, b = x * c_mul, x * c_small
    else:
        a, b = x[:, :1] * c_small + c_mul, x[:1, :] * c_small
    xs = x.expand(reps, T, T) if reps > 1 else x
    chains = [xs * const(1.0 + 1e-6 * c) for c in range(n_chains)]
    for _ in range(n_ops // 2):
        chains = [y * a for y in chains]
        chains = [y + b for y in chains]
    acc = chains[0]
    for y in chains[1:]:
        acc = acc + y
    return acc[0] if reps > 1 else acc


def _launch_probe(x, n_ops, n_chains, mode, reps=REPS):
    """Launch ``csrc/issue_probe.cu`` on a contiguous tile on a CUDA
    device, with the result of ``_probe_reference``."""
    global KERNEL_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"kernel P1: x is on {x.device}, not a CUDA device")
    if not x.is_contiguous():
        raise TypeError("kernel P1: x must be contiguous")
    out = torch.empty_like(x)
    symbol = "issue_probe_f32" if x.dtype == torch.float32 else "issue_probe_f64"
    fn = _build.bind("issue_probe", symbol, 2, 4)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), n_ops, MODES.index(mode), n_chains, reps,
                _build.stream(x.device))
    _build.raise_on(rc, "P1")
    KERNEL_LAUNCHES += 1
    return out


def issue_probe(x, n_ops=128, n_chains=1, mode="scalar", reps=REPS):
    """The probe's chains on the (128, 128) tile ``x`` (float32 or float64):
    ``n_chains`` chains of ``n_ops`` alternating multiplies and adds with the
    operands of ``mode``, summed in order, for ``reps`` copies of the tile.
    On a CUDA device the kernel; on the CPU its plain version."""
    _check(x, n_ops, n_chains, mode)
    if x.device.type == "cuda":
        return _launch_probe(x, n_ops, n_chains, mode, reps)
    if x.device.type == "cpu":
        return _probe_reference(x, n_ops, n_chains, mode, reps)
    raise ValueError(f"[ issue_probe error ] x is on {x.device}: the CPU or a CUDA device only.")


def operations(n_ops, n_chains, reps=REPS):
    """Multiplies and adds of one call (the final sum aside)."""
    return reps * T * T * n_chains * 2 * (n_ops // 2)


def bound_ms(ops, dtype, clock_hz=BOOST_CLOCK_HZ):
    """The least time for ``ops`` multiplies and adds: one per lane of the
    type per cycle on every SM."""
    return ops / (SMS * LANES[str(dtype)[6:]] * clock_hz) * 1e3


def sm_clock_under_load(dtype=torch.float64, seconds=1.5, device="cuda"):
    """The SM clock (MHz, median) and the power draw (W, max) that
    ``nvidia-smi`` reads every 100 ms while the card runs the probe's
    8-chain ``vv`` mode for about ``seconds``. The launches are queued
    before ``nvidia-smi`` starts, so every sample falls under load."""
    x = make_tile(dtype, device)
    one = time_events(lambda: issue_probe(x, 128, 8, "vv", 16 * REPS), (), 2)
    for _ in range(max(1, int(seconds * 1e3 / one))):
        issue_probe(x, 128, 8, "vv", 16 * REPS)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        try:
            out, _ = smi.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            smi.kill()
            raise
    samples = [[float(v) for v in line.split(",")] for line in out.splitlines() if line.strip()]
    if not samples:
        raise RuntimeError("nvidia-smi gave no clock sample under load")
    return float(np.median([s[0] for s in samples])), max(s[1] for s in samples), len(samples)


def run(device="cuda", n_ops=128, modes=MODES, dtypes=DTYPES, reps=REPS, time_reps=10,
        clock_hz=BOOST_CLOCK_HZ):
    """Every configuration once on ``device``. On a CUDA device each is
    timed with CUDA events: ms, GFLOP/s, SM cycles per warp instruction
    (at ``clock_hz``) and the bound at the data-sheet clock. On the CPU only
    the plain version runs and no time is taken. Returns one dict a row."""
    rows = []
    for dtype in dtypes:
        x = make_tile(dtype, device)
        for mode in modes:
            for n_chains in CHAINS:
                args = (x, n_ops, n_chains, mode, reps)
                out = issue_probe(*args)
                ops = operations(n_ops, n_chains, reps)
                row = {"dtype": str(dtype)[6:], "mode": mode, "chains": n_chains, "ops": ops,
                       "checksum": float(out.double().sum()), "ms": None}
                if x.device.type == "cuda":
                    ms = time_events(issue_probe, args, time_reps)
                    row.update(ms=ms, gflops=ops / ms / 1e6, bound_ms=bound_ms(ops, dtype),
                               cycles_per_warp_instr=ms * 1e-3 * clock_hz * SMS / (ops / 32))
                rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_ops", nargs="?", type=int, default=128)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    on_card = torch.device(a.device).type == "cuda"
    reps = REPS if on_card else 1
    clock = BOOST_CLOCK_HZ
    if on_card:
        mhz, watts, n = sm_clock_under_load(device=a.device)
        clock = mhz * 1e6
        print(f"device: {torch.cuda.get_device_name(a.device)}; SM clock under load {mhz:.0f} "
              f"MHz (median of {n} nvidia-smi samples), power draw up to {watts:.1f} W")
    else:
        print("device: cpu (the plain version; no time is measured)")
    t0 = time.perf_counter()
    for r in run(a.device, a.n_ops, a.modes.split(","), reps=reps, clock_hz=clock):
        head = f"  {r['dtype']} {r['mode']:9s} chains={r['chains']}:"
        if r["ms"] is None:
            print(f"{head} checksum {r['checksum']:.9e}")
        else:
            print(f"{head} {r['ms']:8.4f} ms {r['gflops']:9.1f} GFLOP/s "
                  f"({r['cycles_per_warp_instr']:.3f} SM cycles per warp instruction; bound "
                  f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} of the data-sheet rate)")
    if not on_card:
        print(f"  ({time.perf_counter() - t0:.2f} s on the host)")


if __name__ == "__main__":
    main()
