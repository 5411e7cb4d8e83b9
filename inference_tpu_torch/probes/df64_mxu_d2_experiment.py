"""Probe P3: kernel B3's function with the squared distance's cross term
from exact integer matmuls on the tensor cores.

Port of ``benchmarks/df64_mxu_d2_experiment.py``. On the TPU the pair-
arithmetic distance was the fused kernels' bottleneck, and the experiment
moved the cross term ``u_i . u_j`` to the matrix unit with an error-free
split: each coordinate becomes ``NW = 7`` integer words of 7 bits
(``build_words``), and the cross term is a sum over scale classes ``c`` of
exact integer matmuls ``C_c``. Here the class matmuls are int8 ``mma.sync``
instructions on the tensor cores, written by hand
(``ops/csrc/sqexp_words_mma.cu``), their int32 sums are combined exactly in
integers, and the argument ``-|u_i|^2/2 - |u_j|^2/2 + u_i . u_j``, the exp
and the accumulate run in FP64 as in B3. The TPU kernel's pair combine and
pair exponential (its ``:120-153``) worked round the TPU's lack of float64
and are not ported; ``build_norms`` is kept as the JAX script defines it,
and the kernel takes the FP64 norms it splits (``half_norms``).

``words_matvec`` launches the kernel for operands (``prepare``) on a CUDA
device and runs the plain version ``_words_reference`` (the class matmuls in
float64 torch, exact for these integers, the same combine, ``torch.exp`` and
a row-blocked matvec) for operands on the CPU. ``run`` prints the error
against the float64 truth and times the kernel beside B3 on the same
inputs; ``KERNEL_LAUNCHES`` counts the kernel's launches.

    python -m inference_tpu_torch.probes.df64_mxu_d2_experiment [n ...]
    python -m inference_tpu_torch.probes.df64_mxu_d2_experiment 512 --device cpu
"""

import argparse
import time

import numpy as np
import torch

from ..ops import _build, df64
from . import EXP_FLOPS, FP64_FLOPS, bound, time_events
from .df64_ablate import N, make_inputs

NW = 7  # fixed-point words per coordinate
BITS = 7  # magnitude bits per word
KP = 16  # int8 entries of one word vector: the MMA's K, at least NW * d

KERNEL_LAUNCHES = 0  # launches of the kernel in this process


def build_words(u64):
    """(Wq, s): Wq is (n, NW*d) float32 holding the integer words
    word-major (columns [k*d:(k+1)*d] = word k of every dimension)."""
    n, d = u64.shape
    s = int(np.ceil(np.log2(np.abs(u64).max() + 1e-300))) + 1
    r = np.asarray(u64, np.float64).copy()
    cols = []
    for k in range(NW):
        scale = 2.0 ** (s - BITS * (k + 1))
        q = np.rint(r / scale)
        cols.append(q.astype(np.float32))
        r -= q * scale
    return np.concatenate(cols, axis=1), s


def half_norms(u64):
    """-|u|^2 / 2 of every row, in float64."""
    return -0.5 * (np.asarray(u64, np.float64) ** 2).sum(axis=1)


def build_norms(u64):
    """float32 pair of -0.5 |u|^2 (host f64, split exactly)."""
    m = half_norms(u64)
    nh = m.astype(np.float32)
    nl = (m - nh.astype(np.float64)).astype(np.float32)
    return nh, nl


def prepare(u64, device="cuda"):
    """The kernel's operands from FP64 coordinates ``u64`` (n, d), d <= 2,
    built on the host: ``rows`` (n, 16) int8, every row's words word-major
    and zero-padded; ``cols`` (NW, n, 16) int8, for class c the words
    q_{c-a} at a d + k for a <= c, so that ``rows[i] . cols[c, j]`` is the
    class-c cross term; ``norms`` (n,) float64; ``shift`` = 2 s - 56, the
    exponent of the combined class sum."""
    u64 = np.asarray(u64, np.float64)
    n, d = u64.shape
    if NW * d > KP:
        raise ValueError(f"[ prepare error ] the words of d = {d} dimensions do not fit the "
                         f"MMA's K = {KP}; d <= {KP // NW}.")
    Wq, s = build_words(u64)
    W = Wq.astype(np.int8)
    rows = np.zeros((n, KP), np.int8)
    rows[:, : NW * d] = W
    cols = np.zeros((NW, n, KP), np.int8)
    for c in range(NW):
        for a in range(c + 1):
            cols[c, :, a * d:(a + 1) * d] = W[:, (c - a) * d:(c - a + 1) * d]
    t = lambda a: torch.as_tensor(a, device=device)
    return {"rows": t(rows), "cols": t(cols), "norms": t(half_norms(u64)),
            "shift": 2 * s - BITS * (NW + 1)}


def _class_sums(rows, cols):
    """Exact C_c of the rows against every column, summed to
    S = sum_c C_c 2^(7 (6 - c)) in int64."""
    S = torch.zeros((rows.shape[0], cols.shape[1]), dtype=torch.int64, device=rows.device)
    for c in range(NW):
        S += (rows.double() @ cols[c].double().T).long() * (1 << BITS * (NW - 1 - c))
    return S


def _words_reference(ops, v):
    """The kernel's plain version: the class matmuls in float64 (exact for
    these integers), the same integer combine and FP64 argument, torch.exp,
    and the product with v in float64, row block by row block."""
    rows, cols, norms = ops["rows"], ops["cols"], ops["norms"]
    n = rows.shape[0]
    scale = 2.0 ** ops["shift"]
    V64 = v.double()
    out = torch.empty(n, dtype=torch.float64, device=rows.device)
    for blk in df64._row_blocks(n, n):
        S = _class_sums(rows[blk], cols)
        arg = (norms[blk, None] + norms[None, :]) + S.double() * scale
        out[blk] = torch.exp(arg) @ V64
    return out


def _check_cuda(kernel, ops, *extra):
    dev = ops["rows"].device
    for name, t in (("rows", ops["rows"]), ("cols", ops["cols"]), ("norms", ops["norms"]),
                    *extra):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel {kernel}: {name} is on {t.device}; every operand must be "
                             f"on one CUDA device")
        if not t.is_contiguous():
            raise TypeError(f"kernel {kernel}: {name} must be contiguous")
    return dev


def _launch_words(ops, v):
    """Launch ``csrc/sqexp_words_mma.cu`` on ``prepare``'s operands and float32
    v on one CUDA device, with the result of ``_words_reference``."""
    global KERNEL_LAUNCHES
    dev = _check_cuda("P3", ops, ("v", v))
    if v.dtype != torch.float32:
        raise TypeError(f"kernel P3: v must be float32, got {v.dtype}")
    n = ops["rows"].shape[0]
    splits = df64._splits(n, n, dev)
    partial = torch.empty((splits, n), dtype=torch.float64, device=dev)
    fn = _build.bind("sqexp_words_mma", "sqexp_words_mma", 5, 3)
    with torch.cuda.device(dev):
        rc = fn(ops["rows"].data_ptr(), ops["cols"].data_ptr(), ops["norms"].data_ptr(),
                v.data_ptr(), partial.data_ptr(), ops["shift"], n, splits, _build.stream(dev))
    _build.raise_on(rc, "P3")
    KERNEL_LAUNCHES += 1
    return partial[0] if splits == 1 else partial.sum(dim=0)


def words_matvec(ops, v):
    """y = E v with E_ij = exp(-|u_i - u_j|^2 / 2), from ``prepare``'s
    operands and float32 ``v`` (n,), n a multiple of 128. On a CUDA device
    the kernel; on the CPU its plain version."""
    n = ops["rows"].shape[0]
    if n % df64._TJ != 0 or n == 0:
        raise ValueError(f"[ words_matvec error ] n ({n}) must be a multiple of {df64._TJ}.")
    if v.dtype != torch.float32 or v.shape != (n,):
        raise TypeError(f"[ words_matvec error ] v must be float32 ({n},), got {v.dtype} "
                        f"{tuple(v.shape)}.")
    dev = df64._same_device("words_matvec", ops["rows"], ops["cols"], ops["norms"], v)
    if dev.type == "cuda":
        return _launch_words(ops, v.contiguous())
    return _words_reference(ops, v)


def _launch_tile(ops):
    """The class sums C_c of rows 0-15 and columns 0-7 by one warp of the
    kernel's MMAs: (NW, 16, 8) int32, the fragment layout's check."""
    dev = _check_cuda("P3 tile", ops)
    out = torch.empty((NW, 16, 8), dtype=torch.int32, device=dev)
    fn = _build.bind("sqexp_words_mma", "words_mma_tile", 3, 1)
    with torch.cuda.device(dev):
        rc = fn(ops["rows"].data_ptr(), ops["cols"].data_ptr(), out.data_ptr(),
                ops["rows"].shape[0], _build.stream(dev))
    _build.raise_on(rc, "P3 tile")
    return out


def _tile_reference(ops):
    """``_launch_tile``'s plain version."""
    rows = ops["rows"][:16].double()
    return torch.stack([rows @ ops["cols"][c, :8].double().T for c in range(NW)]).int()


def words_bound(n):
    """(ms, what bounds it) of the kernel's FP64 work at n, with
    chip_smoke.py's arithmetic: per entry one add and one fma for the
    argument, the exp and the fma accumulate; the operands moved once."""
    n_bytes = n * (KP + NW * KP + 8 + 4 + 8)
    return bound(n_bytes, float(n) * n * (3 + EXP_FLOPS + 2), FP64_FLOPS)


def run(n=N, device="cuda", time_reps=5, seed=0):
    """The probe at n on ``make_inputs``' data: the kernel (or on the CPU
    its plain version) and B3 against the float64 truth (exact differences,
    B3's plain version) and, on a CUDA device, both timed with CUDA events.
    Returns a dict of the readings."""
    uh, ul, us64, v = make_inputs(n, device, seed)
    t0 = time.perf_counter()
    ops = prepare(us64.cpu().numpy(), device)
    build_s = time.perf_counter() - t0
    y = words_matvec(ops, v)
    y_b3 = df64.sqexp_matvec_df64(uh, ul, v)
    truth = df64._fused_reference(us64, us64, v[:, None])[:, 0]
    scale = float(truth.abs().max())
    out = {"n": n, "build_s": build_s, "ms": None, "b3_ms": None,
           "err": float((y - truth).abs().max()) / scale,
           "b3_err": float((y_b3 - truth).abs().max()) / scale}
    out["bound_ms"], out["bound_by"] = words_bound(n)
    if us64.device.type == "cuda":
        out["ms"] = time_events(words_matvec, (ops, v), time_reps)
        out["b3_ms"] = time_events(df64.sqexp_matvec_df64, (uh, ul, v), time_reps)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sizes", nargs="*", type=int, default=[N])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    on_card = torch.device(a.device).type == "cuda"
    print(f"device: {torch.cuda.get_device_name(a.device) if on_card else 'cpu (the plain versions; no time is measured)'}")
    for n in a.sizes:
        r = run(n, a.device)
        print(f"n={n}: words rel err {r['err']:.2e}, B3 rel err {r['b3_err']:.2e} "
              f"(max |y - truth| / max |truth|); words built on the host in "
              f"{r['build_s']:.3f} s")
        if on_card:
            print(f"  words: {r['ms']:8.4f} ms ({r['ms'] * 1e9 / n**2:.4f} ps/entry), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            print(f"  B3:    {r['b3_ms']:8.4f} ms ({r['b3_ms'] * 1e9 / n**2:.4f} ps/entry)")


if __name__ == "__main__":
    main()
