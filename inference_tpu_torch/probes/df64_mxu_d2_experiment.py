"""Probe P3: kernel B3's function with the squared distance's cross term
from exact integer matmuls on the tensor cores, at any coordinate dimension d.

Port of ``benchmarks/df64_mxu_d2_experiment.py``. On the TPU the pair-
arithmetic distance was the fused kernels' bottleneck, and the experiment
moved the cross term ``u_i . u_j`` to the matrix unit with an error-free
split: each coordinate becomes ``NW = 7`` integer words of 7 bits
(``build_words``), and the cross term is a sum over scale classes ``c`` of
exact integer matmuls ``C_c``. Here the class matmuls are int8 ``mma.sync``
instructions on the tensor cores, written by hand
(``ops/csrc/sqexp_words_mma.cu``, one library per d), and the argument ``-|u_i|^2/2 - |u_j|^2/2 + S 2^shift``, the exp and the accumulate
run in FP64 as in B3. The TPU kernel's pair combine and pair exponential
(its ``:120-153``) worked round the TPU's lack of float64 and are not
ported; ``build_norms`` is kept as the JAX script defines it, and the kernel
takes the FP64 norms it splits (``half_norms``).

The combined class sum ``S = sum_c C_c 2^(7 (6 - c))`` needs 54 + log2(d)
bits, more than int64 holds above d = 256. The plain version carries it
exactly in two int64 words (``_class_sums``) and rounds it to FP64 once, so
it takes any d, as the JAX probe does. So does the kernel. Up to
``D_RESIDENT`` = 411, where its smallest resident plan (16 rows of words
resident, one stage of 16 columns) still fits the 227 KB of shared memory a
block may have, the resident kernel folds S into the FP64 argument part by
part (``parts``); above, the library is built streamed
(``kernel_variant``): each class's K passes through shared memory in chunks
into 64-bit class sums, and S forms in two int64 words as in the plain
version.

``words_matvec`` launches the kernel for operands (``prepare``) on a CUDA
device and runs the plain version ``_words_reference`` (the class matmuls in
float64 torch, exact for these integers, the same combine, ``torch.exp`` and
a row-blocked matvec) for operands on the CPU. ``run`` prints the error
against the float64 truth and times the kernel beside B3 on the same
inputs; ``KERNEL_LAUNCHES`` counts the kernel's launches.

    python -m inference_tpu_torch.probes.df64_mxu_d2_experiment [n ...] [--d D]
    python -m inference_tpu_torch.probes.df64_mxu_d2_experiment 512 --d 20 --device cpu
"""

import argparse
import ctypes
import time

import numpy as np
import torch

from ..ops import _build, df64
from . import FP64_FLOPS, INT8_MACS, bound, time_events
from .df64_ablate import N, make_inputs

NW = 7  # fixed-point words per coordinate
BITS = 7  # magnitude bits per word
KS = 16  # int8 entries of a K chunk (an MMA takes two, or one last): each class's K is a multiple
LO_BITS = BITS * (NW - 1)  # S = hi 2^LO_BITS + lo, 0 <= lo < 2^LO_BITS (``_class_sums``)
# FP64 flops of the kernel's exp_nonpos (an fma two): 7 DFMA, 1 DADD, 1 DMUL
EXP_NONPOS_FLOPS = 16

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


def _round_up(x, m):
    return -(-x // m) * m


def layout(d):
    """(KA, [(offset, K) of each class], KB): the bytes of a row's words,
    where class c's words lie in a column's and how many (``(c + 1) d``
    rounded up to the MMA's K step), and the bytes of a column's words;
    ``csrc/sqexp_words_mma.cu`` computes the same."""
    ks = [_round_up((c + 1) * d, KS) for c in range(NW)]
    offs = np.concatenate([[0], np.cumsum(ks)]).astype(int).tolist()
    return _round_up(NW * d, KS), list(zip(offs[:-1], ks)), offs[-1]


def _operands(W, d):
    """rows (n, KA) and cols (n, KB) int8 from the integer words ``W`` (n,
    NW d), word-major: ``rows[i]`` holds row i's words, zero-padded;
    column j's class-c slice of ``cols`` holds q_{c-a}(j) at a d + k for
    a <= c and zeros after, so that ``rows[i, :K] . cols[j, off:off + K]``
    is the JAX kernel's class-c sum (its ``:104-114``)."""
    W = np.asarray(W, np.int8)
    n = W.shape[0]
    KA, classes, KB = layout(d)
    rows = np.zeros((n, KA), np.int8)
    rows[:, : NW * d] = W
    cols = np.zeros((n, KB), np.int8)
    for c, (off, _) in enumerate(classes):
        for a in range(c + 1):
            cols[:, off + a * d: off + (a + 1) * d] = W[:, (c - a) * d:(c - a + 1) * d]
    return rows, cols


def _plan_fits(d):
    """Whether the kernel's smallest plan at d fits a block's shared memory:
    16 rows of words at its pitch, one stage of 16 columns (words, norms, v)
    and the exp's table, as ``csrc/sqexp_words_mma.cu``'s choose_plan
    counts them."""
    KA, _, KB = layout(d)
    return 16 * (_round_up(KA, 32) + 16) + 16 * (KB + 12) + 512 <= 233472 - 1024


D_RESIDENT = max(d for d in range(1, 1024) if _plan_fits(d))  # the resident kernel's largest d


def prepare(u64, device="cuda"):
    """The kernel's operands from FP64 coordinates ``u64`` (n, d), built on
    the host: ``rows`` and ``cols`` (``_operands``), ``norms`` (n,) float64,
    ``shift`` = 2 s - 56, the exponent of the combined class sum, and
    ``d``."""
    u64 = np.asarray(u64, np.float64)
    n, d = u64.shape
    Wq, s = build_words(u64)
    rows, cols = _operands(Wq, d)
    t = lambda a: torch.as_tensor(a, device=device)
    return {"rows": t(rows), "cols": t(cols), "norms": t(half_norms(u64)),
            "shift": 2 * s - BITS * (NW + 1), "d": d}


def class_operands(ops, c):
    """(A, B): the rows' and the columns' words of class c, A @ B.T = C_c."""
    _, classes, _ = layout(ops["d"])
    off, k = classes[c]
    return ops["rows"][:, :k], ops["cols"][:, off:off + k]


def _class_sums(ops, rows=slice(None), cols=slice(None)):
    """Exact C_c of the rows against the columns (float64 matmuls of
    integers below 2^31), summed to S = sum_c C_c 2^(7 (6 - c)) exactly in
    two int64 words (hi, lo), S = hi 2^42 + lo with 0 <= lo < 2^42: C_c
    2^(42 - 7 c) = floor(C_c / 2^(7 c)) 2^42 + (C_c mod 2^(7 c)) 2^(42 - 7 c),
    the first into hi and the second, below 2^42, into lo, then lo's carry
    into hi. |hi| stays below 1.02 d 2^12, so S is exact at every d."""
    hi = lo = 0
    for c in range(NW):
        A, B = class_operands(ops, c)
        C = (A[rows].double() @ B[cols].double().T).long()
        low = BITS * c  # the bits of C_c below 2^42 once it is scaled by 2^(42 - 7 c)
        q = C >> low  # floor(C_c / 2^(7 c))
        hi = hi + q
        lo = lo + ((C - (q << low)) << (LO_BITS - low))
    carry = lo >> LO_BITS
    return hi + carry, lo - (carry << LO_BITS)


def _class_sum_f64(hi, lo):
    """S = hi 2^42 + lo (``_class_sums``) in FP64, rounded once: hi 2^42
    and lo are exact doubles, and their sum rounds."""
    return hi.double() * 2.0**LO_BITS + lo.double()


def parts(d):
    """The kernel's parts of S: runs (a, b) of consecutive classes whose
    P = sum_{c=a..b} C_c 2^(7 (b - c)) fits int32 for words of +-64 (|C_c|
    <= (c + 1) d 2^12), taken greedily from class 0, as
    ``csrc/sqexp_words_mma.cu``'s part_fits; S = sum of P 2^(7 (6 - b))."""
    fits = lambda a, b: sum((c + 1) * d * 4096 * 128 ** (b - c) for c in range(a, b + 1)) < 2 ** 31
    out, a = [], 0
    while a < NW:
        b = a
        while b + 1 < NW and fits(a, b + 1):
            b += 1
        out.append((a, b))
        a = b + 1
    return out


def _parts_of(C, d):
    """The parts (``parts``) of class sums C (NW, ...) in int64."""
    C = C.long()
    out = []
    for a, b in parts(d):
        P = C[a]
        for c in range(a + 1, b + 1):
            P = P * 128 + C[c]
        out.append(P)
    return torch.stack(out)


def _words_reference(ops, v):
    """The kernel's plain version: the class matmuls in float64 (exact for
    these integers), S exact (``_class_sums``) rounded once into the FP64
    argument, torch.exp, and the product with v in float64, row block by row
    block."""
    norms = ops["norms"]
    n = norms.shape[0]
    scale = 2.0 ** ops["shift"]
    V64 = v.double()
    out = torch.empty(n, dtype=torch.float64, device=norms.device)
    for blk in df64._row_blocks(n, n):
        arg = (norms[blk, None] + norms[None, :]) + _class_sum_f64(*_class_sums(ops, blk)) * scale
        out[blk] = torch.exp(arg) @ V64
    return out


def kernel_variant(d):
    """The nvcc defines of the kernel's library for d coordinates: one
    library per d, streamed above ``D_RESIDENT``."""
    return (("P3_D", d),) + ((("P3_STREAMED", 1),) if d > D_RESIDENT else ())


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


PLAN_KEYS = ("d", "bm", "tj", "stages", "threads", "smem", "blocks_per_sm", "splits", "ka", "kb",
             "parts", "areg")


def plan(n, d, device):
    """The library's launch plan for n rows at d on ``device``
    (``sqexp_words_mma_plan``): its tile sizes, ring depth, threads, shared
    bytes, blocks an SM, column splits, operand widths, the parts of S
    (``parts``; 0 for the streamed kernel, which forms S in two words) and
    whether A's fragments sit in registers."""
    fn = getattr(_build.load("sqexp_words_mma", kernel_variant(d)), "sqexp_words_mma_plan")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        rc = fn(n, ctypes.addressof(out))
    _build.raise_on(rc, "P3 plan")
    return dict(zip(PLAN_KEYS, out))


def _launch_words(ops, v):
    """Launch ``csrc/sqexp_words_mma.cu`` (the library of ``ops``' d) on
    ``prepare``'s operands and float32 v on one CUDA device, with the result
    of ``_words_reference``."""
    global KERNEL_LAUNCHES
    dev = _check_cuda("P3", ops, ("v", v))
    if v.dtype != torch.float32:
        raise TypeError(f"kernel P3: v must be float32, got {v.dtype}")
    n, d = ops["rows"].shape[0], ops["d"]
    p = plan(n, d, dev)
    if (p["ka"], p["kb"]) != (ops["rows"].shape[1], ops["cols"].shape[1]):
        raise ValueError(f"kernel P3: operands of {ops['rows'].shape[1]} and "
                         f"{ops['cols'].shape[1]} bytes, the library's d = {d} takes "
                         f"{p['ka']} and {p['kb']}")
    partial = torch.empty((p["splits"], n), dtype=torch.float64, device=dev)
    fn = _build.bind("sqexp_words_mma", "sqexp_words_mma", 5, 4, kernel_variant(d))
    with torch.cuda.device(dev):
        rc = fn(ops["rows"].data_ptr(), ops["cols"].data_ptr(), ops["norms"].data_ptr(),
                v.data_ptr(), partial.data_ptr(), ops["shift"], n, d, p["splits"],
                _build.stream(dev))
    _build.raise_on(rc, "P3")
    KERNEL_LAUNCHES += 1
    return partial[0] if p["splits"] == 1 else partial.sum(dim=0)


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
    """The class sums C_c (NW, 32, 16) and the parts P (``parts``, 32, 16),
    int32, of rows 0-31 and columns 0-15 by one warp of the kernel's own
    staging, fragments and combine: the layout's check."""
    dev = _check_cuda("P3 tile", ops)
    d = ops["d"]
    out_c = torch.empty((NW, 32, 16), dtype=torch.int32, device=dev)
    out_p = torch.empty((len(parts(d)), 32, 16), dtype=torch.int32, device=dev)
    fn = _build.bind("sqexp_words_mma", "words_mma_tile", 4, 2, kernel_variant(d))
    with torch.cuda.device(dev):
        rc = fn(ops["rows"].data_ptr(), ops["cols"].data_ptr(), out_c.data_ptr(),
                out_p.data_ptr(), ops["rows"].shape[0], d, _build.stream(dev))
    _build.raise_on(rc, "P3 tile")
    return out_c, out_p


def _tile_reference(ops):
    """``_launch_tile``'s plain version."""
    C = torch.stack([(A[:32].double() @ B[:16].double().T).long()
                     for A, B in (class_operands(ops, c) for c in range(NW))])
    return C.int(), _parts_of(C, ops["d"]).int()


def words_bound(n, d):
    """(ms, what bounds it) of the kernel's FP64 work at n, an fma two
    flops: per entry the add of the norms, one fma for each part of S
    (``parts``; the streamed kernel's two: S from its two words, S into the
    argument), exp_nonpos (``EXP_NONPOS_FLOPS``) and the fma accumulate, 25
    flops up to d = 31 (three parts), 27 above; the operands read once and
    y written once."""
    KA, _, KB = layout(d)
    flops = 1 + 2 * (len(parts(d)) if d <= D_RESIDENT else 2) + EXP_NONPOS_FLOPS + 2
    return bound(n * (KA + KB + 8 + 4 + 8), float(n) * n * flops, FP64_FLOPS)


def tensor_ms(n, d):
    """The int8 MACs the kernel issues, KB an entry (each class's K, padded
    to the MMA's step), over the data sheet's dense int8 rate: the least
    time of its MMAs (ms), a model."""
    return float(n) * n * layout(d)[2] / INT8_MACS * 1e3


def make_coords(n, d, device="cuda", seed=0):
    """Coordinates for the probe at d: ``df64_ablate.make_inputs``' U[0,
    10]^2 at d = 2 (P3's own data), else pre-scaled uniform on [0, 1.5
    sqrt(20 / d)]^d (gp-large-50k-d20's [0, 1.5]^20 at d = 20), as a float32
    pair, their FP64 sum and v ~ N(0, 1) in float32."""
    if d == 2:
        return make_inputs(n, device, seed)
    rng = np.random.default_rng(seed)
    uh, ul = df64.split_f64(rng.uniform(0, 1.5 * np.sqrt(20 / d), (n, d)))
    v = rng.normal(size=n).astype(np.float32)
    uh, ul, v = (torch.as_tensor(a, device=device) for a in (uh, ul, v))
    return uh, ul, uh.double() + ul.double(), v


def run(n=N, device="cuda", time_reps=5, seed=0, d=2):
    """The probe at n and d on ``make_coords``' data: the kernel (or on the
    CPU its plain version) and B3 against the float64 truth (exact
    differences, B3's plain version) and, on a CUDA device, both timed with
    CUDA events. Returns a dict of the readings."""
    uh, ul, us64, v = make_coords(n, d, device, seed)
    t0 = time.perf_counter()
    ops = prepare(us64.cpu().numpy(), device)
    build_s = time.perf_counter() - t0
    y = words_matvec(ops, v)
    y_b3 = df64.sqexp_matvec_df64(uh, ul, v)
    truth = df64._fused_reference(us64, us64, v[:, None])[:, 0]
    scale = float(truth.abs().max())
    out = {"n": n, "d": d, "build_s": build_s, "ms": None, "b3_ms": None,
           "err": float((y - truth).abs().max()) / scale,
           "b3_err": float((y_b3 - truth).abs().max()) / scale,
           "tensor_ms": tensor_ms(n, d)}
    # the least time: the larger of the FP64 flops bound and the MMAs' time
    out["bound_ms"], out["bound_by"] = max(words_bound(n, d), (out["tensor_ms"], "operations"))
    if us64.device.type == "cuda":
        out["ms"] = time_events(words_matvec, (ops, v), time_reps)
        out["b3_ms"] = time_events(df64.sqexp_matvec_df64, (uh, ul, v), time_reps)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sizes", nargs="*", type=int, default=[N])
    p.add_argument("--d", type=int, default=2,
                   help=f"coordinate dimension (any; the card's kernel is streamed above "
                        f"{D_RESIDENT})")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    on_card = torch.device(a.device).type == "cuda"
    print(f"device: {torch.cuda.get_device_name(a.device) if on_card else 'cpu (the plain versions; no time is measured)'}")
    for n in a.sizes:
        r = run(n, a.device, d=a.d)
        print(f"n={n} d={a.d}: words rel err {r['err']:.2e}, B3 rel err {r['b3_err']:.2e} "
              f"(max |y - truth| / max |truth|); words built on the host in "
              f"{r['build_s']:.3f} s")
        if on_card:
            print(f"  words: {r['ms']:8.4f} ms ({r['ms'] * 1e9 / n**2:.4f} ps/entry), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), tensor-core time (a model) "
                  f"{r['tensor_ms']:.4f} ms")
            print(f"  B3:    {r['b3_ms']:8.4f} ms ({r['b3_ms'] * 1e9 / n**2:.4f} ps/entry)")


if __name__ == "__main__":
    main()
