"""Probe P2: kernel B3 stripped stage by stage, to split its time between
the distance, the exp and the accumulate.

Port of ``benchmarks/df64_ablate.py``, which timed stripped variants of the
TPU's pair-arithmetic matvec. Here the variants are instantiations of B3's
own CUDA design (``ops/csrc/sqexp_ablate.cu``; d = 2), in native FP64:

- ``d2``: y_i = sum_j d2_ij, the distance only;
- ``d2exp32``: sum_j expf(-d2_ij / 2) v_j, a float32 exp and accumulate
  after the FP64 distance;
- ``d2exp``: sum_j exp(-d2_ij / 2), the FP64 exp without v;
- ``noexp``: sum_j d2_ij v_j, B3's accumulate with E := d2;
- ``full``: B3 itself;
- ``d2b`` / ``fullb``: ``d2`` / ``full`` with the column operands passed
  round the warp by shuffles instead of shared-memory broadcast reads;
- ``d2s2``, ``d2s4`` / ``fulls2``, ``fulls4``: ``d2`` / ``full`` with 2 or 4
  output rows per thread.

``sqexp_ablate`` launches the kernel for operands on a CUDA device and runs
the plain version ``_ablate_reference`` (float64 torch, float32 for
``d2exp32``, row block by row block as ``df64._fused_reference``) for
operands on the CPU. ``run`` times every variant and B3 beside them with
CUDA events, each with its operations bound; ``KERNEL_LAUNCHES`` counts the
kernel's launches.

    python -m inference_tpu_torch.probes.df64_ablate [n] [--variants d2,full]
    python -m inference_tpu_torch.probes.df64_ablate 512 --device cpu
"""

import argparse

import numpy as np
import torch

from ..ops import _build, df64
from . import EXP_FLOPS, FP64_FLOPS, bound, time_events

N = 53_248  # gp-large-50k's padded n
D = 2
VARIANTS = ("d2", "d2b", "d2s2", "d2s4", "d2exp32", "d2exp", "noexp", "full", "fullb",
            "fulls2", "fulls4")
# the function each variant computes, and its rows per thread
FUNCTION = {"d2b": "d2", "d2s2": "d2", "d2s4": "d2", "fullb": "full", "fulls2": "full",
            "fulls4": "full"}
ROWS_PER_THREAD = {"d2s2": 2, "d2s4": 4, "fulls2": 2, "fulls4": 4}
# FP64 flops per entry: 3 d for the distance, then the accumulate (1 for a
# plain sum, 2 for an fma) and, with an exp, the scale and the exp; d2exp32's
# float32 exp and accumulate run beside it on the FP32 lanes
FLOPS = {"d2": 3 * D + 1, "d2exp32": 3 * D + 1, "d2exp": 3 * D + 2 + EXP_FLOPS,
         "noexp": 3 * D + 2, "full": 3 * D + 3 + EXP_FLOPS}

KERNEL_LAUNCHES = 0  # launches of the kernel in this process


def function_of(variant):
    return FUNCTION.get(variant, variant)


def make_inputs(n=N, device="cuda", seed=0):
    """``benchmarks/df64_ablate.py``'s data: x ~ U[0, 10]^2 from ``seed`` as
    a float32 pair (``df64.split_f64``, as B3 takes it) and v ~ N(0, 1) in
    float32. Returns (us_hi, us_lo, us64 = hi + lo, v) on ``device``."""
    rng = np.random.default_rng(seed)
    uh, ul = df64.split_f64(rng.uniform(0, 10, size=(n, D)))
    v = rng.normal(size=n).astype(np.float32)
    uh, ul, v = (torch.as_tensor(a, device=device) for a in (uh, ul, v))
    return uh, ul, uh.double() + ul.double(), v


def _ablate_reference(us64, v, variant):
    """The kernel's plain version: the variant's term of every entry (the
    distance formed as ``df64._entry_block`` forms it), times v or ones,
    summed over j by a matmul, row block by row block. Float64, float32 for
    ``d2exp32``."""
    fn = function_of(variant)
    n = us64.shape[0]
    if fn == "d2exp32":
        w = v
    elif fn in ("noexp", "full"):
        w = v.double()
    else:
        w = torch.ones(n, dtype=torch.float64, device=us64.device)
    out = torch.empty(n, dtype=w.dtype, device=us64.device)
    for blk in df64._row_blocks(n, n):
        dist = torch.zeros((blk.stop - blk.start, n), dtype=torch.float64, device=us64.device)
        for k in range(us64.shape[1]):
            diff = us64[blk, k][:, None] - us64[:, k][None, :]
            dist = dist + diff * diff
        if fn == "d2exp32":
            term = torch.exp((-0.5 * dist).float())
        elif fn in ("d2exp", "full"):
            term = torch.exp(-0.5 * dist)
        else:
            term = dist
        out[blk] = term @ w
    return out


def _launch_ablate(us64, v, variant):
    """Launch ``csrc/sqexp_ablate.cu`` on contiguous FP64 coordinates and
    float32 v on one CUDA device, with the result of ``_ablate_reference``."""
    global KERNEL_LAUNCHES
    for name, t, dt in (("us", us64, torch.float64), ("v", v, torch.float32)):
        if t.device.type != "cuda" or t.device != us64.device:
            raise ValueError(f"kernel P2: {name} is on {t.device}; every operand must be on "
                             f"one CUDA device")
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"kernel P2: {name} must be contiguous {dt}, got {t.dtype} "
                            f"(contiguous={t.is_contiguous()})")
    n = us64.shape[0]
    rpt = ROWS_PER_THREAD.get(variant, 1)
    splits = df64._splits(-(-n // rpt), n, us64.device)
    dtype = torch.float32 if variant == "d2exp32" else torch.float64
    partial = torch.empty((splits, n), dtype=dtype, device=us64.device)
    fn = _build.bind("sqexp_ablate", "sqexp_ablate", 3, 3)
    with torch.cuda.device(us64.device):
        rc = fn(us64.data_ptr(), v.data_ptr(), partial.data_ptr(), n, VARIANTS.index(variant),
                splits, _build.stream(us64.device))
    _build.raise_on(rc, "P2")
    KERNEL_LAUNCHES += 1
    return partial[0] if splits == 1 else partial.sum(dim=0)


def sqexp_ablate(us64, v, variant):
    """Variant ``variant`` of B3 on FP64 coordinates ``us64`` (n, 2), n a
    multiple of 128, and float32 ``v`` (n,). On a CUDA device the kernel; on
    the CPU its plain version."""
    caller = "sqexp_ablate"
    if variant not in VARIANTS:
        raise ValueError(f"[ {caller} error ] variant must be one of {VARIANTS}, got {variant!r}.")
    if us64.dtype != torch.float64 or us64.ndim != 2 or us64.shape[1] != D:
        raise TypeError(f"[ {caller} error ] us64 must be float64 (n, {D}), got {us64.dtype} "
                        f"{tuple(us64.shape)}.")
    df64._check_coords(us64, caller)
    if v.dtype != torch.float32 or v.shape != (us64.shape[0],):
        raise TypeError(f"[ {caller} error ] v must be float32 ({us64.shape[0]},), got "
                        f"{v.dtype} {tuple(v.shape)}.")
    if df64._same_device(caller, us64, v).type == "cuda":
        return _launch_ablate(us64.contiguous(), v.contiguous(), variant)
    return _ablate_reference(us64, v, variant)


def variant_bound(variant, n):
    """(ms, "operations" or "bytes"): the variant's least time at n, with
    chip_smoke.py's arithmetic: the coordinates, v and y moved once, the FP64
    flops over 33.5 TFLOP/s."""
    fn = function_of(variant)
    out_bytes = 4 if fn == "d2exp32" else 8
    return bound((8 * D + 4 + out_bytes) * n, float(n) * n * FLOPS[fn], FP64_FLOPS)


def run(n=N, device="cuda", variants=VARIANTS, time_reps=5, seed=0):
    """Every variant and B3 (``df64.sqexp_matvec_df64``) once at n on the
    same inputs. On a CUDA device each is timed with CUDA events: ms,
    picoseconds per entry and the bound. On the CPU the plain versions run
    and no time is taken. Returns one dict a variant, and B3's last."""
    uh, ul, us64, v = make_inputs(n, device, seed)
    calls = [(variant, sqexp_ablate, (us64, v, variant)) for variant in variants]
    calls.append(("B3", df64.sqexp_matvec_df64, (uh, ul, v)))
    rows = []
    for name, fn, args in calls:
        y = fn(*args)
        b_ms, b_by = variant_bound("full" if name == "B3" else name, n)
        row = {"variant": name, "checksum": float(y.double().sum()), "ms": None,
               "bound_ms": b_ms, "bound_by": b_by}
        if us64.device.type == "cuda":
            ms = time_events(fn, args, time_reps)
            row.update(ms=ms, ps_per_entry=ms * 1e9 / n**2)
        rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=N)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda":
        print(f"device: {torch.cuda.get_device_name(a.device)}, n={a.n}")
    else:
        print(f"device: cpu (the plain versions; no time is measured), n={a.n}")
    for r in run(a.n, a.device, a.variants.split(",")):
        head = f"  {r['variant']:8s}:"
        if r["ms"] is None:
            print(f"{head} checksum {r['checksum']:.9e}")
        else:
            print(f"{head} {r['ms']:8.4f} ms ({r['ps_per_entry']:.4f} ps/entry); bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['ms'] / r['bound_ms']:.2f}x")


if __name__ == "__main__":
    main()
