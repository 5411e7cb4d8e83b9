"""Pairwise squared distances and the squared-exponential covariance, with
kernel B2 and its plain version.

Port of ``inference_tpu.ops.pairwise``.

- ``scaled_sq_distances`` and ``_sqexp_fallback``: the matmul form
  ``|u'|^2 + |v'|^2 - 2 u' v'^T`` (``u' = u / l``), for small blocks.
- Kernel B2 (``csrc/sqexp.cu``, CUDA C++ for Hopper):
  ``A^2 exp(-1/2 sum_k (us_ik - vs_jk)^2)`` from exact per-coordinate
  differences of the pre-scaled rows, with the exponential fused into the
  one pass that writes the M x N block. ``_sqexp_reference`` is its plain
  version, the same arithmetic in the same order as separate torch
  operations; ``_launch_sqexp`` is the wrapper that launches it, by the
  plan ``sqexp_plan``, from the library of its D (``kernel_variant``: one
  per D up to ``B2_D_REG``, one wide library above).
- ``SqexpCovariance``: the ``torch.autograd.Function`` around B2 (the JAX
  package's ``_sqexp_pallas_diff``), whose backward is plain torch
  (``_sqexp_backward``, ``_sqexp_position_backward``).
- ``sqexp_covariance``: the dispatch. Blocks with both sides >=
  ``_PALLAS_MIN_N`` rows go through ``SqexpCovariance``, which launches B2
  on a CUDA tensor and runs ``_sqexp_reference`` on a CPU tensor; smaller
  blocks take the matmul form.
"""

import contextlib
import contextvars
from typing import NamedTuple

import torch

from . import _build

_PALLAS_MIN_N = 2048  # both sides at least this many rows take kernel B2
# kernel B2: one library per D up to this D (a thread holds its columns'
# coordinates in registers), one wide library for any larger D, which was
# the faster above D = 5 on the H100 (PERF.md)
B2_D_REG = 5
B2_TILE_M = 32  # rows of an output tile of kernel B2 (csrc/sqexp.cu TM)
ROUTES = {"scalar": 0, "vector": 1}  # kernel B2's store routes (csrc/sqexp.cu Route)

# launches of kernel B2 in this process; the wrapper adds one per launch
KERNEL_LAUNCHES = 0

# set only inside CovarianceFunction.covariance_and_gradients: forward-mode
# autodiff (torch.func.jacfwd) cannot pass through SqexpCovariance, so that
# method builds its matrices on the matmul form
_MATMUL_FORM = contextvars.ContextVar("matmul_form", default=False)


@contextlib.contextmanager
def _matmul_form():
    token = _MATMUL_FORM.set(True)
    try:
        yield
    finally:
        _MATMUL_FORM.reset(token)


def _as_rows(u):
    u = torch.as_tensor(u)
    return u.reshape(1, -1) if u.ndim < 2 else u


def scaled_sq_distances(u, v, lengthscales):
    """Pairwise squared distances between the rows of ``u`` (M, D) and
    ``v`` (N, D) after per-dimension scaling by ``lengthscales`` (D,), as
    ``|u'|^2 + |v'|^2 - 2 u'.v'``. Returns (M, N). Cancellation can leave
    values of about -1e-16 at zero distance; they are not clamped, since
    ``max(d, 0)`` would corrupt second derivatives there."""
    u, v = _as_rows(u), _as_rows(v)
    ls = torch.as_tensor(lengthscales, dtype=u.dtype, device=u.device)
    us = u / ls[None, :]
    vs = v / ls[None, :]
    uu = (us * us).sum(dim=1)
    vv = (vs * vs).sum(dim=1)
    return uu[:, None] + vv[None, :] - 2.0 * (us @ vs.T)


def _sqexp_fallback(u, v, amplitude, lengthscales):
    return (amplitude**2) * torch.exp(-0.5 * scaled_sq_distances(u, v, lengthscales))


def _scaled(u, v, lengthscales):
    """The pre-scaled rows ``u / l`` and ``v / l`` that kernel B2 reads."""
    return (u / lengthscales[None, :]).contiguous(), (v / lengthscales[None, :]).contiguous()


def _sqexp_reference(u, v, amplitude, lengthscales):
    """Kernel B2's plain version: exact per-coordinate differences of the
    pre-scaled rows accumulated over k in order, then the exponential, on
    any device and dtype. Returns (M, N)."""
    us, vs = _scaled(u, v, lengthscales)
    dist = torch.zeros((us.shape[0], vs.shape[0]), dtype=us.dtype, device=us.device)
    for k in range(us.shape[1]):
        diff = us[:, k][:, None] - vs[:, k][None, :]
        dist = dist + diff * diff
    return (amplitude**2) * torch.exp(-0.5 * dist)


def kernel_variant(d: int) -> tuple:
    """The nvcc defines of kernel B2's library for ``d`` feature dimensions:
    its own up to ``B2_D_REG``, the wide library (``B2_D = 0``) above."""
    return (("B2_D", d if d <= B2_D_REG else 0),)


class SqexpPlan(NamedTuple):
    """The work of kernel B2's launch, which the kernel takes as given:
    output tiles of ``tile_m`` rows by ``tile_n`` columns (1 KiB of a row),
    ``tiles_m`` by ``tiles_n`` of them, walked by ``blocks`` blocks in
    row-major tile order (block b takes tiles b, b + blocks, ...), stored
    by ``route`` (``ROUTES``)."""

    tile_m: int
    tile_n: int
    tiles_m: int
    tiles_n: int
    blocks: int
    route: str


def _blocks_per_sm(d: int) -> int:
    """The blocks per SM to which kernel B2's library for ``d`` holds its
    registers (csrc/sqexp.cu MINB): its persistent walk launches that many."""
    return 4 if d <= 4 else 3


def sqexp_plan(m, n, d, dtype, sms) -> SqexpPlan:
    """Kernel B2's plan for an (m, n) block of ``d`` features in ``dtype``
    on a card of ``sms`` SMs: every output tile exactly once, as many
    blocks as fit on the SMs at once (``_blocks_per_sm``) and none without
    a tile; 16-byte stores where a row of the output is whole 16-byte
    units, else one store per entry."""
    size = dtype.itemsize
    tile_n = 1024 // size
    tiles_m, tiles_n = -(-m // B2_TILE_M), -(-n // tile_n)
    route = "vector" if n * size % 16 == 0 else "scalar"
    return SqexpPlan(B2_TILE_M, tile_n, tiles_m, tiles_n,
                     min(tiles_m * tiles_n, sms * _blocks_per_sm(d)), route)


def _launch_sqexp(u, v, amplitude, lengthscales):
    """Launch kernel B2 on CUDA tensors, with the signature and result of
    ``_sqexp_reference``. ``u`` (M, D) and ``v`` (N, D) are contiguous,
    float32 or float64, on one CUDA device; ``amplitude`` (a scalar) and
    ``lengthscales`` (D,) have their dtype and device. Raises on anything
    else, and when the library of its D fails to build, load or launch; it
    never casts or copies an input."""
    global KERNEL_LAUNCHES
    amplitude = torch.as_tensor(amplitude)
    for name, x in (("u", u), ("v", v), ("amplitude", amplitude),
                    ("lengthscales", lengthscales)):
        if x.device.type != "cuda" or x.device != u.device:
            raise ValueError(
                f"kernel B2: {name} is on {x.device}; every operand must be on "
                f"one CUDA device (u is on {u.device})"
            )
        if x.dtype not in (torch.float32, torch.float64) or x.dtype != u.dtype:
            raise TypeError(
                f"kernel B2 takes float32 or float64 operands of one dtype; "
                f"{name} is {x.dtype}, u is {u.dtype}. The wrapper does not cast"
            )
    if u.ndim != 2 or v.ndim != 2 or u.shape[1] != v.shape[1]:
        raise ValueError(
            f"kernel B2 takes u (M, D) and v (N, D), got {tuple(u.shape)} and "
            f"{tuple(v.shape)}"
        )
    m, d = u.shape
    n = v.shape[0]
    if amplitude.numel() != 1 or tuple(lengthscales.shape) != (d,):
        raise ValueError(
            f"kernel B2 takes a scalar amplitude and ({d},) lengthscales, got "
            f"{tuple(amplitude.shape)} and {tuple(lengthscales.shape)}"
        )
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel B2 takes contiguous u and v")
    if m < 1 or n < 1 or d < 1:
        raise ValueError(f"kernel B2 needs non-empty operands, got M={m} N={n} D={d}")

    symbol = "sqexp_f64" if u.dtype == torch.float64 else "sqexp_f32"
    try:
        fn = _build.bind("sqexp", symbol, 4, 9, kernel_variant(d))
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"kernel B2 for D = {d} failed to build or load: {e}") from e
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    plan = sqexp_plan(m, n, d, u.dtype, sms)
    us, vs = _scaled(u, v, lengthscales)
    amp_sq = (amplitude**2).reshape(1).contiguous()
    out = torch.empty((m, n), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        rc = fn(us.data_ptr(), vs.data_ptr(), amp_sq.data_ptr(), out.data_ptr(), m, n, d,
                plan.tile_m, plan.tile_n, plan.tiles_m, plan.tiles_n, plan.blocks,
                ROUTES[plan.route], _build.stream(u.device))
    _build.raise_on(rc, f"B2 (D = {d})")
    KERNEL_LAUNCHES += 1
    return out


def _sqexp_block(u, v, amplitude, lengthscales):
    """Kernel B2 on a CUDA tensor, its plain version on a CPU tensor."""
    if u.device.type == "cuda":
        return _launch_sqexp(u, v, amplitude, lengthscales)
    if u.device.type == "cpu":
        return _sqexp_reference(u, v, amplitude, lengthscales)
    raise ValueError(f"no squared-exponential path for device {u.device}")


def _sqexp_position_backward(u, v, lengthscales, K, Kbar):
    """Position cotangents of the squared-exponential covariance: with
    ``w = K * Kbar`` and ``us = u/l``, ``vs = v/l``,

        dL/du_ik = -(1/l_k) (us_ik sum_j w_ij - (w @ vs)_ik)
        dL/dv_jk = -(1/l_k) (vs_jk sum_i w_ij - (w.T @ us)_jk)

    one row or column reduction and one matrix product each."""
    ls = lengthscales[None, :]
    us = u / ls
    vs = v / ls
    w = K * Kbar
    du = -(us * w.sum(dim=1)[:, None] - w @ vs) / ls
    dv = -(vs * w.sum(dim=0)[:, None] - w.T @ us) / ls
    return du, dv


def _sqexp_backward(u, v, lengthscales, K, Kbar):
    """Hyperparameter reductions of the squared-exponential covariance for
    the cotangent ``Kbar``:

        g_amp = sum_ij Kbar_ij K_ij
        g_l_k = sum_ij Kbar_ij K_ij ((u_ik - v_jk)/l_k)^2

    so no per-parameter dK matrix is ever built."""
    us = u / lengthscales[None, :]
    vs = v / lengthscales[None, :]
    w = K * Kbar
    g_ls = torch.stack(
        [(w * (us[:, k][:, None] - vs[:, k][None, :]) ** 2).sum()
         for k in range(u.shape[1])]
    )
    return w.sum(), g_ls


class SqexpCovariance(torch.autograd.Function):
    """``A^2 exp(-1/2 sum_k ((u_ik - v_jk)/l_k)^2)`` through kernel B2 (its
    plain version on the CPU), differentiable in all four arguments."""

    @staticmethod
    def forward(ctx, u, v, amplitude, lengthscales):
        K = _sqexp_block(u, v, amplitude, lengthscales)
        ctx.save_for_backward(u, v, amplitude, lengthscales, K)
        return K

    @staticmethod
    def backward(ctx, Kbar):
        u, v, amplitude, lengthscales, K = ctx.saved_tensors
        g_amp, g_ls = _sqexp_backward(u, v, lengthscales, K, Kbar)
        # dK/dA = 2 K / A;  dK/dl_k = K scaled_diff_k^2 / l_k
        d_amp = (2.0 * g_amp / amplitude).reshape(amplitude.shape)
        d_ls = g_ls / lengthscales
        d_u = d_v = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_u, d_v = _sqexp_position_backward(u, v, lengthscales, K, Kbar)
        return d_u, d_v, d_amp, d_ls


def sqexp_covariance(u, v, amplitude, lengthscales):
    """Squared-exponential covariance block
    ``A^2 exp(-1/2 sum_k ((u_ik - v_jk)/l_k)^2)``, differentiable in all
    four arguments. Blocks with both sides >= ``_PALLAS_MIN_N`` rows go
    through kernel B2 (its plain version on the CPU), smaller ones through
    the matmul form. The JAX package also sent float64 blocks to the
    matmul form, because TPU Pallas has no float64; the card has, so both
    dtypes take the kernel here."""
    u, v = _as_rows(u), _as_rows(v)
    like = dict(dtype=u.dtype, device=u.device)
    amplitude = torch.as_tensor(amplitude, **like)
    lengthscales = torch.as_tensor(lengthscales, **like)
    if (
        not _MATMUL_FORM.get()
        and u.shape[0] >= _PALLAS_MIN_N
        and v.shape[0] >= _PALLAS_MIN_N
    ):
        return SqexpCovariance.apply(u.contiguous(), v.contiguous(), amplitude, lengthscales)
    return _sqexp_fallback(u, v, amplitude, lengthscales)
