"""The squared-exponential kernel matrix of the matrix-free small-noise GP
tier, in native FP64: kernels B3-B8 and their plain versions.

Port of ``inference_tpu.ops.df64``. The JAX package carries every quantity
there as a pair of float32 words ``(hi, lo)`` and evaluates
``exp(-1/2 d^2)`` in pair arithmetic, because the TPU has no float64. The
card has, so the port keeps the public names and the ``(us_hi, us_lo)``
float32-pair signatures (the tests feed both packages the same arrays),
forms ``us = hi.double() + lo.double()`` (an exact sum) and runs everything
after that in FP64. The pair-arithmetic helpers (``two_sum``, ``df_mul``,
``df_exp_neg`` and the rest) have no job here and are not ported.

With ``E_ij = exp(-1/2 |us_i - us_j|^2)``:

- ``sqexp_matvec_df64`` (B3) and ``sqexp_matmat_df64`` /
  ``sqexp_matmat_rect_df64`` (B4): ``E V`` evaluated entry by entry and
  never stored, one CUDA kernel (``csrc/sqexp_fused.cu``); B3 is its
  ``q = 1`` launch. ``sqexp_matmat_df64_sharded`` runs B4 on each cell's
  block of rows of a mesh (``parallel.mesh``).
- ``sqexp_entries_df64`` (B5): E itself as one FP64 (n, n) tensor, 8 bytes
  per entry as the pair was (``csrc/sqexp_entries.cu``).
- ``sqexp_stored_matmat_df64`` / ``sqexp_stored_matvec_df64`` (B6): ``E V``
  from the stored E (``csrc/sqexp_stored.cu``). They also take the JAX
  package's ``(E_hi, E_lo)`` pair in E's place.
- ``sqexp_entries_f32`` (B7, ``csrc/sqexp_entries.cu``): E rounded to
  float32, 4 bytes per entry; ``sqexp_stored_f32_matmat`` (B8,
  ``csrc/sqexp_stored.cu``): its product with float32 ``V``, exact products
  summed in FP64. The tier that iterates on it refreshes its residuals
  through B3/B4 (``gp.large_scale``).
- ``stored_entries_tier``: the one storage policy, sized for 80 GB.

Right-hand sides ``V`` are float32 (the solver's float32 search
directions) and results float64, as in the JAX package; ``n`` is a
multiple of 128 (``_TJ``/``_TI``). Each wrapper launches its CUDA kernel for
operands on a CUDA device and raises on what the kernel does not take; for
operands on the CPU it runs the kernel's plain version (``_fused_reference``,
``_entries_reference``, ``_entries_f32_reference``, ``_stored_reference``),
which forms each entry with the same operations in the same order. ``KERNEL_LAUNCHES`` counts the
launches of each kernel, ``STORED_LAUNCHES_BY_Q`` those of B6 and B8 by q.
"""

from typing import NamedTuple
from warnings import warn

import numpy as np
import torch

from . import _build

_TJ = 128  # column tile of the kernels; n must be a multiple
_TI = 128  # row tile of the kernels
D_MAX = 16  # above this coordinate dimension B3/B4 and B5/B7 take their wide kernels
Q_MAX = 16  # the largest right-hand-side block one kernel launch takes

# launches of each kernel in this process; each wrapper adds one per launch
KERNEL_LAUNCHES = {"B3": 0, "B4": 0, "B5": 0, "B6": 0, "B7": 0, "B8": 0}

# the largest padded n the FP64 and the float32 entry stores serve under
# store_entries="auto" (see stored_entries_tier)
STORE_MAX_N = 81_920
F32_STORE_MAX_N = 114_688

_BLOCK_ELEMS = 1 << 27  # entries per row block of the plain versions (1 GiB)


def split_f64(a):
    """Host helper: split float64 array(s) into a (hi, lo) float32 pair."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


# --------------------------------------------------------------------- #
# operand checks
# --------------------------------------------------------------------- #
def _tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _float32(name, a, caller):
    a = _tensor(a)
    if a.dtype != torch.float32:
        raise TypeError(
            f"[ {caller} error ] {name} must be float32 (the JAX package's "
            f"contract); got {a.dtype}. The function does not cast."
        )
    return a


def _pair_sum(hi, lo, caller):
    """``hi + lo`` of a float32 pair in float64: exact."""
    hi, lo = _float32("the pair's high word", hi, caller), _float32("the pair's low word", lo, caller)
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError(
            f"[ {caller} error ] the pair's words differ in shape or device: "
            f"{tuple(hi.shape)} on {hi.device}, {tuple(lo.shape)} on {lo.device}."
        )
    return hi.double() + lo.double()


def _same_device(caller, *tensors):
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in tensors):
        raise ValueError(
            f"[ {caller} error ] the operands must lie on one CPU or CUDA "
            f"device; got {', '.join(str(t.device) for t in tensors)}."
        )
    return dev


def _check_coords(us, caller, what="n"):
    if us.ndim != 2:
        raise ValueError(f"[ {caller} error ] coordinates must be 2D (n, d), got {tuple(us.shape)}.")
    n, d = us.shape
    if n % _TJ != 0 or n == 0:
        raise ValueError(
            f"[ {caller} error ] {what} ({n}) must be a multiple of {_TJ}; "
            f"pad the data rows (zero-padded v entries are inert)."
        )
    if d < 1:
        raise ValueError(f"[ {caller} error ] coordinates need at least one dimension, got {d}.")


def _check_block(V, n_cols, caller):
    if V.ndim != 2:
        raise ValueError(f"[ {caller} error ] V must be 2D (n, q); got {tuple(V.shape)}.")
    if V.shape[0] != n_cols:
        raise ValueError(
            f"[ {caller} error ] V has {V.shape[0]} rows but there are "
            f"{n_cols} column points."
        )
    if V.shape[1] < 1:
        raise ValueError(f"[ {caller} error ] V needs at least one right-hand side.")


def _by_column_blocks(fn, V):
    """``fn`` over ``V``'s columns in blocks of at most ``Q_MAX`` (the
    kernels' bound), concatenated. Each column of a product is independent
    of the others, so each computes what it does in a block of its own."""
    if V.shape[1] <= Q_MAX:
        return fn(V)
    return torch.cat([fn(V[:, c:c + Q_MAX]) for c in range(0, V.shape[1], Q_MAX)], dim=1)


def _row_blocks(n_rows, n_cols):
    step = max(1, _BLOCK_ELEMS // max(n_cols, 1))
    return [slice(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


def _entry_block(rows64, cols64):
    """``exp(-1/2 |r_i - c_j|^2)`` for a block of rows: exact differences
    accumulated over k in order, then the exponential (the kernels' order)."""
    dist = torch.zeros((rows64.shape[0], cols64.shape[0]), dtype=torch.float64,
                       device=rows64.device)
    for k in range(rows64.shape[1]):
        diff = rows64[:, k][:, None] - cols64[:, k][None, :]
        dist = dist + diff * diff
    return torch.exp(-0.5 * dist)


# --------------------------------------------------------------------- #
# B3 / B4: the fused matmat
# --------------------------------------------------------------------- #
def _fused_reference(rows64, cols64, V):
    """Kernels B3/B4's plain version: each row block's entries as
    ``_entry_block`` forms them, then their product with ``V`` in float64.
    Returns (n_rows, q) float64."""
    V64 = V.double()
    out = torch.empty((rows64.shape[0], V.shape[1]), dtype=torch.float64, device=rows64.device)
    for blk in _row_blocks(rows64.shape[0], cols64.shape[0]):
        out[blk] = _entry_block(rows64[blk], cols64) @ V64
    return out


def _column_splits(row_blocks, n_tiles, sms):
    """Column splits of a launch of ``row_blocks`` row blocks on ``sms``
    SMs: about sixteen blocks per SM (a few waves of the blocks that fit at
    once), at least two column tiles per split."""
    return max(1, min(-(-16 * sms // row_blocks), n_tiles // 2))


def _splits(n_rows, n_cols, device):
    """Column splits of a launch of one row per thread (probes P2, P3)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _column_splits(-(-n_rows // _TI), n_cols // _TJ, sms)


# output rows per thread of kernels B3/B4 for each bucket of q (the kernel's
# QMAX template parameter), the fastest without spills on the H100 (PERF.md);
# csrc/sqexp_fused.cu instantiates exactly these and refuses any other
FUSED_RPT = {1: 4, 2: 4, 4: 4, 8: 2, 16: 2}


def fused_plan(n_rows, n_cols, q, sms):
    """The work of each block of a fused launch on a card with ``sms`` SMs,
    which the kernel takes as given: ``(rpt, splits, tiles_per_split)``. A
    block of 128 threads owns ``128 rpt`` output rows, each thread ``rpt``
    rows 128 apart; column split ``s`` walks the 128-column tiles ``[s
    tiles_per_split, (s + 1) tiles_per_split)``, the last one cut at
    ``n_cols``. ``rpt`` is ``FUSED_RPT`` of q's bucket; every split holds at
    least one tile and, where there are two or more, at least two."""
    rpt = FUSED_RPT[next(b for b in FUSED_RPT if q <= b)]
    n_tiles = n_cols // _TJ
    per = -(-n_tiles // _column_splits(-(-n_rows // (_TI * rpt)), n_tiles, sms))
    return rpt, -(-n_tiles // per), per


WIDE_KC = 4  # the wide kernels' unrolled step of dimensions: d is padded to a multiple
WIDE_DC = 16  # B3/B4's wide chunk of dimensions where all of d_pad's do not fit
SMEM_MAX = 232_448  # dynamic shared memory one block may take on the H100


class WidePlan(NamedTuple):
    """The plan of one launch of the wide fused kernel (``fused_wide_plan``)."""
    splits: int   # column splits (blockIdx.y)
    per: int      # 128-column tiles per split
    d_pad: int    # d rounded up to a multiple of WIDE_KC; the pad dimensions are zeros
    dc: int       # dimensions staged per chunk: d_pad where they fit, else WIDE_DC
    smem: int     # dynamic shared memory of a block, bytes


def pad_dims(d):
    """``d`` rounded up to a multiple of ``WIDE_KC``: the width of the wide
    kernels' zero-padded coordinates. Adding (0 - 0)^2 = +0 to a distance
    leaves it bit for bit, so the padded coordinates give the same
    entries."""
    return -(-d // WIDE_KC) * WIDE_KC


def fused_wide_plan(n_rows, n_cols, d, q, sms):
    """The plan of a launch of the wide fused kernel (d > ``D_MAX``) on a
    card with ``sms`` SMs, which the kernel takes as given. A block of 128
    threads owns 128 rows, one a thread; the splits and tiles per split are
    those of ``fused_plan`` at one row a thread. A block stages its rows and
    two 128-column tiles of all ``d_pad`` dimensions in shared memory beside
    two tiles of v (q's bucket, widened to double); where those exceed
    ``SMEM_MAX`` it walks each tile in chunks of ``WIDE_DC`` dimensions,
    with two buffers of rows and the tile's 128 x 128 partial distances in
    shared memory."""
    bucket = next(b for b in FUSED_RPT if q <= b)
    n_tiles = n_cols // _TJ
    per = -(-n_tiles // _column_splits(-(-n_rows // _TI), n_tiles, sms))
    d_pad = pad_dims(d)
    v_doubles = 2 * _TJ * bucket
    whole = 8 * (d_pad * (_TI + 2 * _TJ) + v_doubles)
    if whole <= SMEM_MAX:
        return WidePlan(-(-n_tiles // per), per, d_pad, d_pad, whole)
    chunked = 8 * (WIDE_DC * (2 * _TI + 2 * _TJ) + v_doubles + _TJ * _TI)
    return WidePlan(-(-n_tiles // per), per, d_pad, WIDE_DC, chunked)


def _launch_fused(rows64, cols64, V, kernel="B4"):
    """Launch the fused kernel (``csrc/sqexp_fused.cu``) on contiguous
    FP64 coordinates and a float32 block ``V`` on one CUDA device, with the
    result of ``_fused_reference``, by ``fused_plan`` (d <= ``D_MAX``) or
    ``fused_wide_plan``. Counts one launch of ``kernel`` (B3 for the
    matvec, B4 for the matmat)."""
    for name, t, dt in (("rows", rows64, torch.float64), ("cols", cols64, torch.float64),
                        ("V", V, torch.float32)):
        if t.device.type != "cuda" or t.device != rows64.device:
            raise ValueError(f"kernel {kernel}: {name} is on {t.device}; every operand must be "
                             f"on one CUDA device")
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"kernel {kernel}: {name} must be contiguous {dt}, got "
                            f"{t.dtype} (contiguous={t.is_contiguous()})")
    n_rows, d = rows64.shape
    n_cols, q = V.shape
    sms = torch.cuda.get_device_properties(rows64.device).multi_processor_count
    if d <= D_MAX:
        rpt, splits, per = fused_plan(n_rows, n_cols, q, sms)
        fn = _build.bind("sqexp_fused", "sqexp_fused_f64", 4, 7)
        plan = (rpt, splits, per)
    else:
        wp = fused_wide_plan(n_rows, n_cols, d, q, sms)
        fn = _build.bind("sqexp_fused", "sqexp_fused_wide_f64", 4, 9)
        splits = wp.splits
        plan = tuple(wp)
    partial = torch.empty((splits, n_rows, q), dtype=torch.float64, device=rows64.device)
    with torch.cuda.device(rows64.device):
        rc = fn(rows64.data_ptr(), cols64.data_ptr(), V.data_ptr(), partial.data_ptr(),
                n_rows, n_cols, d, q, *plan, _build.stream(rows64.device))
    _build.raise_on(rc, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return partial[0] if splits == 1 else partial.sum(dim=0)


def _fused(rows64, cols64, V, kernel):
    dev = _same_device(f"kernel {kernel}", rows64, cols64, V)
    if dev.type == "cuda":
        rows64, cols64 = rows64.contiguous(), cols64.contiguous()
        return _by_column_blocks(
            lambda W: _launch_fused(rows64, cols64, W.contiguous(), kernel), V)
    return _by_column_blocks(lambda W: _fused_reference(rows64, cols64, W), V)


def sqexp_matmat_rect_df64(rows_hi, rows_lo, cols_hi, cols_lo, V):
    """``Y[i, k] = sum_j E(r_i, c_j) V[j, k]`` with ``E(a, b) = exp(-1/2
    |a - b|^2)``, rows and columns from different pre-scaled coordinate
    pairs (kernel B4). ``V`` (n_cols, q) float32; returns (n_rows, q)
    float64. Both point counts must be multiples of 128."""
    caller = "sqexp_matmat_rect_df64"
    rows64 = _pair_sum(rows_hi, rows_lo, caller)
    cols64 = _pair_sum(cols_hi, cols_lo, caller)
    V = _float32("V", V, caller)
    _check_coords(rows64, caller, "row count")
    _check_coords(cols64, caller, "column count")
    if rows64.shape[1] != cols64.shape[1]:
        raise ValueError(f"[ {caller} error ] rows and columns differ in dimension.")
    _check_block(V, cols64.shape[0], caller)
    return _fused(rows64, cols64, V, "B4")


def sqexp_matmat_df64(us_hi, us_lo, V):
    """``Y = E V`` for a block of right-hand sides ``V`` (n, q) float32
    (kernel B4, one launch per 16 columns): returns float64 (n, q). ``n``
    must be a multiple of 128."""
    caller = "sqexp_matmat_df64"
    us64 = _pair_sum(us_hi, us_lo, caller)
    V = _float32("V", V, caller)
    _check_coords(us64, caller)
    _check_block(V, us64.shape[0], caller)
    return _fused(us64, us64, V, "B4")


def sqexp_matvec_df64(us_hi, us_lo, v):
    """``y = E v`` with ``E_ij = exp(-1/2 |us_i - us_j|^2)`` for pre-scaled
    coordinates given as a float32 pair (``split_f64``) and a float32
    vector (kernel B3, the ``q = 1`` launch of B4's kernel). Returns the
    float64 vector. Amplitude and diagonal terms are the caller's job.
    ``n`` must be a multiple of 128: pad with rows whose ``v`` is zero."""
    caller = "sqexp_matvec_df64"
    us64 = _pair_sum(us_hi, us_lo, caller)
    v = _float32("v", v, caller)
    _check_coords(us64, caller)
    if v.shape != (us64.shape[0],):
        raise ValueError(f"[ {caller} error ] v must be ({us64.shape[0]},), got {tuple(v.shape)}.")
    return _fused(us64, us64, v.reshape(-1, 1), "B3")[:, 0]


def mesh_row_cells(mesh, caller):
    """The cells of a mesh's first axis (at index 0 of any other). Cells of
    other processes are held to ``parallel._collectives.Layout``'s rules:
    every process of the group holds as many of them (a ValueError names a
    process that does not exist), each process's on one device (several
    raise, ROADMAP A13(c))."""
    from ..parallel._collectives import Layout
    from ..parallel.mesh import Mesh, cell_grid, process_info

    cells = list(mesh.devices.reshape(mesh.shape[mesh.axis_names[0]], -1)[:, 0])
    rank, _ = process_info()
    if any(c.rank != rank for c in cells):
        Layout(Mesh(cell_grid(cells, (len(cells),)), ("rows",)), 1, caller)
    return cells


def sqexp_matmat_df64_sharded(us_hi, us_lo, V, mesh):
    """
    Row-sharded ``sqexp_matmat_df64`` over the cells of ``mesh``'s first
    axis (kernel B4 once per cell and block of 16 columns): each cell
    evaluates its block of ``E V``'s rows on its device against the full
    columns and ``V``, and the blocks come back in order, as float64
    ``(n, q)`` on the operands' device. ``n`` must split over the cells into
    row blocks that are multiples of 128. When the cells span processes,
    every process passes the full operands and runs its own cells' blocks,
    and one ``dist.all_gather`` gives each the whole product (NCCL between
    cards, gloo on the CPU or between processes that share a card).
    """
    caller = "sqexp_matmat_df64_sharded"
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    n = us_hi.shape[0]
    if n % (n_dev * _TI) != 0:
        raise ValueError(
            f"[ sqexp_matmat_df64_sharded error ] n ({n}) must split over "
            f"{n_dev} devices into row blocks that are multiples of {_TI}."
        )
    cells = mesh_row_cells(mesh, caller)
    us64 = _pair_sum(us_hi, us_lo, caller)
    V = _float32("V", V, caller)
    _check_coords(us64, caller)
    _check_block(V, n, caller)
    block = n // n_dev
    on = {}  # the columns and V on each cell's device, moved once

    def rows(k, device):
        if device not in on:
            on[device] = (us64.to(device), V.to(device))
        cols, Vd = on[device]
        return _fused(cols[k * block:(k + 1) * block], cols, Vd, "B4")

    from ..parallel._collectives import deal_blocks

    return deal_blocks(cells, block, n, rows, us64.device)


# --------------------------------------------------------------------- #
# B5: the entry store
# --------------------------------------------------------------------- #
def _entries_reference(us64):
    """Kernel B5's plain version: E (n, n) float64, row block by row block,
    with the kernel's operations in its order."""
    n = us64.shape[0]
    E = torch.empty((n, n), dtype=torch.float64, device=us64.device)
    for blk in _row_blocks(n, n):
        E[blk] = _entry_block(us64[blk], us64)
    return E


def _entries_f32_reference(us64):
    """Kernel B7's plain version: ``_entries_reference``'s entries rounded
    to float32 (to nearest), row block by row block."""
    n = us64.shape[0]
    E = torch.empty((n, n), dtype=torch.float32, device=us64.device)
    for blk in _row_blocks(n, n):
        E[blk] = _entry_block(us64[blk], us64).float()
    return E


# the entry store's kernels: output dtype -> (kernel, C entry point)
_ENTRIES = {torch.float64: ("B5", "sqexp_entries_f64"), torch.float32: ("B7", "sqexp_entries_f32")}


def _launch_entries(us64, dtype=torch.float64):
    """Launch kernel B5 (``dtype`` float64) or B7 (float32) of
    ``csrc/sqexp_entries.cu`` on contiguous FP64 coordinates on a CUDA
    device, with the result of ``_entries_reference`` or
    ``_entries_f32_reference``."""
    kernel, symbol = _ENTRIES[dtype]
    if us64.device.type != "cuda":
        raise ValueError(f"kernel {kernel}: us is on {us64.device}, not a CUDA device")
    if us64.dtype != torch.float64 or not us64.is_contiguous():
        raise TypeError(f"kernel {kernel}: us must be contiguous float64, got {us64.dtype}")
    n, d = us64.shape
    E = torch.empty((n, n), dtype=dtype, device=us64.device)
    fn = _build.bind("sqexp_entries", symbol, 2, 2)
    with torch.cuda.device(us64.device):
        rc = fn(us64.data_ptr(), E.data_ptr(), n, d, _build.stream(us64.device))
    _build.raise_on(rc, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return E


def sqexp_entries_df64(us_hi, us_lo):
    """Materialise ``E_ij = exp(-1/2 |us_i - us_j|^2)`` as one FP64 (n, n)
    tensor (kernel B5): 8 bytes per entry, 22.7 GB at n = 53,248. Every
    later ``sqexp_stored_matmat_df64`` then reads it instead of evaluating
    entries."""
    return _entries(us_hi, us_lo, torch.float64, "sqexp_entries_df64")


def sqexp_entries_f32(us_hi, us_lo):
    """Materialise ``fl32(exp(-1/2 |us_i - us_j|^2))``, the FP64 entry
    rounded to nearest float32, as an (n, n) float32 tensor (kernel B7): 4
    bytes per entry, 11.3 GB at n = 53,248. Its only error is that rounding,
    at most 2^-24 of each entry."""
    return _entries(us_hi, us_lo, torch.float32, "sqexp_entries_f32")


def _entries(us_hi, us_lo, dtype, caller):
    us64 = _pair_sum(us_hi, us_lo, caller)
    _check_coords(us64, caller)
    if us64.device.type == "cuda":
        return _launch_entries(us64.contiguous(), dtype)
    _same_device(caller, us64)
    return (_entries_reference if dtype == torch.float64 else _entries_f32_reference)(us64)


# --------------------------------------------------------------------- #
# B6: the stored matmat
# --------------------------------------------------------------------- #
def _stored_reference(E, V):
    """Kernels B6 and B8's plain version: ``E V`` in float64 (a float32 E
    widened, so every product is exact), row block by row block."""
    V64 = V.double()
    out = torch.empty((E.shape[0], V.shape[1]), dtype=torch.float64, device=E.device)
    for blk in _row_blocks(E.shape[0], E.shape[1]):
        out[blk] = E[blk].double() @ V64
    return out


# the stored product's kernels: entry dtype -> (kernel, C entry point)
_STORED = {torch.float64: ("B6", "sqexp_stored_f64"), torch.float32: ("B8", "sqexp_stored_f32")}
# launches of B6 and B8 in this process by q; each launch adds one
STORED_LAUNCHES_BY_Q = {"B6": {}, "B8": {}}
_STORED_MIN_ROWS = 32  # rows of one stage of the kernel's ring of E tiles


def stored_plan(n_rows, n_cols, q, sms):
    """The work of each block of a stored-product launch on a card with
    ``sms`` SMs, which the kernel takes as given: ``(row bounds, column
    bounds, panel columns)``. Row group ``r`` owns rows ``[rows[r],
    rows[r + 1])``, whole boxes of 4 rows (the kernel's TMA copies), at
    least 16 of them; column split ``s`` owns the 128-column tiles of
    ``[cols[s], cols[s + 1])``. The grid is one block per SM, and the
    columns are split only where the rows alone make fewer than ``sms``
    groups of 32 rows (a stage of the kernel's ring). A block walks its
    split in panels of ``panel`` columns, each staging its rows of V once
    into one of the kernel's two 64 KiB panel buffers: 1024 columns of one
    8-column n-tile of doubles at q <= 8, 512 of two n-tiles at q <= 16."""
    tiles = n_cols // _TJ
    splits = max(1, min(tiles, -(-sms // max(1, n_rows // _STORED_MIN_ROWS))))
    groups = max(1, min(sms // splits, n_rows // 16))
    boxes = n_rows // 4
    rows = [r * boxes // groups * 4 for r in range(groups + 1)]
    cols = [s * tiles // splits * _TJ for s in range(splits + 1)]
    return rows, cols, 1024 if q <= 8 else 512


def _launch_stored(E, V, dtype=torch.float64):
    """Launch kernel B6 (``dtype`` float64) or B8 (float32) of
    ``csrc/sqexp_stored.cu`` on a contiguous E of that dtype and float32 V
    on one CUDA device, with the result of ``_stored_reference``."""
    kernel, symbol = _STORED[dtype]
    for name, t, dt in (("E", E, dtype), ("V", V, torch.float32)):
        if t.device.type != "cuda" or t.device != E.device:
            raise ValueError(f"kernel {kernel}: {name} is on {t.device}; every operand must "
                             f"be on one CUDA device")
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"kernel {kernel}: {name} must be contiguous {dt}, got {t.dtype} "
                            f"(contiguous={t.is_contiguous()})")
    if E.data_ptr() % 16:
        raise ValueError(f"kernel {kernel}: E must be 16-byte aligned for the TMA")
    if V.data_ptr() % 16:
        V = V.clone()  # the kernel reads V with 16-byte loads
    n_rows, n_cols = E.shape
    q = V.shape[1]
    sms = torch.cuda.get_device_properties(E.device).multi_processor_count
    rows, cols, panel = stored_plan(n_rows, n_cols, q, sms)
    # host memory, read by the launcher into the kernel's parameters
    bounds = torch.tensor(rows + cols, dtype=torch.int32)
    splits = len(cols) - 1
    # two planes per split, one for each column half of the kernel's stages
    partial = torch.empty((2 * splits, n_rows, q), dtype=torch.float64, device=E.device)
    fn = _build.bind("sqexp_stored", symbol, 4, 6)
    with torch.cuda.device(E.device):
        rc = fn(E.data_ptr(), V.data_ptr(), partial.data_ptr(), bounds.data_ptr(), n_rows,
                n_cols, q, len(rows) - 1, splits, panel, _build.stream(E.device))
    _build.raise_on(rc, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    by_q = STORED_LAUNCHES_BY_Q[kernel]
    by_q[q] = by_q.get(q, 0) + 1
    return partial.sum(dim=0)


def _launch_stored_mma_tile(A, B):
    """``A @ B`` for FP64 A (16, 4) and B (4, 8) on a CUDA device by one
    m16n8k4 MMA with kernels B6/B8's fragment mapping: the layout check.
    Not counted as a launch of B6 or B8."""
    if A.shape != (16, 4) or B.shape != (4, 8) or A.device.type != "cuda":
        raise ValueError("the MMA tile takes CUDA A (16, 4) and B (4, 8)")
    A, B = A.double().contiguous(), B.double().contiguous()
    D = torch.empty((16, 8), dtype=torch.float64, device=A.device)
    fn = _build.bind("sqexp_stored", "sqexp_stored_mma_tile", 3, 0)
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), B.data_ptr(), D.data_ptr(), _build.stream(A.device))
    _build.raise_on(rc, "B6/B8 MMA tile")
    return D


def _stored_operands(args, caller):
    """``(E, V)`` from ``(E, V)`` or the JAX package's ``(E_hi, E_lo, V)``."""
    if len(args) == 3:
        return _pair_sum(args[0], args[1], caller), args[2]
    if len(args) == 2:
        return _tensor(args[0]), args[1]
    raise TypeError(f"[ {caller} error ] takes (E, V) or (E_hi, E_lo, V), got {len(args)} arguments.")


def sqexp_stored_matmat_df64(*args):
    """``Y = E V`` from the stored entries (kernel B6): ``(E, V)`` with E
    the FP64 (n, n) store of ``sqexp_entries_df64``, or the JAX package's
    ``(E_hi, E_lo, V)`` pair. ``V`` (n, q) float32; returns float64 (n, q).
    Accepts q = 1 for the matvec case."""
    caller = "sqexp_stored_matmat_df64"
    E, V = _stored_operands(args, caller)
    return _stored(E, V, torch.float64, caller)


def sqexp_stored_f32_matmat(E, V):
    """``Y = E V`` from the float32 store of ``sqexp_entries_f32`` (kernel
    B8): ``V`` (n, q) float32; returns float64 (n, q). Each product of two
    float32 words is exact in FP64 and the sums run in FP64, so the only
    error of the operator is the entries' rounding: the iteration operator
    of ``store_entries="f32"``."""
    return _stored(_tensor(E), V, torch.float32, "sqexp_stored_f32_matmat")


def _stored(E, V, dtype, caller):
    V = _float32("V", V, caller)
    if E.dtype != dtype or E.ndim != 2 or E.shape[0] != E.shape[1]:
        raise TypeError(f"[ {caller} error ] E must be a square {dtype} matrix, got "
                        f"{E.dtype} {tuple(E.shape)}.")
    if E.shape[0] % _TJ != 0:
        raise ValueError(f"[ {caller} error ] n ({E.shape[0]}) must be a multiple of {_TJ}.")
    _check_block(V, E.shape[0], caller)
    dev = _same_device(caller, E, V)
    if dev.type == "cuda":
        E = E.contiguous()
        return _by_column_blocks(lambda W: _launch_stored(E, W.contiguous(), dtype), V)
    return _by_column_blocks(lambda W: _stored_reference(E, W), V)


def sqexp_stored_matvec_df64(*args):
    """Single-vector form of ``sqexp_stored_matmat_df64``: ``(E, v)`` or
    ``(E_hi, E_lo, v)``."""
    *E, v = args
    return sqexp_stored_matmat_df64(*E, _tensor(v).reshape(-1, 1))[:, 0]


# --------------------------------------------------------------------- #
# storage policy
# --------------------------------------------------------------------- #
def stored_entries_tier(n_padded: int, store):
    """The one storage policy of the df64 tier, sized for one 80 GB H100.
    Returns ``"f64"`` (store E once in FP64, kernel B5, and multiply it in
    every iteration, kernel B6), ``"f32"`` (store E rounded to float32,
    kernel B7, iterate on it, kernel B8, and refresh the residuals through
    the fused kernel B3/B4) or ``None`` (evaluate the entries in every
    product, kernels B3/B4).

    The FP64 store takes 8 n^2 bytes: 21.5 GB at n = 51,200, 22.7 GB at
    53,248 (N = 50,000 padded to 4096-row blocks), 53.7 GB at
    ``STORE_MAX_N`` = 81,920. Beside it the tier holds the (n, m) FP64
    preconditioner factor (0.34 GB at n = 81,920, m = 512), a few (n, q)
    solver blocks and the (q, n) cross-covariances of a prediction, well
    under 1 GB, so 81,920 leaves about 25 GB of the 80 GB for them, for the
    caching allocator's slack and for a full-width check beside the store.
    The float32 store takes 4 n^2 bytes: 52.6 GB at ``F32_STORE_MAX_N`` =
    114,688, with the same room beside it (the factor is 0.47 GB there).

    ``store`` is the user's choice: ``"auto"`` stores in FP64 up to
    ``STORE_MAX_N``, in float32 up to ``F32_STORE_MAX_N`` (where the JAX
    package's soundness guard may still refuse it, see
    ``LargeScaleGP._f32_store_is_sound``) and beyond takes the fused kernel
    and warns; ``True`` demands the FP64 store and raises beyond
    ``STORE_MAX_N``; ``"f32"`` demands the float32 store at any size the
    card holds (an explicit accuracy opt-in); ``False`` never stores.
    """
    if store is False:
        return None
    if store == "f32":
        return "f32"
    if n_padded <= STORE_MAX_N:
        return "f64"
    if store is True:
        raise ValueError(
            f"[ stored_entries_tier error ] store_entries=True requests the "
            f"FP64 entry store, which is limited to padded n <= {STORE_MAX_N} "
            f"(8 bytes/entry of the card's 80 GB); got n_padded = {n_padded}. "
            f"Use store_entries='f32' to opt into the rounded float32 store, "
            f"or 'auto'/False for the policy/fused paths."
        )
    if n_padded <= F32_STORE_MAX_N:
        return "f32"
    warn(
        f"[ LargeScaleGP warning ] store_entries='auto' takes the fused "
        f"kernel: the float32 entry store of n_padded = {n_padded} "
        f"({4 * n_padded**2 / 1e9:.1f} GB) exceeds the {F32_STORE_MAX_N} limit "
        f"of one 80 GB card. Every product evaluates its entries anew."
    )
    return None
