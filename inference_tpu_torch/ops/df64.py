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
  ``q = 1`` launch.
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
launches of each kernel.
"""

from warnings import warn

import numpy as np
import torch

from . import _build

_TJ = 128  # column tile of the kernels; n must be a multiple
_TI = 128  # row tile of the kernels
D_MAX = 16  # the kernels' largest coordinate dimension
Q_MAX = 16  # the largest right-hand-side block the kernels take

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
    if not 1 <= d <= D_MAX:
        raise ValueError(
            f"[ {caller} error ] the kernels take 1 to {D_MAX} coordinate "
            f"dimensions, got {d} (larger d is ROADMAP queue B4's open item)."
        )


def _check_block(V, n_cols, caller):
    if V.ndim != 2:
        raise ValueError(f"[ {caller} error ] V must be 2D (n, q); got {tuple(V.shape)}.")
    if V.shape[0] != n_cols:
        raise ValueError(
            f"[ {caller} error ] V has {V.shape[0]} rows but there are "
            f"{n_cols} column points."
        )
    if not 1 <= V.shape[1] <= Q_MAX:
        raise ValueError(
            f"[ {caller} error ] the kernels take 1 to {Q_MAX} right-hand "
            f"sides at once, got {V.shape[1]}; chunk the columns."
        )


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


def _splits(n_rows, n_cols, device):
    """Column splits of a fused launch: about sixteen blocks per SM (a few
    waves of the five or so that fit at once), at least two column tiles
    per split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = -(-n_rows // _TI)
    n_tiles = n_cols // _TJ
    return max(1, min(-(-16 * sms // row_blocks), n_tiles // 2))


def _launch_fused(rows64, cols64, V, kernel="B4"):
    """Launch the fused kernel (``csrc/sqexp_fused.cu``) on contiguous
    FP64 coordinates and a float32 block ``V`` on one CUDA device, with the
    result of ``_fused_reference``. Counts one launch of ``kernel`` (B3 for
    the matvec, B4 for the matmat)."""
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
    splits = _splits(n_rows, n_cols, rows64.device)
    partial = torch.empty((splits, n_rows, q), dtype=torch.float64, device=rows64.device)
    fn = _build.bind("sqexp_fused", "sqexp_fused_f64", 4, 5)
    with torch.cuda.device(rows64.device):
        rc = fn(rows64.data_ptr(), cols64.data_ptr(), V.data_ptr(), partial.data_ptr(),
                n_rows, n_cols, d, q, splits, _build.stream(rows64.device))
    _build.raise_on(rc, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return partial[0] if splits == 1 else partial.sum(dim=0)


def _fused(rows64, cols64, V, kernel):
    dev = _same_device(f"kernel {kernel}", rows64, cols64, V)
    if dev.type == "cuda":
        return _launch_fused(rows64.contiguous(), cols64.contiguous(), V.contiguous(), kernel)
    return _fused_reference(rows64, cols64, V)


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
    (kernel B4): returns float64 (n, q). ``n`` must be a multiple of 128;
    ``q`` at most 16."""
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
    n_rows, n_cols = E.shape
    q = V.shape[1]
    Y = torch.empty((n_rows, q), dtype=torch.float64, device=E.device)
    fn = _build.bind("sqexp_stored", symbol, 3, 3)
    with torch.cuda.device(E.device):
        rc = fn(E.data_ptr(), V.data_ptr(), Y.data_ptr(), n_rows, n_cols, q,
                _build.stream(E.device))
    _build.raise_on(rc, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return Y


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
        return _launch_stored(E.contiguous(), V.contiguous(), dtype)
    return _stored_reference(E, V)


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
