"""The df64 tier's operations in the PyTorch port against float64 numpy and
the JAX package: the plain versions of kernels B3-B8
(inference_tpu_torch/ops/df64.py), the storage policy, and the chunked
solvers of ops/solvers.py. The kernels themselves are tested on the card by
test_torch_cuda.py.

Tolerances, with reasons:

- plain versions against a float64 numpy truth with exact differences: B5
  1e-14 relative (the same operations, only exp may differ by an ulp); B7
  the same entries rounded to nearest float32, so 2^-24 relative plus that
  ulp; B3, B4, B6 and B8 1e-13 of sum_j |E_ij| |V_jk| per row (the sums run
  in another order than numpy's);
- the port against the JAX kernels (interpret mode): the JAX side's own
  accuracy contract (tests/test_df64.py), since the pair arithmetic carries
  about 1e-8 of error: entries 5e-8 relative where E > 1e-25 and 1e-8
  absolute, products 1e-7 of max |truth|. Differences below 1e-37 come from
  the pair exponential's flush of arguments below -87 to zero
  (``_exp_parts_m``), not from the port. The float32 stores (B7) differ by
  at most one float32 ulp, where the pair's error moves a value across a
  rounding boundary; over the same float32 store the two products (B8) are
  both exact to float64 summation, so they agree to 1e-13;
- the solvers on a shared dense float64 operator: 1e-10 relative, the same
  ``info``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from inference_tpu.ops import df64 as jdf64
from inference_tpu.ops import solvers as jsolvers
from inference_tpu_torch.ops import df64, solvers

N = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coords(n, d, seed, scale=10.0):
    rng = np.random.default_rng(seed)
    uh, ul = df64.split_f64(rng.uniform(0, scale, (n, d)) / 0.7)
    return uh, ul, rng.normal(size=(n, 8)).astype(np.float32)


def _truth(uh, ul, uh2=None, ul2=None):
    """Float64 numpy entries from exact differences of the pair sums,
    summed over k in order."""
    a = uh.astype(np.float64) + ul.astype(np.float64)
    b = a if uh2 is None else uh2.astype(np.float64) + ul2.astype(np.float64)
    sq = (a[:, None, :] - b[None, :, :]) ** 2
    dist = np.zeros(sq.shape[:2])
    for k in range(sq.shape[2]):
        dist = dist + sq[:, :, k]
    return np.exp(-0.5 * dist)


def _within_row_scale(got, E, V, tol=1e-13):
    got = np.asarray(got).reshape(E.shape[0], -1)
    V = np.asarray(V, np.float64).reshape(E.shape[1], -1)
    scale = np.abs(E) @ np.abs(V)
    assert np.all(np.abs(got - E @ V) <= tol * scale)


# --------------------------------------------------------------------- #
# plain versions against float64 numpy
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [1, 2, 3, 5, 20])
def test_entries_plain_matches_numpy(d):
    uh, ul, _ = _coords(N, d, seed=d)
    E = df64.sqexp_entries_df64(uh, ul)
    assert E.dtype == torch.float64 and E.shape == (N, N)
    truth = _truth(uh, ul)
    mask = truth > 1e-300
    assert np.all(np.abs(E.numpy() - truth)[mask] <= 1e-14 * truth[mask])


@pytest.mark.parametrize("d, q", [(2, 1), (2, 8), (3, 5), (5, 16), (2, 20), (20, 1), (20, 37)])
def test_fused_and_stored_plain_match_numpy(d, q):
    """B4 (square and rectangular), B3 (q = 1) and B6 within 1e-13 of
    sum_j |E_ij| |V_jk|."""
    uh, ul, V = _coords(N, d, seed=10 + d)
    V = np.random.default_rng(q).normal(size=(N, q)).astype(np.float32)
    E = _truth(uh, ul)
    _within_row_scale(df64.sqexp_matmat_df64(uh, ul, V), E, V)
    rows = slice(128, 256)
    _within_row_scale(df64.sqexp_matmat_rect_df64(uh[rows], ul[rows], uh, ul, V), E[rows], V)
    _within_row_scale(df64.sqexp_stored_matmat_df64(torch.as_tensor(E), V), E, V)
    if q == 1:
        _within_row_scale(df64.sqexp_matvec_df64(uh, ul, V[:, 0]), E, V)
        _within_row_scale(df64.sqexp_stored_matvec_df64(torch.as_tensor(E), V[:, 0]), E, V)


@pytest.mark.parametrize("d", [1, 2, 3, 20])
def test_entries_f32_plain_is_the_rounded_fp64_entry(d):
    """B7's plain version is B5's, rounded to nearest float32: within 2^-24
    of the float64 numpy truth (plus B5's ulp) and equal to the rounding of
    B5's plain version bit for bit."""
    uh, ul, _ = _coords(N, d, seed=30 + d)
    E32 = df64.sqexp_entries_f32(uh, ul)
    assert E32.dtype == torch.float32 and E32.shape == (N, N)
    assert torch.equal(E32, df64.sqexp_entries_df64(uh, ul).float())
    truth = _truth(uh, ul)
    mask = truth > 1e-30
    err = np.abs(E32.numpy().astype(np.float64) - truth)[mask]
    assert np.all(err <= (2.0**-24 + 1e-15) * truth[mask])


@pytest.mark.parametrize("q", [1, 3, 16, 20])
def test_stored_f32_plain_is_exact_over_the_store(q):
    """B8's plain version: the float64 product of the float32 store with V
    (every product exact), within 1e-13 of sum_j |E_ij| |V_jk|."""
    uh, ul, _ = _coords(N, 2, seed=40 + q)
    V = np.random.default_rng(q).normal(size=(N, q)).astype(np.float32)
    E32 = df64.sqexp_entries_f32(uh, ul)
    Y = df64.sqexp_stored_f32_matmat(E32, V)
    assert Y.dtype == torch.float64 and Y.shape == (N, q)
    _within_row_scale(Y, E32.numpy().astype(np.float64), V)


@pytest.mark.parametrize("n, sms", [(53_248, 132), (4096, 132), (4736, 132), (4736, 114),
                                     (1664, 8), (128, 132)])
def test_stored_grid_covers_every_tile_once(n, sms):
    """B6/B8's plan, which the kernel takes as given: at most one block per
    SM; the row groups cover every row once in whole boxes of 4 rows, at
    least 16 each; for every q the splits are non-empty, and their panels
    cover every 128-column tile exactly once and fit the kernel's 64 KiB
    panel buffer (8 doubles per column and n-tile)."""
    for q in (1, 2, 8, 9, 16):
        rows, cols, panel = df64.stored_plan(n, n, q, sms)
        groups, splits = len(rows) - 1, len(cols) - 1
        assert groups >= 1 and splits >= 1 and groups * splits <= max(sms, 1)
        assert rows[0] == 0 and rows[-1] == n and cols[0] == 0 and cols[-1] == n
        assert all(b - a >= min(16, n) and a % 4 == 0 for a, b in zip(rows, rows[1:]))
        assert all(b > a and a % 128 == 0 for a, b in zip(cols, cols[1:]))
        assert panel % 128 == 0 and panel * (1 if q <= 8 else 2) * 64 <= 64 * 1024
        panels = [(p, min(p + panel, c1)) for c0, c1 in zip(cols, cols[1:])
                  for p in range(c0, c1, panel)]
        tiles = [t for a, b in panels for t in range(a // 128, b // 128)]
        assert sorted(tiles) == list(range(n // 128))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("q", [1, 2, 16])
def test_stored_partials_sum_to_the_product(dtype, sms, q):
    """The plain version run panel by panel, as B6/B8 walk their plan (n =
    1,664, 13 tiles: 3 ragged splits on 132 SMs, one split of ragged panels
    on 8), summed over the splits: within 1e-13 of sum_j |E_ij| |V_jk| of
    ``_stored_reference``."""
    n = 1664
    rng = np.random.default_rng(q + sms)
    E = torch.as_tensor(rng.uniform(0, 1, (n, n))).to(dtype)
    V = torch.as_tensor(rng.normal(size=(n, q)).astype(np.float32))
    _, cols, panel = df64.stored_plan(n, n, q, sms)
    splits = len(cols) - 1
    partial = torch.zeros((splits, n, q), dtype=torch.float64)
    walked = []
    for s in range(splits):
        for c0 in range(cols[s], cols[s + 1], panel):
            c1 = min(c0 + panel, cols[s + 1])
            partial[s] += df64._stored_reference(E[:, c0:c1], V[c0:c1])
            walked.append(c1 - c0)
    ref = df64._stored_reference(E, V)
    scale = df64._stored_reference(E, V.abs())
    assert float(((partial.sum(dim=0) - ref).abs() / scale).max()) <= 1e-13
    assert splits == (3 if sms == 132 else 1)
    assert sum(walked) == n and any(w < panel for w in walked)


def _instantiated_rpt():
    """{QMAX: rows per thread} of the launches ``csrc/sqexp_fused.cu``
    instantiates (``launch_q<DT, QMAX, RPT>``)."""
    src = (Path(df64.__file__).with_name("csrc") / "sqexp_fused.cu").read_text()
    return {int(qmax): int(rpt) for qmax, rpt in re.findall(r"launch_q<DT, (\d+), (\d+)>", src)}


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("q", [1, 2, 8, 16])
@pytest.mark.parametrize("n_rows", [128, 4224, 53_248])
def test_fused_plan_covers_every_tile_once(n_rows, q, sms):
    """B3/B4's plan, which the kernel takes as given: the rows per thread
    the launcher instantiates for q's bucket; for square and rectangular
    launches the splits cover every 128-column tile exactly once, none
    empty, and hold at least two tiles where there are two."""
    built = _instantiated_rpt()
    assert sorted(built) == sorted(df64.FUSED_RPT) and built == df64.FUSED_RPT
    for n_cols in (n_rows, 4096):
        rpt, splits, per = df64.fused_plan(n_rows, n_cols, q, sms)
        assert rpt == built[min(b for b in built if q <= b)]
        n_tiles = n_cols // 128
        walked = [range(s * per, min((s + 1) * per, n_tiles)) for s in range(splits)]
        assert all(len(w) >= 1 for w in walked)
        assert sorted(t for w in walked for t in w) == list(range(n_tiles))
        assert per >= min(2, n_tiles)
        assert 1 <= splits <= 65535


@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("q", [1, 8])
def test_fused_partials_sum_to_the_product(sms, q):
    """The plain version run split by split, as B3/B4 walk their plan (n =
    1,664, 13 tiles: ragged splits on 132 SMs), summed over the splits:
    within 1e-13 of sum_j |E_ij| |V_jk| of ``_fused_reference``."""
    n = 1664
    uh, ul, _ = _coords(n, 2, seed=q + sms)
    us = torch.as_tensor(uh).double() + torch.as_tensor(ul).double()
    V = torch.as_tensor(np.random.default_rng(q).normal(size=(n, q)).astype(np.float32))
    _, splits, per = df64.fused_plan(n, n, q, sms)
    partial = torch.stack([df64._fused_reference(us, us[s * per * 128:(s + 1) * per * 128],
                                                 V[s * per * 128:(s + 1) * per * 128])
                           for s in range(splits)])
    ref = df64._fused_reference(us, us, V)
    scale = df64._fused_reference(us, us, V.abs())
    assert float(((partial.sum(dim=0) - ref).abs() / scale).max()) <= 1e-13
    assert splits > 1


def _instantiated_wide():
    """The buckets of q the wide launcher of ``csrc/sqexp_fused.cu``
    instantiates (``launch_wide_q<QMAX>``), and its constants KC, DC and
    SMEM_MAX."""
    src = (Path(df64.__file__).with_name("csrc") / "sqexp_fused.cu").read_text()
    buckets = sorted(int(a) for a in re.findall(r"launch_wide_q<(\d+)>\(", src))
    consts = {k: int(re.search(rf"constexpr (?:int|size_t) {k} = (\d+);", src)[1])
              for k in ("KC", "DC", "SMEM_MAX")}
    return buckets, consts


@pytest.mark.parametrize("q", [1, 2, 4, 8, 16])
def test_fused_wide_plan_at_every_width(q):
    """The wide kernel's plan (d > 16), which its launcher checks and takes
    as given, at every d from 17 to 130 for each bucket of q the source
    instantiates: d_pad the least multiple of its KC at or above d; all of
    d_pad staged at once (rows, two column tiles and two tiles of v)
    wherever that fits the block's shared memory, else chunks of its DC with
    two row buffers and a tile of distances, which fit too;
    gp-large-50k-d20's width and every d up to 64 at once; the splits cover
    every column tile exactly once."""
    buckets, consts = _instantiated_wide()
    assert buckets == sorted(df64.FUSED_RPT)
    assert (consts["KC"], consts["DC"], consts["SMEM_MAX"]) == (df64.WIDE_KC, df64.WIDE_DC,
                                                                 df64.SMEM_MAX)
    bucket = min(b for b in buckets if q <= b)
    for d in range(17, 131):
        for n_rows, n_cols, sms in ((53_248, 53_248, 132), (4224, 4096, 132), (128, 128, 1)):
            plan = df64.fused_wide_plan(n_rows, n_cols, d, q, sms)
            assert plan.d_pad % df64.WIDE_KC == 0 and d <= plan.d_pad < d + df64.WIDE_KC
            whole = 8 * (plan.d_pad * 3 * 128 + 2 * 128 * bucket)
            chunked = 8 * (df64.WIDE_DC * 4 * 128 + 2 * 128 * bucket + 128 * 128)
            if whole <= df64.SMEM_MAX:
                assert (plan.dc, plan.smem) == (plan.d_pad, whole)
            else:
                assert d > 64 and (plan.dc, plan.smem) == (df64.WIDE_DC, chunked)
            assert plan.dc % df64.WIDE_KC == 0 and plan.smem <= df64.SMEM_MAX
            n_tiles = n_cols // 128
            walked = [range(s * plan.per, min((s + 1) * plan.per, n_tiles))
                      for s in range(plan.splits)]
            assert all(len(w) >= 1 for w in walked)
            assert sorted(t for w in walked for t in w) == list(range(n_tiles))
            assert plan.per >= min(2, n_tiles) and 1 <= plan.splits <= 65535
    assert df64.fused_wide_plan(53_248, 53_248, 20, q, 132).dc == 20


@pytest.mark.parametrize("d", [17, 20, 33, 100])
def test_zero_padded_coordinates_give_the_same_entries(d):
    """What the wide kernels rely on: coordinates zero-padded to
    ``pad_dims(d)`` give B5's entries and B3/B4's products bit for bit (each
    pad dimension adds +0 to a non-negative distance), and so does B3/B4's
    walk in chunks of the plan's ``dc`` dimensions with the partial
    distances carried from chunk to chunk; the wrapper (its plain route
    here) gives the plain version on the unpadded coordinates."""
    uh, ul, V = _coords(N, d, seed=60 + d, scale=1.2 * np.sqrt(20 / d))
    us = torch.as_tensor(uh).double() + torch.as_tensor(ul).double()
    V = torch.as_tensor(V)
    d_pad = df64.pad_dims(d)
    assert d_pad % df64.WIDE_KC == 0 and d <= d_pad < d + df64.WIDE_KC
    padded = torch.cat([us, us.new_zeros((N, d_pad - d))], dim=1)
    assert torch.equal(df64._entries_reference(padded), df64._entries_reference(us))
    plain = df64._fused_reference(us[:128], us, V)
    assert torch.equal(df64._fused_reference(padded[:128], padded, V), plain)
    dc = df64.fused_wide_plan(128, N, d, V.shape[1], 132).dc
    dist = torch.zeros((128, N), dtype=torch.float64)
    for k0 in range(0, d_pad, dc):  # the kernel's chunks, each k in order
        for k in range(k0, min(k0 + dc, d_pad)):
            diff = padded[:128, k][:, None] - padded[:, k][None, :]
            dist = dist + diff * diff
    assert torch.equal(torch.exp(-0.5 * dist) @ V.double(), plain)
    assert torch.equal(df64.sqexp_matmat_rect_df64(uh[:128], ul[:128], uh, ul, V), plain)


def test_plain_row_blocks_cover_every_row(monkeypatch):
    """The plain versions work in row blocks; with blocks of 100 rows (not a
    divisor of 256) they give the unblocked result."""
    uh, ul, V = _coords(N, 2, seed=4)
    whole = [df64.sqexp_entries_df64(uh, ul), df64.sqexp_matmat_df64(uh, ul, V)]
    monkeypatch.setattr(df64, "_BLOCK_ELEMS", 100 * N)
    blocked = [df64.sqexp_entries_df64(uh, ul), df64.sqexp_matmat_df64(uh, ul, V)]
    for a, b in zip(whole, blocked):
        torch.testing.assert_close(a, b, rtol=1e-15, atol=0)


# --------------------------------------------------------------------- #
# the port against the JAX package's Pallas kernels (interpret mode)
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=[2, 3])
def jax_kernels(request):
    """One interpret-mode call per kernel and shape (they are slow)."""
    d = request.param
    uh, ul, V = _coords(N, d, seed=20 + d, scale=6.0)
    Eh, El = jdf64.sqexp_entries_df64(uh, ul, interpret=True)
    E32 = jdf64.sqexp_entries_f32(uh, ul, interpret=True)
    return {
        "d": d, "uh": uh, "ul": ul, "V": V, "Eh": np.array(Eh), "El": np.array(El),
        "E32": np.array(E32),
        "matvec": np.asarray(jdf64.sqexp_matvec_df64(uh, ul, V[:, 0], interpret=True)),
        "matmat": np.asarray(jdf64.sqexp_matmat_df64(uh, ul, V[:, :4], interpret=True)),
        "stored": np.asarray(jdf64.sqexp_stored_matmat_df64(Eh, El, V[:, :4], interpret=True)),
        "stored_f32": np.asarray(jdf64.sqexp_stored_f32_matmat(E32, V[:, :4], interpret=True)),
    }


def test_entries_match_jax_kernel(jax_kernels):
    k = jax_kernels
    E = df64.sqexp_entries_df64(k["uh"], k["ul"]).numpy()
    E_jax = k["Eh"].astype(np.float64) + k["El"].astype(np.float64)
    mask = E > 1e-25
    assert np.all(np.abs(E_jax - E)[mask] <= 5e-8 * E[mask])
    # below ~1e-37 the pair exponential flushes to zero (ah < -87)
    assert np.abs(E_jax - E).max() <= 1e-8


def test_entries_f32_match_jax_kernel(jax_kernels):
    """B7 against the JAX kernel: at most one float32 ulp apart, where the
    pair evaluation's ~1e-8 error crosses a rounding boundary."""
    k = jax_kernels
    E32 = df64.sqexp_entries_f32(k["uh"], k["ul"]).numpy()
    E_jax = k["E32"]
    assert E32.dtype == E_jax.dtype == np.float32
    mask = E32 > 1e-25
    ulps = np.abs(E32.view(np.int32) - E_jax.view(np.int32))[mask]
    assert ulps.max() <= 1
    # below ~1e-37 the pair exponential flushes to zero (ah < -87)
    assert np.abs(E32.astype(np.float64) - E_jax)[~mask].max() <= 1e-25


@pytest.mark.parametrize("which", ["matvec", "matmat", "stored", "stored_pair"])
def test_products_match_jax_kernels(jax_kernels, which):
    """B3, B4 and B6 against the JAX kernels; B6 also from the JAX
    package's (E_hi, E_lo) pair itself."""
    k = jax_kernels
    uh, ul, V = k["uh"], k["ul"], k["V"]
    if which == "matvec":
        ours, ref = df64.sqexp_matvec_df64(uh, ul, V[:, 0]), k["matvec"]
    elif which == "matmat":
        ours, ref = df64.sqexp_matmat_df64(uh, ul, V[:, :4]), k["matmat"]
    elif which == "stored":
        ours = df64.sqexp_stored_matmat_df64(df64.sqexp_entries_df64(uh, ul), V[:, :4])
        ref = k["stored"]
    else:
        ours, ref = df64.sqexp_stored_matmat_df64(k["Eh"], k["El"], V[:, :4]), k["stored"]
    ours = ours.numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float64
    assert np.abs(ours - ref).max() <= 1e-7 * np.abs(ref).max()


def test_stored_f32_matches_jax_kernel(jax_kernels):
    """B8 on the JAX package's own float32 store against its kernel: both
    are exact products summed in (pair or native) float64, so they agree to
    1e-13 of max |truth|; on the port's store, to the JAX contract."""
    k = jax_kernels
    V, ref = k["V"][:, :4], k["stored_f32"]
    ours = df64.sqexp_stored_f32_matmat(k["E32"], V).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float64
    assert np.abs(ours - ref).max() <= 1e-13 * np.abs(ref).max()
    own = df64.sqexp_stored_f32_matmat(df64.sqexp_entries_f32(k["uh"], k["ul"]), V).numpy()
    assert np.abs(own - ref).max() <= 1e-7 * np.abs(ref).max()


@pytest.fixture(scope="module")
def jax_wide():
    """The JAX kernels (interpret mode, n = 256) where the port's kernels
    used to raise: the four products at q = 20 right-hand sides (d = 2), and
    B3/B4/B5/B7 at d = 20 on coordinates spread so that E is well filled."""
    uh, ul, _ = _coords(N, 2, seed=50, scale=6.0)
    V = np.random.default_rng(51).normal(size=(N, 20)).astype(np.float32)
    Eh, El = jdf64.sqexp_entries_df64(uh, ul, interpret=True)
    E32 = np.array(jdf64.sqexp_entries_f32(uh, ul, interpret=True))
    wh, wl, W = _coords(N, 20, seed=52, scale=1.2)
    return {
        "q20": (uh, ul, V, np.array(Eh), np.array(El), E32),
        "matmat": np.asarray(jdf64.sqexp_matmat_df64(uh, ul, V, interpret=True)),
        "rect": np.asarray(jdf64.sqexp_matmat_rect_df64(uh[:128], ul[:128], uh, ul, V,
                                                        interpret=True)),
        "stored": np.asarray(jdf64.sqexp_stored_matmat_df64(Eh, El, V, interpret=True)),
        "stored_f32": np.asarray(jdf64.sqexp_stored_f32_matmat(E32, V, interpret=True)),
        "d20": (wh, wl, W[:, :2]),
        "entries20": [np.array(a) for a in jdf64.sqexp_entries_df64(wh, wl, interpret=True)],
        "entries_f32_20": np.array(jdf64.sqexp_entries_f32(wh, wl, interpret=True)),
        "matvec20": np.asarray(jdf64.sqexp_matvec_df64(wh, wl, W[:, 0], interpret=True)),
        "matmat20": np.asarray(jdf64.sqexp_matmat_df64(wh, wl, W[:, :2], interpret=True)),
    }


@pytest.mark.parametrize("which", ["matmat", "rect", "stored", "stored_f32"])
def test_wrappers_take_twenty_right_hand_sides_as_jax(jax_wide, which):
    """The four block products at q = 20, where the port raised before: one
    launch per 16 columns, concatenated, against the JAX kernels (to the
    JAX contract, 1e-7 of max |ref|; B8 on the JAX package's own float32
    store to 1e-13) and against the plain version of each column block
    alone, bit for bit."""
    uh, ul, V, Eh, El, E32 = jax_wide["q20"]
    us = torch.as_tensor(uh).double() + torch.as_tensor(ul).double()
    Vt = torch.as_tensor(V)
    if which == "matmat":
        ours, tol = df64.sqexp_matmat_df64(uh, ul, V), 1e-7
        blocks = [df64._fused_reference(us, us, Vt[:, c:c + 16]) for c in (0, 16)]
    elif which == "rect":
        ours, tol = df64.sqexp_matmat_rect_df64(uh[:128], ul[:128], uh, ul, V), 1e-7
        blocks = [df64._fused_reference(us[:128], us, Vt[:, c:c + 16]) for c in (0, 16)]
    elif which == "stored":
        E = df64.sqexp_entries_df64(uh, ul)
        ours, tol = df64.sqexp_stored_matmat_df64(E, V), 1e-7
        blocks = [df64._stored_reference(E, Vt[:, c:c + 16]) for c in (0, 16)]
    else:
        ours, tol = df64.sqexp_stored_f32_matmat(E32, V), 1e-13
        blocks = [df64._stored_reference(torch.as_tensor(E32), Vt[:, c:c + 16]) for c in (0, 16)]
    ref = jax_wide[which]
    assert ours.shape == ref.shape == (ref.shape[0], 20) and ours.dtype == torch.float64
    assert np.abs(ours.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert torch.equal(ours, torch.cat(blocks, dim=1))


def _wide_matches_jax(wh, wl, W, ref, which):
    """One of B5, B7, B3 and B4's plain versions at a wide d against the JAX
    kernel's output ``ref``: the JAX contract of test_entries_match_jax_kernel,
    test_entries_f32_match_jax_kernel and test_products_match_jax_kernels."""
    if which == "entries":
        E = df64.sqexp_entries_df64(wh, wl).numpy()
        E_jax = ref[0].astype(np.float64) + ref[1].astype(np.float64)
        mask = E > 1e-25
        assert mask.mean() > 0.5
        assert np.all(np.abs(E_jax - E)[mask] <= 5e-8 * E[mask])
        assert np.abs(E_jax - E).max() <= 1e-8
    elif which == "entries_f32":
        E32 = df64.sqexp_entries_f32(wh, wl).numpy()
        mask = E32 > 1e-25
        ulps = np.abs(E32.view(np.int32) - ref.view(np.int32))[mask]
        assert E32.dtype == np.float32 and mask.mean() > 0.5 and ulps.max() <= 1
    else:
        ours = (df64.sqexp_matvec_df64(wh, wl, W[:, 0]) if which == "matvec"
                else df64.sqexp_matmat_df64(wh, wl, W)).numpy()
        assert ours.shape == ref.shape and ours.dtype == np.float64
        assert np.abs(ours - ref).max() <= 1e-7 * np.abs(ref).max()


@pytest.mark.parametrize("which", ["entries", "entries_f32", "matvec", "matmat"])
def test_plain_routes_at_twenty_dimensions_match_jax(jax_wide, which):
    """B5, B7, B3 and B4's plain versions at d = 20, where the port raised
    before, against the JAX kernels in interpret mode."""
    wh, wl, W = jax_wide["d20"]
    ref = {"entries": jax_wide["entries20"], "entries_f32": jax_wide["entries_f32_20"],
           "matvec": jax_wide["matvec20"], "matmat": jax_wide["matmat20"]}[which]
    _wide_matches_jax(wh, wl, W, ref, which)


@pytest.fixture(scope="module", params=[17, 33, 100])
def jax_wide_d(request):
    """The JAX kernels (interpret mode, n = 256) at the other widths of the
    wide kernels' checks: both ends of a padded step of 4 (17, and 20
    above), B5/B7's second staged chunk (33), B3/B4 read from device memory
    and B5/B7's fourth chunk (100); coordinates spread as d = 20's, scaled
    by sqrt(20 / d). At d = 100 the JAX kernel's entries depart from the
    float64 truth by up to 4.8e-7 relative (8 float32 ulps), beyond its own
    5e-8 contract, so they are not computed there (see below)."""
    d = request.param
    wh, wl, W = _coords(N, d, seed=52 + d, scale=1.2 * np.sqrt(20 / d))
    W = W[:, :2]
    refs = {
        "matvec": np.asarray(jdf64.sqexp_matvec_df64(wh, wl, W[:, 0], interpret=True)),
        "matmat": np.asarray(jdf64.sqexp_matmat_df64(wh, wl, W, interpret=True)),
    }
    if d < 100:
        refs["entries"] = [np.array(a) for a in jdf64.sqexp_entries_df64(wh, wl, interpret=True)]
        refs["entries_f32"] = np.array(jdf64.sqexp_entries_f32(wh, wl, interpret=True))
    return d, (wh, wl, W), refs


@pytest.mark.parametrize("which", ["entries", "entries_f32", "matvec", "matmat"])
def test_plain_routes_at_wide_dimensions_match_jax(jax_wide_d, which):
    """The same at d = 17, 33 and 100. At d = 100 the products keep the JAX
    contract; the entries are held to the float64 numpy truth the JAX kernel
    misses there (B5 1e-14 relative, B7 its rounding: 2^-24 plus B5's ulp,
    and B5's entries rounded bit for bit)."""
    d, (wh, wl, W), refs = jax_wide_d
    if which in refs:
        _wide_matches_jax(wh, wl, W, refs[which], which)
        return
    truth = _truth(wh, wl)
    assert (truth > 1e-3).mean() > 0.5
    E = df64.sqexp_entries_df64(wh, wl)
    if which == "entries":
        assert np.all(np.abs(E.numpy() - truth) <= 1e-14 * truth)
    else:
        E32 = df64.sqexp_entries_f32(wh, wl)
        assert torch.equal(E32, E.float())
        err = np.abs(E32.numpy().astype(np.float64) - truth)
        assert np.all(err <= (2.0**-24 + 1e-15) * truth)


def test_split_f64_matches_jax():
    a = np.random.default_rng(0).normal(size=(64, 3)) * 1e3
    for ours, ref in zip(df64.split_f64(a), jdf64.split_f64(a)):
        np.testing.assert_array_equal(ours, ref)


# --------------------------------------------------------------------- #
# validation and policy
# --------------------------------------------------------------------- #
def test_padding_and_operand_contracts():
    """The n % 128 contract with the JAX package's errors, plus the port's
    own: float32 operands only, at least one right-hand side and one
    coordinate dimension (any number of each above that, as in the JAX
    package)."""
    bad = np.zeros((100, 2), np.float32)
    for fn in (jdf64.sqexp_matvec_df64, df64.sqexp_matvec_df64):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(bad, bad, np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        df64.sqexp_matmat_df64(bad, bad, np.zeros((100, 2), np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        df64.sqexp_entries_df64(bad, bad)
    with pytest.raises(ValueError, match="multiple of 128"):
        df64.sqexp_stored_matmat_df64(torch.zeros((100, 100), dtype=torch.float64),
                                      np.zeros((100, 1), np.float32))
    uh, ul, V = _coords(N, 2, seed=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        df64.sqexp_matmat_rect_df64(uh[:100], ul[:100], uh, ul, V)
    with pytest.raises(ValueError, match="2D"):
        df64.sqexp_matmat_df64(uh, ul, V[:, 0])
    with pytest.raises(TypeError, match="float32"):
        df64.sqexp_matmat_df64(uh, ul, V.astype(np.float64))
    with pytest.raises(TypeError, match="float32"):
        df64.sqexp_matvec_df64(uh.astype(np.float64), ul, V[:, 0])
    with pytest.raises(ValueError, match="right-hand"):
        df64.sqexp_matmat_df64(uh, ul, np.zeros((N, 0), np.float32))
    with pytest.raises(ValueError, match="dimension"):
        df64.sqexp_entries_df64(np.zeros((128, 0), np.float32), np.zeros((128, 0), np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        df64.sqexp_entries_f32(bad, bad)
    with pytest.raises(TypeError, match="float32"):
        df64.sqexp_stored_f32_matmat(torch.zeros((N, N), dtype=torch.float64), V)
    with pytest.raises(ValueError, match="multiple of 128"):
        df64.sqexp_stored_f32_matmat(np.zeros((100, 100), np.float32), np.zeros((100, 1), np.float32))


def test_stored_entries_tier_policy():
    """The FP64 store up to 81,920 padded rows (53.7 GB of 80), then 'auto'
    takes the float32 store up to 114,688 (52.6 GB) and beyond that the
    fused kernel, with a warning; True raises beyond 81,920; 'f32' stores
    in float32 at any size."""
    assert df64.stored_entries_tier(1024, "auto") == "f64"
    assert df64.stored_entries_tier(53_248, "auto") == "f64"
    assert df64.stored_entries_tier(81_920, True) == "f64"
    assert df64.stored_entries_tier(86_016, "auto") == "f32"
    assert df64.stored_entries_tier(114_688, "auto") == "f32"
    with pytest.warns(UserWarning, match="fused"):
        assert df64.stored_entries_tier(118_784, "auto") is None
    with pytest.raises(ValueError, match="81920"):
        df64.stored_entries_tier(86_016, True)
    assert df64.stored_entries_tier(1024, False) is None
    assert df64.stored_entries_tier(200_000, False) is None
    assert df64.stored_entries_tier(1024, "f32") == "f32"
    assert df64.stored_entries_tier(53_248, "f32") == "f32"


# --------------------------------------------------------------------- #
# solvers
# --------------------------------------------------------------------- #
def _spd(n, seed, kappa_exp):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.logspace(0, kappa_exp, n)) @ Q.T, rng


def _dense_op(A):
    At = torch.as_tensor(A)
    return lambda V32: At @ V32.double()


def test_multi_solver_matches_jax_on_a_shared_operator():
    """Df64MultiSolver on the same dense float64 operator in both packages
    (the sqexp matrix of 256 points plus sigma^2 = 1e-2, applied to the
    float32 direction), q = 4, restart 40: X to 1e-10 relative, the same
    info."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 6, (N, 2))
    A = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1)) + 1e-2 * np.eye(N)
    B = rng.normal(size=(N, 4))
    A_j = jnp.asarray(A)
    jsolver = jsolvers.Df64MultiSolver(lambda V32: A_j @ V32.astype(jnp.float64),
                                       restart_every=40)
    X_j, info_j = jsolver.solve(jnp.asarray(B), tol=1e-12, maxiter=2000)
    X, info = solvers.Df64MultiSolver(_dense_op(A), restart_every=40).solve(
        torch.as_tensor(B), tol=1e-12, maxiter=2000)
    X_j = np.asarray(X_j)
    assert info == int(info_j) == 0
    assert np.abs(X.numpy() - X_j).max() <= 1e-10 * np.abs(X_j).max()
    rel = np.linalg.norm(A @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-12


def test_multi_solver_with_a_fast_operator_matches_jax():
    """Df64MultiSolver with ``matmat_fast`` (mixed-precision iterative
    refinement) in both packages on one problem: the accurate operator the
    sqexp matrix of 256 points plus sigma^2 = 1e-2 in float64, the fast one
    the same matrix rounded to float32 (products exact in float64, as B8
    forms them), q = 4, chunks of 20 iterations (unpreconditioned, chunks of
    4 stall near 3e-4 here). X to 1e-10 relative, the same info, and the
    true residual at the accurate operator's level."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 6, (N, 2))
    E = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1))
    A = E + 1e-2 * np.eye(N)
    A32 = E.astype(np.float32).astype(np.float64) + 1e-2 * np.eye(N)
    B = rng.normal(size=(N, 4))
    A_j, A32_j = jnp.asarray(A), jnp.asarray(A32)
    jsolver = jsolvers.Df64MultiSolver(
        lambda V32: A_j @ V32.astype(jnp.float64), restart_every=20,
        matmat_fast=lambda V32, M: M @ V32.astype(jnp.float64), matmat_fast_args=(A32_j,))
    X_j, info_j = jsolver.solve(jnp.asarray(B), tol=1e-11, maxiter=2000)
    solver = solvers.Df64MultiSolver(_dense_op(A), restart_every=20,
                                     matmat_fast=lambda V32, M: M @ V32.double(),
                                     matmat_fast_args=(torch.as_tensor(A32),))
    X, info = solver.solve(torch.as_tensor(B), tol=1e-11, maxiter=2000)
    X_j = np.asarray(X_j)
    assert info == int(info_j) == 0 and solver.chunks_run > 1
    assert np.abs(X.numpy() - X_j).max() <= 1e-10 * np.abs(X_j).max()
    rel = np.linalg.norm(A @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-11


def test_df64_pcg_ill_conditioned_matches_jax():
    """df64_pcg on a kappa = 1e6 SPD system (tests/test_df64.py's): both
    packages reach 1e-10 and agree."""
    A, rng = _spd(300, seed=0, kappa_exp=6)
    b = A @ rng.normal(size=300)
    A_j = jnp.asarray(A)
    x_j, info_j = jsolvers.df64_pcg(lambda v: A_j @ v.astype(jnp.float64), jnp.asarray(b),
                                    tol=1e-11, maxiter=20000, restart_every=50)
    x, info = solvers.df64_pcg(lambda v: torch.as_tensor(A) @ v.double(), torch.as_tensor(b),
                               tol=1e-11, maxiter=20000, restart_every=50)
    assert info == int(info_j) == 0
    assert np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b) < 1e-10
    x_j = np.asarray(x_j)
    assert np.abs(x.numpy() - x_j).max() <= 1e-6 * np.abs(x_j).max()


def test_breakdown_freezes_iterate():
    """A pAp <= 0 breakdown (an indefinite operator) never makes the
    returned iterate worse than the start, and is reported."""
    rng = np.random.default_rng(7)
    d = np.ones(128)
    d[-8:] = -0.5
    b = rng.normal(size=128)
    dt = torch.as_tensor(d)
    x, info = solvers.Df64Solver(lambda v: dt * v.double(), restart_every=25).solve(
        torch.as_tensor(b), tol=1e-12, maxiter=100)
    assert np.linalg.norm(b - d * x.numpy()) <= np.linalg.norm(b) * (1.0 + 1e-6)
    assert info != 0


def test_divergence_safeguard_returns_best_iterate():
    """tests/test_df64.py's construction: chunks from the fourth on are
    corrupted by 1e12; the safeguard restores the best state on the first
    strike, freezes on the second (five chunks in all), reports that tol was
    not reached, and returns exactly the iterate of three clean chunks."""
    A, rng = _spd(200, seed=3, kappa_exp=4)
    b = torch.as_tensor(A @ rng.normal(size=200))
    solver = solvers.Df64Solver(_dense_op(A), restart_every=20)
    real_chunk = solver._multi._chunk
    calls = {"n": 0}

    def corrupting_chunk(*args):
        X, R, Z, P, rz, ok, rr = real_chunk(*args)
        calls["n"] += 1
        if calls["n"] >= 4:
            X, R, rr = X * 1e12, R * 1e12, rr * 1e24
        return X, R, Z, P, rz, ok, rr

    solver._multi._chunk = corrupting_chunk
    x, info = solver.solve(b, tol=1e-300, maxiter=400)
    assert calls["n"] == 5
    assert info != 0
    x_ref, _ = solvers.Df64Solver(_dense_op(A), restart_every=20).solve(b, tol=1e-300, maxiter=60)
    torch.testing.assert_close(x, x_ref, rtol=0, atol=0)


def test_preconditioned_multi_solver_converges_columns_independently():
    """A preconditioned block solve (diagonal preconditioner as M) whose
    columns differ in scale by 1e6 converges every column; a zero column
    stays zero."""
    A, rng = _spd(200, seed=5, kappa_exp=4)
    B = rng.normal(size=(200, 3)) * np.array([1.0, 1e6, 0.0])
    dinv = torch.as_tensor(1.0 / np.diag(A))
    X, info = solvers.Df64MultiSolver(
        _dense_op(A), M=lambda R, di: di[:, None] * R, M_args=(dinv,), restart_every=30
    ).solve(torch.as_tensor(B), tol=1e-11, maxiter=3000)
    assert info == 0
    R = A @ X.numpy() - B
    assert np.all(np.linalg.norm(R[:, :2], axis=0) <= 1e-11 * np.linalg.norm(B[:, :2], axis=0))
    assert np.all(X.numpy()[:, 2] == 0.0)
