"""The port's probes P1-P3 (inference_tpu_torch/probes/) on the CPU: each
kernel's plain version against a numpy restatement of the JAX probe, and
P2's ``full`` variant and P3 against the JAX package in interpret mode. The
kernels themselves are held to these plain versions on the card by
test_torch_cuda.py and chip_smoke.py.

Tolerances, with reasons:

- P1: bit for bit. Every multiply and add is one rounded operation in
  numpy, in torch and in the kernel.
- P2 against numpy float64 with exact differences: 1e-13 of sum_j |term_ij|
  |w_j| (w = v, or ones for the variants without v), since the sums run in
  another order; ``d2exp32`` is float32 throughout, 1e-4. ``full`` against
  the JAX B3 kernel: the JAX side's accuracy contract, 1e-7 of max |y|, as
  test_torch_df64_ops.py holds B3.
- P3 against the JAX experiment: 1e-7 of max |y| (the JAX side's own error
  is about 3e-8, its pair exponential's); against the float64 truth: 1e-11
  of sum_j |E_ij| |v_j|, the words' truncation (classes c >= 7, about 1e-12
  of the argument). Its operands, class sums and combined sum: exactly.
  P3 runs at d = 2 (U[0, 10]^2), 3 and 20 (pre-scaled, [0, 1.5]^20 at
  d = 20).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from inference_tpu.ops import df64 as jdf64
from inference_tpu_torch.ops import df64
from inference_tpu_torch.probes import df64_ablate, fp64_issue_ms, vpu_probe
from inference_tpu_torch.probes import df64_mxu_d2_experiment as p3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# P1: the issue probe
# --------------------------------------------------------------------- #
def _numpy_probe(x, n_ops, n_chains, mode):
    """``benchmarks/vpu_probe.py:37-63`` restated in numpy, in x's dtype."""
    f = x.dtype.type
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        chains = [x * f(1.0 + 1e-6 * c) for c in range(n_chains)]
        c_mul, c_add = f(0.9999999), f(1e-7)
        if mode == "scalar":
            a, b = c_mul, c_add
        elif mode == "vv":
            a, b = x * c_mul, x * f(1e-9)
        elif mode == "bcast":
            a, b = x[:, 0][:, None] * f(1e-9) + c_mul, x[0, :][None, :] * f(1e-9)
        else:
            a = np.broadcast_to(x[:, 0][:, None] * f(1e-9) + c_mul, x.shape)
            b = x[0, :][None, :] * f(1e-9)
        for _ in range(n_ops // 2):
            chains = [y * a for y in chains]
            chains = [y + b for y in chains]
        acc = chains[0]
        for y in chains[1:]:
            acc = acc + y
    return acc


@pytest.mark.parametrize("mode", vpu_probe.MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_issue_probe_plain_equals_numpy(dtype, mode):
    """The plain version equals the numpy restatement bit for bit, for every
    chain count at the probe's default 128 operations."""
    x = vpu_probe.make_tile(dtype, "cpu", seed=3)
    for n_chains in vpu_probe.CHAINS:
        got = vpu_probe.issue_probe(x, 128, n_chains, mode, reps=1)
        assert got.dtype == dtype and got.shape == (128, 128)
        np.testing.assert_array_equal(got.numpy(), _numpy_probe(x.numpy(), 128, n_chains, mode))


def test_issue_probe_copies_and_checks():
    """reps copies give the one tile's result; bad arguments raise; the
    operation count and bound follow the lanes of the type."""
    x = vpu_probe.make_tile(torch.float64, "cpu")
    one = vpu_probe.issue_probe(x, 10, 2, "vv", reps=1)
    assert torch.equal(vpu_probe.issue_probe(x, 10, 2, "vv", reps=3), one)
    with pytest.raises(ValueError):
        vpu_probe.issue_probe(x, 10, 3, "vv")
    with pytest.raises(ValueError):
        vpu_probe.issue_probe(x, 10, 2, "broadcast")
    with pytest.raises(TypeError):
        vpu_probe.issue_probe(x[:64], 10, 2, "vv")
    ops = vpu_probe.operations(128, 8)
    assert ops == 512 * 128 * 128 * 8 * 128
    assert vpu_probe.bound_ms(ops, torch.float64) == pytest.approx(
        2 * vpu_probe.bound_ms(ops, torch.float32))


# --------------------------------------------------------------------- #
# P2: the stage ablation of B3
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ablate_inputs():
    uh, ul, us64, v = df64_ablate.make_inputs(N, "cpu", seed=4)
    u = us64.numpy()
    dist = ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1)
    return {"uh": uh, "ul": ul, "us64": us64, "v": v, "dist": dist,
            "jax_b3": np.asarray(jdf64.sqexp_matvec_df64(uh.numpy(), ul.numpy(), v.numpy(),
                                                         interpret=True))}


def _numpy_ablate(dist, v, fn):
    """(y, sum_j |term| |w|) of the variant's function in numpy."""
    if fn == "d2exp32":
        term = np.exp((-0.5 * dist).astype(np.float32))
        return term @ v, term @ np.abs(v)
    term = np.exp(-0.5 * dist) if fn in ("d2exp", "full") else dist
    w = v.astype(np.float64) if fn in ("noexp", "full") else np.ones(len(v))
    return term @ w, term @ np.abs(w)


@pytest.mark.parametrize("variant", df64_ablate.VARIANTS)
def test_ablate_plain_matches_numpy(ablate_inputs, variant):
    k = ablate_inputs
    fn = df64_ablate.function_of(variant)
    got = df64_ablate.sqexp_ablate(k["us64"], k["v"], variant).numpy()
    ref, scale = _numpy_ablate(k["dist"], k["v"].numpy(), fn)
    assert got.shape == (N,) and got.dtype == (np.float32 if fn == "d2exp32" else np.float64)
    tol = 1e-4 if fn == "d2exp32" else 1e-13
    assert np.all(np.abs(got - ref) <= tol * scale)


def test_ablate_full_is_b3_and_matches_jax(ablate_inputs):
    """``full`` is B3: equal to the port's B3 and, to the JAX contract, to
    the JAX package's B3 kernel in interpret mode."""
    k = ablate_inputs
    full = df64_ablate.sqexp_ablate(k["us64"], k["v"], "full").numpy()
    np.testing.assert_array_equal(full, df64.sqexp_matvec_df64(k["uh"], k["ul"], k["v"]).numpy())
    ref = k["jax_b3"]
    assert np.abs(full - ref).max() <= 1e-7 * np.abs(ref).max()


def test_ablate_checks_and_bounds():
    uh, ul, us64, v = df64_ablate.make_inputs(N, "cpu")
    with pytest.raises(ValueError):
        df64_ablate.sqexp_ablate(us64, v, "d2x")
    with pytest.raises(ValueError):
        df64_ablate.sqexp_ablate(us64[:200], v[:200], "d2")
    with pytest.raises(TypeError):
        df64_ablate.sqexp_ablate(us64, v.double(), "d2")
    # full's bound is chip_smoke.py's B3 bound: 41 FP64 flops per entry
    n = df64_ablate.N
    assert df64_ablate.variant_bound("full", n) == (float(n) * n * 41 / 33.5e12 * 1e3,
                                                    "operations")
    assert df64_ablate.variant_bound("fulls4", n) == df64_ablate.variant_bound("full", n)


# --------------------------------------------------------------------- #
# P3: the tensor-core cross term
# --------------------------------------------------------------------- #
def _jax_experiment():
    """``benchmarks/df64_mxu_d2_experiment.py``, loaded from its file."""
    path = os.path.join(REPO, "benchmarks", "df64_mxu_d2_experiment.py")
    spec = importlib.util.spec_from_file_location("jax_df64_mxu_d2_experiment", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WORDS_D = (2, 3, 20)  # d = 2 on P3's U[0, 10]^2, the others pre-scaled (p3.make_coords)


@pytest.fixture(scope="module", params=WORDS_D, ids=lambda d: f"d{d}")
def words_inputs(request):
    d = request.param
    _, _, us64, v = p3.make_coords(N, d, "cpu", seed=5)
    u = us64.numpy()
    jx = _jax_experiment()
    E = np.exp(-0.5 * ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1))
    return {"u": u, "v": v, "jx": jx, "E": E, "d": d,
            "jax_y": np.asarray(jx.sqexp_matvec_mxu(u, v.numpy(), interpret=True))}


@pytest.mark.parametrize("scale", [1.0, -3.7, 0.01])
def test_words_and_norms_equal_the_jax_scripts(words_inputs, scale):
    u = words_inputs["u"] * scale
    jx = words_inputs["jx"]
    Wq, s = p3.build_words(u)
    Wq_j, s_j = jx.build_words(u)
    assert s == s_j and Wq.dtype == Wq_j.dtype
    np.testing.assert_array_equal(Wq, Wq_j)
    assert np.abs(Wq).max() <= 64
    for ours, ref in zip(p3.build_norms(u), jx.build_norms(u)):
        np.testing.assert_array_equal(ours, ref)


def test_words_operands_give_the_class_sums(words_inputs):
    """Each class's operands are the JAX kernel's A and B (its ``:104-114``)
    with zeros to the MMA's K step, their product its class-c matmul, the
    tile check's plain version the same sums, and the combined sum times
    2^shift is u_i . u_j to the words' precision."""
    u, d = words_inputs["u"], words_inputs["d"]
    ops = p3.prepare(u, "cpu")
    Wq, _ = p3.build_words(u)
    KA, classes, KB = p3.layout(d)
    assert ops["rows"].shape == (N, KA) and ops["cols"].shape == (N, KB) and ops["d"] == d
    tile_c, tile_p = p3._tile_reference(ops)
    for c in range(p3.NW):
        A_j = Wq[:, : (c + 1) * d]
        B_j = np.concatenate([Wq[:, a * d:(a + 1) * d] for a in range(c, -1, -1)], axis=1)
        A, B = (t.numpy() for t in p3.class_operands(ops, c))
        assert A.shape[1] == B.shape[1] == classes[c][1] and A.shape[1] % p3.KS == 0
        np.testing.assert_array_equal(A[:, : (c + 1) * d], A_j)
        np.testing.assert_array_equal(B[:, : (c + 1) * d], B_j)
        assert not B[:, (c + 1) * d:].any()
        ref = A_j.astype(np.float64) @ B_j.astype(np.float64).T
        np.testing.assert_array_equal((A.astype(np.float64) @ B.astype(np.float64).T), ref)
        np.testing.assert_array_equal(tile_c[c].numpy(), ref[:32, :16])
    hi, lo = p3._class_sums(ops)
    S = hi * 2**p3.LO_BITS + lo  # fits int64 at these d
    combined = sum(tile_p[k].long() * 2 ** (7 * (p3.NW - 1 - b))
                   for k, (_, b) in enumerate(p3.parts(d)))
    np.testing.assert_array_equal(combined.numpy(), S[:32, :16].numpy())
    cross = p3._class_sum_f64(hi, lo) * 2.0 ** ops["shift"]
    assert np.abs(cross.numpy() - u @ u.T).max() <= 1e-11


@pytest.mark.parametrize("d", [20, 256, 300, 1000])
@pytest.mark.parametrize("signs", ["all +64", "random +-64"])
def test_words_class_sum_does_not_overflow(d, signs):
    """At the largest words (every one +-64) the combined S = sum_c C_c
    2^(7 (6 - c)) of the plain version is exact at any d, also where it
    passes int64 (d = 1000): its two words equal the sum in Python's
    integers, lo in [0, 2^42), and its FP64 value is that sum rounded once;
    and each of the kernel's parts of S fits int32."""
    rng = np.random.default_rng(d)
    shape = (32, p3.NW * d)
    W = np.full(shape, 64) if signs == "all +64" else rng.choice([-64, 64], shape)
    rows, cols = p3._operands(W, d)
    ops = {"rows": torch.as_tensor(rows), "cols": torch.as_tensor(cols), "d": d}
    hi, lo = p3._class_sums(ops)
    exact = sum((W[:, : (c + 1) * d].astype(np.int64)
                 @ np.concatenate([W[:, a * d:(a + 1) * d] for a in range(c, -1, -1)], 1).T
                 ).astype(object) * 2 ** (7 * (6 - c)) for c in range(p3.NW))
    if signs == "all +64":  # past int64 at d = 1000
        assert (np.abs(exact).max() >= 2 ** 63) == (d == 1000)
    assert int(lo.min()) >= 0 and int(lo.max()) < 2**p3.LO_BITS
    got = hi.numpy().astype(object) * 2**p3.LO_BITS + lo.numpy().astype(object)
    np.testing.assert_array_equal(got, exact)
    rounded = np.vectorize(float, otypes=[np.float64])(exact)  # Python's int -> float rounds once
    np.testing.assert_array_equal(p3._class_sum_f64(hi, lo).numpy(), rounded)
    C = torch.stack([A.double() @ B.double().T for A, B in
                     (p3.class_operands(ops, c) for c in range(p3.NW))]).long()
    assert int(p3._parts_of(C, d).abs().max()) < 2 ** 31


def test_words_plain_matches_truth_and_jax(words_inputs):
    k = words_inputs
    y = p3.words_matvec(p3.prepare(k["u"], "cpu"), k["v"]).numpy()
    v64 = k["v"].numpy().astype(np.float64)
    assert y.shape == (N,) and y.dtype == np.float64
    assert np.all(np.abs(y - k["E"] @ v64) <= 1e-11 * (k["E"] @ np.abs(v64)))
    ref = k["jax_y"]
    assert np.abs(y - ref).max() <= 1e-7 * np.abs(ref).max()


@pytest.mark.parametrize("d, chunks, mmas, parts", [
    (1, 7, 7, [(0, 2), (3, 5), (6, 6)]), (2, 7, 7, [(0, 2), (3, 5), (6, 6)]),
    (3, 9, 7, [(0, 2), (3, 5), (6, 6)]), (20, 38, 21, [(0, 2), (3, 4), (5, 6)]),
    (33, 63, 35, [(0, 1), (2, 3), (4, 5), (6, 6)]),
    (256, 448, 224, [(0, 1), (2, 3), (4, 5), (6, 6)])])
def test_words_layout_and_readings(d, chunks, mmas, parts):
    """Every class's K is (c + 1) d rounded up to a chunk of 16; the kernel
    issues an m16n8k32 MMA for each pair of chunks and an m16n8k16 for an
    odd last one, ``mmas`` a 16 x 8 tile; the tensor-core time counts the
    MACs issued; the parts of S cover the classes in order; the flops bound
    counts the add of the norms, an fma a part, exp_nonpos's 16 flops and
    the accumulate's fma: 25 FP64 flops an entry with three parts, 27 with
    four."""
    assert p3.parts(d) == parts
    KA, classes, KB = p3.layout(d)
    assert KA == -(-7 * d // 16) * 16 and KB == sum(k for _, k in classes) == 16 * chunks
    assert sum(-(-k // 32) for _, k in classes) == mmas
    assert [off for off, _ in classes] == list(np.cumsum([0] + [k for _, k in classes])[:-1])
    n = 53_248
    assert p3.tensor_ms(n, d) == pytest.approx(n * n * KB / 989.5e12 * 1e3)
    assert p3.words_bound(n, d) == (n * n * (19 + 2 * len(parts)) / 33.5e12 * 1e3, "operations")
    assert fp64_issue_ms(n, 21, 1.98e9) == pytest.approx(n * n * 21 / (132 * 64 * 1.98e9) * 1e3)


def test_words_bound_counts_the_kernels_exp():
    """EXP_NONPOS_FLOPS is the FP64 work of the kernel's exp_nonpos: seven
    fmas, the shifter's subtraction and the product with the table."""
    src = open(os.path.join(REPO, "inference_tpu_torch", "ops", "csrc",
                            "sqexp_words_mma.cu")).read()
    body = src.split("double exp_nonpos(")[1].split("\n}\n")[0]
    fmas = body.count("fma(")
    assert fmas == 7 and "kf - SHIFTER" in body and "p * tab[" in body
    assert p3.EXP_NONPOS_FLOPS == 2 * fmas + 2


def test_words_checks():
    """The plain version takes d above the resident kernel's limit
    (``D_RESIDENT``, the largest d whose smallest resident plan fits a
    block's shared memory), where the kernel's library is built streamed;
    the operands' checks raise."""
    assert p3.D_RESIDENT == 411 and p3._plan_fits(411) and not p3._plan_fits(412)
    assert p3.kernel_variant(411) == (("P3_D", 411),)
    assert p3.kernel_variant(412) == (("P3_D", 412), ("P3_STREAMED", 1))
    u = np.random.default_rng(0).uniform(0, 0.5, (128, p3.D_RESIDENT + 1))
    v = torch.as_tensor(np.random.default_rng(1).normal(size=128).astype(np.float32))
    y = p3.words_matvec(p3.prepare(u, "cpu"), v).numpy()
    E = np.exp(-0.5 * ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1))
    v64 = v.numpy().astype(np.float64)
    assert np.all(np.abs(y - E @ v64) <= 1e-11 * (E @ np.abs(v64)))
    ops = p3.prepare(u[:, :2], "cpu")
    with pytest.raises(TypeError):
        p3.words_matvec(ops, torch.zeros(N, dtype=torch.float64))
    with pytest.raises(ValueError):
        p3.words_matvec(p3.prepare(u[:100, :2], "cpu"), torch.zeros(100))


# --------------------------------------------------------------------- #
# the probes' entry points on the CPU
# --------------------------------------------------------------------- #
def test_probe_mains_run_on_the_cpu(capsys):
    """Each probe's main() on the CPU: the plain versions, no device time."""
    vpu_probe.main(["8", "--device", "cpu", "--modes", "scalar,bcast"])
    df64_ablate.main(["256", "--device", "cpu", "--variants", "d2,full"])
    p3.main(["256", "--device", "cpu"])
    p3.main(["256", "--d", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("checksum") == 2 * 2 * 4 + 3
    assert "GFLOP/s" not in out and " ms" not in out
    assert out.count("B3 rel err 0.00e+00") == 2 and "n=256 d=20:" in out
    for part in out.split("words rel err ")[1:]:
        assert float(part.split(",")[0]) <= 1e-11


def test_probe_runs_agree_on_the_cpu():
    """run() returns the plain versions' results: P2's full and B3 agree,
    and P3 lies within the words' precision of the truth."""
    rows = {r["variant"]: r for r in df64_ablate.run(256, "cpu", ("full", "fullb", "d2"))}
    assert rows["full"]["checksum"] == rows["B3"]["checksum"] == rows["fullb"]["checksum"]
    assert rows["d2"]["ms"] is None and rows["full"]["bound_by"] == "operations"
    for d in (2, 20):
        r = p3.run(256, "cpu", d=d)
        assert r["ms"] is None and r["b3_err"] == 0.0 and r["err"] <= 1e-11 and r["d"] == d
