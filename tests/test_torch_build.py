"""The port's kernel build plumbing (inference_tpu_torch/ops/_build.py) and
kernel B1's per-P variants, on the CPU: library paths keyed by source,
flags and defines; the nvcc command a build runs (through a stub compiler,
never a real compile); one log per variant; and the B1 wrapper's refusals
before any build."""

import os
import stat

import numpy as np
import pytest
import torch

from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.ops import _build, hmc_fused, pairwise
from inference_tpu_torch.ops.hmc_fused import GaussianForm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A stub nvcc that writes a fake library and prints its arguments, in
    a build directory of its own; returns (build dir, call log)."""
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        'args="$*"\n'
        f'echo "$args" >> "{calls}"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo fake > "$2"\n'
        'echo "ptxas info    : Used 40 registers, args: $args"\n'
    )
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    return tmp_path / "kernels", calls


def test_library_paths_differ_by_variant():
    """Two parameter counts of B1 build two libraries, both apart from an
    unrelated kernel's, and the defines name the file."""
    p2 = _build.library_path("hmc_fused", hmc_fused.kernel_variant(2, True))
    p10 = _build.library_path("hmc_fused", hmc_fused.kernel_variant(10, True))
    p10_diag = _build.library_path("hmc_fused", hmc_fused.kernel_variant(10, False))
    other = _build.library_path("sqexp")
    assert len({p2, p10, p10_diag, other}) == 4
    assert p2.name.startswith("hmc_fused_B1_P2_B1_UNIT1_")
    assert p10_diag.name.startswith("hmc_fused_B1_P10_B1_UNIT0_")
    assert p2.parent == p10.parent == _build.BUILD_DIR
    assert _build.library_path("hmc_fused", hmc_fused.kernel_variant(10, True)) == p10


@pytest.mark.parametrize("P", [1, 10, 64])
def test_flags_and_defines_reach_the_command(P, monkeypatch):
    """The nvcc command of a variant carries the common flags, the
    kernel's own flags and its defines, and builds the kernel's source."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/stub/nvcc")
    cmd = _build.command("hmc_fused", hmc_fused.kernel_variant(P, P != 10), "out.so")
    assert cmd[0] == "/stub/nvcc"
    assert f"-DB1_P={P}" in cmd and f"-DB1_UNIT={int(P != 10)}" in cmd and "--fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd and ("-Xptxas", "-v") == tuple(
        cmd[cmd.index("-v") - 1:cmd.index("-v") + 1])
    assert cmd[-3:] == ["-o", "out.so", str(_build.CSRC / "hmc_fused.cu")]
    fused = _build.command("sqexp_fused", (), "x.so")
    assert "--register-usage-level=10" in fused and not any(a.startswith("-D") for a in fused)


def test_build_keeps_one_library_and_log_per_variant(stub_nvcc):
    """Each variant is compiled once into its own library with its own
    log; a second build of the same variant runs no compiler."""
    build_dir, calls = stub_nvcc
    libs = [_build.build("hmc_fused", hmc_fused.kernel_variant(P, True)) for P in (3, 17, 3)]
    assert libs[0] == libs[2] != libs[1]
    assert all(lib.parent == build_dir and lib.exists() for lib in libs)
    lines = calls.read_text().splitlines()
    assert len(lines) == 2
    assert "-DB1_P=3" in lines[0] and "-DB1_P=17" in lines[1]
    for P in (3, 17):
        log = _build.build_log("hmc_fused", hmc_fused.kernel_variant(P, True))
        assert "registers" in log and f"-DB1_P={P}" in log
    assert not [f for f in os.listdir(build_dir) if f.endswith(".tmp")]


def test_failed_build_names_the_variant(stub_nvcc, tmp_path, monkeypatch):
    """A compiler error raises with the variant's library name and leaves
    no library behind."""
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no' >&2\nexit 2\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(bad))
    with pytest.raises(RuntimeError, match=r"hmc_fused_B1_P5_B1_UNIT0_.*exit 2"):
        _build.build("hmc_fused", hmc_fused.kernel_variant(5, False))
    assert not _build.library_path("hmc_fused", hmc_fused.kernel_variant(5, False)).exists()


def _chunk(P, K=8, dtype=torch.float32):
    rng = np.random.default_rng(P)
    t = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt)
    form = GaussianForm(t(np.eye(max(P, 1))[:P, :P])).to(dtype)
    theta = t(rng.normal(size=(P, K)))
    eps = AdaptiveScale(t(np.full(K, 0.2)), t(np.zeros(K)), t(np.zeros(K)),
                        t(np.zeros(K), torch.int32), t(np.full(K, 20), torch.int32))
    args = (theta, t(np.zeros(K)), eps, t(np.ones(K)), t(rng.normal(size=(2, P, K))),
            t(rng.uniform(size=(2, K))), t(rng.uniform(size=(2, K))))
    return args, dict(form=form, steps=5, inv_mass_diag=None, store=False)


@pytest.mark.parametrize("P, dtype, error, message", [
    (0, torch.float32, ValueError, "at least one parameter"),
    (65, torch.float32, ValueError, "CUDA tensors"),
    (3, torch.float64, TypeError, "float64"),
])
def test_wrapper_refuses_before_any_build(P, dtype, error, message, stub_nvcc):
    """P = 0, non-float32 operands and CPU tensors raise in the wrapper,
    before any library is built; P > 64 (the wide route) passes every check
    but the device."""
    build_dir, calls = stub_nvcc
    args, kw = _chunk(P, dtype=dtype)
    with pytest.raises(error, match=message):
        hmc_fused._launch_chunk(*args, **kw)
    assert not calls.exists()


@pytest.mark.parametrize("d", [1, 2, 5, pairwise.B2_D_REG, pairwise.B2_D_REG + 1, 100])
def test_b2_library_and_define_differ_per_d(d, monkeypatch):
    """Kernel B2: its own library and -DB2_D for each D up to B2_D_REG, the
    one wide library (-DB2_D=0) for every larger D."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/stub/nvcc")
    own = d <= pairwise.B2_D_REG
    variant = pairwise.kernel_variant(d)
    assert variant == (("B2_D", d if own else 0),)
    cmd = _build.command("sqexp", variant, "out.so")
    assert f"-DB2_D={d if own else 0}" in cmd and "--fmad=false" in cmd
    assert cmd[-1] == str(_build.CSRC / "sqexp.cu")
    path = _build.library_path("sqexp", variant)
    assert path.name.startswith(f"sqexp_B2_D{d if own else 0}_")
    others = {_build.library_path("sqexp", pairwise.kernel_variant(e)) for e in (1, 2, 5, 100)}
    assert (path in others) == (d in (1, 2, 5) or not own)
    assert len(others) == 4


def test_b2_failed_build_names_b2_and_d(stub_nvcc, tmp_path, monkeypatch):
    """A compiler error in B2's library of one D raises from the wrapper
    naming B2 and that D, before any launch."""
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no' >&2\nexit 2\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(bad))
    _build.load.cache_clear()
    u = torch.zeros((4, 3), dtype=torch.float64)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError, match=r"kernel B2 for D = 3 failed to build.*sqexp_B2_D3_"):
        pairwise._launch_sqexp(u, u, torch.ones((), dtype=torch.float64),
                               torch.ones(3, dtype=torch.float64))


def test_kernel_variant_is_one_per_parameter_count_and_mass():
    """One library per P and kind of mass up to P_NARROW (64), the one wide
    library (-DB1_P=0) for every larger P and either mass."""
    assert hmc_fused.kernel_variant(10, True) == (("B1_P", 10), ("B1_UNIT", 1))
    variants = {hmc_fused.kernel_variant(P, unit) for P in range(1, hmc_fused.P_NARROW + 1)
                for unit in (True, False)}
    assert len(variants) == 128
    wide = {hmc_fused.kernel_variant(P, unit) for P in (65, 100, 256, 1000)
            for unit in (True, False)}
    assert wide == {(("B1_P", 0),)}
    assert _build.library_path("hmc_fused", (("B1_P", 0),)).name.startswith("hmc_fused_B1_P0_")


def test_host_copy_is_kept_until_the_tensor_changes():
    """The launcher's host copy of a form operand is made once per tensor
    and refreshed by an in-place write; other tensors get their own."""
    hmc_fused._HOST_COPIES.clear()
    A = torch.arange(4.0).reshape(2, 2)
    first = hmc_fused._host_copy(A)
    assert hmc_fused._host_copy(A) is first and torch.equal(first, A)
    A.mul_(3.0)
    again = hmc_fused._host_copy(A)
    assert again is not first and torch.equal(again, A)
    other = A.clone()
    assert hmc_fused._host_copy(other) is not again
    assert torch.equal(hmc_fused._host_copy(A.double()), A)
    assert hmc_fused._host_copy(A.double()).dtype == torch.float32


def test_host_copies_are_bounded_and_skip_inference_tensors():
    hmc_fused._HOST_COPIES.clear()
    keep = [torch.full((3,), float(i)) for i in range(hmc_fused._HOST_COPIES_MAX + 4)]
    for x in keep:
        assert torch.equal(hmc_fused._host_copy(x), x)
    assert len(hmc_fused._HOST_COPIES) == hmc_fused._HOST_COPIES_MAX
    assert id(keep[-1]) in hmc_fused._HOST_COPIES and id(keep[0]) not in hmc_fused._HOST_COPIES
    with torch.inference_mode():
        x = torch.ones(3)
    assert torch.equal(hmc_fused._host_copy(x), x)
    assert id(x) not in hmc_fused._HOST_COPIES
    hmc_fused._HOST_COPIES.clear()
