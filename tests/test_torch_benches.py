"""The port's benches (inference_tpu_torch/bench) on the CPU at a tiny size:
each prints one JSON line with ``bench.py``'s keys (``bo_warm``: its own)
and names the device it ran on, with no device rate; their workloads and
flop counts are those of ``bench.py``, ``benchmarks/dense_hmc_bench.py``
and ``benchmarks/bo_warm_bench.py``."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from inference_tpu_torch.bench import bo_warm, dense_hmc, headline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "scaling", "acceptance", "mfu_pct"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_headline_prints_one_json_line_with_bench_keys(capsys):
    headline.main(["--device", "cpu", "--chains", "32", "64", "--work", "96"])
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    result = lines[0]
    assert BENCH_KEYS | {"device"} == set(result)
    assert result["device"] == "cpu" and result["mfu_pct"] is None
    assert result["vs_baseline"] is None
    assert set(result["scaling"]) == {"32", "64"}
    assert 0.0 < result["acceptance"] <= 1.0
    assert result["value"] == max(result["scaling"].values()) > 0


def test_headline_workload_is_bench_py_s():
    bench = _module(os.path.join(REPO, "bench.py"))
    np.testing.assert_array_equal(headline.make_cov(), bench.make_cov())
    assert (headline.N_DIM, headline.HMC_STEPS, headline.CHAIN_SWEEP, headline.WORK_PER_TIER) == (
        bench.N_DIM, bench.HMC_STEPS, bench.CHAIN_SWEEP, bench.WORK_PER_TIER)
    # bench.py's flop count per transition, against a float32 peak of the card
    assert headline.flops_per_transition() == bench.HMC_STEPS * (2 * 10 * 10 + 8 * 10)


def test_dense_hmc_prints_one_json_line_with_bench_keys(capsys):
    dense_hmc.main(["--device", "cpu", "--chains", "4", "--work", "8"])
    out = capsys.readouterr().out
    lines = _json_lines(out)
    assert len(lines) == 1
    result = lines[0]
    assert BENCH_KEYS | {"device", "tflops", "tf32"} == set(result)
    assert result["device"] == "cpu" and result["tf32"] is False
    assert set(result["scaling"]) == {"gaussian", "forward-model"}
    assert all(v is None for v in result["mfu_pct"].values())
    assert "[gaussian] chains=4" in out and "[forward-model] chains=4" in out
    assert "not measured" in out


def test_dense_hmc_workloads_and_flops_are_the_jax_bench_s():
    """The same shapes, seeds and flop counts as benchmarks/dense_hmc_bench.py
    (its module imports jax only inside its functions)."""
    ref = _module(os.path.join(REPO, "benchmarks", "dense_hmc_bench.py"))
    assert (dense_hmc.P, dense_hmc.N_DATA, dense_hmc.HMC_STEPS) == (ref.P, ref.N_DATA, ref.HMC_STEPS)
    for kind in ("gaussian", "forward-model"):
        assert dense_hmc.flops_per_transition(kind) == ref.flops_per_transition(kind)
    form, cov = dense_hmc.correlated_gaussian()
    rng = np.random.default_rng(42)
    A = rng.normal(size=(ref.P, ref.P)) / np.sqrt(ref.P)
    np.testing.assert_allclose(cov, A @ A.T + 0.1 * np.eye(ref.P))
    like, A_fm, y, sigma = dense_hmc.forward_model("cpu")
    assert A_fm.shape == (ref.N_DATA, ref.P) and y.shape == (ref.N_DATA,)
    assert like.n_data == ref.N_DATA and np.all(sigma == 0.1)


def test_bo_warm_prints_one_json_line(capsys):
    bo_warm.main(["--device", "cpu", "--iterations", "1", "--dtype", "float64"])
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    result = lines[0]
    assert result["bench"] == "bo_warm" and result["device"] == "cpu"
    assert result["iterations"] == 1 and result["dtype"] == "float64"
    assert set(result["warm_iteration_s"]) == {"median", "min", "max"}
    assert np.isfinite(result["best_objective"])


def test_bo_warm_configuration_is_the_jax_bench_s():
    """The same objective, starting points and bounds as
    benchmarks/bo_warm_bench.py (which imports jax only inside main)."""
    ref = _module(os.path.join(REPO, "benchmarks", "bo_warm_bench.py"))
    x = np.random.default_rng(5).uniform(0, 6, (7, 2))
    assert [bo_warm.objective(p) for p in x] == [ref.objective(p) for p in x]
    opt = bo_warm.make_optimiser("cpu", torch.float64)
    np.testing.assert_array_equal(opt.x, np.random.default_rng(0).uniform(0, 6, size=(6, 2)))
    assert opt.bounds == [(0.0, 6.0), (0.0, 6.0)] and opt.optimizer == "device"
    assert type(opt.acquisition).__name__ == "ExpectedImprovement"
    assert (bo_warm.WARMUP, bo_warm.ITERATIONS) == (2, 10)
