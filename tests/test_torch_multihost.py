"""The port's multi-process runtime: two real gloo processes on the CPU,
each holding 4 cells (``tests/_torch_multihost_worker.py``), modelled on
tests/test_multihost.py. They join over a localhost coordinator
(``initialize_multihost``) and run, for real: the gather of sharded rows,
a ``ShardedTempering`` whose swaps cross the process boundary (held to the
same swaps in one process, on the same state and uniforms, exactly), a
short run and a checkpoint restored across the processes, a
``ChainArray`` over the global chain mesh, and the row-sharded GP on a
4-cell global mesh, 2 cells a process (the sharded df64 matmat,
``LargeScaleGP`` in the df64 and cg tiers, the df64 inverter), each held to
the same run on a 4-cell mesh of one process exactly. The worker pair runs
once per module; each worker has a hard timeout and is killed when it
runs out.
"""

import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_multihost_worker.py")
TIMEOUT = 120  # seconds a worker may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_module():
    spec = importlib.util.spec_from_file_location("_torch_multihost_worker", WORKER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("torch_multihost"))
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, "2", str(i), out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return [dict(np.load(os.path.join(out_dir, f"rank{i}.npz"))) for i in range(2)]


def test_two_process_group_and_gather(results):
    for i, r in enumerate(results):
        assert int(r["info_process_id"]) == i and int(r["info_n_processes"]) == 2
        assert int(r["info_local_devices"]) == 4 and int(r["info_global_devices"]) == 8
        # each cell's rows, gathered from both processes in global order
        np.testing.assert_array_equal(r["gathered"], np.arange(16.0))
        # global_tempering_mesh keeps each 4-rung ladder inside one process
        assert list(r["tempering_col_procs"]) == [1, 1]


def test_swaps_across_processes_equal_one_process(results):
    """Both swap phases (phase 1's middle pair crosses the processes) on
    the same state and uniforms as one process, exactly."""
    worker = _worker_module()
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        from inference_tpu_torch.parallel import ShardedTempering, tempering_mesh

        st = ShardedTempering(worker.gauss2, worker.START, worker.TEMPS, 4,
                              tempering_mesh(4, 8, device="cpu"), steps=5, epsilon=0.25, seed=3)
        ref = worker.swap_scenario(st)
    finally:
        torch.set_default_dtype(dt)
    assert 0 < ref["flags1"].mean() < 1 and ref["flags1"][4:12].any()  # rungs 1, 2 swap
    for r in results:
        for key, value in ref.items():
            np.testing.assert_array_equal(r[f"swap_{key}"], value)


def test_sharded_tempering_advances_across_processes(results):
    """A run over both processes: both gather the same global state,
    history and swap counts, and the swaps accept at a healthy rate."""
    a, b = results
    for key in ("advance_theta", "advance_logp", "advance_history", "advance_successful"):
        np.testing.assert_array_equal(a[key], b[key])
    assert 0.05 < float(a["advance_rate"]) < 1.0
    assert np.isfinite(a["advance_logp"]).all() and a["advance_history"].shape == (40, 4, 4, 2)


def test_checkpoint_restore_across_processes(results):
    for r in results:
        np.testing.assert_array_equal(r["restored_theta"], r["advance_theta"])
        assert int(r["restored_phase"]) == 0 and np.isfinite(r["restored_logp"]).all()


def test_chain_array_across_processes(results):
    """``ChainArray(mesh=global_chain_mesh())``: each process steps its 8
    chains; both gather the same history of all 16, which moved."""
    a, b = results
    np.testing.assert_array_equal(a["ca_history"], b["ca_history"])
    assert a["ca_history"].shape == (64, 16, 2)
    assert (np.abs(a["ca_theta"] - np.array([1.0, -1.0])) > 0).all(axis=1).mean() > 0.5
    np.testing.assert_array_equal(a["ca_rhat"], b["ca_rhat"])
    np.testing.assert_array_equal(a["ca_local_rows"], np.arange(8))
    np.testing.assert_array_equal(b["ca_local_rows"], np.arange(8, 16))
    for r in results:
        np.testing.assert_array_equal(r["ca_restored_theta"], r["ca_theta"])


@pytest.fixture(scope="module")
def gp_reference():
    """``gp_scenario`` on a 4-cell mesh of this one process, single-threaded
    as the workers run."""
    worker = _worker_module()
    dt, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(1)
    try:
        from inference_tpu_torch.parallel import chain_mesh

        return worker.gp_scenario(chain_mesh(4, device="cpu"))
    finally:
        torch.set_default_dtype(dt)
        torch.set_num_threads(threads)


@pytest.mark.parametrize("key", ["matmat", "df64_means", "df64_var", "cg_means", "inv_mean"])
def test_gp_across_processes_equals_one_process(results, gp_reference, key):
    """The GP's row blocks dealt to 2 processes x 2 cells and gathered give
    what 4 cells of one process give, bit for bit, on both processes."""
    for r in results:
        assert list(r["gp_cell_ranks"]) == [0, 0, 1, 1]
        np.testing.assert_array_equal(r[f"gp_{key}"], gp_reference[key])
    assert float(results[0]["gp_df64_residual"]) < 1e-8
