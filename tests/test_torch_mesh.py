"""The port's device meshes (``parallel.mesh``, ``parallel.multihost``),
the layout of a sharded state (``parallel._collectives``) and the
multi-device dry run, against the JAX package's helpers on its 8 virtual
CPU devices where they have a counterpart, on CPU cells of one process."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from inference_tpu.parallel import chain_mesh as jax_chain_mesh
from inference_tpu.parallel import global_chain_mesh as jax_global_chain_mesh
from inference_tpu.parallel import global_tempering_mesh as jax_global_tempering_mesh
from inference_tpu.parallel import tempering_mesh as jax_tempering_mesh
from inference_tpu_torch.parallel import (ShardedTempering, chain_mesh, global_chain_mesh,
                                          global_tempering_mesh, initialize_multihost,
                                          tempering_mesh)
from inference_tpu_torch.parallel._collectives import Exchange, Layout
from inference_tpu_torch.parallel.dryrun import dryrun_multichip
from inference_tpu_torch.parallel.mesh import Cell, Mesh, cell_grid
from inference_tpu_torch.parallel.tempering import _even_odd_perm


def shape_of(mesh):
    return dict(mesh.shape), tuple(mesh.axis_names)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_chain_mesh_matches_jax(n):
    port = chain_mesh(n, device="cpu")
    assert shape_of(port) == shape_of(jax_chain_mesh(n))
    assert port.size == n and all(c == Cell(0, torch.device("cpu")) for c in port.cells())
    assert shape_of(chain_mesh(n, axis_name="walkers", device="cpu")) == \
        shape_of(jax_chain_mesh(n, axis_name="walkers"))


@pytest.mark.parametrize("n_rungs, n", [(1, 8), (2, 8), (4, 8), (8, 8), (2, 4), (3, 6)])
def test_tempering_mesh_matches_jax(n_rungs, n):
    assert shape_of(tempering_mesh(n_rungs, n, device="cpu")) == \
        shape_of(jax_tempering_mesh(n_rungs, n))


@pytest.mark.parametrize("n_rungs, n", [(3, 8), (5, 8), (4, 6)])
def test_tempering_mesh_error_matches_jax(n_rungs, n):
    errors = []
    for fn, kw in ((jax_tempering_mesh, {}), (tempering_mesh, dict(device="cpu"))):
        with pytest.raises(ValueError) as info:
            fn(n_rungs, n, **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_global_meshes_match_jax_in_one_process():
    """``test_global_meshes_single_process``: with 8 cells in one process the
    global meshes have JAX's shapes, its error, and a ShardedTempering runs
    on the global tempering layout."""
    kw = dict(device="cpu", cells_per_process=8)
    assert shape_of(global_chain_mesh(**kw)) == shape_of(jax_global_chain_mesh())
    tm = global_tempering_mesh(4, **kw)
    assert shape_of(tm) == shape_of(jax_global_tempering_mesh(4))
    errors = []
    for call in (lambda: jax_global_tempering_mesh(3), lambda: global_tempering_mesh(3, **kw)):
        with pytest.raises(ValueError) as info:
            call()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    st = ShardedTempering(lambda t: -0.5 * (t * t).sum(), np.array([4.0]),
                          [1.0, 3.0, 10.0, 30.0], 4, tm, steps=5, seed=0)
    acc = st.advance(20, swap_interval=10)
    assert acc.shape == (2, 4, 4) and np.isfinite(st.logp).all()


def test_meshes_need_their_device():
    """No fallback: a mesh over "cuda" without a card raises, as every
    entry point of the port does; so does a cell count that is not a
    positive multiple of the process count."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: chain_mesh(2), lambda: tempering_mesh(2, 4),
                 lambda: global_chain_mesh(), lambda: global_tempering_mesh(1)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
    with pytest.raises(ValueError, match="positive multiple"):
        chain_mesh(0, device="cpu")


def test_mesh_surface():
    mesh = tempering_mesh(2, 4, device="cpu")
    assert mesh.shape["rungs"] == 2 and mesh.shape["chains"] == 2
    assert mesh.devices.shape == (2, 2) and mesh.devices[1, 0].rank == 0
    assert mesh.cells()[3] is mesh.devices[1, 1]
    with pytest.raises(ValueError, match="as many dimensions"):
        Mesh(cell_grid(mesh.cells(), (4,)), ("rungs", "chains"))


def test_layout_rows_and_gather():
    """Cell f holds the global rows f * lanes to (f + 1) * lanes - 1; one
    process holds them all, and a gather is the identity there."""
    layout = Layout(tempering_mesh(2, 4, device="cpu"), 3, "test")
    np.testing.assert_array_equal(layout.rows, np.arange(12))
    t = torch.arange(24.0).reshape(2, 12)
    a, b = layout.gather([t, t > 5], axis=1)
    np.testing.assert_array_equal(a, t.numpy())
    assert b.dtype == bool and b.sum() == 18
    assert layout.host_reads == 1


def test_layout_refuses_cells_of_one_process_on_two_devices():
    mesh = Mesh(cell_grid([Cell(0, torch.device("cpu")), Cell(0, torch.device("meta"))], (2,)),
                ("chains",))
    with pytest.raises(NotImplementedError, match=r"A13\(c\)"):
        Layout(mesh, 1, "test")


def test_exchange_pairs_cells_within_a_process():
    """The even-odd pairing of 4 rungs x 2 shards as an index: each row gets
    its partner cell's row of the same lane; unpaired cells keep theirs."""
    layout = Layout(tempering_mesh(4, 8, device="cpu"), 2, "test")
    _, rung_partner = _even_odd_perm(4, 1)  # phase 1: rungs (1, 2) paired, 0 and 3 alone
    partner = [rung_partner[f // 2] * 2 + f % 2 for f in range(8)]
    ex = Exchange(layout, partner)
    data = torch.arange(16.0)[:, None]
    got = ex(data)[:, 0].numpy()
    expect = np.array([0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15], float)
    np.testing.assert_array_equal(got, expect)
    assert ex.local_only and ex.has_partner.numpy().tolist() == [False] * 4 + [True] * 8 + \
        [False] * 4


def test_initialize_multihost_in_one_process():
    """A gloo group of one process: JAX's dict, and the global meshes lay
    out this process's cells."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = initialize_multihost(f"127.0.0.1:{port}", 1, 0, cells_per_process=4, device="cpu",
                                timeout=30)
    try:
        assert info == {"process_id": 0, "n_processes": 1, "local_devices": 4,
                        "global_devices": 4}
        assert shape_of(global_tempering_mesh(2)) == ({"rungs": 2, "chains": 2},
                                                      ("rungs", "chains"))
        layout = Layout(global_chain_mesh(), 2, "test")
        assert layout.grouped
        got = layout.gather([torch.arange(8.0)])[0]
        np.testing.assert_array_equal(got, np.arange(8.0))
    finally:
        dist.destroy_process_group()
        from inference_tpu_torch.parallel import multihost

        multihost._PROCESS.update(device="cuda", cells=1)


def test_dryrun_on_repeated_cpu_cells():
    """``__graft_entry__.dryrun_multichip(8)``'s checks on 8 cells of the
    CPU; without ``devices=`` fewer devices than cells raise."""
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out = dryrun_multichip(8, device="cpu", devices=["cpu"] * 8)
    finally:
        torch.set_default_dtype(dt)
    assert out["mesh"] == {"rungs": 4, "chains": 2} and out["swap_phases"] == 2
    assert 0.0 <= out["swap_rate"] <= 1.0 and out["residual"] < 1e-6 and out["gp_n"] == 1024
    with pytest.raises(ValueError, match="pass devices="):
        dryrun_multichip(8, device="cpu")
