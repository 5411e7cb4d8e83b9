"""The port's package exports: every name in the ``__all__`` of each path
in ``PATHS`` (but the port's own, ``PORT_ONLY``) is exported by the JAX
package from the same path, and is the object its defining module of the
port holds."""

import importlib
import sys

import pytest

import inference_tpu_torch
import inference_tpu_torch.ops

PATHS = ("inference_tpu_torch", "inference_tpu_torch.ops", "inference_tpu_torch.mcmc",
         "inference_tpu_torch.models", "inference_tpu_torch.gp", "inference_tpu_torch.pdf",
         "inference_tpu_torch.parallel", "inference_tpu_torch.approx", "inference_tpu_torch.utils")
# the port's own names: how a posterior reaches the fused kernel (ops' form,
# models' forward model), the device policy and the torch generator of utils
PORT_ONLY = {"GaussianForm", "LinearForwardModel", "resolve_device", "make_generator"}
# the JAX package's names from these paths that the port does not define:
# the TPU watchdog's chunk length has no job on a GPU (ROADMAP "Not ported");
# utils' JAX keys and its probes of traceability and host callbacks have no
# counterpart (torch generators; ``utils.wrap`` routes a posterior by vmap)
UNPORTED = {
    "inference_tpu.ops": {"df64_chunk_iters"},
    "inference_tpu.utils": {"make_key", "is_traceable", "callbacks_supported"},
}


def _jax_path(path):
    return "inference_tpu" + path[len("inference_tpu_torch"):]


@pytest.mark.parametrize(
    "path, name",
    [(path, name) for path in PATHS for name in importlib.import_module(path).__all__
     if name not in PORT_ONLY],
)
def test_port_exports_what_jax_exports(path, name):
    port = importlib.import_module(path)
    reference = importlib.import_module(_jax_path(path))
    assert name in reference.__all__ and hasattr(reference, name)
    obj = getattr(port, name)
    home = obj.__module__
    assert home.startswith("inference_tpu_torch.") and home != path
    assert getattr(sys.modules[home], name) is obj


def test_ops_exports_every_ported_name():
    """The ops path exports all the JAX package's names there but the
    unported ones, and nothing else but the port's own."""
    port = set(inference_tpu_torch.ops.__all__)
    reference = set(importlib.import_module("inference_tpu.ops").__all__)
    assert port - PORT_ONLY == reference - UNPORTED["inference_tpu.ops"]


def test_parallel_exports_what_jax_exports():
    """The parallel path exports the JAX package's names there, all of them
    ported (A13(b))."""
    port = importlib.import_module("inference_tpu_torch.parallel").__all__
    assert sorted(port) == sorted(importlib.import_module("inference_tpu.parallel").__all__)


@pytest.mark.parametrize("path", ["inference_tpu_torch.approx", "inference_tpu_torch.utils"])
def test_approx_and_utils_export_every_ported_name(path):
    """approx exports JAX's four names; utils all of JAX's but the unported
    ones, with PhaseTimer and device_trace, and its own two."""
    port = set(importlib.import_module(path).__all__)
    reference = set(importlib.import_module(_jax_path(path)).__all__)
    assert port - PORT_ONLY == reference - UNPORTED.get(_jax_path(path), set())
    assert {"PhaseTimer", "device_trace"} <= set(importlib.import_module(
        "inference_tpu_torch.utils").__all__)


def test_plotting_has_jax_functions():
    from inference_tpu import plotting as jax_plotting
    from inference_tpu_torch import plotting

    for name in ("matrix_plot", "trace_plot", "hdi_plot", "transition_matrix_plot"):
        assert callable(getattr(plotting, name)) and callable(getattr(jax_plotting, name))
