"""The port's package exports: every name in the ``__all__`` of each path
in ``PATHS`` (but ``GaussianForm``, the port's own) is exported by the JAX
package from the same path, and is the object its defining module of the
port holds."""

import importlib
import sys

import pytest

import inference_tpu_torch
import inference_tpu_torch.ops

PATHS = ("inference_tpu_torch", "inference_tpu_torch.ops", "inference_tpu_torch.mcmc",
         "inference_tpu_torch.models", "inference_tpu_torch.gp", "inference_tpu_torch.pdf",
         "inference_tpu_torch.parallel")
PORT_ONLY = {"GaussianForm"}
# the JAX package's names from these paths that the port does not define:
# the TPU watchdog's chunk length has no job on a GPU (ROADMAP "Not ported")
UNPORTED = {
    "inference_tpu.ops": {"df64_chunk_iters"},
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
