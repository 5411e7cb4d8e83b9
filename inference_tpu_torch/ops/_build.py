"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point. At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout, named by a
hash of its source and flags, and loaded with ``ctypes``. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
the library as ``<library>.log``. ``bind`` types an entry point for its
wrapper, ``stream`` gives the stream to launch on and ``raise_on`` turns
a launcher's CUDA error code into an exception.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``$PATH`` or the toolkit's default
    install location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "package's kernels"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed by a hash of
    the source and the flags."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; return
    the library's path. The library is written under a temporary name and
    renamed, so concurrent builds never load a partial file."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the built library of ``name``."""
    return Path(f"{library_path(name)}.log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed as every
    kernel of the package declares its launcher: ``n_ptrs`` device pointers,
    ``n_ints`` ints and the CUDA stream in, a CUDA error code out."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, for a launcher."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"kernel {kernel} launch failed with CUDA error {rc}")
