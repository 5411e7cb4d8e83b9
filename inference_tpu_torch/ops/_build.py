"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point. At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout, named by a
hash of its source, the headers the kernels share (``csrc/*.cuh``) and
its flags (``NVCC_FLAGS`` and, for some kernels, ``KERNEL_FLAGS``), and loaded with ``ctypes``. A kernel built in variants
(kernel B1: one library per parameter count) takes ``defines``, pairs
``(macro, value)`` passed to nvcc as ``-Dmacro=value``: they join the
flags in the hash and name the library, so each variant is its own file,
built, logged and loaded apart. The compiler's ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside each library as
``<library>.log``. ``bind`` types an entry point for its wrapper,
``stream`` gives the stream to launch on and ``raise_on`` turns a
launcher's CUDA error code into an exception.
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
# flags of one kernel's build beside NVCC_FLAGS. B3/B4: ptxas's highest
# register-usage level gives the FP64 chains of several rows per thread more
# registers to be scheduled side by side, 1-12% faster on the H100 (PERF.md)
KERNEL_FLAGS = {"sqexp_fused": ("-Xptxas", "--register-usage-level=10")}


def flags(name: str, defines: tuple = ()) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu`` in the variant ``defines``."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ()) + tuple(f"-D{k}={v}" for k, v in defines)


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


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where the library of ``csrc/<name>.cu`` in the variant ``defines``
    is built, keyed by a hash of the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers + " ".join(flags(name, defines)).encode()
    ).hexdigest()[:16]
    tag = "".join(f"_{k}{v}" for k, v in defines)
    return BUILD_DIR / f"{name}{tag}_{digest}.so"


def command(name: str, defines: tuple, out) -> list:
    """The nvcc command that builds ``csrc/<name>.cu`` in the variant
    ``defines`` into ``out``."""
    return [find_nvcc(), *flags(name, defines), "-o", str(out), str(CSRC / f"{name}.cu")]


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` in the variant ``defines`` unless its
    library already exists; return the library's path. The library is
    written under a temporary name and renamed, so concurrent builds never
    load a partial file."""
    lib = library_path(name, defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = command(name, defines, tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {lib.stem} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log(name: str, defines: tuple = ()) -> str:
    """The ``-Xptxas -v`` report of the built library of ``name`` in the
    variant ``defines``."""
    return Path(f"{library_path(name, defines)}.log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (at first use) and load the library of ``csrc/<name>.cu`` in
    the variant ``defines``."""
    return ctypes.CDLL(str(build(name, defines)))


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int, defines: tuple = ()):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (in the variant
    ``defines``), typed as every kernel of the package declares its
    launcher: ``n_ptrs`` pointers, ``n_ints`` ints and the CUDA stream in,
    a CUDA error code out."""
    fn = getattr(load(name, defines), symbol)
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
