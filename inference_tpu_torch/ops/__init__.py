"""Hand-written GPU kernels and their plain PyTorch versions:
``hmc_fused`` (kernel B1, fused whole-trajectory HMC transitions; its
model route for the library's posteriors over a linear forward model in
``hmc_model``) and
``pairwise`` (kernel B2, the squared-exponential covariance block) and
``df64`` (kernels B3-B8, the matrix-free GP's kernel matrix in FP64); the
dense linear algebra of the GP path (``linalg``) and the matrix-free GP's
solvers (``solvers``)."""

from .hmc_fused import GaussianForm
from .pairwise import scaled_sq_distances, sqexp_covariance
from .linalg import add_diagonal, identity_like
from .solvers import mixed_pcg, pcg_multi, df64_pcg, Df64Solver, Df64MultiSolver
from .df64 import (
    sqexp_matvec_df64,
    sqexp_matmat_df64,
    sqexp_matmat_rect_df64,
    sqexp_matmat_df64_sharded,
    sqexp_entries_df64,
    sqexp_entries_f32,
    sqexp_stored_matvec_df64,
    sqexp_stored_matmat_df64,
    sqexp_stored_f32_matmat,
    stored_entries_tier,
    split_f64,
)

# the JAX package's names from this path that the port defines, and
# GaussianForm, the port's own: how a posterior reaches kernel B1
__all__ = [
    "GaussianForm",
    "scaled_sq_distances",
    "sqexp_covariance",
    "add_diagonal",
    "identity_like",
    "mixed_pcg",
    "pcg_multi",
    "df64_pcg",
    "Df64Solver",
    "Df64MultiSolver",
    "sqexp_matvec_df64",
    "sqexp_matmat_df64",
    "sqexp_matmat_rect_df64",
    "sqexp_matmat_df64_sharded",
    "sqexp_entries_df64",
    "sqexp_entries_f32",
    "sqexp_stored_matvec_df64",
    "sqexp_stored_matmat_df64",
    "sqexp_stored_f32_matmat",
    "stored_entries_tier",
    "split_f64",
]
