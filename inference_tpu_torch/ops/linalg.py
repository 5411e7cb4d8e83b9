"""Dense linear-algebra helpers for the Gaussian-process path.

Port of ``inference_tpu.ops.linalg``. ``add_diagonal`` and
``identity_like`` keep the JAX package's names. ``blocked_cholesky``,
``blocked_tril_inverse`` and ``tril_gram`` are the blocked factorisation,
triangular inverse and triangular Gram product as plain torch: every
O(N^3) term is a matrix product, and the ``block x block`` diagonal
factorisations and solves go to ``torch.linalg`` (LAPACK on the CPU,
cuSOLVER and cuBLAS on a GPU). ``GpRegressor(cholesky="blocked" | int |
"analytic")`` reaches them; everything else uses ``torch.linalg``
directly.

A failed factorisation gives NaN, as ``jnp.linalg.cholesky`` does (torch's
own ``cholesky`` raises instead), so callers can pin the likelihood to a
floor without a host round trip.
"""

import torch
from torch.utils.checkpoint import checkpoint


def add_diagonal(K, value):
    """``K + value * I`` as a new tensor; ``value`` is a scalar or a
    length-N vector."""
    out = K.clone()
    out.diagonal().add_(value)
    return out


def identity_like(K):
    """An identity matrix with the shape, dtype and device of ``K``."""
    return torch.eye(K.shape[0], dtype=K.dtype, device=K.device)


def cholesky_or_nan(K):
    """Lower Cholesky factor of ``K``, all NaN where the factorisation
    fails (``jnp.linalg.cholesky``'s convention)."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill(info != 0, float("nan"))


def _tril_solve(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def blocked_cholesky(K, block: int = 2048, method: str = "inv", remat: bool = True):
    """Right-looking blocked Cholesky over block columns.

    Each step factors the ``block x block`` diagonal block, forms the
    panel below it and downdates the trailing matrix with one matrix
    product, so the N^3/3 flops of the factorisation are matmul work.

    :param block: panel width; ``N <= block`` factors in one call.
    :param method: ``"inv"`` forms the panel as one product with the
        explicit inverse of the diagonal factor (error ~cond(L_kk) * eps on
        the panel); ``"trsm"`` solves against the panel, the textbook
        stable choice.
    :param remat: recompute each block step in the backward pass
        (``torch.utils.checkpoint``), so autograd keeps O(N^2) memory.
    """
    if method not in ("inv", "trsm"):
        raise ValueError(f"'method' must be 'inv' or 'trsm', got {method!r}")
    n = K.shape[0]
    if n <= block:
        return cholesky_or_nan(K)
    pad = (-n) % block
    if pad:
        # embed K as blockdiag(K, I): its factor is blockdiag(L, I)
        K = torch.nn.functional.pad(K, (0, pad, 0, pad))
        K.diagonal()[n:] = 1.0
    n_padded = n + pad

    def step(trailing):
        """One block column: the diagonal factor, the panel below it and
        the downdated trailing matrix."""
        Lkk = cholesky_or_nan(trailing[:block, :block])
        below = trailing[block:, :block]
        if method == "inv":
            panel = below @ _tril_solve(Lkk, identity_like(Lkk)).T
        else:
            panel = _tril_solve(Lkk, below.T).T
        rest = trailing[block:, block:] - panel @ panel.T
        return Lkk, panel, rest

    run = (lambda t: checkpoint(step, t, use_reentrant=False)) if remat else step
    cols = []
    trailing = K
    while trailing.shape[0] > block:
        Lkk, panel, trailing = run(trailing)
        cols.append((Lkk, panel))
    cols.append((cholesky_or_nan(trailing), None))

    # column block k carries [0; L_kk; panel] at offset k*block
    L = K.new_zeros((n_padded, n_padded))
    for k, (Lkk, panel) in enumerate(cols):
        i0 = k * block
        L[i0 : i0 + block, i0 : i0 + block] = Lkk
        if panel is not None:
            L[i0 + block :, i0 : i0 + block] = panel
    return L[:n, :n]


def blocked_tril_inverse(L, block: int = 2048):
    """Explicit inverse of a lower-triangular matrix by blocked forward
    substitution: ``X_ii = L_ii^-1`` (one small triangular solve) and, for
    i > j, ``X_ij = -X_ii @ sum_{j<=k<i} L_ik X_kj``; n^3/3 flops, all
    matrix products. Padding embeds L as blockdiag(L, I)."""
    n = L.shape[0]
    if n <= block:
        return _tril_solve(L, identity_like(L))
    pad = (-n) % block
    if pad:
        L = torch.nn.functional.pad(L, (0, pad, 0, pad))
        L.diagonal()[n:] = 1.0
    nb = (n + pad) // block
    blk = lambda i, j: L[i * block : (i + 1) * block, j * block : (j + 1) * block]
    eye = identity_like(blk(0, 0))

    X = [[None] * nb for _ in range(nb)]
    for i in range(nb):
        X[i][i] = _tril_solve(blk(i, i), eye)
    for j in range(nb):
        for i in range(j + 1, nb):
            row = L[i * block : (i + 1) * block, j * block : i * block]
            col = torch.cat([X[k][j] for k in range(j, i)], dim=0)
            X[i][j] = -(X[i][i] @ (row @ col))

    out = torch.zeros_like(L)
    for i in range(nb):
        for j in range(i + 1):
            out[i * block : (i + 1) * block, j * block : (j + 1) * block] = X[i][j]
    return out[:n, :n]


def tril_gram(X, block: int = 2048):
    """``X^T X`` for a lower-triangular ``X``, blockwise:
    ``G_ij = sum_{k >= max(i,j)} X_ki^T X_kj``. The zero blocks above the
    diagonal are never touched, so it costs n^3/3 flops instead of n^3.
    With ``blocked_tril_inverse`` it forms ``K^-1 = L^-T L^-1``."""
    n = X.shape[0]
    if n <= block:
        return X.T @ X
    pad = (-n) % block
    if pad:
        # padded rows/columns of X contribute nothing to X^T X
        X = torch.nn.functional.pad(X, (0, pad, 0, pad))
    nb = (n + pad) // block

    G = torch.zeros_like(X)
    for i in range(nb):
        for j in range(i, nb):
            # columns i and j of X are both nonzero from block row j down
            col_i = X[j * block :, i * block : (i + 1) * block]
            col_j = X[j * block :, j * block : (j + 1) * block]
            Gij = col_i.T @ col_j
            G[i * block : (i + 1) * block, j * block : (j + 1) * block] = Gij
            if i != j:
                G[j * block : (j + 1) * block, i * block : (i + 1) * block] = Gij.T
    return G[:n, :n]
