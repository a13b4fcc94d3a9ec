"""Feature matrices: dense tensors and padded-sparse (ELL) rows.

The port of ``photon_tpu/ops/features.py``. Sparse rows use the padded
ELL layout (``indices [n, k]`` int32, ``values [n, k]``) with pad slots
``(0, 0.0)``, so pads contribute ``0 * theta[0]`` to margins and scatter
``+0`` into gradients. An index outside ``[0, D)`` adds 0 everywhere (the
Pallas kernels' semantics, which the port's K2 keeps too).

The aggregators (``ops/aggregators.py``) reduce to three primitives on
either layout — ``matvec`` (margins), ``rmatvec`` (``X^T w``) and
``sq_rmatvec`` (``(X*X)^T w``, for Hessian diagonals) — plus
``weighted_gram`` for small-dimension full Hessians.

Mixed storage: features may be stored narrower than the weights (bf16
features, f32 or f64 coefficients). Where JAX promotes implicitly, these
functions promote explicitly to the wider type before the product.

The sparse scatters use ``index_put_(..., accumulate=True)``, which sorts
the indices on the card and adds each column's terms in a fixed order, so
reruns are bitwise equal (``index_add_`` on the card uses float atomics).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor


class SparseFeatures(NamedTuple):
    """Padded ELL rows: ``indices[i, j]`` / ``values[i, j]`` is the j-th
    nonzero of sample i; pad slots are ``(0, 0.0)``."""

    indices: Tensor  # [n, k] int32
    values: Tensor   # [n, k] float

    def to(self, device) -> "SparseFeatures":
        return SparseFeatures(self.indices.to(device), self.values.to(device))


FeatureMatrix = Union[Tensor, SparseFeatures]


def num_samples(x: FeatureMatrix) -> int:
    return (x.values if isinstance(x, SparseFeatures) else x).shape[0]


def _promoted(a: Tensor, dtype: torch.dtype) -> Tensor:
    return a if a.dtype == dtype else a.to(dtype)


def _in_range(x: SparseFeatures, dim: int):
    """(column ids clamped into [0, dim), whether each id was in range).
    An id outside [0, dim) adds 0 on every route, as in the Pallas
    kernels and the port's K2, where it matches no column."""
    cols = x.indices.long()
    return cols.clamp(0, max(dim - 1, 0)), (cols >= 0) & (cols < dim)


def matvec(x: FeatureMatrix, theta: Tensor) -> Tensor:
    """Per-sample margins ``X @ theta`` -> [n]."""
    if isinstance(x, SparseFeatures):
        dt = torch.promote_types(x.values.dtype, theta.dtype)
        cols, keep = _in_range(x, theta.shape[0])
        vals = _promoted(x.values, dt)
        if not theta.shape[0]:
            return torch.zeros(vals.shape[0], dtype=dt, device=vals.device)
        terms = vals * _promoted(theta, dt)[cols]
        return torch.where(keep, terms, torch.zeros_like(terms)).sum(dim=-1)
    dt = torch.promote_types(x.dtype, theta.dtype)
    return _promoted(x, dt) @ _promoted(theta, dt)


def _scatter(x: SparseFeatures, contrib: Tensor, dim: int) -> Tensor:
    """Sum ``contrib`` [n, k] into [dim] by column; an id outside [0, dim)
    sends nothing."""
    cols, keep = _in_range(x, dim)
    out = torch.zeros(dim, dtype=contrib.dtype, device=contrib.device)
    if not dim:
        return out
    kept = torch.where(keep, contrib, torch.zeros_like(contrib))
    return out.index_put_((cols.reshape(-1),), kept.reshape(-1),
                          accumulate=True)


def rmatvec(x: FeatureMatrix, w: Tensor, dim: int) -> Tensor:
    """``X^T w`` -> [d]; ``w`` is a per-sample weight vector [n]."""
    if isinstance(x, SparseFeatures):
        dt = torch.promote_types(x.values.dtype, w.dtype)
        return _scatter(x, _promoted(x.values, dt) * _promoted(w, dt)[:, None],
                        dim)
    dt = torch.promote_types(x.dtype, w.dtype)
    return _promoted(w, dt) @ _promoted(x, dt)


def sq_rmatvec(x: FeatureMatrix, w: Tensor, dim: int) -> Tensor:
    """``(X * X)^T w`` -> [d] (elementwise square). Values promote to the
    weight type BEFORE squaring, so narrow storage does not round the
    squared Hessian terms."""
    if isinstance(x, SparseFeatures):
        v = _promoted(x.values, w.dtype)
        return _scatter(x, v * v * w[:, None], dim)
    xf = _promoted(x, w.dtype)
    return w @ (xf * xf)


def weighted_gram(x: FeatureMatrix, w: Tensor, dim: int) -> Tensor:
    """``X^T diag(w) X`` -> [d, d], for small-dim full Hessians
    (reference: HessianMatrixAggregator.scala:31)."""
    if isinstance(x, SparseFeatures):
        n, k = x.indices.shape
        if k <= 64:
            # per-slot scatter of the outer product: temporaries are
            # [n, k], the data's own footprint, never an [n, dim] copy
            cols, keep = _in_range(x, dim)
            vals = _promoted(x.values, w.dtype)
            vals = torch.where(keep, vals, torch.zeros_like(vals))
            wv = w[:, None] * vals                              # [n, k]
            h = torch.zeros(dim * dim, dtype=wv.dtype, device=w.device)
            for j in range(k):
                flat = cols[:, j:j + 1] * dim + cols            # [n, k]
                h.index_put_((flat.reshape(-1),),
                             (wv[:, j:j + 1] * vals).reshape(-1),
                             accumulate=True)
            return h.reshape(dim, dim)
        dense = _promoted(to_dense(x, dim), w.dtype)
        return dense.T @ (dense * w[:, None])
    xf = _promoted(x, w.dtype)
    return xf.T @ (xf * w[:, None])


def to_dense(x: FeatureMatrix, dim: int) -> Tensor:
    if isinstance(x, SparseFeatures):
        n, k = x.indices.shape
        out = torch.zeros(n * dim, dtype=x.values.dtype,
                          device=x.values.device)
        rows = torch.arange(n, device=x.indices.device)[:, None]
        cols, keep = _in_range(x, dim)
        vals = torch.where(keep, x.values, torch.zeros_like(x.values))
        out.index_put_(((rows * dim + cols).reshape(-1),), vals.reshape(-1),
                       accumulate=True)
        return out.reshape(n, dim)
    return x


def _ell(n: int, k: int, dtype) -> tuple:
    return np.zeros((n, k), dtype=np.int32), np.zeros((n, k), dtype=dtype)


def _as_sparse(indices: np.ndarray, values: np.ndarray) -> SparseFeatures:
    return SparseFeatures(torch.from_numpy(indices), torch.from_numpy(values))


def _width(widest: int, max_nnz: Optional[int]) -> int:
    k = int(max_nnz) if max_nnz is not None else widest
    if widest > k:
        raise ValueError(f"row has {widest} nonzeros > max_nnz={k}; "
                         "refusing to silently truncate features")
    return k


def from_csr_arrays(indptr, cols, vals, max_nnz: Optional[int] = None,
                    dtype=np.float32) -> SparseFeatures:
    """Host-side: raw CSR arrays -> padded ELL (CPU tensors)."""
    indptr = np.asarray(indptr, np.int64)
    n = len(indptr) - 1
    row_nnz = np.diff(indptr)
    k = _width(int(row_nnz.max()) if n else 0, max_nnz)
    indices, values = _ell(n, k, dtype)
    if n and k:
        slot = np.arange(k)[None, :]
        mask = slot < row_nnz[:, None]
        src = indptr[:-1, None] + slot
        indices[mask] = np.asarray(cols)[src[mask]]
        values[mask] = np.asarray(vals)[src[mask]]
    return _as_sparse(indices, values)


def from_scipy_csr(csr, max_nnz: Optional[int] = None,
                   dtype=np.float32) -> SparseFeatures:
    """Host-side: scipy CSR -> padded ELL (CPU tensors). Rows wider than
    ``max_nnz`` are refused: silent truncation would corrupt margins."""
    csr = csr.tocsr()
    return from_csr_arrays(csr.indptr, csr.indices, csr.data,
                           max_nnz=max_nnz, dtype=dtype)


def from_rows(rows, dim: int, dtype=np.float32,
              max_nnz: Optional[int] = None) -> SparseFeatures:
    """Host-side: list of (indices, values) pairs -> padded ELL."""
    del dim  # the width is carried by coefficient vectors, not the ELL
    k = _width(max((len(r[0]) for r in rows), default=0), max_nnz)
    indices, values = _ell(len(rows), k, dtype)
    for i, (idx, val) in enumerate(rows):
        m = len(idx)
        indices[i, :m] = np.asarray(idx, dtype=np.int32)
        values[i, :m] = np.asarray(val, dtype=dtype)
    return _as_sparse(indices, values)
