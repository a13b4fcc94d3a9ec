"""The GLM compute kernels: value+gradient, Hessian products.

The port of ``photon_tpu/ops/aggregators.py`` (reference: photon-lib
function/glm/ValueAndGradientAggregator.scala:34, HessianVectorAggregator
.scala:37, HessianDiagonalAggregator.scala:33, HessianMatrixAggregator
.scala:31).

Normalization is folded in algebraically, as in the reference
(ValueAndGradientAggregator.scala:36-80): with x' = (x - shift) * factor
and e = coef * factor,

    margin_i = e . x_i - e . shift + offset_i
    d value / d coef_j = factor_j [sum_i w_i l'_i x_ij]
                         - (sum_i w_i l'_i) factor_j shift_j

so the raw data is never rescaled.

Routing of ``value_and_gradient`` is by structure alone (no flag, no
fallback): dense 2-D f32/bf16 features with an f32 coef and identity
normalization go to the K1 wrapper; padded-ELL f32/bf16 values with an
f32 coef, D <= 4096 and identity normalization go to the K2 wrapper;
everything else (f64 coefficients, a normalization, ELL wider than 4096)
takes the two-pass path below. ``routes`` counts each decision;
``two_pass_cuda`` counts two-pass evaluations on a CUDA device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from photon_tpu_torch.ops import fused_value_grad as fvg
from photon_tpu_torch.ops.features import (
    FeatureMatrix,
    SparseFeatures,
    matvec,
    rmatvec,
    sq_rmatvec,
    weighted_gram,
)
from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.ops.normalization import NormalizationContext

Tensor = torch.Tensor

#: routing decisions of value_and_gradient in this process, any device
routes: Dict[str, int] = {"dense_kernel": 0, "sparse_kernel": 0,
                          "two_pass": 0}
#: two-pass value_and_gradient evaluations on a CUDA device
two_pass_cuda = 0


def reset_counts() -> None:
    global two_pass_cuda
    for key in routes:
        routes[key] = 0
    two_pass_cuda = 0


def effective_coefficients(coef: Tensor, norm: NormalizationContext
                           ) -> Tuple[Tensor, Tensor]:
    """(e, margin_shift) with e = coef*factor and margin_shift = -e.shift."""
    e = coef * norm.factors if norm.factors is not None else coef
    if norm.shifts is not None:
        shift = -torch.dot(e, norm.shifts)
    else:
        shift = torch.zeros((), dtype=coef.dtype, device=coef.device)
    return e, shift


def compute_margins(x: FeatureMatrix, coef: Tensor,
                    offsets: Optional[Tensor],
                    norm: NormalizationContext) -> Tensor:
    e, margin_shift = effective_coefficients(coef, norm)
    m = matvec(x, e) + margin_shift
    if offsets is not None:
        m = m + offsets
    return m


def _apply_factor_and_shift(vec: Tensor, prefactor: Tensor,
                            norm: NormalizationContext) -> Tensor:
    """factor * vec - prefactor * factor * shift (identity when
    unnormalized)."""
    out = vec
    if norm.factors is not None:
        out = out * norm.factors
        if norm.shifts is not None:
            out = out - prefactor * norm.factors * norm.shifts
    elif norm.shifts is not None:
        out = out - prefactor * norm.shifts
    return out


def kernel_route(x: FeatureMatrix, coef: Tensor,
                 norm: NormalizationContext) -> Optional[str]:
    """Which fused kernel takes this evaluation, or None for two-pass —
    the JAX package's ``_supported`` / ``_supported_sparse`` conditions
    (``pallas_glm.py:76-98``, ``:205-230``) without its env flag."""
    if not norm.is_identity or coef.dtype != torch.float32:
        return None
    if isinstance(x, SparseFeatures):
        if (x.values.dim() == 2 and x.values.dtype in fvg.STORAGE
                and coef.shape[0] <= fvg.MAX_SPARSE_DIM):
            return "sparse_kernel"
        return None
    if x.dim() == 2 and x.dtype in fvg.STORAGE:
        return "dense_kernel"
    return None


def value_and_gradient(loss: PointwiseLoss, x: FeatureMatrix,
                       labels: Tensor, offsets: Optional[Tensor],
                       weights: Optional[Tensor], coef: Tensor,
                       norm: NormalizationContext) -> Tuple[Tensor, Tensor]:
    """Weighted loss value and gradient w.r.t. transformed-space coef
    (reference: ValueAndGradientAggregator.calculateValueAndGradient)."""
    global two_pass_cuda
    route = kernel_route(x, coef, norm)
    if route == "dense_kernel":
        routes[route] += 1
        return fvg.fused_dense_value_grad(loss, x, labels, offsets, weights,
                                          coef)
    if route == "sparse_kernel":
        routes[route] += 1
        return fvg.fused_sparse_value_grad(loss, x, labels, offsets,
                                           weights, coef)
    routes["two_pass"] += 1
    if coef.device.type == "cuda":
        two_pass_cuda += 1
    dim = coef.shape[0]
    margins = compute_margins(x, coef, offsets, norm)
    l, dz = loss.loss_and_dz(margins, labels)
    if weights is not None:
        l = l * weights
        dz = dz * weights
    value = l.sum()
    grad = _apply_factor_and_shift(rmatvec(x, dz, dim), dz.sum(), norm)
    return value, grad


def hessian_weights(loss: PointwiseLoss, x: FeatureMatrix, labels: Tensor,
                    offsets: Optional[Tensor], weights: Optional[Tensor],
                    coef: Tensor, norm: NormalizationContext) -> Tensor:
    """Per-sample Gauss-Newton curvature weights ``w_i l''(margin_i)``;
    constant over one Hessian build."""
    d2 = loss.d2z(compute_margins(x, coef, offsets, norm), labels)
    if weights is not None:
        d2 = d2 * weights
    return d2


def hessian_vector_from_weights(x: FeatureMatrix, d2: Tensor,
                                vector: Tensor, norm: NormalizationContext,
                                dim: int) -> Tensor:
    """Hv given precomputed curvature weights: two passes over X."""
    v_eff = vector * norm.factors if norm.factors is not None else vector
    t = matvec(x, v_eff)
    if norm.shifts is not None:
        t = t - torch.dot(v_eff, norm.shifts)
    coeffs = d2 * t
    return _apply_factor_and_shift(rmatvec(x, coeffs, dim), coeffs.sum(),
                                   norm)


def hessian_matrix_from_weights(x: FeatureMatrix, d2: Tensor,
                                norm: NormalizationContext,
                                dim: int) -> Tensor:
    """Full H from precomputed curvature weights: one weighted Gram."""
    h = weighted_gram(x, d2, dim)
    if norm.shifts is not None:
        lin = rmatvec(x, d2, dim)
        outer = torch.outer(lin, norm.shifts)
        h = (h - outer - outer.T
             + d2.sum() * torch.outer(norm.shifts, norm.shifts))
    if norm.factors is not None:
        h = h * torch.outer(norm.factors, norm.factors)
    return h


def hessian_vector(loss: PointwiseLoss, x: FeatureMatrix, labels: Tensor,
                   offsets: Optional[Tensor], weights: Optional[Tensor],
                   coef: Tensor, vector: Tensor,
                   norm: NormalizationContext) -> Tensor:
    """Gauss-Newton Hessian-vector product (reference:
    HessianVectorAggregator.calcHessianVector)."""
    d2 = hessian_weights(loss, x, labels, offsets, weights, coef, norm)
    return hessian_vector_from_weights(x, d2, vector, norm, coef.shape[0])


def hessian_diagonal(loss: PointwiseLoss, x: FeatureMatrix, labels: Tensor,
                     offsets: Optional[Tensor], weights: Optional[Tensor],
                     coef: Tensor, norm: NormalizationContext) -> Tensor:
    """diag(H) = sum_i w_i l''_i x'_ij^2 (reference:
    HessianDiagonalAggregator.calcHessianDiagonal)."""
    dim = coef.shape[0]
    d2 = hessian_weights(loss, x, labels, offsets, weights, coef, norm)
    sq = sq_rmatvec(x, d2, dim)
    if norm.shifts is None:
        diag = sq
    else:
        lin = rmatvec(x, d2, dim)
        diag = sq - 2.0 * norm.shifts * lin + norm.shifts ** 2 * d2.sum()
    if norm.factors is not None:
        diag = diag * norm.factors * norm.factors
    return diag


def hessian_matrix(loss: PointwiseLoss, x: FeatureMatrix, labels: Tensor,
                   offsets: Optional[Tensor], weights: Optional[Tensor],
                   coef: Tensor, norm: NormalizationContext) -> Tensor:
    """Full H = sum_i w_i l''_i x'_i x'_i^T (reference:
    HessianMatrixAggregator.calcHessianMatrix); small dims only."""
    d2 = hessian_weights(loss, x, labels, offsets, weights, coef, norm)
    return hessian_matrix_from_weights(x, d2, norm, coef.shape[0])
