"""Feature normalization as algebra folded into the training kernels.

The port of ``photon_tpu/ops/normalization.py`` (reference: photon-lib
normalization/NormalizationContext.scala:37,80-126 and
NormalizationType.scala:26-41). The transformed feature is

    x' = (x - shift) * factor          (identity on the intercept column)

and optimizers run in *transformed* coefficient space while the data stays
raw: the aggregators fold the affine map in algebraically, as
ValueAndGradientAggregator.scala:36-80 does. This module holds the context
and the margin-invariant model <-> transformed-space conversions.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


class NormalizationContext(NamedTuple):
    """``factors``/``shifts`` are [d] tensors or None; an intercept slot
    holds factor 1 and shift 0 (``build_normalization_context`` sees to
    it)."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def to(self, device, dtype=None) -> "NormalizationContext":
        move = lambda t: None if t is None else t.to(device=device,
                                                     dtype=dtype)
        return NormalizationContext(move(self.factors), move(self.shifts))

    def model_to_transformed_space(self, coef: Tensor,
                                   intercept_index: Optional[int] = None
                                   ) -> Tensor:
        """Original-space model -> transformed-space coefficients."""
        out = coef
        if self.factors is not None:
            out = out / self.factors
        if self.shifts is not None and intercept_index is not None:
            out = out.clone()
            out[intercept_index] += torch.dot(coef, self.shifts)
        return out

    def transformed_space_to_model(self, coef: Tensor,
                                   intercept_index: Optional[int] = None
                                   ) -> Tensor:
        """Transformed-space coefficients -> original-space model."""
        eff = coef * self.factors if self.factors is not None else coef
        out = eff
        if self.shifts is not None and intercept_index is not None:
            out = out.clone()
            out[intercept_index] -= torch.dot(eff, self.shifts)
        return out


def no_normalization() -> NormalizationContext:
    return NormalizationContext(None, None)


def build_normalization_context(
    norm_type: NormalizationType,
    mean: Tensor,
    variance: Tensor,
    abs_max: Tensor,
    intercept_index: Optional[int] = None,
) -> NormalizationContext:
    """A context from feature statistics (reference: the
    NormalizationContext factory from FeatureDataStatistics)."""
    if norm_type == NormalizationType.NONE:
        return no_normalization()
    std = torch.sqrt(variance)
    inv_std = 1.0 / torch.where(std > 0, std, torch.ones_like(std))
    inv_mag = 1.0 / torch.where(abs_max > 0, abs_max,
                                torch.ones_like(abs_max))
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = inv_std, None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = inv_mag, None
    elif norm_type == NormalizationType.STANDARDIZATION:
        factors, shifts = inv_std, mean.clone()
    else:  # pragma: no cover
        raise ValueError(f"unknown normalization type {norm_type}")
    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    return NormalizationContext(factors, shifts)
